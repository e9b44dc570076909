"""The epoch-level training harness (the JAX package's train/loop.py).

``Trainer`` runs what train.py runs every epoch (train.py:29-203): a
shuffled epoch of train steps, validation through the eval step (K1 on
the card; the class confusion and accuracy for the classification loss),
best-epoch selection on (mean class accuracy + mean IoU) / 2, and the
pruned share. The per-batch work stays on the model's device: the
shuffle, the augmentation draws and the dropout keep masks come from a
generator on that device,
the metrics are summed there, the best params are selected there (a copy,
never an alias of the live params), and ``train_run`` fetches the metrics
once a chunk of epochs. ``train_epoch_streamed`` trains an epoch from a
host dataset through a prefetching stream instead of the device cache. Script-specific control flow (sweeps, the prune
phase) lives in the CLI, as in the reference.

With a ``mesh`` (parallel/mesh.py) the Trainer is one rank of a
data-parallel (and spatially partitioned) run: every rank seeds the same
generator and draws the permutation, the augmentation draws and the
keep masks of the global batch, then takes its own samples of it
(``shard_rows``), so that a mesh run is the one-process run at the same
seed; the train step sums the gradients over the mesh, and validation
sums an epoch's metrics over it once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from robocupvision_tpu_torch.data.device_cache import (DeviceCache,
                                                       epoch_batches,
                                                       num_batches,
                                                       shard_rows, shuffle)
from robocupvision_tpu_torch.data.streaming import StreamingBatches
from robocupvision_tpu_torch.models import layers as L
from robocupvision_tpu_torch.models.zoo import Model
from robocupvision_tpu_torch.ops import color
from robocupvision_tpu_torch.ops.metrics import (SegAccum, seg_finalize,
                                                 seg_finalize_tensors)
from robocupvision_tpu_torch.ops.pruning import near_zero_fraction
from robocupvision_tpu_torch.train import checkpoint as ckpt
from robocupvision_tpu_torch.train import optim
from robocupvision_tpu_torch.train import step as tstep
from robocupvision_tpu_torch.utils import profiling


@dataclasses.dataclass
class EpochResult:
    loss: float
    reg: float
    pixel_acc: float


def _host(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _each(fn, tree):
    """``fn`` on each tensor of a dict of draws or keep masks (or None)."""
    return None if tree is None else {k: fn(v) for k, v in tree.items()}


_ACC = ("conf", "iou_sum", "lab_cnts", "correct", "img_cnt")


class Trainer:
    def __init__(self, model: Model, tx: optim.GradientTransform,
                 cfg: tstep.StepCfg, train_cache: Optional[DeviceCache],
                 val_cache: Optional[DeviceCache], batch_size: int,
                 multipliers: Optional[Dict[str, float]] = None,
                 seed: int = 12345678, mesh=None):
        """Trains ``model``'s family on its device. The random generator
        (the shuffle, the augmentation draws and the dropout keep masks)
        lives on that device, seeded with ``seed``; ``draw_perm(n)``,
        ``draw_augment(n)`` (the draws of ``cfg.augment_mode``) and
        ``draw_dropout(n)`` (``Model.draw_dropout`` at the current
        batch's (H, W)) draw from it, and a caller may replace them with
        draws of its own. The streamed epoch's host shuffle draws from a
        numpy generator seeded once with ``seed``.

        ``mesh``: a ``parallel.mesh.Mesh`` whose device is the model's;
        the caches are the whole sets on every rank (``shard_rows``
        takes the rank's samples of each batch) and ``batch_size`` the
        global batch."""
        if mesh is not None and torch.device(mesh.device) != model.device:
            raise ValueError(f"the mesh's device {mesh.device} is not the "
                             f"model's {model.device}")
        self.mesh = mesh
        self.model = model
        self.tx = tx
        self.cfg = cfg
        self.train_cache = train_cache
        self.val_cache = val_cache
        self.batch_size = batch_size
        self.multipliers = multipliers
        self.device = model.device
        self.seed = seed
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._host_rng: Optional[np.random.Generator] = None
        self._batch_hw = None  # the (H, W) of the batch being drawn for
        self.train_step = tstep.make_train_step(model, tx, cfg, multipliers,
                                                mesh=mesh)
        self.eval_step = tstep.make_eval_step(model, cfg, mesh=mesh)
        draw_augment, _ = color.AUGMENT_MODES[cfg.augment_mode]
        self.draw_perm = lambda n: shuffle(self.gen, n)
        self.draw_augment = lambda n: draw_augment(self.gen, n)
        self.draw_dropout = lambda n: model.draw_dropout(self.gen, n,
                                                         self._batch_hw)
        self.state: Optional[tstep.TrainState] = None
        self.epoch = 0   # train epochs begun: the req of an epoch's spans

    # -- state ------------------------------------------------------------------

    def _replicate(self, state: tstep.TrainState) -> tstep.TrainState:
        """On a mesh, rank 0's state on every rank."""
        if self.mesh is None:
            return state
        from robocupvision_tpu_torch.parallel.mesh import replicate_state

        return tstep.TrainState(replicate_state(self.mesh, state.params),
                                replicate_state(self.mesh, state.opt_state))

    def init(self) -> None:
        """Start from the model's own weights with a fresh optimizer."""
        self.state = self._replicate(tstep.init_state(self.model, self.tx))

    def _to_device(self, params: Mapping) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, torch.float32).clone()
                for k, v in params.items()}

    def set_params(self, params: Mapping, reset_opt: bool = True) -> None:
        """Take ``params`` (the port's layout, tensors or arrays) as the
        current params; a fresh optimizer state unless ``reset_opt`` is
        False and there is one."""
        dev = self._to_device(params)
        if self.state is None or reset_opt:
            trainable, _ = L.split_params(dev)
            self.state = self._replicate(
                tstep.TrainState(dev, self.tx.init(trainable)))
        else:
            self.state = self._replicate(
                tstep.TrainState(dev, self.state.opt_state))

    def params_numpy(self) -> Dict[str, np.ndarray]:
        return _host(self.state.params)

    def _masks(self, prune_masks):
        if prune_masks is None:
            return None
        return {k: torch.as_tensor(v).to(self.device) for k, v in
                prune_masks.items()}

    # -- epochs -----------------------------------------------------------------

    def _steps(self, batches, lr: float, masks,
               strided: bool = False) -> Dict[str, torch.Tensor]:
        """A train step on each (imgs, targets, sample_mask) batch; the
        metrics summed on the device. On a mesh a batch is the global one
        (the rank takes its block), or with ``strided`` already the
        rank's: rows ``data_index::data`` of the global batch, as a
        sharded stream yields them. The draws and keep masks are drawn
        for the global batch either way, and cut as its rows. A
        ``train.epoch`` span."""
        self.epoch += 1
        with profiling.span("train.epoch", req=self.epoch):
            return self._step_each(batches, lr, masks, strided)

    def _step_each(self, batches, lr: float, masks,
                   strided: bool) -> Dict[str, torch.Tensor]:
        mesh = self.mesh
        tot: Dict[str, torch.Tensor] = {}
        for imgs, tgt, mask in batches:
            n = mask.shape[0]
            local = None
            if mesh is not None and strided:
                parts = mesh.shape["data"]
                n *= parts

                def local(t, i=mesh.data_index, parts=parts):
                    return t[i::parts]
            elif mesh is not None:
                def local(t):
                    return shard_rows(mesh, t)

                imgs, tgt = local(imgs), local(tgt)
                mask = shard_rows(mesh, mask, fill=0.0)
            self._batch_hw = tuple(imgs.shape[1:3])
            draws = self.draw_augment(n) if self.cfg.augment else None
            drops = self.draw_dropout(n)
            if local is not None:
                draws, drops = _each(local, draws), _each(local, drops)
            self.state, out = self.train_step(self.state, imgs, tgt, mask,
                                              draws, lr, masks, drops)
            tot = out if not tot else {k: tot[k] + out[k] for k in tot}
        return tot

    def _train_epoch(self, lr: float, masks) -> Dict[str, torch.Tensor]:
        """One shuffled epoch of train steps over the train cache."""
        perm = self.draw_perm(self.train_cache.n)
        return self._steps(epoch_batches(self.train_cache, self.batch_size,
                                         perm), lr, masks)

    def _epoch_result(self, tot: Dict[str, torch.Tensor],
                      nb: int) -> EpochResult:
        if not tot:
            return EpochResult(loss=0.0, reg=0.0, pixel_acc=0.0)
        tot = {k: float(v) for k, v in tot.items()}
        return EpochResult(
            loss=tot["loss"] / max(nb, 1), reg=tot["reg"] / max(nb, 1),
            pixel_acc=tot["correct"] * self.cfg.out_size * 100.0
            / max(tot["img_cnt"], 1.0))

    def train_epoch(self, lr: float, prune_masks=None) -> EpochResult:
        assert self.state is not None and self.train_cache is not None
        tot = self._train_epoch(lr, self._masks(prune_masks))
        return self._epoch_result(
            tot, num_batches(self.train_cache.n, self.batch_size))

    def train_epoch_streamed(self, lr: float, dataset, *,
                             shuffle: bool = True,
                             device_transform: Optional[Callable] = None,
                             prune_masks=None) -> EpochResult:
        """One epoch fed from a host dataset through the prefetching
        stream (data/streaming.py) instead of the device cache, for sets
        larger than the card's memory: the host reads and copies batches
        while the card trains, through the same train step as
        :meth:`train_epoch`. ``shuffle``: the order from a numpy generator
        seeded once from the Trainer's seed (the device generator is left
        to the draws). ``device_transform``: ``(imgs, labels) -> (imgs,
        labels)`` on the card after the copy (e.g. uint8 frames
        normalized there). On a mesh the stream takes the mesh's data
        sharding: each rank reads only its samples, ``batch_size / data``
        a batch."""
        assert self.state is not None
        rng = None
        if shuffle:
            if self._host_rng is None:
                self._host_rng = np.random.default_rng(self.seed)
            rng = self._host_rng
        batch, sharding = self.batch_size, None
        if self.mesh is not None:
            from robocupvision_tpu_torch.parallel.mesh import sample_sharding

            parts = self.mesh.shape["data"]
            if batch % parts:
                raise ValueError(f"batch {batch} is not divisible by the "
                                 f"mesh data axis ({parts}): a sharded "
                                 f"stream reads batch / {parts} samples a "
                                 f"rank")
            batch //= parts
            sharding = sample_sharding(self.mesh)
        stream = StreamingBatches(dataset, batch, rng, sharding=sharding,
                                  device_transform=device_transform,
                                  device=self.device)
        tot = self._steps(stream, lr, self._masks(prune_masks),
                          strided=sharding is not None)
        return self._epoch_result(tot, len(stream))

    def _valid(self, params) -> Optional[Dict]:
        """The eval step's outputs summed over the val set on the device
        (``acc`` a SegAccum; for ``ce`` ``conf``, ``correct``,
        ``img_cnt``), or None for an empty set. A ``train.valid_epoch``
        span."""
        with profiling.span("train.valid_epoch", req=self.epoch):
            return self._valid_sums(params)

    def _valid_sums(self, params) -> Optional[Dict]:
        tot = None
        mesh = self.mesh
        for imgs, tgt, mask in epoch_batches(self.val_cache, self.batch_size):
            if mesh is not None:
                imgs, tgt = shard_rows(mesh, imgs), shard_rows(mesh, tgt)
                mask = shard_rows(mesh, mask, fill=0.0)
            out = self.eval_step(imgs, tgt, mask, params)
            out.pop("pred", None)
            tot = out if tot is None else {k: tot[k] + out[k] for k in tot}
        if tot is not None and mesh is not None:
            tot = self._mesh_sum(tot)
        return tot

    def _mesh_sum(self, tot: Dict) -> Dict:
        """An epoch's validation sums over the mesh, in one all-reduce.
        The counts of a spatial rank other than 0 are left out: the eval
        step summed each image's counts over its spatial ranks already."""
        mesh = self.mesh
        acc = tot.get("acc")
        keys = [k for k in tot if k != "acc"]
        vals = [tot[k] for k in keys] + \
            ([getattr(acc, f) for f in _ACC] if acc is not None else [])
        own = torch.tensor(0.0 if mesh.spatial_index else 1.0,
                           device=self.device)
        vals = [v if k == "loss" else v * own
                for k, v in zip(keys + list(_ACC), vals)]
        summed = mesh.all_reduce_flat(vals)
        out = dict(zip(keys, summed))
        if acc is not None:
            out["acc"] = SegAccum(*summed[len(keys):])
        return out

    def valid_epoch(self) -> Dict:
        """The mean loss and the segmentation metrics of ``seg_finalize``
        (``ce``: the class confusion counts ``conf`` and the accuracy
        ``acc`` in percent)."""
        assert self.state is not None and self.val_cache is not None
        tot = self._valid(self.state.params)
        classify = self.cfg.loss == "ce"
        if tot is None:
            if classify:
                return {"loss": 0.0, "conf": None, "acc": 0.0}
            return {"loss": 0.0, "conf": None, "pixel_acc": 0.0,
                    "mean_class_acc": 0.0, "mean_iou": 0.0, "score": 0.0}
        loss = float(tot["loss"]) / max(
            num_batches(self.val_cache.n, self.batch_size), 1)
        if classify:
            return {"loss": loss, "conf": tot["conf"].cpu().numpy(),
                    "acc": float(tot["correct"]) * 100.0
                    / max(float(tot["img_cnt"]), 1.0)}
        fin = seg_finalize(tot["acc"], self.cfg.out_size)
        fin["loss"] = loss
        for k in ("pixel_acc", "mean_class_acc", "mean_iou", "score"):
            fin[k] = float(fin[k])
        return fin

    def pruned_fraction(self) -> float:
        """count_zero_weights (reference model.py:59-66) on the device,
        one scalar fetched."""
        return float(near_zero_fraction(self.state.params,
                                        self.model.param_order))

    # -- the train.py epoch loop -----------------------------------------------

    def _epoch(self, lr: float, masks, best_score, best_params):
        """One train epoch, its validation and the best-epoch selection,
        all on the device: -> (best_score, best_params, metrics)."""
        nb = max(num_batches(self.train_cache.n, self.batch_size), 1)
        vnb = max(num_batches(self.val_cache.n, self.batch_size), 1)
        tr = self._train_epoch(lr, masks)
        val = self._valid(self.state.params)
        vloss = val["loss"]
        fin = seg_finalize_tensors(val["acc"], self.cfg.out_size)
        better = fin["score"] > best_score
        best_params = {k: torch.where(better, v, best_params[k])
                       for k, v in self.state.params.items()}
        best_score = torch.where(better, fin["score"], best_score)
        em = {"train_loss": tr["loss"] / nb, "train_reg": tr["reg"] / nb,
              "train_pixel_acc": tr["correct"] * self.cfg.out_size * 100.0
              / torch.clamp_min(tr["img_cnt"], 1.0),
              "val_loss": vloss / vnb,
              **{k: fin[k] for k in ("pixel_acc", "mean_class_acc",
                                     "mean_iou", "score", "conf")},
              "better": better,
              "pruned": near_zero_fraction(self.state.params,
                                           self.model.param_order)}
        return best_score, best_params, em

    def train_run(self, epochs: int, lrs, prune_masks=None,
                  chunk_epochs: Optional[int] = None,
                  on_chunk: Optional[Callable] = None,
                  resume_path: Optional[str] = None):
        """The whole train.py epoch loop: train epochs, per-epoch
        validation and best-epoch selection. ``lrs``: one LR an epoch.

        ``chunk_epochs``: after every K epochs the chunk's metrics are
        fetched from the device (the only fetch) and
        ``on_chunk(epoch_offset, chunk_metrics, best_params_or_None)``
        fires; best_params (numpy) is given iff the chunk improved the best
        score, so the caller can print and write the best checkpoint
        mid-run. None: one chunk.

        ``resume_path``: after every chunk the params, optimizer state,
        best carry, generator state and chunk cursor are written there; if
        the file exists, the run continues from its cursor and ends as an
        uninterrupted run would (exactly so on the CPU). The file is not
        deleted at the end.

        Returns (best_score, best_params | None, metrics): metrics is a
        dict of (epochs,)-stacked arrays train_loss, train_reg,
        train_pixel_acc, val_loss, pixel_acc, mean_class_acc, mean_iou,
        score, conf (epochs, C, C), better, pruned; best_params is None
        when no epoch beat score 0 (the reference saves nothing then)."""
        assert self.state is not None and self.train_cache is not None \
            and self.val_cache is not None
        if self.cfg.loss == "ce":
            raise ValueError("train_run is the segmentation loop; the "
                             "classification loss trains by train_epoch "
                             "and valid_epoch")
        if len(lrs) != epochs:
            raise ValueError(f"{len(lrs)} learning rates for {epochs} epochs")
        if chunk_epochs is not None and chunk_epochs <= 0:
            raise ValueError(f"chunk_epochs={chunk_epochs}")
        if chunk_epochs is None or chunk_epochs >= epochs:
            chunks = [epochs]
        else:
            chunks = [chunk_epochs] * (epochs // chunk_epochs)
            if epochs % chunk_epochs:
                chunks.append(epochs % chunk_epochs)
        masks = self._masks(prune_masks)
        best_score = torch.zeros((), device=self.device)
        best_params = {k: v.clone() for k, v in self.state.params.items()}
        start_chunk = 0
        any_better = False
        resume = resume_path is not None and ckpt.exists(resume_path)
        if self.mesh is not None:
            # every rank has looked before rank 0 writes the first snapshot
            self.mesh.barrier()
        if resume:
            (params, opt_state, bs0, bp0, rng, start_chunk,
             meta) = ckpt.load_resume(resume_path)
            if meta["epochs"] != epochs or meta["chunks"] != chunks:
                raise ValueError(f"{resume_path} was written for "
                                 f"{meta['epochs']} epochs in chunks "
                                 f"{meta['chunks']}, not {epochs} in {chunks}")
            self.state = tstep.TrainState(
                self._to_device(params),
                {k: v.to(self.device) for k, v in opt_state.items()})
            self.gen.set_state(rng)
            best_score = torch.tensor(bs0, dtype=torch.float32,
                                      device=self.device)
            best_params = self._to_device(bp0)
            any_better = bool(meta["any_better"])
        parts: List[Dict[str, np.ndarray]] = []
        off = sum(chunks[:start_chunk])
        for ci in range(start_chunk, len(chunks)):
            ems = []
            for ei in range(off, off + chunks[ci]):
                best_score, best_params, em = self._epoch(
                    float(lrs[ei]), masks, best_score, best_params)
                ems.append(em)
            ms = {k: torch.stack([em[k] for em in ems]).cpu().numpy()
                  for k in ems[0]}
            parts.append(ms)
            improved = bool(ms["better"].any())
            any_better = any_better or improved
            if resume_path is not None and (self.mesh is None
                                            or self.mesh.is_main):
                ckpt.save_resume(resume_path, self.state.params,
                                 self.state.opt_state, float(best_score),
                                 best_params, self.gen.get_state(), ci + 1,
                                 {"epochs": epochs, "chunks": chunks,
                                  "any_better": any_better})
            if on_chunk is not None:
                on_chunk(off, ms, _host(best_params) if improved else None)
            off += chunks[ci]
        ms = {k: np.concatenate([m[k] for m in parts]) for k in parts[0]} \
            if parts else {}
        return (float(best_score), _host(best_params) if any_better else None,
                ms)
