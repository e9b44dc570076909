"""The epoch-level training harness (the JAX package's train/loop.py).

``Trainer`` runs what train.py runs every epoch (train.py:29-203): a
shuffled epoch of train steps, validation through the eval step (K1 on
the card), best-epoch selection on (mean class accuracy + mean IoU) / 2,
and the pruned share. The per-batch work stays on the model's device: the
shuffle and the augmentation draws come from a generator on that device,
the metrics are summed there, the best params are selected there (a copy,
never an alias of the live params), and ``train_run`` fetches the metrics
once a chunk of epochs. Script-specific control flow (sweeps, the prune
phase) lives in the CLI, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from robocupvision_tpu_torch.data.device_cache import (DeviceCache,
                                                       epoch_batches,
                                                       num_batches, shuffle)
from robocupvision_tpu_torch.models import layers as L
from robocupvision_tpu_torch.models.zoo import Model
from robocupvision_tpu_torch.ops import color
from robocupvision_tpu_torch.ops.metrics import (seg_finalize,
                                                 seg_finalize_tensors)
from robocupvision_tpu_torch.ops.pruning import near_zero_fraction
from robocupvision_tpu_torch.train import checkpoint as ckpt
from robocupvision_tpu_torch.train import optim
from robocupvision_tpu_torch.train import step as tstep


@dataclasses.dataclass
class EpochResult:
    loss: float
    reg: float
    pixel_acc: float


def _host(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


class Trainer:
    def __init__(self, model: Model, tx: optim.GradientTransform,
                 cfg: tstep.StepCfg, train_cache: Optional[DeviceCache],
                 val_cache: Optional[DeviceCache], batch_size: int,
                 multipliers: Optional[Dict[str, float]] = None,
                 seed: int = 12345678, mesh=None):
        """Trains ``model``'s family on its device. The random generator
        (the shuffle and the augmentation draws) lives on that device,
        seeded with ``seed``; ``draw_perm(n)`` and ``draw_augment(n)`` draw
        from it, and a caller may replace them with draws of its own."""
        if mesh is not None:
            raise NotImplementedError("data-parallel training over a mesh is "
                                      "not ported yet (ROADMAP A.7)")
        self.model = model
        self.tx = tx
        self.cfg = cfg
        self.train_cache = train_cache
        self.val_cache = val_cache
        self.batch_size = batch_size
        self.multipliers = multipliers
        self.device = model.device
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.draw_perm = lambda n: shuffle(self.gen, n)
        self.draw_augment = lambda n: color.draw_augment(self.gen, n)
        self.train_step = tstep.make_train_step(model, tx, cfg, multipliers)
        self.eval_step = tstep.make_eval_step(model, cfg)
        self.state: Optional[tstep.TrainState] = None

    # -- state ------------------------------------------------------------------

    def init(self) -> None:
        """Start from the model's own weights with a fresh optimizer."""
        self.state = tstep.init_state(self.model, self.tx)

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
            self.state = tstep.TrainState(dev, self.tx.init(trainable))
        else:
            self.state = tstep.TrainState(dev, self.state.opt_state)

    def params_numpy(self) -> Dict[str, np.ndarray]:
        return _host(self.state.params)

    def _masks(self, prune_masks):
        if prune_masks is None:
            return None
        return {k: torch.as_tensor(v).to(self.device) for k, v in
                prune_masks.items()}

    # -- epochs -----------------------------------------------------------------

    def _train_epoch(self, lr: float, masks) -> Dict[str, torch.Tensor]:
        """One shuffled epoch of train steps; the metrics summed on the
        device."""
        tot: Dict[str, torch.Tensor] = {}
        perm = self.draw_perm(self.train_cache.n)
        for imgs, tgt, mask in epoch_batches(self.train_cache,
                                             self.batch_size, perm):
            self.state, out = self.train_step(self.state, imgs, tgt, mask,
                                              self.draw_augment(mask.shape[0]),
                                              lr, masks)
            tot = out if not tot else {k: tot[k] + out[k] for k in tot}
        return tot

    def train_epoch(self, lr: float, prune_masks=None) -> EpochResult:
        assert self.state is not None and self.train_cache is not None
        tot = self._train_epoch(lr, self._masks(prune_masks))
        nb = num_batches(self.train_cache.n, self.batch_size)
        if not tot:
            return EpochResult(loss=0.0, reg=0.0, pixel_acc=0.0)
        tot = {k: float(v) for k, v in tot.items()}
        return EpochResult(
            loss=tot["loss"] / max(nb, 1), reg=tot["reg"] / max(nb, 1),
            pixel_acc=tot["correct"] * self.cfg.out_size * 100.0
            / max(tot["img_cnt"], 1.0))

    def train_epoch_streamed(self, lr: float, dataset, **kw) -> EpochResult:
        """An epoch fed from a host dataset through a prefetching stream,
        for sets larger than the card's memory: not ported yet."""
        raise NotImplementedError("train_epoch_streamed (data/streaming) is "
                                  "not ported yet (ROADMAP A.7)")

    def _valid(self, params):
        """(SegAccum of device tensors, summed loss) over the val set."""
        acc, loss = None, None
        for imgs, tgt, mask in epoch_batches(self.val_cache, self.batch_size):
            out = self.eval_step(imgs, tgt, mask, params)
            acc = out["acc"] if acc is None else acc + out["acc"]
            loss = out["loss"] if loss is None else loss + out["loss"]
        return acc, loss

    def valid_epoch(self) -> Dict:
        assert self.state is not None and self.val_cache is not None
        acc, loss = self._valid(self.state.params)
        if acc is None:
            return {"loss": 0.0, "conf": None, "pixel_acc": 0.0,
                    "mean_class_acc": 0.0, "mean_iou": 0.0, "score": 0.0}
        fin = seg_finalize(acc, self.cfg.out_size)
        fin["loss"] = float(loss) / max(
            num_batches(self.val_cache.n, self.batch_size), 1)
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
        acc, vloss = self._valid(self.state.params)
        fin = seg_finalize_tensors(acc, self.cfg.out_size)
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
        if resume_path is not None and ckpt.exists(resume_path):
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
            if resume_path is not None:
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
