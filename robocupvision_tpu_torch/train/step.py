"""The train and eval steps (the JAX package's train/step.py).

One train step per batch does what the reference does per batch
(train.py:43-94, and the legacy CLIs' loops): the augmentation (with
draws the caller made; of the images alone for the classification loss),
the class-ablation label remap, the train-mode forward with padded samples
left out of the BN statistics and the dropout keep masks the caller drew,
the loss plus the L1 term, the gradients of
the trainable params by autograd, the prune masks zeroing theirs, the
optimizer's update, and the new BN running statistics merged in. With
``StepCfg.packed`` the forward is the packed graph (models/packed.py) and
the loss is taken over packed targets; with ``StepCfg.remat`` the forward
runs under ``torch.utils.checkpoint``. Its
metrics stay tensors on the device; the loop sums them there and fetches
them once a chunk.

One eval step per batch: the label remap, the forward in
``compute_dtype``, the loss (plus the L1 term when ``l1_decay`` is set, as
the reference's valid() adds it), the argmax, and the batch's
confusion/IoU statistics through ``seg_batch_stats`` (kernel K1 on CUDA
tensors), padded samples masked out; for the classification loss ``ce``
the class confusion and correct count (``class_batch_stats``) instead.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from robocupvision_tpu_torch.models import layers as L
from robocupvision_tpu_torch.models import packed as packed_mod
from robocupvision_tpu_torch.models.zoo import Model
from robocupvision_tpu_torch.ops import color, labels, losses, metrics
from robocupvision_tpu_torch.ops.pruning import mask_gradients
from robocupvision_tpu_torch.train import optim

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Params            # trainable + BN running stats (registry names)
    opt_state: optim.OptState


@dataclasses.dataclass(frozen=True)
class StepCfg:
    num_classes: int
    loss: str = "ce2d"                  # ce2d | dice | ce (classification)
    class_weights: Tuple[float, ...] = ()
    l1_decay: float = 0.0               # train.py:52-54 manual L1 term
    mask_flags: Tuple[bool, bool, bool, bool] = (False, False, False, False)
    augment: bool = True                # the step augments its batch
    augment_mode: str = "ssyuv"         # ssyuv: hflip + YUV jitter
                                        #   (train.py)
                                        # legacy: hflip + vflip + RGB
                                        #   ColorJitter (trainer.py:88-104)
                                        # legacy_hflip: hflip + RGB
                                        #   ColorJitter (classTrainer.py:55-62)
    jitter: bool = True                 # the augmentation's colour jitter
    out_size: float = 1.0               # 1/(H*W) pixel-acc normalizer
    compute_dtype: str = "float32"      # "bfloat16": bf16 forward and
                                        # backward over f32 master weights;
                                        # loss, BN statistics and the
                                        # optimizer stay f32
    packed: bool = False                # the lane-packed training graph
                                        # (ROBO-UNet, ce2d only): an exact
                                        # rewrite over the same params,
                                        # optimizer and checkpoints
                                        # (models/packed.py
                                        # packed_train_apply)
    remat: str = "none"                 # none | dots | full: recompute the
                                        # forward's activations in the
                                        # backward instead of keeping them
                                        # (dots: keep the conv and matmul
                                        # outputs); numerics unchanged


def _class_weights(cfg: StepCfg, device) -> Optional[torch.Tensor]:
    """The class weights on ``device``, made once a step function: a
    tensor built from a list on the card is a host copy, which waits for
    the card."""
    return torch.tensor(cfg.class_weights, dtype=torch.float32,
                        device=device) if cfg.class_weights else None


def _loss(cfg: StepCfg, logits: torch.Tensor, targets: torch.Tensor,
          mask, w: Optional[torch.Tensor]) -> torch.Tensor:
    """The task loss over (N, H, W, C) logits (``ce``: (N, C)) with class
    weights ``w``, ``mask`` (N,) expanded to a per-pixel mask."""
    if cfg.loss == "ce":
        return losses.cross_entropy(logits, targets, w, mask)
    pixel_mask = None
    if mask is not None:
        m = torch.as_tensor(mask, device=logits.device).float()
        pixel_mask = m.reshape((-1,) + (1,) * (targets.dim() - 1)) \
            * torch.ones(targets.shape, device=logits.device)
    if cfg.loss == "dice":
        return losses.dice_loss(logits, targets, w if w is not None else
                                torch.ones(cfg.num_classes,
                                           device=logits.device), pixel_mask)
    return losses.cross_entropy_2d(logits, targets, w, pixel_mask)


def _check(cfg: StepCfg) -> None:
    if cfg.loss not in ("ce2d", "dice", "ce"):
        raise ValueError(f"loss must be ce2d, dice or ce, not {cfg.loss!r}")
    if cfg.augment_mode not in color.AUGMENT_MODES:
        raise ValueError(f"augment_mode must be one of "
                         f"{sorted(color.AUGMENT_MODES)}, "
                         f"not {cfg.augment_mode!r}")
    if cfg.remat not in ("none", "dots", "full"):
        raise ValueError(f"remat must be none, dots or full, not "
                         f"{cfg.remat!r}")


# the ops whose outputs remat="dots" keeps: the convolutions and matmuls
# (JAX's dots_saveable keeps dot_general and conv_general_dilated outputs)
_DOTS = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _make_forward(model: Model, cfg: StepCfg):
    """forward(leaves, bn_state, x, sample_mask, dropout) -> (logits, mut):
    the train-mode forward, under ``cfg.remat``'s checkpoint.

    The forward enters the train-mode contexts itself (BN's sample mask,
    train mode with the dropout keep masks) from its arguments: a
    checkpoint's recompute runs inside autograd's backward, after any
    context around the step has exited, and would otherwise recompute BN
    in eval mode, without the mask or the drops. The running statistics
    the recompute writes go into a dict of its own and are dropped: ``mut``
    is the first forward's."""
    maps = None
    if cfg.packed:
        assert cfg.loss == "ce2d", "packed training supports the ce2d path"
        maps = packed_mod.build_train_pack_maps(model)

    def forward(leaves, bn_state, x, sample_mask, dropout):
        p = {**leaves, **bn_state}
        with L.bn_stats_mask(sample_mask):
            if maps is not None:
                return packed_mod.packed_train_apply(maps, p, x)
            return model.apply(p, x, train=True, dropout=dropout)

    if cfg.remat == "none":
        return forward
    # the forward draws nothing, so no generator state needs keeping
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: checkpoint(forward, *args, **kw)


def _flat_logits(cfg: StepCfg, logits: torch.Tensor) -> torch.Tensor:
    """``ce``'s (N, 1, 1, C) logits as (N, C)."""
    return logits.reshape(logits.shape[0], -1) if cfg.loss == "ce" \
        else logits


def make_train_step(model: Model, tx: optim.GradientTransform, cfg: StepCfg,
                    multipliers: Optional[Mapping[str, float]] = None):
    """Returns step(state, imgs, targets, sample_mask, draws, lr,
    prune_masks=None, dropout=None) -> (new state, metrics) for a batch on
    the model's device.

    ``draws``: the batch's augmentation draws for ``cfg.augment_mode``
    (the mode's draw in ``color.AUGMENT_MODES``; unused without
    ``cfg.augment``). ``prune_masks``: {name: mask} True or 1 at pruned
    positions, or None. ``dropout``: the forward's keep masks
    (``Model.draw_dropout``), for a family with dropout sites.
    ``metrics``: 0-d tensors ``loss`` (task loss plus the L1 term),
    ``reg``, ``correct`` (right pixels, or samples for ``ce``, of the real
    samples) and ``img_cnt``, on the device. The new state holds new
    tensors; the old one is left as it was."""
    _check(cfg)
    forward = _make_forward(model, cfg)
    nb, nr, ng, nl = cfg.mask_flags
    weights = _class_weights(cfg, model.device)
    _, augment = color.AUGMENT_MODES[cfg.augment_mode]
    classify = cfg.loss == "ce"

    def step(state: TrainState, imgs, targets, sample_mask, draws, lr,
             prune_masks: Optional[Mapping[str, torch.Tensor]] = None,
             dropout: Optional[Mapping[str, torch.Tensor]] = None):
        if cfg.augment:
            # a class label has no pixels to flip
            imgs, flipped = augment(imgs, None if classify else targets,
                                    draws, cfg.jitter)
            if not classify:
                targets = flipped
        targets = labels.mask_label(targets, nb, nr, ng, nl)
        if cfg.packed:
            targets = packed_mod.pack_targets(targets)
        trainable, bn_state = L.split_params(state.params)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in trainable.items()}
        x = imgs.to(torch.bfloat16) if cfg.compute_dtype == "bfloat16" \
            else imgs
        with torch.enable_grad():
            logits, mut = forward(leaves, bn_state, x, sample_mask, dropout)
            logits = _flat_logits(cfg, logits)
            task = _loss(cfg, logits, targets, sample_mask, weights)
            reg = torch.zeros((), device=logits.device)
            if cfg.l1_decay:
                reg = cfg.l1_decay * losses.l1_regularization(leaves)
            total = task + reg
            # a param the forward does not reach (the segmentation head of
            # a net trained to classify) gets a zero gradient, as in JAX
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        materialize_grads=True)
        grads = dict(zip(leaves, grads))
        if prune_masks is not None:
            grads = mask_gradients(grads, prune_masks)
        with torch.no_grad():
            direction, opt_state = tx.update(grads, state.opt_state,
                                             trainable)
            new_trainable = optim.apply_updates(trainable, direction, lr,
                                                multipliers)
            pred = torch.argmax(logits.detach(), dim=-1)
            m = torch.as_tensor(sample_mask, device=pred.device).float()
            correct = ((pred == targets).float()
                       * m.reshape((-1,) + (1,) * (targets.dim() - 1))).sum()
            out = {"loss": total.detach(), "reg": reg.detach(),
                   "correct": correct, "img_cnt": m.sum()}
        return TrainState({**new_trainable, **bn_state, **mut},
                          opt_state), out

    return step


def make_eval_step(model: Model, cfg: StepCfg):
    """Returns step(imgs, targets, sample_mask, params=None) -> {"loss",
    "acc" (a SegAccum of tensors on the model's device), "pred"} for a
    batch already on the model's device, with ``params`` (the train loop's)
    or the model's own weights; for ``ce``: {"loss", "conf" (C, C),
    "correct", "img_cnt"}."""
    _check(cfg)
    nb, nr, ng, nl = cfg.mask_flags
    weights = _class_weights(cfg, model.device)

    @torch.no_grad()
    def step(imgs, targets, sample_mask, params: Optional[Params] = None):
        p = model.flat() if params is None else params
        targets = labels.mask_label(targets, nb, nr, ng, nl)
        if cfg.compute_dtype == "bfloat16":
            imgs = imgs.to(torch.bfloat16)
        logits = _flat_logits(cfg, model.apply(p, imgs))
        loss = _loss(cfg, logits, targets, sample_mask, weights)
        if cfg.l1_decay:
            trainable, _ = L.split_params(p)
            loss = loss + cfg.l1_decay * losses.l1_regularization(trainable)
        pred = torch.argmax(logits, dim=-1)
        if cfg.loss == "ce":
            conf, correct = metrics.class_batch_stats(
                pred, targets, cfg.num_classes, sample_mask)
            return {"loss": loss, "conf": conf, "correct": correct,
                    "img_cnt": torch.as_tensor(sample_mask).float().sum()}
        acc = metrics.seg_batch_stats(pred, targets, cfg.num_classes,
                                      sample_mask, device=pred.device)
        return {"loss": loss, "acc": acc, "pred": pred}

    return step


def init_state(model: Model, tx: optim.GradientTransform) -> TrainState:
    """The model's own weights (copied) and a fresh optimizer state."""
    params = {k: v.detach().clone() for k, v in model.flat().items()}
    trainable, _ = L.split_params(params)
    return TrainState(params, tx.init(trainable))
