"""The train and eval steps (the JAX package's train/step.py).

One train step per batch does what the reference does per batch
(train.py:43-94): the augmentation (with draws the caller made), the
class-ablation label remap, the train-mode forward with padded samples
left out of the BN statistics, the loss plus the L1 term, the gradients of
the trainable params by autograd, the prune masks zeroing theirs, the
optimizer's update, and the new BN running statistics merged in. Its
metrics stay tensors on the device; the loop sums them there and fetches
them once a chunk.

One eval step per batch: the label remap, the forward in
``compute_dtype``, the loss (plus the L1 term when ``l1_decay`` is set, as
the reference's valid() adds it), the argmax, and the batch's
confusion/IoU statistics through ``seg_batch_stats`` (kernel K1 on CUDA
tensors), padded samples masked out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from robocupvision_tpu_torch.models import layers as L
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
    loss: str = "ce2d"                  # ce2d | dice
    class_weights: Tuple[float, ...] = ()
    l1_decay: float = 0.0               # train.py:52-54 manual L1 term
    mask_flags: Tuple[bool, bool, bool, bool] = (False, False, False, False)
    augment_mode: str = "ssyuv"         # hflip + YUV jitter (train.py)
    out_size: float = 1.0               # 1/(H*W) pixel-acc normalizer
    compute_dtype: str = "float32"      # "bfloat16": bf16 forward and
                                        # backward over f32 master weights;
                                        # loss, BN statistics and the
                                        # optimizer stay f32
    packed: bool = False                # the JAX package's lane-packed
                                        # training graph: not ported
    remat: str = "none"                 # activation recomputation: not ported


def _class_weights(cfg: StepCfg, device) -> Optional[torch.Tensor]:
    """The class weights on ``device``, made once a step function: a
    tensor built from a list on the card is a host copy, which waits for
    the card."""
    return torch.tensor(cfg.class_weights, dtype=torch.float32,
                        device=device) if cfg.class_weights else None


def _loss(cfg: StepCfg, logits: torch.Tensor, targets: torch.Tensor,
          mask, w: Optional[torch.Tensor]) -> torch.Tensor:
    """The task loss over (N, H, W, C) logits with class weights ``w``,
    ``mask`` (N,) expanded to a per-pixel mask."""
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


def _check_seg(cfg: StepCfg) -> None:
    if cfg.loss not in ("ce2d", "dice"):
        raise ValueError(f"the steps train and score segmentation (ce2d, "
                         f"dice), not {cfg.loss!r}")


def make_train_step(model: Model, tx: optim.GradientTransform, cfg: StepCfg,
                    multipliers: Optional[Mapping[str, float]] = None):
    """Returns step(state, imgs, targets, sample_mask, draws, lr,
    prune_masks) -> (new state, metrics) for a batch on the model's device.

    ``draws``: the batch's augmentation draws (``color.draw_augment``). ``prune_masks``: {name: mask} True or
    1 at pruned positions, or None. ``metrics``: 0-d tensors ``loss``
    (task loss plus the L1 term), ``reg``, ``correct`` (right pixels of the
    real samples) and ``img_cnt``, on the device. The new state holds new
    tensors; the old one is left as it was."""
    _check_seg(cfg)
    if cfg.packed:
        raise NotImplementedError("packed training is not ported yet "
                                  "(ROADMAP A.1)")
    if cfg.remat != "none":
        raise NotImplementedError(f"remat={cfg.remat!r} is not ported yet "
                                  "(ROADMAP A.1)")
    if cfg.augment_mode != "ssyuv":
        raise NotImplementedError(f"augment_mode={cfg.augment_mode!r} is not "
                                  "ported yet (ROADMAP A.2)")
    nb, nr, ng, nl = cfg.mask_flags
    weights = _class_weights(cfg, model.device)

    def step(state: TrainState, imgs, targets, sample_mask, draws, lr,
             prune_masks: Optional[Mapping[str, torch.Tensor]] = None):
        imgs, targets = color.augment_batch(imgs, targets, draws)
        targets = labels.mask_label(targets, nb, nr, ng, nl)
        trainable, bn_state = L.split_params(state.params)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in trainable.items()}
        x = imgs.to(torch.bfloat16) if cfg.compute_dtype == "bfloat16" \
            else imgs
        with torch.enable_grad():
            with L.bn_stats_mask(sample_mask):
                logits, mut = model.apply({**leaves, **bn_state}, x,
                                          train=True)
            task = _loss(cfg, logits, targets, sample_mask, weights)
            reg = torch.zeros((), device=logits.device)
            if cfg.l1_decay:
                reg = cfg.l1_decay * losses.l1_regularization(leaves)
            total = task + reg
            grads = torch.autograd.grad(total, list(leaves.values()))
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
    or the model's own weights."""
    _check_seg(cfg)
    nb, nr, ng, nl = cfg.mask_flags
    weights = _class_weights(cfg, model.device)

    @torch.no_grad()
    def step(imgs, targets, sample_mask, params: Optional[Params] = None):
        p = model.flat() if params is None else params
        targets = labels.mask_label(targets, nb, nr, ng, nl)
        if cfg.compute_dtype == "bfloat16":
            imgs = imgs.to(torch.bfloat16)
        logits = model.apply(p, imgs)
        loss = _loss(cfg, logits, targets, sample_mask, weights)
        if cfg.l1_decay:
            trainable, _ = L.split_params(p)
            loss = loss + cfg.l1_decay * losses.l1_regularization(trainable)
        pred = torch.argmax(logits, dim=-1)
        acc = metrics.seg_batch_stats(pred, targets, cfg.num_classes,
                                      sample_mask, device=pred.device)
        return {"loss": loss, "acc": acc, "pred": pred}

    return step


def init_state(model: Model, tx: optim.GradientTransform) -> TrainState:
    """The model's own weights (copied) and a fresh optimizer state."""
    params = {k: v.detach().clone() for k, v in model.flat().items()}
    trainable, _ = L.split_params(params)
    return TrainState(params, tx.init(trainable))
