"""The evaluation step (the JAX package's train/step.py: ``StepCfg``,
``_loss`` and the eval step; the train step belongs to the port's training
slice).

One call per batch: the class-ablation label remap, the forward in
``compute_dtype``, the loss, the argmax, and the batch's confusion/IoU
statistics through ``seg_batch_stats`` (kernel K1 on CUDA tensors), padded
samples masked out. The L1 term that the reference's valid() adds during
training (``l1_decay``) comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from robocupvision_tpu_torch.models.zoo import Model
from robocupvision_tpu_torch.ops import labels, losses, metrics


@dataclasses.dataclass(frozen=True)
class StepCfg:
    num_classes: int
    loss: str = "ce2d"                  # ce2d | dice
    class_weights: Tuple[float, ...] = ()
    mask_flags: Tuple[bool, bool, bool, bool] = (False, False, False, False)
    out_size: float = 1.0               # 1/(H*W) pixel-acc normalizer
    compute_dtype: str = "float32"      # "bfloat16": a bf16 forward over the
                                        # f32 weights (each op casts them)


def _loss(cfg: StepCfg, logits: torch.Tensor, targets: torch.Tensor,
          mask) -> torch.Tensor:
    """The task loss over (N, H, W, C) logits, ``mask`` (N,) expanded to a
    per-pixel mask."""
    w = torch.tensor(cfg.class_weights, device=logits.device) \
        if cfg.class_weights else None
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


def make_eval_step(model: Model, cfg: StepCfg):
    """Returns step(imgs, targets, sample_mask) -> {"loss", "acc" (a
    SegAccum of tensors on the model's device), "pred"} for a batch already
    on the model's device, with the model's own weights."""
    if cfg.loss not in ("ce2d", "dice"):
        raise ValueError(f"the eval step scores segmentation (ce2d, dice), "
                         f"not {cfg.loss!r}")
    nb, nr, ng, nl = cfg.mask_flags

    @torch.no_grad()
    def step(imgs, targets, sample_mask):
        targets = labels.mask_label(targets, nb, nr, ng, nl)
        if cfg.compute_dtype == "bfloat16":
            imgs = imgs.to(torch.bfloat16)
        logits = model(imgs)
        loss = _loss(cfg, logits, targets, sample_mask)
        pred = torch.argmax(logits, dim=-1)
        acc = metrics.seg_batch_stats(pred, targets, cfg.num_classes,
                                      sample_mask, device=pred.device)
        return {"loss": loss, "acc": acc, "pred": pred}

    return step
