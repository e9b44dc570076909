"""Segmentation metrics (the JAX package's ops/metrics.py, eval side),
and the classification counts of the legacy classifier's validation.

Conventions (reference train.py:136-164):
- conf[pred, lab] counts pixels, later normalized per label column by
  labCnts/100.
- IoU is accumulated per image per class, empty union counting as 1;
  meanIoU = sum_c(IoU_c / imgCnt) / C * 100.
- score = (meanClassAcc + meanIoU) / 2.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from robocupvision_tpu_torch.device import DeviceLike, resolve_device
from robocupvision_tpu_torch.ops.cuda_kernels import (confusion_count,
                                                      confusion_count_plain)


@dataclasses.dataclass
class SegAccum:
    """Accumulator over eval batches (tensors or numpy arrays inside)."""

    conf: object       # (C, C) conf[pred, lab] pixel counts
    iou_sum: object    # (C,) per-image IoU sums
    lab_cnts: object   # (C,)
    correct: object    # scalar: correctly classified pixels
    img_cnt: object    # scalar: number of (valid) images

    @classmethod
    def zero(cls, num_classes: int) -> "SegAccum":
        """Host-side (numpy f64) zero accumulator."""
        z = np.zeros
        return cls(z((num_classes, num_classes), np.float64),
                   z((num_classes,), np.float64), z((num_classes,), np.float64),
                   z((), np.float64), z((), np.float64))

    def __add__(self, other: "SegAccum") -> "SegAccum":
        return SegAccum(self.conf + other.conf, self.iou_sum + other.iou_sum,
                        self.lab_cnts + other.lab_cnts,
                        self.correct + other.correct,
                        self.img_cnt + other.img_cnt)


def seg_batch_stats(pred_cls, targets, num_classes: int,
                    sample_mask=None, impl: str = "auto",
                    device: DeviceLike = None,
                    conf_reduce: Optional[Callable] = None) -> SegAccum:
    """Per-batch contribution; ``pred_cls``/``targets`` are (B, H, W) int
    maps (tensors or arrays), moved to ``device`` (``cuda`` unless the caller
    passes another). ``sample_mask`` (B,) zeroes padded samples in every
    statistic. ``impl``: "auto" (the K1 kernel on CUDA tensors, the plain
    count on CPU tensors) or "einsum" (the plain one-hot count anywhere).
    ``conf_reduce``: applied to the per-image (B, C, C) counts before
    anything is derived from them (a sum over the ranks that hold the
    rows of each image, on a spatial mesh)."""
    dev = resolve_device(device)
    pred = torch.as_tensor(pred_cls, device=dev)
    tgt = torch.as_tensor(targets, device=dev)
    b = pred.shape[0]
    m = (torch.ones((b,), dtype=torch.float32, device=dev) if sample_mask is None
         else torch.as_tensor(sample_mask, device=dev).float())
    if impl == "auto":
        conf_img = confusion_count(pred, tgt, num_classes)
    elif impl == "einsum":
        conf_img = confusion_count_plain(pred, tgt, num_classes)
    else:
        raise ValueError(f"impl must be 'auto' or 'einsum', got {impl!r}")
    if conf_reduce is not None:
        conf_img = conf_reduce(conf_img)
    inter = torch.diagonal(conf_img, dim1=1, dim2=2)
    pred_cnt = conf_img.sum(dim=2)
    lab_cnt = conf_img.sum(dim=1)
    union = pred_cnt + lab_cnt - inter
    iou = torch.where(union == 0, torch.ones_like(union),
                      inter / torch.clamp_min(union, 1.0))
    return SegAccum(
        conf=torch.einsum("bpl,b->pl", conf_img, m),
        iou_sum=torch.einsum("bc,b->c", iou, m),
        lab_cnts=torch.einsum("bc,b->c", lab_cnt, m),
        correct=torch.sum(inter.sum(dim=1) * m),
        img_cnt=torch.sum(m),
    )


def class_batch_stats(pred_cls: torch.Tensor, targets: torch.Tensor,
                      num_classes: int,
                      sample_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Classification counts of a batch (classTrainer.py:144-146): the f32
    confusion ``conf[pred, label]`` (C, C) and the correct count, padded
    samples (``sample_mask`` 0) left out, on the tensors' device. A label
    outside [0, C) adds no confusion entry, as the one-hot form drops it."""
    m = torch.ones(pred_cls.shape[0], device=pred_cls.device) \
        if sample_mask is None else sample_mask.to(pred_cls.device).float()
    classes = torch.arange(num_classes, device=pred_cls.device)
    oh_pred = (pred_cls.long()[:, None] == classes).float()
    oh_tgt = (targets.long()[:, None] == classes).float()
    conf = torch.einsum("bp,bl,b->pl", oh_pred, oh_tgt, m)
    correct = ((pred_cls == targets).float() * m).sum()
    return conf, correct


def to_host(acc: SegAccum) -> SegAccum:
    """Fetch every field as a numpy array."""
    def h(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    return SegAccum(h(acc.conf), h(acc.iou_sum), h(acc.lab_cnts),
                    h(acc.correct), h(acc.img_cnt))


def seg_batch_stats_host(pred_cls, targets, num_classes: int,
                         sample_mask=None,
                         device: DeviceLike = None) -> SegAccum:
    """:func:`seg_batch_stats` with the fields fetched to numpy, for host-side
    accumulation across batches (``SegAccum.zero(C) + ...``)."""
    return to_host(seg_batch_stats(pred_cls, targets, num_classes,
                                   sample_mask, device=device))


def seg_finalize(acc: SegAccum, out_size: float) -> dict:
    """Final metrics matching the reference's printed quantities (numpy)."""
    acc = to_host(acc)
    num_classes = acc.conf.shape[0]
    conf = np.asarray(acc.conf, np.float32)
    lab = np.maximum(acc.lab_cnts, 1e-12)
    conf_norm = conf / (lab[None, :] / 100.0)
    mean_class_acc = np.trace(conf_norm) / num_classes
    mean_iou = np.sum(acc.iou_sum / np.maximum(acc.img_cnt, 1.0)) \
        / num_classes * 100.0
    pixel_acc = acc.correct * out_size * 100.0 / np.maximum(acc.img_cnt, 1.0)
    return {
        "conf": conf_norm,
        "conf_raw": conf,
        "pixel_acc": pixel_acc,
        "mean_class_acc": mean_class_acc,
        "mean_iou": mean_iou,
        "score": (mean_class_acc + mean_iou) / 2.0,
    }


def seg_finalize_tensors(acc: SegAccum, out_size: float) -> dict:
    """:func:`seg_finalize` as f32 tensor ops on the accumulator's device,
    with no host copy (the train loop selects its best epoch on the card
    and fetches the metrics once a chunk)."""
    conf = acc.conf.float()
    num_classes = conf.shape[0]
    lab = torch.clamp_min(acc.lab_cnts.float(), 1e-12)
    conf_norm = conf / (lab[None, :] / 100.0)
    img_cnt = torch.clamp_min(acc.img_cnt.float(), 1.0)
    mean_class_acc = torch.diagonal(conf_norm).sum() / num_classes
    mean_iou = (acc.iou_sum.float() / img_cnt).sum() / num_classes * 100.0
    pixel_acc = acc.correct.float() * out_size * 100.0 / img_cnt
    return {"conf": conf_norm, "pixel_acc": pixel_acc,
            "mean_class_acc": mean_class_acc, "mean_iou": mean_iou,
            "score": (mean_class_acc + mean_iou) / 2.0}
