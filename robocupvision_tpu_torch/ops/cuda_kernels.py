"""K1 `confusion_count`: the CUDA replacement of the JAX package's
``confusion_matrix_pallas`` (robocupvision_tpu/ops/pallas_kernels.py), and
its plain PyTorch version.

``confusion_count`` launches ``csrc/confusion.cu`` for CUDA tensors and runs
``confusion_count_plain`` for CPU tensors; nothing else selects between
them. ``confusion_count.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

_KERNEL_MAX_CLASSES = 16  # csrc/confusion.cu kMaxClasses


def confusion_count_plain(pred: torch.Tensor, tgt: torch.Tensor,
                          num_classes: int) -> torch.Tensor:
    """(B, H, W) int maps -> (B, C, C) f32 counts conf[b, pred, tgt], by the
    one-hot einsum of the JAX package's ``seg_batch_stats(impl="einsum")``.
    Labels outside [0, C) get an all-zero one-hot, i.e. are not counted."""
    classes = torch.arange(num_classes, device=pred.device)
    oh_pred = (pred.long()[..., None] == classes).float()
    oh_tgt = (tgt.long()[..., None] == classes).float()
    return torch.einsum("bhwp,bhwl->bpl", oh_pred, oh_tgt)


def _lib():
    from robocupvision_tpu_torch.csrc import build

    lib = build.load("confusion.cu")
    fn = lib.rcv_confusion_count
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def confusion_count(pred: torch.Tensor, tgt: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """(B, H, W) int maps -> (B, C, C) f32 counts conf[b, pred, tgt].

    CUDA tensors go through the kernel (int64 maps, e.g. from
    ``torch.argmax``, are cast to int32 first, as the JAX kernel casts);
    CPU tensors through :func:`confusion_count_plain`."""
    if pred.shape != tgt.shape or pred.dim() != 3:
        raise ValueError(f"pred {tuple(pred.shape)} and tgt {tuple(tgt.shape)} "
                         "must both be (B, H, W)")
    if pred.device != tgt.device:
        raise ValueError(f"pred on {pred.device}, tgt on {tgt.device}")
    if pred.device.type == "cpu":
        return confusion_count_plain(pred, tgt, num_classes)
    if pred.device.type != "cuda":
        raise ValueError(f"confusion_count runs on cuda or cpu, not {pred.device}")
    for name, t in (("pred", pred), ("tgt", tgt)):
        if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
            raise TypeError(f"{name} must be an integer label map, got {t.dtype}")
    if not 1 <= num_classes <= _KERNEL_MAX_CLASSES:
        raise ValueError(f"num_classes={num_classes} outside the kernel's "
                         f"1..{_KERNEL_MAX_CLASSES}")
    p32 = pred.to(torch.int32).contiguous()
    t32 = tgt.to(torch.int32).contiguous()
    b, h, w = p32.shape
    out = torch.zeros((b, num_classes, num_classes), dtype=torch.int32,
                      device=pred.device)
    fn = _lib()
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(p32.data_ptr(), t32.data_ptr(), out.data_ptr(), b, h * w,
                 num_classes, stream)
    if err != 0:
        raise RuntimeError(f"confusion_count launch failed: CUDA error {err}")
    confusion_count.launches += 1
    return out.float()


confusion_count.launches = 0
