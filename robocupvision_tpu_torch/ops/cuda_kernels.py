"""The CUDA replacements of the JAX package's ops/pallas_kernels.py, each
with its plain PyTorch version:

- K1 ``confusion_count`` (``confusion_matrix_pallas``, ``csrc/confusion.cu``);
- K3 ``fused_conv3x3_block`` (``fused_conv3x3_block``, ``csrc/conv_block.cu``).

Each wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors; nothing else selects between them. ``<wrapper>.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_KERNEL_MAX_CLASSES = 16  # csrc/confusion.cu kMaxClasses
# label types the kernel reads as they are, by element size (csrc/confusion.cu)
_KERNEL_LABEL_SIZE = {torch.uint8: 1, torch.int32: 4, torch.int64: 8}


def confusion_count_plain(pred: torch.Tensor, tgt: torch.Tensor,
                          num_classes: int) -> torch.Tensor:
    """(B, H, W) int maps -> (B, C, C) f32 counts conf[b, pred, tgt], by the
    one-hot einsum of the JAX package's ``seg_batch_stats(impl="einsum")``.
    A label counts by its value cast to int32, as the JAX package's
    ``astype(jnp.int32)`` casts (an int64 label by its low 32 bits, taken as
    a signed int32); labels outside [0, C) get an all-zero one-hot, i.e. are
    not counted."""
    classes = torch.arange(num_classes, dtype=torch.int32, device=pred.device)
    oh_pred = (pred.to(torch.int32)[..., None] == classes).float()
    oh_tgt = (tgt.to(torch.int32)[..., None] == classes).float()
    return torch.einsum("bhwp,bhwl->bpl", oh_pred, oh_tgt)


def _lib():
    """The kernel's C entry, built and loaded at first use, its argument
    types set once."""
    fn = _lib.fn
    if fn is None:
        from robocupvision_tpu_torch.csrc import build

        fn = build.load("confusion.cu").rcv_confusion_count
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, i32, ptr, i32, ptr, ptr, i64, i64, i32, i32, ptr]
        fn.restype = ctypes.c_int
        _lib.fn = fn
    return fn


_lib.fn = None
# one zeroed workspace of 64-bit words per (device, stream), grown, never
# shrunk
_WORKSPACES = {}


def _workspace(device: torch.device, stream, need: int) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < need:
        size = max(need, 4096, 0 if ws is None else 2 * ws.numel())
        ws = _WORKSPACES[key] = torch.zeros(size, dtype=torch.int64,
                                            device=device)
    return ws


def confusion_count(pred: torch.Tensor, tgt: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """(B, H, W) int maps -> (B, C, C) f32 counts conf[b, pred, tgt].

    CUDA tensors go through the kernel, one launch a call: uint8, int32 and
    int64 maps are read as they are, in any pairing (an int64 label counts
    by its low 32 bits as a signed int32, as the JAX kernel's cast to int32
    counts it); other integer types (int8, int16, ...), which lie off the
    main paths, are cast to int32 first, and maps that are not contiguous
    are made so. The kernel writes the f32 counts itself. CPU tensors go
    through :func:`confusion_count_plain`.

    The kernel sums its blocks' counts in a workspace of 64-bit words that
    is zero between launches (the last block to add to a bin zeroes it);
    there is one per (device, stream), allocated on the stream's first call
    (and grown when a batch needs more), so launches on one stream are
    ordered and two streams never share one."""
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
    p, t = ((m if m.dtype in _KERNEL_LABEL_SIZE else m.to(torch.int32))
            .contiguous() for m in (pred, tgt))
    b, h, w = p.shape
    dev = p.device
    out = torch.empty((b, num_classes, num_classes), dtype=torch.float32,
                      device=dev)
    stream = torch.cuda.current_stream(dev)
    ws = _workspace(dev, stream, b * num_classes * num_classes)
    err = _lib()(p.data_ptr(), _KERNEL_LABEL_SIZE[p.dtype], t.data_ptr(),
                 _KERNEL_LABEL_SIZE[t.dtype], out.data_ptr(), ws.data_ptr(),
                 b, h * w, num_classes, dev.index, stream.cuda_stream)
    if err != 0:
        # a launch that failed may have left the workspace dirty
        _WORKSPACES.pop((dev.index, stream.cuda_stream), None)
        raise RuntimeError(f"confusion_count launch failed: CUDA error {err}")
    confusion_count.launches += 1
    return out


confusion_count.launches = 0


# ---- K3: fused conv3x3 block ------------------------------------------------


def _check_conv_block(x, w, b, scale, shift, tile):
    if x.dim() != 4 or x.shape[0] != 1:
        raise ValueError(f"x must be (1, H, W, C), got {tuple(x.shape)}")
    _, h, _, c = x.shape
    if tile < 1 or h % tile:
        raise ValueError(f"tile={tile} must divide H={h}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"w must be (3, 3, {c}, Co), got {tuple(w.shape)}")
    co = int(w.shape[3])
    for name, t in (("b", b), ("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (co,):
            raise ValueError(f"{name} must be ({co},), got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")


def fused_conv3x3_block_plain(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, scale: torch.Tensor,
                              shift: torch.Tensor,
                              relu_before_bn: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the weights rounded to x's
    dtype, the nine taps (dy, dx in order) summed at f32 as nine einsums
    over shifted views of the zero-padded input, then the f32 epilogue,
    stored at x's dtype."""
    _, h, wd, _ = x.shape
    xp = F.pad(x[0].float(), (0, 0, 1, 1, 1, 1))
    wf = w.to(x.dtype).float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            t = torch.einsum("hwc,co->hwo", xp[dy:dy + h, dx:dx + wd],
                             wf[dy, dx])
            acc = t if acc is None else acc + t
    y = acc + b.float()
    if relu_before_bn:
        y = torch.clamp_min(y, 0.0) * scale.float() + shift.float()
    else:
        y = torch.clamp_min(y * scale.float() + shift.float(), 0.0)
    return y.to(x.dtype)[None]


def conv_block_bf16_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """Per-element tolerance of a bf16 K3 output against its plain version:
    one bf16 ulp of ``|ref|`` (both sides round an f32 sum to bf16; sums in
    another order can land on the other side of a rounding boundary) plus
    ``2**-16 * max|ref|``, for outputs near zero, where the sums' order
    moves the f32 value by more than their own ulp."""
    r = ref.float().abs()
    _, e = torch.frexp(r)
    ulp = torch.where(r > 0, torch.ldexp(torch.ones_like(r), e - 8),
                      torch.zeros_like(r))
    return ulp + r.max() * 2.0 ** -16


def _conv_block_lib():
    from robocupvision_tpu_torch.csrc import build

    fn = build.load("conv_block.cu").rcv_conv3x3_block
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_conv3x3_block(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        scale: torch.Tensor, shift: torch.Tensor,
                        relu_before_bn: bool = True,
                        tile: int = 8) -> torch.Tensor:
    """Fused conv3x3 (stride 1, pad 1) + bias + ReLU/BN affine, (1, H, W, C)
    NHWC with an HWIO (3, 3, C, Co) kernel -> (1, H, W, Co) at x's dtype.
    ``relu_before_bn``: relu(y) * scale + shift, else relu(y * scale +
    shift). ``tile`` output rows a block; it must divide H, as the JAX
    kernel asserts. CUDA tensors (f32 or bf16 x, contiguous) go through
    ``csrc/conv_block.cu``; CPU tensors through
    :func:`fused_conv3x3_block_plain`."""
    _check_conv_block(x, w, b, scale, shift, tile)
    if x.device.type == "cpu":
        return fused_conv3x3_block_plain(x, w, b, scale, shift,
                                         relu_before_bn)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3x3_block runs on cuda or cpu, not "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    _, h, wd, c = x.shape
    co = int(w.shape[3])
    wk = w.to(x.dtype).contiguous()
    vecs = [t.float().contiguous() for t in (b, scale, shift)]
    out = torch.empty((1, h, wd, co), dtype=x.dtype, device=x.device)
    fn = _conv_block_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), wk.data_ptr(), *(v.data_ptr() for v in vecs),
                 out.data_ptr(), h, wd, c, co, tile, int(relu_before_bn),
                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_conv3x3_block launch failed: CUDA error "
                           f"{err}")
    fused_conv3x3_block.launches += 1
    return out


fused_conv3x3_block.launches = 0
