"""The CUDA replacements of the JAX package's ops/pallas_kernels.py, each
with its plain PyTorch version:

- K1 ``confusion_count`` (``confusion_matrix_pallas``, ``csrc/confusion.cu``);
- K3 ``fused_conv3x3_block`` (``fused_conv3x3_block``, ``csrc/conv_block.cu``);

and two that replace no TPU kernel: K4 ``legacy_jitter``
(``csrc/legacy_jitter.cu``), the legacy flips and ColorJitter in one pass a
pixel; K5 ``seg_head`` (``csrc/seg_head.cu``), the SegFormer's folded
decoder head gathered in one pass a pixel.

K1's, K3's and K5's wrappers launch their kernel for CUDA tensors and run
their plain version for CPU tensors; nothing else selects between them. K4's
plain version is ``ops/color.py``'s ``legacy_augment_batch_plain``, and
``color.legacy_augment_batch`` selects: CUDA tensors go to K4, with the
plain version's constants, and K4's wrapper takes nothing else. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from robocupvision_tpu_torch.ops import nn
from robocupvision_tpu_torch.utils import profiling

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


# ---- K4: the legacy flips and ColorJitter -----------------------------------

_K4_MAX_PARTS = 64  # csrc/legacy_jitter.cu kMaxParts: partials a sample


def _k4_lib():
    """K4's C entry, at first use."""
    if _k4_lib.fn is None:
        from robocupvision_tpu_torch.csrc import build

        fn = build.load("legacy_jitter.cu").rcv_legacy_jitter
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 4 + [i32] + [ptr] * 8 \
            + [ctypes.POINTER(ctypes.c_float)] + [i32] * 5 + [ptr]
        fn.restype = ctypes.c_int
        _k4_lib.fn = fn
    return _k4_lib.fn


_k4_lib.fn = None

_K4_DRAWS = (("hflip", torch.bool, ()), ("vflip", torch.bool, ()))
_K4_JITTER_DRAWS = (("b", torch.float32, ()), ("c", torch.float32, ()),
                    ("s", torch.float32, ()), ("h", torch.float32, ()),
                    ("order", torch.int64, (4,)))


def legacy_jitter(imgs: torch.Tensor, labels, draws, jitter: bool,
                  tables: np.ndarray):
    """:func:`color.legacy_augment_batch` of a CUDA batch through K4: the
    YUV-normalized (N, H, W, C) f32 images and their (N, H, W) labels (None:
    images only) flipped per ``draws["hflip"]`` / ``["vflip"]``, then, with
    ``jitter``, each image's RGB ColorJitter with its factors ``b``, ``c``,
    ``s``, ``h`` and op ``order`` (:func:`color.draw_legacy_augment`; each
    order a permutation of 0..3). ``tables``: the 21 f32 constants of the
    plain version (``color.LEGACY_JITTER_TABLES``). -> (images, labels or
    None), new tensors.

    Two launches with ``jitter`` (the contrast means, then the pixels), one
    without; no host sync. The images must be contiguous f32 (C = 3 with
    ``jitter``, any C without), the labels contiguous uint8, int32 or int64;
    anything else raises. The draws are taken to the images' device and
    dtype, and made contiguous (a mesh rank's draws are strided views).
    Each call adds 1 to the tracer's counter ``k4.calls``."""
    if imgs.device.type != "cuda":
        raise ValueError(f"legacy_jitter runs on cuda, not {imgs.device}")
    if imgs.dim() != 4:
        raise ValueError(f"imgs must be (N, H, W, C), got {tuple(imgs.shape)}")
    n, h, w, c = imgs.shape
    if imgs.dtype != torch.float32:
        raise TypeError(f"imgs must be float32, got {imgs.dtype}")
    if jitter and c != 3:
        raise ValueError(f"the jitter takes RGB's 3 channels, not {c}")
    if not imgs.is_contiguous():
        raise ValueError("imgs must be contiguous (NHWC)")
    if labels is not None:
        if tuple(labels.shape) != (n, h, w):
            raise ValueError(f"labels must be {(n, h, w)}, got "
                             f"{tuple(labels.shape)}")
        if labels.device != imgs.device:
            raise ValueError(f"labels on {labels.device}, imgs on "
                             f"{imgs.device}")
        if labels.dtype not in _KERNEL_LABEL_SIZE:
            raise TypeError(f"labels must be uint8, int32 or int64, got "
                            f"{labels.dtype}")
        if not labels.is_contiguous():
            raise ValueError("labels must be contiguous")
    if n > 65535:
        raise ValueError(f"the kernel's grid holds 65535 images, not {n}")
    if tables.dtype != np.float32 or tables.shape != (21,) \
            or not tables.flags.c_contiguous:
        raise ValueError("tables must be 21 contiguous float32 values")
    dev = imgs.device
    d = {}
    for key, dtype, tail in _K4_DRAWS + (_K4_JITTER_DRAWS if jitter else ()):
        t = torch.as_tensor(draws[key]).to(device=dev, dtype=dtype)
        if tuple(t.shape) != (n, *tail):
            raise ValueError(f"draws[{key!r}] must be {(n, *tail)}, got "
                             f"{tuple(t.shape)}")
        d[key] = t.contiguous()
    out = torch.empty_like(imgs)
    lab_out = None if labels is None else torch.empty_like(labels)
    partials = torch.empty(n * _K4_MAX_PARTS, dtype=torch.float64,
                           device=dev) if jitter else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _k4_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(imgs.data_ptr(), out.data_ptr(), ptr(labels), ptr(lab_out),
                 0 if labels is None else _KERNEL_LABEL_SIZE[labels.dtype],
                 d["hflip"].data_ptr(), d["vflip"].data_ptr(),
                 *(ptr(d.get(k)) for k in ("b", "c", "s", "h", "order")),
                 ptr(partials),
                 tables.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                 n, h, w, c, int(jitter), stream)
    if err != 0:
        raise RuntimeError(f"legacy_jitter launch failed: CUDA error {err}")
    legacy_jitter.launches += 2 if jitter else 1
    profiling.count("k4.calls")
    return out, lab_out


legacy_jitter.launches = 0


# ---- K5: the SegFormer's folded head gather ---------------------------------

_K5_MAX_WIDTH = 1024  # csrc/seg_head.cu: a thread a channel quad, 256 threads


def seg_head_plain(ys, bias: torch.Tensor, w_pred: torch.Tensor,
                   b_pred: torch.Tensor) -> torch.Tensor:
    """The head's function in plain PyTorch, at f32 (f64 for f64 maps):
    ``ys`` the four stage maps (N, H_i, W_i, D), the first at the output's
    (H, W) -> ``W_pred ReLU(y_1 + b' + up(y_2) + up(y_3) + up(y_4)) +
    b_pred``, (N, H, W, K) at ``ys``' dtype; ``up`` PyTorch's bilinear
    resize to (H, W), align_corners False."""
    y1 = ys[0]
    acc = torch.promote_types(y1.dtype, torch.float32)
    h = y1.to(acc) + bias.to(acc)
    for y in ys[1:]:
        h = h + nn.resize_bilinear(y.to(acc), y1.shape[1:3])
    return F.linear(nn.relu(h), w_pred.to(acc), b_pred.to(acc)).to(y1.dtype)


def _check_seg_head(ys, bias, w_pred, b_pred):
    if len(ys) != 4 or any(y.dim() != 4 for y in ys):
        raise ValueError("ys must be four (N, H_i, W_i, D) maps, got "
                         f"{[tuple(y.shape) for y in ys]}")
    n, _, _, d = ys[0].shape
    if any(y.shape[0] != n or y.shape[3] != d for y in ys) \
            or any(0 in y.shape[1:3] for y in ys):
        raise ValueError(f"the maps differ in N or D, or one is empty: "
                         f"{[tuple(y.shape) for y in ys]}")
    if w_pred.dim() != 2 or w_pred.shape[1] != d:
        raise ValueError(f"w_pred must be (K, {d}), got "
                         f"{tuple(w_pred.shape)}")
    k = w_pred.shape[0]
    for name, t, shape in (("bias", bias, (d,)), ("b_pred", b_pred, (k,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for t in (*ys[1:], bias, w_pred, b_pred):
        if t.device != ys[0].device:
            raise ValueError(f"a tensor on {t.device}, ys[0] on "
                             f"{ys[0].device}")


def _k5_lib():
    """K5's C entry, at first use."""
    if _k5_lib.fn is None:
        from robocupvision_tpu_torch.csrc import build

        fn = build.load("seg_head.cu").rcv_seg_head
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _k5_lib.fn = fn
    return _k5_lib.fn


_k5_lib.fn = None


def seg_head(ys, bias: torch.Tensor, w_pred: torch.Tensor,
             b_pred: torch.Tensor) -> torch.Tensor:
    """K5: the SegFormer's folded decoder head (``models/segformer.py``)
    at the first map's (H, W): ``ys`` the stage maps y_1..y_4 (N, H_i,
    W_i, D), ``bias`` b' (D,), ``w_pred`` (K, D), ``b_pred`` (K,) ->
    (N, H, W, K) logits at ``ys``' dtype, accumulated at f32.

    CUDA tensors go through ``csrc/seg_head.cu``: the maps f32 or bf16,
    all of one dtype, contiguous, D a multiple of 4 up to 1024, N and H at
    most 65535; one launch for up to 8 classes, one more for each further
    8. Anything else raises. Each call adds 1 to the tracer's counter
    ``k5.calls``. CPU tensors go through :func:`seg_head_plain`."""
    _check_seg_head(ys, bias, w_pred, b_pred)
    y1 = ys[0]
    if y1.device.type == "cpu":
        return seg_head_plain(ys, bias, w_pred, b_pred)
    if y1.device.type != "cuda":
        raise ValueError(f"seg_head runs on cuda or cpu, not {y1.device}")
    if y1.dtype not in (torch.float32, torch.bfloat16) \
            or any(y.dtype != y1.dtype for y in ys):
        raise TypeError(f"the maps must all be float32 or all bfloat16, got "
                        f"{[y.dtype for y in ys]}")
    if not all(y.is_contiguous() for y in ys):
        raise ValueError("the maps must be contiguous (NHWC)")
    n, h, w, d = y1.shape
    if d % 4 or not 0 < d <= _K5_MAX_WIDTH:
        raise ValueError(f"D={d}: the kernel takes a multiple of 4 up to "
                         f"{_K5_MAX_WIDTH}")
    if n > 65535 or h > 65535:
        raise ValueError(f"the kernel's grid holds 65535 images and rows, "
                         f"not {n} and {h}")
    if any(y.data_ptr() % (4 * y.element_size()) for y in ys):
        raise ValueError("the maps must start on a channel quad's alignment")
    k = w_pred.shape[0]
    out = torch.empty((n, h, w, k), dtype=y1.dtype, device=y1.device)
    if out.numel() == 0:   # N = 0 or K = 0
        return out
    vecs = [t.float().contiguous() for t in (bias, w_pred, b_pred)]
    vecs = [v if v.data_ptr() % 16 == 0 else v.clone() for v in vecs]
    sizes = [s for y in ys for s in y.shape[1:3]]
    fn = _k5_lib()
    with torch.cuda.device(y1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(y.data_ptr() for y in ys), *(v.data_ptr() for v in vecs),
                 out.data_ptr(), *sizes, n, d, k,
                 int(y1.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"seg_head launch failed: CUDA error {err}")
    seg_head.launches += -(-k // 8)
    profiling.count("k5.calls")
    return out


seg_head.launches = 0
