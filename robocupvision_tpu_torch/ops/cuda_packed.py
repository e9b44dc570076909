"""K2 `fused_conv_chain`: N consecutive conv stages on one lane-packed grid
as ONE CUDA kernel (``csrc/conv_chain.cu``), the replacement of the JAX
package's Pallas kernel ``fused_conv_chain``
(robocupvision_tpu/ops/pallas_packed.py), with its plain PyTorch version
:func:`chain_reference`.

A stage is a 3x3/s1 or 1x1 conv, ``dil``-dilated with padding
``dil * (K // 2)``, then bias, then the folded-BN affine (``rbb``: conv ->
ReLU -> affine; else conv -> affine -> ReLU) or, for a ``relu_only`` stage,
a bare ReLU, then an identity skip add. A ``skip_w`` stage instead adds
``conv(skips[skip_idx], skip_w)`` (a (K, K, Cskip, Cout) kernel, K in {1,
3}, padding K // 2) to the conv's f32 sum before the bias: the second half
of a conv split over a concat, or LabelProp's channel-slice skip folded
into its classifier. A ``pool`` stage is the --UNet downs' packed 2x2/s2
max pool (``models/packed.packed_max_pool``): its ``w`` is the (1, 4, Cin,
Cout) stack of 0/1 lane-selection matrices, output lane l is the max over
t of the input lane that column l of matrix t selects, with no bias and no
epilogue, so it reads no halo and its output is bit-identical to
``packed_max_pool``. Rows and columns outside the image are zero (they are
the next stage's padding) and every inter-stage value is rounded to the
chain dtype. Stage 0 may be the folded space-to-depth stem
(``stem_f = f``): the chain then takes the raw (N, f*H, f*W, cin) image and
the stem's (f+2, 3, f*cin, Cout) kernel runs as the (f, 1)-strided,
padding-1 conv over its free grouped view (N, f*H, W, f*cin), so the chain
grid is (H, W). Only ``emit`` stages (and always the last) are returned. The
last stage may carry the fused serving argmax (``argmax_groups``): per-phase
int32 labels instead of logits, first max winning ties.

``fused_conv_chain`` launches the kernel for CUDA tensors and runs
:func:`chain_reference` for CPU tensors; nothing else selects between them.
``fused_conv_chain.launches`` counts kernel launches.

The int8 stage feature of the JAX kernel (``x_scale``/``w_scale``) keeps
its ChainStage fields but raises ``NotImplementedError`` in both paths.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, List, Sequence

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ChainStage:
    """One conv(+epilogue) stage of a fused region (fields as in the JAX
    package's ChainStage).

    w: (K, K, Cin, Cout) kernel (K in {1, 3}), already packed/BN-folded;
    (f+2, 3, f*cin, Cout) for a ``stem_f = f`` stage. b: (Cout,) bias.
    scale/shift: (Cout,) folded-BN affine (None for the bias-only head and
    for ``relu_only`` stages). rbb: affine order (see module docstring).
    skip_idx: index into the chain's ``skips`` added after the epilogue, -1
    for none. skip_w: (K, K, Cskip, Cout) kernel that takes
    ``skips[skip_idx]`` through a conv added before the bias instead.
    emit: return this stage's (N, H, W, Cout) output. stem_f:
    stage 0 only, the folded stem's factor. relu_only: ReLU instead of an
    affine. dil: tap spacing. argmax_groups: last stage only, emit (N, H,
    W, groups) int32 labels, argmax over each group of Cout/groups adjacent
    channels. pool: a packed max pool whose ``w`` is the (1, 4, Cin, Cout)
    lane-selection stack (and ``b`` an unused zero bias). pool_src: the
    pool's (4, Cout) int32 table of source lanes (:func:`pool_table` of
    ``w``), which the kernel reads; ``None`` derives it from ``w`` on each
    call.
    """

    w: Any
    b: Any
    scale: Any = None
    shift: Any = None
    rbb: bool = True
    skip_idx: int = -1
    emit: bool = False
    stem_f: int = 0
    relu_only: bool = False
    skip_w: Any = None
    dil: int = 1
    argmax_groups: int = 0
    pool: bool = False
    pool_src: Any = None
    x_scale: float = 0.0
    w_scale: Any = None

    @property
    def k(self) -> int:
        return int(self.w.shape[0])

    @property
    def reach(self) -> int:
        """Rows/cols of input context beyond the center this stage reads."""
        return self.dil * (self.k // 2)


def _halo_depths(stages: Sequence[ChainStage]) -> List[int]:
    """d[k]: extra rows stage k must produce so later 3x3 stages see halos."""
    d = [0] * len(stages)
    for k in range(len(stages) - 2, -1, -1):
        d[k] = d[k + 1] + stages[k + 1].reach
    return d


def with_argmax_head(stages: Sequence[ChainStage],
                     groups: int) -> List[ChainStage]:
    """The chain's serving form: the final (classifier) stage emits fused
    per-phase int32 labels instead of logits."""
    stages = list(stages)
    stages[-1] = dataclasses.replace(stages[-1], argmax_groups=groups,
                                     emit=True)
    return stages


def pool_table(w: torch.Tensor) -> torch.Tensor:
    """A pool stage's (4, Cout) int32 table of source lanes, on ``w``'s
    device: entry [t, l] is the one row of selection matrix ``w[0, t]``
    whose column l holds a 1. Raises ``ValueError`` unless every column of
    every matrix holds exactly one 1 and zeros elsewhere."""
    sel = w.detach()[0]
    ones = sel == 1
    if not (bool(((sel == 0) | ones).all())
            and bool((ones.sum(dim=1) == 1).all())):
        raise ValueError("a pool stage's selection matrices need exactly one "
                         "1 in every column and zeros elsewhere")
    return ones.to(torch.int32).argmax(dim=1).to(torch.int32).contiguous()


def _check_pool(i: int, st: ChainStage) -> ChainStage:
    """The JAX kernel's asserts on a pool stage: the selection stack only.
    Returns the stage with its ``pool_src`` table, derived from (and
    checked against the form of) ``w`` when the caller gave none."""
    if st.w.dim() != 4 or tuple(st.w.shape[:2]) != (1, 4):
        raise ValueError(f"stage {i}: a pool stage's w is the (1, 4, Cin, "
                         f"Cout) selection stack, got {tuple(st.w.shape)}")
    extra = [name for name, on in (
        ("scale", st.scale is not None), ("relu_only", st.relu_only),
        ("skip_idx", st.skip_idx >= 0), ("skip_w", st.skip_w is not None),
        ("stem_f", st.stem_f), ("argmax_groups", st.argmax_groups)) if on]
    if extra:
        raise ValueError(f"stage {i}: a pool stage takes no "
                         f"{', '.join(extra)}")
    if st.pool_src is None:
        return dataclasses.replace(st, pool_src=pool_table(st.w))
    if tuple(st.pool_src.shape) != (4, int(st.w.shape[3])):
        raise ValueError(f"stage {i}: pool_src must be (4, "
                         f"{int(st.w.shape[3])}), got "
                         f"{tuple(st.pool_src.shape)}")
    return st


def _prepare(stages: Sequence[ChainStage]) -> List[ChainStage]:
    """Validate a chain for this port and mark its last stage emitted."""
    stages = list(stages)
    if not stages:
        raise ValueError("a chain needs at least one stage")
    if not stages[-1].emit:
        stages[-1] = dataclasses.replace(stages[-1], emit=True)
    for i, st in enumerate(stages):
        if st.x_scale or st.w_scale is not None:
            raise NotImplementedError(
                f"stage {i}: int8 (x_scale, w_scale) not ported yet (plain, "
                "dilated, relu-only, conv'd-skip, folded-stem and pool stages "
                "and the argmax head only)")
        if st.pool:
            stages[i] = _check_pool(i, st)
            continue
        if st.w.dim() != 4:
            raise ValueError(f"stage {i}: kernel must be 4-D, got "
                             f"{tuple(st.w.shape)}")
        if st.stem_f:
            f = st.stem_f
            if i != 0 or st.dil != 1 or tuple(st.w.shape[:2]) != (f + 2, 3):
                raise ValueError(
                    f"stage {i}: a stem_f={f} stage is stage 0, undilated, "
                    f"with an ({f + 2}, 3, {f}*cin, Cout) kernel, got "
                    f"{tuple(st.w.shape)}")
        elif st.k not in (1, 3) or st.w.shape[0] != st.w.shape[1]:
            raise ValueError(f"stage {i}: kernel must be (K, K, Cin, Cout) "
                             f"with K in (1, 3), got {tuple(st.w.shape)}")
        if st.dil < 1:
            raise ValueError(f"stage {i}: dil must be >= 1, got {st.dil}")
        if st.skip_w is not None:
            sw = st.skip_w
            if (sw.dim() != 4 or int(sw.shape[0]) not in (1, 3)
                    or sw.shape[0] != sw.shape[1]
                    or sw.shape[3] != st.w.shape[3]):
                raise ValueError(
                    f"stage {i}: skip_w must be (K, K, Cskip, "
                    f"{int(st.w.shape[3])}) with K in (1, 3), got "
                    f"{tuple(sw.shape)}")
            if st.skip_idx < 0:
                raise ValueError(f"stage {i}: skip_w needs a skip_idx >= 0")
        if st.argmax_groups and i != len(stages) - 1:
            raise ValueError("argmax_groups is a final-stage (serving head) "
                             "epilogue")
    last = stages[-1]
    if last.argmax_groups:
        if last.scale is not None or last.relu_only:
            raise ValueError("the argmax head is the bias-only classifier")
        if int(last.w.shape[3]) % last.argmax_groups:
            raise ValueError("Cout must split into argmax_groups groups")
    return stages


def chain_reference(x: torch.Tensor, stages: Sequence[ChainStage],
                    skips: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
    """Plain-PyTorch mirror of :func:`fused_conv_chain` at the same rounding
    points: f32 convs of the chain-dtype activations and kernels, f32
    epilogue, and rounding to the chain dtype between stages and at every
    emitted output. The test oracle for the kernel, and its CPU path."""
    stages = _prepare(stages)
    chain_dtype = x.dtype
    h = x
    outs = []
    for k, st in enumerate(stages):
        cout = int(st.w.shape[3])
        if st.pool:
            # the max over the four 0/1 selections (exact gathers, as the
            # JAX package's chain_reference computes them), no epilogue
            sel = st.w[0].float()
            hf = h.float()
            y = torch.einsum("nhwc,cd->nhwd", hf, sel[0])
            for t in range(1, 4):
                y = torch.maximum(y, torch.einsum("nhwc,cd->nhwd", hf, sel[t]))
            if st.emit:
                outs.append(y.to(chain_dtype))
            h = y.to(chain_dtype)
            continue
        # (KH, KW, in, out) -> OIHW, at the chain dtype as the kernel reads it
        w = st.w.to(chain_dtype).float().permute(3, 2, 0, 1)
        if st.stem_f:
            f = st.stem_f
            n, hf, wf, cin = h.shape
            xg = h.float().reshape(n, hf, wf // f, f * cin)
            y = F.conv2d(xg.permute(0, 3, 1, 2), w, stride=(f, 1), padding=1)
        else:
            y = F.conv2d(h.float().permute(0, 3, 1, 2), w, padding=st.reach,
                         dilation=st.dil)
        if st.skip_w is not None:
            # the skip's conv, its kernel at the chain dtype, summed in f32
            # before the bias
            sw = st.skip_w.to(chain_dtype).float().permute(3, 2, 0, 1)
            y = y + F.conv2d(skips[st.skip_idx].float().permute(0, 3, 1, 2),
                             sw, padding=int(sw.shape[2]) // 2)
        y = y.permute(0, 2, 3, 1) + st.b.float()
        if st.scale is not None:
            s, sh = st.scale.float(), st.shift.float()
            y = torch.clamp_min(y, 0.) * s + sh if st.rbb \
                else torch.clamp_min(y * s + sh, 0.)
        elif st.relu_only:
            y = torch.clamp_min(y, 0.)
        if st.skip_idx >= 0 and st.skip_w is None:
            y = y + skips[st.skip_idx].float()
        if st.argmax_groups:
            yr = y.to(chain_dtype).float()
            n, H, W, _ = yr.shape
            lab = torch.argmax(yr.reshape(n, H, W, st.argmax_groups,
                                          cout // st.argmax_groups), dim=-1)
            outs.append(lab.to(torch.int32))
            break
        if st.emit:
            outs.append(y.to(chain_dtype))
        h = y.to(chain_dtype)
    return outs


# ---------------------------------------------------------------------------
# the CUDA path
# ---------------------------------------------------------------------------

_MAX_STAGES = 16  # csrc/conv_chain.cu RCV_MAX_STAGES
_MAX_SKIPS = 4    # csrc/conv_chain.cu RCV_MAX_SKIPS


class _Stage(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("scale", ctypes.c_void_p), ("shift", ctypes.c_void_p),
                ("skip_w", ctypes.c_void_p), ("pool_src", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("ws_off", ctypes.c_longlong),
                ("kh", ctypes.c_int), ("kw", ctypes.c_int),
                ("cin", ctypes.c_int), ("cout", ctypes.c_int),
                ("rbb", ctypes.c_int), ("skip_idx", ctypes.c_int),
                ("argmax_groups", ctypes.c_int), ("depth", ctypes.c_int),
                ("dil", ctypes.c_int), ("stem_f", ctypes.c_int),
                ("relu_only", ctypes.c_int), ("skip_k", ctypes.c_int),
                ("skip_cin", ctypes.c_int), ("pool", ctypes.c_int)]


class _Chain(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("skips", ctypes.c_void_p * _MAX_SKIPS),
                ("ws", ctypes.c_void_p), ("ws_per_block", ctypes.c_longlong),
                ("n", ctypes.c_int), ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("band", ctypes.c_int), ("n_stages", ctypes.c_int),
                ("bf16", ctypes.c_int), ("pad0", ctypes.c_int),
                ("pad1", ctypes.c_int),
                ("st", _Stage * _MAX_STAGES)]


def _lib():
    from robocupvision_tpu_torch.csrc import build

    lib = build.load("conv_chain.cu")
    fn = lib.rcv_conv_chain
    fn.argtypes = [ctypes.POINTER(_Chain), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def choose_band(n: int, h: int, device: torch.device) -> int:
    """Rows per block: the largest divisor of ``h`` that still gives at
    least one block per SM of this card; ``1`` when even that is too few.
    The band changes only how halo rows are recomputed, never a result."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for band in range(h, 0, -1):
        if h % band == 0 and n * (h // band) >= sms:
            return band
    return 1


def bf16_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """Per-element tolerance of a bf16 chain output against its plain
    version: two bf16 ulps of ``|ref|`` plus ``2**-8 * max|ref|``. Both
    sides round every stage to bf16, so a sum that lands on the other side
    of a rounding boundary moves by an ulp, which the later stages carry;
    the absolute term covers outputs near zero."""
    r = ref.float().abs()
    _, e = torch.frexp(r)
    ulp = torch.where(r > 0, torch.ldexp(torch.ones_like(r), e - 8),
                      torch.zeros_like(r))
    return 2 * ulp + r.max() * 2.0 ** -8


def _param(t, device, dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor on ``device`` whose data is
    16-byte aligned (the kernel loads weights in vectors of 4)."""
    t = torch.as_tensor(t).to(device=device, dtype=dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_conv_chain(x: torch.Tensor, stages: Sequence[ChainStage],
                     skips: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
    """Run a fused chain of conv3x3(s1)/conv1x1 (+epilogue, +skip) and
    packed max-pool stages.

    x: (N, H, W, C0) in f32 or bf16, or the raw (N, f*H, f*W, cin) image
    when stage 0 is a ``stem_f = f`` stem. Kernels are read at x's dtype (as the
    JAX kernel reads them); bias and affine in f32. Returns the emitted
    outputs in stage order (the last stage always). CUDA tensors launch the
    kernel (one launch per call); CPU tensors run :func:`chain_reference`."""
    stages = _prepare(stages)
    if x.device.type == "cpu":
        return chain_reference(x, stages, skips)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_chain runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"chain dtype must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (N, H, W, C) tensor")
    if len(stages) > _MAX_STAGES or len(skips) > _MAX_SKIPS:
        raise ValueError(f"at most {_MAX_STAGES} stages and {_MAX_SKIPS} skips")
    n, H, W, c0 = x.shape
    f = stages[0].stem_f
    if f:
        if H % f or W % f:
            raise ValueError(f"a stem_f={f} chain needs an image whose height "
                             f"and width divide by {f}, got {H}x{W}")
        H, W, c0 = H // f, W // f, f * c0
    for s in skips:
        if (s.device != x.device or s.dtype != x.dtype or s.dim() != 4
                or tuple(s.shape[:3]) != (n, H, W) or not s.is_contiguous()):
            raise ValueError("skips must be contiguous (N, H, W, C) tensors "
                             "on x's device, in x's dtype")
    band = choose_band(n, H, x.device)
    if band < 1 or H % band:
        raise ValueError(f"band={band} must divide H={H}")
    depths = _halo_depths(stages)

    dev = x.device
    keep = []  # parameter copies that must outlive the launch call
    outs = []
    desc = _Chain()
    desc.x = x.data_ptr()
    for i, s in enumerate(skips):
        desc.skips[i] = s.data_ptr()
    ws_elems = 0
    cin = c0
    for i, st in enumerate(stages):
        kh, kw, wcin, cout = (int(v) for v in st.w.shape)
        if wcin != cin:
            raise ValueError(f"stage {i}: Cin {wcin} != incoming channels {cin}")
        # an identity skip is cout wide, a conv'd one skip_w's Cskip
        skip_c = cout if st.skip_w is None else int(st.skip_w.shape[2])
        if st.skip_idx >= 0 and (st.skip_idx >= len(skips)
                                 or skips[st.skip_idx].shape[3] != skip_c):
            raise ValueError(f"stage {i}: skip {st.skip_idx} missing or not "
                             f"{skip_c} channels wide")
        d = desc.st[i]
        if st.pool:
            # the selection stack's (1, 4) is no tap grid: the kernel reads
            # the table of source lanes instead
            table = _param(st.pool_src, dev, torch.int32)
            keep.append(table)
            d.pool, d.pool_src, kh, kw = 1, table.data_ptr(), 1, 1
        else:
            w, b = _param(st.w, dev, x.dtype), _param(st.b, dev, torch.float32)
            keep += [w, b]
            d.w, d.b = w.data_ptr(), b.data_ptr()
        if st.scale is not None:
            sc = _param(st.scale, dev, torch.float32)
            sh = _param(st.shift, dev, torch.float32)
            keep += [sc, sh]
            d.scale, d.shift = sc.data_ptr(), sh.data_ptr()
        if st.skip_w is not None:
            sw = _param(st.skip_w, dev, x.dtype)
            keep.append(sw)
            d.skip_w = sw.data_ptr()
            d.skip_k, d.skip_cin = int(sw.shape[0]), int(sw.shape[2])
        if st.argmax_groups:
            out = torch.empty((n, H, W, st.argmax_groups), dtype=torch.int32,
                              device=dev)
        elif st.emit:
            out = torch.empty((n, H, W, cout), dtype=x.dtype, device=dev)
        else:
            out = None
        if out is not None:
            outs.append(out)
            d.out = out.data_ptr()
        # a strip of (band + 2*depth) rows lives in the block's workspace for
        # every stage the next stage reads, and for the argmax head's logits
        if i + 1 < len(stages) or st.argmax_groups:
            d.ws_off = ws_elems
            ws_elems += (band + 2 * depths[i]) * W * cout
        else:
            d.ws_off = -1
        d.kh, d.kw, d.cin, d.cout, d.rbb = kh, kw, wcin, cout, int(st.rbb)
        d.skip_idx, d.argmax_groups, d.depth = st.skip_idx, st.argmax_groups, depths[i]
        d.dil, d.stem_f, d.relu_only = st.dil, st.stem_f, int(st.relu_only)
        cin = cout
    ws = torch.empty((max(n * (H // band) * ws_elems, 1),), dtype=x.dtype,
                     device=dev)
    desc.ws, desc.ws_per_block = ws.data_ptr(), ws_elems
    desc.n, desc.h, desc.w, desc.band = n, H, W, band
    desc.n_stages, desc.bf16 = len(stages), int(x.dtype == torch.bfloat16)

    fn = _lib()
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(desc), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_conv_chain launch failed: CUDA error {err}")
    fused_conv_chain.launches += 1
    return outs


fused_conv_chain.launches = 0
