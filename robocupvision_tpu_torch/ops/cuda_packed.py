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

A chain may be int8 (static post-training quantization, the JAX
package's ``x_scale``/``w_scale`` stages), every stage or none: stage 0
quantizes its input to int8 at its ``x_scale`` (round half to even, clip to
+-127), a conv stage takes int8 weights with a per-output-channel
``w_scale``, sums its integer products exactly and dequantizes with
``acc * (w_scale * x_scale)`` before the float bias, epilogue and skips
(which stay float, at the chain dtype); a pool stage takes the max of the
integers times its ``x_scale``. Between stages the f32 result is
requantized at the next stage's ``x_scale``; emitted outputs and the argmax
head's logits are rounded to the chain dtype as in a float chain.
:func:`chain_stats` takes the calibration statistics of a float chain and
:func:`quantize_chain_stages` turns them into an int8 chain.

The kernel's tap loops walk only the weight blocks that are not all zero
(the packed kernels are mostly structural zeros): :func:`tap_blocks` lists
them once, where a graph builds its stages (``ChainStage.taps``).

``fused_conv_chain`` launches the kernel for CUDA tensors and runs
:func:`chain_reference` for CPU tensors; nothing else selects between them.
``fused_conv_chain.launches`` counts kernel launches and
``chain_reference.calls`` the plain version's calls.

The same launch is also the op ``robocupvision_tpu_torch::fused_conv_chain``
(``torch.library``; importing this module registers it), which a
``torch.export`` graph holds as one opaque node a chain
(:func:`fused_conv_chain_op`, export/aot.py): its CUDA implementation is the
launch above, its CPU implementation :func:`chain_reference`, and its fake
implementation gives each emitted output's shape and dtype. The op's schema
takes tensors, ints and floats only, so a chain enters it flattened
(:func:`chain_op_args`): every stage's tensors in one list, its switches and
tap-list widths in an int list, its input scale in a float list; the tap
lists and pool tables are built before the graph is traced and enter as
constant tensors, since they are read off weight values.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, List, NamedTuple, Sequence

import numpy as np
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
    call. x_scale: an int8 stage's static input scale (> 0; 0 for a float
    stage). w_scale: an int8 conv stage's (Cout,) f32 dequant row, its
    ``w`` then int8 (pool stages keep their 0/1 selections and take none).
    taps: a conv stage's :class:`TapBlocks` (:func:`tap_blocks` of ``w``
    and ``skip_w``), the lists of weight blocks that are not all zero, which
    the kernel's tap loops walk; built once where a graph builds the stage
    (a call then copies nothing to the host); ``None``, or lists read from
    other tensors than the stage holds, derive them from ``w`` on each
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
    taps: Any = None

    @property
    def k(self) -> int:
        return int(self.w.shape[0])

    @property
    def reach(self) -> int:
        """Rows/cols of input context beyond the center this stage reads."""
        return self.dil * (self.k // 2)


@dataclasses.dataclass(frozen=True, eq=False)
class TapBlocks:
    """The lists of a conv stage's weight blocks that are not all zero, as
    the kernel reads them (csrc/conv_chain.cu, "tap table"): ``table`` is
    one int32 tensor on the kernel's device, ``host`` the same on the host.

    Two granularities, each per output-channel tile and per source (0: the
    stage's kernel ``w``, 1: its ``skip_w``), entries ``(tap << 16) | k``
    in (tap, k) order, tap = dy * KW + dx:
    - MMA (bf16 float chains): k a 16-input-channel chunk, tiles of
      ``mma_nt`` (16, or 8 when Cout is no multiple of 16) output channels;
    - CUDA cores (f32 and int8 chains): k an input channel, groups of
      ``cob`` output channels (the kernel's COB for this stage,
      :func:`kernel_cob`); ``dense`` when they hold every row of every
      group (a chain of dense stages runs the kernel that walks every
      tap).
    ``w`` and ``skip_w`` are the tensors the lists were read from."""

    table: torch.Tensor
    host: np.ndarray
    w: Any
    skip_w: Any
    mma_nt: int
    cob: int

    @property
    def dense(self) -> bool:
        return bool(self.host[3])

    def lists(self, kind: str) -> dict:
        """{(tile or group, source): [(tap, k), ...]} of the ``"mma"`` or
        ``"cc"`` lists."""
        h = self.host
        if kind == "mma":
            start, n = 4, -(-int(self.w.shape[3]) // self.mma_nt)
        else:
            start, n = int(h[2]), int(self.w.shape[3]) // self.cob
        off = h[start:start + 2 * n + 1]
        return {(t, s): [(int(e) >> 16, int(e) & 0xFFFF)
                         for e in h[off[2 * t + s]:off[2 * t + s + 1]]]
                for t in range(n) for s in range(2)}


def kernel_cob(cout: int, quant: bool, skip_w: bool) -> int:
    """The output channels a thread of the kernel's CUDA-core loops takes
    (its COB dispatch in csrc/conv_chain.cu chain_kernel): float stages 16,
    8, 4 or 1, int8 stages 8, 4 or 1, and 4 or 1 beside a skip_w conv."""
    if quant and skip_w:
        options = (4,)
    elif quant:
        options = (8, 4)
    else:
        options = (16, 8, 4)
    return next((c for c in options if cout % c == 0), 1)


def _block_mask(nz: np.ndarray, kgran: int, ngran: int) -> np.ndarray:
    """(taps, Cin / kgran, Cout / ngran) bool, rounded up: whether each
    (tap, kgran-channel chunk, ngran-channel tile) block of the (KH, KW,
    Cin, Cout) non-zero mask ``nz`` holds a non-zero."""
    kh, kw, cin, cout = nz.shape
    kc, nt = -(-cin // kgran), -(-cout // ngran)
    full = np.zeros((kh * kw, kc * kgran, nt * ngran), bool)
    full[:, :cin, :cout] = nz.reshape(kh * kw, cin, cout)
    return full.reshape(kh * kw, kc, kgran, nt, ngran).any(axis=(2, 4))


def _append_lists(table: list, masks: Sequence[np.ndarray]) -> None:
    """Append the offsets and entries of per-(tile, source) lists, each
    mask (taps, k, tiles) one source, to ``table`` (offsets absolute)."""
    n = masks[0].shape[2]
    base = len(table) + 2 * n + 1
    offs, ents = [], []
    for t in range(n):
        for s in range(2):
            offs.append(base + len(ents))
            if s < len(masks):
                taps, ks = np.nonzero(masks[s][:, :, t])
                ents.extend(((taps << 16) | ks).tolist())
    offs.append(base + len(ents))
    table += offs + ents


def tap_blocks(w: torch.Tensor, skip_w: torch.Tensor = None) -> TapBlocks:
    """The :class:`TapBlocks` of a conv stage's (KH, KW, Cin, Cout) kernel
    ``w`` (int8 for an int8 stage) and its ``skip_w``, read from the tensors
    themselves (one copy to the host), the table on ``w``'s device."""
    srcs = [w] + ([] if skip_w is None else [skip_w])
    nzs = [(k.detach() != 0).cpu().numpy() for k in srcs]
    cout = int(w.shape[3])
    mma_nt = 16 if cout % 16 == 0 else 8
    cob = kernel_cob(cout, w.dtype == torch.int8, skip_w is not None)
    cc = [_block_mask(nz, 1, cob) for nz in nzs]
    table = [mma_nt, cob, 0, int(all(m.all() for m in cc))]
    _append_lists(table, [_block_mask(nz, 16, mma_nt) for nz in nzs])
    table[2] = len(table)
    _append_lists(table, cc)
    host = np.asarray(table, np.int32)
    return TapBlocks(table=torch.from_numpy(host).to(w.device), host=host,
                     w=w, skip_w=skip_w, mma_nt=mma_nt, cob=cob)


def _taps_of(st: ChainStage) -> TapBlocks:
    """The stage's tap lists: its own when they were read from the very
    tensors it holds, else (none given, or a stage whose ``w`` or
    ``skip_w`` was replaced after its lists were built) read from them
    now."""
    t = st.taps
    if t is not None and t.w is st.w and t.skip_w is st.skip_w:
        return t
    return tap_blocks(st.w, st.skip_w)


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


def _check_int8(i: int, st: ChainStage, quant: bool) -> None:
    """The JAX kernel's asserts on int8 stages: every stage of a chain is
    quantized or none is, and a stage has ``w_scale`` exactly when it is a
    quantized conv stage; a quantized conv stage's ``w`` is int8 and its
    ``w_scale`` (Cout,)."""
    if st.x_scale < 0:
        raise ValueError(f"stage {i}: x_scale must be > 0, got {st.x_scale}")
    if bool(st.x_scale) != quant:
        raise ValueError(f"stage {i}: int8 chains quantize every stage "
                         "together (x_scale set on some stages only)")
    if (st.w_scale is not None) != (quant and not st.pool):
        raise ValueError(f"stage {i}: a stage has w_scale exactly when it is "
                         "a quantized conv stage")
    if quant and not st.pool:
        if st.w.dtype != torch.int8:
            raise ValueError(f"stage {i}: a quantized stage's w is int8, got "
                             f"{st.w.dtype}")
        if tuple(st.w_scale.shape) != (int(st.w.shape[-1]),):
            raise ValueError(f"stage {i}: w_scale must be ({int(st.w.shape[-1])},"
                             f"), got {tuple(st.w_scale.shape)}")


def _prepare(stages: Sequence[ChainStage]) -> List[ChainStage]:
    """Validate a chain for this port and mark its last stage emitted."""
    stages = list(stages)
    if not stages:
        raise ValueError("a chain needs at least one stage")
    if not stages[-1].emit:
        stages[-1] = dataclasses.replace(stages[-1], emit=True)
    quant = bool(stages[0].x_scale)
    for i, st in enumerate(stages):
        _check_int8(i, st, quant)
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


def _quantize(y: torch.Tensor, x_scale: float) -> torch.Tensor:
    """f32 ``y`` as the int8 values (held in f32) of scale ``x_scale``:
    ``clip(round(y * (1 / x_scale)), -127, 127)``, half to even, the
    reciprocal rounded once to f32 as the JAX package's weak-typed scalar
    is."""
    return torch.clamp(torch.round(y.float() * (1.0 / x_scale)), -127., 127.)


def skip_conv_in_tap_order(skip: torch.Tensor,
                           sw: torch.Tensor) -> torch.Tensor:
    """The (K, K, Cskip, Cout) conv of NHWC ``skip`` (padding K/2) as the
    kernel's ``float_taps`` sums it: taps (dy, dx) in order, input channels
    inner, every product added to an f32 accumulator with one rounding (the
    kernel's FMA; the product of two f32 values is exact in f64, so the f64
    sum rounded to f32 is the FMA but for a double rounding, which needs a
    tie at both widths at once). Returns (N, H, W, Cout) f32."""
    n, h, w, scin = skip.shape
    k = int(sw.shape[0])
    p = k // 2
    xp = F.pad(skip.double(), (0, 0, p, p, p, p))
    w64 = sw.double()
    acc = torch.zeros((n, h, w, int(sw.shape[3])), dtype=torch.float32,
                      device=skip.device)
    for dy in range(k):
        for dx in range(k):
            xs = xp[:, dy:dy + h, dx:dx + w, :]
            for ci in range(scin):
                acc = (acc.double() + xs[..., ci:ci + 1] * w64[dy, dx, ci]
                       ).float()
    return acc


def chain_reference(x: torch.Tensor, stages: Sequence[ChainStage],
                    skips: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
    """Plain-PyTorch mirror of :func:`fused_conv_chain` at the same rounding
    points: f32 convs of the chain-dtype activations and kernels, f32
    epilogue, and rounding to the chain dtype between stages and at every
    emitted output. An int8 chain quantizes its input at stage 0, runs its
    integer convs in f64 (exact: every sum stays below 2**53; CPU convs have
    no int32 form) cast to f32, dequantizes, adds a ``skip_w`` stage's float
    skip conv summed in the kernel's order (:func:`skip_conv_in_tap_order`),
    and requantizes the f32 result for the next stage. The test oracle for the kernel, and its CPU path;
    ``chain_reference.calls`` counts its calls."""
    chain_reference.calls += 1
    stages = _prepare(stages)
    chain_dtype = x.dtype
    h = _quantize(x, stages[0].x_scale) if stages[0].x_scale else x
    outs = []
    for k, st in enumerate(stages):
        q = bool(st.x_scale)
        cout = int(st.w.shape[3])
        if st.pool:
            # the max over the four 0/1 selections (exact gathers, as the
            # JAX package's chain_reference computes them), no epilogue; an
            # int8 pool dequantizes the integer max at its own scale
            sel = st.w[0].float()
            hf = h.float()
            y = torch.einsum("nhwc,cd->nhwd", hf, sel[0])
            for t in range(1, 4):
                y = torch.maximum(y, torch.einsum("nhwc,cd->nhwd", hf, sel[t]))
            if q:
                y = y * st.x_scale
        else:
            # (KH, KW, in, out) -> OIHW, at the chain dtype as the kernel
            # reads it (int8 stages: the integers, in f64)
            ct = torch.float64 if q else torch.float32
            w = (st.w if q else st.w.to(chain_dtype)).to(ct).permute(3, 2, 0, 1)
            if st.stem_f:
                f = st.stem_f
                n, hh, wf, cin = h.shape
                xg = h.to(ct).reshape(n, hh, wf // f, f * cin)
                y = F.conv2d(xg.permute(0, 3, 1, 2), w, stride=(f, 1), padding=1)
            else:
                y = F.conv2d(h.to(ct).permute(0, 3, 1, 2), w, padding=st.reach,
                             dilation=st.dil)
            y = y.float()
            if q:
                y = y * (st.w_scale.float() * st.x_scale).view(-1, 1, 1)
            if st.skip_w is not None and q:
                # an int8 stage's float skip conv, summed in the kernel's
                # order: a requantization tie downstream turns on the last
                # bit of the sum
                y = y + skip_conv_in_tap_order(
                    skips[st.skip_idx], st.skip_w.to(chain_dtype)
                ).permute(0, 3, 1, 2)
            elif st.skip_w is not None:
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
        if k + 1 < len(stages):
            nxt = stages[k + 1]
            h = _quantize(y, nxt.x_scale) if nxt.x_scale else y.to(chain_dtype)
    return outs


chain_reference.calls = 0


def _abs_stat(t: torch.Tensor, pct) -> float:
    """max|t| over the whole tensor, or with ``pct`` its pct-th percentile
    as ``jnp.quantile`` computes it (linear interpolation between the sorted
    values at ranks floor and ceil of q * (n - 1), all in f32).
    ``torch.quantile`` is not used: it refuses inputs over 2**24 values."""
    a = t.detach().float().abs().flatten()
    if pct is None:
        return float(a.max())
    n = a.numel()
    pos = np.float32(pct / 100.0) * (np.float32(n) - np.float32(1.0))
    low, high = np.floor(pos), np.ceil(pos)
    hw = pos - low
    lw = np.float32(1.0) - hw
    srt = torch.sort(a).values
    lo = np.float32(srt[int(min(max(low, 0), n - 1))].item())
    hi = np.float32(srt[int(min(max(high, 0), n - 1))].item())
    return float(lo * lw + hi * hw)


def chain_stats(x: torch.Tensor, stages: Sequence[ChainStage],
                skips: Sequence[torch.Tensor] = (), pct=None):
    """Calibrate a float chain: run it once (:func:`fused_conv_chain`, so K2
    on CUDA tensors) with every stage emitted and return ``(outs, stats)``,
    ``outs`` the outputs the chain emits as given and ``stats`` one value per
    stage, the max of |stage input| (``pct``: its pct-th percentile), the
    statistic :func:`quantize_chain_stages` takes. Stage 0's input is ``x``;
    stage k + 1's is stage k's output at the chain dtype, which is what an
    emitted output holds."""
    stages = _prepare(stages)
    if stages[0].x_scale:
        raise ValueError("calibration runs the float chain")
    outs = fused_conv_chain(x, [dataclasses.replace(st, emit=True)
                                for st in stages], skips)
    stats = [_abs_stat(t, pct) for t in [x] + outs[:-1]]
    return [o for o, st in zip(outs, stages) if st.emit], stats


def quantize_chain_stages(stages: Sequence[ChainStage],
                          in_maxes: Sequence[float]) -> List[ChainStage]:
    """Static int8 post-training quantization of a chain (the JAX package's
    ``quantize_chain_stages``): per-stage input scales ``max(mx, 1e-6) /
    127`` from the calibration statistics ``in_maxes`` (one per stage, as
    :func:`chain_stats` returns them), symmetric per-output-channel int8
    weights ``clip(round(w / ws), -127, 127)`` with ``ws = max(max|w|,
    1e-12) / 127`` in f32, with tap lists read from those int8 weights.
    Pool stages keep their 0/1 selections (and ``pool_src``) and take only
    the scale."""
    if len(stages) != len(in_maxes):
        raise ValueError(f"{len(stages)} stages but {len(in_maxes)} "
                         "statistics")
    out = []
    for st, mx in zip(stages, in_maxes):
        s = max(float(mx), 1e-6) / 127.0
        if st.pool:
            out.append(dataclasses.replace(st, x_scale=s))
            continue
        w = st.w.float()
        ws = torch.clamp_min(w.abs().amax(dim=(0, 1, 2)), 1e-12) / 127.0
        wq = torch.clamp(torch.round(w / ws), -127, 127).to(torch.int8)
        out.append(dataclasses.replace(st, w=wq, w_scale=ws, x_scale=s,
                                       taps=tap_blocks(wq, st.skip_w)))
    return out


# ---------------------------------------------------------------------------
# the CUDA path
# ---------------------------------------------------------------------------

_MAX_STAGES = 16  # csrc/conv_chain.cu RCV_MAX_STAGES
_MAX_SKIPS = 4    # csrc/conv_chain.cu RCV_MAX_SKIPS


class _Stage(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("scale", ctypes.c_void_p), ("shift", ctypes.c_void_p),
                ("skip_w", ctypes.c_void_p), ("table", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("ws_off", ctypes.c_longlong),
                ("kh", ctypes.c_int), ("kw", ctypes.c_int),
                ("cin", ctypes.c_int), ("cout", ctypes.c_int),
                ("rbb", ctypes.c_int), ("skip_idx", ctypes.c_int),
                ("argmax_groups", ctypes.c_int), ("depth", ctypes.c_int),
                ("dil", ctypes.c_int), ("stem_f", ctypes.c_int),
                ("relu_only", ctypes.c_int), ("skip_k", ctypes.c_int),
                ("skip_cin", ctypes.c_int), ("pool", ctypes.c_int),
                ("w_scale", ctypes.c_void_p), ("x_scale", ctypes.c_float),
                ("requant", ctypes.c_float)]


class _Chain(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("skips", ctypes.c_void_p * _MAX_SKIPS),
                ("ws", ctypes.c_void_p), ("ws_per_block", ctypes.c_longlong),
                ("n", ctypes.c_int), ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("band", ctypes.c_int), ("n_stages", ctypes.c_int),
                ("bf16", ctypes.c_int), ("quant", ctypes.c_int),
                ("listed", ctypes.c_int),
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


def int8_flip_step(st: ChainStage) -> float:
    """The most one output element of a quantized stage moves when one
    integer of its input moves by one: the input step ``x_scale`` times the
    largest dequantized weight (``127 * w_scale``) times ``|scale|`` of the
    affine (the ReLU and an identity skip do not widen it). A pool stage's
    max moves by at most one step, ``x_scale``."""
    if st.pool:
        return float(st.x_scale)
    s = st.w_scale.float() * 127.0
    if st.scale is not None:
        s = s * st.scale.float().abs()
    return float(s.max()) * st.x_scale


def int8_output_steps(stages: Sequence[ChainStage]) -> List[float]:
    """:func:`int8_flip_step` of each stage that emits an output, in the
    order of the chain's outputs (the argmax head's labels last)."""
    return [int8_flip_step(st) for st in _prepare(stages) if st.emit]


def int8_mismatch(got: torch.Tensor, ref: torch.Tensor, step: float):
    """``(share, worst)`` of an int8 chain output against its plain version:
    the share of its elements outside the kernel's tolerance (rtol = atol =
    1e-5 in f32, :func:`bf16_tolerance` in bf16), and the largest excess
    over that tolerance among them in units of ``step``, the
    :func:`int8_flip_step` of the stage that emitted the output. Integer
    taps are exact on both sides, so an element falls outside only
    downstream of a requantization tie (an f32 value one ulp from a
    rounding boundary of its scale, sent to the neighbouring integer by the
    float skip conv's summation order): then ``worst`` is at most 1."""
    g, r = got.float(), ref.float()
    tol = bf16_tolerance(r) if ref.dtype == torch.bfloat16 \
        else 1e-5 + 1e-5 * r.abs()
    excess = (g - r).abs() - tol
    out = excess > 0
    worst = float(excess[out].max()) / step if bool(out.any()) else 0.0
    return float(out.float().mean()), worst


def _param(t, device, dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor on ``device`` whose data is
    16-byte aligned (the kernel loads weights in vectors of 4, and its MMA
    loop copies inputs, skips and weights in 16-byte pieces)."""
    t = torch.as_tensor(t).to(device=device, dtype=dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_conv_chain(x: torch.Tensor, stages: Sequence[ChainStage],
                     skips: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
    """Run a fused chain of conv3x3(s1)/conv1x1 (+epilogue, +skip) and
    packed max-pool stages.

    x: (N, H, W, C0) in f32 or bf16, or the raw (N, f*H, f*W, cin) image
    when stage 0 is a ``stem_f = f`` stem. Kernels are read at x's dtype (as the
    JAX kernel reads them), int8 in an int8 chain, whose input the wrapper
    quantizes at stage 0's scale; bias and affine in f32. Returns the emitted
    outputs in stage order (the last stage always). CUDA tensors launch the
    kernel (one launch per call); CPU tensors run :func:`chain_reference`."""
    stages = _prepare(stages)
    if x.device.type == "cpu":
        return chain_reference(x, stages, skips)
    return _launch(x, stages, [None if st.pool else _taps_of(st)
                               for st in stages], skips)


def _launch(x: torch.Tensor, stages: List[ChainStage], taps: Sequence,
            skips: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One K2 launch of a prepared chain on the current stream; ``taps[i]``
    is stage i's tap lists (anything with ``table``, ``cob`` and
    ``dense``), None for a pool stage."""
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
    quant = bool(stages[0].x_scale)
    keep = []  # parameter copies that must outlive the launch call
    outs = []
    desc = _Chain()
    if quant:
        # the chain input enters as int8 at stage 0's scale, quantized in f32
        # as chain_reference does
        xq = _quantize(x, stages[0].x_scale).to(torch.int8)
        keep.append(xq)
        desc.x = xq.data_ptr()
    else:
        # the tap loops copy 16-byte pieces of the input and the skips
        x = _param(x, dev, x.dtype)
        desc.x = x.data_ptr()
    skips = [_param(s, dev, s.dtype) for s in skips]
    keep += [x] + skips
    for i, s in enumerate(skips):
        desc.skips[i] = s.data_ptr()
    ws_bytes = 0
    cin = c0
    listed = False  # some stage's CUDA-core lists skip rows
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
            d.pool, d.table, kh, kw = 1, table.data_ptr(), 1, 1
        else:
            w = _param(st.w, dev, torch.int8 if quant else x.dtype)
            b = _param(st.b, dev, torch.float32)
            st_taps = taps[i]
            if st_taps.cob != kernel_cob(cout, quant, st.skip_w is not None):
                raise ValueError(f"stage {i}: tap lists for {st_taps.cob}-wide "
                                 "groups, not the kernel's")
            listed = listed or not st_taps.dense
            table = _param(st_taps.table, dev, torch.int32)
            keep += [w, b, table]
            d.w, d.b, d.table = w.data_ptr(), b.data_ptr(), table.data_ptr()
            if quant:
                wsc = _param(st.w_scale, dev, torch.float32)
                keep.append(wsc)
                d.w_scale = wsc.data_ptr()
        if quant:
            d.x_scale = st.x_scale
            if i + 1 < len(stages):
                d.requant = 1.0 / stages[i + 1].x_scale
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
        # every stage the next stage reads (int8 in an int8 chain), and for
        # the argmax head's logits (the chain dtype); 16-byte aligned
        if i + 1 < len(stages) or st.argmax_groups:
            item = 1 if quant and not st.argmax_groups else x.element_size()
            d.ws_off = ws_bytes
            ws_bytes += -(-(band + 2 * depths[i]) * W * cout * item // 16) * 16
        else:
            d.ws_off = -1
        d.kh, d.kw, d.cin, d.cout, d.rbb = kh, kw, wcin, cout, int(st.rbb)
        d.skip_idx, d.argmax_groups, d.depth = st.skip_idx, st.argmax_groups, depths[i]
        d.dil, d.stem_f, d.relu_only = st.dil, st.stem_f, int(st.relu_only)
        cin = cout
    ws = torch.empty((max(n * (H // band) * ws_bytes, 1),), dtype=torch.uint8,
                     device=dev)
    desc.ws, desc.ws_per_block = ws.data_ptr(), ws_bytes
    desc.n, desc.h, desc.w, desc.band = n, H, W, band
    desc.n_stages, desc.bf16 = len(stages), int(x.dtype == torch.bfloat16)
    desc.quant, desc.listed = int(quant), int(listed)

    fn = _lib()
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(desc), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_conv_chain launch failed: CUDA error {err}")
    fused_conv_chain.launches += 1
    return outs


fused_conv_chain.launches = 0


# ---------------------------------------------------------------------------
# the torch.library op (what a torch.export graph holds)
# ---------------------------------------------------------------------------

# a stage's entries in the op's int list: its switches, then its CUDA-core
# tap-list width (``cob``) and whether those lists hold every row (``dense``)
_STAGE_INTS = ("pool", "rbb", "skip_idx", "emit", "stem_f", "relu_only",
               "dil", "argmax_groups", "has_scale", "has_skip_w", "cob",
               "dense")


class _OpTaps(NamedTuple):
    """A stage's tap lists as the op receives them: what ``_launch`` reads."""

    table: torch.Tensor
    cob: int
    dense: bool


def with_tables(stages: Sequence[ChainStage]) -> List[ChainStage]:
    """A prepared chain whose every stage carries the tables read off its
    weights: the tap lists of a conv stage (``taps``, built now unless the
    stage holds lists read from its own tensors) and a pool stage's
    ``pool_src``. Runs on real tensors, ahead of any trace."""
    return [st if st.pool else dataclasses.replace(st, taps=_taps_of(st))
            for st in _prepare(stages)]


def chain_op_args(stages: Sequence[ChainStage]):
    """A chain flattened into the op's schema: ``(tensors, ints, floats)``.
    Per stage, ``tensors`` takes w, b, the tap table (a pool stage: its
    ``pool_src``), then scale and shift, skip_w and w_scale where the stage
    has them; ``ints`` takes the ``_STAGE_INTS`` entries; ``floats`` its
    ``x_scale``. Reads no tensor's values: every stage must carry its tables
    already (:func:`with_tables`)."""
    tensors, ints, floats = [], [], []
    for i, st in enumerate(_prepare(stages)):
        if not st.pool and st.taps is None:
            raise ValueError(f"stage {i} has no tap lists: build them with "
                             "with_tables before tracing")
        tensors += [st.w, st.b, st.pool_src if st.pool else st.taps.table]
        if st.scale is not None:
            tensors += [st.scale, st.shift]
        if st.skip_w is not None:
            tensors.append(st.skip_w)
        if st.w_scale is not None:
            tensors.append(st.w_scale)
        ints += [int(st.pool), int(st.rbb), st.skip_idx, int(st.emit),
                 st.stem_f, int(st.relu_only), st.dil, st.argmax_groups,
                 int(st.scale is not None), int(st.skip_w is not None),
                 0 if st.pool else st.taps.cob,
                 0 if st.pool else int(st.taps.dense)]
        floats.append(float(st.x_scale))
    return tensors, ints, floats


def _op_stages(tensors: Sequence[torch.Tensor], ints: Sequence[int],
               floats: Sequence[float]):
    """Inverse of :func:`chain_op_args`: (stages, per-stage taps)."""
    stages, taps = [], []
    it = iter(tensors)
    k = len(_STAGE_INTS)
    for i, x_scale in enumerate(floats):
        m = dict(zip(_STAGE_INTS, ints[i * k:(i + 1) * k]))
        w, b, table = next(it), next(it), next(it)
        scale, shift = (next(it), next(it)) if m["has_scale"] else (None, None)
        skip_w = next(it) if m["has_skip_w"] else None
        w_scale = next(it) if x_scale and not m["pool"] else None
        stages.append(ChainStage(
            w=w, b=b, scale=scale, shift=shift, rbb=bool(m["rbb"]),
            skip_idx=m["skip_idx"], emit=bool(m["emit"]), stem_f=m["stem_f"],
            relu_only=bool(m["relu_only"]), skip_w=skip_w, dil=m["dil"],
            argmax_groups=m["argmax_groups"], pool=bool(m["pool"]),
            pool_src=table if m["pool"] else None, x_scale=x_scale,
            w_scale=w_scale))
        taps.append(None if m["pool"] else
                    _OpTaps(table, m["cob"], bool(m["dense"])))
    return stages, taps


@torch.library.custom_op("robocupvision_tpu_torch::fused_conv_chain",
                         mutates_args=(), device_types="cuda")
def _chain_op(x: torch.Tensor, skips: List[torch.Tensor],
              tensors: List[torch.Tensor], ints: List[int],
              floats: List[float]) -> List[torch.Tensor]:
    """K2's launch (:func:`_launch`, counted in ``fused_conv_chain.launches``)
    of a flattened chain."""
    stages, taps = _op_stages(tensors, ints, floats)
    return _launch(x.contiguous(), _prepare(stages), taps,
                   [s.contiguous() for s in skips])


@_chain_op.register_kernel("cpu")
def _chain_op_cpu(x, skips, tensors, ints, floats):
    stages, _ = _op_stages(tensors, ints, floats)
    return chain_reference(x, stages, skips)


@_chain_op.register_fake
def _chain_op_fake(x, skips, tensors, ints, floats):
    """The emitted outputs' shapes and dtypes, as :func:`chain_reference`
    gives them: (N, H, W, Cout) at x's dtype for each emitted stage (the
    chain grid: x's, or a ``stem_f = f`` chain's image over f; a pool
    stage's Cout is its selection stack's), the argmax head's (N, H, W,
    groups) int32 labels last."""
    stages = _prepare(_op_stages(tensors, ints, floats)[0])
    n, h, w, _ = x.shape
    f = stages[0].stem_f or 1
    outs = []
    for st in stages:
        if st.argmax_groups:
            outs.append(x.new_empty((n, h // f, w // f, st.argmax_groups),
                                    dtype=torch.int32))
        elif st.emit:
            outs.append(x.new_empty((n, h // f, w // f, int(st.w.shape[3]))))
    return outs


def fused_conv_chain_op(x: torch.Tensor, stages: Sequence[ChainStage],
                        skips: Sequence[torch.Tensor] = ()
                        ) -> List[torch.Tensor]:
    """:func:`fused_conv_chain` through the op: what a traced graph calls,
    one op node a chain (stages with their tables, :func:`with_tables`)."""
    tensors, ints, floats = chain_op_args(stages)
    return _chain_op(x, list(skips), tensors, ints, floats)
