"""Lane-packed (space-to-depth) inference graphs: the ROBO-UNet family's
plan (the flagship, ``--UNet`` and ``--v2``; PB_FCN_2 rides it), PB_FCN and
LabelProp.

An exact graph rewrite (the JAX package's models/packed.py): the top of
the U-Net trades spatial resolution for channels (space-to-depth by 4 at
full resolution, 2 at half, 1 below), so a VGA graph runs its top levels on
one 120x160 grid with 32..128 channels. Each original conv becomes a conv
on the packed grid whose kernel is a scatter of the original weights:

    for output phase (qy, qx) and original tap (dy, dx):
        r = stride*q + d - k//2          (plain conv; f_in == stride * f_out)
        r = (q + d - 1) / 2 if even      (k3/s2/p1/op1 tconv, pre-flipped
                                          kernel; f_out == 2 * f_in)
        packed tap  DY = r // f_in,  input phase  py = r % f_in

Per-channel vectors (bias, folded BN scale/shift) tile across phases; the
packed channel order is (py*f + px)*C + c. The ``--UNet`` downs' 2x2 max
pool is a pure lane op on a packed grid (``packed_max_pool``). The ``--v2``
concat skips are never materialized at f > 1: conv(concat(a, b), W) ==
conv(a, W[:, :, :Ca]) + conv(b, W[:, :, Ca:]), so the consuming conv's
packed kernel is split along the original Cin into ``.w0``/``.w1`` halves
(``split2`` blocks) instead.

``build_packed_infer(..., pallas=True)`` runs the two packed-grid regions
as fused chains (ops/cuda_packed.fused_conv_chain, kernel K2 on CUDA):
the down region after the stem ([L1C0, L1C1, L2C0, L2C1] for the
flagship; pool, Level1's convs, pool, Level2's convs for ``--UNet``), and
[Up(D-3)+skip, Up(D-2)+skip, head] before the output, the head fusing the
serving argmax (for ``--v2`` the last two stages add their concat skip
through a ``skip_w`` kernel, the split ``.w1`` half). ``pallas_fold_stem``
moves the stem (and the rest of Level0) into the down chain (its stage 0
reads the raw image), and ``pallas_deep`` runs Level(D-1)'s stride-1 convs
and the PB belly as a third chain on the deepest grid. Strided plans with
levels outside (1, 2) chain the up region only. Otherwise the stem is a
plain conv with stride (f, 1) over the grouped input view, and the f == 1
levels run the zoo's blocks. ``pallas=False`` is the plain PyTorch packed
graph.

``build_packed_pb_fcn`` does the same for PB_FCN: its down chain [conv0,
conv1, conv2.conv1 (ReLU only), conv2.pool] on the 1/4-resolution grid,
its up chain [up(n-1)+skip, up(n)+skip, head], and with ``pallas_deep``
the dilated conv1 of the next ConvPool in the down chain and the five
dilated deep convs as a third chain.

``build_packed_label_prop`` compiles LabelProp, whose 8-channel
full-resolution input packs into 128 lanes: its down chain [down1, down2]
(``pallas_fold_stem``: [pre, down1, down2] from the raw input), the
dilated belly [conv1, conv2, conv3] on the 1/8 grid (``pallas_mid``), and
its up chain [upConv2 + skip, upConv3, classifier], whose classifier takes
the channel-slice skip of ``top`` through a 1x1 ``skip_w`` kernel.

``packed_train_apply`` is the flagship's packed graph made
differentiable, for training (``StepCfg.packed``): its packed kernels are
gathers of the live weights through maps built once
(``build_train_pack_maps``), BN in train mode over the packed layout.

``quantize_int8`` turns any chain graph into a static int8 one: one
calibration pass through the chains (K2 on CUDA) collects each stage's
activation statistic, and every chain is rebuilt with int8 stages
(ops/cuda_packed.quantize_chain_stages).

The packers work on numpy arrays in the JAX package's HWIO layout (their
arithmetic is layout-bound); ``build_packed_infer`` takes the port's
state_dict and carries it there with export/torch_io.to_jax_params.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from robocupvision_tpu_torch.device import DeviceLike, resolve_device
from robocupvision_tpu_torch.export.torch_io import (to_jax_layout,
                                                     to_jax_params)
from robocupvision_tpu_torch.models import layers as L
from robocupvision_tpu_torch.models.zoo import (LabelPropCfg, Model,
                                                PBFCN2Cfg, PBFCNCfg,
                                                RoboUNetCfg)
from robocupvision_tpu_torch.ops import cuda_packed as ckp
from robocupvision_tpu_torch.ops import nn
from robocupvision_tpu_torch.ops.color import raw_camera_preprocess

Params = Dict[str, torch.Tensor]
NpParams = Dict[str, np.ndarray]

_BN_EPS = 1e-5


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/f, W/f, f*f*C), packed channel (py*f+px)*C + c."""
    if f == 1:
        return x
    n, h, w, c = x.shape
    x = x.reshape(n, h // f, f, w // f, f, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // f, w // f, f * f * c)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    if f == 1:
        return x
    n, hp, wp, cp = x.shape
    c = cp // (f * f)
    x = x.reshape(n, hp, wp, f, f, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, hp * f, wp * f, c)


def packed_max_pool(x: torch.Tensor, f_in: int) -> torch.Tensor:
    """2x2/s2 max pool on a packed tensor: each packed cell holds f_in x f_in
    original pixels, so each of the pooled cell's (f_in/2)^2 outputs is the
    max of a 2x2 block inside the same cell (a pure lane op). Output packing
    f_in/2."""
    if f_in not in (2, 4):
        raise ValueError(f"packed_max_pool takes f_in 2 or 4, got {f_in}")
    n, hp, wp, cp = x.shape
    fo = f_in // 2
    c = cp // (f_in * f_in)
    x = x.reshape(n, hp, wp, fo, 2, fo, 2, c)
    return x.amax(dim=(4, 6)).reshape(n, hp, wp, fo * fo * c)


def pack_conv_weight(w: np.ndarray, f_in: int, f_out: int, stride: int = 1,
                     transpose: bool = False, dilation: int = 1) -> np.ndarray:
    """Scatter an HWIO kernel into its packed-grid equivalent.

    Plain conv: k in {1, 3}, torch padding dilation*(k//2), requires
    f_in == stride * f_out and dilation <= f_in. Transpose conv: the zoo's
    only config (k3, s2, p1, op1, pre-flipped HWIO kernel), requires
    f_out == 2 * f_in. Returns a (K, K, f_in^2*cin, f_out^2*cout) kernel for
    a packed conv with padding K//2 where K = 3 (K = 1 for 1x1 convs).
    """
    kh, kw, cin, cout = w.shape
    assert kh == kw and kh in (1, 3), w.shape
    if transpose:
        assert kh == 3 and f_out == 2 * f_in, (f_in, f_out)
    else:
        assert f_in == stride * f_out, (f_in, f_out, stride)
        assert dilation in (1,) or dilation <= f_in, (dilation, f_in)
    K = 1 if (kh == 1 and f_in == f_out) else 3
    wp = np.zeros((K, K, f_in * f_in * cin, f_out * f_out * cout), w.dtype)

    def tap(q, d):
        """-> (packed tap offset, input phase) or None for a zero tap."""
        if transpose:
            num = q + d - 1  # z-index offset; z[2t] = in[t], odd = 0
            if num % 2:
                return None
            r = num // 2
        else:
            r = stride * q + dilation * (d - kh // 2)
        return r // f_in, r % f_in

    for qy in range(f_out):
        for qx in range(f_out):
            for dy in range(kh):
                for dx in range(kw):
                    ty, tx = tap(qy, dy), tap(qx, dx)
                    if ty is None or tx is None:
                        continue
                    (DY, py), (DX, px) = ty, tx
                    assert -1 <= DY <= 1 and -1 <= DX <= 1
                    ci0 = (py * f_in + px) * cin
                    co0 = (qy * f_out + qx) * cout
                    wp[DY + K // 2, DX + K // 2,
                       ci0:ci0 + cin, co0:co0 + cout] = w[dy, dx]
    return wp


def pack_stem_weight_grouped(w: np.ndarray, f: int = 4,
                             group: Optional[int] = None) -> np.ndarray:
    """Fold space-to-depth(f) into the stem conv, grouped-input form.

    The raw (N, H, W, cin) image is viewed as (N, H, W/group, group*cin), a
    free reshape. Returns a (f+2, 3, group*cin, (group/f)*f^2*cout) HWIO
    kernel such that ``conv2d(x.reshape(N, H, W//group, group*cin), W',
    stride=(f, 1), padding=1).reshape(N, H/f, W/f, f*f*cout)`` equals the
    packed Level0 output. Column tap g covers the previous / own / next
    pixel group; unused positions hold zeros.
    """
    kh, kw, cin, cout = w.shape
    assert kh == kw == 3, w.shape
    group = f if group is None else group
    assert group % f == 0, (group, f)
    cells = group // f
    wp = np.zeros((f + 2, 3, group * cin, cells * f * f * cout), w.dtype)
    for cell in range(cells):
        for qy in range(f):
            for qx in range(f):
                for dy in range(3):
                    for dx in range(3):
                        e = cell * f + qx + dx - 1  # pixel within group
                        g = 1 + (e // group)        # group tap: prev/own/next
                        p = e % group
                        co0 = (cell * f * f + qy * f + qx) * cout
                        wp[qy + dy, g, p * cin:(p + 1) * cin,
                           co0:co0 + cout] = w[dy, dx]
    return wp


def _f_at(res_level: int) -> int:
    """Packing factor at a resolution level (0 = full input resolution)."""
    return {0: 4, 1: 2}.get(res_level, 1)


def _fold_bn(np_params: NpParams, name: str):
    """Inference BN as a single affine: scale = g/sqrt(rv+eps),
    shift = b - rm*scale."""
    g = np.asarray(np_params[name + ".weight"], np.float32)
    b = np.asarray(np_params[name + ".bias"], np.float32)
    rm = np.asarray(np_params[name + ".running_mean"], np.float32)
    rv = np.asarray(np_params[name + ".running_var"], np.float32)
    scale = g / np.sqrt(rv + _BN_EPS)
    return scale, b - rm * scale


@dataclasses.dataclass(frozen=True)
class _Blk:
    """One block of a packed inference plan.

    kind: "stem"     first conv, space-to-depth folded into an (f+2, 3)
                     kernel over the free (N, H, W/f, f*cin) reshape;
          "pconv"    conv(+BN affine) on the packed grid (the plain
                     conv_block / conv_pool_simple when f_in == f_out == 1);
          "pconv_nr" conv + ReLU, no BN (ConvPool.conv1);
          "ptconv"   k3/s2/p1/op1 transpose conv (the plain up_tconv at
                     f_out 1);
          "pool"     2x2/s2 max pool (packed_max_pool when f_in > 1);
          "head"     bias-only classifier conv.
    rbb: conv -> ReLU -> BN (conv_block) vs conv -> BN -> ReLU
    (conv_pool_simple, up_tconv). pad/dil: the f == 1 plain block's (the
    packed taps encode them). split2: the block consumes an unmaterialized
    two-part concat (a ``--v2`` skip); its packed kernel is stored as
    ``.w0``/``.w1`` halves. wkey/bnkey: param prefixes of blocks whose
    keys do not follow name + ".conv" / name + ".bn" (ConvPool's
    conv1/pool/bn).
    """

    kind: str
    name: str = ""
    f_in: int = 1
    f_out: int = 1
    stride: int = 1
    rbb: bool = True
    k: int = 3
    pad: int = 1
    dil: int = 1
    split2: bool = False
    wkey: str = ""
    bnkey: str = ""

    @property
    def w_prefix(self) -> str:
        if self.wkey:
            return self.wkey
        return self.name if self.kind == "head" else self.name + ".conv"

    @property
    def bn_prefix(self) -> str:
        return self.bnkey or self.name + ".bn"


@dataclasses.dataclass(frozen=True)
class _Plan:
    downs: tuple     # per resolution level: tuple of _Blk
    ups: tuple       # one _Blk per up stage
    head: _Blk
    v2: bool         # concat skips instead of additive ones
    belly: bool      # PB.PB_1 / PB.PB_2 bottleneck between down and up


def _robo_unet_plan(cfg: RoboUNetCfg) -> _Plan:
    """Packed plan for the ROBO-UNet family -- reference model.py:461-536:
    the flagship (strided convs, additive skips), ``--UNet`` (``pool``: a
    max pool, then stride-1 convs) and ``--v2`` (concat skips, doubled up
    widths, a 3x3 head)."""
    D = cfg.eff_depth
    n0 = max(cfg.levels - 1, 1)   # conv blocks in Level0
    nI = max(cfg.levels - 1, 1) if cfg.pool else cfg.levels  # per Level i >= 1
    f0 = _f_at(0)
    blks = [_Blk("stem", "downPart.Level0.layers.Conv0", f0, f0)]
    for i in range(1, n0):
        blks.append(_Blk("pconv", f"downPart.Level0.layers.Conv{i}", f0, f0))
    downs = [tuple(blks)]
    for lvl in range(1, D):
        f_in, f = _f_at(lvl - 1), _f_at(lvl)
        name = f"downPart.Level{lvl}"
        if cfg.pool:
            blks = [_Blk("pool", f_in=f_in, f_out=f),
                    _Blk("pconv", f"{name}.layers.Conv0", f, f)]
        else:
            blks = [_Blk("pconv", f"{name}.layers.Conv0", f_in, f, stride=2)]
        for i in range(1, nI):
            blks.append(_Blk("pconv", f"{name}.layers.Conv{i}", f, f))
        downs.append(tuple(blks))
    # a v2 up at f_in > 1 consumes the unmaterialized concat of the previous
    # up and its skip; at f_in == 1 the concat is materialized
    ups = tuple(_Blk("ptconv", f"upPart.Up{j}", _f_at(D - 1 - j),
                     _f_at(D - 2 - j), rbb=False,
                     split2=cfg.v2 and j > 0 and _f_at(D - 1 - j) > 1)
                for j in range(D - 1))
    head = _Blk("head", "segmenter.layers.Class", 4, 4, k=cfg.class_size,
                split2=cfg.v2)
    return _Plan(tuple(downs), ups, head, cfg.v2, cfg.belly_size > 0)


class _PackedBase:
    """Shared interpreter for packed inference graphs."""

    # -- public api ---------------------------------------------------------

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def logits(self, x) -> torch.Tensor:
        """(N, H, W, Cin) input -> (N, H, W, num_classes) logits; an exact
        (up to float reassociation) match of the zoo forward."""
        return depth_to_space(self._logits_packed(self._input(x)), 4)

    def _labels_packed(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H/4, W/4, 16) int32 per-phase labels. Chain graphs fuse this
        argmax into the head stage's kernel (unless built with
        ``pallas_argmax_head=False``); otherwise the packed logits are
        argmaxed (first max wins, as in the kernel)."""
        if self.chains is not None and self.chains["argmax_head"]:
            return self._logits_packed(x, argmax=True)
        lp = self._logits_packed(x)
        n, hp, wp, _ = lp.shape
        return torch.argmax(lp.reshape(n, hp, wp, 16, self.cfg.num_classes),
                            dim=-1).to(torch.int32)

    def infer(self, x) -> torch.Tensor:
        """(N, H, W, Cin) input -> (N, H, W) int32 label map (argmax in the
        packed domain, per phase over num_classes)."""
        lab = self._labels_packed(self._input(x))
        return depth_to_space(lab, 4)[..., 0]  # 16 phases == f^2 * (C=1)

    def infer_u8(self, x) -> torch.Tensor:
        """Like :meth:`infer` but uint8 labels (num_classes < 256)."""
        return self.infer(x).to(torch.uint8)

    def infer_u8_io(self, x_u8) -> torch.Tensor:
        """Raw camera bytes in, label bytes out: (N, H, W, 3) uint8 RGB ->
        (N, H, W) uint8 labels, the /255, ToYUV, Normalize preprocessing
        folded into one on-device affine (ops/color.raw_camera_preprocess)."""
        return self.infer_u8(raw_camera_preprocess(self._input(x_u8)))

    def infer_u8_packed(self) -> Tuple:
        """Serving pair (device_fn, host_unpack): the device returns the
        (N, H/4, W/4, 16) packed uint8 labels (no depth-to-space on the
        device) and ``host_unpack`` (numpy) rearranges the fetched labels
        into the (N, H, W) map."""
        def device_fn(x):
            return self._labels_packed(self._input(x)).to(torch.uint8)

        def host_unpack(packed_labels):
            a = _host(packed_labels)
            n, hp, wp, _ = a.shape
            a = a.reshape(n, hp, wp, 4, 4)
            return np.ascontiguousarray(
                a.transpose(0, 1, 3, 2, 4)).reshape(n, hp * 4, wp * 4)

        return device_fn, host_unpack

    def infer_u4_packed(self) -> Tuple:
        """Half-wire serving pair (device_fn, host_unpack): like
        :meth:`infer_u8_packed` but two 4-bit labels per byte (any
        num_classes <= 16)."""
        if self.cfg.num_classes > 16:
            raise ValueError("4-bit labels need num_classes <= 16")

        def device_fn(x):
            lab = self._labels_packed(self._input(x))  # (N, H/4, W/4, 16)
            return (lab[..., 0::2] | (lab[..., 1::2] << 4)).to(torch.uint8)

        def host_unpack(nibbles):
            a = _host(nibbles)
            n, hp, wp, _ = a.shape
            out = np.empty((n, hp, wp, 16), np.uint8)
            out[..., 0::2] = a & 0xF
            out[..., 1::2] = a >> 4
            out = out.reshape(n, hp, wp, 4, 4)
            return np.ascontiguousarray(
                out.transpose(0, 1, 3, 2, 4)).reshape(n, hp * 4, wp * 4)

        return device_fn, host_unpack

    def _chain(self, tag: str, x, stages, skips=()):
        """One fused-region call: K2 on CUDA tensors, the plain mirror on
        CPU tensors (ops/cuda_packed.fused_conv_chain selects by device).
        When the chains dict carries a ``collect`` map (int8 calibration,
        :func:`quantize_int8`) the same call also appends each stage's
        statistic (max|input|, or its ``collect_pct``-th percentile) to
        ``collect[tag]`` (ops/cuda_packed.chain_stats)."""
        x, skips = x.contiguous(), [s.contiguous() for s in skips]
        col = self.chains.get("collect")
        if col is not None:
            outs, stats = ckp.chain_stats(x, stages, skips,
                                          pct=self.chains.get("collect_pct"))
            col.setdefault(tag, []).extend(stats)
            return outs
        return ckp.fused_conv_chain(x, stages, skips)

    # -- block interpreter --------------------------------------------------

    def _affine(self, key: str, y: torch.Tensor, rbb: bool) -> torch.Tensor:
        scale, shift = self.packed[key + ".scale"], self.packed[key + ".shift"]
        if rbb:  # conv_block: conv -> ReLU -> BN (model.py:116)
            return nn.relu(y) * scale + shift
        return nn.relu(y * scale + shift)  # up_tconv order

    def _conv_packed(self, key: str, x) -> torch.Tensor:
        """Packed conv; ``x`` may be a 2-tuple (an unmaterialized concat):
        then the split .w0/.w1 halves are applied to its parts and summed."""
        pp = self.packed
        if isinstance(x, tuple):
            w0 = pp[key + ".w0"]
            pad = int(w0.shape[2]) // 2
            return nn.conv2d(x[0], w0, pp[key + ".b"], padding=pad) \
                + nn.conv2d(x[1], pp[key + ".w1"], padding=pad)
        w = pp[key + ".w"]
        return nn.conv2d(x, w, pp[key + ".b"], padding=int(w.shape[2]) // 2)

    def _blk(self, blk: _Blk, x) -> torch.Tensor:
        p = self.plain
        if blk.kind == "pool":
            return packed_max_pool(x, blk.f_in) if blk.f_in > 1 \
                else nn.max_pool(x, 2, 2)
        if blk.kind == "stem":
            # s2d(f) folded into an (f+2, 3)/stride-(f, 1) conv on the
            # grouped input view (N, H, W/f, f*cin), a free reshape
            f = blk.f_out
            n, H, W, c = x.shape
            xg = x.reshape(n, H, W // f, f * c)
            y = nn.conv2d(xg, self.packed[blk.w_prefix + ".w"],
                          self.packed[blk.w_prefix + ".b"], stride=(f, 1),
                          padding=1)
            return self._affine(blk.w_prefix, y, blk.rbb)
        if blk.kind == "head":
            return self._conv_packed(blk.name, x)
        if blk.kind == "ptconv":
            if blk.f_out == 1:
                return L.up_tconv(p, blk.name, x)
            y = self._conv_packed(blk.w_prefix, x)
            return self._affine(blk.w_prefix, y, False)
        if blk.kind == "pconv_nr":  # conv + ReLU, no BN (ConvPool.conv1)
            return nn.relu(self._conv_packed(blk.w_prefix, x))
        assert blk.kind == "pconv", blk.kind
        if blk.f_in == 1 and blk.f_out == 1:
            if blk.rbb:
                return L.conv_block(p, blk.name, x, blk.stride, blk.k)
            return L.conv_pool_simple(p, blk.name, x, blk.stride, blk.pad,
                                      blk.dil)
        y = self._conv_packed(blk.w_prefix, x)
        return self._affine(blk.w_prefix, y, blk.rbb)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass
class PackedInfer(_PackedBase):
    """Compiled-for-inference ROBO-UNet. Call .infer(x) / .logits(x)."""

    cfg: RoboUNetCfg
    plan: _Plan
    packed: Params       # packed/tiled tensors for the top of the net (OIHW)
    plain: Params        # the state_dict (mid/low levels), in ``dtype``
    dtype: torch.dtype
    device: torch.device
    # fused-region mode (build_packed_infer(pallas=True)): the packed-grid
    # conv chains run as K2 launches instead of separate convs
    chains: Optional[dict] = None

    def _belly(self, h: torch.Tensor) -> torch.Tensor:
        p, cfg = self.plain, self.cfg
        h = L.level_down(p, "PB.PB_1", h, cfg.belly_size - 1, False, False)
        return L.level_down(p, "PB.PB_2", h, 1, False, False)

    def _logits_packed(self, x: torch.Tensor, argmax: bool = False
                       ) -> torch.Tensor:
        if self.chains is not None:
            return self._logits_packed_chains(x, argmax)
        assert not argmax  # the fused argmax is a chain-head epilogue
        plan = self.plan
        h = x.to(self.dtype)
        feats = {}
        for lvl, blks in enumerate(plan.downs):
            for blk in blks:
                h = self._blk(blk, h)
            feats[lvl] = h
        if plan.belly:
            h = self._belly(h)
        D = len(plan.downs)
        up = h
        for j, blk in enumerate(plan.ups):
            up = self._skip(self._blk(blk, up), feats[D - 2 - j],
                            blk.f_out > 1)
        return self._blk(plan.head, up)

    def _skip(self, y: torch.Tensor, skip: torch.Tensor, packed: bool):
        """An up's skip: added, or for ``--v2`` concatenated -- at f > 1
        (``packed``) left as the pair the consuming split2 block takes."""
        if not self.plan.v2:
            return y + skip
        return (y, skip) if packed else torch.cat([y, skip], dim=-1)

    def _logits_packed_chains(self, x: torch.Tensor,
                              argmax: bool = False) -> torch.Tensor:
        """The plan with its packed-grid conv regions fused: the down
        region after the stem (Level0 too with ``fold_stem``; plain when
        the chains have no ``down``), [Up(D-3)+skip, Up(D-2)+skip, head]
        before the output, and with ``deep`` Level(D-1)'s stride-1 convs
        and the PB belly on the deepest grid. ``argmax``: the head stage
        emits fused per-phase int32 labels (serving form)."""
        plan, ch = self.plan, self.chains
        h = x.to(self.dtype)
        feats = {}
        if ch["down"] is None:
            # strided plans with levels outside (1, 2): the downs stay plain
            for lvl in range(3):
                for blk in plan.downs[lvl]:
                    h = self._blk(blk, h)
                feats[lvl] = h
        elif ch["fold_stem"]:
            # stage 0 reads the raw image and emits feats0 itself
            feats[0], feats[1], feats[2] = self._chain("down", h, ch["down"])
        else:
            for blk in plan.downs[0]:
                h = self._blk(blk, h)     # stem (plain conv) and Level0
            feats[0] = h
            feats[1], feats[2] = self._chain("down", h, ch["down"])
        h = feats[2]
        D = len(plan.downs)
        deep = ch.get("deep")
        for lvl in range(3, D):
            blks = plan.downs[lvl]
            if deep is not None and lvl == D - 1:
                # the strided Level(D-1).Conv0 stays plain; the rest of the
                # level and the belly are one chain on the deepest grid
                h = self._chain("deep", self._blk(blks[0], h), deep)[-1]
                break
            for blk in blks:
                h = self._blk(blk, h)
            feats[lvl] = h
        if plan.belly and deep is None:
            h = self._belly(h)
        up = h
        for j in range(D - 3):             # f == 1 ups stay on the plain path
            up = self._skip(self._blk(plan.ups[j], up), feats[D - 2 - j],
                            False)
        up_ch = ckp.with_argmax_head(ch["up"], 16) if argmax else ch["up"]
        return self._chain("up", up, up_ch, skips=[feats[1], feats[0]])[-1]


def _pack_blocks(np_params: NpParams, blks, dtype, device) -> Params:
    """Pack + BN-fold the weights of every packed block of a plan. Kernels
    are stored in torch's OIHW layout for the plain packed convs; every
    tensor is in ``dtype`` (as the JAX package stores them). ``pconv_nr``
    blocks get no affine."""
    packed: Params = {}

    def put(key, arr):
        packed[key] = torch.as_tensor(np.ascontiguousarray(arr)).to(
            device=device, dtype=dtype)

    def put_w(key, w_hwio, suffix=".w"):
        put(key + suffix, np.transpose(w_hwio, (3, 2, 0, 1)))

    def put_vectors(blk, t):
        bias = np_params.get(blk.w_prefix + ".bias")
        if bias is None:  # bias=False conv (BN shift absorbs it)
            bias = np.zeros(np_params[blk.w_prefix + ".weight"].shape[-1],
                            np.float32)
        put(blk.w_prefix + ".b", np.tile(bias, t))
        if blk.kind not in ("head", "pconv_nr"):
            scale, shift = _fold_bn(np_params, blk.bn_prefix)
            put(blk.w_prefix + ".scale", np.tile(scale, t))
            put(blk.w_prefix + ".shift", np.tile(shift, t))

    for blk in blks:
        if blk.kind == "pool" or (blk.f_in == 1 and blk.f_out == 1
                                  and blk.kind != "head"):
            continue  # a pool, or the plain conv_block / up_tconv path
        w = np_params[blk.w_prefix + ".weight"]
        if blk.kind == "stem":
            pack = functools.partial(pack_stem_weight_grouped, f=blk.f_out)
        elif blk.kind == "ptconv":
            pack = functools.partial(pack_conv_weight, f_in=blk.f_in,
                                     f_out=blk.f_out, transpose=True)
        else:
            pack = functools.partial(pack_conv_weight, f_in=blk.f_in,
                                     f_out=blk.f_out, stride=blk.stride,
                                     dilation=blk.dil)
        if blk.split2:
            # halves along the original Cin: a Cin slice of the original
            # kernel packs to exactly the phase-major slice
            cin = w.shape[2]
            put_w(blk.w_prefix, pack(w[:, :, :cin // 2]), ".w0")
            put_w(blk.w_prefix, pack(w[:, :, cin // 2:]), ".w1")
        else:
            put_w(blk.w_prefix, pack(w))
        put_vectors(blk, blk.f_out * blk.f_out)
    return packed


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """An OIHW packed kernel as the (KH, KW, Cin, Cout) a ChainStage takes."""
    return w.permute(2, 3, 1, 0).contiguous()


def _packed_stage(packed: Params, prefix: str, split: bool = False,
                  **kw) -> ckp.ChainStage:
    """ChainStage from a packed block: its kernel back from OIHW to
    (KH, KW, Cin, Cout) at ``dtype`` (the stem's is (f+2, 3, f*cin, Cout)),
    its vectors as f32 copies of the ``dtype`` values, no affine for the
    head and ``pconv_nr`` blocks, and the lists of its kernels' non-zero
    blocks (``taps``: the packing leaves most of them zero). ``split``: a
    split2 block, its ``.w0`` half as the stage's kernel and its ``.w1``
    half as the ``skip_w`` kernel of the concat's second part."""
    scale = packed.get(prefix + ".scale")
    if split:
        kw["skip_w"] = _hwio(packed[prefix + ".w1"])
    w = _hwio(packed[prefix + (".w0" if split else ".w")])
    return ckp.ChainStage(
        w=w, b=packed[prefix + ".b"].float(),
        scale=None if scale is None else scale.float(),
        shift=None if scale is None else packed[prefix + ".shift"].float(),
        taps=ckp.tap_blocks(w, kw.get("skip_w")), **kw)


def _plain_stage(np_params: NpParams, name: str, dtype, device, rbb: bool,
                 **kw) -> ckp.ChainStage:
    """ChainStage for a plain (f == 1) conv(+BN) block: the kernel in
    ``dtype``, bias and folded BN in f32 (as the JAX package builds it),
    with its tap lists."""
    w = torch.as_tensor(np_params[name + ".conv.weight"]).to(
        device=device, dtype=dtype).contiguous()
    b = np_params.get(name + ".conv.bias")
    if b is None:
        b = np.zeros(w.shape[-1], np.float32)
    scale, shift = _fold_bn(np_params, name + ".bn")

    def f32(a):
        return torch.as_tensor(a).to(device=device, dtype=torch.float32)

    return ckp.ChainStage(w=w, b=f32(b), scale=f32(scale),
                          shift=f32(shift), rbb=rbb,
                          taps=ckp.tap_blocks(w, kw.get("skip_w")), **kw)


def _pool_chain_stage(f_in: int, c: int, dtype, device,
                      **kw) -> ckp.ChainStage:
    """:func:`packed_max_pool` as a ChainStage: output lane (qy*fo + qx)*c +
    ch is the max of the four input lanes ((2qy + ry)*f_in + (2qx + rx))*c +
    ch, given as four 0/1 lane-selection matrices (the JAX kernel's form)
    and as the (4, Cout) table of those source lanes that the kernel reads."""
    fo = f_in // 2
    cin, cout = f_in * f_in * c, fo * fo * c
    sel = np.zeros((1, 4, cin, cout), np.float32)
    src_lanes = np.zeros((4, cout), np.int32)
    eye = np.eye(c, dtype=np.float32)
    for t, (ry, rx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        for qy in range(fo):
            for qx in range(fo):
                src = ((2 * qy + ry) * f_in + (2 * qx + rx)) * c
                dst = (qy * fo + qx) * c
                sel[0, t, src:src + c, dst:dst + c] = eye
                src_lanes[t, dst:dst + c] = np.arange(src, src + c)
    return ckp.ChainStage(w=torch.from_numpy(sel).to(device=device, dtype=dtype),
                          b=torch.zeros(cout, device=device), pool=True,
                          pool_src=torch.from_numpy(src_lanes).to(device),
                          **kw)


def _emit_last(stages):
    stages[-1] = dataclasses.replace(stages[-1], emit=True)
    return stages


def _build_flagship_chains(cfg: RoboUNetCfg, packed: Params,
                           np_params: NpParams, dtype, device,
                           fold_stem: bool, deep: bool) -> dict:
    """ChainStage lists for the ROBO-UNet plan's fused regions.

    down: ``--UNet`` [pool, Level1's convs, pool, Level2's convs] (every
    conv grid-preserving, so the region fuses at any ``levels``); the
    strided flagship [Level1's convs, Level2's convs] with levels in (1, 2);
    None otherwise (the downs stay plain). ``fold_stem``: the down chain
    starts at the raw image with the grouped space-to-depth stem as stage 0
    (and the rest of Level0 after it) and emits feats0. up: [Up(D-3) +
    skip, Up(D-2) + skip, head]; for ``--v2`` the last two add their
    concat skip through the split ``.w1`` kernel (``skip_w``) instead, and
    Up(D-3) takes the materialized f == 1 concat whole. ``deep``:
    Level(D-1)'s stride-1 convs plus the PB belly, all stride-1
    conv_blocks on the deepest grid, as a third chain."""
    D = cfg.eff_depth
    pk = functools.partial(_packed_stage, packed)

    def plain_block(name, **kw):
        return _plain_stage(np_params, name, dtype, device, rbb=True, **kw)

    nI = cfg.levels  # convs per down level (Conv0 strided + nI-1 preserving)
    if cfg.pool:
        n0 = max(cfg.levels - 1, 1)   # Level0 convs, the stem included
        nP = max(cfg.levels - 1, 1)   # convs per Level i >= 1
        # a pool keeps its input's width: the consuming Conv0's Cin
        c0 = int(np_params["downPart.Level1.layers.Conv0.conv.weight"].shape[2])
        c1 = int(np_params["downPart.Level2.layers.Conv0.conv.weight"].shape[2])
        down = [_pool_chain_stage(4, c0, dtype, device)]
        down += _emit_last([pk(f"downPart.Level1.layers.Conv{i}.conv",
                               rbb=True) for i in range(nP)])   # feats[1]
        down.append(_pool_chain_stage(2, c1, dtype, device))
        # Level2 runs at f == 1: plain conv_blocks
        down += _emit_last([plain_block(f"downPart.Level2.layers.Conv{i}")
                            for i in range(nP)])                # feats[2]
        if fold_stem:
            pre = [pk("downPart.Level0.layers.Conv0.conv", rbb=True, stem_f=4)]
            pre += [pk(f"downPart.Level0.layers.Conv{i}.conv", rbb=True)
                    for i in range(1, n0)]
            down = _emit_last(pre) + down                        # feats[0]
    elif cfg.levels not in (1, 2):
        down = None
    else:
        down = _emit_last([pk(f"downPart.Level1.layers.Conv{i}.conv", rbb=True)
                           for i in range(nI)])                 # feats[1]
        down.append(pk("downPart.Level2.layers.Conv0.conv", rbb=True))
        for i in range(1, nI):  # Level2 grid-preserving convs: plain (f == 1)
            down.append(plain_block(f"downPart.Level2.layers.Conv{i}"))
        _emit_last(down)                                        # feats[2]
        if fold_stem:
            down.insert(0, pk("downPart.Level0.layers.Conv0.conv", rbb=True,
                              emit=True, stem_f=4))
    if cfg.v2:
        up = [pk(f"upPart.Up{D - 3}.conv", rbb=False),
              pk(f"upPart.Up{D - 2}.conv", split=True, rbb=False, skip_idx=0),
              pk("segmenter.layers.Class", split=True, rbb=False, skip_idx=1)]
    else:
        up = [pk(f"upPart.Up{D - 3}.conv", rbb=False, skip_idx=0),
              pk(f"upPart.Up{D - 2}.conv", rbb=False, skip_idx=1),
              pk("segmenter.layers.Class", rbb=False)]
    chains = {"down": down, "up": up, "fold_stem": fold_stem}
    if deep:
        names = [f"downPart.Level{D - 1}.layers.Conv{i}" for i in range(1, nI)] \
            + [f"PB.PB_1.layers.Conv{i}"
               for i in range(max(cfg.belly_size - 1, 1))] \
            + ["PB.PB_2.layers.Conv0"]
        chains["deep"] = [plain_block(n) for n in names]
    return chains


def build_packed_infer(model: Model, params: Optional[Params] = None,
                       dtype: torch.dtype = torch.bfloat16,
                       pallas: bool = False, pallas_fold_stem: bool = False,
                       pallas_deep: bool = False,
                       pallas_argmax_head: bool = True,
                       device: DeviceLike = None) -> PackedInfer:
    """Compile a ROBO-UNet (the flagship, ``--UNet``, ``--v2``, any levels,
    QVGA and VGA), or PB_FCN_2's segmentation net, for inference (exact
    rewrite).

    ``params``: the port's state_dict (``model.state_dict()`` when None).
    ``pallas=True``: the packed-grid regions run as fused chains (K2 on
    CUDA; the flags keep the JAX package's names), the stem folded into the
    down chain with ``pallas_fold_stem`` and the deepest grid's convs as a
    third chain with ``pallas_deep``. ``pallas_argmax_head=False`` keeps the
    logits head and argmaxes outside the kernel. Runs on ``device``
    (``cuda`` unless the caller passes another)."""
    dev = resolve_device(device)
    cfg = model.cfg
    if isinstance(cfg, PBFCN2Cfg):
        # PB_FCN_2's segmentation graph is the flagship plan under the same
        # block names; only its unused classification head differs
        if cfg.classify or cfg.levels != 2:
            raise ValueError("the packed PB_FCN_2 graph is its segmentation "
                             "net with levels == 2")
        cfg = RoboUNetCfg(planes=cfg.planes, num_classes=cfg.num_classes,
                          depth=cfg.depth, levels=cfg.levels,
                          belly_size=cfg.belly_size,
                          belly_planes=cfg.belly_planes)
    if not isinstance(cfg, RoboUNetCfg):
        raise ValueError("build_packed_infer takes ROBO-UNet and PB_FCN_2; "
                         "use build_packed_pb_fcn for PB_FCN")
    if cfg.eff_depth < 4:
        raise ValueError("the packed plan needs eff_depth >= 4")
    plan = _robo_unet_plan(cfg)
    state = model.state_dict() if params is None else params
    np_params = to_jax_params(model.registry, state)
    all_blks = [b for lvl in plan.downs for b in lvl] + list(plan.ups) \
        + [plan.head]
    packed = _pack_blocks(np_params, all_blks, dtype, dev)
    plain = {k: v.detach().to(device=dev, dtype=dtype) for k, v in state.items()}
    chains = None
    if pallas:
        full_downs = cfg.pool or cfg.levels in (1, 2)
        if pallas_fold_stem and not full_downs:
            raise ValueError("fold_stem needs the fully chained down region")
        if pallas_deep and (cfg.pool or not full_downs or cfg.belly_size == 0):
            raise ValueError("the deep chain covers strided plans with a PB "
                             "belly")
        chains = _build_flagship_chains(cfg, packed, np_params, dtype, dev,
                                        pallas_fold_stem, pallas_deep)
        chains["argmax_head"] = pallas_argmax_head
    return PackedInfer(cfg, plan, packed, plain, dtype, dev, chains)


# ---------------------------------------------------------------------------
# PB_FCN
# ---------------------------------------------------------------------------


def _pb_fcn_blks(cfg: PBFCNCfg):
    """Packed blocks of the PB_FCN top (reference model.py:201-232,
    269-309). FCN.conv0 is a dilated (d=2) ConvPoolSimple, packed by the
    dilation-aware pack_conv_weight (taps r = q + dil*(d-1), valid for
    dil <= f); the f == 1 levels stay plain."""
    ups = []
    n_up = 4 if cfg.no_scale else 3
    for j in range(n_up):
        r = n_up - 1 - j  # output resolution level
        ups.append(_Blk("ptconv", f"up{j + 1}", _f_at(r + 1), _f_at(r),
                        rbb=False))
    return [
        _Blk("pconv", "FCN.conv0", 4, 4, rbb=False, dil=2, pad=2),
        _Blk("pconv", "FCN.conv1", 4, 2, stride=2, rbb=False),
        _Blk("pconv_nr", "FCN.conv2", 2, 2, dil=2, wkey="FCN.conv2.conv1"),
        _Blk("pconv", "FCN.conv2", 2, 1, stride=2, rbb=False,
             wkey="FCN.conv2.pool", bnkey="FCN.conv2.bn"),
    ] + ups + [
        _Blk("head", "segmenter.classifier", 4, 4, k=cfg.kernel_size,
             pad=cfg.kernel_size // 2),
    ]


@dataclasses.dataclass
class PackedPBFCNInfer(_PackedBase):
    """Compiled-for-inference PB_FCN segmentation net (reference
    model.py:269-309 over the DownSampler encoder model.py:201-232), the net
    tester.py serves and the C++ engine deploys. Exact rewrite of
    zoo.pb_fcn_apply (segment mode)."""

    cfg: PBFCNCfg
    packed: Params
    plain: Params
    dtype: torch.dtype
    device: torch.device
    chains: Optional[dict] = None   # fused regions (pallas=True)

    def _logits_packed(self, x: torch.Tensor, argmax: bool = False
                       ) -> torch.Tensor:
        cfg, p, ch = self.cfg, self.plain, self.chains
        assert not argmax or ch is not None  # the fused argmax is a chain head
        dc = ch.get("deep") if ch is not None else None
        blks = {b.kind + ":" + b.name: b for b in _pb_fcn_blks(cfg)}
        h = space_to_depth(x.to(self.dtype), 4)

        def cps(name, x):
            return L.conv_pool_simple(p, name, x, 1, 2, 2)

        def pool_tail(name, y):
            # the stride-2 pool conv + BN tail of a ConvPool whose dilated
            # conv1 ran as the down chain's last stage
            y = L.conv(p, name + ".pool", y, stride=2, padding=1)
            return nn.relu(L.bn(p, name + ".bn", y))

        if ch is not None:
            outs = self._chain("down", h, ch["down"])
            x0, x1, x2 = outs[:3]
        else:
            x0 = self._blk(blks["pconv:FCN.conv0"], h)
            x1 = self._blk(blks["pconv:FCN.conv1"], x0)
            hh = self._blk(blks["pconv_nr:FCN.conv2"], x1)
            x2 = self._blk(blks["pconv:FCN.conv2"], hh)

        def deep(h):
            h = L.conv_pool(p, "FCN.conv3", h)
            for i in range(4, 9):
                h = cps(f"FCN.conv{i}", h)
            return h

        if dc is not None:
            # outs[3] is the dilated relu-only conv1 of the ConvPool that
            # follows x2 (conv_ext when no_scale, conv3 otherwise)
            if cfg.no_scale:
                x3 = pool_tail("FCN.conv_ext", outs[3])
                y = L.conv_pool(p, "FCN.conv3", x3)
            else:
                y = pool_tail("FCN.conv3", outs[3])
            y = self._chain("deep", y, dc)[-1]
            feats = [x0, x1, x2, x3, y] if cfg.no_scale else [x0, x1, x2, y]
        elif cfg.no_scale:
            x3 = L.conv_pool(p, "FCN.conv_ext", x2)
            feats = [x0, x1, x2, x3, deep(x3)]
        else:
            feats = [x0, x1, x2, deep(x2)]

        up = feats[-1]
        n_up = len(feats) - 1
        if ch is not None:
            for j in range(n_up - 2):  # f == 1 ups stay on the plain path
                up = self._blk(blks[f"ptconv:up{j + 1}"], up) \
                    + feats[n_up - 1 - j]
            up_ch = ckp.with_argmax_head(ch["up"], 16) if argmax else ch["up"]
            return self._chain("up", up, up_ch, skips=[x1, x0])[-1]
        for j in range(n_up):
            up = self._blk(blks[f"ptconv:up{j + 1}"], up) + feats[n_up - 1 - j]
        return self._blk(blks["head:segmenter.classifier"], up)


def build_packed_pb_fcn(model: Model, params: Optional[Params] = None,
                        dtype: torch.dtype = torch.bfloat16,
                        pallas: bool = False, pallas_deep: bool = False,
                        pallas_argmax_head: bool = True,
                        device: DeviceLike = None) -> PackedPBFCNInfer:
    """Compile a PB_FCN (segment mode) for inference, the net the
    reference's tester.py serves (tester.py:142-144).

    ``pallas=True``: the down and up regions run as fused chains (K2 on
    CUDA); ``pallas_deep`` also moves the dilated conv1 of the ConvPool
    after x2 into the down chain and runs the five dilated deep convs as a
    third chain. Runs on ``device`` (``cuda`` unless the caller passes
    another)."""
    dev = resolve_device(device)
    cfg = model.cfg
    if not isinstance(cfg, PBFCNCfg) or cfg.classify:
        raise ValueError("the packed PB_FCN graph is the segmentation PB_FCN")
    state = model.state_dict() if params is None else params
    np_params = to_jax_params(model.registry, state)
    packed = _pack_blocks(np_params, _pb_fcn_blks(cfg), dtype, dev)
    plain = {k: v.detach().to(device=dev, dtype=dtype) for k, v in state.items()}
    chains = None
    if pallas:
        def pk(prefix, **kw):
            return _packed_stage(packed, prefix, **kw)

        # no folded stem: FCN.conv0 is dilated, which the grouped stem
        # kernel does not encode, so the chain starts at the packed input
        down = [pk("FCN.conv0.conv", rbb=False, emit=True),      # x0
                pk("FCN.conv1.conv", rbb=False, emit=True),      # x1
                pk("FCN.conv2.conv1", relu_only=True),           # pconv_nr
                pk("FCN.conv2.pool", rbb=False)]                 # x2
        n_up = 4 if cfg.no_scale else 3
        up = [pk(f"up{n_up - 1}.conv", rbb=False, skip_idx=0),
              pk(f"up{n_up}.conv", rbb=False, skip_idx=1),
              pk("segmenter.classifier")]
        chains = {"down": down, "up": up, "argmax_head": pallas_argmax_head}
        if pallas_deep:
            nxt = "FCN.conv_ext" if cfg.no_scale else "FCN.conv3"
            w = torch.as_tensor(np_params[nxt + ".conv1.weight"]).to(
                device=dev, dtype=dtype)
            down[-1] = dataclasses.replace(down[-1], emit=True)  # x2
            down.append(ckp.ChainStage(
                w=w, b=torch.zeros(w.shape[-1], device=dev), relu_only=True,
                dil=2, taps=ckp.tap_blocks(w)))
            chains["deep"] = [
                _plain_stage(np_params, f"FCN.conv{i}", dtype, dev, rbb=False,
                             dil=2) for i in range(4, 9)]
    return PackedPBFCNInfer(cfg, packed, plain, dtype, dev, chains)


# ---------------------------------------------------------------------------
# LabelProp
# ---------------------------------------------------------------------------


# Packed blocks of LabelProp (reference model.py:538-567): conv -> BN -> ReLU
# blocks and tconvs at f > 1; down3, the dilated belly and upConv1 stay plain
# (f == 1).
_LABEL_PROP_BLKS = {b.name: b for b in (
    _Blk("stem", "pre", 4, 4, rbb=False),
    _Blk("pconv", "down1", 4, 2, stride=2, rbb=False),
    _Blk("pconv", "down2", 2, 1, stride=2, rbb=False),
    _Blk("ptconv", "upConv2", 1, 2, rbb=False),
    _Blk("ptconv", "upConv3", 2, 4, rbb=False),
    _Blk("head", "classifier", 4, 4, k=1, pad=0),
)}


@dataclasses.dataclass
class PackedLabelPropInfer(_PackedBase):
    """Compiled-for-inference LabelProp net (reference model.py:538-567),
    an exact rewrite of zoo.label_prop_apply. Input: (N, H, W, 8) = [Y_t,
    Y_other, Y_t - Y_other, one-hot previous label]."""

    cfg: LabelPropCfg
    packed: Params
    plain: Params
    dtype: torch.dtype
    device: torch.device
    chains: Optional[dict] = None   # fused regions (pallas=True)

    def _logits_packed(self, x: torch.Tensor, argmax: bool = False
                       ) -> torch.Tensor:
        p, ch = self.plain, self.chains
        assert not argmax or ch is not None  # the fused argmax is a chain head
        h = x.to(self.dtype)
        blks = _LABEL_PROP_BLKS

        def cps(name, x, stride, padding, dilation):
            return L.conv_pool_simple(p, name, x, stride, padding, dilation)

        if ch is not None and ch["fold_stem"]:
            # stage 0 reads the raw input and emits top itself
            top, middle, bottom = self._chain("down", h, ch["down"])
        else:
            top = self._blk(blks["pre"], h)
            if ch is not None:
                middle, bottom = self._chain("down", top, ch["down"])
            else:
                middle = self._blk(blks["down1"], top)
                bottom = self._blk(blks["down2"], middle)
        h = cps("down3", bottom, 2, 1, 1)
        if ch is not None and ch.get("mid") is not None:
            # the dilated belly as one chain on the 1/8 grid
            h = self._chain("mid", h, ch["mid"])[-1]
        else:
            h = cps("conv3", cps("conv2", cps("conv1", h, 1, 2, 2), 1, 2, 2),
                    1, 2, 2)
        h = bottom + L.up_tconv(p, "upConv1", h)
        if ch is not None:
            up_ch = ckp.with_argmax_head(ch["up"], 16) if argmax else ch["up"]
            return self._chain("up", h, up_ch, skips=[middle, top])[-1]
        h = middle + self._blk(blks["upConv2"], h)
        h = self._blk(blks["upConv3"], h)
        # the channel-slice skip h[..., :C_pre] += top (model.py:565), folded
        # into the 1x1 classifier: conv(h + embed(top), W) == conv(h, W) +
        # conv(top, W[:, :C_pre])
        return self._conv_packed("classifier", h) \
            + nn.conv2d(top, self.packed["classifier.wtop"])


def build_packed_label_prop(model: Model, params: Optional[Params] = None,
                            dtype: torch.dtype = torch.bfloat16,
                            stem_group: int = 4, pallas: bool = False,
                            pallas_fold_stem: bool = False,
                            pallas_mid: bool = False,
                            pallas_argmax_head: bool = True,
                            device: DeviceLike = None) -> PackedLabelPropInfer:
    """Compile a LabelProp net for inference (exact rewrite of
    zoo.label_prop_apply), the net validLabelProp.py serves.

    ``params``: the port's state_dict (``model.state_dict()`` when None).
    ``stem_group``: the stem's input group width in pixels; only the group
    == f stem (4, or 0 for f) is ported, the wider groups the JAX package
    measured slower are not. ``pallas=True``: the down and up regions run
    as fused chains (K2 on CUDA), the stem folded into the down chain with
    ``pallas_fold_stem`` and the dilated belly as a third chain with
    ``pallas_mid``.
    ``pallas_argmax_head=False`` keeps the logits head and argmaxes outside
    the kernel. Runs on ``device`` (``cuda`` unless the caller passes
    another)."""
    dev = resolve_device(device)
    cfg = model.cfg
    if not isinstance(cfg, LabelPropCfg):
        raise ValueError("build_packed_label_prop takes the LabelProp family")
    if stem_group not in (0, 4):
        raise ValueError("only the group == f stem (stem_group 4) is ported, "
                         f"got {stem_group}")
    state = model.state_dict() if params is None else params
    np_params = to_jax_params(model.registry, state)
    packed = _pack_blocks(np_params, _LABEL_PROP_BLKS.values(), dtype, dev)
    # the channel-slice skip's classifier half (see _logits_packed), OIHW
    c_pre = np_params["pre.conv.weight"].shape[-1]
    wtop = pack_conv_weight(np_params["classifier.weight"][:, :, :c_pre], 4, 4)
    packed["classifier.wtop"] = torch.as_tensor(
        np.ascontiguousarray(np.transpose(wtop, (3, 2, 0, 1)))).to(
            device=dev, dtype=dtype)
    plain = {k: v.detach().to(device=dev, dtype=dtype) for k, v in state.items()}
    chains = None
    if pallas:
        def pk(prefix, **kw):
            return _packed_stage(packed, prefix, **kw)

        down = [pk("down1.conv", rbb=False, emit=True),          # middle
                pk("down2.conv", rbb=False)]                      # bottom
        if pallas_fold_stem:
            down.insert(0, pk("pre.conv", rbb=False, emit=True, stem_f=4))
        skip_w = _hwio(packed["classifier.wtop"])
        up = [pk("upConv2.conv", rbb=False, skip_idx=0),          # + middle
              pk("upConv3.conv", rbb=False),
              pk("classifier", skip_idx=1, skip_w=skip_w)]        # + top
        chains = {"down": down, "up": up, "fold_stem": pallas_fold_stem,
                  "argmax_head": pallas_argmax_head}
        if pallas_mid:
            # the dilated belly (model.py:556-558): plain f == 1
            # conv_pool_simple blocks, conv -> BN -> ReLU
            chains["mid"] = [_plain_stage(np_params, n, dtype, dev, rbb=False,
                                          dil=2)
                             for n in ("conv1", "conv2", "conv3")]
    return PackedLabelPropInfer(cfg, packed, plain, dtype, dev, chains)


# Per-family calibration statistic of quantize_int8: the
# percentile of |activation| (None: its max), from the JAX package's
# trained-net sweeps (robocupvision_tpu/models/packed.py INT8_PCT_DEFAULTS,
# tests/test_int8_families.py). Percentile clipping helps the deeper dilated
# stacks, where one outlier stretches every quantization step of a stage.
INT8_PCT_DEFAULTS = {
    "robo_unet": 99.9,
    "robo_unet_v2": 99.9,
    "robo_unet_pool": None,
    "pb_fcn": 99.9,
    "label_prop": None,
}

_CHAIN_TAGS = ("down", "mid", "deep", "up")


def _int8_family_key(infer) -> str:
    if isinstance(infer, PackedLabelPropInfer):
        return "label_prop"
    if isinstance(infer, PackedPBFCNInfer):
        return "pb_fcn"
    cfg = infer.cfg
    if getattr(cfg, "pool", False):
        return "robo_unet_pool"
    return "robo_unet_v2" if getattr(cfg, "v2", False) else "robo_unet"


def quantize_int8(infer, calib_x, pct="auto"):
    """Static int8 post-training quantization of a chain graph (any
    ``Packed*Infer`` built with ``pallas=True``), as the JAX package's
    ``quantize_int8`` does it: one calibration pass over ``calib_x``
    (representative inputs; stack frames along the batch axis for more)
    collects each chain stage's statistic of |input| -- its max
    (``pct=None``), its ``pct``-th percentile, or with ``pct="auto"`` what
    the family's :data:`INT8_PCT_DEFAULTS` entry says (the trained-net
    envelope sweeps the three) -- and every chain is rebuilt with static
    per-stage input scales and symmetric per-output-channel int8 weights
    (ops/cuda_packed.quantize_chain_stages). The calibration pass runs the
    chains through ``fused_conv_chain`` (K2 on the card) with every stage
    emitted. Returns a new instance; ``infer`` is left as it was. Raises
    ``ValueError`` for a graph without chains or one already quantized."""
    if isinstance(pct, str):
        if pct != "auto":
            raise ValueError(f"pct must be None, a percentile or 'auto', "
                             f"not {pct!r}")
        pct = INT8_PCT_DEFAULTS[_int8_family_key(infer)]
    ch = infer.chains
    if ch is None:
        raise ValueError("quantize_int8 needs a chain graph (pallas=True)")
    if any(ch.get(tag) and ch[tag][0].x_scale for tag in _CHAIN_TAGS):
        raise ValueError("the graph is already quantized")
    collect: dict = {}
    probe = dataclasses.replace(infer, chains={**ch, "collect": collect,
                                               "collect_pct": pct})
    with torch.no_grad():
        probe._logits_packed(probe._input(calib_x))
    q = dict(ch)
    for tag in _CHAIN_TAGS:
        if q.get(tag):
            q[tag] = ckp.quantize_chain_stages(q[tag], collect[tag])
    return dataclasses.replace(infer, chains=q)


# ---- packed TRAINING graph ----------------------------------------------------
#
# The same exact rewrite, made differentiable (the JAX package's
# packed_train_apply): each packed kernel is a gather of the live weight
# (each packed position reads one original weight or a structural zero),
# so autograd scatter-adds the gradients back onto the original parameter
# tensors, and the train state, checkpoints, optimizer and prune masks
# keep the canonical layout. The gather maps are built over the port's own
# torch layouts and index the packed kernel in torch's conv layout (out,
# in, kh, kw), so a step gathers from the live leaf with no permute copy.
# Only the positions that read a weight are gathered, into a zero kernel:
# the JAX package's gather of an appended zero sends the structural zeros
# (most positions) to one index, and on the card the backward of such a
# gather (a sort-based scatter-add) walks that run serially, 19.9 ms a
# b64 step on an H100 (PERF.md). BatchNorm runs in train mode with phase-grouped statistics: the
# packed activation (N, Hp, Wp, t*C) is viewed as (N, Hp, Wp, t, C), and
# batch_norm_train reduces over every axis but the last, per original
# channel, over the same values as the unpacked graph.


def _gather_index_map(spec: L.ParamSpec, packer) -> np.ndarray:
    """Index map for the weight ``spec`` (the port's torch layout): packed
    kernel position, in torch's conv layout (out, in, kh, kw) -> flat index
    into the torch-layout weight, with ``numel`` as the structural-zero
    sentinel (one zero is appended to the flattened weight at gather
    time). ``packer`` takes the JAX package's HWIO layout, so the index
    array is carried there (``to_jax_layout``) and packed."""
    n = int(np.prod(spec.torch_shape))
    ids = np.arange(1, n + 1, dtype=np.int64).reshape(spec.torch_shape)
    packed = packer(to_jax_layout(ids, spec.kind))   # HWIO of ids, 0 = zero
    idx = np.transpose(packed, (3, 2, 0, 1)) - 1     # -> (out, in, kh, kw)
    return np.ascontiguousarray(np.where(idx < 0, n, idx))


@dataclasses.dataclass(frozen=True)
class Gather:
    """A packed kernel as a gather: its (out, in, kh, kw) shape, the flat
    positions that read a weight and the flat weight index each reads;
    every other position is a structural zero."""

    shape: Tuple[int, ...]
    pos: torch.Tensor
    src: torch.Tensor

    @classmethod
    def from_index_map(cls, idx: np.ndarray, n: int,
                       device: torch.device) -> "Gather":
        flat = idx.reshape(-1)
        pos = np.flatnonzero(flat != n)
        return cls(tuple(idx.shape), torch.from_numpy(pos).to(device),
                   torch.from_numpy(flat[pos]).to(device))


@dataclasses.dataclass(frozen=True)
class PackMaps:
    """Gathers and tile factors of the packed-training forward."""

    cfg: RoboUNetCfg
    gathers: Dict[str, Gather]  # conv name -> its packed kernel's gather
    tile: Dict[str, int]        # conv name -> f_out^2 per-channel tiling


def build_train_pack_maps(model: Model) -> PackMaps:
    """The gather maps of a ROBO-UNet configuration, built once on the
    host and kept on the model's device. The family build_packed_infer
    packs without pooling or concat skips: pool=False, v2=False,
    levels=2, belly_size>0, class_size=1, eff_depth>=4."""
    cfg = model.cfg
    assert isinstance(cfg, RoboUNetCfg), "packed training is ROBO-UNet only"
    assert not cfg.pool and not cfg.v2, "pool/v2 variants not packed (yet)"
    assert cfg.levels == 2 and cfg.belly_size > 0 and cfg.class_size == 1
    assert cfg.eff_depth >= 4

    specs = model.registry.specs
    gathers: Dict[str, Gather] = {}
    tile: Dict[str, int] = {}

    def add(name, wname, packer, f_out):
        spec = specs[wname]
        gathers[name] = Gather.from_index_map(
            _gather_index_map(spec, packer), int(np.prod(spec.shape)),
            model.device)
        tile[name] = f_out * f_out

    def add_block(name, packer, f_out):
        add(name, name + ".conv.weight", packer, f_out)

    add_block("downPart.Level0.layers.Conv0",
              lambda w: pack_stem_weight_grouped(w, 4), 4)
    add_block("downPart.Level1.layers.Conv0",
              lambda w: pack_conv_weight(w, 4, 2, 2), 2)
    add_block("downPart.Level1.layers.Conv1",
              lambda w: pack_conv_weight(w, 2, 2, 1), 2)
    add_block("downPart.Level2.layers.Conv0",
              lambda w: pack_conv_weight(w, 2, 1, 2), 1)
    D = cfg.eff_depth
    for j in range(D - 1):
        r = D - 2 - j
        if _f_at(r) > 1:
            add_block(f"upPart.Up{j}",
                      lambda w, fi=_f_at(r + 1), fo=_f_at(r):
                          pack_conv_weight(w, fi, fo, transpose=True),
                      _f_at(r))
    name = "segmenter.layers.Class"
    add(name, name + ".weight", lambda w: pack_conv_weight(w, 4, 4, 1), 4)
    return PackMaps(cfg, gathers, tile)


def _gather_weight(p: Params, wname: str, g: Gather) -> torch.Tensor:
    """The packed kernel: the live weight gathered into its non-zero
    positions (autograd scatter-adds the gradient back onto the weight)."""
    w = p[wname].reshape(-1)
    return w.new_zeros(int(np.prod(g.shape))).index_copy(
        0, g.pos, w[g.src]).reshape(g.shape)


def _packed_bn(p: Params, name: str, x: torch.Tensor, t: int) -> torch.Tensor:
    """BatchNorm over the packed layout with per-original-channel
    statistics."""
    n, hp, wp, cp = x.shape
    y = L.bn(p, name, x.reshape(n, hp, wp, t, cp // t))
    return y.reshape(n, hp, wp, cp)


def _pconv(maps: PackMaps, p: Params, name: str, x: torch.Tensor,
           wname: str, bname: str, **kw) -> torch.Tensor:
    w = _gather_weight(p, wname, maps.gathers[name])
    return nn.conv2d(x, w, p[bname].repeat(maps.tile[name]),
                     padding=kw.pop("padding", int(w.shape[2]) // 2), **kw)


def _pconv_block(maps: PackMaps, p: Params, name: str,
                 x: torch.Tensor) -> torch.Tensor:
    """Packed conv_block: conv -> ReLU -> BN (reference model.py:116)."""
    y = _pconv(maps, p, name, x, name + ".conv.weight", name + ".conv.bias")
    return _packed_bn(p, name + ".bn", nn.relu(y), maps.tile[name])


def _ptconv_block(maps: PackMaps, p: Params, name: str,
                  x: torch.Tensor) -> torch.Tensor:
    """Packed up_tconv: tconv -> BN -> ReLU."""
    y = _pconv(maps, p, name, x, name + ".conv.weight", name + ".conv.bias")
    return nn.relu(_packed_bn(p, name + ".bn", y, maps.tile[name]))


def pack_targets(targets: torch.Tensor) -> torch.Tensor:
    """(N, H, W) int labels -> (N, H/4, W/4, 16) packed labels. The pixel
    set is kept, so the loss and metrics over the packed layout are
    exact."""
    return space_to_depth(targets[..., None], 4)


def packed_train_apply(maps: PackMaps, p: Params, x: torch.Tensor, *,
                       train: bool = True):
    """The packed forward with live params, BN in train mode (batch
    statistics, padded samples left out under ``layers.bn_stats_mask``)
    when ``train``. Returns ((N, H/4, W/4, 16, num_classes) logits, mut):
    zoo.robo_unet_apply rewritten exactly, up to float reassociation;
    pair it with :func:`pack_targets`. The segmentation head has no
    dropout (reference model.py:410, the pool=False path)."""
    cfg = maps.cfg
    n, H, W, c = x.shape
    assert H % 8 == 0 and W % 8 == 0, (H, W)
    ctx = L.train_mode() if train else contextlib.nullcontext({})
    with ctx as mut:
        logits = _packed_forward(maps, cfg, p, x)
    nl, hp, wp, _ = logits.shape
    return logits.reshape(nl, hp, wp, 16, cfg.num_classes), mut


def _packed_forward(maps: PackMaps, cfg: RoboUNetCfg, p: Params,
                    x: torch.Tensor) -> torch.Tensor:
    D = cfg.eff_depth
    n, H, W, c = x.shape
    feats = {}
    name = "downPart.Level0.layers.Conv0"
    y = _pconv(maps, p, name, x.reshape(n, H, W // 4, 4 * c),
               name + ".conv.weight", name + ".conv.bias", stride=(4, 1),
               padding=1)
    h = _packed_bn(p, name + ".bn", nn.relu(y), 16)
    feats[0] = h
    h = _pconv_block(maps, p, "downPart.Level1.layers.Conv0", h)
    h = _pconv_block(maps, p, "downPart.Level1.layers.Conv1", h)
    feats[1] = h
    h = _pconv_block(maps, p, "downPart.Level2.layers.Conv0", h)
    h = L.conv_block(p, "downPart.Level2.layers.Conv1", h, 1, 3)
    feats[2] = h
    for i in range(3, D):
        h = L.level_down(p, f"downPart.Level{i}", h, cfg.levels, True, False)
        feats[i] = h
    h2 = L.level_down(p, "PB.PB_1", h, cfg.belly_size - 1, False, False)
    up = L.level_down(p, "PB.PB_2", h2, 1, False, False)
    for j in range(D - 1):
        r = D - 2 - j
        if _f_at(r) == 1:
            up = L.up_tconv(p, f"upPart.Up{j}", up) + feats[r]
        else:
            up = _ptconv_block(maps, p, f"upPart.Up{j}", up) + feats[r]
    name = "segmenter.layers.Class"
    return _pconv(maps, p, name, up, name + ".weight", name + ".bias",
                  padding=0)
