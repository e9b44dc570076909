"""Model zoo: the ROBO-UNet family (reference model.py:461-536)
at QVGA and at VGA (``no_scale``), the flagship with additive skips, the
``--UNet`` variant (``pool``: max-pool downs) and the ``--v2`` variant
(concat skips), with its analytic op count; PB_FCN over its DownSampler
encoder (model.py:201-232, 269-309) and PB_FCN_2 (model.py:416-459), each
in its segmentation and classification modes; and the LabelProp net
(model.py:538-567); and the classifier baselines of classVal.py and
objDetEval.py: the FCN (model.py:311-330), BNN L and MC (model.py:569-619),
and the standalone DownSampler and Classifier (classVal.py:60-61; the
DownSampler's forward returns the encoder's feature tuple).

``make(family, ...)`` returns a :class:`Model`, an ``nn.Module`` whose
``state_dict`` carries the registry names; its ``forward`` takes NHWC input
and returns NHWC logits with the module's own weights, and ``apply`` does
the same with given params, in eval or train mode, like the JAX package's
``Model.apply``. A train-mode forward drops channels (elements at BNN L's
``fc``) at the family's dropout sites (PB_FCN_2's classifier, LabelProp's
conv blocks when its ``dropout`` is set, BNN's convs) by keep masks that
``Model.draw_dropout`` draws from a ``torch.Generator``, or that the
caller gives.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple, Union

import torch

from robocupvision_tpu_torch.device import DeviceLike, resolve_device
from robocupvision_tpu_torch.models import layers as L
from robocupvision_tpu_torch.ops import nn

Params = L.Params


# =============================================================================
# DownSampler (PB-FCN encoder) -- reference model.py:201-232
# =============================================================================


@dataclasses.dataclass(frozen=True)
class DownSamplerCfg:
    planes: int = 32
    no_scale: bool = False


def downsampler_registry(cfg: DownSamplerCfg, r: L.Registry,
                         prefix: str = "") -> None:
    p = cfg.planes
    L.conv_pool_simple_def(r, prefix + "conv0", 3, p // 4, 3, bias=False)
    L.conv_pool_simple_def(r, prefix + "conv1", p // 4, p // 2, 3, bias=False)
    L.conv_pool_def(r, prefix + "conv2", p // 2, p)
    if cfg.no_scale:
        L.conv_pool_def(r, prefix + "conv_ext", p, p)
    L.conv_pool_def(r, prefix + "conv3", p, p * 2)
    L.conv_pool_simple_def(r, prefix + "conv4", p * 2, p * 4, 3, bias=False)
    for i in (5, 6, 7):
        L.conv_pool_simple_def(r, prefix + f"conv{i}", p * 4, p * 4, 3,
                               bias=False)
    L.conv_pool_simple_def(r, prefix + "conv8", p * 4, p * 2, 3, bias=False)


def downsampler_apply(cfg: DownSamplerCfg, p: Params, x, prefix: str = ""):
    """Returns (f4, f3, f2, f1, f0); f4 is None unless no_scale."""
    def cps(name, x, stride, padding, dilation):
        return L.conv_pool_simple(p, prefix + name, x, stride, padding,
                                  dilation)

    x0 = cps("conv0", x, 1, 2, 2)
    x1 = cps("conv1", x0, 2, 1, 1)
    x2 = L.conv_pool(p, prefix + "conv2", x1)

    def deep(h):
        h = L.conv_pool(p, prefix + "conv3", h)
        for i in range(4, 9):
            h = cps(f"conv{i}", h, 1, 2, 2)
        return h

    if cfg.no_scale:
        x3 = L.conv_pool(p, prefix + "conv_ext", x2)
        return deep(x3), x3, x2, x1, x0
    return None, deep(x2), x2, x1, x0


# =============================================================================
# PB_FCN -- reference model.py:269-309
# =============================================================================


@dataclasses.dataclass(frozen=True)
class PBFCNCfg:
    planes: int = 32
    num_classes: int = 5
    kernel_size: int = 1
    no_scale: bool = False
    classify: bool = False

    @property
    def img_shape(self) -> Tuple[int, int]:
        return (240, 320) if self.no_scale else (120, 160)


def pb_fcn_registry(cfg: PBFCNCfg) -> L.Registry:
    r = L.Registry()
    pl = cfg.planes
    mult = 2 if cfg.no_scale else 1
    out = pl // 4
    downsampler_registry(DownSamplerCfg(pl, cfg.no_scale), r, "FCN.")
    L.up_tconv_def(r, "up1", pl * 2, pl)
    L.up_tconv_def(r, "up2", pl, pl // 2 * mult)
    L.up_tconv_def(r, "up3", pl // 2 * mult, out * mult)
    if cfg.no_scale:
        L.up_tconv_def(r, "up4", pl // 2, out)
    L.classifier_def(r, "classifier", pl * 2, cfg.num_classes, cfg.kernel_size)
    L.classifier_def(r, "segmenter", out, cfg.num_classes, cfg.kernel_size)
    return r


def pb_fcn_apply(cfg: PBFCNCfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    ds = DownSamplerCfg(cfg.planes, cfg.no_scale)
    f4, f3, f2, f1, f0 = downsampler_apply(ds, p, x, "FCN.")
    if cfg.classify:
        feat = f4 if cfg.no_scale else f3
        return L.classifier(p, "classifier", feat, 2 if cfg.no_scale else 4,
                            cfg.kernel_size)
    if cfg.no_scale:
        h = L.up_tconv(p, "up1", f4) + f3
        h = L.up_tconv(p, "up2", h) + f2
        h = L.up_tconv(p, "up3", h) + f1
        h = L.up_tconv(p, "up4", h) + f0
    else:
        h = L.up_tconv(p, "up1", f3) + f2
        h = L.up_tconv(p, "up2", h) + f1
        h = L.up_tconv(p, "up3", h) + f0
    return L.classifier(p, "segmenter", h, 0, cfg.kernel_size)


# =============================================================================
# ROBO_UNet -- reference model.py:461-536
# =============================================================================


@dataclasses.dataclass(frozen=True)
class RoboUNetCfg:
    no_scale: bool = False
    planes: int = 8
    num_classes: int = 5
    depth: int = 4
    levels: int = 2
    belly_size: int = 5
    belly_planes: int = 128
    pool: bool = False  # vanilla-UNet mode
    v2: bool = False    # concat skips instead of add
    class_size: int = 1

    @property
    def eff_depth(self) -> int:
        return self.depth + 1 if self.no_scale else self.depth

    @property
    def img_shape(self) -> Tuple[int, int]:
        return (240, 320) if self.no_scale else (120, 160)


def robo_unet_registry(cfg: RoboUNetCfg) -> L.Registry:
    r = L.Registry()
    depth = cfg.eff_depth
    pl = cfg.planes
    max_depth = pl * 2 ** (depth - 1)

    L.level_down_def(r, "downPart.Level0", 3, pl, cfg.levels - 1, False, cfg.pool)
    for i in range(depth - 1):
        n_ch = pl * 2 ** i
        L.level_down_def(r, f"downPart.Level{i + 1}", n_ch, n_ch * 2,
                         cfg.levels, True, cfg.pool)
    if cfg.belly_size > 0:
        L.level_down_def(r, "PB.PB_1", max_depth, cfg.belly_planes,
                         cfg.belly_size - 1, False, False)
        L.level_down_def(r, "PB.PB_2", cfg.belly_planes, max_depth, 1, False, False)
    for i in range(depth - 1):
        n_ch = pl * 2 ** (depth - 1 - i)
        o_ch = n_ch // 2
        if i > 0 and cfg.v2:
            n_ch *= 2
        L.up_tconv_def(r, f"upPart.Up{i}", n_ch, o_ch)
    L.ult_classifier_def(r, "segmenter", pl * 2 if cfg.v2 else pl,
                         cfg.num_classes, cfg.class_size)
    return r


def robo_unet_apply(cfg: RoboUNetCfg, p: Params, x: torch.Tensor):
    """NHWC input -> NHWC logits (train mode under ``layers.train_mode``)."""
    depth = cfg.eff_depth
    downs = [x]
    downs.append(L.level_down(p, "downPart.Level0", x, cfg.levels - 1, False,
                              cfg.pool))
    for i in range(depth - 1):
        downs.append(L.level_down(p, f"downPart.Level{i + 1}", downs[-1],
                                  cfg.levels, True, cfg.pool))
    if cfg.belly_size > 0:
        h = L.level_down(p, "PB.PB_1", downs[-1], cfg.belly_size - 1, False,
                         False)
        downs[-1] = L.level_down(p, "PB.PB_2", h, 1, False, False)

    up = downs[-1]
    for i in range(depth - 1):
        y = L.up_tconv(p, f"upPart.Up{i}", up)
        skip = downs[-(i + 2)]
        up = torch.cat([y, skip], dim=-1) if cfg.v2 else y + skip
    return L.ult_classifier(p, "segmenter", up, cfg.class_size)


def robo_unet_get_computations(cfg: RoboUNetCfg, params: Optional[Params] = None,
                               pruned: bool = False):
    """Analytic per-layer op counts (reference model.py:513-536).

    Conv cost: k*k*W*H*Cin*Cout*2*nnz_ratio + W*H*Cout*4 (the BN/ReLU tail);
    pool cost: W*H*C; the last entry is the segmenter estimate
    H*W*nClass*planes*2 (the reference's formula, kept as it is).

    ``params`` (the port's state_dict, torch layouts) gives each layer's
    widths from its kernel's shape, and with ``pruned`` its share of
    non-zero weights.
    """
    H, W = cfg.img_shape

    def ratio(name):
        if not pruned or params is None:
            return 1.0
        w = params[name + ".weight"]
        return float(torch.count_nonzero(torch.as_tensor(w))) / w.numel()

    def shape(name):
        w = None if params is None else params.get(name + ".weight")
        return None if w is None else tuple(w.shape)

    comp = []
    depth = cfg.eff_depth
    pl = cfg.planes

    def conv_cost(name, cin, cout, k, stride, w, h):
        s = shape(name)
        if s is not None:  # conv (out, in, kh, kw)
            cout, cin, k = s[0], s[1], s[2]
        w2, h2 = w // stride, h // stride
        comp.append(k * k * w2 * h2 * cin * cout * 2 * ratio(name)
                    + w2 * h2 * cout * 4)
        return w2, h2

    def level_cost(name, cin, cout, levels, do_pool, pool, w, h):
        if pool:
            if do_pool:
                s = shape(name + ".layers.Conv0.conv")
                if s is not None:  # a pool keeps its width: Conv0's Cin
                    cin = s[1]
                comp.append(w * h * cin)
                w, h = w // 2, h // 2
                levels -= 1
            levels = max(levels, 1)
            w, h = conv_cost(name + ".layers.Conv0.conv", cin, cout, 3, 1, w, h)
        else:
            w, h = conv_cost(name + ".layers.Conv0.conv", cin, cout, 3,
                             2 if do_pool else 1, w, h)
        for i in range(levels - 1):
            w, h = conv_cost(f"{name}.layers.Conv{i + 1}.conv", cout, cout, 3,
                             1, w, h)
        return w, h

    w, h = W, H
    w, h = level_cost("downPart.Level0", 3, pl, cfg.levels - 1, False,
                      cfg.pool, w, h)
    for i in range(depth - 1):
        n_ch = pl * 2 ** i
        w, h = level_cost(f"downPart.Level{i + 1}", n_ch, n_ch * 2, cfg.levels,
                          True, cfg.pool, w, h)
    max_depth = pl * 2 ** (depth - 1)
    if cfg.belly_size > 0:
        w, h = level_cost("PB.PB_1", max_depth, cfg.belly_planes,
                          cfg.belly_size - 1, False, False, w, h)
        w, h = level_cost("PB.PB_2", cfg.belly_planes, max_depth, 1, False,
                          False, w, h)
    for i in range(depth - 1):
        n_ch = pl * 2 ** (depth - 1 - i)
        o_ch = n_ch // 2
        if i > 0 and cfg.v2:
            n_ch *= 2
        name = f"upPart.Up{i}.conv"
        s = shape(name)
        if s is not None:  # tconv (in, out, kh, kw)
            n_ch, o_ch = s[0], s[1]
        comp.append(3 * 3 * w * h * n_ch * o_ch * 2 * ratio(name)
                    + w * h * o_ch * 4)
        w, h = w * 2, h * 2
    # the reference's segmenter estimate uses nClass*planes*2 even for v2,
    # whose head reads 2*planes; from params, planes is the head's Cin (/2
    # for v2)
    s = shape("segmenter.layers.Class")
    if s is not None:
        pl = s[1] // (2 if cfg.v2 else 1)
    comp.append(H * W * cfg.num_classes * pl * 2)
    return comp


# =============================================================================
# PB_FCN_2 -- reference model.py:416-459
# =============================================================================


@dataclasses.dataclass(frozen=True)
class PBFCN2Cfg:
    classify: bool = False
    num_classes: int = 5
    planes: int = 8
    depth: int = 4
    levels: int = 2
    belly_size: int = 5
    belly_planes: int = 128

    @property
    def img_shape(self) -> Tuple[int, int]:
        return (120, 160)


def pb_fcn_2_registry(cfg: PBFCN2Cfg) -> L.Registry:
    r = L.Registry()
    pl = cfg.planes
    max_depth = pl * 2 ** (cfg.depth - 1)
    L.level_down_def(r, "downPart.Level0", 3, pl, 1, False, False)
    for i in range(cfg.depth - 1):
        n_ch = pl * 2 ** i
        L.level_down_def(r, f"downPart.Level{i + 1}", n_ch, n_ch * 2,
                         cfg.levels, True, False)
    L.level_down_def(r, "PB.PB_1", max_depth, cfg.belly_planes,
                     cfg.belly_size - 1, False, False)
    L.level_down_def(r, "PB.PB_2", cfg.belly_planes, max_depth, 1, False, False)
    for i in range(cfg.depth - 1):
        n_ch = pl * 2 ** (cfg.depth - 1 - i)
        L.up_tconv_def(r, f"upPart.Up{i}", n_ch, n_ch // 2)
    L.ult_classifier_def(r, "classifier", max_depth, cfg.num_classes, 1)
    L.ult_classifier_def(r, "segmenter", pl, cfg.num_classes, 1)
    return r


def pb_fcn_2_apply(cfg: PBFCN2Cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    downs = [x]
    downs.append(L.level_down(p, "downPart.Level0", x, 1, False, False))
    for i in range(cfg.depth - 1):
        downs.append(L.level_down(p, f"downPart.Level{i + 1}", downs[-1],
                                  cfg.levels, True, False))
    h = L.level_down(p, "PB.PB_1", downs[-1], cfg.belly_size - 1, False, False)
    downs[-1] = L.level_down(p, "PB.PB_2", h, 1, False, False)
    if cfg.classify:
        return L.ult_classifier(p, "classifier", downs[-1], 1, pool=True)
    up = downs[-1]
    for i in range(cfg.depth - 1):
        up = L.up_tconv(p, f"upPart.Up{i}", up) + downs[-(i + 2)]
    return L.ult_classifier(p, "segmenter", up, 1)


# =============================================================================
# LabelProp -- reference model.py:538-567
# =============================================================================


@dataclasses.dataclass(frozen=True)
class LabelPropCfg:
    num_classes: int = 5
    planes: int = 32
    dropout: float = 0.0  # Dropout2d after each conv block, in training


def label_prop_registry(cfg: LabelPropCfg) -> L.Registry:
    r = L.Registry()
    pl = cfg.planes
    cin = 8  # the reference hard-codes 8 input channels (model.py:542)
    L.conv_pool_simple_def(r, "pre", cin, pl // 4, 3, bias=False)
    L.conv_pool_simple_def(r, "down1", pl // 4, pl // 2, 3, bias=False)
    L.conv_pool_simple_def(r, "down2", pl // 2, pl // 2, 3, bias=False)
    L.conv_pool_simple_def(r, "down3", pl // 2, pl, 3, bias=False)
    L.conv_pool_simple_def(r, "conv1", pl, pl * 2, 3, bias=False)
    L.conv_pool_simple_def(r, "conv2", pl * 2, pl * 2, 3, bias=False)
    L.conv_pool_simple_def(r, "conv3", pl * 2, pl, 3, bias=False)
    L.up_tconv_def(r, "upConv1", pl, pl // 2)
    L.up_tconv_def(r, "upConv2", pl // 2, pl // 2)
    L.up_tconv_def(r, "upConv3", pl // 2, pl // 2)
    r.conv("classifier", pl // 2, cfg.num_classes, 1, bias=True)
    return r


LP_DROPOUT_SITES = ("pre", "down1", "down2", "down3", "conv1", "conv2",
                    "conv3")


def label_prop_apply(cfg: LabelPropCfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 8) frame-pair input -> NHWC logits; in train mode with
    Dropout2d(``cfg.dropout``) after each conv block of the encoder (the
    dropout the reference's __init__ meant to wire, model.py:542)."""
    def cps(name, x, stride, padding, dilation):
        y = L.conv_pool_simple(p, name, x, stride, padding, dilation)
        return L.dropout2d(y, name)

    top = cps("pre", x, 1, 1, 1)
    middle = cps("down1", top, 2, 1, 1)
    bottom = cps("down2", middle, 2, 1, 1)
    h = cps("down3", bottom, 2, 1, 1)
    h = cps("conv3", cps("conv2", cps("conv1", h, 1, 2, 2), 1, 2, 2), 1, 2, 2)
    h = bottom + L.up_tconv(p, "upConv1", h)
    h = middle + L.up_tconv(p, "upConv2", h)
    h = L.up_tconv(p, "upConv3", h)
    # channel-slice skip: x[:, 0:C_pre] += top (reference model.py:565), NHWC
    pre_ch = top.shape[-1]
    h = torch.cat([h[..., :pre_ch] + top, h[..., pre_ch:]], dim=-1)
    return L.conv(p, "classifier", h, padding=0)


# =============================================================================
# FCN baseline -- reference model.py:235-254, 311-330
# =============================================================================


@dataclasses.dataclass(frozen=True)
class FCNCfg:
    planes: int = 32
    num_classes: int = 5


def fcn_registry(cfg: FCNCfg) -> L.Registry:
    r = L.Registry()
    pl = cfg.planes
    out = pl // 2
    L.conv_pool_simple_def(r, "FCN.conv0", 3, out, 3, bias=False)
    L.conv_pool_simple_def(r, "FCN.conv0_1", out, out, 3, bias=False)
    L.conv_pool_simple_def(r, "FCN.conv1", out, out, 3, bias=False)
    L.conv_pool_double_def(r, "FCN.conv2", out, pl)
    L.conv_pool_double_def(r, "FCN.conv3", pl, pl * 2)
    L.conv_pool_simple_def(r, "FCN.conv4", pl * 2, pl * 4, 3, bias=False)
    L.conv_pool_simple_def(r, "FCN.conv5", pl * 4, pl * 2, 3, bias=False)
    L.up_tconv_def(r, "up1", pl * 2, pl)
    L.up_tconv_def(r, "up2", pl, pl // 2)
    L.up_tconv_def(r, "up3", pl // 2, pl // 2)
    L.classifier_def(r, "classifier", pl // 2, cfg.num_classes, 1)
    return r


def fcn_apply(cfg: FCNCfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    def cps(name, x, stride, padding, dilation):
        return L.conv_pool_simple(p, name, x, stride, padding, dilation)

    x0 = cps("FCN.conv0_1", cps("FCN.conv0", x, 1, 2, 2), 1, 2, 2)
    x1 = cps("FCN.conv1", x0, 2, 1, 1)
    x2 = L.conv_pool_double(p, "FCN.conv2", x1)
    x3 = L.conv_pool_double(p, "FCN.conv3", x2)
    x3 = cps("FCN.conv5", cps("FCN.conv4", x3, 1, 2, 2), 1, 2, 2)
    h = L.up_tconv(p, "up1", x3) + x2
    h = L.up_tconv(p, "up2", h) + x1
    h = L.up_tconv(p, "up3", h) + x0
    return L.classifier(p, "classifier", h, 0, 1)


# =============================================================================
# BNNL / BNNMC -- reference model.py:569-619
# =============================================================================


@dataclasses.dataclass(frozen=True)
class BNNCfg:
    variant: str = "L"  # "L" or "MC"
    num_classes: int = 4


def bnn_registry(cfg: BNNCfg) -> L.Registry:
    r = L.Registry()
    if cfg.variant == "L":
        r.conv("conv1", 3, 8, 8)
        r.conv("conv2", 8, 16, 8)
        r.conv("conv3", 16, 16, 8)
        r.conv("fc", 16, 512, 1)
        r.conv("classifier", 512, cfg.num_classes, 1)
    else:
        r.conv("conv1", 3, 8, 5)
        r.conv("conv2", 8, 16, 3)
        r.conv("conv3", 16, 16, 3)
        r.conv("classifier", 16, cfg.num_classes, 3)
    return r


def bnn_apply(cfg: BNNCfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """conv -> Dropout2d(0.25) -> max pool -> ReLU, three times (L: 8x8
    kernels, padding 4/3/3, then the 1x1 ``fc`` with element dropout 0.5
    and a 1x1 classifier; MC: 5/3/3 kernels, padding 1, then a 3x3
    classifier)."""
    def block(name, y, padding, pool):
        y = L.dropout2d(L.conv(p, name, y, padding=padding), name)
        return nn.relu(nn.max_pool(y, pool, 2))

    if cfg.variant == "L":
        y = block("conv1", x, 4, 4)
        y = block("conv2", y, 3, 4)
        y = block("conv3", y, 3, 4)
        y = L.dropout(L.conv(p, "fc", y), "fc")
        return L.conv(p, "classifier", nn.relu(y))
    y = block("conv1", x, 1, 4)
    y = block("conv2", y, 1, 4)
    y = block("conv3", y, 1, 2)
    return L.conv(p, "classifier", y)


def bnn_dropout_sites(cfg: BNNCfg):
    """{site: (channels, p)}: Dropout2d(0.25) after each conv; BNN L's
    ``fc`` drops elements at 0.5 (``_ELEMENT_SITES``)."""
    sites = {"conv1": (8, 0.25), "conv2": (16, 0.25), "conv3": (16, 0.25)}
    if cfg.variant == "L":
        sites["fc"] = (512, 0.5)
    return sites


def _bnn_l_fc_hw(h: int, w: int) -> Tuple[int, int]:
    """BNN L's ``fc`` activation (H, W) for an (h, w) input: each of the
    three blocks is an 8x8 conv (padding 4, then 3) and a 4x4/2 pool."""
    def block(n, pad):
        return (n + 2 * pad - 8 + 1 - 4) // 2 + 1

    return block(block(block(h, 4), 3), 3), block(block(block(w, 4), 3), 3)


# =============================================================================
# Standalone Classifier head (classVal.py:61) and DownSampler (classVal.py:60)
# =============================================================================


@dataclasses.dataclass(frozen=True)
class ClassifierCfg:
    in_planes: int = 64
    num_classes: int = 4
    pool_size: int = 4
    kernel_size: int = 1


def classifier_registry(cfg: ClassifierCfg) -> L.Registry:
    r = L.Registry()
    L.classifier_def(r, "", cfg.in_planes, cfg.num_classes, cfg.kernel_size)
    return r


def classifier_apply(cfg: ClassifierCfg, p: Params, x: torch.Tensor):
    return L.classifier(p, "", x, cfg.pool_size, cfg.kernel_size)


def downsampler_standalone_registry(cfg: DownSamplerCfg) -> L.Registry:
    r = L.Registry()
    downsampler_registry(cfg, r, "")
    return r


def downsampler_standalone_apply(cfg: DownSamplerCfg, p: Params, x):
    """The encoder's feature tuple (f4, f3, f2, f1, f0), not one tensor."""
    return downsampler_apply(cfg, p, x, "")


# =============================================================================
# Generic model handle
# =============================================================================

def pb_fcn_2_dropout_sites(cfg: PBFCN2Cfg):
    """{site: (channels, p)}: the classification head's Dropout2d(0.5)."""
    if not cfg.classify:
        return {}
    return {"classifier": (cfg.planes * 2 ** (cfg.depth - 1), 0.5)}


def label_prop_dropout_sites(cfg: LabelPropCfg):
    """{site: (channels, p)} in the JAX package's key order; none at
    dropout 0."""
    if cfg.dropout <= 0:
        return {}
    pl = cfg.planes
    widths = (pl // 4, pl // 2, pl // 2, pl, pl * 2, pl * 2, pl)
    return {site: (c, cfg.dropout)
            for site, c in zip(LP_DROPOUT_SITES, widths)}


def _no_dropout_sites(cfg):
    return {}


# family: (config, registry, apply, dropout sites)
_FAMILIES = {
    "downsampler": (DownSamplerCfg, downsampler_standalone_registry,
                    downsampler_standalone_apply, _no_dropout_sites),
    "robo_unet": (RoboUNetCfg, robo_unet_registry, robo_unet_apply,
                  _no_dropout_sites),
    "pb_fcn": (PBFCNCfg, pb_fcn_registry, pb_fcn_apply, _no_dropout_sites),
    "pb_fcn_2": (PBFCN2Cfg, pb_fcn_2_registry, pb_fcn_2_apply,
                 pb_fcn_2_dropout_sites),
    "fcn": (FCNCfg, fcn_registry, fcn_apply, _no_dropout_sites),
    "label_prop": (LabelPropCfg, label_prop_registry, label_prop_apply,
                   label_prop_dropout_sites),
    "bnn": (BNNCfg, bnn_registry, bnn_apply, bnn_dropout_sites),
    "classifier": (ClassifierCfg, classifier_registry, classifier_apply,
                   _no_dropout_sites),
}

# family: {site: the site's activation (H, W) from the input's}, for the
# dropout sites that drop elements (nn.Dropout), whose keep masks have the
# activation's shape; every other site is Dropout2d's, (N, 1, 1, C)
_ELEMENT_SITES = {"bnn": {"fc": _bnn_l_fc_hw}}


class Model(L.RegistryModule):
    """A zoo architecture with its parameters (registry-named state_dict)."""

    def __init__(self, family: str, cfg, params: Params) -> None:
        super().__init__(_FAMILIES[family][1](cfg), params)
        self.family = family
        self.cfg = cfg

    @property
    def registry(self) -> L.Registry:
        return _FAMILIES[self.family][1](self.cfg)

    @property
    def param_order(self):
        return self.registry.order

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        return _FAMILIES[self.family][2](self.cfg, self.flat(), x)

    @property
    def dropout_sites(self):
        """{site: (channels, p)} of the train-mode forward's dropouts."""
        return _FAMILIES[self.family][3](self.cfg)

    def draw_dropout(self, gen: torch.Generator, n: int,
                     hw: Optional[Tuple[int, int]] = None
                     ) -> Optional[Mapping[str, torch.Tensor]]:
        """The keep masks of a train-mode forward of ``n`` samples of
        (H, W) ``hw``, one bool mask a dropout site drawn from ``gen`` in
        site order (on the generator's device): (n, 1, 1, C) at a
        Dropout2d site, the activation's shape at an element-dropout site
        (BNN L's ``fc``, which needs ``hw``); None for a family without
        dropout."""
        sites = self.dropout_sites
        if not sites:
            return None
        element = _ELEMENT_SITES.get(self.family, {})
        out = {}
        for site, (c, p) in sites.items():
            if site in element:
                if hw is None:
                    raise ValueError(f"dropout site {site!r} drops elements: "
                                     "its mask needs the input's (H, W)")
                shape = (n, *element[site](*hw), c)
            else:
                shape = (n, 1, 1, c)
            out[site] = nn.draw_keep(gen, shape, p)
        return out

    def apply(self, params: Params, x: torch.Tensor, *, train: bool = False,
              dropout: Union[None, torch.Generator,
                             Mapping[str, torch.Tensor]] = None):
        """The forward with the given flat params (the train step's
        tensors, not the module's own): logits, or (logits, mut) with the
        new BN running statistics when ``train``, BN by the batch
        statistics (padded samples left out under
        ``layers.bn_stats_mask``). ``dropout``: the keep masks of the
        train-mode forward (``draw_dropout``'s dict), or a generator to
        draw them from; a family with dropout sites raises ValueError in
        train mode without them. Each site drops at its rate in
        ``dropout_sites``, the rate its mask was drawn at."""
        fn = _FAMILIES[self.family][2]
        if not train:
            return fn(self.cfg, params, x)
        if isinstance(dropout, torch.Generator):
            dropout = self.draw_dropout(dropout, x.shape[0],
                                        tuple(x.shape[1:3]))
        sites = self.dropout_sites
        missing = [s for s in sites if dropout is None or s not in dropout]
        if missing:
            raise ValueError(f"train mode needs the keep masks of dropout "
                             f"sites {missing}")
        with L.train_mode({s: (dropout[s], p)
                           for s, (_, p) in sites.items()}) as mut:
            return fn(self.cfg, params, x), mut


def make(family: str, *, device: DeviceLike = None,
         generator: Optional[torch.Generator] = None, **kwargs) -> Model:
    """Build ``family`` with PyTorch-default initial weights drawn from
    ``generator`` (seed 0 when omitted), on ``device`` (``cuda`` unless the
    caller passes another)."""
    dev = resolve_device(device)
    cfg = _FAMILIES[family][0](**kwargs)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params = _FAMILIES[family][1](cfg).init(gen)
    return Model(family, cfg, params).to(dev)
