"""Structured channel pruning with exact compaction (the JAX package's
ops/slim.py).

Whole channels are scored, zeroed as structured masks (the ``masks`` format
of ops/pruning.py, which the masked-gradient finetune consumes), and then
compacted: the dead channels are removed, so that every width-driven
consumer (the zoo apply, the packed and chain serving graphs, the net.cfg
export and the native engine) runs a smaller network.

A pruned channel is zeroed after its BatchNorm (kernel out-slice, bias, BN
gamma and beta), so its activation is exactly 0 in train and eval mode, and
removing it with every consumer's in-slice is an exact rewrite up to float
reassociation. Channels coupled by additive skips form one group; concat
(``--v2``) and channel-slice (LabelProp) consumers take in-axis offsets.

Group and parameter names are the registry's, as in the JAX package; only
the layouts differ. A conv kernel is ``(out, in, kh, kw)`` and a transposed
conv's ``(in, out, kh, kw)``: :func:`channel_axes` gives each kernel's out
and in axis from its registry ``kind``, and :func:`channel_groups` attaches
the kinds to every slice, so no group builder names an axis. Scores are
taken over each kernel in the JAX package's layout, whose summation order
they then share to the bit, so that both packages prune the same channels.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from robocupvision_tpu_torch.export.torch_io import to_jax_layout

Params = Mapping[str, "torch.Tensor | np.ndarray"]


def channel_axes(kind: str) -> Tuple[int, int]:
    """(out axis, in axis) of a kernel of registry ``kind`` in the port's
    layout: conv (out, in, kh, kw), transposed conv (in, out, kh, kw)."""
    if kind == "conv_w":
        return 0, 1
    if kind == "tconv_w":
        return 1, 0
    raise ValueError(f"no channel axes for a {kind!r} tensor")


@dataclasses.dataclass(frozen=True)
class OutSlice:
    """One producer of a group's channels: ``conv`` names a conv or tconv
    kernel, ``start`` the offset of the group's channels in its out axis
    (non-zero where a tensor's outputs belong to several groups, as
    LabelProp's upConv3, whose first ``pre`` channels alias the
    slice-add). ``kind``: the kernel's registry kind, which
    :func:`channel_groups` fills in."""

    conv: str
    bias: Optional[str] = None
    bn: Optional[str] = None  # bn prefix: <bn>.weight/.bias/.running_*
    start: int = 0
    kind: Optional[str] = None

    @property
    def axis(self) -> int:
        return channel_axes(self.kind)[0]


@dataclasses.dataclass(frozen=True)
class InSlice:
    """One consumer: ``conv``'s in axis at ``start``."""

    conv: str
    start: int = 0
    kind: Optional[str] = None

    @property
    def axis(self) -> int:
        return channel_axes(self.kind)[1]


@dataclasses.dataclass(frozen=True)
class Group:
    """A set of channels that must be pruned together (skip-add coupling)."""

    size: int
    outs: Tuple[OutSlice, ...]
    ins: Tuple[InSlice, ...]


def _block(name: str, start: int = 0) -> OutSlice:
    """OutSlice for a conv_block / conv_pool_simple style block
    (``<name>.conv`` + ``<name>.bn``, models/layers.py)."""
    return OutSlice(conv=f"{name}.conv.weight", bias=f"{name}.conv.bias",
                    bn=f"{name}.bn", start=start)


# ---------------------------------------------------------------------------
# group builders (one a zoo family)
# ---------------------------------------------------------------------------


def _robo_unet_groups(cfg, extra_belly_consumer: Optional[str] = None,
                      level0_convs: Optional[int] = None) -> List[Group]:
    """Channel groups of zoo.robo_unet (reference model.py:461-536): the
    flagship (additive skips), ``--v2`` (concat skips: consumers see
    [up | skip] at in-axis offsets), ``--UNet`` (max pools keep widths),
    any levels and belly. ``extra_belly_consumer``: PB_FCN_2's
    classification head, which reads downs[-1] (model.py:449)."""
    D = cfg.eff_depth
    pl = cfg.planes

    def n_convs(levels: int, do_pool: bool) -> int:
        # as layers.level_down_def (reference LevelDown model.py:379-401)
        if cfg.pool and do_pool:
            levels -= 1
        return max(levels, 1)

    lvl_n = [level0_convs if level0_convs is not None
             else n_convs(cfg.levels - 1, False)] + \
        [n_convs(cfg.levels, True) for _ in range(D - 1)]
    lvl_w = [pl * 2 ** i for i in range(D)]

    def lvl_conv(lvl: int, i: int) -> str:
        return f"downPart.Level{lvl}.layers.Conv{i}"

    def up_out(j: int) -> OutSlice:
        return OutSlice(conv=f"upPart.Up{j}.conv.weight",
                        bias=f"upPart.Up{j}.conv.bias", bn=f"upPart.Up{j}.bn")

    def after_add_consumer(j: int) -> str:
        # the (up_j + skip) / concat output feeds Up_{j+1}, or the head
        if j < D - 2:
            return f"upPart.Up{j + 1}.conv.weight"
        return "segmenter.layers.Class.weight"

    groups: List[Group] = []

    # intra-level chains (one consumer, no skip)
    for lvl in range(D):
        for i in range(lvl_n[lvl] - 1):
            groups.append(Group(lvl_w[lvl], (_block(lvl_conv(lvl, i)),),
                                (InSlice(lvl_conv(lvl, i + 1) + ".conv.weight"),)))

    # level outputs, skip-coupled for lvl <= D-2. Additive skips need the
    # joint group; v2's concat keeps one set too, because the packed
    # graph's split-weight concat splits the consumer's kernel at cin // 2
    for lvl in range(D - 1):
        j = D - 2 - lvl
        ins = [InSlice(lvl_conv(lvl + 1, 0) + ".conv.weight"),
               InSlice(after_add_consumer(j))]
        if cfg.v2:
            # the concat consumer sees [up | skip]: the skip's channels
            # start after the up output's
            ins.append(InSlice(after_add_consumer(j), start=lvl_w[lvl]))
        groups.append(Group(
            lvl_w[lvl],
            (_block(lvl_conv(lvl, lvl_n[lvl] - 1)), up_out(j)),
            tuple(ins)))

    # deepest level output -> belly (or straight into the up path)
    deep_out = _block(lvl_conv(D - 1, lvl_n[D - 1] - 1))
    if cfg.belly_size > 0:
        groups.append(Group(lvl_w[D - 1], (deep_out,),
                            (InSlice("PB.PB_1.layers.Conv0.conv.weight"),)))
        nb1 = max(cfg.belly_size - 1, 1)
        for i in range(nb1 - 1):
            groups.append(Group(
                cfg.belly_planes, (_block(f"PB.PB_1.layers.Conv{i}"),),
                (InSlice(f"PB.PB_1.layers.Conv{i + 1}.conv.weight"),)))
        groups.append(Group(cfg.belly_planes,
                            (_block(f"PB.PB_1.layers.Conv{nb1 - 1}"),),
                            (InSlice("PB.PB_2.layers.Conv0.conv.weight"),)))
        belly_ins = [InSlice("upPart.Up0.conv.weight")]
        if extra_belly_consumer:
            belly_ins.append(InSlice(extra_belly_consumer))
        groups.append(Group(lvl_w[D - 1], (_block("PB.PB_2.layers.Conv0"),),
                            tuple(belly_ins)))
    else:
        deep_ins = [InSlice("upPart.Up0.conv.weight")]
        if extra_belly_consumer:
            deep_ins.append(InSlice(extra_belly_consumer))
        groups.append(Group(lvl_w[D - 1], (deep_out,), tuple(deep_ins)))

    return groups


def _pb_fcn_2_groups(cfg) -> List[Group]:
    """PB_FCN_2 (reference model.py:416-459): the flagship ROBO-UNet plan
    plus the classification head reading downs[-1]."""
    from robocupvision_tpu_torch.models.zoo import RoboUNetCfg

    rcfg = RoboUNetCfg(planes=cfg.planes, num_classes=cfg.num_classes,
                       depth=cfg.depth, levels=cfg.levels,
                       belly_size=cfg.belly_size,
                       belly_planes=cfg.belly_planes)
    # pb_fcn_2_registry gives Level0 ONE conv at any cfg.levels
    return _robo_unet_groups(
        rcfg, extra_belly_consumer="classifier.layers.Class.weight",
        level0_convs=1)


def _cps_out(name: str, start: int = 0) -> OutSlice:
    """conv_pool_simple: one conv (no bias) + bn (models/layers.py)."""
    return OutSlice(conv=f"{name}.conv.weight", bias=None,
                    bn=f"{name}.bn", start=start)


def _label_prop_groups(cfg) -> List[Group]:
    """LabelProp (reference model.py:538-567). Additive skips couple
    down2 + upConv1 and down1 + upConv2; the channel-slice skip
    ``h[:, :pre] += top`` (model.py:565) couples ``pre`` with the first
    ``pre`` channels of upConv3's output, whose other channels form their
    own group (read only by the classifier)."""
    pl = cfg.planes
    pre, half = pl // 4, pl // 2

    def up(name, start=0):
        return OutSlice(conv=f"{name}.conv.weight", bias=f"{name}.conv.bias",
                        bn=f"{name}.bn", start=start)

    return [
        Group(pre, (_cps_out("pre"), up("upConv3")),
              (InSlice("down1.conv.weight"), InSlice("classifier.weight"))),
        Group(half - pre, (up("upConv3", start=pre),),
              (InSlice("classifier.weight", start=pre),)),
        Group(half, (_cps_out("down1"), up("upConv2")),
              (InSlice("down2.conv.weight"), InSlice("upConv3.conv.weight"))),
        Group(half, (_cps_out("down2"), up("upConv1")),
              (InSlice("down3.conv.weight"), InSlice("upConv2.conv.weight"))),
        Group(pl, (_cps_out("down3"),), (InSlice("conv1.conv.weight"),)),
        Group(pl * 2, (_cps_out("conv1"),), (InSlice("conv2.conv.weight"),)),
        Group(pl * 2, (_cps_out("conv2"),), (InSlice("conv3.conv.weight"),)),
        Group(pl, (_cps_out("conv3"),), (InSlice("upConv1.conv.weight"),)),
    ]


def _pb_fcn_groups(cfg) -> List[Group]:
    """PB_FCN over the DownSampler encoder (reference model.py:201-309):
    each ConvPool has an internal conv1 -> pool set and a post-BN output;
    the up path's additive skips couple encoder outputs with up-tconv
    outputs. Both heads read widths, so one slim dict serves the classify
    and the segment graphs."""
    p = cfg.planes
    F = "FCN."

    def cp_groups(name: str, cout: int, nxt: List[InSlice]) -> List[Group]:
        # ConvPool: conv1(d2) -> relu -> pool(s2) -> bn -> relu
        return [
            Group(cout, (OutSlice(conv=f"{F}{name}.conv1.weight"),),
                  (InSlice(f"{F}{name}.pool.weight"),)),
            Group(cout, (OutSlice(conv=f"{F}{name}.pool.weight",
                                  bn=f"{F}{name}.bn"),), tuple(nxt)),
        ]

    def up(name):
        return OutSlice(conv=f"{name}.conv.weight", bias=f"{name}.conv.bias",
                        bn=f"{name}.bn")

    g: List[Group] = []
    last_up = "up4" if cfg.no_scale else "up3"
    # conv0 + last up (skip add) -> conv1 + segmenter
    g.append(Group(p // 4, (_cps_out(F + "conv0"), up(last_up)),
                   (InSlice(F + "conv1.conv.weight"),
                    InSlice("segmenter.classifier.weight"))))
    if cfg.no_scale:
        # f1 = conv1 + up3; f2 = conv2 + up2; f3 = conv_ext + up1
        g.append(Group(p // 2, (_cps_out(F + "conv1"), up("up3")),
                       (InSlice(F + "conv2.conv1.weight"),
                        InSlice("up4.conv.weight"))))
        g += cp_groups("conv2", p, [InSlice(F + "conv_ext.conv1.weight"),
                                    InSlice("up3.conv.weight")])
        g[-1] = Group(g[-1].size, g[-1].outs + (up("up2"),), g[-1].ins)
        g += cp_groups("conv_ext", p, [InSlice(F + "conv3.conv1.weight"),
                                       InSlice("up2.conv.weight")])
        g[-1] = Group(g[-1].size, g[-1].outs + (up("up1"),), g[-1].ins)
    else:
        g.append(Group(p // 2, (_cps_out(F + "conv1"), up("up2")),
                       (InSlice(F + "conv2.conv1.weight"),
                        InSlice("up3.conv.weight"))))
        g += cp_groups("conv2", p, [InSlice(F + "conv3.conv1.weight"),
                                    InSlice("up2.conv.weight")])
        g[-1] = Group(g[-1].size, g[-1].outs + (up("up1"),), g[-1].ins)
    # deep chain conv3..conv8: conv8's output feeds up1 + the classifier
    g += cp_groups("conv3", p * 2, [InSlice(F + "conv4.conv.weight")])
    for a, b, w in (("conv4", "conv5", p * 4), ("conv5", "conv6", p * 4),
                    ("conv6", "conv7", p * 4), ("conv7", "conv8", p * 4)):
        g.append(Group(w, (_cps_out(F + a),),
                       (InSlice(f"{F}{b}.conv.weight"),)))
    g.append(Group(p * 2, (_cps_out(F + "conv8"),),
                   (InSlice("up1.conv.weight"),
                    InSlice("classifier.classifier.weight"))))
    return g


def _fcn_groups(cfg) -> List[Group]:
    """FCN baseline (reference model.py:235-254, 311-330)."""
    p = cfg.planes
    out = p // 2
    F = "FCN."

    def up(name):
        return OutSlice(conv=f"{name}.conv.weight", bias=f"{name}.conv.bias",
                        bn=f"{name}.bn")

    def cpd_groups(name: str, cout: int, nxt: List[InSlice]) -> List[Group]:
        # ConvPoolDouble: conv1 -> conv2 -> pool -> bn
        return [
            Group(cout, (OutSlice(conv=f"{F}{name}.conv1.weight"),),
                  (InSlice(f"{F}{name}.conv2.weight"),)),
            Group(cout, (OutSlice(conv=f"{F}{name}.conv2.weight"),),
                  (InSlice(f"{F}{name}.pool.weight"),)),
            Group(cout, (OutSlice(conv=f"{F}{name}.pool.weight",
                                  bn=f"{F}{name}.bn"),), tuple(nxt)),
        ]

    g: List[Group] = [
        Group(out, (_cps_out(F + "conv0"),),
              (InSlice(F + "conv0_1.conv.weight"),)),
        # x0 = conv0_1's output, skip-added with up3
        Group(out, (_cps_out(F + "conv0_1"), up("up3")),
              (InSlice(F + "conv1.conv.weight"),
               InSlice("classifier.classifier.weight"))),
        # x1 = conv1's output, skip-added with up2
        Group(out, (_cps_out(F + "conv1"), up("up2")),
              (InSlice(F + "conv2.conv1.weight"), InSlice("up3.conv.weight"))),
    ]
    # x2 = conv2's output + up1
    g += cpd_groups("conv2", p, [InSlice(F + "conv3.conv1.weight"),
                                 InSlice("up2.conv.weight")])
    g[-1] = Group(g[-1].size, g[-1].outs + (up("up1"),), g[-1].ins)
    g += cpd_groups("conv3", p * 2, [InSlice(F + "conv4.conv.weight")])
    g.append(Group(p * 4, (_cps_out(F + "conv4"),),
                   (InSlice(F + "conv5.conv.weight"),)))
    g.append(Group(p * 2, (_cps_out(F + "conv5"),),
                   (InSlice("up1.conv.weight"),)))
    return g


_BUILDERS = {"robo_unet": _robo_unet_groups, "pb_fcn_2": _pb_fcn_2_groups,
             "label_prop": _label_prop_groups, "pb_fcn": _pb_fcn_groups,
             "fcn": _fcn_groups}


def channel_groups(model) -> List[Group]:
    """Channel-coupling groups of a zoo.Model, each slice given its
    kernel's registry kind. Every hidden channel of the network belongs to
    exactly one group; the class heads' outputs are never pruned."""
    if model.family not in _BUILDERS:
        raise ValueError(f"no structured-pruning groups for family "
                         f"{model.family}")
    specs = model.registry.specs

    def kinded(s):
        return dataclasses.replace(s, kind=specs[s.conv].kind)

    return [Group(g.size, tuple(kinded(o) for o in g.outs),
                  tuple(kinded(i) for i in g.ins))
            for g in _BUILDERS[model.family](model.cfg)]


# ---------------------------------------------------------------------------
# scoring / pruning / compaction
# ---------------------------------------------------------------------------


def _np(v) -> np.ndarray:
    return v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _sl(arr: np.ndarray, axis: int, start: int, size: int) -> np.ndarray:
    """``arr``'s [start, start + size) along ``axis`` (a view)."""
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(start, start + size)
    return arr[tuple(idx)]


def channel_scores(params: Params, g: Group) -> np.ndarray:
    """Per-channel saliency: mean |kernel out-slice| x |BN gamma|, summed
    over the group's producers (network slimming: BN gamma gates the
    channel's contribution)."""
    s = np.zeros(g.size, np.float64)
    for o in g.outs:
        # the out-slice in the JAX package's layout (HWIO), which it scores
        sl = to_jax_layout(_np(params[o.conv]), o.kind)[
            ..., o.start:o.start + g.size]
        m = np.abs(sl).mean(axis=tuple(range(sl.ndim - 1)))
        if o.bn is not None:
            m = m * np.abs(_np(params[o.bn + ".weight"])
                           [o.start:o.start + g.size])
        s += m
    return s


def _to_torch(arrays: Dict[str, np.ndarray], order) -> "OrderedDict[str, torch.Tensor]":
    return OrderedDict((k, torch.from_numpy(np.ascontiguousarray(arrays[k])))
                       for k in order)


def prune_channels(params: Params, groups: List[Group], ratio: float,
                   min_keep: int = 1, round_to: int = 1,
                   verbose: bool = True
                   ) -> Tuple["OrderedDict[str, torch.Tensor]",
                              Dict[str, torch.Tensor]]:
    """Structurally zero the lowest-scoring ``ratio`` of each group's
    channels.

    Returns (new params, masks), CPU tensors in the port's layout: the
    masks are full-shape booleans, True at the pruned positions, the format
    of ops/pruning.py that the masked-gradient finetune applies. Kept
    counts are at least ``min_keep`` and rounded up to a multiple of
    ``round_to``."""
    new = {k: np.array(_np(v), np.float32, copy=True)
           for k, v in params.items()}
    masks: Dict[str, np.ndarray] = {}

    def mask_of(name: str) -> np.ndarray:
        if name not in masks:
            masks[name] = np.zeros(new[name].shape, bool)
        return masks[name]

    total = kept_total = 0
    for g in groups:
        n_keep = g.size - int(g.size * ratio)
        n_keep = max(n_keep, min_keep, 1)
        if round_to > 1:
            n_keep = min(-(-n_keep // round_to) * round_to, g.size)
        order = np.argsort(channel_scores(params, g), kind="stable")
        pruned_idx = order[: g.size - n_keep]
        total += g.size
        kept_total += n_keep
        if pruned_idx.size == 0:
            continue
        for o in g.outs:
            pos = o.start + pruned_idx
            idx = [slice(None)] * new[o.conv].ndim
            idx[o.axis] = pos
            new[o.conv][tuple(idx)] = 0.0
            mask_of(o.conv)[tuple(idx)] = True
            if o.bias is not None and o.bias in new:
                new[o.bias][pos] = 0.0
                mask_of(o.bias)[pos] = True
            if o.bn is not None:
                for suffix in (".weight", ".bias"):
                    new[o.bn + suffix][pos] = 0.0
                    mask_of(o.bn + suffix)[pos] = True
    if verbose:
        print("Structured prune: kept %d of %d channels (%.1f%% pruned)"
              % (kept_total, total, 100.0 * (1 - kept_total / max(total, 1))))
    return (_to_torch(new, params),
            {k: torch.from_numpy(m) for k, m in masks.items()})


def _others(arr: np.ndarray, axis: int) -> Tuple[int, ...]:
    return tuple(a for a in range(arr.ndim) if a != axis % arr.ndim)


def _group_dead(params: Dict[str, np.ndarray], g: Group) -> np.ndarray:
    """The channels of ``g`` that are exactly zero at every producer
    (kernel out-slice, bias, BN gamma and beta): the compactable set."""
    dead = np.ones(g.size, bool)
    for o in g.outs:
        w = _sl(params[o.conv], o.axis, o.start, g.size)
        d = ~np.any(w, axis=_others(w, o.axis))
        if o.bias is not None and o.bias in params:
            d &= params[o.bias][o.start:o.start + g.size] == 0
        if o.bn is not None:
            d &= params[o.bn + ".weight"][o.start:o.start + g.size] == 0
            d &= params[o.bn + ".bias"][o.start:o.start + g.size] == 0
        dead &= d
    return dead


def compact(model, params: Params, min_keep: int = 1
            ) -> Tuple["OrderedDict[str, torch.Tensor]", Dict[str, int]]:
    """Remove the structurally dead channels: an exact rewrite up to float
    reassociation (the zoo apply of the slim dict matches the masked
    dict's). Returns (slim params as CPU tensors in the port's layout, the
    kept count of each group).

    Works on any params whose dead channels keep the post-BN-zero
    invariant that :func:`prune_channels` establishes (and the
    masked-gradient finetune preserves)."""
    groups = channel_groups(model)
    np_params = {k: _np(v) for k, v in params.items()}

    out_keep: Dict[str, np.ndarray] = {}   # kernel -> out-axis keep vector
    in_keep: Dict[str, np.ndarray] = {}    # kernel -> in-axis keep vector
    vec_keep: Dict[str, np.ndarray] = {}   # bias/bn vector -> keep vector
    axes: Dict[str, Tuple[int, int]] = {}  # kernel -> (out axis, in axis)
    kept: Dict[str, int] = {}

    def keep_vec(store, name, axis_len):
        if name not in store:
            store[name] = np.ones(axis_len, bool)
        return store[name]

    for gi, g in enumerate(groups):
        dead = _group_dead(np_params, g)
        if dead.sum() > g.size - min_keep:  # keep at least min_keep
            alive_order = np.nonzero(dead)[0]
            for idx in alive_order[: int(dead.sum()) - (g.size - min_keep)]:
                dead[idx] = False
        kept[f"group{gi}"] = int(g.size - dead.sum())
        if not dead.any():
            continue
        for o in g.outs:
            axes[o.conv] = channel_axes(o.kind)
            kv = keep_vec(out_keep, o.conv, np_params[o.conv].shape[o.axis])
            kv[o.start:o.start + g.size] &= ~dead
            if o.bias is not None and o.bias in np_params:
                bv = keep_vec(vec_keep, o.bias, np_params[o.bias].shape[0])
                bv[o.start:o.start + g.size] &= ~dead
            if o.bn is not None:
                for suffix in (".weight", ".bias", ".running_mean",
                               ".running_var"):
                    n = o.bn + suffix
                    bv = keep_vec(vec_keep, n, np_params[n].shape[0])
                    bv[o.start:o.start + g.size] &= ~dead
        for i in g.ins:
            axes[i.conv] = channel_axes(i.kind)
            kv = keep_vec(in_keep, i.conv, np_params[i.conv].shape[i.axis])
            kv[i.start:i.start + g.size] &= ~dead

    slim: Dict[str, np.ndarray] = {}
    for name, a in np_params.items():
        if name in out_keep:
            a = np.compress(out_keep[name], a, axis=axes[name][0])
        if name in in_keep:
            a = np.compress(in_keep[name], a, axis=axes[name][1])
        if name in vec_keep:
            a = a[vec_keep[name]]
        slim[name] = a
    return _to_torch(slim, params), kept


def param_count(params: Params) -> int:
    return int(sum(np.size(_np(v)) for v in params.values()))


def validate_groups(model, params: Params) -> None:
    """Check a family's groups against the params' shapes: every named
    tensor exists, every slice is in range, no two groups cover the same
    out channels of a tensor, and every out axis a group touches is
    covered whole. Raises ValueError on a violation."""
    def need(ok, what):
        if not ok:
            raise ValueError(what)

    covered: Dict[str, np.ndarray] = {}
    for g in channel_groups(model):
        need(g.outs and g.size > 0, f"empty group {g}")
        for o in g.outs:
            w = _np(params[o.conv])
            need(w.ndim == 4, f"{o.conv}: shape {w.shape}")
            n_out = w.shape[o.axis]
            need(o.start + g.size <= n_out, f"{o}: {g.size} > {w.shape}")
            cov = covered.setdefault(o.conv, np.zeros(n_out, bool))
            seg = cov[o.start:o.start + g.size]
            need(not seg.any(), f"overlapping out groups on {o.conv}")
            seg[:] = True
            if o.bias is not None and o.bias in params:
                need(_np(params[o.bias]).shape[0] >= o.start + g.size,
                     f"{o.bias} shorter than its group")
            if o.bn is not None:
                need(_np(params[o.bn + ".weight"]).shape[0]
                     >= o.start + g.size, f"{o.bn} shorter than its group")
        for i in g.ins:
            w = _np(params[i.conv])
            need(w.ndim == 4, f"{i.conv}: shape {w.shape}")
            need(i.start + g.size <= w.shape[i.axis],
                 f"{i}: {g.size} > {w.shape}")
    for name, cov in covered.items():
        need(cov.all(), f"{name}: channels {np.nonzero(~cov)[0]} uncovered")


# =============================================================================
# Belly-only pruning (tools/structured_prune.py --keep)
# =============================================================================
# Removes channels from ROBO-UNet's bottleneck only (reference
# model.py:480-483: a plain conv chain without skips, so each layer keeps
# its own channel set).


def _belly_layer_names(cfg):
    """The PB_1 conv chain's names (Conv0 enters the belly) and the PB_2
    conv that leaves it (reference model.py:480-487)."""
    n_pb1 = max(cfg.belly_size - 1, 1)
    pb1 = [f"PB.PB_1.layers.Conv{i}" for i in range(n_pb1)]
    return pb1, "PB.PB_2.layers.Conv0"


def belly_channel_scores(params: Params, cfg) -> np.ndarray:
    """Per-layer L1 importances, one row a PB_1 conv: row i ranks conv
    i's output channels by its own filter norms (Li et al.). Shape
    (n_pb1, belly_planes)."""
    pb1, _ = _belly_layer_names(cfg)
    return np.stack([
        np.abs(to_jax_layout(_np(params[n + ".conv.weight"]), "conv_w"))
        .sum(axis=(0, 1, 2)) for n in pb1])


def shrink_belly(params: Params, cfg, keep: int):
    """Remove the lowest-importance belly channels, each layer keeping its
    own channel set.

    Returns (new params as CPU tensors, new cfg with belly_planes=keep,
    kept index rows: shape (n_pb1, keep), row i ascending, the channels
    conv i keeps). The result is a standard ROBO-UNet of that cfg."""
    if cfg.belly_size <= 0:
        raise ValueError("model has no belly (belly_size == 0)")
    if not (0 < keep <= cfg.belly_planes):
        raise ValueError(f"keep={keep} out of range (1..{cfg.belly_planes})")
    scores = belly_channel_scores(params, cfg)
    kept = np.stack([np.sort(np.argsort(row)[::-1][:keep]) for row in scores])

    pb1, pb2 = _belly_layer_names(cfg)
    new = {k: _np(v) for k, v in params.items()}

    def slice_out(name, idx):  # conv out channels + bias + bn vectors
        new[name + ".conv.weight"] = new[name + ".conv.weight"][idx]
        for suffix in (".conv.bias", ".bn.weight", ".bn.bias",
                       ".bn.running_mean", ".bn.running_var"):
            key = name + suffix
            if key in new:
                new[key] = new[key][idx]

    def slice_in(name, idx):
        new[name + ".conv.weight"] = new[name + ".conv.weight"][:, idx]

    for i, name in enumerate(pb1):
        slice_out(name, kept[i])
        if i > 0:
            slice_in(name, kept[i - 1])
    slice_in(pb2, kept[-1])

    new_cfg = dataclasses.replace(cfg, belly_planes=int(keep))
    return _to_torch(new, params), new_cfg, kept
