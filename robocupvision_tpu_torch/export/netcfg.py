"""net.cfg, the darknet-style deployment graph format (the JAX package's
export/netcfg.py): writer, parser, emitters, and ``run_cfg``, a torch
interpreter that runs a cfg + weights.dat pair directly.

The reference hand-maintains these files (weights/net.cfg,
weightsVGA/net.cfg, weightsLP/net.cfg) to describe the deployed networks
for the external C++ engine: section order is the layer list, and
``[shortcut] from=N`` names the 0-based output of layer N. They are
generated here from the model configs. ``run_cfg`` checks that the written
pair describes the whole network (``deploy.verify_deployment``) and computes
the golden vectors the C++ engine replays (``cli/testDumper.py``).
Sections (those of the reference's three cfg files, and the layer types
its testDumper exercises, testDumper.py:30-55):
  [net] height width channels downscale
  [convolutional] filters size|KHxKW stride pad dilation activation hasBias
  [batchnorm] activation
  [transposedconv] filters size stride pad outpad activation
  [shortcut] from activation      (adds over the first min(C) channels)
  [concat] from
  [maxpool] size stride
  [avgpool] size stride
  [pixelshuffle] factor
  [connected] outputs             (fully connected)
  [softmax]
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from robocupvision_tpu_torch.models.layers import Registry
from robocupvision_tpu_torch.ops import nn

Section = Tuple[str, Dict[str, str]]


# ---------------------------------------------------------------------------
# writer / parser
# ---------------------------------------------------------------------------


def write_cfg(path: str, sections: List[Section]) -> None:
    lines = []
    for name, kv in sections:
        lines.append(f"[{name}]")
        for k, v in kv.items():
            lines.append(f"{k}={v}")
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def parse_cfg(path: str) -> List[Section]:
    sections: List[Section] = []
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith(("#", ";")):
                continue
            if line.startswith("[") and line.endswith("]"):
                sections.append((line[1:-1], {}))
            else:
                k, _, v = line.partition("=")
                sections[-1][1][k.strip()] = v.strip()
    return sections


# ---------------------------------------------------------------------------
# emitters
# ---------------------------------------------------------------------------


def _conv(filters, size, stride=1, pad=0, dilation=1, activation="linear",
          has_bias=0) -> Section:
    return ("convolutional", dict(filters=filters, size=size, stride=stride,
                                  pad=pad, dilation=dilation,
                                  activation=activation, hasBias=has_bias))


def _bn() -> Section:
    return ("batchnorm", {"activation": "relu"})


def _tconv(filters, size=3, stride=2, pad=1, outpad=1) -> Section:
    return ("transposedconv", dict(filters=filters, size=size, stride=stride,
                                   pad=pad, outpad=outpad, activation="linear"))


def _shortcut(frm: int) -> Section:
    return ("shortcut", {"activation": "linear", "from": frm})


def pb_fcn_sections(planes: int = 32, num_classes: int = 5,
                    no_scale: bool = False, kernel_size: int = 1) -> List[Section]:
    """PB-FCN deployment graph; the layout of weights/net.cfg (QVGA) and
    weightsVGA/net.cfg (VGA) for the default planes=32."""
    h, w = (480, 640) if no_scale else (120, 160)
    p = planes
    secs: List[Section] = [("net", dict(height=h, width=w, channels=3,
                                        downscale=4))]

    def cps(filters, stride, pad, dilation):  # ConvPoolSimple: conv+bn+relu
        secs.append(_conv(filters, 3, stride, pad, dilation))
        secs.append(_bn())

    def cp(filters):  # ConvPool: conv(d2, relu) + conv(s2) + bn + relu
        secs.append(_conv(filters, 3, 1, 2, 2, activation="relu"))
        secs.append(_conv(filters, 3, 2, 1, 1))
        secs.append(_bn())

    cps(p // 4, 1, 2, 2)          # conv0 -> skip idx 1 (its bn)
    skip0 = len(secs) - 2          # 0-based excluding [net]
    cps(p // 2, 2, 1, 1)          # conv1 -> skip idx 3
    skip1 = len(secs) - 2
    cp(p)                          # conv2 -> skip idx 6
    skip2 = len(secs) - 2
    if no_scale:
        cp(p)                      # conv_ext
        skip3 = len(secs) - 2
    cp(p * 2)                      # conv3
    for _ in range(4):             # conv4..conv7
        cps(p * 4, 1, 2, 2)
    cps(p * 2, 1, 2, 2)           # conv8

    mult = 2 if no_scale else 1
    ups = [p, p // 2 * mult, p // 4 * mult] + ([p // 4] if no_scale else [])
    skips = ([skip3, skip2, skip1, skip0] if no_scale
             else [skip2, skip1, skip0])
    for f, s in zip(ups, skips):
        secs.append(_tconv(f))
        secs.append(_bn())
        secs.append(_shortcut(s))
    secs.append(_conv(num_classes, kernel_size, 1, kernel_size // 2,
                      activation="linear", has_bias=1))
    secs.append(("softmax", {}))
    return secs


def label_prop_sections(planes: int = 32, num_classes: int = 5) -> List[Section]:
    """LabelProp deployment graph; the layout of weightsLP/net.cfg."""
    p = planes
    secs: List[Section] = [("net", dict(height=120, width=160, channels=8,
                                        downscale=4))]

    def cps(filters, stride, pad, dilation):
        secs.append(_conv(filters, 3, stride, pad, dilation))
        secs.append(_bn())

    cps(p // 4, 1, 1, 1)   # pre  -> bn at idx 1
    cps(p // 2, 2, 1, 1)   # down1 -> bn at idx 3
    cps(p // 2, 2, 1, 1)   # down2 -> bn at idx 5
    cps(p, 2, 1, 1)        # down3
    cps(p * 2, 1, 2, 2)    # conv1
    cps(p * 2, 1, 2, 2)    # conv2
    cps(p, 1, 2, 2)        # conv3
    for f, s in [(p // 2, 5), (p // 2, 3), (p // 2, 1)]:
        secs.append(_tconv(f))
        secs.append(_bn())
        secs.append(_shortcut(s))
    secs.append(_conv(num_classes, 1, 1, 0, activation="linear", has_bias=1))
    secs.append(("softmax", {}))
    return secs


def robo_unet_sections(cfg) -> List[Section]:
    """ROBO-UNet deployment graph from a zoo.RoboUNetCfg. ``pool`` (--UNet)
    writes [maxpool] + stride-1 convs per LevelDown; ``v2`` writes [concat]
    instead of [shortcut]."""
    h, w = cfg.img_shape
    secs: List[Section] = [("net", dict(height=h, width=w, channels=3,
                                        downscale=2 if cfg.no_scale else 4))]
    depth = cfg.eff_depth
    pl = cfg.planes
    skips: List[int] = []

    def conv_bn_relu(filters, stride):
        # the zoo's "Conv" block: conv(relu) then BN, written as
        # conv(act=relu) + bn(linear)
        secs.append(_conv(filters, 3, stride, 1, 1, activation="relu", has_bias=1))
        secs.append(("batchnorm", {"activation": "linear"}))

    def level(cin, cout, levels, do_pool, pool):
        # mirrors layers.level_down (reference LevelDown, model.py:379-401):
        # pool mode downsamples with MaxPool(2, 2) and drops one conv level
        if pool:
            if do_pool:
                secs.append(("maxpool", {"size": 2, "stride": 2}))
                levels -= 1
            for _ in range(max(levels, 1)):
                conv_bn_relu(cout, 1)
        else:
            conv_bn_relu(cout, 2 if do_pool else 1)
            for _ in range(max(levels, 1) - 1):
                conv_bn_relu(cout, 1)

    level(3, pl, cfg.levels - 1, False, cfg.pool)
    skips.append(len(secs) - 2)
    for i in range(depth - 1):
        n_ch = pl * 2 ** i
        level(n_ch, n_ch * 2, cfg.levels, True, cfg.pool)
        skips.append(len(secs) - 2)
    if cfg.belly_size > 0:
        level(pl * 2 ** (depth - 1), cfg.belly_planes, cfg.belly_size - 1,
              False, False)
        level(cfg.belly_planes, pl * 2 ** (depth - 1), 1, False, False)
    for i in range(depth - 1):
        n_ch = pl * 2 ** (depth - 1 - i)
        secs.append(_tconv(n_ch // 2))
        secs.append(_bn())
        src = skips[-(i + 2)]
        if cfg.v2:
            secs.append(("concat", {"from": src}))
        else:
            secs.append(_shortcut(src))
    secs.append(_conv(cfg.num_classes, cfg.class_size, 1, cfg.class_size // 2,
                      activation="linear", has_bias=1))
    secs.append(("softmax", {}))
    return secs


def apply_param_widths(secs: List[Section], reg: Registry, state,
                       skip_prefixes: Tuple[str, ...] = ()) -> List[Section]:
    """Rewrite each [convolutional]/[transposedconv] section's ``filters``
    from the kernels of ``state`` (a state_dict, torch layouts). The
    emitters derive widths from the model config; a structurally-pruned
    checkpoint carries other per-layer widths. Section order equals the
    registry's conv/tconv order less ``skip_prefixes``, the invariant the
    flat weights.dat reader depends on. A dense state returns the sections
    unchanged."""
    kernels = [(n, s.kind) for n, s in reg.specs.items()
               if s.kind in ("conv_w", "tconv_w")
               and not any(n.startswith(p) for p in skip_prefixes)]
    out: List[Section] = []
    ki = 0
    for name, kv in secs:
        if name in ("convolutional", "transposedconv"):
            if ki >= len(kernels):
                raise ValueError(
                    f"cfg has more weighted layers than the registry's "
                    f"{len(kernels)} (check skip_prefixes / emitter)")
            kname, kind = kernels[ki]
            ki += 1
            # conv (out, in, kh, kw), tconv (in, out, kh, kw)
            filters = state[kname].shape[0 if kind == "conv_w" else 1]
            kv = dict(kv, filters=int(filters))
        out.append((name, kv))
    if ki != len(kernels):
        raise ValueError(f"cfg has {ki} weighted layers, registry {len(kernels)}")
    return out


# ---------------------------------------------------------------------------
# torch interpreter over (cfg, flat weights)
# ---------------------------------------------------------------------------


class FlatReader:
    """Reads consecutive shaped slices off a flat f32 weight stream."""

    def __init__(self, flat: np.ndarray):
        self.flat = np.asarray(flat, np.float32)
        self.off = 0

    def take(self, *shape: int) -> np.ndarray:
        n = int(np.prod(shape))
        out = self.flat[self.off:self.off + n].reshape(shape)
        self.off += n
        return out

    def done(self) -> bool:
        return self.off == self.flat.size


def _pair(v: str) -> Tuple[int, int]:
    """A cfg value "A" or "AxB" as (A, A) or (A, B)."""
    a, _, b = v.partition("x")
    return int(a), int(b or a)


def run_cfg(sections: List[Section], flat_weights: np.ndarray, x,
            return_all: bool = False):
    """Run a cfg graph on the NHWC input ``x`` (a tensor, on its device, or
    an array, on the CPU) with weights read in order off the flat stream.

    Weight order per layer is paramSave/state_dict order, torch layouts:
    conv weight (O, I, kh, kw) [+ bias]; tconv weight (I, O, kh, kw) + bias
    (torch's ConvTranspose2d takes it unflipped; the JAX interpreter flips
    it into its own pre-flipped form); bn gamma, beta, mean, var; connected
    weight (O, I) + bias. Returns the final output, and with ``return_all``
    every layer's output too."""
    assert sections[0][0] == "net"
    r = FlatReader(flat_weights)
    h = torch.as_tensor(x)
    dev = h.device

    def take(*shape):
        return torch.from_numpy(np.array(r.take(*shape))).to(dev)

    outs = []
    cin = int(h.shape[-1])
    for name, kv in sections[1:]:
        kv = {k: str(v) for k, v in kv.items()}  # accept int-valued sections
        act = kv.get("activation", "linear")
        if name == "convolutional":
            co = int(kv["filters"])
            kh, kw = _pair(kv.get("size", "1"))
            w = take(co, cin, kh, kw)
            b = take(co) if int(kv.get("hasBias", 1)) else None
            h = nn.conv2d(h, w, b, stride=int(kv.get("stride", 1)),
                          padding=_pair(kv.get("pad", "0")),
                          dilation=_pair(kv.get("dilation", "1")))
            cin = co
        elif name == "transposedconv":
            co = int(kv["filters"])
            k = int(kv.get("size", 3))
            w = take(cin, co, k, k)
            b = take(co) if int(kv.get("hasBias", 1)) else None
            h = nn.conv_transpose2d(h, w, b, stride=int(kv.get("stride", 2)),
                                    padding=int(kv.get("pad", 1)),
                                    output_padding=int(kv.get("outpad", 1)))
            cin = co
        elif name == "batchnorm":
            g, bb, rm, rv = take(cin), take(cin), take(cin), take(cin)
            h = nn.batch_norm(h, g, bb, rm, rv)
        elif name == "shortcut":
            other = outs[int(kv["from"])]
            c = min(int(h.shape[-1]), int(other.shape[-1]))
            h = torch.cat([h[..., :c] + other[..., :c], h[..., c:]], dim=-1)
        elif name == "concat":
            h = torch.cat([h, outs[int(kv["from"])]], dim=-1)
            cin = int(h.shape[-1])
        elif name == "maxpool":
            h = nn.max_pool(h, int(kv.get("size", 2)), int(kv.get("stride", 2)))
        elif name == "avgpool":
            h = nn.avg_pool(h, int(kv.get("size", 2)), int(kv.get("stride", 2)))
        elif name == "pixelshuffle":
            h = nn.pixel_shuffle(h, int(kv.get("factor", 2)))
            cin = int(h.shape[-1])
        elif name == "connected":
            co = int(kv["outputs"])
            n_batch = int(h.shape[0])
            # darknet's FC flattens the whole activation in NCHW order (the
            # engine's semantics); the output is (N, 1, 1, outputs)
            flat = h.permute(0, 3, 1, 2).reshape(n_batch, -1)
            in_len = int(kv.get("inputs", flat.shape[1]))
            if in_len != flat.shape[1]:
                raise ValueError(f"[connected] inputs={in_len} != {flat.shape[1]}")
            w = take(co, in_len)
            h = nn.linear(flat, w.T, take(co)).reshape(n_batch, 1, 1, co)
            cin = co
        elif name == "softmax":
            h = nn.softmax(h, dim=-1)
        else:
            raise ValueError(f"unknown section [{name}]")
        if act == "relu":
            h = nn.relu(h)
        outs.append(h)
    return (h, outs) if return_all else h
