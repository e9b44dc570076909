"""The benchmark's own operation and byte counts, from the configurations'
layer shapes (frozen here, independent of the program's packed graphs).

- ``model_flops(config, h, w)``: the forward's FLOPs for one (h, w) image:
  two per multiply-add of every convolution and transposed convolution,
  counting only the taps that land inside the input (padding taps do no
  work). Element-wise work (BatchNorm, ReLU, skip adds) is left out, so a
  share of a peak built on it cannot read high.
- ``k2_chains(config, n, h, w)``: each K2 chain that one forward of an
  (n, h, w) batch launches, with the original convs it computes (their
  useful taps, as above: the packed kernels' structural zeros are not
  work) and the bytes it must move: its input, skips and weights read
  once, each emitted output written once.
"""

from __future__ import annotations

import dataclasses
from typing import List

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    stride: int
    pad: int
    dil: int
    h_in: int
    w_in: int
    transposed: bool = False

    @property
    def out_hw(self):
        if self.transposed:   # k3, s2, p1, output_padding 1
            return 2 * self.h_in, 2 * self.w_in
        eff = self.dil * (self.k - 1)
        return ((self.h_in + 2 * self.pad - eff - 1) // self.stride + 1,
                (self.w_in + 2 * self.pad - eff - 1) // self.stride + 1)

    def _valid(self, n_in: int, n_out: int, d: int) -> int:
        """Positions at which tap ``d`` of one axis reads the input."""
        if self.transposed:   # input i feeds output i*2 - 1 + d
            return sum(1 for i in range(n_in) if 0 <= 2 * i - 1 + d < n_out)
        off = d * self.dil - self.pad
        return sum(1 for o in range(n_out)
                   if 0 <= o * self.stride + off < n_in)

    @property
    def macs(self) -> int:
        ho, wo = self.out_hw
        taps = sum(self._valid(self.h_in, ho, dy) for dy in range(self.k)) \
            * sum(self._valid(self.w_in, wo, dx) for dx in range(self.k))
        return taps * self.cin * self.cout

    @property
    def flops(self) -> int:
        return 2 * self.macs


def _c(name, cin, cout, h, w, k=3, stride=1, pad=None, dil=1):
    pad = dil * (k // 2) if pad is None else pad
    return Conv(name, cin, cout, k, stride, pad, dil, h, w)


def robo_unet_convs(cfg: dict, h: int, w: int) -> List[Conv]:
    """The flagship ROBO_UNet's convs, in forward order."""
    if cfg.get("pool") or cfg.get("v2"):
        raise ValueError("counts hold the flagship ROBO_UNet only")
    depth = cfg["depth"] + (1 if cfg["no_scale"] else 0)
    lv, p = cfg["levels"], cfg["planes"]
    out = []
    for i in range(max(lv - 1, 1)):
        out.append(_c(f"downPart.Level0.layers.Conv{i}.conv",
                      3 if i == 0 else p, p, h, w))
    c = p
    for lvl in range(1, depth):
        out.append(_c(f"downPart.Level{lvl}.layers.Conv0.conv", c, 2 * c,
                      h, w, stride=2))
        h, w, c = out[-1].out_hw + (2 * c,)
        for i in range(1, lv):
            out.append(_c(f"downPart.Level{lvl}.layers.Conv{i}.conv", c, c,
                          h, w))
    if cfg["belly_size"] > 0:
        bp = cfg["belly_planes"]
        for i in range(cfg["belly_size"] - 1):
            out.append(_c(f"PB.PB_1.layers.Conv{i}.conv",
                          c if i == 0 else bp, bp, h, w))
        out.append(_c("PB.PB_2.layers.Conv0.conv", bp, c, h, w))
    for i in range(depth - 1):
        out.append(Conv(f"upPart.Up{i}.conv", c, c // 2, 3, 2, 1, 1, h, w,
                        transposed=True))
        h, w, c = 2 * h, 2 * w, c // 2
    k = cfg.get("class_size", 1)
    out.append(_c("segmenter.layers.Class", c, cfg["num_classes"], h, w, k=k))
    return out


def pb_fcn_convs(cfg: dict, h: int, w: int) -> List[Conv]:
    """PB_FCN's convs (segmentation mode), in forward order."""
    p = cfg["planes"]
    out = [_c("FCN.conv0.conv", 3, p // 4, h, w, dil=2)]
    out.append(_c("FCN.conv1.conv", p // 4, p // 2, h, w, stride=2))
    h, w = out[-1].out_hw
    skips = [(p // 4), (p // 2)]

    def conv_pool(name, cin, cout, h, w):
        out.append(_c(name + ".conv1", cin, cout, h, w, dil=2))
        out.append(_c(name + ".pool", cout, cout, h, w, stride=2))
        return out[-1].out_hw

    h, w = conv_pool("FCN.conv2", p // 2, p, h, w)
    skips.append(p)
    c = p
    if cfg["no_scale"]:
        h, w = conv_pool("FCN.conv_ext", p, p, h, w)
        skips.append(p)
    h, w = conv_pool("FCN.conv3", c, 2 * p, h, w)
    widths = [(2 * p, 4 * p), (4 * p, 4 * p), (4 * p, 4 * p), (4 * p, 4 * p),
              (4 * p, 2 * p)]
    for i, (ci, co) in zip(range(4, 9), widths):
        out.append(_c(f"FCN.conv{i}.conv", ci, co, h, w, dil=2))
    c = 2 * p
    for j, s in enumerate(reversed(skips)):
        out.append(Conv(f"up{j + 1}.conv", c, s, 3, 2, 1, 1, h, w,
                        transposed=True))
        h, w, c = 2 * h, 2 * w, s
    k = cfg.get("kernel_size", 1)
    out.append(_c("segmenter.classifier", c, cfg["num_classes"], h, w, k=k))
    return out


CONVS = {"robo_unet": robo_unet_convs, "pb_fcn": pb_fcn_convs}


def model_flops(config: dict, h: int, w: int) -> int:
    """Forward FLOPs of one (h, w) image of ``config``."""
    return sum(c.flops for c in CONVS[config["family"]](config["cfg"], h, w))


@dataclasses.dataclass(frozen=True)
class Chain:
    tag: str
    convs: tuple
    read_bytes: int      # input, skips, weights and per-channel vectors
    write_bytes: int     # emitted outputs

    @property
    def flops(self) -> int:
        return sum(c.flops for c in self.convs)

    def seconds(self, flops_per_s: float, bytes_per_s: float) -> float:
        """The least time the card could take: the larger of the
        operations over the peak and the bytes over the memory rate."""
        return max(self.flops / flops_per_s,
                   (self.read_bytes + self.write_bytes) / bytes_per_s)


def _act(n, c: Conv, elt, out=True):
    """Bytes of a conv's (n-image) output, or of its input."""
    hh, ww = c.out_hw if out else (c.h_in, c.w_in)
    return n * hh * ww * (c.cout if out else c.cin) * elt


def _params(convs, elt, vectors):
    return sum(c.k * c.k * c.cin * c.cout * elt + vectors * c.cout * 4
               for c in convs)


def k2_chains(config: dict, n: int, h: int, w: int) -> List[Chain]:
    """The K2 chains of one forward of an (n, h, w) batch through the
    configuration's served graph (``serve.options``: the down chain with
    the stem folded in, the deep chain, the up chain with the argmax
    head)."""
    fam, cfg = config["family"], config["cfg"]
    elt = DTYPE_BYTES[config["serve"]["dtype"]]
    labels_bytes = n * h * w * 4          # the argmax head's int32 labels
    by = {c.name: c for c in CONVS[fam](cfg, h, w)}
    if fam == "robo_unet":
        opts = config["serve"]["options"]
        if not (opts.get("pallas_fold_stem") and opts.get("pallas_deep")) \
                or cfg["levels"] not in (1, 2):
            raise ValueError("counts hold the full chain graph")
        depth = cfg["depth"] + (1 if cfg["no_scale"] else 0)
        lv = cfg["levels"]
        l0 = [by[f"downPart.Level0.layers.Conv{i}.conv"]
              for i in range(max(lv - 1, 1))]
        l1 = [by[f"downPart.Level1.layers.Conv{i}.conv"] for i in range(lv)]
        l2 = [by[f"downPart.Level2.layers.Conv{i}.conv"] for i in range(lv)]
        down = l0 + l1 + l2
        deep = [by[f"downPart.Level{depth - 1}.layers.Conv{i}.conv"]
                for i in range(1, lv)]
        deep += [by[f"PB.PB_1.layers.Conv{i}.conv"]
                 for i in range(cfg["belly_size"] - 1)]
        deep += [by["PB.PB_2.layers.Conv0.conv"]]
        up = [by[f"upPart.Up{depth - 3}.conv"],
              by[f"upPart.Up{depth - 2}.conv"], by["segmenter.layers.Class"]]
        chains = [
            Chain("down", tuple(down),
                  _act(n, down[0], elt, out=False) + _params(down, elt, 3),
                  sum(_act(n, c, elt) for c in (l0[-1], l1[-1], l2[-1]))),
            Chain("deep", tuple(deep),
                  _act(n, deep[0], elt, out=False) + _params(deep, elt, 3),
                  _act(n, deep[-1], elt)),
            Chain("up", tuple(up),
                  _act(n, up[0], elt, out=False) + _act(n, l1[-1], elt)
                  + _act(n, l0[-1], elt) + _params(up[:2], elt, 3)
                  + _params(up[2:], elt, 1),
                  labels_bytes),
        ]
        return chains
    if fam == "pb_fcn":
        if not cfg["no_scale"] or not config["serve"]["options"].get(
                "pallas_deep"):
            raise ValueError("counts hold the no_scale graph with its deep "
                             "chain")
        down = [by["FCN.conv0.conv"], by["FCN.conv1.conv"],
                by["FCN.conv2.conv1"], by["FCN.conv2.pool"],
                by["FCN.conv_ext.conv1"]]
        deep = [by[f"FCN.conv{i}.conv"] for i in range(4, 9)]
        up = [by["up3.conv"], by["up4.conv"], by["segmenter.classifier"]]
        x0, x1 = down[0], down[1]
        return [
            Chain("down", tuple(down),
                  _act(n, down[0], elt, out=False)
                  + _params(down[:2], elt, 3) + _params(down[2:3], elt, 1)
                  + _params(down[3:4], elt, 3) + _params(down[4:], elt, 1),
                  sum(_act(n, c, elt) for c in (x0, x1, down[3], down[4]))),
            Chain("deep", tuple(deep),
                  _act(n, deep[0], elt, out=False) + _params(deep, elt, 3),
                  _act(n, deep[-1], elt)),
            Chain("up", tuple(up),
                  _act(n, up[0], elt, out=False) + _act(n, x1, elt)
                  + _act(n, x0, elt) + _params(up[:2], elt, 3)
                  + _params(up[2:], elt, 1),
                  labels_bytes),
        ]
    raise ValueError(f"no K2 chains counted for {fam}")
