"""PB_FCN in its segmentation mode (RoboCupVision model.py:269-309 over the
DownSampler, model.py:201-232): its plain reference forward, its convs and
FLOPs, and the K2 chains of its served graph (``build_packed_pb_fcn``).

The forward is plain PyTorch on NCHW tensors in f32 over the shared blocks
of ``reference/nets.py``; it imports nothing of the program.
"""

from __future__ import annotations

from typing import List

import torch

from h100bench.counts import DTYPE_BYTES, Chain, Conv, _act, _c, _params
from h100bench.reference.nets import (Params, conv, conv_pool,
                                      conv_pool_simple, up)


def forward(p: Params, cfg: dict, x: torch.Tensor,
            train: bool = False) -> torch.Tensor:
    """PB_FCN, segmentation mode: (N, 3, H, W) -> (N, classes, H, W)."""
    def cps(name, h, stride, padding, dilation):
        return conv_pool_simple(p, "FCN." + name, h, stride, padding,
                                dilation, train)

    x0 = cps("conv0", x, 1, 2, 2)
    x1 = cps("conv1", x0, 2, 1, 1)
    x2 = conv_pool(p, "FCN.conv2", x1, train)
    feats = [x0, x1, x2]
    h = x2
    if cfg["no_scale"]:
        h = conv_pool(p, "FCN.conv_ext", h, train)
        feats.append(h)
    h = conv_pool(p, "FCN.conv3", h, train)
    for i in range(4, 9):
        h = cps(f"conv{i}", h, 1, 2, 2)
    for j in range(len(feats)):
        h = up(p, f"up{j + 1}", h, train) + feats[-(j + 1)]
    k = cfg.get("kernel_size", 1)
    return conv(p, "segmenter.classifier", h, 1, k // 2)


def convs(cfg: dict, h: int, w: int) -> List[Conv]:
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


def flops(cfg: dict, h: int, w: int) -> int:
    """Forward FLOPs of one (h, w) image."""
    return sum(c.flops for c in convs(cfg, h, w))


def k2_chains(config: dict, n: int, h: int, w: int) -> List[Chain]:
    """The down chain (through conv_ext's first conv), the deep chain
    (conv4-conv8), the up chain with the argmax head."""
    cfg = config["cfg"]
    elt = DTYPE_BYTES[config["serve"]["dtype"]]
    labels_bytes = n * h * w * 4          # the argmax head's int32 labels
    by = {c.name: c for c in convs(cfg, h, w)}
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
