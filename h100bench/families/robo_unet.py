"""The flagship ROBO_UNet (RoboCupVision model.py:461-536: strided downs,
additive skips): its plain reference forward, its convs and FLOPs, and the
K2 chains of its served graph (``build_packed_infer``).

The forward is plain PyTorch on NCHW tensors in f32 over the shared blocks
of ``reference/nets.py``; it imports nothing of the program.
"""

from __future__ import annotations

from typing import List

import torch

from h100bench.counts import DTYPE_BYTES, Chain, Conv, _act, _c, _params
from h100bench.reference.nets import Params, conv, conv_block, up


def forward(p: Params, cfg: dict, x: torch.Tensor,
            train: bool = False) -> torch.Tensor:
    """The flagship ROBO_UNet: (N, 3, H, W) -> (N, classes, H, W) logits.
    Depth ``depth`` (+1 with ``no_scale``); Level0 holds ``levels - 1``
    Conv blocks (at least one), every deeper level a stride-2 Conv and
    ``levels - 1`` more; the PB belly ``belly_size - 1`` Convs to
    ``belly_planes`` and one back; each up adds its skip."""
    if cfg.get("pool") or cfg.get("v2"):
        raise ValueError("the reference holds the flagship ROBO_UNet only")
    depth = cfg["depth"] + (1 if cfg["no_scale"] else 0)
    lv = cfg["levels"]

    def level(name, h, n_convs, stride):
        h = conv_block(p, name + ".layers.Conv0", h, stride, train)
        for i in range(1, n_convs):
            h = conv_block(p, f"{name}.layers.Conv{i}", h, 1, train)
        return h

    downs = [level("downPart.Level0", x, max(lv - 1, 1), 1)]
    for i in range(1, depth):
        downs.append(level(f"downPart.Level{i}", downs[-1], lv, 2))
    h = downs[-1]
    if cfg["belly_size"] > 0:
        h = level("PB.PB_1", h, cfg["belly_size"] - 1, 1)
        h = level("PB.PB_2", h, 1, 1)
    for i in range(depth - 1):
        h = up(p, f"upPart.Up{i}", h, train) + downs[-(i + 2)]
    k = cfg.get("class_size", 1)
    return conv(p, "segmenter.layers.Class", h, 1, k // 2)


def convs(cfg: dict, h: int, w: int) -> List[Conv]:
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


def flops(cfg: dict, h: int, w: int) -> int:
    """Forward FLOPs of one (h, w) image."""
    return sum(c.flops for c in convs(cfg, h, w))


def k2_chains(config: dict, n: int, h: int, w: int) -> List[Chain]:
    """The down chain with the stem folded in, the deep chain, the up
    chain with the argmax head."""
    cfg = config["cfg"]
    elt = DTYPE_BYTES[config["serve"]["dtype"]]
    labels_bytes = n * h * w * 4          # the argmax head's int32 labels
    by = {c.name: c for c in convs(cfg, h, w)}
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
