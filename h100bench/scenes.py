"""The traffic generator: synthetic RoboCup frames drawn on the device from
a seed.

A frozen, batched copy of ``chip_smoke.py``'s ``draw_scene`` (itself as
``tests/synth_data.py`` draws a frame): a field gradient, a line stripe
(class 4), a goal post (3), a robot box (2) and a ball disc (1), with
Gaussian pixel noise, quantized to 8 bits. Every scene has the same size,
so every seed gives the same work; only the content moves.
"""

from __future__ import annotations

from typing import Tuple

import torch

# the per-domain normalization constants of the reference's datasets
# (dataset.py:74-75 for SSYUVDataset; Normalize([.5, 0, 0], [.5, .5, .5])
# after ToYUV for the legacy SSDataSet)
MEAN_SYNTHETIC = (0.36269532, 0.41144562, 0.282713)
STD_SYNTHETIC = (0.31111388, 0.21010718, 0.34060917)
YUV_FROM_RGB = ((0.299, 0.587, 0.114),
                (-0.14714119, -0.28886916, 0.43601035),
                (0.61497538, -0.51496512, -0.10001026))
LEGACY_MEAN, LEGACY_STD = (0.5, 0.0, 0.0), 0.5


def _randint(gen, lo, hi, n, dev):
    return torch.randint(int(lo), int(hi), (n,), generator=gen,
                         device=dev).reshape(n, 1, 1)


def draw_u8(gen: torch.Generator, n: int, h: int, w: int,
            chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` scenes on the generator's device: RGB (n, h, w, 3) uint8 and
    labels (n, h, w) int32. Drawn ``chunk`` scenes at a time."""
    dev = gen.device
    imgs, labs = [], []
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        yy = torch.arange(h, device=dev).reshape(1, h, 1)
        xx = torch.arange(w, device=dev).reshape(1, 1, w)
        img = torch.zeros((m, h, w, 3), device=dev)
        img[..., 1] = torch.linspace(0.2, 0.5, h, device=dev).reshape(1, h, 1)
        lab = torch.zeros((m, h, w), dtype=torch.int32, device=dev)

        def paint(mask, rgb, cls):
            nonlocal img, lab
            col = torch.tensor(rgb, device=dev)
            img = torch.where(mask[..., None], col, img)
            lab = torch.where(mask, torch.full_like(lab, cls), lab)

        ly = _randint(gen, h // 4, 3 * h // 4, m, dev)
        paint((yy >= ly) & (yy < ly + max(h // 16, 1)), (0.9, 0.9, 0.9), 4)
        gx = _randint(gen, 0, w - w // 8, m, dev)
        paint((xx >= gx) & (xx < gx + max(w // 20, 1)) & (yy < h // 2),
              (0.8, 0.1, 0.1), 3)
        rx = _randint(gen, 0, w - w // 5, m, dev)
        ry = _randint(gen, h // 3, h - h // 4, m, dev)
        paint((xx >= rx) & (xx < rx + w // 6) & (yy >= ry)
              & (yy < ry + h // 5), (0.1, 0.7, 0.2), 2)
        cx = _randint(gen, 0, w, m, dev)
        cy = _randint(gen, h // 2, h, m, dev)
        r = max(h // 10, 2)
        paint((xx - cx) ** 2 + (yy - cy) ** 2 < r * r, (0.1, 0.2, 0.9), 1)
        img = img + 0.02 * torch.randn(img.shape, generator=gen, device=dev)
        imgs.append(torch.round(img.clamp(0, 1) * 255).to(torch.uint8))
        labs.append(lab)
    return torch.cat(imgs), torch.cat(labs)


def normalized(rgb_u8: torch.Tensor, kind: str) -> torch.Tensor:
    """A dataset's f32 images from uint8 RGB: ``ssyuv`` as train.py's
    SSYUVDataset gives them ((rgb - mean) / std), ``legacy`` as trainer.py's
    SSDataSet gives them (ToYUV, then Normalize([.5, 0, 0], [.5, .5, .5]))."""
    rgb = rgb_u8.float() / 255.0
    dev = rgb.device
    if kind == "ssyuv":
        return (rgb - torch.tensor(MEAN_SYNTHETIC, device=dev)) \
            / torch.tensor(STD_SYNTHETIC, device=dev)
    if kind == "legacy":
        yuv = rgb @ torch.tensor(YUV_FROM_RGB, device=dev).T
        return (yuv - torch.tensor(LEGACY_MEAN, device=dev)) / LEGACY_STD
    raise ValueError(f"unknown normalization {kind!r}")
