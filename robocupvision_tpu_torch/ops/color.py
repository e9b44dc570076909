"""Colour constants, the serving-side camera preprocessing, and the
training augmentation of train.py (horizontal flip and YUV jitter).

rgb2yuv uses skimage.color's BT.601 constants (the legacy pipeline's
ToYUV), and the per-domain normalization constants are the reference's;
both copied from the JAX package's ops/color.py.

The augmentation is split in two: ``draw_augment`` draws each sample's
flip and jitter values from a ``torch.Generator``, and ``augment_batch``
applies given draws. The JAX package draws from ``jax.random``, whose
numbers torch cannot reproduce, so a test hands both the same draws.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# skimage.color.yuv_from_rgb
YUV_FROM_RGB = np.array(
    [[0.299, 0.587, 0.114],
     [-0.14714119, -0.28886916, 0.43601035],
     [0.61497538, -0.51496512, -0.10001026]], np.float32)

# Per-domain normalization constants (reference dataset.py:74-75)
MEAN_SYNTHETIC = (0.36269532, 0.41144562, 0.282713)
STD_SYNTHETIC = (0.31111388, 0.21010718, 0.34060917)
MEAN_FINETUNE = (0.34190056, 0.4833289, 0.48565758)
STD_FINETUNE = (0.47421749, 0.13846053, 0.1714848)


def rgb_to_yuv(rgb: torch.Tensor) -> torch.Tensor:
    """NHWC (or HWC) RGB in [0, 1] -> YUV, skimage semantics."""
    m = torch.as_tensor(YUV_FROM_RGB, dtype=rgb.dtype, device=rgb.device)
    return torch.einsum("...c,dc->...d", rgb, m)


def normalize(img: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.as_tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def raw_camera_preprocess(x_u8: torch.Tensor, mean=(0.5, 0.0, 0.0),
                          std: float = 0.5) -> torch.Tensor:
    """Raw uint8 RGB frames -> the legacy serving input (/255, ToYUV,
    normalize) as ONE affine: ``x @ (YUV^T / (255*std)) - mean/std``, in
    f32 on the frames' device."""
    a = torch.as_tensor(YUV_FROM_RGB.T / (255.0 * std), dtype=torch.float32,
                        device=x_u8.device)
    c = -torch.as_tensor(mean, dtype=torch.float32, device=x_u8.device) / std
    return torch.einsum("...c,cd->...d", x_u8.float(), a) + c


# the jitter ranges of the reference's dataset.py:19-39
JITTER_B, JITTER_C, JITTER_S, JITTER_H = 0.3, 0.3, 0.3, 3.1415 / 6


def draw_augment(gen: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
    """One batch's draws, on the generator's device: per sample a
    0.5-probability flip (bool) and the jitter's brightness ``b`` in
    [-0.3, 0.3), contrast ``c`` and saturation ``s`` in [0.7, 1.3), hue
    ``h`` in [-pi/6, pi/6), each uniform, as ``augment_sample`` of the JAX
    package draws them."""
    u = torch.rand((5, n), generator=gen, device=gen.device)
    return {"flip": u[0] > 0.5,
            "b": -JITTER_B + 2 * JITTER_B * u[1],
            "c": (1 - JITTER_C) + 2 * JITTER_C * u[2],
            "s": (1 - JITTER_S) + 2 * JITTER_S * u[3],
            "h": -JITTER_H + 2 * JITTER_H * u[4]}


def yuv_color_jitter(img: torch.Tensor, b, c, s, h) -> torch.Tensor:
    """YUV-space jitter (reference dataset.py:19-39) of NHWC images with
    per-sample values (N,): Y -> (Y + b) * c, UV through the rotation-scale
    [[s cos h, -sin h], [sin h, s cos h]]."""
    def col(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=img.device).reshape(-1, 1, 1)

    b, c, s, h = col(b), col(c), col(s), col(h)
    u, v = img[..., 1], img[..., 2]
    y = (img[..., 0] + b) * c
    u2 = s * torch.cos(h) * u + -torch.sin(h) * v
    v2 = torch.sin(h) * u + s * torch.cos(h) * v
    return torch.stack([y, u2, v2], dim=-1).to(img.dtype)


def augment_sample(img: torch.Tensor, label: torch.Tensor,
                   draws: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`augment_batch` of one (H, W, 3) image and its (H, W) label;
    ``draws`` holds one value each (0-d or (1,))."""
    one = {k: torch.as_tensor(v).reshape(1) for k, v in draws.items()}
    i, l = augment_batch(img[None], label[None], one)
    return i[0], l[0]


def augment_batch(imgs: torch.Tensor, labels: torch.Tensor,
                  draws: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-time augmentation of an NHWC batch and its (N, H, W) labels
    with the given draws: the flipped samples mirrored left-right (image
    and label), then the YUV jitter of every image (reference
    dataset.py:126-131)."""
    flip = draws["flip"].to(imgs.device)
    imgs = torch.where(flip.reshape(-1, 1, 1, 1), imgs.flip(2), imgs)
    labels = torch.where(flip.reshape(-1, 1, 1), labels.flip(2), labels)
    imgs = yuv_color_jitter(imgs, draws["b"], draws["c"], draws["s"],
                            draws["h"])
    return imgs, labels
