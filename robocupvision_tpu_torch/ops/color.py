"""Colour constants and the serving-side camera preprocessing.

rgb2yuv uses skimage.color's BT.601 constants (the legacy pipeline's
ToYUV), and the per-domain normalization constants are the reference's;
both copied from the JAX package's ops/color.py.
"""

from __future__ import annotations

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
