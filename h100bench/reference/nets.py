"""The blocks of the plain reference forwards, and the camera input they
take: the conv families' forwards (``families/<family>.py``) are built
from them.

Plain PyTorch on NCHW tensors in f32, written from the layer equations of
the reference's blocks:

  Conv (model.py:105-116)            conv -> ReLU -> BN
  ConvPoolSimple (model.py:166-176)  conv -> BN -> ReLU
  ConvPool (model.py:126-142)        dilated conv1 -> ReLU -> stride-2
                                     pool conv -> BN -> ReLU
  upSampleTransposeConv (178-194)    k3/s2/p1/op1 tconv -> BN -> ReLU
  UltClassifier / Classifier         conv (k, padding k // 2)

Parameters are a state_dict: {name: tensor}, conv kernels (out, in, kh,
kw), transposed kernels (in, out, kh, kw). ``train=True`` normalizes by
the batch's statistics (biased variance), as BatchNorm2d does in train
mode. This module imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
EPS = 1e-5
YUV_FROM_RGB = ((0.299, 0.587, 0.114),
                (-0.14714119, -0.28886916, 0.43601035),
                (0.61497538, -0.51496512, -0.10001026))


def camera_input(x_u8: torch.Tensor) -> torch.Tensor:
    """Raw (N, H, W, 3) uint8 RGB camera frames -> the serving input
    (N, 3, H, W): /255, ToYUV (BT.601, skimage's matrix), then
    Normalize([.5, 0, 0], [.5, .5, .5])."""
    rgb = x_u8.double() / 255.0
    yuv = rgb @ torch.tensor(YUV_FROM_RGB, dtype=torch.float64,
                             device=x_u8.device).T
    mean = torch.tensor((0.5, 0.0, 0.0), dtype=torch.float64,
                        device=x_u8.device)
    return ((yuv - mean) / 0.5).float().permute(0, 3, 1, 2).contiguous()


def bn(p: Params, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    g = p[name + ".weight"].reshape(1, -1, 1, 1)
    b = p[name + ".bias"].reshape(1, -1, 1, 1)
    if train:
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    else:
        mean = p[name + ".running_mean"].reshape(1, -1, 1, 1)
        var = p[name + ".running_var"].reshape(1, -1, 1, 1)
    return (x - mean) / torch.sqrt(var + EPS) * g + b


def conv(p: Params, name: str, x, stride=1, padding=0, dilation=1):
    return F.conv2d(x, p[name + ".weight"], p.get(name + ".bias"),
                    stride=stride, padding=padding, dilation=dilation)


def conv_block(p, name, x, stride, train):              # Conv
    k = p[name + ".conv.weight"].shape[-1]
    y = conv(p, name + ".conv", x, stride, k // 2)
    return bn(p, name + ".bn", F.relu(y), train)


def conv_pool_simple(p, name, x, stride, padding, dilation, train):
    y = conv(p, name + ".conv", x, stride, padding, dilation)
    return F.relu(bn(p, name + ".bn", y, train))


def conv_pool(p, name, x, train):
    y = F.relu(conv(p, name + ".conv1", x, 1, 2, 2))
    y = conv(p, name + ".pool", y, 2, 1)
    return F.relu(bn(p, name + ".bn", y, train))


def up(p, name, x, train):
    y = F.conv_transpose2d(x, p[name + ".conv.weight"],
                           p.get(name + ".conv.bias"), stride=2, padding=1,
                           output_padding=1)
    return F.relu(bn(p, name + ".bn", y, train))
