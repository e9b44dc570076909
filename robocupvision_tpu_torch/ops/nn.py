"""Low-level NN ops: NHWC activations (the JAX package's public layout),
torch-layout weights (what the port's modules store).

- ``conv2d``            (x NHWC, w (out, in, kh, kw))   == robocupvision_tpu.ops.nn.conv2d
- ``conv_transpose2d``  (x NHWC, w (in, out, kh, kw))   == ...conv_transpose2d.
                        Torch's kernel is unflipped; the JAX package stores
                        the same kernel pre-flipped HWIO (export/torch_io.py).
- ``batch_norm``        eval mode only: the running statistics as one f32
                        affine, result in the input dtype.
- ``relu``, ``max_pool``.

The NHWC <-> NCHW permutes are views: a contiguous NHWC tensor permuted to
NCHW is a channels-last NCHW tensor, which the convolution takes without a
copy and returns channels-last, so the permute back is a view too.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

IntOrPair = Union[int, Tuple[int, int]]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: IntOrPair = 1, padding: IntOrPair = 0,
           dilation: IntOrPair = 1) -> torch.Tensor:
    """2-D convolution, NHWC x (out, in, kh, kw) -> NHWC, torch padding."""
    bb = None if b is None else b.to(x.dtype)
    return _nhwc(F.conv2d(_nchw(x), w.to(x.dtype), bb, stride=stride,
                          padding=padding, dilation=dilation))


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, stride: IntOrPair = 2,
                     padding: IntOrPair = 1,
                     output_padding: IntOrPair = 1) -> torch.Tensor:
    """torch.nn.ConvTranspose2d on NHWC; ``w`` is torch's (in, out, kh, kw)."""
    bb = None if b is None else b.to(x.dtype)
    return _nhwc(F.conv_transpose2d(_nchw(x), w.to(x.dtype), bb,
                                    stride=stride, padding=padding,
                                    output_padding=output_padding))


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm2d over the channel (last) axis, statistics in f32.
    (The training form with ``sample_mask`` belongs to the training port.)"""
    inv = torch.rsqrt(running_var.float() + eps) * gamma.float()
    shift = beta.float() - running_mean.float() * inv
    return (x.float() * inv + shift).to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def max_pool(x: torch.Tensor, kernel: IntOrPair,
             stride: Optional[IntOrPair] = None) -> torch.Tensor:
    """MaxPool2d, no padding, floor output size (torch default), NHWC."""
    return _nhwc(F.max_pool2d(_nchw(x), kernel, stride))
