"""Low-level NN ops: NHWC activations (the JAX package's public layout),
torch-layout weights (what the port's modules store).

- ``conv2d``            (x NHWC, w (out, in, kh, kw))   == robocupvision_tpu.ops.nn.conv2d
- ``conv_transpose2d``  (x NHWC, w (in, out, kh, kw))   == ...conv_transpose2d.
                        Torch's kernel is unflipped; the JAX package stores
                        the same kernel pre-flipped HWIO (export/torch_io.py).
- ``batch_norm``        eval mode: the running statistics as one f32
                        affine, result in the input dtype.
- ``batch_norm_train``  train mode: the batch statistics (padded samples
                        masked out) and the new running statistics.
- ``relu``, ``max_pool``, ``adaptive_avg_pool_1``.
- ``dropout``, ``dropout2d``: the train-time drops, applied with a keep
                        mask that ``draw_keep`` draws from a
                        ``torch.Generator`` apart from the apply (the JAX
                        package draws it from jax.random, whose numbers
                        torch cannot reproduce, so a test hands both the
                        same mask).

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
    """Eval-mode BatchNorm2d over the channel (last) axis, statistics in f32."""
    inv = torch.rsqrt(running_var.float() + eps) * gamma.float()
    shift = beta.float() - running_mean.float() * inv
    return (x.float() * inv + shift).to(x.dtype)


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     momentum: float = 0.1, eps: float = 1e-5,
                     sample_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm2d over the channel (last) axis, as the JAX
    package's ``batch_norm(train=True)`` computes it: batch statistics in
    f32, the variance as E[x^2] - E[x]^2 (biased) for the normalization and
    its unbiased form for the running variance, torch's momentum.
    ``sample_mask`` (N,) leaves padded samples out of the statistics, and an
    all-padding batch leaves the running statistics as they were.

    Returns (y at x's dtype, new running mean, new running var); the
    running statistics carry no gradient."""
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    if sample_mask is not None:
        m = torch.as_tensor(sample_mask, device=x.device).float().reshape(
            (-1,) + (1,) * (x.dim() - 1))
        per_sample = 1
        for a in axes[1:]:
            per_sample *= x.shape[a]
        n = torch.clamp_min(m.sum() * per_sample, 1.0)
        mean = (xf * m).sum(dim=axes) / n
        var = (xf.square() * m).sum(dim=axes) / n - mean.square()
        unbiased = var * (n / torch.clamp_min(n - 1.0, 1.0))
    else:
        mean = xf.mean(dim=axes)
        var = xf.square().mean(dim=axes) - mean.square()  # biased
        n = 1
        for a in axes:
            n *= x.shape[a]
        unbiased = var * (n / max(n - 1, 1))
    with torch.no_grad():
        new_rm = (1.0 - momentum) * running_mean + momentum * mean
        new_rv = (1.0 - momentum) * running_var + momentum * unbiased
        if sample_mask is not None:
            valid = m.sum() > 0
            new_rm = torch.where(valid, new_rm, running_mean)
            new_rv = torch.where(valid, new_rv, running_var)
    inv = torch.rsqrt(var + eps) * gamma.float()
    shift = beta.float() - mean * inv
    return (xf * inv + shift).to(x.dtype), new_rm, new_rv


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def max_pool(x: torch.Tensor, kernel: IntOrPair,
             stride: Optional[IntOrPair] = None) -> torch.Tensor:
    """MaxPool2d, no padding, floor output size (torch default), NHWC."""
    return _nhwc(F.max_pool2d(_nchw(x), kernel, stride))


def adaptive_avg_pool_1(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) on NHWC: the mean over H, W (dims kept)."""
    return torch.mean(x, dim=(1, 2), keepdim=True)


def draw_keep(gen: torch.Generator, shape, p: float) -> torch.Tensor:
    """A bool keep mask of ``shape``, each entry kept with probability
    1 - ``p``, on the generator's device. ``dropout`` takes a mask of x's
    shape, ``dropout2d`` one of (N, 1, 1, C)."""
    return torch.rand(tuple(shape), generator=gen, device=gen.device) \
        < 1.0 - p


def dropout(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """Element dropout (torch.nn.Dropout) with the given keep mask: kept
    entries scaled by 1 / (1 - p), the others 0."""
    return torch.where(keep.to(x.device), x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device)
                       ).to(x.dtype)


def dropout2d(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """Channel dropout (torch.nn.Dropout2d) over NHWC: ``keep`` (N, 1, 1, C)
    keeps or drops whole channels of each sample."""
    if keep.dim() != 4 or keep.shape[1:3] != (1, 1):
        raise ValueError(f"dropout2d takes an (N, 1, 1, C) mask, not "
                         f"{tuple(keep.shape)}")
    return dropout(x, keep, p)
