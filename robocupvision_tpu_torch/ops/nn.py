"""Low-level NN ops: NHWC activations (the JAX package's public layout),
torch-layout weights (what the port's modules store).

- ``conv2d``            (x NHWC, w (out, in, kh, kw))   == robocupvision_tpu.ops.nn.conv2d
- ``conv_transpose2d``  (x NHWC, w (in, out, kh, kw))   == ...conv_transpose2d.
                        Torch's kernel is unflipped; the JAX package stores
                        the same kernel pre-flipped HWIO (export/torch_io.py).
- ``batch_norm``        eval mode: the running statistics as one f32
                        affine, result in the input dtype.
- ``batch_norm_train``  train mode: the batch statistics (padded samples
                        masked out, summed over a mesh's ranks with
                        ``reduce``) and the new running statistics.
- ``relu``, ``max_pool``, ``avg_pool``, ``adaptive_avg_pool_1``.
- ``resize_bilinear``   F.interpolate(mode="bilinear", align_corners=False)
                        on the NCHW view.
- ``linear``            w (in, out), as the JAX package stores it.
- ``pixel_shuffle``     torch.nn.PixelShuffle on the NCHW view.
- ``softmax``.
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

from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F

IntOrPair = Union[int, Tuple[int, int]]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: IntOrPair = 1, padding: IntOrPair = 0,
           dilation: IntOrPair = 1, groups: int = 1) -> torch.Tensor:
    """2-D convolution, NHWC x (out, in / groups, kh, kw) -> NHWC, torch
    padding."""
    bb = None if b is None else b.to(x.dtype)
    return _nhwc(F.conv2d(_nchw(x), w.to(x.dtype), bb, stride=stride,
                          padding=padding, dilation=dilation, groups=groups))


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
                     sample_mask: Optional[torch.Tensor] = None,
                     reduce: Optional[Callable[[torch.Tensor],
                                               torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm2d over the channel (last) axis, as the JAX
    package's ``batch_norm(train=True)`` computes it: batch statistics in
    f32, the variance as E[x^2] - E[x]^2 (biased) for the normalization and
    its unbiased form for the running variance, torch's momentum.
    ``sample_mask`` (N,) leaves padded samples out of the statistics, and an
    all-padding batch leaves the running statistics as they were.
    ``reduce``: a differentiable sum over the ranks of a mesh (the mesh's
    ``all_reduce_sum``), which makes the statistics those of the global
    batch: the sums of x and x^2 and the sample count go through it in one
    call.

    Returns (y at x's dtype, new running mean, new running var); the
    running statistics carry no gradient."""
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    if sample_mask is not None or reduce is not None:
        m = torch.ones(x.shape[0], device=x.device) if sample_mask is None \
            else torch.as_tensor(sample_mask, device=x.device).float()
        m = m.reshape((-1,) + (1,) * (x.dim() - 1))
        per_sample = 1
        for a in axes[1:]:
            per_sample *= x.shape[a]
        s1 = (xf * m).sum(dim=axes)
        s2 = (xf.square() * m).sum(dim=axes)
        cnt = m.sum() * per_sample
        if reduce is not None:
            c = s1.shape[0]
            tot = reduce(torch.cat([s1, s2, cnt.reshape(1)]))
            s1, s2, cnt = tot[:c], tot[c:2 * c], tot[2 * c].detach()
        n = torch.clamp_min(cnt, 1.0)
        mean = s1 / n
        var = s2 / n - mean.square()
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
        if sample_mask is not None or reduce is not None:
            valid = cnt > 0
            new_rm = torch.where(valid, new_rm, running_mean)
            new_rv = torch.where(valid, new_rv, running_var)
    inv = torch.rsqrt(var + eps) * gamma.float()
    shift = beta.float() - mean * inv
    return (xf * inv + shift).to(x.dtype), new_rm, new_rv


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to ``hw`` (align_corners False)."""
    return _nhwc(F.interpolate(_nchw(x), size=tuple(hw), mode="bilinear",
                               align_corners=False))


def max_pool(x: torch.Tensor, kernel: IntOrPair,
             stride: Optional[IntOrPair] = None) -> torch.Tensor:
    """MaxPool2d, no padding, floor output size (torch default), NHWC."""
    return _nhwc(F.max_pool2d(_nchw(x), kernel, stride))


def avg_pool(x: torch.Tensor, kernel: IntOrPair,
             stride: Optional[IntOrPair] = None) -> torch.Tensor:
    """AvgPool2d, no padding, floor output size, NHWC: the window sum over
    the window size."""
    return _nhwc(F.avg_pool2d(_nchw(x), kernel, stride))


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense layer; ``w`` is (in, out), as in the JAX package."""
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(y.dtype)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """PixelShuffle on NHWC: (N, H, W, C*r*r) -> (N, H*r, W*r, C), as
    torch.nn.PixelShuffle computes it on the NCHW view (input channel
    c*r*r + i*r + j goes to output pixel (h*r + i, w*r + j))."""
    n, h, w, crr = x.shape
    c = crr // (r * r)
    y = x.reshape(n, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(n, h * r, w * r, c)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=dim)


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
