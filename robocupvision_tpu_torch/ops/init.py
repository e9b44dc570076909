"""Parameter initializers reproducing PyTorch layer defaults, drawn from an
explicit ``torch.Generator`` and returned in torch layout.

Conv2d/ConvTranspose2d/Linear default to ``kaiming_uniform_(a=sqrt(5))``,
i.e. U(-1/sqrt(fan_in), 1/sqrt(fan_in)); biases use the same bound.
BatchNorm starts at gamma=1, beta=0, running_mean=0, running_var=1;
LayerNorm at weight=1, bias=0.

fan_in (same as the JAX package's ops/init.py):
- conv  (kh, kw, in, out):  in * kh * kw
- tconv (kh, kw, in, out):  out * kh * kw  (torch's (in, out, kh, kw) dim 1)
- linear (in, out):         in

The draws are made on the CPU so one seed gives the same weights on every
device; the JAX package draws from jax.random, so the two packages share
distributions, not values (tests carry weights across with
export/torch_io.py instead).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _uniform(gen: torch.Generator, shape: Tuple[int, ...],
             bound: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return u * (2.0 * bound) - bound


def conv_weight(gen: torch.Generator, kh: int, kw: int, cin: int,
                cout: int) -> torch.Tensor:
    """(cout, cin, kh, kw)."""
    return _uniform(gen, (cout, cin, kh, kw), 1.0 / math.sqrt(cin * kh * kw))


def conv_bias(gen: torch.Generator, kh: int, kw: int, cin: int,
              cout: int) -> torch.Tensor:
    return _uniform(gen, (cout,), 1.0 / math.sqrt(cin * kh * kw))


def tconv_weight(gen: torch.Generator, kh: int, kw: int, cin: int,
                 cout: int) -> torch.Tensor:
    """(cin, cout, kh, kw), torch's unflipped ConvTranspose2d layout."""
    return _uniform(gen, (cin, cout, kh, kw), 1.0 / math.sqrt(cout * kh * kw))


def tconv_bias(gen: torch.Generator, kh: int, kw: int, cin: int,
               cout: int) -> torch.Tensor:
    return _uniform(gen, (cout,), 1.0 / math.sqrt(cout * kh * kw))


def linear_weight(gen: torch.Generator, cin: int, cout: int) -> torch.Tensor:
    """(cout, cin)."""
    return _uniform(gen, (cout, cin), 1.0 / math.sqrt(cin))


def linear_bias(gen: torch.Generator, cin: int, cout: int) -> torch.Tensor:
    return _uniform(gen, (cout,), 1.0 / math.sqrt(cin))


def bn_weight(c: int) -> torch.Tensor:
    return torch.ones((c,), dtype=torch.float32)


def bn_bias(c: int) -> torch.Tensor:
    return torch.zeros((c,), dtype=torch.float32)
