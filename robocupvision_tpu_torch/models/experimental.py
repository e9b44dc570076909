"""Experimental separable-conv blocks (the JAX package's
models/experimental.py; reference model.py:333-377).

ConvSep (parallel nx1 and 1xn convs, concatenated, then a 1x1 mix) and
trConvSep (a 1x1 conv, then parallel 1x3 and 3x1 transpose convs summed)
are unused experiments in the reference (only a commented line names
trConvSep, model.py:439). They keep its structure, with a registry
declaration and a block function each, so that a model variant can adopt
them. As every block of models/layers.py, they run in eval mode unless
called inside ``layers.train_mode``.
"""

from __future__ import annotations

import torch

from robocupvision_tpu_torch.models import layers as L
from robocupvision_tpu_torch.ops import nn

_j = L.join


def conv_sep_def(r: L.Registry, name: str, cin: int, cout: int, k: int) -> None:
    r.conv(_j(name, "conv_nx1"), cin, cout // 2, (k, 1), bias=False)
    r.conv(_j(name, "conv_1xn"), cin, cout // 2, (1, k), bias=False)
    r.bn(_j(name, "bn1"), cout)
    r.conv(_j(name, "conv_1x1"), cout, cout, 1, bias=False)
    r.bn(_j(name, "bn2"), cout)


def conv_sep(p: L.Params, name: str, x: torch.Tensor, k: int,
             stride: int) -> torch.Tensor:
    dilation = 1 if stride > 1 else 2
    padding = k // 2 + dilation - 1
    a = L.conv(p, _j(name, "conv_nx1"), x, stride=stride,
               padding=(padding, 0), dilation=(dilation, dilation))
    b = L.conv(p, _j(name, "conv_1xn"), x, stride=stride,
               padding=(0, padding), dilation=(dilation, dilation))
    y = torch.cat([a, b], dim=-1)
    y = nn.relu(L.bn(p, _j(name, "bn1"), y))
    y = L.conv(p, _j(name, "conv_1x1"), y)
    return nn.relu(L.bn(p, _j(name, "bn2"), y))


def tr_conv_sep_def(r: L.Registry, name: str, cin: int, cout: int) -> None:
    r.conv(_j(name, "conv"), cin, cout, 1, bias=False)
    r.tconv(_j(name, "trconv1x3"), cout, cout, (1, 3), bias=False)
    r.tconv(_j(name, "trconv3x1"), cout, cout, (3, 1), bias=False)
    r.bn(_j(name, "bn1"), cout)
    r.bn(_j(name, "bn2"), cout)


def tr_conv_sep(p: L.Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """2x upsampling by summed 1x3 and 3x1 transpose convs
    (model.py:363-377); both give (2h, 2w) through output_padding=1 on
    their short axes."""
    y = nn.relu(L.bn(p, _j(name, "bn1"), L.conv(p, _j(name, "conv"), x)))
    a = nn.conv_transpose2d(y, p[_j(name, "trconv1x3.weight")], None,
                            stride=2, padding=(0, 1), output_padding=1)
    b = nn.conv_transpose2d(y, p[_j(name, "trconv3x1.weight")], None,
                            stride=2, padding=(1, 0), output_padding=1)
    return nn.relu(L.bn(p, _j(name, "bn2"), a + b))
