"""Seeded weights, made on the device in a few large calls.

Random weights stand in for a trained checkpoint. One normal and one
uniform draw cover every parameter of the net; each tensor is a slice of
them, scaled by its kind so that activations keep their size through the
depth (He-normal kernels, BatchNorm near its identity with running
statistics spread around it, small biases). The weights are f32, the
type the state_dict holds: a graph built for bf16 rounds them itself.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

# kind -> (normal scale or None for He, uniform span, uniform offset)
_UNIFORM = {
    "conv_b": (0.2, -0.1), "tconv_b": (0.2, -0.1), "lin_b": (0.2, -0.1),
    "bn_w": (0.4, 0.8), "bn_b": (0.2, -0.1),
    "bn_rm": (0.2, -0.1), "bn_rv": (0.4, 0.8),
}


def _he_std(kind: str, shape: Tuple[int, ...]) -> float:
    """He-normal std of a kernel given in (kh, kw, cin, cout) order; a
    stride-2 transposed conv reaches each output from a quarter of its
    taps."""
    if kind == "lin_w":
        fan = shape[0]
    else:
        kh, kw, cin, _ = shape
        fan = kh * kw * cin / (4 if kind == "tconv_w" else 1)
    return (2.0 / fan) ** 0.5


def make(specs: List[Tuple[str, Tuple[int, ...], Tuple[int, ...], str]],
         seed: int, device) -> Dict[str, torch.Tensor]:
    """``specs``: (name, shape in (kh, kw, cin, cout) order, stored shape,
    kind) in state_dict order -> {name: f32 tensor of the stored shape}."""
    sizes = [int(torch.Size(stored).numel()) for _, _, stored, _ in specs]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device)
    u = torch.rand(total, generator=gen, device=device)
    a, b, c = [], [], []
    for name, shape, _, kind in specs:
        if kind in _UNIFORM:
            span, off = _UNIFORM[kind]
            a.append(0.0), b.append(span), c.append(off)
        else:
            a.append(_he_std(kind, shape)), b.append(0.0), c.append(0.0)
    reps = torch.tensor(sizes, device=device)

    def per_element(vals):
        return torch.repeat_interleave(
            torch.tensor(vals, dtype=torch.float32, device=device), reps,
            output_size=total)

    flat = z * per_element(a) + u * per_element(b) + per_element(c)
    out: Dict[str, torch.Tensor] = OrderedDict()
    for (name, _, stored, _), part in zip(specs, torch.split(flat, sizes)):
        out[name] = part.view(stored)
    return out


def specs_of(registry) -> list:
    """The specs of a program registry (``models.layers.Registry``)."""
    return [(s.name, tuple(s.shape), tuple(s.torch_shape), s.kind)
            for s in registry.specs.values()]
