"""Seeded weights, made on the device in a few large calls.

Random weights stand in for a trained checkpoint. One normal and one
uniform draw cover every parameter of the net; each tensor is a slice of
them, scaled by its kind so that activations keep their size through the
depth (He-normal kernels, BatchNorm near its identity with running
statistics spread around it, small biases). The weights are f32, the
type the state_dict holds: a graph built for bf16 rounds them itself.

A kind this module does not know is drawn as the family's file says, in
its ``WEIGHT_KINDS``: {kind: a normal scale, or (uniform span, uniform
offset)}.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

from h100bench import core

# the kernels, drawn He-normal
_KERNELS = ("conv_w", "tconv_w", "lin_w")
# kind -> (uniform span, uniform offset)
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


def _draw(kind: str, shape: Tuple[int, ...],
          family: str) -> Tuple[float, float, float]:
    """(normal scale, uniform span, uniform offset) of a kind: this
    module's, else the family file's ``WEIGHT_KINDS``."""
    if kind in _UNIFORM:
        return (0.0, *_UNIFORM[kind])
    if kind in _KERNELS:
        return _he_std(kind, shape), 0.0, 0.0
    kinds = getattr(core.load_module("families", family), "WEIGHT_KINDS",
                    {})
    if kind not in kinds:
        raise ValueError(
            f"no draw for the parameter kind {kind!r}: add it to "
            f"WEIGHT_KINDS in h100bench/families/{family}.py")
    draw = kinds[kind]
    if isinstance(draw, (tuple, list)):
        span, off = draw
        return 0.0, float(span), float(off)
    return float(draw), 0.0, 0.0


def make(specs: List[Tuple[str, Tuple[int, ...], Tuple[int, ...], str]],
         seed: int, device, family: str) -> Dict[str, torch.Tensor]:
    """``specs``: (name, shape in (kh, kw, cin, cout) order, stored shape,
    kind) in state_dict order -> {name: f32 tensor of the stored shape}.
    ``family``: whose file draws the kinds this module does not know."""
    sizes = [int(torch.Size(stored).numel()) for _, _, stored, _ in specs]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device)
    u = torch.rand(total, generator=gen, device=device)
    a, b, c = [], [], []
    for name, shape, _, kind in specs:
        scale, span, off = _draw(kind, shape, family)
        a.append(scale), b.append(span), c.append(off)
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
