"""Flat weights.dat, the external C++ engine's weight contract (the JAX
package's export/weights_io.py): ``save_params`` writes it,
``load_params_flat`` reads it back.

Reference paramSave.py:5-18: every state_dict tensor, concatenated flat in
registration order, written little-endian. Written as float32 (the format
the robot engine reads), BN gamma/beta/running_mean/running_var included,
no ``num_batches_tracked`` counters. The port's state_dict is already in
torch layouts and registry order.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from robocupvision_tpu_torch.models.layers import Registry


def save_params(path: str, reg: Registry, state: Dict[str, torch.Tensor],
                fname: str = "weights.dat", skip_classifier: bool = False,
                skip_prefixes: Tuple[str, ...] = ()) -> str:
    """Write ``state`` (the port's state_dict) to ``path/fname``.
    ``skip_classifier`` is the reference's substring test (paramSave.py:12:
    it also matches PB_FCN's ``segmenter.classifier``), which the JAX
    tester's ``--dump`` of ``--v2`` uses; ``skip_prefixes`` leaves out an
    unused head precisely (e.g. ``("classifier.",)``)."""
    os.makedirs(path, exist_ok=True)
    chunks = []
    for name in reg.specs:
        if skip_classifier and "classifier" in name:
            print("Classifier module skipped")
            continue
        if any(name.startswith(p) for p in skip_prefixes):
            continue
        chunks.append(torch.as_tensor(state[name]).detach()
                      .to("cpu", torch.float32).numpy().reshape(-1))
    flat = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    out = os.path.join(path, fname)
    flat.astype("<f4").tofile(out)
    return out


def load_params_flat(path: str, reg: Registry,
                     skip_classifier: bool = False
                     ) -> "OrderedDict[str, torch.Tensor]":
    """Inverse of :func:`save_params`: slice the flat stream back into the
    port's state_dict (CPU f32, torch layouts, registry order); tensors
    left out with ``skip_classifier`` come back as zeros.

    Detects the element width: the reference's own saveParams seeds its
    concatenation with ``np.empty(0)`` (float64), so every dump the
    reference itself produced (the shipped weightsLP/weights.dat: 742,696
    bytes, 92,837 float64 values, LabelProp(planes=32)'s parameter count) is
    little-endian float64, while this package and the robot engine write
    float32 (paramSave.py:9-18). A stream of exactly 8 bytes a value is read
    as float64."""
    def kept(name):
        return not (skip_classifier and "classifier" in name)

    expected = sum(int(np.prod(spec.shape))
                   for name, spec in reg.specs.items() if kept(name))
    if os.path.getsize(path) == expected * 8:
        flat = np.fromfile(path, dtype="<f8").astype(np.float32)
    else:
        flat = np.fromfile(path, dtype="<f4")
    state: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    offset = 0
    for name, spec in reg.specs.items():
        if not kept(name):
            state[name] = _zeros_like_spec(reg, name)
            continue
        n = int(np.prod(spec.shape))
        state[name] = torch.from_numpy(
            flat[offset:offset + n].reshape(spec.torch_shape).copy())
        offset += n
    if offset != flat.size:
        raise ValueError(f"{path}: consumed {offset} of {flat.size} floats")
    return state


def _zeros_like_spec(reg: Registry, name: str) -> torch.Tensor:
    """A zero tensor of ``name``'s shape in the port's (torch) layout."""
    return torch.zeros(reg.specs[name].torch_shape, dtype=torch.float32)
