"""Flat weights.dat export, the external C++ engine's weight contract (the
JAX package's export/weights_io.py ``save_params``).

Reference paramSave.py:5-18: every state_dict tensor, concatenated flat in
registration order, written little-endian. Written as float32 (the format
the robot engine reads), BN gamma/beta/running_mean/running_var included,
no ``num_batches_tracked`` counters. The port's state_dict is already in
torch layouts and registry order.
"""

from __future__ import annotations

import os
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
