"""Pruning statistics (the JAX package's ops/pruning.py), so far the
near-zero count that the evaluation CLI test.py prints. The pruning
strategies belong to a later slice of the port."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from robocupvision_tpu_torch.models.layers import is_weight


def count_zero_weights(params: Mapping, order: Sequence[str]) -> float:
    """Share of weights below 1% of their tensor's max |w|, over every
    trainable tensor of ``order`` (reference model.py:59-66: despite the
    name it counts near-zeros). ``params``: tensors or arrays, any
    layout."""
    near_zero = 0.0
    total = 0
    for name in order:
        if not is_weight(name):
            continue
        p = params[name]
        p = np.abs(p.detach().float().cpu().numpy() if hasattr(p, "detach")
                   else np.asarray(p))
        m = np.max(p) if p.size else 0.0
        near_zero += float(np.sum(p < m * 0.01))
        total += p.size
    return near_zero / max(total, 1)
