"""Pruning (the JAX package's ops/pruning.py): the near-zero count that the
CLIs print, the reference's 1%-of-max threshold pruning that train.py's
finetune phase runs, the band pruning of the legacy CLIs' ``--prune``, and
the gradient masking that keeps pruned weights at zero. "Prunable" tensors are the trainable ones with more than one
dimension, in registry order, as the reference's
``for param in model.parameters(): if param.dim() > 1`` walks them.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from robocupvision_tpu_torch.export.torch_io import to_jax_layout
from robocupvision_tpu_torch.models.layers import is_weight


def _np(p) -> np.ndarray:
    return p.detach().float().cpu().numpy() if hasattr(p, "detach") \
        else np.asarray(p)


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
        p = np.abs(_np(params[name]))
        m = np.max(p) if p.size else 0.0
        near_zero += float(np.sum(p < m * 0.01))
        total += p.size
    return near_zero / max(total, 1)


def near_zero_fraction(params: Mapping[str, torch.Tensor],
                       order: Sequence[str]) -> torch.Tensor:
    """:func:`count_zero_weights` as tensor ops on the params' device, a
    0-d f32 tensor: no host copy of the weights (the train loop reports it
    every epoch and fetches it with the epoch's other metrics)."""
    near = None
    total = 0
    for name in order:
        if not is_weight(name):
            continue
        p = params[name].detach().float().abs()
        if p.numel() == 0:
            continue
        cnt = (p < p.max() * 0.01).sum(dtype=torch.float32)
        near = cnt if near is None else near + cnt
        total += p.numel()
    if near is None:
        return torch.zeros(())
    return near / max(total, 1)


def prunable_names(order: Sequence[str], params: Mapping) -> List[str]:
    return [n for n in order if is_weight(n) and np.ndim(_np(params[n])) > 1]


def prune_threshold(params: Mapping, order: Sequence[str],
                    ratio: float = 0.01, verbose: bool = True
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Zero every prunable weight below ``ratio`` of its tensor's max |w|
    (reference model.py:45-57). Returns (new params, masks), both CPU
    tensors, the masks True at the pruned positions."""
    new = {k: torch.as_tensor(_np(v)) for k, v in params.items()}
    masks: Dict[str, torch.Tensor] = {}
    for name in prunable_names(order, params):
        p = _np(params[name]).copy()
        thresh = float(np.max(np.abs(p))) * ratio
        mask = np.abs(p) < thresh
        if verbose:
            print("Pruned %f%% of the weights" % (
                float(mask.sum()) / max(float(np.sum(p != 0)), 1.0) * 100.0))
        p[mask] = 0
        new[name] = torch.from_numpy(p)
        masks[name] = torch.from_numpy(mask)
    return new, masks


def prune_band(params: Mapping, registry, lower: float = 73.0,
               upper: float = 77.0, verbose: bool = True
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Prune each prunable tensor to between ``lower`` and ``upper`` percent
    of its non-zero weights (reference model.py:621-642): a threshold
    seeded at the tensor's standard deviation and scaled by 1.025 or 0.975
    until the share of |w| below it falls in the band, then the weights
    below it zeroed. ``registry``: the model's (its order, and each
    tensor's layout: the deviation is taken over the tensor in the JAX
    package's layout, whose summation order it then shares to the bit).
    Returns (new params, masks), both CPU tensors, the masks True at the
    pruned positions."""
    new = {k: torch.as_tensor(_np(v)) for k, v in params.items()}
    masks: Dict[str, torch.Tensor] = {}
    for name in prunable_names(registry.order, params):
        p = _np(params[name]).copy()
        thresh = float(to_jax_layout(p, registry.specs[name].kind).std())
        nz = max(float(np.sum(p != 0)), 1.0)
        while True:
            num = float(np.sum(np.abs(p) < thresh)) / nz * 100.0
            if num < lower:
                thresh *= 1.025
            elif num > upper:
                thresh *= 0.975
            else:
                break
        mask = np.abs(p) < thresh
        if verbose:
            print("Pruned %f%% of the weights" % (mask.sum() / nz * 100.0))
        p[mask] = 0
        new[name] = torch.from_numpy(p)
        masks[name] = torch.from_numpy(mask)
    return new, masks


def mask_gradients(grads: Mapping[str, torch.Tensor],
                   masks: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero the gradient entries at pruned positions (mask > 0)."""
    out = dict(grads)
    for name, mask in masks.items():
        if name in out:
            g = out[name]
            out[name] = torch.where(mask.to(g.device) > 0,
                                    torch.zeros((), dtype=g.dtype,
                                                device=g.device), g)
    return out
