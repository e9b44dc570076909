"""The weight carry between the JAX package's param dicts and the port's
state_dicts.

Both use the same names; only the layouts differ (the JAX package keeps
TPU layouts), so the carry is a pure layout transform, the same one as the
JAX package's ``to_torch_state_dict`` / ``from_torch_state_dict``:

  conv   torch (out, in, kh, kw)  <-> JAX (kh, kw, in, out)
  tconv  torch (in, out, kh, kw)  <-> JAX (kh, kw, in, out), spatially flipped
  linear torch (out, in)          <-> JAX (in, out)
  bn     identical vectors
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from robocupvision_tpu_torch.models.layers import Registry


def from_jax_params(reg: Registry, params_np: Dict[str, "object"]
                    ) -> "OrderedDict[str, torch.Tensor]":
    """JAX-layout param dict (arrays) -> the port's state_dict (CPU f32)."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name, spec in reg.specs.items():
        if name not in params_np:
            raise KeyError(f"missing parameter: {name}")
        a = np.asarray(params_np[name], dtype=np.float32)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{name}: shape {a.shape} != expected {spec.shape}")
        if spec.kind == "conv_w":
            a = np.transpose(a, (3, 2, 0, 1))
        elif spec.kind == "tconv_w":
            a = np.transpose(a, (2, 3, 0, 1))[:, :, ::-1, ::-1]
        elif spec.kind == "lin_w":
            a = a.T
        out[name] = torch.from_numpy(np.array(a))  # a writable contiguous copy
    return out


def to_jax_layout(a: np.ndarray, kind: str) -> np.ndarray:
    """One array of the port's layout -> the JAX package's (a contiguous
    copy), by its registry ``kind``."""
    if kind == "conv_w":
        a = np.transpose(a, (2, 3, 1, 0))
    elif kind == "tconv_w":
        a = np.transpose(a[:, :, ::-1, ::-1], (2, 3, 0, 1))
    elif kind == "lin_w":
        a = a.T
    return np.ascontiguousarray(a)


def to_jax_params(reg: Registry, state: Dict[str, torch.Tensor]
                  ) -> Dict[str, np.ndarray]:
    """The port's state_dict (tensors or arrays, torch layouts) ->
    JAX-layout param dict (numpy f32)."""
    out: Dict[str, np.ndarray] = {}
    for name, spec in reg.specs.items():
        if name not in state:
            raise KeyError(f"missing parameter: {name}")
        a = to_jax_layout(torch.as_tensor(state[name]).detach().float()
                          .cpu().numpy(), spec.kind)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{name}: shape {a.shape} != expected {spec.shape}")
        out[name] = a
    return out
