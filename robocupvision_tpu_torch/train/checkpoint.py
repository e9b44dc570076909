"""Checkpoint I/O, in the JAX package's format so that either package
loads the other's files.

``save`` writes a compressed ``.npz`` of the parameters in the JAX layout
(HWIO kernels, carried by export/torch_io.to_jax_params) under the
registry names, marked with ``MAGIC_KEY``. ``load_any`` reads such a file,
or a torch pickle of a state_dict (the reference's own ``.pth``, already in
the port's layout), and returns the port's state_dict, checked against the
registry's names and shapes. A structurally pruned (compacted, ops/slim.py)
dict is saved with ``slim=True``, which marks the file with ``SLIM_KEY``;
``load_any`` reads a marked file without the shape guard, and keeps the
guard for every unmarked one.

``save_resume`` / ``load_resume`` keep a training run's crash-resume
snapshot: params, optimizer state, the best score and params so far, the
random generator's state and the next chunk, written atomically after
every chunk, so that a restarted run continues as if never stopped. The
snapshot is the port's own (torch layouts); only the port reads it.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from robocupvision_tpu_torch.export.torch_io import (from_jax_params,
                                                     to_jax_params)
from robocupvision_tpu_torch.models.layers import Registry

MAGIC_KEY = "__robocupvision_tpu__"
SLIM_KEY = "__slim__"  # structurally-pruned dict: per-layer widths differ

State = Dict[str, torch.Tensor]


def save(path: str, reg: Registry, state: State, slim: bool = False) -> None:
    """Write ``state`` (the port's state_dict) to ``path`` as the JAX
    package's ``.npz`` checkpoint; ``slim`` marks a structurally pruned
    dict, whose widths differ from the registry's."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = dict(to_jax_params(reg, state, slim=slim))
    arrays[MAGIC_KEY] = np.array(1)
    if slim:
        arrays[SLIM_KEY] = np.array(1)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def _load_npz(path: str, reg: Registry) -> "OrderedDict[str, torch.Tensor]":
    with np.load(path, allow_pickle=False) as z:
        missing = [name for name in reg.specs if name not in z]
        if missing:
            raise KeyError(f"{path}: missing {missing[0]}")
        return from_jax_params(reg, {name: z[name] for name in reg.specs},
                               slim=SLIM_KEY in z)


def _check_state(path: str, reg: Registry, state) -> "OrderedDict[str, torch.Tensor]":
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name, spec in reg.specs.items():
        if name not in state:
            raise KeyError(f"{path}: missing parameter {name}")
        t = torch.as_tensor(state[name]).detach().to("cpu", torch.float32)
        if tuple(t.shape) != spec.torch_shape:
            raise ValueError(f"{path}: {name} shape {tuple(t.shape)} != "
                             f"{spec.torch_shape}")
        out[name] = t.contiguous()
    return out


def load_any(path: str, reg: Registry) -> "OrderedDict[str, torch.Tensor]":
    """Load a checkpoint as the port's state_dict (CPU f32): the ``.npz``
    format of either package, or a torch pickle of a state_dict."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"PK":  # zip: an npz, or a torch >= 1.6 zipfile pickle
        try:
            with np.load(path, allow_pickle=False) as z:
                names = set(z.files)
        except Exception:
            names = set()
        if MAGIC_KEY in names or all(n in names for n in reg.specs):
            return _load_npz(path, reg)
    state = torch.load(path, map_location="cpu", weights_only=True)
    return _check_state(path, reg, state)


def exists(path: str) -> bool:
    return os.path.exists(path)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_resume(path: str, params: Dict, opt_state: Dict, best_score: float,
                best_params: Dict, rng_state, next_chunk: int,
                meta: Dict) -> None:
    """Atomically write a resume snapshot (a temporary file renamed over
    ``path``: a crash during the write leaves the previous one intact)."""
    import json

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"p_{k}": _np(v) for k, v in params.items()}
    arrays.update({f"b_{k}": _np(v) for k, v in best_params.items()})
    arrays.update({f"o_{k}": _np(v) for k, v in opt_state.items()})
    arrays["rng"] = _np(rng_state)
    arrays["best_score"] = np.float64(best_score)
    arrays["next_chunk"] = np.int64(next_chunk)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(),
                                   dtype=np.uint8).copy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load_resume(path: str) -> Tuple[Dict, Dict, float, Dict, torch.Tensor,
                                    int, Dict]:
    """-> (params, opt_state, best_score, best_params, rng_state,
    next_chunk, meta), tensors on the CPU."""
    import json

    with np.load(path, allow_pickle=False) as z:
        def part(prefix):
            return {k[len(prefix):]: torch.from_numpy(z[k].copy())
                    for k in z.files if k.startswith(prefix)}

        return (part("p_"), part("o_"), float(z["best_score"]), part("b_"),
                torch.from_numpy(z["rng"].copy()), int(z["next_chunk"]),
                json.loads(bytes(z["meta"]).decode()))
