"""Optimizers with PyTorch semantics and per-name learning-rate groups (the
JAX package's train/optim.py, which builds them from optax).

A transform turns gradients into a pre-LR "direction";
``apply_updates`` then steps ``params - lr * multiplier[name] * direction``,
so a schedule changes only the scalar ``lr``. The reference runs
torch.optim.Adam with a 10x LR on the first ``transfer`` encoder levels
(train.py:357-363) and torch.optim.SGD(momentum, weight_decay) elsewhere
(trainer.py:182-184).

A transform's state is a flat ``{key: tensor}`` dict (``count``,
``mu/<name>``, ``nu/<name>``, ``trace/<name>``), so a resume snapshot
saves and restores it as it saves the params. Every update returns new
tensors and leaves its inputs as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]
OptState = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GradientTransform:
    init: Callable[[Mapping[str, torch.Tensor]], OptState]
    update: Callable[[Mapping[str, torch.Tensor], OptState,
                      Mapping[str, torch.Tensor]], Tuple[Params, OptState]]


def adam(b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransform:
    """optax's ``scale_by_adam`` (torch's Adam before the LR): moments
    mu = b1 mu + (1 - b1) g and nu = b2 nu + (1 - b2) g^2, the step count
    incremented first, bias-corrected moments, and the direction
    mu_hat / (sqrt(nu_hat) + eps)."""
    def init(params):
        dev = next(iter(params.values())).device
        st = {"count": torch.zeros((), dtype=torch.int32, device=dev)}
        for k, p in params.items():
            st["mu/" + k] = torch.zeros_like(p, dtype=torch.float32)
            st["nu/" + k] = torch.zeros_like(p, dtype=torch.float32)
        return st

    def update(grads, state, params):
        count = state["count"] + 1
        # optax computes the corrections 1 - b**count in f32, on the
        # device (a host copy of b would synchronise every step)
        t = count.float()
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        names = list(grads)
        g = [grads[k].float() for k in names]
        # one multi-tensor launch an op over all tensors, the same
        # arithmetic as the per-tensor expressions in the docstring
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - b1),
                                torch._foreach_mul([state["mu/" + k]
                                                    for k in names], b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2),
            torch._foreach_mul([state["nu/" + k] for k in names], b2))
        den = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(nu, c2)), eps)
        d = torch._foreach_div(torch._foreach_div(mu, c1), den)
        new: OptState = {"count": count}
        for k, m_, n_ in zip(names, mu, nu):
            new["mu/" + k], new["nu/" + k] = m_, n_
        return dict(zip(names, d)), new

    return GradientTransform(init, update)


def sgd(momentum: float = 0.0, weight_decay: float = 0.0) -> GradientTransform:
    """torch.optim.SGD before the LR: g += wd * param; buf = m * buf + g;
    the direction is buf (optax ``add_decayed_weights`` then ``trace``)."""
    def init(params):
        if not momentum:
            return {}
        return {"trace/" + k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    def update(grads, state, params):
        direction: Params = {}
        new: OptState = {}
        for k, g in grads.items():
            g = g.float()
            if weight_decay:
                g = g + weight_decay * params[k]
            if momentum:
                g = g + momentum * state["trace/" + k]
                new["trace/" + k] = g
            direction[k] = g
        return direction, new

    return GradientTransform(init, update)


def transfer_multipliers(order: Sequence[str], transfer: int,
                         base: float = 10.0) -> Dict[str, float]:
    """10x LR on params of downPart levels [0, transfer) (train.py:357-363)."""
    mult = {}
    for name in order:
        m = 1.0
        if transfer > 0 and name.startswith("downPart.Level"):
            level = int(name.split("Level")[1].split(".")[0])
            if level < transfer:
                m = base
        mult[name] = m
    return mult


def apply_updates(params: Mapping[str, torch.Tensor],
                  direction: Mapping[str, torch.Tensor], lr,
                  multipliers: Optional[Mapping[str, float]] = None) -> Params:
    """params - lr * mult * direction (torch's minimizing convention); new
    tensors, one multi-tensor launch a multiplier."""
    groups: Dict[float, list] = {}
    for name in params:
        m = 1.0 if multipliers is None else multipliers.get(name, 1.0)
        groups.setdefault(m, []).append(name)
    out = {}
    for m, names in groups.items():
        step = torch._foreach_mul([direction[k] for k in names], lr * m)
        new = torch._foreach_sub([params[k] for k in names], step)
        out.update(zip(names, new))
    return {k: out[k] for k in params}

