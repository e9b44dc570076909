"""The comparisons that decide ``correct``: the numbers they give, each
held against its limit in ``limits/<workload>.json``.

- ``logit_gap`` (served labels): over every pixel of the sampled frames,
  the widest gap by which the reference's logit of the served label lies
  below the reference's best logit. Valid for argmax labels only.
- ``loss_gap``, ``grad_gap``, ``change_gap`` (training): the first steps'
  losses (the worst step's relative gap; ``first_loss_gap`` the first
  step's alone), the norm of the first gradient as the optimizer got it,
  and the norm of the params' change after the steps, each leaf's norm
  against the reference's, by the worst leaf, over the larger of that
  leaf's and the median leaf's reference norm. A cell's limits file names
  the numbers it compares. Leaves whose reference gradient is under
  ``GRAD_FLOOR`` of the median leaf's (a conv bias before a BatchNorm,
  whose gradient is nought but for rounding) are left out of the change.
- ``k1_count_gap`` (validation): K1's per-batch confusion counts, label
  counts and correct pixels against a plain count of the same predictions
  and targets; exact (limit 0).
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable

import torch

GRAD_FLOOR = 1e-3


def logit_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """(N, C, H, W) reference logits, (N, H, W) served labels."""
    best = ref_logits.max(dim=1).values
    got = ref_logits.gather(1, served.long().clamp(0, ref_logits.shape[1] - 1)
                            [:, None])[:, 0]
    gap = best - got
    # a label outside the classes lies below every logit
    bad = (served.long() < 0) | (served.long() >= ref_logits.shape[1])
    gap = torch.where(bad, torch.full_like(gap, float("inf")), gap)
    return float(gap.max())


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keys: Iterable[str]) -> float:
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def counted_leaves(ref_grad_norms: Dict[str, float]) -> list:
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= GRAD_FLOOR * med]


def train_gaps(prog: dict, ref: dict, p0: Dict[str, torch.Tensor]) -> dict:
    """``prog`` and ``ref``: {"losses": [...], "grads": {leaf: tensor},
    "params": {leaf: tensor after the steps}}; ``p0`` the params before."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                 ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        gaps = [float("inf")]
    g_ref = norms(ref["grads"])
    grad_gap = worst_leaf_gap(norms(prog["grads"]), g_ref, g_ref)
    keys = counted_leaves(g_ref)
    d_prog = norms({k: prog["params"][k] - p0[k] for k in keys})
    d_ref = norms({k: ref["params"][k] - p0[k] for k in keys})
    return {"loss_gap": max(gaps), "first_loss_gap": gaps[0],
            "grad_gap": grad_gap,
            "change_gap": worst_leaf_gap(d_prog, d_ref, keys)}


def plain_counts(pred: torch.Tensor, tgt: torch.Tensor, classes: int):
    """conf[pred, label] over the batch, label counts, correct pixels."""
    idx = pred.long().reshape(-1) * classes + tgt.long().reshape(-1)
    conf = torch.bincount(idx, minlength=classes * classes).reshape(
        classes, classes).double()
    return conf, conf.sum(dim=0), torch.diagonal(conf).sum()


def k1_count_gap(batches) -> float:
    """``batches``: (pred, tgt, conf, lab_cnts, correct) per validation
    batch, the last three as the program's eval step gave them."""
    worst = 0.0
    for pred, tgt, conf, lab, correct in batches:
        c = conf.shape[0]
        want = plain_counts(pred, tgt, c)
        for got, ref in zip((conf, lab, correct), want):
            worst = max(worst, float((got.double().to(ref.device)
                                      - ref).abs().max()))
    return worst
