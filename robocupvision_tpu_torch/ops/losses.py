"""Losses with the reference's semantics (reference model.py:5-43, 76-82;
the JAX package's ops/losses.py).

They take NHWC logits and integer NHW targets, and an optional per-pixel
validity mask so that the padded samples of a static-shape batch add
nothing. Every loss is computed in f32 and is differentiable (the train
step takes its gradients by autograd).
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Union

import torch


def _one_hot(targets: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 one-hot; a label outside [0, num_classes) is all zeros."""
    classes = torch.arange(num_classes, device=targets.device)
    return (targets.long()[..., None] == classes).float()


def cross_entropy_2d(logits: torch.Tensor, targets: torch.Tensor,
                     class_weights: Optional[torch.Tensor] = None,
                     mask: Optional[torch.Tensor] = None,
                     mesh=None) -> torch.Tensor:
    """Pixel-wise weighted NLL over log_softmax (CrossEntropyLoss2d): torch
    NLLLoss(weight, reduction='mean'), sum(w[t] * nll) / sum(w[t]). A label
    outside [0, C) drops out of the numerator and the denominator.

    ``mesh`` (a ``parallel.mesh.Mesh``): the rank's share of the global
    loss, its own numerator over the denominator summed over the mesh
    (without gradient); the shares sum to the loss of the global batch."""
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    oh = _one_hot(targets, num_classes)
    # select instead of logp * oh: a saturated logit's -inf log-prob times 0
    # would be NaN
    nll = -torch.where(oh > 0, logp, torch.zeros_like(logp)).sum(dim=-1)
    w = torch.ones(num_classes, device=logits.device) if class_weights is None \
        else torch.as_tensor(class_weights, device=logits.device).float()
    pw = (w * oh).sum(dim=-1)
    if mask is not None:
        pw = pw * torch.as_tensor(mask, device=logits.device).float()
    den = pw.sum()
    if mesh is not None:
        den = mesh.sum(den)
    return (nll * pw).sum() / torch.clamp_min(den, 1e-12)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  class_weights: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  mesh=None) -> torch.Tensor:
    """Classification CE (torch.nn.CrossEntropyLoss) over (N, C) logits
    and (N,) targets, with class weights and an (N,) sample mask; ``mesh``
    as in :func:`cross_entropy_2d`."""
    return cross_entropy_2d(logits, targets, class_weights, mask, mesh)


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              class_weights: torch.Tensor, mask: Optional[torch.Tensor] = None,
              eps: float = 1e-7, mesh=None) -> torch.Tensor:
    """Class-weighted Sørensen-Dice loss (reference model.py:5-43). The
    weights are renormalized to sum to C; one class uses the sigmoid with
    (pos, neg) channels, in the reference's channel order.

    ``mesh``: the intersection and cardinality are summed over the mesh
    (differentiably), and each rank returns the global loss over the
    mesh's size, its share."""
    num_classes = logits.shape[-1]
    w = torch.as_tensor(class_weights, device=logits.device).float()
    w = w / w.sum() * w.shape[0]
    if num_classes == 1:
        pos = torch.sigmoid(logits.float())
        probas = torch.cat([pos, 1.0 - pos], dim=-1)
        oh = _one_hot(targets, 2)
        one_hot = torch.stack([oh[..., 1], oh[..., 0]], dim=-1)
    else:
        probas = torch.softmax(logits.float(), dim=-1)
        one_hot = _one_hot(targets, num_classes)
    if mask is not None:
        m = torch.as_tensor(mask, device=logits.device).float()[..., None]
        probas = probas * m
        one_hot = one_hot * m
    axes = tuple(range(probas.dim() - 1))  # reduce all but the class axis
    intersection = (probas * one_hot).sum(dim=axes)
    cardinality = (probas + one_hot).sum(dim=axes)
    if mesh is not None:
        both = mesh.all_reduce_sum(torch.stack([intersection, cardinality]))
        intersection, cardinality = both[0], both[1]
    loss = 1.0 - torch.mean(2.0 * w * intersection / (cardinality + eps))
    return loss if mesh is None else loss / mesh.size


def l1_regularization(params: Union[Mapping[str, torch.Tensor],
                                    Iterable[torch.Tensor]]) -> torch.Tensor:
    """Sum of absolute values over the given tensors (train.py:23-27); a
    dict (the train step's trainable params) is summed in its sorted-name
    order, as the JAX package's tree of leaves is."""
    if isinstance(params, Mapping):
        params = [params[k] for k in sorted(params)]
    return sum(p.float().abs().sum() for p in params)
