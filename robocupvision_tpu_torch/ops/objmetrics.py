"""Object-level precision and recall (reference test.py:28-89; the JAX
package's ops/objmetrics.py).

Per foreground class and image: the connected components of the predicted
and the target masks, matched greedily and uniquely by (a) mask IoU >
thresh and (b) bounding-box-centre distance < distanceThresh; per image,
(precision + recall) / 2 for both criteria. An empty prediction or target
set counts as precision or recall 1 (the reference's convention).

Components are the reference's ``cv2.connectedComponents`` ones: scipy's
``ndimage.label`` with a 3x3 structure (8-connected; its default is
4-connected), renumbered in the order cv2's block-based labelling numbers
them, because the greedy matching depends on that order. This runs on the
host: evaluation only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

_EIGHT = np.ones((3, 3), dtype=bool)


def _connected_components(mask: np.ndarray) -> Tuple[int, np.ndarray]:
    """(n, labels): 8-connected components numbered 1..n by their first
    2x2 block in raster order of the blocks (cv2's numbering: its labelling
    scans 2x2 blocks, and the foreground of a block is always one
    component)."""
    lab, n = ndimage.label(mask, structure=_EIGHT)
    if n == 0:
        return 0, lab
    ys, xs = np.nonzero(lab)
    block = (ys // 2) * ((lab.shape[1] + 1) // 2) + xs // 2
    first = np.full(n + 1, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first, lab[ys, xs], block)
    rank = np.zeros(n + 1, lab.dtype)
    rank[np.argsort(first[1:]) + 1] = np.arange(1, n + 1)
    return n, rank[lab]


def _bounding_rect(mask: np.ndarray) -> Tuple[int, int, int, int]:
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return 0, 0, 0, 0
    return int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1), \
        int(ys.max() - ys.min() + 1)


def _components_stats(lab: np.ndarray, n: int):
    """Bounding-box centres of components 1..n of a labeled image."""
    h, w = lab.shape
    ys, xs = np.nonzero(lab)
    vals = lab[ys, xs]
    min_x = np.full(n + 1, w, np.int64)
    min_y = np.full(n + 1, h, np.int64)
    max_x = np.full(n + 1, -1, np.int64)
    max_y = np.full(n + 1, -1, np.int64)
    np.minimum.at(min_x, vals, xs)
    np.minimum.at(min_y, vals, ys)
    np.maximum.at(max_x, vals, xs)
    np.maximum.at(max_y, vals, ys)
    centers = []
    for j in range(1, n + 1):
        bw = max_x[j] - min_x[j] + 1
        bh = max_y[j] - min_y[j] + 1
        centers.append((min_x[j] + bw / 2, min_y[j] + bh / 2))
    return centers


def _pair_stats(pred_lab, n_pred, tar_lab, n_true):
    """Pairwise IoU and centre distance of every (pred, target) component
    pair, from one 2-D histogram of component ids."""
    inter = np.zeros((n_pred + 1, n_true + 1), np.int64)
    np.add.at(inter, (pred_lab.ravel(), tar_lab.ravel()), 1)
    area_p = inter.sum(axis=1)
    area_t = inter.sum(axis=0)
    union = area_p[1:, None] + area_t[None, 1:] - inter[1:, 1:]
    iou = np.where(union > 0, inter[1:, 1:] / np.maximum(union, 1), 0.0)
    if n_pred and n_true:
        cp = np.asarray(_components_stats(pred_lab, n_pred))
        ct = np.asarray(_components_stats(tar_lab, n_true))
        dist = np.hypot(cp[:, None, 0] - ct[None, :, 0],
                        cp[:, None, 1] - ct[None, :, 1])
    else:
        dist = np.zeros((n_pred, n_true))
    return iou, dist


def _greedy(ok: np.ndarray) -> int:
    """Greedy unique matching count over a boolean (nPred, nTrue) matrix,
    in the reference's i-then-j scan order."""
    used = np.zeros(ok.shape[1], bool)
    n = 0
    for i in range(ok.shape[0]):
        for j in range(ok.shape[1]):
            if ok[i, j] and not used[j]:
                used[j] = True
                n += 1
                break
    return n


def _images(mask_pred: np.ndarray, mask_target: np.ndarray):
    """(n_pred, n_true, iou, dist) of every foreground class and image."""
    n_class, b_size = mask_pred.shape[:2]
    for c in range(1, n_class):
        for b in range(b_size):
            n_pred, pred_lab = _connected_components(mask_pred[c, b])
            n_true, tar_lab = _connected_components(mask_target[c, b])
            yield (n_pred, n_true) + _pair_stats(pred_lab, n_pred, tar_lab,
                                                 n_true)


def _counts(n_pred, n_true, iou, dist, thresh, distance_thresh):
    """Matched components by IoU and by centre distance."""
    return (_greedy(iou > thresh),
            _greedy(dist < distance_thresh) if n_pred and n_true else 0)


def get_prec_recall_multi(mask_pred: np.ndarray, mask_target: np.ndarray,
                          thresholds, distance_thresholds) -> np.ndarray:
    """mask_pred/mask_target: (C, B, H, W) 0/1 arrays. Every (thresh,
    distance) pair at once, the components and pairwise statistics computed
    once per class and image. Returns (2, len(thresholds)): row 0 the
    IoU-matched (prec + rec) / 2, row 1 the distance-matched one, summed
    over the batch and averaged over the foreground classes (the caller
    divides by the image count, as the reference does)."""
    out = np.zeros((2, len(thresholds)))
    for n_pred, n_true, iou, dist in _images(mask_pred, mask_target):
        for ti, pair in enumerate(zip(thresholds, distance_thresholds)):
            for row, n_corr in enumerate(_counts(n_pred, n_true, iou, dist,
                                                 *pair)):
                p = n_corr / n_pred if n_pred else 1
                r = n_corr / n_true if n_true else 1
                out[row, ti] += (p + r) / 2
    return out / max(mask_pred.shape[0] - 1, 1)


def get_prec_recall(mask_pred: np.ndarray, mask_target: np.ndarray,
                    thresh: float, distance_thresh: float) -> Tuple[float, float]:
    """One (thresh, distance) pair: ((precI + recI) / 2, (precD + recD) /
    2), precision and recall each summed over the batch and averaged over
    the foreground classes first, as the reference sums them."""
    prec_i = rec_i = prec_d = rec_d = 0.0
    for n_pred, n_true, iou, dist in _images(mask_pred, mask_target):
        n_corr_i, n_corr_d = _counts(n_pred, n_true, iou, dist, thresh,
                                     distance_thresh)
        prec_i += n_corr_i / n_pred if n_pred else 1
        rec_i += n_corr_i / n_true if n_true else 1
        prec_d += n_corr_d / n_pred if n_pred else 1
        rec_d += n_corr_d / n_true if n_true else 1
    k = max(mask_pred.shape[0] - 1, 1)
    prec_i, rec_i, prec_d, rec_d = prec_i / k, rec_i / k, prec_d / k, rec_d / k
    return (prec_i + rec_i) / 2, (prec_d + rec_d) / 2


def get_prec_recall_naive(mask_pred: np.ndarray, mask_target: np.ndarray,
                          thresh: float, distance_thresh: float) -> Tuple[float, float]:
    """The reference's loop as written (a full-mask IoU per component
    pair): the cross-check oracle for the fast path."""
    n_class, b_size = mask_pred.shape[:2]
    prec_i = rec_i = prec_d = rec_d = 0.0
    for c in range(1, n_class):
        for b in range(b_size):
            n_pred, pred_lab = _connected_components(mask_pred[c, b])
            n_true, tar_lab = _connected_components(mask_target[c, b])
            used_i = np.zeros(n_true)
            used_d = np.zeros(n_true)
            n_corr_i = n_corr_d = 0
            tars = []
            for j in range(n_true):
                t = tar_lab == (j + 1)
                tx, ty, tw, th = _bounding_rect(t)
                tars.append((t, (tx + tw / 2, ty + th / 2)))
            for i in range(n_pred):
                pred = pred_lab == (i + 1)
                px, py, pw, ph = _bounding_rect(pred)
                pc = (px + pw / 2, py + ph / 2)
                found_i = found_d = False
                for j, (tar, tc) in enumerate(tars):
                    dist = float(np.hypot(pc[0] - tc[0], pc[1] - tc[1]))
                    union = np.logical_or(pred, tar).sum()
                    iou = np.logical_and(pred, tar).sum() / union if union else 0.0
                    if iou > thresh and not found_i and used_i[j] == 0:
                        n_corr_i += 1
                        found_i = True
                        used_i[j] = 1
                    if distance_thresh > dist and not found_d and used_d[j] == 0:
                        n_corr_d += 1
                        found_d = True
                        used_d[j] = 1
            prec_i += n_corr_i / n_pred if n_pred else 1
            rec_i += n_corr_i / n_true if n_true else 1
            prec_d += n_corr_d / n_pred if n_pred else 1
            rec_d += n_corr_d / n_true if n_true else 1
    # the reference divides by (nClass - 1) only; callers divide by the
    # image count at the end
    k = max(n_class - 1, 1)
    prec_i, rec_i, prec_d, rec_d = prec_i / k, rec_i / k, prec_d / k, rec_d / k
    return (prec_i + rec_i) / 2, (prec_d + rec_d) / 2
