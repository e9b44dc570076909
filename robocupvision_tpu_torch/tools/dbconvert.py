"""Segmentation labels -> detection DB + anchor clustering (the JAX
package's tools/dbconvert.py; host only, no device).

The reference's DBConvert.py:26-150: per class, external contours of the
label mask with area filters (ball>=25, robot>=200, goal>=30), relative-area
cut (5% of max; 20% for goals), per-class caps (6 balls / 5 robots / 2
goals), bounding boxes; then anchors: mean ball box, KMeans(5) robot boxes,
KMeans(2) goal boxes -> bMean/rMean/gMean.npy + preds.pickle.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
import sys
from typing import List

import numpy as np

from robocupvision_tpu_torch.data.datasets import _list_pngs, load_label


def _contour_boxes(mask: np.ndarray):
    """External-contour bounding boxes + areas (cv2 if present, else scipy)."""
    try:
        import cv2

        res = cv2.findContours(mask.astype(np.uint8), mode=cv2.RETR_EXTERNAL,
                               method=cv2.CHAIN_APPROX_SIMPLE)
        cont = res[0] if len(res) == 2 else res[1]
        out = []
        for c in cont:
            out.append((float(cv2.contourArea(c)), cv2.boundingRect(c)))
        return out
    except ImportError:  # pragma: no cover
        from scipy import ndimage

        lab, n = ndimage.label(mask)
        out = []
        for i in range(1, n + 1):
            ys, xs = np.nonzero(lab == i)
            area = float(len(xs))
            out.append((area, (int(xs.min()), int(ys.min()),
                               int(xs.max() - xs.min() + 1),
                               int(ys.max() - ys.min() + 1))))
        return out


CLASS_RULES = {  # class id -> (min area, relative cut, cap)
    1: (25, 0.05, 6),   # ball
    2: (200, 0.05, 5),  # robot
    3: (30, 0.2, 2),    # goal
}


def detect_objects(label: np.ndarray) -> List:
    """Per-image detection list [[cls, box-array], ...] per the reference rules."""
    pred = []
    for cls, (min_area, rel, cap) in CLASS_RULES.items():
        mask = (label == cls).astype(np.uint8)
        cands = [(a, b) for a, b in _contour_boxes(mask) if a > min_area]
        max_area = max((a for a, _ in cands), default=0)
        kept = 0
        for area, box in sorted(cands, key=lambda t: t[0]):
            if area >= max_area * rel and kept < cap:
                pred.append([cls, np.asarray(box)])
                kept += 1
    return pred


def _kmeans(x: np.ndarray, k: int) -> np.ndarray:
    try:
        from sklearn.cluster import KMeans

        return KMeans(k, n_init=10, random_state=0).fit(x).cluster_centers_
    except ImportError:  # pragma: no cover — tiny Lloyd's fallback
        rng = np.random.default_rng(0)
        centers = x[rng.choice(len(x), min(k, len(x)), replace=False)]
        for _ in range(50):
            d = ((x[:, None] - centers[None]) ** 2).sum(-1)
            assign = d.argmin(1)
            centers = np.stack([x[assign == i].mean(0) if (assign == i).any()
                                else centers[i] for i in range(len(centers))])
        return centers


def convert(root: str, split: str = "val") -> None:
    data_dir = osp.join(root, split)
    lab_dir = osp.join(data_dir, "labels")
    img_dir = osp.join(data_dir, "images")
    labels = _list_pngs(lab_dir)
    images = _list_pngs(img_dir)

    preds = []
    for lab_file, img_file in zip(labels, images):
        label = load_label(osp.join(lab_dir, lab_file))
        preds.append([img_file] + detect_objects(label))

    rects = {1: [], 2: [], 3: []}
    for pred in preds:
        for item in pred[1:]:
            rects[item[0]].append(item[1])

    ball = np.asarray(rects[1], np.float64).reshape(-1, 4)
    robot = np.asarray(rects[2], np.float64).reshape(-1, 4)
    goal = np.asarray(rects[3], np.float64).reshape(-1, 4)

    np.save(osp.join(data_dir, "bMean.npy"),
            ball.mean(0) if len(ball) else np.zeros(4))
    np.save(osp.join(data_dir, "rMean.npy"),
            _kmeans(robot, 5) if len(robot) >= 5 else robot)
    np.save(osp.join(data_dir, "gMean.npy"),
            _kmeans(goal, 2) if len(goal) >= 2 else goal)
    with open(osp.join(data_dir, "preds.pickle"), "wb") as f:
        pickle.dump(preds, f)
    print(f"{split}: {len(preds)} images, "
          f"{len(ball)} balls / {len(robot)} robots / {len(goal)} goals")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Labels -> detection DB + anchors")
    p.add_argument("--root", type=str,
                   default=os.environ.get("ROBOCUP_DATA", "./data"))
    p.add_argument("--splits", nargs="*", default=["train", "val"])
    p.add_argument("--finetune", action="store_true",
                   help="also convert the FinetuneHorizon tree")
    opt = p.parse_args(argv)
    for split in opt.splits:
        convert(opt.root, split)
        if opt.finetune:
            convert(osp.join(opt.root, "FinetuneHorizon"), split)
    return 0


if __name__ == "__main__":
    sys.exit(main())
