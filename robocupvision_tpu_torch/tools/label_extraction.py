"""UETrainingSetGenerator masks -> PNG label images (the JAX package's
tools/label_extraction.py; host only, no device).

The reference's labelExtraction.py:21-164 (with its hard-coded Windows paths
made into arguments): reads per-image .txt grids of legend ids, a .leg legend
file mapping cumulative id ranges to tag names, and LabelConfig.cfg mapping
tags to class ids; writes label PNGs. The optional majority-filter denoise
(labelExtraction.py:70-88) is vectorized here (the reference's 480x640x16
python loop).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import re
import sys
from typing import Dict

import numpy as np


def numerical_key(value: str):
    parts = re.split(r"(\d+)", value)
    return [int(p) if p.isdigit() else p for p in parts]


def load_label_config(path: str) -> Dict[str, int]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            tag, _, cls = line.partition(":")
            out[tag] = int(cls)
    return out


def load_legend(path: str) -> Dict[int, str]:
    """Cumulative-range legend: 'count:tag count:tag ...' ->
    {cumulative_end: tag}."""
    out = {}
    with open(path) as f:
        data = f.readline().split(" ")
    idx = 0
    for item in data:
        item = item.strip()
        if ":" not in item:
            continue
        count, tag = item.split(":", 1)
        idx += int(count)
        out[idx] = tag
    return out


def id_to_class_table(legend: Dict[int, str], label_cfg: Dict[str, int],
                      max_id: int) -> np.ndarray:
    """Precompute pixel-id -> class-id lookup (replaces per-pixel dict walks)."""
    table = np.zeros(max_id + 1, np.uint8)
    bounds = sorted(legend)
    for pid in range(1, max_id + 1):
        tag = None
        for b in bounds:
            if pid - 1 < b:
                tag = legend[b]
                break
        if tag is not None and tag in label_cfg:
            table[pid] = label_cfg[tag]
    return table


def majority_filter(mask: np.ndarray, win: int = 4, hi: int = 15,
                    lo: int = 7, num_classes: int = 5) -> np.ndarray:
    """Vectorized version of the reference's __filterMask: per pixel, the
    class histogram over a 4x4 neighborhood; replace with the argmax when the
    max count >= hi or the pixel's own class count < lo."""
    h, w = mask.shape
    counts = np.zeros((num_classes, h, w), np.int32)
    pad = np.full((h + win, w + win), -1, np.int64)
    pad[2:2 + h, 2:2 + w] = mask  # offsets -2..1 like the reference
    for dy in range(win):
        for dx in range(win):
            window = pad[dy:dy + h, dx:dx + w]
            for c in range(num_classes):
                counts[c] += window == c
    max_idx = counts.argmax(0)
    max_val = counts.max(0)
    own = np.take_along_axis(counts, mask[None].astype(np.int64), 0)[0]
    replace = (max_val >= hi) | (own < lo)
    return np.where(replace, max_idx, mask).astype(np.uint8)


def extract(mask_dir: str, out_dir: str, height: int = 480, width: int = 640,
            denoise: bool = False) -> int:
    from PIL import Image

    masks = sorted([f for f in os.listdir(mask_dir) if f.endswith(".txt")],
                   key=numerical_key)
    legs = [f for f in os.listdir(mask_dir) if f.endswith(".leg")]
    label_cfg = load_label_config(osp.join(mask_dir, "LabelConfig.cfg"))
    legend = load_legend(osp.join(mask_dir, legs[0]))
    table = id_to_class_table(legend, label_cfg, max(legend))

    os.makedirs(out_dir, exist_ok=True)
    for i, name in enumerate(masks):
        grid = np.loadtxt(osp.join(mask_dir, name), dtype=np.int64,
                          max_rows=height)
        grid = grid.reshape(height, width)
        lab = table[np.clip(grid, 0, len(table) - 1)]
        if denoise:
            lab = majority_filter(lab)
        Image.fromarray(lab).save(
            osp.join(out_dir, name.rsplit(".", 1)[0] + ".png"))
    return len(masks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="UE masks -> label PNGs")
    p.add_argument("--maskDir", required=True)
    p.add_argument("--outDir", required=True)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--denoise", action="store_true")
    opt = p.parse_args(argv)
    n = extract(opt.maskDir, opt.outDir, opt.height, opt.width, opt.denoise)
    print(f"extracted {n} label images to {opt.outDir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
