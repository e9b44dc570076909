"""Label tables used when scoring served frames: the class-ablation remap
and the colour palette (copied from the JAX package's ops/labels.py)."""

from __future__ import annotations

import numpy as np
import torch


def mask_label_table(nb: bool, nr: bool, ng: bool, nl: bool) -> np.ndarray:
    """Lookup table equivalent to the reference remap cascade on ids 0..4."""
    lab = np.arange(5)
    b_num, r_num, g_num, l_num = 1, 2, 3, 4
    if nb:
        lab[lab == b_num] = 0
        lab[lab > b_num] -= 1
        r_num, g_num, l_num = 1, 2, 3
    if nr:
        lab[lab == r_num] = 0
        lab[lab > r_num] -= 1
        g_num, l_num = 1, 2
    if ng:
        lab[lab == g_num] = 0
        lab[lab > g_num] -= 1
        l_num = 1
    if nl:
        lab[lab == l_num] = 0
    return lab.astype(np.int32)


def mask_label(label: torch.Tensor, nb: bool, nr: bool, ng: bool,
               nl: bool) -> torch.Tensor:
    """Remap labels per class-ablation flags (one gather through the table)."""
    if not (nb or nr or ng or nl):
        return label
    table = torch.as_tensor(mask_label_table(nb, nr, ng, nl),
                            device=label.device)
    return table[label.long()]


def label_colormap(n: int = 5) -> np.ndarray:
    """5-class palette: bg black, ball blue, robot green, goal red, line white."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    full = [(0, 0, 0), (0, 0, 255), (0, 255, 0), (255, 0, 0), (255, 255, 255)]
    for i in range(min(n, 5)):
        cmap[i] = full[i]
    return cmap


def colorize(label: np.ndarray, n: int = 5) -> np.ndarray:
    """Label map (H, W) -> RGB uint8 (H, W, 3)."""
    cmap = label_colormap(n)
    return cmap[np.asarray(label).astype(np.int64).clip(0, n - 1)]
