"""Label-propagation training CLI (the JAX package's cli/labelPropTrain.py),
so far only its input builder, which the serving CLI validLabelProp.py uses
too. The training ``main`` belongs to the port's training slice.
"""

from __future__ import annotations

import numpy as np


def build_lp_pairs(imgs: np.ndarray, labs: np.ndarray, num_classes: int):
    """(N, 2, H, W, 3) YUV images + (N, 2, H, W) labels -> (2N, H, W, 3 + C)
    inputs [Y_t, Y_other, Y_t - Y_other, labelToPred(label_other)] and
    (2N, H, W) targets, both temporal directions (reference
    labelPropTrain.py:178-193)."""
    n, _, h, w, _ = imgs.shape
    y = imgs[..., 0]  # (N, 2, H, W) luma channel
    oh = np.eye(num_classes, dtype=np.float32) * 2.0 - 1.0  # labelToPred rows
    inputs = np.zeros((2 * n, h, w, 3 + num_classes), np.float32)
    targets = np.zeros((2 * n, h, w), np.int32)
    for k, (a, b) in enumerate([(0, 1), (1, 0)]):
        inputs[k::2, ..., 0] = y[:, a]
        inputs[k::2, ..., 1] = y[:, b]
        inputs[k::2, ..., 2] = y[:, a] - y[:, b]
        inputs[k::2, ..., 3:] = oh[labs[:, b]]
        targets[k::2] = labs[:, a]
    return inputs, targets
