"""Training CLI (the JAX package's cli/train.py), so far only its
architecture table, which the evaluation CLI test.py uses too. The training
``main`` belongs to the port's training slice.
"""

from __future__ import annotations


def model_hyper(unet: bool, v2: bool) -> dict:
    """The ROBO-UNet hyperparameters of the reference's train.py:302-307
    table (``--UNet``, ``--v2`` or the flagship); the ``pool``/``v2`` flags
    themselves are the caller's."""
    num_planes = 8
    levels = 3 if unet else (1 if v2 else 2)
    depth = 4
    belly_size = 0 if unet else (9 if v2 else 5)
    class_size = 3 if v2 else 1
    belly_planes = num_planes * 2 ** (depth - 1) if v2 else num_planes * 2 ** depth
    return dict(planes=num_planes, levels=levels, depth=depth,
                belly_size=belly_size, class_size=class_size,
                belly_planes=belly_planes)
