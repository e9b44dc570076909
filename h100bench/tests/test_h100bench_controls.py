"""The controls of ``correct`` on the card, at the cells' own sizes and a
short window: each served cell's control (the program's path one
precision below the configuration's) fails its limit where the program
passes it, and each training cell's control (the reference in TF32) and
fault (the mean over half of each batch) fail one of its numbers. Only on
a machine with a CUDA card:

    python -m pytest h100bench/tests -m cuda
"""

import pytest

from h100bench import calibrate, core

SERVED = ["robo_unet_vga.label_b32", "pb_fcn_vga.label_b32"]
TRAINED = ["robo_unet_vga.train_b128", "pb_fcn_vga.train_legacy_b32"]
SEED = 3_900_000_013


def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own sizes")


def over(readings: dict, limits: dict) -> list:
    """The compared numbers a reading fails (a control reads no K1)."""
    return [k for k, lim in limits.items()
            if k in readings and readings[k] > lim]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", SERVED)
def test_served_control_fails(cell):
    card()
    lim = core.limits(cell)
    assert not over(calibrate.served(cell, SEED, "program", 8, "cuda"), lim)
    assert over(calibrate.served(cell, SEED, "control", 8, "cuda"), lim)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAINED)
def test_training_control_and_fault_fail(cell):
    card()
    lim = core.limits(cell)
    got = dict(calibrate.trained(cell, SEED, True, "cuda"))
    assert not over(got["program"], lim)
    assert over(got["control_tf32"], lim)
    assert over(got["fault_half_batch"], lim)
    unchanged = {**got["program"], "change_gap": 1.0}
    assert over(unchanged, lim)
