"""Whole runs of each cell on the CPU at a small size (the harness's look
for a card skipped): sound, ``correct`` comes out true; with the timed
path broken underneath in each way the cell can break, it comes out
false. The served cells take their own limits (limits/<workload>.json),
the training cells limits for the small size."""

import pytest
import torch

from conftest import small_run
from h100bench import core

LABEL = ["robo_unet_vga.label_b32", "pb_fcn_vga.label_b32"]
TRAIN = ["robo_unet_vga.train_b128", "pb_fcn_vga.train_legacy_b32"]
# a training cell's limits hold at its own size; at 32x48 and b4 the
# deepest BatchNorms see a few pixels, and sound runs read up to about a
# tenth of these
SMALL_TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 0.1,
                      "k1_count_gap": 0.0}


def drive(cell):
    r = small_run(cell, seconds=0.3,
                  limits=SMALL_TRAIN_LIMITS if cell in TRAIN else None)
    core.load_module("runners", r.traffic["runner"]).run(r)
    return r


@pytest.mark.parametrize("cell", LABEL + TRAIN)
def test_sound_run_is_correct(cell, cpu_threads):
    r = drive(cell)
    assert r.correct, r.compared
    assert r.attempted > 0 and r.failed == 0


def broken_serving(monkeypatch, how):
    from robocupvision_tpu_torch.models import packed

    plain = packed._PackedBase.infer_u8_io

    def infer_u8_io(self, x):
        if how == "half_batch":     # half the frames served, copied over
            n = x.shape[0] // 2
            lab = plain(self, x[:n])
            return torch.cat([lab, lab])
        lab = plain(self, x).clone()
        lab[0] = (lab[0] + 1) % 5   # one frame's answer altered
        return lab

    monkeypatch.setattr(packed._PackedBase, "infer_u8_io", infer_u8_io)


@pytest.mark.parametrize("how", ["half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", LABEL)
def test_broken_serving_is_caught(cell, how, monkeypatch, cpu_threads):
    broken_serving(monkeypatch, how)
    r = drive(cell)
    assert not r.correct, r.compared


def broken_step(monkeypatch, how):
    from robocupvision_tpu_torch.train import step as tstep

    make = tstep.make_train_step

    def make_train_step(*args, **kw):
        step = make(*args, **kw)

        def broken(state, imgs, tgt, mask, draws, *rest):
            if how == "unchanged":        # the state comes back as it was
                _, out = step(state, imgs, tgt, mask, draws, *rest)
                return state, out
            n = imgs.shape[0] // 2        # the mean over half the batch
            half = {k: v[:n] for k, v in draws.items()}
            return step(state, imgs[:n], tgt[:n], mask[:n], half, *rest)

        return broken

    monkeypatch.setattr(tstep, "make_train_step", make_train_step)


@pytest.mark.parametrize("how", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN)
def test_broken_step_is_caught(cell, how, monkeypatch, cpu_threads):
    broken_step(monkeypatch, how)
    r = drive(cell)
    assert not r.correct, r.compared
