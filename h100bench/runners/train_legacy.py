"""trainer.py's loop (``train_segmenter``): ``run_plateau_training`` over
``Trainer.train_epoch`` / ``valid_epoch`` with SGD (momentum, weight
decay), ReduceLROnPlateau with its rollback to the best params, best-epoch
selection on the validation loss, and the legacy augmentation (flips and
an RGB ColorJitter whose four ops take an order of each sample's own).
The weights come from the seed in place of classTrainer's checkpoint, and
the best params are kept in memory (``save_fn``/``load_fn``) instead of a
file.

Set-up is ``trainkit.Kit``'s. The window runs the plateau loop, which
hands each epoch's losses to its plotter; the benchmark's plotter ends the
loop at the first epoch end after ``seconds`` have passed.
"""

from __future__ import annotations

import contextlib
import io
import time

import torch

from h100bench import core, trainkit


class WindowClosed(Exception):
    pass


class Clock:
    """The plateau loop's plotter: counts epochs and closes the window."""

    def __init__(self, t0: float, seconds: float):
        self.t0, self.seconds, self.epochs = t0, seconds, 0

    def plot(self, var, split, x, y) -> None:
        if split != "val":
            return
        self.epochs += 1
        if time.perf_counter() - self.t0 >= self.seconds:
            raise WindowClosed


def run(r: core.Run) -> None:
    from robocupvision_tpu_torch.train.legacy import run_plateau_training

    kit = trainkit.Kit(r)
    kit.warm_up()
    r.setup_s = time.perf_counter() - r.t_start
    best = {}
    t0 = time.perf_counter()
    clock = Clock(t0, r.seconds)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            run_plateau_training(
                kit.tr, 1 << 30, kit.lr, "", patience=r.traffic["patience"],
                select="loss", save_fn=lambda p: best.update(p=p),
                load_fn=lambda: best.get("p"), plotter=clock)
    except WindowClosed:
        pass
    if r.device.type == "cuda":
        torch.cuda.synchronize()
    kit.end_window(t0, clock.epochs)
    kit.traced_epoch()
    kit.judge()
