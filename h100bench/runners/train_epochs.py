"""train.py's loop: ``Trainer.train_epoch`` then ``valid_epoch``, epoch
after epoch (Adam, the L1 term, train.py's flip and YUV jitter, validation
scored on K1), on a training set held on the card (``DeviceCache``).

Set-up is ``trainkit.Kit``'s: the checked first steps and one validation.
The window runs whole epochs, each with its validation, until ``seconds``
have passed; its images are the training images of those epochs, and its
time holds their validations too.
"""

from __future__ import annotations

import time

import torch

from h100bench import core, trainkit


def run(r: core.Run) -> None:
    kit = trainkit.Kit(r)
    kit.warm_up()
    r.setup_s = time.perf_counter() - r.t_start
    t0, epochs = time.perf_counter(), 0
    while time.perf_counter() - t0 < r.seconds:
        kit.tr.train_epoch(kit.lr)
        kit.tr.valid_epoch()
        epochs += 1
    if r.device.type == "cuda":
        torch.cuda.synchronize()
    kit.end_window(t0, epochs)
    kit.traced_epoch()
    kit.judge()
