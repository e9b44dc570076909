"""Shared helpers of the benchmark's CPU tests: runs of a cell at a size a
test can hold (64x96 frames, a few images), on the CPU, where the port's
kernels run their plain versions.

    python -m pytest h100bench/tests -q
"""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 2 ** 31 + 11   # more than 32 signed bits hold


def small_run(cell_name, seconds=0.3, trace=False, seed=SEED, limits=None,
              **traffic):
    import torch

    from h100bench import core

    man = core.manifest()
    cell = core.workload(man, cell_name)
    cfg = core.config(cell["config"])
    # the training size keeps its share of the frame: half of it where the
    # cell trains at half the frame
    (fh, fw), (th, tw) = cfg["frame"], cfg["train"]["size"]
    cfg["frame"] = [64, 96]
    cfg["train"]["size"] = [64 * th // fh, 96 * tw // fw]
    tr = core.traffic(cell["traffic"])
    if tr["runner"] == "label_pipeline":
        tr.update(log_frames=8, batch=4, warmup_batches=2, sample_batches=2,
                  trace_batches=2)
    else:
        tr.update(train_images=16, val_images=8, batch=4)
    tr.update(traffic)
    return core.Run(cell=cell, config=cfg, traffic=tr,
                    limits=limits or core.limits(cell_name), seed=seed,
                    seconds=seconds, trace=trace, device=torch.device("cpu"),
                    t_start=time.perf_counter())


@pytest.fixture
def cpu_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
