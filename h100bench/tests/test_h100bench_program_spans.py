"""The readers of the program's spans and counters (metrics/*.py through
program_spans.py) against a hand-built ``trace.Trace`` and spans the
port's tracer recorded in a CPU profiler session on a clock the test sets:
per-batch and per-step means, self times, the filter to the traced
window, the card's idle time inside a step, and None where nothing was
recorded."""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100bench import core, trace

LABEL = ["copy_in_ms.label", "fetch_wait_ms.label", "fetch_copy_ms.label",
         "plain_host_ms.label", "k2_host_ms.label", "k2_chains.label"]
TRAIN = ["step_host_ms.train", "step_idle_ms.train", "augment_card_ms.train",
         "update_card_ms.train"]


@pytest.fixture
def prof(monkeypatch):
    """The port's tracer, cleared, on a clock the test sets (``at``), with
    CUDA timing events that read the card's time as half the host's."""
    from robocupvision_tpu_torch.utils import profiling

    now = [0.0]

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self, stream=None):
            self.t = now[0]

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3 * 0.5

    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter=lambda: now[0]))
    monkeypatch.setattr(torch.cuda, "Event", Event)
    profiling.reset()

    def at(t):
        now[0] = float(t)

    yield profiling, at
    profiling.reset()


def session():
    return profile(activities=[ProfilerActivity.CPU])


def read(name, run):
    return core.load_module("metrics", name).read(run)


def run_of(window, device=()):
    return types.SimpleNamespace(traced=trace.Trace(window, list(device),
                                                    []))


def batch(p, at, t, seq, wait=True):
    """One served batch from ``t``: copy-in 2 s, enqueue 5 s holding two
    chains of 1 s, then the fetch of the batch before it, 4 s with a wait
    of 3 s."""
    at(t)
    with p.span("serve.submit", req=seq):
        with p.span("serve.copy_in"):
            at(t + 2)
        with p.span("serve.enqueue"):
            for k, tag in enumerate(("down", "up")):
                with p.span("k2.chain", tag=tag):
                    p.count("k2.chains")
                    at(t + 3 + k)
            at(t + 7)
        with p.span("serve.fetch", req=seq - 1):
            if wait:
                with p.span("serve.fetch_wait"):
                    at(t + 10)
            at(t + 11)


def test_label_readers(prof):
    p, at = prof
    with session():
        batch(p, at, 100, 0)
        batch(p, at, 120, 1)
    got = {m: read(m, run_of((99, 200))) for m in LABEL}
    assert got == {"copy_in_ms.label": 2e3, "fetch_wait_ms.label": 3e3,
                   "fetch_copy_ms.label": 1e3, "plain_host_ms.label": 3e3,
                   "k2_host_ms.label": 2e3, "k2_chains.label": 2.0}


def test_label_readers_keep_the_traced_window(prof):
    """Spans outside the window are left out (the counter is the
    process's total: the traced segment alone in a run)."""
    p, at = prof
    with session():
        batch(p, at, 10, 0)        # before the window
        batch(p, at, 100, 1)
        batch(p, at, 120, 2, wait=False)
        batch(p, at, 300, 3)       # after it
    run = run_of((99, 200))
    assert read("copy_in_ms.label", run) == 2e3
    assert read("fetch_wait_ms.label", run) == 3e3 / 2   # one wait in two
    assert read("fetch_copy_ms.label", run) == (1e3 + 4e3) / 2
    assert read("k2_chains.label", run) == 8 / 2


def test_train_readers(prof):
    """Two steps of 10 s, phases of 1, 2, 3 and 4 s timed on the card at
    half that; the card busy 3 + 5 s of the first step and all of the
    second."""
    p, at = prof
    with session():
        for t0, req in ((50, 0), (60, 1)):
            at(t0)
            with p.span("train.step", req=req):
                t = t0
                for name, d in (("step.augment", 1), ("step.forward", 2),
                                ("step.backward", 3), ("step.update", 4)):
                    with p.span(name, card=True):
                        t += d
                        at(t)
    device = [("k", 50, 53), ("k", 55, 60), ("k", 59, 70)]
    run = run_of((40, 80), device)
    assert read("step_host_ms.train", run) == 10e3
    assert read("step_idle_ms.train", run) == 2e3 / 2
    assert read("augment_card_ms.train", run) == 0.5e3
    assert read("update_card_ms.train", run) == 2e3
    # the step before the window is left out
    assert read("step_idle_ms.train", run_of((59, 80), device)) == 0.0


@pytest.mark.parametrize("name", LABEL + TRAIN)
def test_none_without_spans(prof, name, monkeypatch):
    p, at = prof
    assert read(name, types.SimpleNamespace(traced=None)) is None
    run = run_of((0, 1))
    assert read(name, run) is None                  # nothing recorded
    with session():
        batch(p, at, 10, 0)
    assert read(name, run) is None                  # outside the window
    monkeypatch.delattr(p, "spans")                 # a program without them
    assert read(name, run_of((0, 100))) is None
