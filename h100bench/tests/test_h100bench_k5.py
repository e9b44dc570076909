"""The reader of K5's calls, ``k5_calls.label``: the program's counter
``k5.calls`` a served batch, on spans the port's tracer recorded in a CPU
profiler session on a clock the test sets; 0 where the program never
counts it, as before K5; None without the tracer's records. Then the
folded head through the served pipeline on the CPU, where K5's plain
version runs and counts nothing."""

import time
import types

import numpy as np

from test_h100bench_program_spans import prof, read, run_of, session  # noqa: F401


def served(p, at, t, k5: bool):
    """One served batch from ``t``: the enqueue holds the encoder's and
    the decoder's spans, the decoder one K5 call when ``k5``."""
    at(t)
    with p.span("serve.enqueue"):
        with p.span("seg.encoder", card=True):
            at(t + 6)
        with p.span("seg.decoder", card=True):
            if k5:
                p.count("k5.calls")
            at(t + 8)


def test_one_call_a_batch(prof):
    p, at = prof
    with session():
        for t in (100, 120, 140):
            served(p, at, t, True)
    assert read("k5_calls.label", run_of((99, 200))) == 1.0


def test_zero_without_the_counter(prof):
    p, at = prof
    with session():
        for t in (100, 120):
            served(p, at, t, False)
    assert read("k5_calls.label", run_of((99, 200))) == 0.0


def test_none_without_the_tracer(prof, monkeypatch):
    p, at = prof
    assert read("k5_calls.label", types.SimpleNamespace(traced=None)) is None
    with session():
        served(p, at, 100, True)
    assert read("k5_calls.label", run_of((0, 50))) is None   # no batch
    monkeypatch.delattr(p, "spans")                 # a program without them
    assert read("k5_calls.label", run_of((99, 200))) is None


def test_cpu_pipeline_counts_no_kernel_call(cpu_threads):
    """On the CPU the served graph gathers its folded head through K5's
    plain version: 16 attention calls a batch, no K5 call."""
    from robocupvision_tpu_torch.models import segformer, zoo
    from robocupvision_tpu_torch.utils import profiling
    from robocupvision_tpu_torch.utils.serving import ServingPipeline

    model = zoo.make("segformer", device="cpu")
    pi = segformer.build_segformer_infer(model, device="cpu")
    frames = np.zeros((2, 1, 32, 64, 3), np.uint8)
    profiling.reset()
    try:
        with session():
            list(ServingPipeline(pi.infer_u8_io, device="cpu").map(frames))
        run = run_of((0, time.perf_counter() + 1))
        assert read("attn_calls.label", run) == 16.0
        assert read("k5_calls.label", run) == 0.0
    finally:
        profiling.reset()
