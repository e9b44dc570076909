"""Profiling helpers: device traces, timing and the analytic FLOPs report
(the JAX package's utils/profiling.py, on ``torch.profiler``).

The reference's performance surface is wall-clock per-forward timing
(tester.py:142-144) plus the analytic ``get_computations`` op counts
(model.py:513-536). This module keeps both and adds ``torch.profiler``
traces for the card's timeline.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import torch


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Profile the block and write its Chrome trace to
    ``log_dir/trace.json`` (chrome://tracing, Perfetto, TensorBoard)."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync_inputs(args) -> None:
    for dev in {a.device for a in args if torch.is_tensor(a)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, iters: int = 50, warmup: int = 2) -> float:
    """Average seconds per call, the work queued on the inputs' devices
    finished before the clock starts and before it stops."""
    for _ in range(warmup):
        fn(*args)
    _sync_inputs(args)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync_inputs(args)
    return (time.perf_counter() - t0) / iters


def interval_union_length(spans: list) -> float:
    """Total length covered by (start, end) intervals, overlaps counted
    once. Device-trace events can overlap across streams, and the [first
    start, last end] wall span counts the idle gaps between launches (for
    a graph whose host launches kernels slower than the card runs them,
    that span reports the launch cadence instead of device time)."""
    if not spans:
        return 0.0
    spans = sorted(spans)
    busy = 0.0
    cur_a, cur_b = spans[0]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return busy + (cur_b - cur_a)


def device_busy_span_us(run: Callable[[], None],
                        min_events: int) -> Optional[float]:
    """The card's busy time over ``run()`` in microseconds, or None.

    Runs ``run`` under ``torch.profiler`` and returns the UNION length of
    the intervals of its CUDA kernel and memory-copy events, not the
    [first start, last end] wall span, which counts the card's idle gaps
    between launches; the card is synchronised before the profiler stops.
    Returns None when no CUDA device is present, when tracing fails, or
    when fewer than ``min_events`` device events landed (or they cover no
    time): callers treat None as no measurement.
    """
    if not torch.cuda.is_available():
        return None
    try:
        from torch.autograd import DeviceType
        from torch.profiler import profile

        with profile(activities=_activities()) as prof:
            run()
            torch.cuda.synchronize()
        spans = [(e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(spans) < min_events:
            return None
        busy = interval_union_length(spans)
        return busy if busy > 0 else None
    except Exception:
        return None


def flops_report(model, params=None, pruned: bool = False) -> str:
    """Analytic per-layer op counts for supported families (ROBO-UNet)."""
    from robocupvision_tpu_torch.models import zoo

    if model.family != "robo_unet":
        return f"(no analytic FLOPs model for family {model.family})"
    comp = zoo.robo_unet_get_computations(model.cfg, params, pruned)
    lines = [f"  layer {i:2d}: {c / 1e6:9.2f} MFLOPs" for i, c in enumerate(comp)]
    lines.append(f"  total   : {sum(comp) / 1e6:9.2f} MFLOPs")
    return "\n".join(lines)
