"""Profiling: the program's spans and counters, device traces, and the
card's busy time (the JAX package's utils/profiling.py, on
``torch.profiler``).

The tracer records where the program's time goes, from inside it:
``span(name)`` around a stretch of work (name, start and end on
``time.perf_counter()``, the span open around it on the same thread, the
request ``req`` it serves), ``count(name)`` at the same places. It records
exactly while a ``torch.profiler`` session records on the calling thread
(``recording()``), whatever activities the session traces, and keeps its
records in memory (``spans()``, ``counters()``, ``reset()``); outside a
session a span or a count costs one check and allocates nothing.
``device_trace`` writes a block's Chrome trace and its spans.

The program's spans:

    serve.submit > serve.copy_in, serve.enqueue   a batch into the serving
        pipeline (utils/serving.py); req: the batch's sequence number
    serve.fetch > serve.fetch_wait                the oldest batch's labels
        to the host; req: that batch's number
    k2.chain (tag: the chain's name)              one fused-chain call
        (models/packed.py); counter ``k2.chains``
    train.epoch, train.valid_epoch                a Trainer epoch of train
        steps and its validation (train/loop.py); req: the epoch
    train.step > step.augment, step.forward, step.backward, step.update
        one train step and its phases (train/step.py), the phases timed
        on the card as well; req: the step's number
    seg.encoder, then seg.decoder
        one SegFormer forward (models/segformer.py), the encoder and the
        decoder timed on the card as well

and counters ``k4.calls``: one call of K4, the legacy augmentation on the
card (ops/cuda_kernels.py ``legacy_jitter``); ``mit.attn``: one attention
call of a SegFormer block; ``k5.calls``: one call of K5, the SegFormer's
folded head gathered on the card (ops/cuda_kernels.py ``seg_head``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

# -- the tracer -----------------------------------------------------------------

_enabled = torch._C._autograd._profiler_enabled


def recording() -> bool:
    """True while a ``torch.profiler`` session records on this thread: the
    tracer records exactly then."""
    return _enabled()


_spans: List["Span"] = []
_counts: Dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()


class Span:
    """One recorded span. Times are ``time.perf_counter()`` seconds;
    ``parent`` is the span open around it on its thread when it opened,
    ``req`` its own or, by default, the parent's."""

    __slots__ = ("name", "req", "tag", "t0", "t1", "parent", "thread",
                 "_child_s", "_events")

    def __init__(self, name: str, req: Any, tag: Optional[str], card: bool):
        self.name, self.req, self.tag = name, req, tag
        self.t0 = self.t1 = None
        self.parent: Optional[Span] = None
        self.thread = threading.get_ident()
        self._child_s = 0.0
        self._events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True)) if card else None

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent = stack[-1]
            if self.req is None:
                self.req = self.parent.req
        stack.append(self)
        _spans.append(self)
        if self._events is not None:
            self._events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        if self._events is not None:
            self._events[1].record()
        _local.stack.pop()
        if self.parent is not None:
            self.parent._child_s += self.t1 - self.t0
        return False

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    @property
    def self_ms(self) -> float:
        """The host time its child spans do not cover."""
        return self.host_ms - self._child_s * 1e3

    @property
    def card_ms(self) -> Optional[float]:
        """For a span opened with ``card=True``: the current CUDA stream's
        time from a marker event recorded as the span opened to one
        recorded as it closed (waits for the second), so the card's time
        of the span's work where the host runs ahead of the card; where the
        host sets the pace, it includes the card's idle time in between.
        None otherwise."""
        if self._events is None:
            return None
        start, end = self._events
        end.synchronize()
        return start.elapsed_time(end)

    def as_dict(self) -> dict:
        return {"name": self.name, "req": self.req, "tag": self.tag,
                "t0": self.t0, "t1": self.t1, "thread": self.thread,
                "host_ms": self.host_ms, "self_ms": self.self_ms,
                "card_ms": self.card_ms}


_OFF = contextlib.nullcontext()   # the span while nothing records


def span(name: str, req: Any = None, card: bool = False,
         tag: Optional[str] = None):
    """A context manager recording the block as span ``name`` (with ``as``:
    the ``Span``, or None while nothing records). ``req``: the request the
    block serves (default: the parent span's). ``card=True``: the block
    queues work on the current CUDA stream, and the span also times that
    stream (``Span.card_ms``). ``tag``: a label of the span's own."""
    if not _enabled():
        return _OFF
    return Span(name, req, tag, card)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while the tracer records."""
    if not _enabled():
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def spans() -> List[Span]:
    """The closed spans recorded since the last ``reset()``, in the order
    they opened."""
    return [s for s in _spans if s.t1 is not None]


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset() -> None:
    """Forget every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _counts.clear()


def _write_spans(path: str, t0: float, counts0: Dict[str, int]) -> None:
    got = [s for s in spans() if s.t0 >= t0]
    index = {id(s): i for i, s in enumerate(got)}
    rows = [{**s.as_dict(), "parent": index.get(id(s.parent))} for s in got]
    now = counters()
    counts = {k: v - counts0.get(k, 0) for k, v in now.items()
              if v != counts0.get(k, 0)}
    with open(path, "w") as f:
        json.dump({"spans": rows, "counters": counts}, f, default=str)


# -- device traces --------------------------------------------------------------


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Profile the block and write its Chrome trace to
    ``log_dir/trace.json`` (chrome://tracing, Perfetto, TensorBoard), and
    the program's spans and counters of the block to ``log_dir/spans.json``
    (``{"spans": [...], "counters": {...}}``; a span's ``parent`` is its
    parent's index in the list, or null)."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    t0, counts0 = time.perf_counter(), counters()
    with profile(activities=_activities()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    _write_spans(os.path.join(log_dir, "spans.json"), t0, counts0)


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
