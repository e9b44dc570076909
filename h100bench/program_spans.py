"""The program's own spans and counters, as the per-layer readers take
them: the records of the port's tracer (``utils/profiling.py``: ``spans()``
and ``counters()``), which records while ``torch.profiler`` runs, so in
the runners' traced segment. A reader keeps the spans inside the traced
window; a program without the tracer, or a run without a traced segment,
gives None.

The counters are totals over everything the tracer recorded in the
process: in a run of the benchmark, the traced segment alone."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple


def recorded(run) -> Optional[Tuple[list, Dict[str, int]]]:
    """(the program's spans inside ``run.traced.window``, its counters),
    or None."""
    t = run.traced
    if t is None:
        return None
    try:
        from robocupvision_tpu_torch.utils import profiling
        spans, counters = profiling.spans, profiling.counters
    except (ImportError, AttributeError):
        return None
    a, b = t.window
    return [s for s in spans() if s.t0 >= a and s.t1 <= b], counters()


def named(spans: list, name: str) -> List:
    return [s for s in spans if s.name == name]


def per_span(run, name: str, value: Callable, per: str = None
             ) -> Optional[float]:
    """The sum of ``value(span)`` over the window's spans ``name`` (values
    of None left out) over the number of its spans ``per`` (default:
    ``name``); None where either is missing."""
    got = recorded(run)
    if got is None:
        return None
    spans = got[0]
    vals = [v for v in map(value, named(spans, name)) if v is not None]
    n = len(named(spans, per or name))
    return sum(vals) / n if vals and n else None


def per_batch_count(run, counter: str) -> Optional[float]:
    """Counter ``counter`` over the window's served batches (its
    ``serve.enqueue`` spans); None where either is missing."""
    got = recorded(run)
    if got is None:
        return None
    spans, counts = got
    n = len(named(spans, "serve.enqueue"))
    return counts[counter] / n if n and counts.get(counter) else None
