"""The traced segment: ``torch.profiler`` over a stretch of a cell's work,
reduced to the card's intervals by name and the benchmark's own spans.

Only the card's activity is recorded (kernels, copies, sets): recording
every host op as well would slow the host's launches and read as idle
card time that an untraced run does not have. The benchmark's own spans
are host-clock intervals (``core.Span``) the runners record around their
calls into the program. The two clocks are tied by marker kernels
(``torch.cuda._sleep``) launched on an idle card before and after the
segment. Busy time is the union of the card's intervals (overlaps counted
once); each idle gap of the card is laid to the innermost span open on the
host at its middle (``_no_span_`` when none is).
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

Interval = Tuple[float, float]
MARKER = "spin_kernel"


def union_length(spans: List[Interval]) -> float:
    """Total length covered by (start, end) intervals, overlaps once (the
    arithmetic of the program's utils/profiling.interval_union_length)."""
    merged = _merged(spans)
    return sum(b - a for a, b in merged)


def _merged(spans: List[Interval]) -> List[Interval]:
    out: List[list] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "Memory"))


@dataclasses.dataclass
class Trace:
    """Times in seconds on the host's ``perf_counter`` clock."""
    window: Interval
    device: List[Tuple[str, float, float]]   # (name, start, end)
    spans: List[Tuple[str, float, float]]    # the benchmark's own spans
    align_error_s: float = 0.0   # markers' worst card-host disagreement

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def clipped(self, a: float, b: float) -> List[Interval]:
        return [(max(s, a), min(e, b)) for _, s, e in self.device
                if e > a and s < b]

    def busy_s(self, a: float = None, b: float = None) -> float:
        a = self.window[0] if a is None else a
        b = self.window[1] if b is None else b
        return union_length(self.clipped(a, b))

    def kernels(self, match: Callable[[str], bool] = lambda n: True):
        return [(n, s, e) for n, s, e in self.device
                if is_kernel(n) and match(n)]

    def span_list(self, name: str) -> List[Interval]:
        return [(s, e) for n, s, e in self.spans if n == name]

    def top_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            tot[n] += e - s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:96], t] for n, t in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle time of the card inside the window, by the innermost span
        open at each gap's middle."""
        a0, b0 = self.window
        gaps, t = [], a0
        for s, e in _merged(self.clipped(a0, b0)):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if b0 > t:
            gaps.append((t, b0))
        spans = sorted(self.spans, key=lambda x: x[1])
        tot: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inner = [(n, ss, ee) for n, ss, ee in spans if ss <= mid <= ee]
            name = min(inner, key=lambda x: x[2] - x[1])[0] if inner \
                else "_no_span_"
            tot[name] += e - s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t] for n, t in top]


# the markers' lengths in clock cycles, two before the segment and two
# after, each four times the last: at any SM clock from 1 to 2 GHz each is
# told from the others by its length on the card alone, so a marker the
# profiler misses leaves the others usable
MARKER_CYCLES = (10_000, 40_000, 160_000, 640_000)
CLOCK_HZ = 1.5e9


def _marker(cycles: int) -> Tuple[float, float]:
    """Launch a marker kernel on an idle card; the host times of the
    launch and of its end."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    return t, time.perf_counter()


def _offset(marks, hosts) -> float:
    """The card clock less the host clock, from the markers the profiler
    recorded (start, length), each matched to the launch whose length in
    cycles lies nearest its own (in proportion)."""
    offs = []
    for s, d in marks:
        i = min(range(len(MARKER_CYCLES)), key=lambda j: abs(
            math.log(max(d, 1e-9) * CLOCK_HZ / MARKER_CYCLES[j])))
        offs.append(s - hosts[i])
    offs.sort()
    return offs[len(offs) // 2]


def profile(fn: Callable[[], None], spans) -> Trace:
    """Run ``fn`` under the profiler (the card's activity only); ``spans``:
    the list of ``core.Span`` the runners append to while ``fn`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    _marker(MARKER_CYCLES[0])   # loads the marker's kernel before timing it
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        starts = [_marker(c) for c in MARKER_CYCLES[:2]]
        fn()
        ends = [_marker(c) for c in MARKER_CYCLES[2:]]
    hosts = [t for t, _ in starts + ends]
    t0, t1 = starts[-1][1], ends[0][0]
    events = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [(s, e - s) for n, s, e in events if MARKER in n]
    if not marks:
        raise RuntimeError("the profiler recorded no marker kernels")
    off = _offset(marks, hosts)
    device = [(n, s - off, e - off) for n, s, e in events
              if MARKER not in n]
    device = [d for d in device if d[2] > t0 and d[1] < t1]
    inside = [(s.name, s.t0, s.t1) for s in spans
              if s.t1 >= t0 and s.t0 <= t1]
    err = max(abs((s - off) - h) for (s, _), h in zip(sorted(marks), hosts)) \
        if len(marks) == len(hosts) else float("nan")
    return Trace((t0, t1), device, inside, err)
