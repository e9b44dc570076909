"""The card's idle share of the traced segment: 100 less the union of its
kernel and copy intervals, in percent of the segment (profiler)."""


def read(run):
    t = run.traced
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
