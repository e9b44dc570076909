"""Card milliseconds a train step: the union of the card's intervals
inside the traced epoch's ``train_epoch`` span (which ends in the epoch's
metric fetch, so the card has drained), over the steps it ran (profiler).
It holds the epoch's shuffle and metric sums, a few kernels an epoch."""


def read(run):
    t = run.traced
    steps = run.counts.get("traced_steps")
    if t is None or not steps:
        return None
    busy = sum(t.busy_s(a, b) for a, b in t.span_list("train_epoch"))
    return busy / steps * 1e3 if busy > 0 else None
