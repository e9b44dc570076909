"""Kernels the card ran a train step: those that started inside the traced
epoch's ``train_epoch`` span, over its steps (profiler). The epoch's
shuffle and metric sums add a fixed handful over the epoch's steps; the
count repeats exactly from run to run."""


def read(run):
    t = run.traced
    steps = run.counts.get("traced_steps")
    if t is None or not steps:
        return None
    spans = t.span_list("train_epoch")
    n = sum(1 for _, s, _ in t.kernels()
            if any(a <= s <= b for a, b in spans))
    return n / steps if n else None
