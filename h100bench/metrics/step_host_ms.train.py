"""Host milliseconds a train step in ``train.step``: the step's Python
and launches (the program's span, traced segment)."""

from h100bench import program_spans


def read(run):
    return program_spans.per_span(run, "train.step", lambda s: s.host_ms)
