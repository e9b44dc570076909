"""Card milliseconds a train step in ``step.update`` (the step's metrics,
the optimizer's update and its application): the card's time between the
span's two timing events (the program's span, traced segment)."""

from h100bench import program_spans


def read(run):
    return program_spans.per_span(run, "step.update", lambda s: s.card_ms)
