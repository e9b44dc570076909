"""Card milliseconds a batch in ``seg.encoder``: the MiT encoder's four
stages, the card's time between the span's two timing events (the
program's span, traced segment; one a served batch)."""

from h100bench import program_spans


def read(run):
    return program_spans.per_span(run, "seg.encoder", lambda s: s.card_ms)
