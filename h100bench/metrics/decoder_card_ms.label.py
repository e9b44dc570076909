"""Card milliseconds a batch in ``seg.decoder``: the all-MLP decoder, from
the stages' linears to the logits' resize to the frame, the card's time
between the span's two timing events (the program's span, traced segment;
one a served batch)."""

from h100bench import program_spans


def read(run):
    return program_spans.per_span(run, "seg.decoder", lambda s: s.card_ms)
