"""Host milliseconds a batch in ``serve.fetch`` outside its
``serve.fetch_wait``: the labels' copy from the card to pageable host
memory once the card is done (the program's spans, self time, traced
segment)."""

from h100bench import program_spans


def read(run):
    return program_spans.per_span(run, "serve.fetch", lambda s: s.self_ms)
