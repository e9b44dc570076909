"""Host milliseconds a batch in ``serve.fetch_wait``: the fetch of the
oldest batch waiting for the card to finish its work, before the copy
(the program's span, traced segment; fetched batches)."""

from h100bench import program_spans


def read(run):
    return program_spans.per_span(run, "serve.fetch_wait",
                                  lambda s: s.host_ms, per="serve.fetch")
