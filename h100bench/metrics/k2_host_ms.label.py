"""Host milliseconds a batch in ``k2.chain``: K2's Python wrapper
preparing and launching the fused chains (the program's spans, traced
segment; over the batches' ``serve.enqueue`` spans)."""

from h100bench import program_spans


def read(run):
    return program_spans.per_span(run, "k2.chain", lambda s: s.host_ms,
                                  per="serve.enqueue")
