"""Host milliseconds a batch in ``serve.enqueue`` outside its
``k2.chain`` spans: the packed graph's plain parts (the preprocessing,
cuDNN's convs, the casts) enqueueing their work (the program's spans,
self time, traced segment)."""

from h100bench import program_spans


def read(run):
    return program_spans.per_span(run, "serve.enqueue", lambda s: s.self_ms)
