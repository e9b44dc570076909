"""Host milliseconds a batch in ``serve.copy_in``: the serving pipeline's
copy of a batch of camera frames from pageable host memory to the card
(the program's span, traced segment)."""

from h100bench import program_spans


def read(run):
    return program_spans.per_span(run, "serve.copy_in",
                                  lambda s: s.host_ms)
