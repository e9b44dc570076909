"""K5 calls a served batch: the program's counter ``k5.calls`` over the
traced segment's batches (``serve.enqueue`` spans): 1 where the SegFormer's
folded head is gathered on the card by K5, 0 where the program has no
K5."""

from h100bench import program_spans


def read(run):
    got = program_spans.recorded(run)
    if got is None:
        return None
    spans, counts = got
    batches = len(program_spans.named(spans, "serve.enqueue"))
    return counts.get("k5.calls", 0) / batches if batches else None
