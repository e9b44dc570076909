"""Attention calls a served batch: the program's counter ``mit.attn``
over the traced segment's batches (one a transformer block: 16 a forward
of MiT-B2, whose depths are 3, 4, 6 and 3)."""

from h100bench import program_spans


def read(run):
    return program_spans.per_batch_count(run, "mit.attn")
