"""K2 chain calls a batch: the program's counter ``k2.chains`` over the
traced segment's batches (counts.k2_chains gives the chains of the
configuration's graph)."""

from h100bench import program_spans


def read(run):
    return program_spans.per_batch_count(run, "k2.chains")
