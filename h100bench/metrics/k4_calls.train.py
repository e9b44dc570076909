"""K4 calls a train step: the program's counter ``k4.calls`` over the
traced segment's ``train.step`` spans (1 where the step runs the legacy
augmentation on the card, 0 where it augments otherwise or where the
program has no K4)."""

from h100bench import program_spans


def read(run):
    got = program_spans.recorded(run)
    if got is None:
        return None
    spans, counts = got
    steps = len(program_spans.named(spans, "train.step"))
    return counts.get("k4.calls", 0) / steps if steps else None
