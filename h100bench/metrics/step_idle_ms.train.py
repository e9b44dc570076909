"""Card idle milliseconds a train step inside ``train.step``: each span
less the union of the card's intervals inside it (profiler, on the same
clock), over the steps: where the card waits for the host's step."""

from h100bench import program_spans


def read(run):
    t = run.traced

    def idle_ms(s):
        return ((s.t1 - s.t0) - t.busy_s(s.t0, s.t1)) * 1e3

    return program_spans.per_span(run, "train.step", idle_ms)
