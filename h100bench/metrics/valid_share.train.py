"""The share of the window spent inside ``valid_epoch`` (the benchmark's
own spans, host clock), in percent."""


def read(run):
    if not run.window_s:
        return None
    v = run.window_span_total("valid_epoch")
    return 100.0 * v / run.window_s if v > 0 else None
