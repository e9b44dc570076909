"""The whole train step's share of the f32 peak: three times the frozen
forward FLOP count an image (counts.model_flops at the training size: a
forward, and a backward of twice its work) times the training images of
the window, over the window, over the peak of the training dtype."""

from h100bench import counts


def read(run):
    images = run.counts.get("images")
    if not images or not run.window_s:
        return None
    cfg = run.config
    flops = 3 * counts.model_flops(cfg, *cfg["train"]["size"]) * images \
        / run.window_s
    return flops / cfg["peaks"][cfg["train"]["dtype"]] * 100.0
