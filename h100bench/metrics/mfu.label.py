"""The whole served step's share of the card's peak: the frozen model
FLOP count a frame (counts.model_flops) times the frames of the window,
over the window, over the peak of the served dtype."""

from h100bench import counts


def read(run):
    frames = run.counts.get("frames")
    if not frames or not run.window_s:
        return None
    cfg = run.config
    flops = counts.model_flops(cfg, *cfg["frame"]) * frames / run.window_s
    return flops / cfg["peaks"][cfg["serve"]["dtype"]] * 100.0
