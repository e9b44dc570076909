"""Frames whose labels came back over the window, per second of it."""


def read(run):
    frames = run.counts.get("frames")
    if not frames or not run.window_s:
        return None
    return frames / run.window_s
