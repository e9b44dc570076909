"""Training images completed over the window, per second of it; the
window's time holds each epoch's validation too."""


def read(run):
    images = run.counts.get("images")
    if not images or not run.window_s:
        return None
    return images / run.window_s
