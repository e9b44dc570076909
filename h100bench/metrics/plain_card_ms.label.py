"""Card milliseconds a frame in every kernel that is not K2 (the packed
graph's plain parts on cuDNN, the preprocessing, the casts), over the
traced segment (profiler)."""

K2 = "chain_kernel"


def read(run):
    t = run.traced
    frames = run.counts.get("traced_frames")
    if t is None or not frames:
        return None
    ks = t.kernels(lambda n: K2 not in n)
    if not ks:
        return None
    return sum(e - s for _, s, e in ks) / frames * 1e3
