"""K2's share of its roofline over the traced segment: the least time the
card could take for the chains it ran (per chain, the larger of its
useful operations over the peak of its dtype and its bytes over the memory
rate; counts.k2_chains) over K2's card time (profiler, its kernel name).
None for a family whose file counts no K2 chains."""

from h100bench import counts

K2 = "chain_kernel"


def read(run):
    t = run.traced
    frames = run.counts.get("traced_frames")
    if t is None or not frames:
        return None
    ks = t.kernels(lambda n: K2 in n)
    card = sum(e - s for _, s, e in ks)
    if card <= 0:
        return None
    cfg = run.config
    batch = run.traffic["batch"]
    h, w = cfg["frame"]
    peak = cfg["peaks"][cfg["serve"]["dtype"]]
    bw = cfg["peaks"]["hbm_bytes_per_s"]
    chains = counts.k2_chains(cfg, batch, h, w)
    if chains is None:
        return None
    per_batch = sum(c.seconds(peak, bw) for c in chains)
    return per_batch * (frames / batch) / card * 100.0
