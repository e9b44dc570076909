"""Host milliseconds a batch inside the device function handed to the
serving pipeline (the packed graph's ``infer_u8_io`` enqueueing its
kernels), mean over the window's batches; the benchmark's own span."""


def read(run):
    n = run.counts.get("batches")
    if not n or "enqueue_s" not in run.counts:
        return None
    return run.counts["enqueue_s"] / n * 1e3
