"""A recorded camera log, replayed in batches through the port's serving
pipeline: the traffic of a team scoring or auto-labelling a match log.

Set-up draws the log (``log_frames`` distinct uint8 RGB frames of the
configuration's frame size, from the seed, on the card) and keeps it in
ordinary pageable host memory, as a log reader yields it; builds the
served graph from the seeded weights; and warms the pipeline up with the
window's own batches. The window replays the log in order, cycling, in
batches of ``batch`` frames, as a closed loop through
``ServingPipeline(depth)`` over the graph's ``infer_u8_io`` (raw camera
bytes in, uint8 labels out, every batch's labels fetched to the host),
until ``seconds`` have passed, then drains the pipeline. A batch's latency
runs from the ``submit`` call that takes it to the moment its labels are on
the host.

``correct``: a sample of the window's batches, drawn from the seed by
reservoir sampling, is held against the plain f32 reference forward
(``checks.logit_gap``) once the window has closed and the graph is freed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import checks, core, program, scenes, trace
from h100bench import reference
from h100bench.reference import nets


class Timed:
    """The device function handed to the pipeline; keeps the host times of
    its last call."""

    def __init__(self, fn):
        self.fn, self.last, self.total = fn, (0.0, 0.0), 0.0

    def __call__(self, x):
        t0 = time.perf_counter()
        out = self.fn(x)
        t1 = time.perf_counter()
        self.last, self.total = (t0, t1), self.total + (t1 - t0)
        return out


def draw_log(r: core.Run) -> np.ndarray:
    h, w = r.config["frame"]
    gen = torch.Generator(device=r.device).manual_seed(
        core.sub_seed(r.seed, 1))
    frames, _ = scenes.draw_u8(gen, r.traffic["log_frames"], h, w)
    return frames.cpu().numpy()   # pageable host memory


class Serving:
    """The served graph and the pipeline over it, for one variant."""

    def __init__(self, r: core.Run, model, log: np.ndarray,
                 variant: str = "program"):
        from robocupvision_tpu_torch.utils.serving import ServingPipeline

        tr = r.traffic
        self.r, self.log, self.batch = r, log, tr["batch"]
        self.n_log = len(log) // self.batch
        self.pi = program.served_graph(r.config, model, variant,
                                       calib_u8=log[:1])
        self.fn = Timed(self.pi.infer_u8_io)
        self.pipe = ServingPipeline(self.fn, depth=tr["depth"],
                                    device=r.device)
        self.submitted = []     # host time of each batch's submit call
        self.done = []          # host time its labels were on the host
        self.on_result = None   # on_result(batch index, labels)

    def frames(self, i: int) -> np.ndarray:
        b = i % self.n_log
        return self.log[b * self.batch:(b + 1) * self.batch]

    def _took(self, out) -> None:
        j = len(self.done)
        self.done.append(time.perf_counter())
        if self.on_result is not None:
            self.on_result(j, out)

    def submit(self) -> None:
        """One batch into the pipeline: the host's copy of it to the card,
        the device function, and the fetch of the oldest batch's labels
        once the pipeline is full, each a span of its own."""
        i = len(self.submitted)
        t0 = time.perf_counter()
        self.submitted.append(t0)
        out = self.pipe.submit(self.frames(i))
        t1 = time.perf_counter()
        d0, d1 = self.fn.last
        self.r.spans += [core.Span("copy_in", t0, d0),
                         core.Span("device_fn", d0, d1),
                         core.Span("fetch", d1, t1)]
        if out is not None:
            self._took(out)

    def flush(self) -> None:
        t0 = time.perf_counter()
        outs = self.pipe.flush()
        self.r.spans.append(core.Span("fetch", t0, time.perf_counter()))
        for out in outs:
            self._took(out)

    def close(self) -> None:
        """Free the graph and the pipeline."""
        del self.pipe, self.fn, self.pi


class Reservoir:
    """A uniform sample of ``k`` of a stream's items, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.n = k, np.random.default_rng(seed), 0
        self.items = []

    def offer(self, key, item) -> None:
        self.n += 1
        if len(self.items) < self.k:
            self.items.append((key, item))
        else:
            j = int(self.rng.integers(0, self.n))
            if j < self.k:
                self.items[j] = (key, item)


def judge(r: core.Run, ref_weights, log: np.ndarray, batch: int,
          n_log: int, sample, block: int = 8) -> float:
    """The widest logit gap of the sampled batches' served labels against
    the plain f32 reference (TF32 off), ``block`` frames at a time."""
    fwd = core.load_module("families", r.config["family"]).forward
    worst = 0.0
    with reference.tf32(False), torch.no_grad():
        for j, labels in sample:
            b = j % n_log
            frames = log[b * batch:(b + 1) * batch]
            for s in range(0, batch, block):
                x = nets.camera_input(torch.from_numpy(
                    frames[s:s + block]).to(r.device))
                logits = fwd(ref_weights, r.config["cfg"], x)
                worst = max(worst, checks.logit_gap(
                    logits, labels[s:s + block].to(r.device)))
    return worst


def well_formed(labels, batch: int, frame) -> bool:
    return (isinstance(labels, torch.Tensor) and labels.dtype == torch.uint8
            and tuple(labels.shape) == (batch, *frame))


def run(r: core.Run, variant: str = "program", batches: int = 0) -> None:
    """One run of the cell. ``variant``/``batches``: the control, or a
    window of a fixed number of batches instead of ``r.seconds`` (the
    calibration's short windows)."""
    tr = r.traffic
    r.phase("imports")
    model, ref_weights = program.model(r.config, core.sub_seed(r.seed, 0),
                                       r.device)
    r.phase("weights")
    log = draw_log(r)
    r.phase("log")
    srv = Serving(r, model, log, variant)
    r.phase("graph")
    with torch.no_grad():
        # warm-up: the window's own batches through the same pipeline
        for _ in range(tr["warmup_batches"]):
            srv.submit()
        srv.flush()
        if r.device.type == "cuda":
            torch.cuda.synchronize()
        r.setup_s = time.perf_counter() - r.t_start
        n_warm = len(srv.submitted)
        sample = Reservoir(tr["sample_batches"], core.sub_seed(r.seed, 3))
        bad = []

        def on_result(j, labels):
            if well_formed(labels, srv.batch, r.config["frame"]):
                sample.offer(j, labels)
            else:
                bad.append(j)

        srv.on_result = on_result
        enqueue0 = srv.fn.total
        t0 = time.perf_counter()
        while (len(srv.submitted) - n_warm < batches) if batches \
                else (time.perf_counter() - t0 < r.seconds):
            srv.submit()
        srv.flush()
        r.window = (t0, time.perf_counter())
        n = len(srv.submitted) - n_warm
        r.counts.update(batches=n, frames=n * srv.batch,
                        enqueue_s=srv.fn.total - enqueue0)
        r.latencies_s = [d - s for s, d in zip(srv.submitted[n_warm:],
                                               srv.done[n_warm:])]
        r.attempted = n * srv.batch
        r.failed = (len(bad) + n - len(r.latencies_s)) * srv.batch
        if r.device.type == "cuda":
            r.memory_peak_bytes = torch.cuda.max_memory_allocated(r.device)
        if r.trace:
            srv.on_result = None
            first = len(srv.submitted)

            def segment():
                for _ in range(tr["trace_batches"]):
                    srv.submit()
                srv.flush()

            r.traced = trace.profile(segment, r.spans)
            r.counts["traced_frames"] = (len(srv.submitted) - first) \
                * srv.batch
    batch, n_log = srv.batch, srv.n_log
    srv.close()
    del model
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    r.compare("logit_gap", judge(r, ref_weights, log, batch, n_log,
                                 sample.items))
