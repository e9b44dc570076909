"""The SegFormer cell, ``segformer_b2_vga.label_b32``: a run of it on the
CPU at a small size, in a copy of the benchmark, reads ``correct`` with
its own limit, reports its metrics, and changes no file of the benchmark;
with the served graph broken, it reads not ``correct``, but on a seed
whose reference gives one class on every pixel a copied frame is the
right answer; its three readers read the program's spans and counter; on
the card its control (the program's path in bf16) fails the limit the
program passes."""

import time

import pytest
import torch

from conftest import SEED
from h100bench import calibrate, core
from test_h100bench_harness import tree_copy  # noqa: F401
from test_h100bench_program_spans import prof, read, run_of, session  # noqa: F401

CELL = "segformer_b2_vga.label_b32"
# at 64x96 the reference labels of this seed's frames mix three classes
# and differ between frames on about two pixels in five
MIXED_SEED = 4_200_001_015


def small_run(seed: int = SEED) -> core.Run:
    """The cell at 64x96 frames, a log of 8, batches of 4, on the CPU."""
    cell = core.workload(core.manifest(), CELL)
    cfg = core.config(cell["config"])
    cfg["frame"] = [64, 96]
    tr = core.traffic(cell["traffic"])
    tr.update(log_frames=8, batch=4, warmup_batches=1, sample_batches=2)
    return core.Run(cell=cell, config=cfg, traffic=tr,
                    limits=core.limits(CELL), seed=seed, seconds=0.2,
                    trace=False, device=torch.device("cpu"),
                    t_start=time.perf_counter())


def test_cell_runs_correct_in_a_copy(tree_copy, cpu_threads):
    """The cell's end-to-end metrics, ``correct`` by its own limit, and
    no file of the benchmark changed."""
    before = {p: p.read_bytes() for p in tree_copy.rglob("*")
              if p.is_file()}
    r = small_run()
    core.load_module("runners", r.traffic["runner"]).run(r)
    assert r.correct, r.compared
    assert r.attempted > 0 and r.failed == 0
    assert set(core.read_metrics(core.manifest(), "end_to_end", r)) == {
        "label_fps", "batch_ms_p95", "setup_s"}
    assert core.load_module("metrics", "mfu.label").read(r) > 0
    for p, data in before.items():   # nothing that was there changed
        assert p.read_bytes() == data


def broken_serving(monkeypatch, how):
    from robocupvision_tpu_torch.models import segformer

    plain = segformer.SegFormerInfer.infer_u8_io

    def infer_u8_io(self, x):
        if how == "half_batch":     # half the frames served, copied over
            n = x.shape[0] // 2
            lab = plain(self, x[:n])
            return torch.cat([lab, lab])
        lab = plain(self, x).clone()
        lab[0] = (lab[0] + 1) % 5   # one frame's answer altered
        return lab

    monkeypatch.setattr(segformer.SegFormerInfer, "infer_u8_io",
                        infer_u8_io)


def judged(seed: int) -> core.Run:
    r = small_run(seed)
    core.load_module("runners", r.traffic["runner"]).run(r)
    return r


@pytest.mark.parametrize("how", ["half_batch", "answer_altered"])
def test_broken_serving_is_caught(how, monkeypatch, cpu_threads):
    broken_serving(monkeypatch, how)
    r = judged(MIXED_SEED)
    assert not r.correct, r.compared


def test_one_class_seed_sees_altered_answers_only(monkeypatch,
                                                  cpu_threads):
    """On SEED at 64x96 the random weights give one class on every pixel
    (so do about a quarter of the seeds at the cell's own size): an
    altered answer is caught, a copied half batch is the reference's own
    answer and reads a gap of 0. The fuse BatchNorm's running statistics
    set from the seed's own frames would mix the labels on every seed
    (ROADMAP E.8)."""
    from h100bench import checks

    refs = []
    gap = checks.logit_gap

    def logit_gap(ref, served):
        refs.append(ref.argmax(1))
        return gap(ref, served)

    monkeypatch.setattr(checks, "logit_gap", logit_gap)
    broken_serving(monkeypatch, "half_batch")
    r = judged(SEED)
    assert all(bool((lab == refs[0].flatten()[0]).all()) for lab in refs)
    assert r.correct and r.compared["logit_gap"][0] == 0.0
    monkeypatch.undo()
    broken_serving(monkeypatch, "answer_altered")
    assert not judged(SEED).correct


def test_readers_of_the_graph(prof):
    """Card ms a batch of the encoder's and the decoder's spans (the fake
    events read half the host's time), and the attention calls a batch,
    as a served forward records them."""
    p, at = prof
    with session():
        for t in (100, 120):
            at(t)
            with p.span("serve.enqueue"):
                with p.span("seg.encoder", card=True):
                    for _ in range(16):
                        p.count("mit.attn")
                    at(t + 6)
                with p.span("seg.decoder", card=True):
                    at(t + 10)
    run = run_of((99, 200))
    assert read("encoder_card_ms.label", run) == 3e3
    assert read("decoder_card_ms.label", run) == 2e3
    assert read("attn_calls.label", run) == 16.0
    assert read("encoder_card_ms.label", run_of((0, 50))) is None


def test_attention_calls_of_a_served_batch(cpu_threads):
    """The program's own counter through the pipeline: one attention call
    a transformer block, 16 a batch of MiT-B2; on the CPU its spans carry
    no card time."""
    import numpy as np

    from robocupvision_tpu_torch.models import segformer, zoo
    from robocupvision_tpu_torch.utils import profiling
    from robocupvision_tpu_torch.utils.serving import ServingPipeline

    model = zoo.make("segformer", device="cpu")
    pi = segformer.build_segformer_infer(model, device="cpu")
    frames = np.zeros((2, 1, 32, 64, 3), np.uint8)
    profiling.reset()
    try:
        with session():
            list(ServingPipeline(pi.infer_u8_io, device="cpu").map(frames))
        run = run_of((0, time.perf_counter() + 1))
        assert read("attn_calls.label", run) == 16.0
        assert read("encoder_card_ms.label", run) is None
    finally:
        profiling.reset()


@pytest.mark.cuda
def test_served_control_fails():
    """At the cell's own size, a short window: the f32 graph passes the
    cell's limit, the same graph in bf16 fails it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own size")
    lim = core.limits(CELL)
    seed = 3_900_000_013
    program = calibrate.served(CELL, seed, "program", 8, "cuda")
    control = calibrate.served(CELL, seed, "control", 8, "cuda")
    assert program["logit_gap"] <= lim["logit_gap"] < control["logit_gap"]
