"""The port's tracer (utils/profiling.py: ``span``, ``count``, ``spans``,
``counters``, ``reset``) and the spans the program records with it: the
serving pipeline's submit and fetch, K2's chains, the SegFormer's encoder
and decoder, the Trainer's epochs and the train step's phases. Each test
records under a CPU ``torch.profiler`` session, the tracer's switch;
outputs are the same with it on and off."""

import json
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from robocupvision_tpu_torch.data.device_cache import DeviceCache
from robocupvision_tpu_torch.models import packed, zoo
from robocupvision_tpu_torch.ops import color
from robocupvision_tpu_torch.train import loop, optim
from robocupvision_tpu_torch.train import step as tstep
from robocupvision_tpu_torch.utils import profiling
from robocupvision_tpu_torch.utils.serving import ServingPipeline

HW = (32, 32)
PHASES = ["step.augment", "step.forward", "step.backward", "step.update"]


def session():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def clean_record():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def clock(monkeypatch):
    """The tracer's clock: each reading 1 s after the one before."""
    ticks = iter(range(1000))
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))


def named(name):
    return [s for s in profiling.spans() if s.name == name]


def test_nothing_is_recorded_outside_a_session():
    assert not profiling.recording()
    off = profiling.span("a", req=1, card=True)
    assert off is profiling.span("b")   # one shared object: no allocation
    with off as s:
        profiling.count("c")
    assert s is None
    pipe = ServingPipeline(lambda x: x + 1, depth=1, device="cpu")
    list(pipe.map(torch.zeros(3, 2)))
    assert profiling.spans() == [] and profiling.counters() == {}


def test_nested_spans_parents_req_and_self_time(clock):
    with session():
        assert profiling.recording()
        with profiling.span("a", req=7) as a:            # t 0 .. 7
            with profiling.span("b") as b:               # t 1 .. 2
                pass
            with profiling.span("c", req=3) as c:        # t 3 .. 6
                with profiling.span("d", tag="x") as d:  # t 4 .. 5
                    pass
    assert [s.name for s in profiling.spans()] == ["a", "b", "c", "d"]
    assert a.parent is None and b.parent is a and c.parent is a \
        and d.parent is c
    assert (a.req, b.req, c.req, d.req) == (7, 7, 3, 3)
    assert (d.tag, a.tag) == ("x", None)
    assert [s.host_ms for s in (a, b, c, d)] == [7e3, 1e3, 3e3, 1e3]
    assert [s.self_ms for s in (a, b, c, d)] == [3e3, 1e3, 2e3, 1e3]
    assert a.card_ms is None


def test_a_second_thread_keeps_a_stack_of_its_own(monkeypatch):
    """A span another thread opens has no parent from this thread's open
    spans. The profiler's switch is per thread, so the other thread
    records nothing at first; with the switch held on for both threads (a
    second session at once is not allowed), it records a stack of its
    own."""
    got = {}

    def other():
        with profiling.span("t.outer", req="t") as o:
            with profiling.span("t.inner") as i:
                got.update(outer=o, inner=i)

    with session():
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive() and profiling.spans() == []
        monkeypatch.setattr(profiling, "_enabled", lambda: True)
        with profiling.span("main", req="m") as m:
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
            with profiling.span("main.child") as child:
                pass
    assert got["outer"].parent is None and got["outer"].req == "t"
    assert got["inner"].parent is got["outer"]
    assert child.parent is m and child.req == "m"
    assert got["outer"].thread != m.thread


def test_counters_sum_until_reset():
    with session():
        profiling.count("k")
        profiling.count("k", 4)
        profiling.count("j", 2)
    profiling.count("k")   # outside: not counted
    assert profiling.counters() == {"k": 5, "j": 2}
    profiling.reset()
    assert profiling.counters() == {} and profiling.spans() == []


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_serving_pipeline_spans(depth):
    """One submit, copy-in and enqueue a batch, each child of its submit;
    a fetch carries the fetched batch's number, under the later submit
    that forced it, or under nothing from ``flush``."""
    n = 6
    pipe = ServingPipeline(lambda x: x * 2, depth=depth, device="cpu")
    with session():
        got = list(pipe.map(torch.arange(n * 4.0).reshape(n, 4)))
    assert [int(g[0]) for g in got] == [8 * i for i in range(n)]
    subs = named("serve.submit")
    assert [s.req for s in subs] == list(range(n))
    for name in ("serve.copy_in", "serve.enqueue"):
        spans = named(name)
        assert [s.parent for s in spans] == subs
        assert [s.req for s in spans] == list(range(n))
    fetches = named("serve.fetch")
    assert [f.req for f in fetches] == list(range(n))
    assert [f.parent for f in fetches] == subs[depth:] + [None] * depth
    assert named("serve.fetch_wait") == []   # CPU tensors: no event
    for s in subs:
        assert s.self_ms <= s.host_ms


@pytest.fixture(scope="module")
def small_graph():
    model = zoo.make("robo_unet", planes=4, levels=2, belly_size=1,
                     device="cpu", generator=torch.Generator().manual_seed(3))
    pi = packed.build_packed_infer(model, None, torch.float32, pallas=True,
                                   device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (4, 2, *HW, 3),
                                               dtype=np.uint8)
    return pi, frames


def test_k2_chain_spans_inside_the_enqueue(small_graph):
    pi, frames = small_graph
    pipe = ServingPipeline(pi.infer_u8_io, depth=2, device="cpu")
    with session():
        list(pipe.map(frames))
    chains = named("k2.chain")
    enq = named("serve.enqueue")
    assert len(chains) == 2 * len(frames)   # the down and the up chain
    assert [c.tag for c in chains] == ["down", "up"] * len(frames)
    assert [c.parent for c in chains] == [e for e in enq for _ in range(2)]
    assert [c.req for c in chains] == [i for i in range(len(frames))
                                       for _ in range(2)]
    assert all(c.t1 <= d.t0 for c, d in zip(chains, chains[1:]))
    assert profiling.counters() == {"k2.chains": len(chains)}
    for e in enq:
        assert e.self_ms <= e.host_ms - sum(
            c.host_ms for c in chains if c.parent is e) + 1e-6


def test_served_labels_equal_with_recording_on_and_off(small_graph):
    pi, frames = small_graph

    def serve():
        pipe = ServingPipeline(pi.infer_u8_io, depth=2, device="cpu")
        return list(pipe.map(frames))

    off = serve()
    with session():
        on = serve()
    assert len(named("serve.submit")) == len(frames)
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_segformer_forward_spans_and_attention_count():
    """One forward: the encoder, then the decoder; one attention call a
    block; the logits the same with recording off, where nothing is
    recorded."""
    depths = (2, 1, 1, 1)
    model = zoo.make("segformer", device="cpu", embed_dims=(8, 8, 16, 16),
                     num_heads=(1, 1, 2, 2), depths=depths, decoder_dim=8,
                     generator=torch.Generator().manual_seed(6))
    x = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(7))
    off = model(x)
    assert profiling.spans() == [] and profiling.counters() == {}
    with session():
        on = model(x)
    assert torch.equal(off, on)
    enc, dec = named("seg.encoder"), named("seg.decoder")
    assert len(enc) == len(dec) == 1 and enc[0].t1 <= dec[0].t0
    assert enc[0].parent is None and dec[0].parent is None
    assert enc[0].card_ms is None and dec[0].card_ms is None   # CPU
    assert profiling.counters() == {"mit.attn": sum(depths)}


H, W = 24, 32
KW = dict(planes=4, depth=3, levels=1, belly_size=2, belly_planes=8)


def _trainer(n=10, batch=4):
    rng = np.random.default_rng(1)
    imgs = rng.standard_normal((n, H, W, 3)).astype(np.float32)
    labs = rng.integers(0, 5, (n, H, W)).astype(np.int32)
    model = zoo.make("robo_unet", device="cpu",
                     generator=torch.Generator().manual_seed(4), **KW)
    cfg = tstep.StepCfg(num_classes=5, l1_decay=1e-6,
                        out_size=1.0 / (H * W))
    cache = DeviceCache.from_numpy(imgs, labs, device="cpu")
    tr = loop.Trainer(model, optim.adam(), cfg, cache, cache, batch)
    tr.init()
    return tr


def test_trainer_epoch_and_step_phase_spans():
    tr = _trainer()
    with session():
        tr.train_epoch(1e-3)
        tr.valid_epoch()
    epochs, valids = named("train.epoch"), named("train.valid_epoch")
    assert len(epochs) == len(valids) == 1
    assert epochs[0].req == valids[0].req == tr.epoch == 1
    steps = named("train.step")
    assert len(steps) == 3   # ceil(10 / 4) batches
    assert [s.req for s in steps] == [0, 1, 2]
    assert all(s.parent is epochs[0] for s in steps)
    for st in steps:
        kids = [s for s in profiling.spans() if s.parent is st]
        assert [k.name for k in kids] == PHASES
        assert all(k.req == st.req and k.card_ms is None for k in kids)
        assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
    assert valids[0].t0 >= epochs[0].t1


def test_train_step_equal_with_recording_on_and_off():
    tr = _trainer()
    imgs, tgt, mask = tr.train_cache.images[:4], tr.train_cache.labels[:4], \
        torch.ones(4)
    draw, _ = color.AUGMENT_MODES["ssyuv"]
    draws = draw(torch.Generator().manual_seed(5), 4)
    step = tr.train_step
    off, m_off = step(tr.state, imgs, tgt, mask, draws, 1e-3)
    with session():
        on, m_on = step(tr.state, imgs, tgt, mask, draws, 1e-3)
    assert len(named("train.step")) == 1
    for k in off.params:
        assert torch.equal(off.params[k], on.params[k]), k
    for k in off.opt_state:
        assert torch.equal(off.opt_state[k], on.opt_state[k]), k
    assert all(torch.equal(m_off[k], m_on[k]) for k in m_off)


def test_device_trace_writes_spans_json(tmp_path):
    with profiling.span("outside"):   # not recorded: no session yet
        pass
    pipe = ServingPipeline(lambda x: x @ x, depth=1, device="cpu")
    with profiling.device_trace(str(tmp_path)):
        list(pipe.map(torch.ones(3, 4, 4)))
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with open(tmp_path / "spans.json") as f:
        got = json.load(f)
    names = [s["name"] for s in got["spans"]]
    assert names.count("serve.submit") == 3 and "outside" not in names
    for s in got["spans"]:
        if s["name"] in ("serve.copy_in", "serve.enqueue"):
            assert got["spans"][s["parent"]]["name"] == "serve.submit"
        assert s["t0"] <= s["t1"] and s["card_ms"] is None
    assert got["counters"] == {}
