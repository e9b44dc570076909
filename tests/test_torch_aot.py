"""The port's AOT serving artifacts (export/aot.py, ``torch.export``)
against the live port graphs and the JAX package's artifacts, on the CPU:
plain, packed, ``raw_u8``, ``pallas`` (the K2 op's CPU implementation,
``chain_reference``) and int8 round trips label as the live graph does,
exactly; in f32 the labels also equal the JAX artifact's (``jax.export`` of
the same carried weights, ``pallas=True`` for a CPU target). A pallas
artifact holds one op node a chain, a plain one none; the op's fake
implementation gives the shapes and dtypes ``chain_reference`` returns; an
artifact loads in a process that imported only ops/cuda_packed.py and
raises without it. The guards raise as the JAX package's."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from robocupvision_tpu.export import aot as jaot
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu_torch.export import aot, torch_io
from robocupvision_tpu_torch.models import packed, zoo
from robocupvision_tpu_torch.ops import cuda_packed as ckp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 32)
KINDS = {"plain": dict(packed=False), "packed": dict(), "raw_u8": dict(raw_u8=True),
         "pallas": dict(pallas=True), "int8": dict(pallas=True, int8=True)}


@pytest.fixture(scope="module")
def small_unet():
    """The JAX package's AOT test net (tests/test_aot_export.py), its
    weights carried into the port."""
    jm = jzoo.make("robo_unet", planes=4, levels=2, belly_size=1,
                   belly_planes=8, num_classes=5)
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    model = zoo.make("robo_unet", planes=4, levels=2, belly_size=1,
                     belly_planes=8, num_classes=5, device="cpu")
    model.load_state_dict(torch_io.from_jax_params(model.registry, jp))
    return jm, jp, model


def _frame(seed, raw=False):
    rng = np.random.default_rng(seed)
    if raw:
        return rng.integers(0, 256, (1, *HW, 3), dtype=np.uint8)
    return rng.standard_normal((1, *HW, 3)).astype(np.float32)


def _op_nodes(path):
    """The K2 op's nodes in the artifact; asserts that the nodes that do
    nothing at the traced dtypes were dropped (export/aot._drop_no_ops)."""
    prog = torch.export.load(path)
    calls = [n for n in prog.graph.nodes if n.op == "call_function"]
    assert not any(n.target is torch.ops.aten._assert_tensor_metadata.default
                   or (n.target is torch.ops.aten.to.dtype
                       and n.args[0].meta["val"].dtype == n.args[1])
                   for n in calls)
    return sum("fused_conv_chain" in str(n.target) for n in calls)


@pytest.mark.parametrize("kind", list(KINDS))
def test_round_trip_matches_live_graph(tmp_path, small_unet, kind):
    _, _, model = small_unet
    kw = dict(KINDS[kind])
    calib = torch.from_numpy(_frame(5))
    if kind == "int8":
        kw["calib_x"] = calib
    out = aot.export_serving(str(tmp_path), model, hw=HW, dtype=torch.float32,
                             fname=f"{kind}.pt2", **kw)
    assert out == str(tmp_path / f"{kind}.pt2")
    fn = aot.load_serving(out)
    x = torch.from_numpy(_frame(6, raw=kind == "raw_u8"))
    if kind == "plain":
        want = torch.argmax(model(x), dim=-1).to(torch.uint8)
    else:
        pi = packed.build_packed_infer(model, None, torch.float32,
                                       pallas=kw.get("pallas", False),
                                       device="cpu")
        if kind == "int8":
            pi = packed.quantize_int8(pi, calib)
        want = pi.infer_u8_io(x) if kind == "raw_u8" else pi.infer_u8(x)
    before = ckp.chain_reference.calls
    got = fn(x)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (1, *HW)
    assert torch.equal(got, want)
    chains = 2 if kw.get("pallas") else 0  # the down and up chains
    assert _op_nodes(out) == chains
    assert ckp.chain_reference.calls == before + chains


@pytest.mark.parametrize("kind", ["plain", "packed", "pallas"])
def test_f32_labels_equal_the_jax_artifact(tmp_path, small_unet, kind):
    jm, jp, model = small_unet
    kw = KINDS[kind]
    jout = jaot.export_serving(str(tmp_path), jm, jp, hw=HW, dtype=jnp.float32,
                               fname="jax.stablehlo", **kw)
    out = aot.export_serving(str(tmp_path), model, hw=HW, dtype=torch.float32,
                             **kw)
    assert os.path.basename(out) == aot.AOT_FNAME == "serving.pt2"
    x = _frame(7)
    want = np.asarray(jaot.load_serving(jout)(x))
    got = aot.load_serving(str(tmp_path))(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_other_params_are_what_is_exported(tmp_path, small_unet):
    """``params`` given: the artifact holds them, not the module's own."""
    _, _, model = small_unet
    other = zoo.make("robo_unet", planes=4, levels=2, belly_size=1,
                     belly_planes=8, num_classes=5, device="cpu",
                     generator=torch.Generator().manual_seed(9))
    x = torch.from_numpy(_frame(8))
    for kw in (dict(packed=False), dict(pallas=True)):
        fn = aot.load_serving(aot.export_serving(
            str(tmp_path), other, model.state_dict(), hw=HW,
            dtype=torch.float32, **kw))
        assert torch.equal(fn(x), torch.argmax(model(x), -1).to(torch.uint8))


def _recorded(pi, x):
    """(x, stages, skips) of every chain call of ``pi.infer(x)``."""
    calls = []
    direct = ckp.fused_conv_chain

    def record(cx, stages, skips=()):
        calls.append((cx, list(stages), list(skips)))
        return direct(cx, stages, skips)

    ckp.fused_conv_chain = record
    try:
        pi.infer(x)
    finally:
        ckp.fused_conv_chain = direct
    return calls


def _chains():
    """(x, stages, skips) of chains with every emitted-shape case, as the
    graphs call them: a folded stem, pool stages, the argmax head, a
    skip_w stage, int8."""
    g = torch.Generator().manual_seed(4)
    kw = dict(planes=4, levels=2, belly_size=1, belly_planes=8, device="cpu",
              generator=g)
    x = torch.from_numpy(_frame(11))
    xlp = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1, *HW, 8)).astype(np.float32))
    flag = packed.build_packed_infer(zoo.make("robo_unet", **kw), None,
                                     torch.float32, pallas=True,
                                     pallas_fold_stem=True, device="cpu")
    unet = packed.build_packed_infer(zoo.make("robo_unet", pool=True, **kw),
                                     None, torch.float32, pallas=True,
                                     pallas_fold_stem=True, device="cpu")
    lp = packed.build_packed_label_prop(
        zoo.make("label_prop", planes=8, device="cpu", generator=g), None,
        torch.float32, pallas=True, device="cpu")
    stem_down, argmax_head = _recorded(flag, x)
    return {"stem_down": stem_down, "pool_down": _recorded(unet, x)[0],
            "argmax_head": argmax_head, "skip_w_head": _recorded(lp, xlp)[-1],
            "int8": _recorded(packed.quantize_int8(flag, x), x)[0]}


@pytest.mark.parametrize("case", ["stem_down", "pool_down", "argmax_head",
                                  "skip_w_head", "int8"])
def test_op_shapes_are_chain_reference_s(case):
    x, stages, skips = _chains()[case]
    stages = ckp.with_tables(stages)
    want = ckp.chain_reference(x, stages, skips)
    got = ckp.fused_conv_chain_op(x, stages, skips)  # the CPU implementation
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = ckp.fused_conv_chain_op(mode.from_tensor(x), stages,
                                       [mode.from_tensor(s) for s in skips])
    assert [(tuple(f.shape), f.dtype) for f in fake] \
        == [(tuple(w.shape), w.dtype) for w in want]


def test_op_needs_tables_read_before_tracing():
    x, stages, skips = _chains()["stem_down"]
    import dataclasses
    bare = [dataclasses.replace(st, taps=None) for st in stages]
    with pytest.raises(ValueError, match="with_tables"):
        ckp.chain_op_args(bare)
    assert ckp.chain_op_args(ckp.with_tables(bare))[1] \
        == ckp.chain_op_args(ckp.with_tables(stages))[1]


def test_artifact_loads_with_only_the_op_module(tmp_path, small_unet):
    """A fresh process cannot load the pallas artifact before it imports
    the op's module (torch names the op it failed to resolve); after
    importing only ops/cuda_packed.py it loads it and labels a frame as
    this process does."""
    _, _, model = small_unet
    out = aot.export_serving(str(tmp_path), model, hw=HW, dtype=torch.float32,
                             pallas=True)
    x = _frame(10)
    np.save(tmp_path / "x.npy", x)
    want = aot.load_serving(out)(torch.from_numpy(x)).numpy()
    code = ("import sys, numpy as np, torch\n"
            "try:\n"
            "    torch.export.load(sys.argv[1])\n"
            "except RuntimeError:\n"
            "    print('refused without the op')\n"
            "import robocupvision_tpu_torch.ops.cuda_packed\n"
            "fn = torch.export.load(sys.argv[1]).module()\n"
            "np.save(sys.argv[3], fn(torch.from_numpy(np.load(sys.argv[2])))"
            ".numpy())\n"
            "print(sorted(m for m in sys.modules if m.startswith('robocup')))\n")
    run = subprocess.run(
        [sys.executable, "-c", code, out, str(tmp_path / "x.npy"),
         str(tmp_path / "y.npy")], env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.startswith("refused without the op")
    assert "robocupvision_tpu_torch.fused_conv_chain" in run.stderr
    assert "robocupvision_tpu_torch.models" not in run.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)


@pytest.mark.parametrize("kw", [
    dict(int8=True, calib_x=np.zeros((1, 32, 32, 3))),   # needs the chains
    dict(pallas=True, int8=True),                       # needs calibration
    dict(packed=False, pallas=True),                    # chains are packed
    dict(packed=False, raw_u8=True),                    # raw_u8 is packed
    dict(platforms=("cuda",)),                          # traced on the CPU
    dict(platforms=("cpu", "tpu")),                     # no cross-lowering
])
def test_export_guards(tmp_path, small_unet, kw):
    _, _, model = small_unet
    with pytest.raises(ValueError):
        aot.export_serving(str(tmp_path), model, hw=HW, **kw)
    assert not os.path.exists(tmp_path / aot.AOT_FNAME)


def test_raw_u8_refuses_label_prop(tmp_path):
    lp = zoo.make("label_prop", planes=8, device="cpu")
    with pytest.raises(ValueError, match="raw_u8"):
        aot.export_serving(str(tmp_path), lp, hw=HW, raw_u8=True)
    out = aot.export_serving(str(tmp_path), lp, hw=(32, 32),
                             dtype=torch.float32, platforms=("cpu",))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 32, 32, 8)).astype(np.float32))
    live = packed.build_packed_label_prop(lp, None, torch.float32,
                                          device="cpu").infer_u8(x)
    assert torch.equal(aot.load_serving(out)(x), live)
