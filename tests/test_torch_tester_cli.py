"""The port's tester CLI (robocupvision_tpu_torch.cli.tester) against the
JAX package's, on a synthetic RoboCup-layout root (tests/synth_data.py) at
48x64 with ``--noScale``: the printed validation metrics within 1e-3, the
mask PNGs equal on all but 1e-4 of the pixels (argmax ties of the f32
chain graph), ``--pipeline 3`` equal to serial, ``--int8`` (PB_FCN and
``--v2``) within 1e-3 of the JAX CLI's ``--int8`` run with masks equal on
>= 0.999 of the pixels, ``--dump`` byte-identical to the JAX tester's and
``--dump --aot --pallas`` reloading to the live graph's labels, the
checkpoint format shared both ways, and the dataset reader equal to the JAX
package's."""

import os
import re
import sys

import numpy as np
import pytest

import jax
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synth_data import make_dataset_root  # noqa: E402

from robocupvision_tpu.cli import tester as jtester  # noqa: E402
from robocupvision_tpu.data import datasets as jdatasets  # noqa: E402
from robocupvision_tpu.models import zoo as jzoo  # noqa: E402
from robocupvision_tpu.train import checkpoint as jcheckpoint  # noqa: E402
from robocupvision_tpu_torch.cli import tester  # noqa: E402
from robocupvision_tpu_torch.data import datasets  # noqa: E402
from robocupvision_tpu_torch.models import zoo as tzoo  # noqa: E402
from robocupvision_tpu_torch.train import checkpoint  # noqa: E402


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Synthetic root, and the legacy checkpoints the tester loads (written
    by the JAX package's checkpoint.save) in a work directory."""
    root = str(tmp_path_factory.mktemp("robocup"))
    make_dataset_root(root, size=(48, 64))
    work = tmp_path_factory.mktemp("work")
    for family, kw, name in (("pb_fcn", dict(planes=32, no_scale=True), "VGA"),
                             ("pb_fcn_2", dict(), "VGAv2")):
        m = jzoo.make(family, num_classes=5, **kw)
        params = {k: np.asarray(v) for k, v in m.init(jax.random.PRNGKey(0)).items()}
        jcheckpoint.save(str(work / "pth" / f"bestModelSeg{name}.pth"),
                         m.registry, params)
    return {"root": root, "work": work}


def _masks(n=6):
    from PIL import Image

    return [np.asarray(Image.open(f"output/{i}.png")) for i in range(n)]


def _metrics(out):
    return [float(v) for line in out.splitlines()
            if line.startswith("Validation")
            for v in re.findall(r"[\d.]+", line)]


def _run(main, args, capsys, **kw):
    assert main(args, **kw) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("v2", [False, True])
def test_tester_matches_jax(env, monkeypatch, capsys, v2):
    monkeypatch.chdir(env["work"])
    flags = ["--root", env["root"], "--noScale"] + (["--v2"] if v2 else [])
    ref = _metrics(_run(jtester.main, flags, capsys))
    ref_masks = _masks()
    for extra in ([], ["--packed", "--pallas"]):
        out = _run(tester.main, flags + extra, capsys, device="cpu")
        assert "Loading pth/bestModelSeg" in out
        assert len(_metrics(out)) == 3
        np.testing.assert_allclose(_metrics(out), ref, atol=1e-3)
        for got, want in zip(_masks(), ref_masks):
            assert np.mean(np.any(got != want, axis=-1)) < 1e-4


def test_tester_pipeline_matches_serial(env, monkeypatch, capsys):
    monkeypatch.chdir(env["work"])
    flags = ["--root", env["root"], "--noScale", "--packed", "--pallas"]
    serial = _run(tester.main, flags, capsys, device="cpu")
    masks = _masks()
    piped = _run(tester.main, flags + ["--pipeline", "3"], capsys, device="cpu")
    assert "Pipelined serving (depth 3)" in piped
    assert _metrics(piped) == _metrics(serial)
    conf = [line for line in serial.splitlines() if line.startswith("[")]
    assert conf and conf == [line for line in piped.splitlines()
                             if line.startswith("[")]
    for got, want in zip(_masks(), masks):
        np.testing.assert_array_equal(got, want)


def test_serve_and_score_counts_every_frame():
    """The loop chip_smoke.py drives: in-memory pairs, every map seen in
    order, the accumulator equal to one batch's statistics."""
    rng = np.random.default_rng(4)
    imgs = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    labs = rng.integers(0, 3, (4, 16, 16)).astype(np.int32)

    def infer(x):  # sign of channel 0 as a two-class "net"
        return (x[..., 0] > 0).to(torch.int32)

    for depth in (1, 2):
        seen = []
        acc, secs, n = tester.serve_and_score(
            infer, zip(imgs, labs), 3, pipeline=depth,
            on_mask=lambda i, m: seen.append((i, m)), device="cpu")
        assert n == 4 and secs >= 0 and [i for i, _ in seen] == [0, 1, 2, 3]
        np.testing.assert_array_equal(np.stack([m for _, m in seen]),
                                      (imgs[..., 0] > 0).astype(np.int32))
        assert float(acc.img_cnt) == 4
        assert float(acc.conf.sum()) == 4 * 16 * 16


def test_checkpoints_pass_between_the_packages(tmp_path):
    jm = jzoo.make("pb_fcn", no_scale=True)
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(1)).items()}
    model = tzoo.make("pb_fcn", no_scale=True, device="cpu",
                      generator=torch.Generator().manual_seed(2))
    # the port writes, the JAX package reads
    checkpoint.save(str(tmp_path / "port.pth"), model.registry,
                    model.state_dict())
    from robocupvision_tpu_torch.export import torch_io

    want = torch_io.to_jax_params(model.registry, model.state_dict())
    got = jcheckpoint.load_any(str(tmp_path / "port.pth"), jm.registry)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the JAX package writes, the port reads
    jcheckpoint.save(str(tmp_path / "jax.pth"), jm.registry, jp)
    state = checkpoint.load_any(str(tmp_path / "jax.pth"), model.registry)
    back = torch_io.to_jax_params(model.registry, state)
    for k in jp:
        np.testing.assert_array_equal(back[k], jp[k])
    # a torch pickle of a state_dict (the reference's own .pth files)
    torch.save(model.state_dict(), str(tmp_path / "ref.pth"))
    state = checkpoint.load_any(str(tmp_path / "ref.pth"), model.registry)
    assert all(torch.equal(state[k], v) for k, v in model.state_dict().items())
    bad = dict(model.state_dict())
    bad.pop("FCN.conv0.conv.weight")
    torch.save(bad, str(tmp_path / "bad.pth"))
    with pytest.raises(KeyError):
        checkpoint.load_any(str(tmp_path / "bad.pth"), model.registry)


@pytest.mark.parametrize("scale,camera", [(1, "both"), (4, "both"),
                                          (1, "top")])
def test_dataset_matches_jax(env, scale, camera):
    root = os.path.join(env["root"], "FinetuneHorizon")
    ds = datasets.SSDataSet(root, split="val", camera=camera, scale=scale)
    jds = jdatasets.SSDataSet(root, split="val", camera=camera, scale=scale)
    assert ds.images == jds.images and ds.labels == jds.labels and len(ds) > 0
    for i in range(len(ds)):
        (img, lab), (jimg, jlab) = ds[i], jds[i]
        assert img.dtype == np.float32 and lab.dtype == np.int32
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(lab, jlab)


def _int8_run_matches_jax(env, capsys, v2):
    """``--packed --pallas --int8`` (calibrated on the first val frame)
    against the JAX CLI's own run: metrics within 1e-3, masks equal on
    >= 0.999 of the pixels (a requantization tie may move a pixel)."""
    flags = ["--root", env["root"], "--noScale", "--packed", "--pallas",
             "--int8"] + (["--v2"] if v2 else [])
    ref = _metrics(_run(jtester.main, flags, capsys))
    ref_masks = _masks()
    out = _run(tester.main, flags, capsys, device="cpu")
    assert len(_metrics(out)) == 3
    np.testing.assert_allclose(_metrics(out), ref, atol=1e-3)
    for got, want in zip(_masks(), ref_masks):
        assert np.mean(np.any(got != want, axis=-1)) <= 1e-3


def _dump(main, env, tmp, flags, capsys, **kw):
    """Run ``main`` with ``flags`` in a fresh directory ``tmp`` holding the
    work directory's checkpoints; returns what it printed."""
    import shutil

    shutil.copytree(env["work"] / "pth", tmp / "pth")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        return _run(main, ["--root", env["root"], "--noScale"] + flags,
                    capsys, **kw)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("flag", [["--dump"], ["--dump", "--aot"],
                                  ["--packed", "--pallas", "--int8"]])
def test_unported_flags_raise(env, monkeypatch, tmp_path, capsys, flag):
    """The flags this test once held as refused now run: ``--dump`` writes
    weights/VGA/{net.cfg, weights2.dat} byte-identical to the JAX tester's
    dump of the same checkpoint; ``--dump --aot --pallas`` also writes
    serving.pt2, which reloads and labels a frame as the live graph does
    (its chains as K2 op nodes); ``--int8`` runs and matches the JAX CLI's
    ``--int8`` run."""
    monkeypatch.chdir(env["work"])
    if "--int8" in flag:
        _int8_run_matches_jax(env, capsys, v2=False)
        return
    if flag == ["--dump"]:
        _dump(jtester.main, env, tmp_path / "jax", flag, capsys)
        out = _dump(tester.main, env, tmp_path / "port", flag, capsys,
                    device="cpu")
        assert "Dumped weights to ./weights/VGA/weights2.dat" in out
        for name in ("net.cfg", "weights2.dat"):
            with open(tmp_path / "port" / "weights" / "VGA" / name, "rb") as f:
                got = f.read()
            with open(tmp_path / "jax" / "weights" / "VGA" / name, "rb") as f:
                assert got == f.read(), name
        return
    from robocupvision_tpu_torch.export import aot
    from robocupvision_tpu_torch.models import packed

    out = _dump(tester.main, env, tmp_path, flag + ["--pallas"], capsys,
                device="cpu")
    assert "Dumped AOT serving graph to ./weights/VGA/serving.pt2" in out
    assert "Mean IoU" in out
    prog = torch.export.load(str(tmp_path / "weights" / "VGA" / "serving.pt2"))
    assert sum("fused_conv_chain" in str(n.target)
               for n in prog.graph.nodes) == 2
    fn = aot.load_serving(str(tmp_path / "weights" / "VGA"))
    ds = datasets.SSDataSet(env["root"], split="val", scale=1)
    x = torch.from_numpy(ds[0][0][None])
    model = tzoo.make("pb_fcn", planes=32, num_classes=5, kernel_size=1,
                      no_scale=True, device="cpu")
    model.load_state_dict(checkpoint.load_any(
        str(env["work"] / "pth" / "bestModelSegVGA.pth"), model.registry))
    live = packed.build_packed_pb_fcn(model, None, torch.float32, pallas=True,
                                      device="cpu").infer_u8(x)
    assert torch.equal(fn(x), live)


def test_tester_dump_v2_matches_jax(env, tmp_path, capsys):
    """``--dump --v2``: PB_FCN_2 through ``save_params(skip_classifier=True)``
    (its classification head left out), byte-identical to the JAX tester's
    weightsVGAv2 dump."""
    flags = ["--dump", "--v2"]
    _dump(jtester.main, env, tmp_path / "jax", flags, capsys)
    out = _dump(tester.main, env, tmp_path / "port", flags, capsys,
                device="cpu")
    assert "Classifier module skipped" in out
    with open(tmp_path / "port" / "weights" / "VGAv2" / "weights2.dat", "rb") as f:
        got = f.read()
    with open(tmp_path / "jax" / "weights" / "VGAv2" / "weights2.dat", "rb") as f:
        assert got == f.read()


def test_tester_int8_v2_matches_jax(env, monkeypatch, capsys):
    """``--v2 --int8``: PB_FCN_2 through build_packed_infer, quantized."""
    monkeypatch.chdir(env["work"])
    _int8_run_matches_jax(env, capsys, v2=True)
