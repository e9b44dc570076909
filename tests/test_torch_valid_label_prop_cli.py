"""The port's validLabelProp CLI (robocupvision_tpu_torch.cli.validLabelProp)
against the JAX package's, on a synthetic LabelProp tree
(tests/synth_data.make_lp_tree, frames read at the CLI's 120x160): the
dataset items and the frame-pair inputs equal, the printed metrics within
1e-3 (plain, ``--packed`` and ``--packed --pallas`` against the JAX plain
run), the mask PNGs equal on all but 1e-4 of the pixels (argmax ties of the
f32 packed graphs), ``--packed --pallas --int8`` within 1e-3 of the JAX
CLI's ``--int8`` run (masks equal on >= 0.999 of the pixels), the
``weightsLP/`` export byte-identical, and the optical-flow baselines
(``--optFlow``, ``--optFlow --jaxFlow``) against the JAX CLI's."""

import os
import re
import sys

import numpy as np
import pytest

import jax
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synth_data import make_lp_tree  # noqa: E402

from robocupvision_tpu.cli import labelPropTrain as jlp_train  # noqa: E402
from robocupvision_tpu.cli import validLabelProp as jvalid  # noqa: E402
from robocupvision_tpu.data import datasets as jdatasets  # noqa: E402
from robocupvision_tpu.models import zoo as jzoo  # noqa: E402
from robocupvision_tpu.train import checkpoint as jcheckpoint  # noqa: E402
from robocupvision_tpu_torch.cli import labelPropTrain, validLabelProp  # noqa: E402
from robocupvision_tpu_torch.data import datasets  # noqa: E402


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A LabelProp tree (two sequences of three frames per split and
    domain) and the LP checkpoint the CLI loads, written by the JAX
    package's checkpoint.save with perturbed BN statistics."""
    root = str(tmp_path_factory.mktemp("robocup"))
    make_lp_tree(root, size=(60, 80), n_seq=2, seq_len=3, seed=3)
    work = tmp_path_factory.mktemp("work")
    m = jzoo.make("label_prop", num_classes=5, planes=32)
    rng = np.random.default_rng(9)
    params = {k: np.array(v) for k, v in m.init(jax.random.PRNGKey(9)).items()}
    for k in params:
        if k.endswith(".running_mean"):
            params[k] = rng.standard_normal(params[k].shape).astype(np.float32) * 0.1
        elif k.endswith(".running_var"):
            params[k] = (0.5 + rng.random(params[k].shape)).astype(np.float32)
    jcheckpoint.save(str(work / "pth" / "bestModelLP.pth"), m.registry, params)
    return {"root": root, "work": work}


def _metrics(out):
    return [float(v) for line in out.splitlines()
            if line.startswith("Validation")
            for v in re.findall(r"[\d.]+", line)]


def _masks(n):
    from PIL import Image

    return [np.asarray(Image.open(f"output/LabelProp/Synthetic/{i}.png"))
            for i in range(n)]


def _weights():
    out = {}
    for name in ("net.cfg", "weights.dat"):
        with open(os.path.join("weightsLP", name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("finetune,train", [(False, False), (True, True)])
def test_dataset_and_pairs_match_jax(env, finetune, train):
    ds = datasets.LPDataSet(env["root"], train=train, finetune=finetune)
    jds = jdatasets.LPDataSet(env["root"], train=train, finetune=finetune)
    assert ds.seqs == jds.seqs and len(ds) == len(jds) == 4
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert got[0].dtype == np.float32 and got[1].dtype == np.int32
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        pairs = labelPropTrain.build_lp_pairs(got[0][None], got[1][None], 5)
        jpairs = jlp_train.build_lp_pairs(want[0][None], want[1][None], 5)
        assert pairs[0].shape == (2, 120, 160, 8)
        for g, w in zip(pairs, jpairs):
            np.testing.assert_array_equal(g, w)


def test_valid_label_prop_matches_jax(env, monkeypatch, capsys):
    monkeypatch.chdir(env["work"])
    flags = ["--root", env["root"]]
    assert jvalid.main(flags) == 0
    ref = _metrics(capsys.readouterr().out)
    ref_masks, ref_weights = _masks(8), _weights()
    for extra in ([], ["--packed"], ["--packed", "--pallas"]):
        assert validLabelProp.main(flags + extra, device="cpu") == 0
        out = capsys.readouterr().out
        assert "Loading pth/bestModelLP.pth" in out
        assert len(_metrics(out)) == 3
        np.testing.assert_allclose(_metrics(out), ref, atol=1e-3)
        for got, want in zip(_masks(8), ref_masks):
            assert np.mean(np.any(got != want, axis=-1)) < 1e-4
        assert _weights() == ref_weights


def test_serve_and_score_counts_every_image():
    """The loop chip_smoke.py drives: in-memory pairs, every map of every
    pair seen in order, the accumulator equal to the pairs' statistics."""
    rng = np.random.default_rng(4)
    inputs = rng.standard_normal((3, 2, 16, 16, 8)).astype(np.float32)
    targets = rng.integers(0, 3, (3, 2, 16, 16)).astype(np.int32)

    def infer(x):  # sign of channel 0 as a two-class "net"
        return (x[..., 0] > 0).to(torch.int32)

    seen = []
    acc, secs, n = validLabelProp.serve_and_score(
        infer, zip(inputs, targets), 3,
        on_mask=lambda i, m: seen.append((i, m)), device="cpu")
    assert n == 6 and secs >= 0 and [i for i, _ in seen] == list(range(6))
    np.testing.assert_array_equal(np.stack([m for _, m in seen]),
                                  (inputs[..., 0] > 0).reshape(6, 16, 16))
    assert float(acc.img_cnt) == 6
    assert float(acc.conf.sum()) == 6 * 16 * 16


@pytest.mark.parametrize("flag", [["--optFlow"], ["--optFlow", "--jaxFlow"],
                                  ["--packed", "--pallas", "--int8"],
                                  ["--jaxFlow"]])
def test_unported_flags_raise(env, monkeypatch, capsys, tmp_path, flag):
    """The flags that raised before their slice was ported, now each held to
    the JAX CLI's run with the same flags. ``--optFlow`` (cv2's Farneback)
    and ``--optFlow --jaxFlow`` (the Farneback port against the JAX one),
    run from an empty working directory: no checkpoint read, no
    ``weightsLP`` written, metrics within 1e-3, masks equal on >= 0.999 of
    the pixels, the latency line 0 as in the JAX CLI. ``--int8``
    (calibrated on the first val pair) within 1e-3 of the JAX CLI's
    ``--int8`` run, masks equal on >= 0.999 of the pixels, the same
    ``weightsLP`` export. ``--jaxFlow`` alone serves the net, as the JAX
    CLI does."""
    flow = "--optFlow" in flag
    monkeypatch.chdir(tmp_path if flow else env["work"])
    flags = ["--root", env["root"]] + flag
    assert jvalid.main(flags) == 0
    jout = capsys.readouterr().out
    ref = _metrics(jout)
    ref_masks = _masks(8)
    ref_weights = None if flow else _weights()
    assert validLabelProp.main(flags, device="cpu") == 0
    out = capsys.readouterr().out
    assert len(_metrics(out)) == 3
    np.testing.assert_allclose(_metrics(out), ref, atol=1e-3)
    for got, want in zip(_masks(8), ref_masks):
        assert np.mean(np.any(got != want, axis=-1)) <= 1e-3
    if flow:
        assert "Loading" not in out and not os.path.exists("weightsLP")
        assert float(out.splitlines()[-1]) == float(jout.splitlines()[-1]) == 0
    else:
        assert _weights() == ref_weights


def test_flow_and_score_counts_every_image():
    """The flow loop chip_smoke.py drives, on in-memory pairs with a flow
    and a warp given as functions: each frame's prediction is the other
    frame's labels warped along the flow from it, every map seen in order,
    scored as int64 maps against the pair's labels."""
    rng = np.random.default_rng(5)
    labs = rng.integers(0, 3, (3, 2, 16, 16)).astype(np.int32)
    grays = rng.integers(0, 256, (3, 2, 16, 16), dtype=np.uint8)
    calls = []

    def flow(a, b):
        calls.append((a, b))
        return None

    seen = []
    acc, n = validLabelProp.flow_and_score(
        flow, lambda lab, _: lab, zip(labs, grays), 3,
        on_mask=lambda i, m: seen.append((i, m)), device="cpu")
    assert n == 6 and [i for i, _ in seen] == list(range(6))
    np.testing.assert_array_equal(np.stack([m for _, m in seen]),
                                  labs[:, ::-1].reshape(6, 16, 16))
    assert seen[0][1].dtype == np.int64
    assert len(calls) == 6
    for (a, b), (c, d), g in zip(calls[::2], calls[1::2], grays):
        for got, want in ((a, g[1]), (b, g[0]), (c, g[0]), (d, g[1])):
            np.testing.assert_array_equal(got, want)
    assert float(acc.img_cnt) == 6
    assert float(acc.correct) == float((labs[:, 0] == labs[:, 1]).sum() * 2)


def test_int8_needs_the_chain_graph(env, monkeypatch, capsys):
    monkeypatch.chdir(env["work"])
    assert validLabelProp.main(["--root", env["root"], "--int8"],
                               device="cpu") == -1
    assert "--int8 requires --packed --pallas" in capsys.readouterr().out
