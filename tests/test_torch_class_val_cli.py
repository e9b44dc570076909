"""The port's classVal and objDetEval CLIs end to end on the CPU, over a
synthetic ImageFolder tree of 32x32 patches (tests/synth_data.py), held
to what tests/test_legacy_clis.py holds the JAX CLIs to: classVal (the
DownSampler + Classifier pair, then ``--hessL`` and ``--hessMC``) exits
0 and writes the reference's checkpoint files (the pair's encoder and
head apart, in pth/bestModelB.pth and pth/bestClassB.pth), objDetEval
prints its false-negative and false-positive lines and writes
pth/bestModelHessL.pth; every printed line has one of the JAX CLIs'
formats, and the JAX package's ``checkpoint.load_any`` reads every file.
``fp_fn_stats`` equals the JAX function's; the pair's plateau rollback
reloads the two files."""

import contextlib
import io
import os
import os.path as osp
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synth_data import make_classification_tree  # noqa: E402

from robocupvision_tpu.cli import objDetEval as jobjdet  # noqa: E402
from robocupvision_tpu.models import zoo as jzoo  # noqa: E402
from robocupvision_tpu.train import checkpoint as jckpt  # noqa: E402
from robocupvision_tpu_torch.cli import classVal, objDetEval  # noqa: E402
from robocupvision_tpu_torch.train import checkpoint, legacy  # noqa: E402

F2, F4 = r"-?\d+\.\d{2}", r"-?\d+\.\d{4}"
LINE_FORMATS = [re.compile(p) for p in (
    rf"Epoch \[\d+\] Training Loss: {F4} Training Acc: {F2}",
    rf"Epoch \[\d+\] Validation Loss: {F4} Validation Acc: {F2}",
    r"Best Model reloaded",
    r"Epoch \d+: reducing learning rate to \d\.\d{4}e[-+]\d+\.",
    r" ?\[?\[[ \d.e+-]+\]\]?",  # the confusion matrix's rows
    rf"(Best|Finished): Accuracy: {F4} False Neg: {F2} False Pos: {F2}",
    rf"Finished: Best Validation Loss: {F4} Best Validation Acc: {F2}")]

# (run, CLI module, argv, checkpoints written, JAX zoo family and kwargs
# of each)
RUNS = [
    ("combo", classVal, ["--epochs", "2"],
     {"pth/bestModelB.pth": ("downsampler", dict(planes=32)),
      "pth/bestClassB.pth": ("classifier", dict(in_planes=64,
                                                num_classes=4))}),
    ("hessL", classVal, ["--epochs", "2", "--hessL"],
     {"pth/bestModelHessL.pth": ("bnn", dict(variant="L"))}),
    ("hessMC", classVal, ["--epochs", "1", "--hessMC"],
     {"pth/bestModelHessMC.pth": ("bnn", dict(variant="MC"))}),
    ("obj_det", objDetEval, ["--epochs", "2"],
     {"pth/bestModelHessL.pth": ("bnn", dict(variant="L"))}),
]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("class_root"))
    make_classification_tree(osp.join(root, "Classification"))
    return root


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device="cpu")
    return rc, buf.getvalue()


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_cli_runs_and_writes_the_reference_files(run, root, tmp_path,
                                                 monkeypatch):
    _, cli, argv, files, = next(r for r in RUNS if r[0] == run)
    monkeypatch.chdir(tmp_path)
    rc, out = _run(cli, ["--root", root] + argv)
    assert rc == 0, out
    lines = [ln for ln in out.splitlines() if ln.strip()]
    for ln in lines:
        assert any(f.fullmatch(ln) for f in LINE_FORMATS), ln
    epochs = int(argv[1])
    train = [float(m) for m in re.findall(r"Training Loss: (\S+)", out)]
    assert len(train) == epochs and np.isfinite(train).all()
    assert out.count("Validation Acc:") == epochs + 1  # the last: Finished
    if cli is objDetEval:
        assert "False Neg" in out and "False Pos" in out
        assert re.search(r"^Finished: Accuracy:", out, re.M)
    for path, (family, kw) in files.items():
        assert osp.exists(path), path
        jm = jzoo.make(family, **kw)
        params = jckpt.load_any(path, jm.registry)
        assert set(params) == set(jm.registry.specs)
        assert all(np.isfinite(np.asarray(v)).all() for v in params.values())


def test_entry_points_refuse_without_data(tmp_path, capsys):
    for cli in (classVal, objDetEval):
        assert cli.main(["--root", str(tmp_path)], device="cpu") == -1
        assert "No classification data" in capsys.readouterr().out


@pytest.mark.parametrize("seed", range(4))
def test_fp_fn_stats_matches_jax(seed):
    rng = np.random.default_rng(seed)
    conf = rng.integers(0, 20, (4, 4)).astype(np.float64)
    if seed == 3:
        conf[:, 1:4] = 0  # no foreground: all zeros
    assert objDetEval.fp_fn_stats(conf) == pytest.approx(
        jobjdet.fp_fn_stats(conf))


def test_combo_rollback_reloads_both_files(root, tmp_path, monkeypatch):
    """With patience -1 the plateau fires after every epoch and reloads the
    best pair through ``load_fn``: the params after a rollback are the
    two files' (the optimizer state kept)."""
    monkeypatch.chdir(tmp_path)
    real, seen = legacy.run_plateau_training, []

    def run(tr, *a, **kw):
        kw["patience"] = -1
        seen.append(tr)
        orig = tr.set_params

        def set_params(params, reset_opt=True):
            seen.append({k: torch.as_tensor(v).clone()
                         for k, v in params.items()})
            assert not reset_opt
            return orig(params, reset_opt)

        tr.set_params = set_params
        return real(tr, *a, **kw)

    monkeypatch.setattr(legacy, "run_plateau_training", run)
    from robocupvision_tpu_torch.data.datasets import ImageFolder
    from robocupvision_tpu_torch.data.device_cache import DeviceCache

    caches = [DeviceCache.from_numpy(*ImageFolder(osp.join(
        root, "Classification", split)).load_all(), device="cpu")
        for split in ("trainBig", "test")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        best = classVal.train_baseline(classVal.build_parser().parse_args(
            ["--epochs", "2"]), *caches, "cpu")
    assert buf.getvalue().count("Best Model reloaded") == 2
    tr, reloaded = seen[0], seen[-1]
    model = tr.model
    down = checkpoint.load_any("pth/bestModelB.pth", model.down.registry)
    head = checkpoint.load_any("pth/bestClassB.pth", model.head.registry)
    assert set(reloaded) == set(model.registry.specs)
    for k, v in down.items():
        assert torch.equal(reloaded["down." + k], v), k
    for k, v in head.items():
        assert torch.equal(reloaded["head." + k], v), k
    assert best["conf"].shape == (4, 4)
