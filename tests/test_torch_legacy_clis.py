"""The port's legacy pipeline CLIs end to end on the CPU, over a synthetic
tree (32x32 classification patches, segmentation frames that the CLI's
scale 4 takes to 48x64, LabelProp sequences): classTrainer (and --v2),
then trainer (and --v2) from their checkpoints, trainer --finetune, then
--finetune --prune, then labelPropTrain, each a few epochs. Each exits 0
and writes the JAX CLI's checkpoint name, which the JAX package's
``checkpoint.load_any`` reads; every printed line has one of the JAX
CLIs' formats; band-pruned weights are still 0 after the pruned epochs.
"""

import contextlib
import io
import os
import os.path as osp
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from synth_data import (make_classification_tree, make_lp_tree,  # noqa: E402
                        make_seg_tree)

from robocupvision_tpu.models import zoo as jzoo  # noqa: E402
from robocupvision_tpu.train import checkpoint as jckpt  # noqa: E402
from robocupvision_tpu_torch.cli import classTrainer, labelPropTrain, trainer  # noqa: E402

F2, F4 = r"-?\d+\.\d{2}", r"-?\d+\.\d{4}"
# every line the three CLIs print, as the JAX CLIs' format strings have it
LINE_FORMATS = [re.compile(p) for p in (
    rf"Epoch \[\d+\] Training Loss: {F4} Training Acc: {F2}",
    rf"Epoch \[\d+\] Validation Loss: {F4} Validation Pixel Acc: {F2} "
    rf"Mean Class Acc: {F2} IoU: {F2}",
    rf"Epoch \[\d+\] Validation Loss: {F4} Validation Acc: {F2}",
    r"Loading pth/\w+\.pth",
    r"Pruned \d+\.\d{6}% of the weights",
    r"Best Model reloaded",
    r"Epoch \d+: reducing learning rate to \d\.\d{4}e[-+]\d+\.",
    r" ?\[?\[[ \d.e+-]+\]\]?",  # the confusion matrix's rows
    rf"Finished: Best Validation Loss: {F4} Best Validation Acc: {F2}",
    rf"Optimization finished Validation Loss: {F4} Pixel Acc: {F2} "
    rf"Mean Class Acc: {F2} IoU: {F2}",
    rf"Optimization finished Validation Loss: {F4} Total Acc: {F2} "
    rf"Mean Class Acc: {F2} IoU: {F2}")]

# (run, CLI module, argv, checkpoint written, JAX zoo family and kwargs)
RUNS = [
    ("class", classTrainer, ["--epochs", "2"], "pth/bestModel.pth",
     ("pb_fcn", dict(planes=32, kernel_size=1, classify=True))),
    ("class_v2", classTrainer, ["--epochs", "2", "--v2"], "pth/bestModelv2.pth",
     ("pb_fcn_2", dict(classify=True))),
    ("seg", trainer, ["--epochs", "3", "--batchSize", "8"],
     "pth/bestModelSeg.pth", ("pb_fcn", dict(planes=32, kernel_size=1))),
    ("seg_v2", trainer, ["--epochs", "2", "--batchSize", "8", "--v2"],
     "pth/bestModelSegv2.pth", ("pb_fcn_2", {})),
    ("finetune", trainer, ["--epochs", "2", "--finetune"],
     "pth/bestModelSegbothFinetuned.pth",
     ("pb_fcn", dict(planes=32, kernel_size=1))),
    ("finetune_prune", trainer, ["--epochs", "2", "--finetune", "--prune"],
     "pth/bestModelSegbothFinetunedPruned.pth",
     ("pb_fcn", dict(planes=32, kernel_size=1))),
    ("label_prop", labelPropTrain, ["--epochs", "2", "--batchSize", "4"],
     "pth/bestModelLP.pth", ("label_prop", dict(planes=32))),
]


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The runs in order in one working directory: {run: (rc, stdout)}."""
    root = str(tmp_path_factory.mktemp("legacy_root"))
    make_seg_tree(root, size=(192, 256), cameras=False)
    make_seg_tree(osp.join(root, "FinetuneHorizon"), size=(192, 256))
    make_lp_tree(root, size=(48, 64))
    make_classification_tree(osp.join(root, "Classification"))
    work = str(tmp_path_factory.mktemp("legacy_work"))
    cwd = os.getcwd()
    out = {}
    os.chdir(work)
    try:
        for run, mod, argv, _, _ in RUNS:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(["--root", root] + argv, device="cpu")
            out[run] = (rc, buf.getvalue())
    finally:
        os.chdir(cwd)
    return work, out


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_legacy_cli_writes_the_jax_checkpoint(pipeline, run):
    work, out = pipeline
    _, _, argv, name, (family, kw) = next(r for r in RUNS if r[0] == run)
    rc, text = out[run]
    assert rc == 0, text
    lines = text.splitlines()
    bad = [ln for ln in lines if not any(f.fullmatch(ln)
                                         for f in LINE_FORMATS)]
    assert not bad, bad
    epochs = int(argv[argv.index("--epochs") + 1])
    assert sum(ln.startswith(f"Epoch [{epochs}] Training Loss")
               for ln in lines) == 1
    final = "Finished" if run.startswith("class") else \
        "Optimization finished"
    assert lines[-1].startswith(final)
    params = jckpt.load_any(osp.join(work, name),
                            jzoo.make(family, **kw).registry)
    assert all(np.isfinite(v).all() for v in params.values())


def test_trainer_loads_its_predecessors(pipeline):
    _, out = pipeline
    assert "Loading pth/bestModel.pth" in out["seg"][1]
    assert "Loading pth/bestModelv2.pth" in out["seg_v2"][1]
    assert "Loading pth/bestModelSeg.pth" in out["finetune"][1]
    assert "Loading pth/bestModelSegbothFinetuned.pth" \
        in out["finetune_prune"][1]


def test_pruned_weights_stay_zero(pipeline):
    """--finetune --prune: every prunable tensor of the best checkpoint
    holds the band's 73-77% zeros after the pruned epochs."""
    work, out = pipeline
    assert out["finetune_prune"][1].count("% of the weights") > 10
    reg = jzoo.make("pb_fcn", planes=32, kernel_size=1).registry
    params = jckpt.load_any(osp.join(
        work, "pth/bestModelSegbothFinetunedPruned.pth"), reg)
    pruned = [k for k, v in params.items() if v.ndim > 1]
    for k in pruned:
        assert 0.73 <= float(np.mean(params[k] == 0)) <= 0.77, k


@pytest.mark.parametrize("mod", [classTrainer, trainer],
                         ids=["classTrainer", "trainer"])
def test_legacy_cli_rejects_all_background(mod, capsys):
    assert mod.main(["--noBall", "--noGoal", "--noRobot", "--noLine"],
                    device="cpu") == -1
    assert "non-background" in capsys.readouterr().out


@pytest.mark.parametrize("mod,text", [(classTrainer, "No classification data"),
                                      (trainer, "No data under"),
                                      (labelPropTrain, "No LabelProp data")],
                         ids=["classTrainer", "trainer", "labelPropTrain"])
def test_legacy_cli_without_data(mod, text, tmp_path, capsys):
    assert mod.main(["--root", str(tmp_path)], device="cpu") == -1
    assert text in capsys.readouterr().out
