"""The port's pruning entry points against the JAX package's, on the CPU
over synthetic trees: tools.structured_prune (``--ratio`` on the flagship
and on PB_FCN / LabelProp, ``--keep`` belly mode, and ops/slim's
``shrink_belly`` under it; tests/test_slim.py and
tests/test_structured_prune.py), the pruner's iterations (the pruner stage
of tests/test_legacy_clis.py), train.py's ``--finetune --pruneStruct``
phase (tests/test_train_pipeline.py) and detect, plain, ``--packed`` and
with ``--ckpt`` on a slim checkpoint (tests/test_eval_clis.py). Weights
enter both packages through checkpoints each reads from the other.

Tolerances: the tool's output checkpoints equal the JAX tool's on the same
input, array for array; shrink_belly's kept rows and arrays equal; the
deployments within 1e-4 of the zoo apply; detect's PNG masks equal the
JAX CLI's byte for byte; the slim sibling's packed labels agree >= 0.999
with the dense pruned checkpoint's."""

import glob
import os
import os.path as osp
import re
import sys

import numpy as np
import pytest

import jax
import torch

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
from synth_data import make_dataset_root, make_seg_tree  # noqa: E402

from robocupvision_tpu.models import zoo as jzoo  # noqa: E402
from robocupvision_tpu.ops import slim as jslim  # noqa: E402
from robocupvision_tpu.train import checkpoint as jckpt  # noqa: E402
from robocupvision_tpu_torch.cli import detect, pruner  # noqa: E402
from robocupvision_tpu_torch.cli import train as tcli  # noqa: E402
from robocupvision_tpu_torch.export import deploy, torch_io  # noqa: E402
from robocupvision_tpu_torch.models import packed as tpacked  # noqa: E402
from robocupvision_tpu_torch.models import zoo as tzoo  # noqa: E402
from robocupvision_tpu_torch.ops import slim as tslim  # noqa: E402
from robocupvision_tpu_torch.tools import structured_prune  # noqa: E402
from robocupvision_tpu_torch.train import checkpoint  # noqa: E402

H, W = 48, 64


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return make_dataset_root(str(tmp_path_factory.mktemp("prune_root")),
                             size=(H, W))


def _seeded(family, seed=0, **kw):
    """A JAX model and the port model on the same seeded weights."""
    jm = jzoo.make(family, **kw)
    jp = {k: np.asarray(v)
          for k, v in jm.init(jax.random.PRNGKey(seed)).items()}
    tm = tzoo.make(family, device="cpu", **kw)
    tm.load_state_dict(torch_io.from_jax_params(tm.registry, jp))
    return jm, jp, tm


def _flagship_ckpt(path, seed=0):
    """train.py's flagship with seeded weights, saved by the port."""
    jm, jp, tm = _seeded("robo_unet", seed, **tcli.model_hyper(False, False))
    checkpoint.save(path, tm.registry, tm.state_dict())
    return jm, tm


def _same_npz(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


# ---- tools.structured_prune ------------------------------------------------


@pytest.mark.parametrize("family,planes,args", [
    ("robo_unet", 0, []),
    ("pb_fcn", 16, ["--roundTo", "2", "--minKeep", "2"]),
    ("label_prop", 16, ["--roundTo", "2", "--minKeep", "2"])])
def test_structured_prune_ratio_matches_jax(tmp_path, monkeypatch, capsys,
                                            family, planes, args):
    """--ratio: the slim checkpoint equals the JAX tool's on the same input
    (and carries the slim marker), the prints match, and its deployment
    verifies against the slim zoo apply."""
    from robocupvision_tpu.tools import structured_prune as jtool

    monkeypatch.chdir(tmp_path)
    if family == "robo_unet":
        jm, tm = _flagship_ckpt("in.weights")
        fam_args, hw = [], (120, 160)
    else:
        jm, _, tm = _seeded(family, planes=planes)
        checkpoint.save("in.weights", tm.registry, tm.state_dict())
        fam_args = ["--family", family, "--planes", str(planes)]
        hw = (32, 32)
    argv = ["--checkpoint", "in.weights", "--ratio", "0.4"] + fam_args + args
    assert structured_prune.main(argv + ["--out", "port.slim", "--deploy",
                                         "dep"], device="cpu") == 0
    out = capsys.readouterr().out
    assert jtool.main(argv + ["--out", "jax.slim"]) == 0
    jout = capsys.readouterr().out
    line = [s for s in out.splitlines() if s.startswith("slim:")]
    assert line and line == [s for s in jout.splitlines()
                             if s.startswith("slim:")]
    if family == "robo_unet":
        assert "MFLOPs" in line[0]
    _same_npz("port.slim", "jax.slim")
    slim_p = checkpoint.load_any("port.slim", tm.registry)
    assert tslim.param_count(slim_p) < tslim.param_count(tm.state_dict())
    if family == "robo_unet":  # --roundTo 8: lane-friendly widths
        for k, v in slim_p.items():
            if k.endswith(".conv.weight"):
                assert v.shape[0] % 8 == 0 or v.shape[0] == 5, (k, v.shape)
    cin = 8 if family == "label_prop" else 3
    x = np.random.default_rng(0).standard_normal((1, *hw, cin)).astype(
        np.float32)
    assert deploy.verify_deployment("dep", tm, slim_p, x) <= 1e-4


def test_structured_prune_keep_matches_jax(tmp_path, monkeypatch, capsys):
    """--keep 64 (belly mode): a standard ROBO-UNet with belly_planes 64,
    equal to the JAX tool's output, which both packages load as such."""
    from robocupvision_tpu.tools import structured_prune as jtool

    monkeypatch.chdir(tmp_path)
    _flagship_ckpt("checkpoints/best.weights")
    argv = ["--checkpoint", "checkpoints/best.weights", "--keep", "64"]
    assert structured_prune.main(argv + [
        "--out", "checkpoints/bestSB64.weights", "--deploy", "weightsSB64"],
        device="cpu") == 0
    out = capsys.readouterr().out
    assert jtool.main(argv + ["--out", "jax.weights"]) == 0
    jout = capsys.readouterr().out
    assert [s for s in out.splitlines() if s.startswith("belly")] == \
        [s for s in jout.splitlines() if s.startswith("belly")]
    _same_npz("checkpoints/bestSB64.weights", "jax.weights")
    assert osp.exists("weightsSB64/net.cfg")
    small = tzoo.make("robo_unet", device="cpu",
                      **{**tcli.model_hyper(False, False), "belly_planes": 64})
    back = checkpoint.load_any("checkpoints/bestSB64.weights", small.registry)
    assert back["PB.PB_1.layers.Conv0.conv.weight"].shape[0] == 64


@pytest.mark.parametrize("keep", [16, 6])
def test_shrink_belly_matches_jax(tmp_path, keep):
    """shrink_belly: the kept rows and arrays equal the JAX package's; at
    keep = all it is the identity; the shrunk net runs and exports."""
    kw = dict(planes=4, depth=3, levels=1, belly_size=3, belly_planes=16)
    jm, jp, tm = _seeded("robo_unet", **kw)
    jnew, jcfg, jkept = jslim.shrink_belly(jp, jm.cfg, keep)
    tnew, tcfg, tkept = tslim.shrink_belly(tm.state_dict(), tm.cfg, keep)
    np.testing.assert_array_equal(tkept, jkept)
    assert tcfg.belly_planes == jcfg.belly_planes == keep
    small = tzoo.Model("robo_unet", tcfg, tnew)
    carried = torch_io.to_jax_params(small.registry, tnew)
    for k, v in jnew.items():
        np.testing.assert_array_equal(carried[k], v, err_msg=k)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    got = small(torch.from_numpy(x))
    if keep == 16:
        np.testing.assert_array_equal(tkept, np.tile(np.arange(16), (2, 1)))
        np.testing.assert_allclose(got.numpy(), tm(x).numpy(), rtol=1e-6)
    assert bool(torch.isfinite(got).all())
    d = str(tmp_path / "sb")
    deploy.export_deployment(d, small)
    assert deploy.verify_deployment(d, small, None, x[:1]) < 1e-4


def test_belly_scores_pick_each_layers_own_dead_channels():
    kw = dict(planes=4, depth=3, levels=1, belly_size=3, belly_planes=16)
    _, _, tm = _seeded("robo_unet", **kw)
    p = {k: v.clone() for k, v in tm.state_dict().items()}
    p["PB.PB_1.layers.Conv0.conv.weight"][[3, 9]] = 0
    p["PB.PB_1.layers.Conv1.conv.weight"][[1, 12]] = 0
    scores = tslim.belly_channel_scores(p, tm.cfg)
    assert scores.shape == (2, 16)
    assert set(np.argsort(scores[0])[:2]) == {3, 9}
    assert set(np.argsort(scores[1])[:2]) == {1, 12}
    new, _, kept = tslim.shrink_belly(p, tm.cfg, 14)
    assert not {3, 9} & set(kept[0]) and not {1, 12} & set(kept[1])
    assert new["PB.PB_1.layers.Conv1.conv.weight"].shape[1] == 14
    assert new["PB.PB_2.layers.Conv0.conv.weight"].shape[1] == 14


# ---- pruner ----------------------------------------------------------------


def test_pruner_iterations(tmp_path, monkeypatch, capsys):
    """The pruner's loop from a finetuned PB_FCN checkpoint, two iterations
    of one and two epochs: rc 0 through main, the JAX CLI's checkpoint name
    (which the JAX package reads) and print formats; through
    prune_iterations, the pruned weights still exactly 0 after the SGD
    epochs and each tensor's pruned count the size-adaptive top-k count."""
    from robocupvision_tpu.ops import pruning as jpruning

    root = str(tmp_path / "root")
    make_seg_tree(osp.join(root, "FinetuneHorizon"), size=(192, 256))
    monkeypatch.chdir(tmp_path)
    kw = dict(planes=32, kernel_size=1)
    jm, jp, tm = _seeded("pb_fcn", 3, **kw)
    checkpoint.save("pth/bestModelSegbothFinetuned.pth", tm.registry,
                    tm.state_dict())
    argv = ["--root", root, "--iters", "2", "--epochsPerIter", "1",
            "--batchSize", "8"]
    assert pruner.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Best Model reloaded" in out
    assert re.search(r"Pruned \d+ of \d+ weights \(0\.\d{3}%\)", out)
    assert "Optimization finished Validation Loss:" in out
    assert jckpt.load_any("pth/bestModelSegbothFinetunedPruned2.pth",
                          jm.registry)

    from robocupvision_tpu_torch.data.datasets import SSDataSet
    from robocupvision_tpu_torch.data.device_cache import DeviceCache

    opt = pruner.build_parser().parse_args(argv)
    caches = [DeviceCache.from_numpy(*SSDataSet(
        osp.join(root, "FinetuneHorizon"), split, "both", 4).load_all(),
        device="cpu") for split in ("train", "val")]
    seen, first = [], {}

    def on_iter(it, masks, tr):
        params = tr.params_numpy()
        for name, m in masks.items():
            assert not params[name][m.numpy()].any(), name  # still exactly 0
        if it == 0:
            first.update(masks)
        seen.append(it)

    os.remove("pth/bestModelSegbothFinetunedPruned2.pth")
    best = pruner.prune_iterations(opt, *caches, device="cpu",
                                   on_iter=on_iter)
    assert seen == [0, 1] and "loss" in best
    # the first iteration's masks: the JAX package's top-k on the same
    # checkpoint, tensor for tensor
    _, jmasks = jpruning.prune_topk(jp, jm.param_order, 0.08, 1000, 50000,
                                    verbose=False)
    assert set(first) == set(jmasks)
    for name, m in jmasks.items():
        kind = tm.registry.specs[name].kind
        np.testing.assert_array_equal(
            torch_io.to_jax_layout(first[name].numpy(), kind), m,
            err_msg=name)


# ---- train.py --pruneStruct --------------------------------------------------


def test_train_cli_prune_struct(data_root, tmp_path, monkeypatch, capsys):
    """--finetune --pruneStruct 0.4: main takes the flag (no refusal); the
    phase (``train_combo`` at one decay, from a seeded bestFinetune
    checkpoint) prunes whole channel groups, finetunes under their masks
    for its 25 epochs and compacts the best params into a .slim sibling; it
    loads (slim marker) in both packages with fewer params, its pruned
    channels are still 0, and its packed graph labels as the dense pruned
    checkpoint's zoo apply does; test.py's --finetune glob leaves the .slim
    out."""
    from robocupvision_tpu_torch.cli import test as ttest
    from robocupvision_tpu_torch.data.datasets import SSYUVDataset
    from robocupvision_tpu_torch.data.device_cache import DeviceCache
    from robocupvision_tpu_torch.train import naming

    monkeypatch.chdir(tmp_path)
    lab = ["--labSize", str(H), str(W)]
    argv = ["--finetune", "--pruneStruct", "0.4", "--batchSize", "8",
            "--chunkEpochs", "0"] + lab
    os.makedirs("empty")
    assert tcli.main(["--root", "empty"] + argv, device="cpu") == -1
    assert "No data found" in capsys.readouterr().out
    s = tcli.Setup.from_opt(tcli.build_parser().parse_args(
        ["--root", data_root] + argv))
    model = tzoo.make("robo_unet", device="cpu",
                      **tcli.model_hyper(False, False))
    checkpoint.save(naming.train_ckpt_name(s.flags, 0), model.registry,
                    model.state_dict())
    _, masks = tslim.prune_channels(model.state_dict(),
                                    tslim.channel_groups(model), 0.4,
                                    min_keep=8, round_to=8, verbose=False)
    caches = [DeviceCache.from_numpy(*SSYUVDataset(
        data_root, (H, W), train, True, "both").load_all(), device="cpu")
        for train in (True, False)]
    assert tcli.train_combo(s, *caches, 0, 1e-5, "cpu",
                            main_done=True) is None
    out = capsys.readouterr().out
    assert "Structured prune: kept" in out and "Compacted" in out
    assert "[Epoch Val 25/25]" in out
    slim_paths = glob.glob("checkpoints/bestFinetune*_*.weights.slim")
    assert slim_paths, os.listdir("checkpoints")
    jm = jzoo.make("robo_unet", **tcli.model_hyper(False, False))
    dense = checkpoint.load_any(slim_paths[0][:-len(".slim")], model.registry)
    slim_p = checkpoint.load_any(slim_paths[0], model.registry)
    jslim_p = jckpt.load_any(slim_paths[0], jm.registry)
    for k, m in masks.items():  # the masked finetune kept them at 0
        assert not dense[k][m].any(), k
    assert tslim.param_count(slim_p) < tslim.param_count(dense)
    assert jslim.param_count(jslim_p) == tslim.param_count(slim_p)
    m = re.search(r"Compacted \S+: (\d+) -> (\d+) params \(\d+\.\d% fewer\)",
                  out)
    assert m and int(m.group(2)) == tslim.param_count(slim_p)

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, H, W, 3)).astype(np.float32))
    labels = tpacked.build_packed_infer(model, slim_p, torch.float32,
                                        device="cpu").infer(x)
    want = torch.argmax(model.apply(dense, x), dim=-1)
    agree = float((labels.long() == want).float().mean())
    assert agree >= 0.999, agree

    assert ttest.main(["--root", data_root, "--batchSize", "8",
                       "--finetune"] + lab, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Mean IoU" in out and ".weights.slim" not in out


# ---- detect ------------------------------------------------------------------


def _pngs(d):
    from PIL import Image

    return [np.asarray(Image.open(p)) for p in
            sorted(glob.glob(osp.join(d, "*.png")),
                   key=lambda p: int(osp.basename(p)[:-4]))]


@pytest.mark.parametrize("form", ["plain", "packed", "slim", "slim_packed"])
def test_detect_matches_jax_cli(data_root, tmp_path, monkeypatch, capsys,
                                form):
    """detect on the val split: the same printed op counts as the JAX CLI
    and the same PNG masks, byte for byte; with --ckpt on a slim
    checkpoint (whose op counts fall) too; --packed (f32 packed graph)
    equal to plain."""
    from robocupvision_tpu.cli import detect as jdetect

    monkeypatch.chdir(tmp_path)
    opt = detect.build_parser().parse_args([])
    model = detect.detect_model(opt, 5, "cpu")
    gen = torch.Generator().manual_seed(4)
    state = model.registry.init(gen)
    argv = ["--root", data_root]
    if form.startswith("slim"):
        masked, _ = tslim.prune_channels(state, tslim.channel_groups(model),
                                         0.5, verbose=False)
        state, _ = tslim.compact(model, masked)
        checkpoint.save("checkpoints/s.weights.slim", model.registry, state,
                        slim=True)
        argv += ["--ckpt", "checkpoints/s.weights.slim"]
    else:
        checkpoint.save("checkpoints/best.weights", model.registry, state)
    if form.endswith("packed"):
        argv.append("--packed")
    assert jdetect.main(argv) == 0
    jout = capsys.readouterr().out
    os.rename("output", "jax_output")
    assert detect.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Detection" in out and "wrote" in out
    assert out.splitlines()[3:6] == jout.splitlines()[3:6]  # the op counts
    got, want = _pngs("output"), _pngs("jax_output")
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    total = int(out.splitlines()[4])
    dense = round(sum(tzoo.robo_unet_get_computations(model.cfg)))
    assert total < dense if form.startswith("slim") else total == dense
