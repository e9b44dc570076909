"""The port's evaluation CLI (robocupvision_tpu_torch.cli.test) and the
modules it runs, against the JAX package's: the losses (class weights and
the pixel mask), the batcher's padding and mask, the SSYUVDataset reader,
the object-level metrics (8-connected components, exact), the near-zero
count, the checkpoint family name and the hyperparameter table; then
``test.main`` for ``--UNet`` and ``--v2`` on a synthetic root
(tests/synth_data.py) at 48x64, from checkpoints the port wrote, whose
printed metric line, op counts and IoU/Dist arrays must match the JAX
CLI's on the same checkpoint within 1e-3; and ``--lProp`` (label
propagation along cv2's Farneback flow over LabelProp sequences) the same
way."""

import os
import re
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synth_data import make_dataset_root, make_lp_tree  # noqa: E402

from robocupvision_tpu.cli import test as jtest  # noqa: E402
from robocupvision_tpu.cli import train as jtrain  # noqa: E402
from robocupvision_tpu.data import datasets as jdatasets  # noqa: E402
from robocupvision_tpu.data import device_cache as jdevice_cache  # noqa: E402
from robocupvision_tpu.ops import losses as jlosses  # noqa: E402
from robocupvision_tpu.ops import objmetrics as jobjmetrics  # noqa: E402
from robocupvision_tpu.ops import pruning as jpruning  # noqa: E402
from robocupvision_tpu.train import naming as jnaming  # noqa: E402
from robocupvision_tpu_torch.cli import test as ttest  # noqa: E402
from robocupvision_tpu_torch.cli import train as ttrain  # noqa: E402
from robocupvision_tpu_torch.data import datasets, device_cache  # noqa: E402
from robocupvision_tpu_torch.export import torch_io  # noqa: E402
from robocupvision_tpu_torch.models import zoo as tzoo  # noqa: E402
from robocupvision_tpu_torch.ops import losses, objmetrics, pruning  # noqa: E402
from robocupvision_tpu_torch.train import checkpoint, naming  # noqa: E402


def _logits_targets(seed, c=5, shape=(3, 6, 7)):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape + (c,)) * 3).astype(np.float32)
    targets = rng.integers(0, c, shape).astype(np.int32)
    return logits, targets


@pytest.mark.parametrize("weights,masked", [(None, False), ((1, 10, 30, 5, 2), True),
                                            ((1, 2, 6, 3, 2), False)])
def test_cross_entropy_2d_matches_jax(weights, masked):
    logits, targets = _logits_targets(1)
    mask = np.broadcast_to(np.array([1.0, 0.0, 1.0], np.float32)[:, None, None],
                           targets.shape) if masked else None
    want = jlosses.cross_entropy_2d(
        jnp.asarray(logits), jnp.asarray(targets),
        None if weights is None else jnp.asarray(weights, jnp.float32),
        None if mask is None else jnp.asarray(mask))
    got = losses.cross_entropy_2d(
        torch.from_numpy(logits), torch.from_numpy(targets),
        None if weights is None else torch.tensor(weights, dtype=torch.float32),
        None if mask is None else torch.from_numpy(np.array(mask)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cross_entropy_2d_saturated_logit_is_finite():
    """A saturated bf16 logit gives a -inf log-prob elsewhere: no NaN."""
    logits = torch.zeros((1, 2, 2, 3), dtype=torch.bfloat16)
    logits[..., 0] = 3e38
    targets = torch.tensor([[[0, 1], [2, 0]]])
    got = losses.cross_entropy_2d(logits, targets)
    want = jlosses.cross_entropy_2d(jnp.asarray(logits.float().numpy(),
                                                jnp.bfloat16),
                                    jnp.asarray(targets.numpy()))
    assert not torch.isnan(got)
    assert float(got) == float(want)


@pytest.mark.parametrize("c,masked", [(5, True), (5, False), (1, True)])
def test_dice_loss_matches_jax(c, masked):
    logits, targets = _logits_targets(2, c=c)
    if c == 1:
        targets = (targets % 2).astype(np.int32)
    weights = np.arange(1, c + 1, dtype=np.float32) if c > 1 \
        else np.ones(2, np.float32)
    mask = np.broadcast_to(np.array([1.0, 1.0, 0.0], np.float32)[:, None, None],
                           targets.shape) if masked else None
    want = jlosses.dice_loss(jnp.asarray(logits), jnp.asarray(targets),
                             jnp.asarray(weights),
                             None if mask is None else jnp.asarray(mask))
    got = losses.dice_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                           torch.from_numpy(weights),
                           None if mask is None else torch.from_numpy(np.array(mask)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_l1_and_near_zero_count_match_jax():
    model = tzoo.make("robo_unet", device="cpu", pool=True, levels=3,
                      belly_size=0, generator=torch.Generator().manual_seed(3))
    state = model.state_dict()
    jp = torch_io.to_jax_params(model.registry, state)
    np.testing.assert_allclose(
        float(losses.l1_regularization(state.values())),
        float(jlosses.l1_regularization({k: jnp.asarray(v) for k, v in jp.items()})),
        rtol=1e-5)
    assert pruning.count_zero_weights(state, model.param_order) \
        == jpruning.count_zero_weights(jp, model.param_order)


@pytest.mark.parametrize("n,batch", [(6, 8), (16, 4), (7, 3)])
def test_epoch_batches_pad_and_mask_like_jax(n, batch):
    rng = np.random.default_rng(n)
    imgs = rng.standard_normal((n, 4, 5, 3)).astype(np.float32)
    labs = rng.integers(0, 5, (n, 4, 5)).astype(np.int32)
    cache = device_cache.DeviceCache.from_numpy(imgs, labs, device="cpu")
    jcache = jdevice_cache.DeviceCache.from_numpy(imgs, labs)
    got = list(device_cache.epoch_batches(cache, batch))
    want = list(jdevice_cache.epoch_batches(jcache, batch, None))
    assert len(got) == len(want) == device_cache.num_batches(n, batch)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # an injected permutation (training's shuffle) orders the samples
    perm = rng.permutation(n)
    got = list(device_cache.epoch_batches(cache, batch, perm))
    order = np.concatenate([perm, np.zeros(len(got) * batch - n, np.int64)])
    np.testing.assert_array_equal(np.concatenate([b[0].numpy() for b in got]),
                                  imgs[order])
    assert float(sum(b[2].sum() for b in got)) == n


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("robocup"))
    make_dataset_root(root, size=(48, 64))
    return root


@pytest.mark.parametrize("finetune,camera,size", [(False, "both", (48, 64)),
                                                  (True, "top", (24, 32))])
def test_ssyuv_dataset_matches_jax(root, finetune, camera, size):
    ds = datasets.SSYUVDataset(root, size, False, finetune, camera)
    jds = jdatasets.SSYUVDataset(root, size, False, finetune, camera)
    assert ds.images == jds.images and ds.labels == jds.labels and len(ds) > 0
    got, want = ds.load_all(), jds.load_all()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _diagonal_masks(seed, shape=(3, 2, 24, 32)):
    """0/1 masks of diagonal strokes: blobs whose pixels touch only at
    corners, one component 8-connected and many 4-connected."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, np.int64)
    for idx in np.ndindex(*shape[:2]):
        for _ in range(rng.integers(0, 6)):
            y, x = rng.integers(0, shape[2]), rng.integers(0, shape[3])
            sx = rng.choice([-1, 1])
            for k in range(rng.integers(2, 9)):
                if 0 <= y + k < shape[2] and 0 <= x + sx * k < shape[3]:
                    m[idx + (y + k, x + sx * k)] = 1
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_objmetrics_match_jax_on_diagonal_blobs(seed):
    pred, tgt = _diagonal_masks(10 + seed), _diagonal_masks(20 + seed)
    n, _ = objmetrics._connected_components(pred[1, 0])
    assert n < int(pred[1, 0].sum())  # the strokes are joined at corners
    thresholds, dist = [0.75, 0.5, 0.25, 0.1, 0.05], [1.25, 2.5, 5, 10, 20]
    np.testing.assert_array_equal(
        objmetrics.get_prec_recall_multi(pred, tgt, thresholds, dist),
        jobjmetrics.get_prec_recall_multi(pred, tgt, thresholds, dist))
    for t, d in zip(thresholds[::2], dist[::2]):
        assert objmetrics.get_prec_recall(pred, tgt, t, d) \
            == jobjmetrics.get_prec_recall(pred, tgt, t, d)
        assert objmetrics.get_prec_recall_naive(pred, tgt, t, d) \
            == jobjmetrics.get_prec_recall_naive(pred, tgt, t, d)


def test_naming_and_hyper_table_match_jax():
    for unet, v2 in ((False, False), (True, False), (False, True)):
        assert ttrain.model_hyper(unet, v2) == jtrain.model_hyper(unet, v2)
    for kw in (dict(), dict(unet=True), dict(v2=True, no_scale=True),
               dict(finetune=True, top_cam=True, no_ball=True)):
        assert naming.test_ckpt_glob_base(naming.Flags(**kw)) \
            == jnaming.test_ckpt_glob_base(jnaming.Flags(**kw))


def _numbers(line):
    return [float(v) for v in re.findall(r"-?\d+\.?\d*(?:e[-+]?\d+)?", line)]


def _report(out):
    """{metric line, IoU, Dist, op counts} of test.py's output."""
    lines = out.splitlines()
    rep = {"validate": [_numbers(ln) for ln in lines if ln.startswith("[Validate]")],
           "iou": [_numbers(ln) for ln in lines if ln.startswith("IoU:")],
           "dist": [_numbers(ln) for ln in lines if ln.startswith("Dist:")],
           "comp": [ln for ln in lines if ln.startswith("[") and
                    not ln.startswith("[Validate]")]}
    assert len(rep["validate"]) == len(rep["iou"]) == len(rep["dist"]) == 1
    return rep


@pytest.mark.parametrize("flag,unet,v2", [("--UNet", True, False),
                                          ("--v2", False, True)])
def test_test_main_matches_jax(root, tmp_path, monkeypatch, capsys, flag, unet,
                               v2):
    monkeypatch.chdir(tmp_path)
    model = tzoo.make("robo_unet", device="cpu", pool=unet, v2=v2,
                      generator=torch.Generator().manual_seed(5),
                      **ttrain.model_hyper(unet, v2))
    rng = np.random.default_rng(6)
    state = model.state_dict()
    for k, t in state.items():  # BN statistics from numpy
        if k.endswith(".running_mean"):
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32) * 0.3))
        elif k.endswith(".running_var"):
            t.copy_(torch.from_numpy((0.5 + rng.random(t.shape)).astype(np.float32)))
    name = "checkpoints/best%s.weights" % ("UNet" if unet else "v2")
    checkpoint.save(name, model.registry, state)
    argv = ["--root", root, "--batchSize", "8", "--labSize", "48", "64", flag]
    assert jtest.main(argv) == 0
    want = _report(capsys.readouterr().out)
    assert ttest.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert f"Testing {name}" in out
    got = _report(out)
    assert got["comp"] == want["comp"]
    for key in ("validate", "iou", "dist"):
        assert len(got[key][0]) == len(want[key][0]) > 0
        np.testing.assert_allclose(got[key][0], want[key][0], atol=1e-3)


def test_lprop_raises(tmp_path, monkeypatch, capsys):
    """``--lProp``, which raised before its slice was ported, against the
    JAX CLI on a LabelProp tree (two val sequences of four frames at
    48x64) from a flagship checkpoint the port wrote: the first checkpoint
    only, its metric line and its ``Normal`` and ``LP`` IoU/Dist rows
    within 1e-3 (cv2's Farneback on both sides)."""
    root = str(tmp_path / "robocup")
    make_lp_tree(root, size=(48, 64), n_seq=2, seq_len=5, seed=4)
    monkeypatch.chdir(tmp_path)
    model = tzoo.make("robo_unet", device="cpu",
                      generator=torch.Generator().manual_seed(7),
                      **ttrain.model_hyper(False, False))
    rng = np.random.default_rng(8)
    state = model.state_dict()
    for k, t in state.items():  # BN statistics from numpy: varied maps
        if k.endswith(".running_mean"):
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
        elif k.endswith(".running_var"):
            t.copy_(torch.from_numpy((0.05 + 0.05 * rng.random(t.shape)).astype(np.float32)))
    checkpoint.save("checkpoints/best.weights", model.registry, state)
    argv = ["--root", root, "--labSize", "48", "64", "--lProp"]
    assert jtest.main(argv) == 0
    jout = capsys.readouterr().out
    assert ttest.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("###### Testing") == 1 and "Testing checkpoints/best.weights" in out
    lines = out.splitlines()
    assert lines[-6:-3] == ["Normal"] + lines[-5:-3] and lines[-3] == "LP"
    got = [_numbers(ln) for ln in lines if ln.startswith(("[Validate]", "IoU:", "Dist:"))]
    want = [_numbers(ln) for ln in jout.splitlines()
            if ln.startswith(("[Validate]", "IoU:", "Dist:"))]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        np.testing.assert_allclose(g, w, atol=1e-3)
