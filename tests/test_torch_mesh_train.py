"""The port's training on a mesh, in two CPU processes of one gloo group
(tests/torch_mesh_pool.py), against one process and the JAX package.

The mesh ``Trainer`` (2 x 1 and 1 x 2) over three SGD epochs with the JAX
run's permutations: its loss curve and ``valid_epoch`` against the port's
one-process Trainer (rtol 1e-4) and the JAX Trainer (rtol 1e-3 for the
curve, as tests/test_train_step.py:177 holds the JAX mesh to one device;
validation loss 5e-3 and mean IoU within 0.5, as
tests/test_spatial_sharding.py:161), params bit-equal across ranks;
the sharded stream's partition and equal batch counts and its refusals;
the streamed epoch on the mesh, augmentation included, against one
process; and ``train.main([... "--spatial", "2"])`` on
tests/synth_data.py's tree: rank 0 prints and writes, the loss lines and
checkpoint those of the one-process run.
"""

import os
import re
import sys

import numpy as np
import pytest

import jax
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synth_data import make_dataset_root  # noqa: E402
from torch_mesh_pool import IdDataset, Pool  # noqa: E402
import torch_mesh_pool as jobs  # noqa: E402

from robocupvision_tpu.data.device_cache import DeviceCache as JCache  # noqa: E402
from robocupvision_tpu.models import zoo as jzoo  # noqa: E402
from robocupvision_tpu.train import loop as jloop  # noqa: E402
from robocupvision_tpu.train import optim as joptim  # noqa: E402
from robocupvision_tpu.train import step as jstep  # noqa: E402
from robocupvision_tpu_torch.cli.train import model_hyper  # noqa: E402
from robocupvision_tpu_torch.data.streaming import StreamingBatches  # noqa: E402
from robocupvision_tpu_torch.export import torch_io  # noqa: E402
from robocupvision_tpu_torch.models import zoo  # noqa: E402
from robocupvision_tpu_torch.train import checkpoint  # noqa: E402

WORLD = 2
H, W = 48, 64
MODEL = dict(planes=4, levels=1, belly_size=2, belly_planes=16)
CFG = dict(num_classes=5, class_weights=(1, 10, 30, 10, 2), l1_decay=1e-6,
           augment=False, out_size=1.0 / (H * W))


@pytest.fixture(scope="module")
def pool():
    p = Pool(WORLD)
    yield p
    p.close()


def _data(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, H, W, 3)).astype(np.float32),
            rng.integers(0, 5, (n, H, W)).astype(np.int64))


def _carried():
    """The JAX model, and seeded port weights in both layouts (a JAX init
    compiles op by op on the CPU, for seconds)."""
    tm = zoo.make("robo_unet", device="cpu", **MODEL)
    tp = {k: v.numpy() for k, v in tm.state_dict().items()}
    return (jzoo.make("robo_unet", **MODEL),
            torch_io.to_jax_params(tm.registry, tp), tp)


def _same_on_every_rank(results, at):
    p0 = results[0][at]
    for r in results[1:]:
        for k in p0:
            assert np.array_equal(r[at][k], p0[k]), k


BATCH, EPOCHS, LR = 8, 3, 1e-2


@pytest.fixture(scope="module")
def trainer_refs():
    """The JAX Trainer's and the port's one-process runs: three epochs
    and a validation, and the JAX run's permutations."""
    train, val = _data(0, 22), _data(1, 10)
    jm, jp, tp = _carried()
    batch, epochs, lr = BATCH, EPOCHS, LR
    jtr = jloop.Trainer(jm, joptim.sgd(momentum=0.5), jstep.StepCfg(**CFG),
                        JCache.from_numpy(train[0], train[1].astype(np.int32)),
                        JCache.from_numpy(val[0], val[1].astype(np.int32)),
                        batch)
    jtr.set_params(jp)
    jlosses = [jtr.train_epoch(lr).loss for _ in range(epochs)]
    jval = jtr.valid_epoch()
    # the JAX Trainer's permutations: a key split off its generator an
    # epoch, then the epoch program's own split
    rng, perms = jax.random.PRNGKey(12345678), []
    for _ in range(epochs):
        rng, sub = jax.random.split(rng)
        perm_rng, _ = jax.random.split(sub)
        perms.append(np.asarray(jax.random.permutation(perm_rng, 22)))

    args = (MODEL, CFG, tp, train, val, batch, perms, lr)
    return args, jlosses, jval, jobs.trainer_run(None, *args)


@pytest.mark.parametrize("spatial", [1, 2], ids=["data2", "spatial2"])
def test_mesh_trainer_matches_one_process_and_jax(pool, trainer_refs,
                                                  spatial):
    args, jlosses, jval, (one_losses, one_val, one_params) = trainer_refs
    res = pool.run("trainer_run", spatial, *args)
    _same_on_every_rank(res, 2)
    assert jlosses[-1] < jlosses[0]
    for losses, v, params in res:
        np.testing.assert_allclose(losses, one_losses, rtol=1e-4)
        np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
        for k in ("loss", "pixel_acc", "mean_class_acc", "mean_iou", "score"):
            assert v[k] == pytest.approx(one_val[k], rel=1e-4, abs=1e-4), k
        assert v["loss"] == pytest.approx(jval["loss"], rel=5e-3)
        assert abs(v["mean_iou"] - jval["mean_iou"]) < 0.5
        for k in params:
            np.testing.assert_allclose(params[k], one_params[k], rtol=2e-3,
                                       atol=2e-5, err_msg=k)


def test_sharded_stream_partition_and_equal_batch_counts(pool):
    """n = 9 over two ranks at 2 samples a rank: shards of 5 and 4 items
    in 3 batches each, disjoint, their union the epoch."""
    res = pool.run("stream_partition", 9, 2)
    ids = [set(r[0]) for r in res]
    assert sum(len(r[0]) for r in res) == 9
    assert ids[0] | ids[1] == set(range(9)) and not ids[0] & ids[1]
    perm = np.random.default_rng(7).permutation(9)
    for rank, (got, count, length, device, errors) in enumerate(res):
        assert got == [int(i) for i in perm[rank::WORLD]]
        assert count == length == 3
        assert device == "cpu"
        assert all(e is not None and "mesh gives" in e for e in errors)
    # without a sharding the process arguments are checked as before
    with pytest.raises(ValueError):
        StreamingBatches(IdDataset(4), 2, process_index=2, process_count=2,
                         device="cpu")


def test_streamed_epoch_on_mesh_matches_one_process(pool):
    """Two shuffled streamed epochs with the step's augmentation: each
    rank reads its samples, the draws are the global batch's rows."""
    train = _data(2, 13)
    _, _, tp = _carried()
    cfg = dict(CFG, augment=True)
    args = (MODEL, cfg, tp, train, 4, 1e-2, 2)
    one_losses, one_params = jobs.trainer_stream(None, *args)
    res = pool.run("trainer_stream", 1, *args)
    _same_on_every_rank(res, 1)
    for losses, params in res:
        np.testing.assert_allclose(losses, one_losses, rtol=1e-4)
        for k in params:
            np.testing.assert_allclose(params[k], one_params[k], rtol=2e-3,
                                       atol=2e-5, err_msg=k)


def _loss_lines(out):
    return [float(v) for v in re.findall(r"total ([0-9.]+)\]\[Pixel", out)]


def test_train_cli_spatial(pool, tmp_path):
    """train.py --spatial 2 in the two-rank group: rank 0 prints the mesh
    line and the epochs and writes the checkpoint, rank 1 prints nothing;
    its loss lines and checkpoint are the one-process run's (Adam, whose
    steps turn reduction-order noise at near-zero gradients into up to lr
    a step: the weights within 2 steps * lr). One process with --spatial
    2 fails the mesh's precondition."""
    root = make_dataset_root(str(tmp_path / "data"), size=(H, W))
    argv = ["--root", root, "--epochs", "2", "--batchSize", "4",
            "--labSize", str(H), str(W)]
    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir()
    two.mkdir()
    rc, out1 = jobs.train_cli(str(one), argv)
    assert rc == 0
    res = pool.run("train_cli", str(two), argv + ["--spatial", "2"])
    (rc0, out0), (rc1, outr1) = res
    assert rc0 == rc1 == 0
    assert out0.startswith("mesh: data=1 spatial=2\n")
    assert outr1 == ""
    assert len(_loss_lines(out1)) == 4  # a train and a val line an epoch
    np.testing.assert_allclose(_loss_lines(out0), _loss_lines(out1),
                               rtol=1e-3)
    reg = zoo.make("robo_unet", device="cpu",
                   **model_hyper(False, False)).registry
    want = checkpoint.load_any(str(one / "checkpoints/best.weights"), reg)
    got = checkpoint.load_any(str(two / "checkpoints/best.weights"), reg)
    steps = 2 * -(-12 // 4)
    for k in want:
        assert float((got[k] - want[k]).abs().max()) <= steps * 1e-3, k
    with pytest.raises(AssertionError, match="not divisible by spatial=2"):
        jobs.train_cli(str(one), argv + ["--spatial", "2"])
    assert not torch.distributed.is_initialized()
