"""The port's mesh (parallel/mesh.py) against one process and the JAX
package, in four CPU processes of one gloo group (tests/torch_mesh_pool.py).

``make_mesh``'s shapes and refusal; ``shard_batch``'s two errors, word
for word the JAX ones; ``all_reduce_sum`` and ``halo_exchange`` forward
and backward against their one-process values; the data-parallel SGD
step (4 x 1, a batch the axis does not divide) and the
data x spatial step (2 x 2, 240x320, on tests/test_spatial_sharding.py's
``_tiny_vga_model``: f32, bf16, prune masks; 2 x 2 halves 240 rows down
to 15, split 7 + 8, the uneven level) held to the JAX package's
single-device step through the weight carry at that file's tolerances,
with the params bit-equal across ranks; the ce2d and Dice shares summing
to the one-process losses; and data-parallel packed serving (K2's plain
version on the CPU) equal to one process, in f32 and int8.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(__file__))
from torch_mesh_pool import Pool  # noqa: E402

from robocupvision_tpu.models import layers as jlayers  # noqa: E402
from robocupvision_tpu.models import zoo as jzoo  # noqa: E402
from robocupvision_tpu.ops import losses as jlosses  # noqa: E402
from robocupvision_tpu.parallel import mesh as jmesh  # noqa: E402
from robocupvision_tpu.train import optim as joptim  # noqa: E402
from robocupvision_tpu.train import step as jstep  # noqa: E402
from robocupvision_tpu_torch.export import torch_io  # noqa: E402
from robocupvision_tpu_torch.models import zoo  # noqa: E402
from robocupvision_tpu_torch.ops import losses  # noqa: E402
from robocupvision_tpu_torch.parallel import mesh as pmesh  # noqa: E402

WORLD = 4
TINY_VGA = dict(no_scale=True, planes=2, levels=1, belly_size=2,
                belly_planes=8)
SMALL = dict(planes=4, depth=3, levels=1, belly_size=2, belly_planes=16)
F32_TOL = dict(rtol=2e-3, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-4)


@pytest.fixture(scope="module")
def pool():
    p = Pool(WORLD)
    yield p
    p.close()


def _carry(kw):
    """The JAX model and its SGD train state from the port's seeded
    weights carried over (a JAX init compiles op by op on the CPU, for
    seconds), the port's registry and its params."""
    tm = zoo.make("robo_unet", device="cpu", **kw)
    tp = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = {k: jnp.asarray(v) for k, v in
              torch_io.to_jax_params(tm.registry, tp).items()}
    trainable, _ = jlayers.split_params(params)
    state = jstep.TrainState(params,
                             joptim.sgd(momentum=0.5).init(trainable))
    return jzoo.make("robo_unet", **kw), state, tm.registry, tp


def _jax_step(jm, state, cfg_kw, imgs, targets, mask, prune_masks=None):
    step = jstep.make_train_step(jm, joptim.sgd(momentum=0.5),
                                 jstep.StepCfg(**cfg_kw), donate=False)
    jmasks = None if prune_masks is None else \
        {k: jnp.asarray(v) for k, v in prune_masks.items()}
    state, out = step(state, jnp.asarray(imgs), jnp.asarray(targets),
                      jnp.asarray(mask), jax.random.PRNGKey(7),
                      jnp.float32(1e-2), jmasks)
    return state.params, {k: float(v) for k, v in out.items()}


def _hold(results, reg, want_params, want_out, tol, loss_tol):
    """Every rank's step against the JAX step; params equal across ranks."""
    want = torch_io.from_jax_params(reg, {k: np.asarray(v)
                                          for k, v in want_params.items()})
    p0, _ = results[0]
    for rank, (params, outs) in enumerate(results):
        out = outs[0]
        assert abs(out["loss"] - want_out["loss"]) < loss_tol, (rank, out)
        assert out["img_cnt"] == want_out["img_cnt"]
        assert abs(out["reg"] - want_out["reg"]) <= 1e-5 * abs(
            want_out["reg"]) + 1e-7
        for k, v in want.items():
            np.testing.assert_allclose(params[k], v.numpy(), err_msg=k,
                                       **tol)
            assert np.array_equal(params[k], p0[k]), (rank, k)


# ---- the mesh ------------------------------------------------------------------


def test_make_mesh_shapes_and_refusals(pool):
    res = pool.run("mesh_shapes", (1, 2, 4))
    for rank, (meshes, errors) in enumerate(res):
        for (shape, coords, main), s in zip(meshes, (1, 2, 4)):
            assert shape == {"data": WORLD // s, "spatial": s}
            assert coords == divmod(rank, s)
            assert main == (rank == 0)
        assert errors[0] == ("AssertionError",
                             "4 devices not divisible by spatial=3")
        assert errors[1][0] == "ValueError"
    # one process: the JAX precondition, before any group is made
    assert not dist.is_initialized()
    with pytest.raises(AssertionError, match="not divisible by spatial=2"):
        pmesh.make_mesh(spatial=2, device="cpu")
    assert not dist.is_initialized()


def test_shard_batch_errors_match_jax(pool):
    res = pool.run("shard_batch_errors", 4, (8, 6, 4, 3), 3)
    jm4 = jmesh.make_mesh(8, spatial=4)
    want = []
    with pytest.raises(ValueError) as e:
        jmesh.shard_batch(jm4, jnp.zeros((8, 6, 4, 3)),
                          jnp.zeros((8, 6, 4), jnp.int32), jnp.ones(8))
    want.append(str(e.value))
    with pytest.raises(ValueError) as e:
        jmesh.shard_batch(jmesh.make_mesh(4, spatial=1),
                          jnp.zeros((3, 6, 4, 3)),
                          jnp.zeros((3, 6, 4), jnp.int32), jnp.ones(3),
                          spatial=False)
    want.append(str(e.value))
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    for rank, (msgs, (i, t, m)) in enumerate(res):
        assert msgs == want
        # 1 x 4: every sample, rows [2 rank, 2 rank + 2)
        np.testing.assert_array_equal(i[..., 0, 0], x[:, 2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(t[..., 0], x[:, 2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(m, np.arange(8.0))


def test_collectives_match_one_process(pool):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 5, 3)).astype(np.float32)
    g = rng.standard_normal((WORLD, 2, 12, 5, 3)).astype(np.float32)
    halos = [(1, 1), (2, 2), (0, 2), (3, 0)]
    res = pool.run("collectives", x, g, halos)
    h = 12 // WORLD
    c = g.reshape(WORLD, -1).sum(axis=1)
    want_sum = sum(x[:, r * h:(r + 1) * h] * c[r] for r in range(WORLD))
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["sum"], want_sum, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out["sum_grad"],
                                   np.full_like(out["sum_grad"],
                                                c[r] * c.sum()),
                                   rtol=1e-5)
    for hi, (top, bottom) in enumerate(halos):
        pad = np.zeros((2, 12 + top + bottom, 5, 3), np.float32)
        pad[:, top:top + 12] = x
        grad = np.zeros_like(pad)
        for r, out in enumerate(res):
            e, _ = out["halo"][hi]
            # rows [r h - top, (r + 1) h + bottom) of the zero-padded image
            np.testing.assert_array_equal(e, pad[:, r * h:(r + 1) * h + top
                                                 + bottom])
            grad[:, r * h:(r + 1) * h + top + bottom] += \
                g[r, :, :h + top + bottom]
        grad = grad[:, top:top + 12]
        for r, out in enumerate(res):
            np.testing.assert_allclose(out["halo"][hi][1],
                                       grad[:, r * h:(r + 1) * h],
                                       rtol=1e-6, atol=1e-6)


# ---- train steps against the JAX package -------------------------------------


def test_data_parallel_step_matches_jax(pool):
    """4 x 1 at 32x32, a batch of 6 (5 real): the axis pads it to 8, so
    rank 3 holds padding alone. (The Dice share's gradient is held in
    ``test_loss_shares_sum_to_one_process``.)"""
    jm, state, reg, tp = _carry(SMALL)
    rng = np.random.default_rng(11)
    imgs = rng.standard_normal((6, 32, 32, 3)).astype(np.float32)
    targets = rng.integers(0, 5, (6, 32, 32)).astype(np.int32)
    mask = np.array([1, 1, 1, 1, 1, 0], np.float32)
    cfg_kw = dict(num_classes=5, class_weights=(1, 10, 30, 10, 2),
                  l1_decay=1e-5, augment=False, out_size=1.0 / (32 * 32))
    want_p, want_o = _jax_step(jm, state, cfg_kw, imgs, targets, mask)
    res = pool.run("train_step", 1, SMALL, cfg_kw, tp, imgs,
                   targets.astype(np.int64), mask, None, 1e-2)
    _hold(res, reg, want_p, want_o, F32_TOL, 1e-4)


@pytest.mark.parametrize("dtype,masks", [
    ("float32", False), ("bfloat16", False), ("float32", True)])
def test_spatial_step_matches_jax(pool, dtype, masks):
    """2 x 2 at 240x320 (tests/test_spatial_sharding.py's quick case)."""
    jm, state, reg, tp = _carry(TINY_VGA)
    rng = np.random.default_rng(3)
    imgs = rng.standard_normal((4, 240, 320, 3)).astype(np.float32)
    targets = rng.integers(0, 5, (4, 240, 320)).astype(np.int32)
    mask = np.ones(4, np.float32)
    jmasks = tmasks = None
    if masks:
        jmasks = {k: rng.integers(0, 2, np.shape(v)).astype(np.float32)
                  for k, v in state.params.items() if np.ndim(v) == 4}
        tmasks = {k: torch_io.from_jax_layout(v, reg.specs[k].kind)
                  for k, v in jmasks.items()}
    cfg_kw = dict(num_classes=5, augment=False, out_size=1.0 / (240 * 320),
                  compute_dtype=dtype)
    want_p, want_o = _jax_step(jm, state, cfg_kw, imgs, targets, mask,
                               jmasks)
    res = pool.run("train_step", 2, TINY_VGA, cfg_kw, tp, imgs,
                   targets.astype(np.int64), mask, tmasks, 1e-2)
    f32 = dtype == "float32"
    _hold(res, reg, want_p, want_o, F32_TOL if f32 else BF16_TOL,
          1e-4 if f32 else 1e-2)
    if masks:  # masked weights did not move
        for params, _ in res:
            for k, m in tmasks.items():
                np.testing.assert_array_equal(params[k][m > 0],
                                              tp[k][m > 0], err_msg=k)


def test_loss_shares_sum_to_one_process(pool):
    """2 x 2: each rank's ce2d and Dice share, summed, is the one-process
    loss (and the JAX package's); the gradients of the shares w.r.t. each
    rank's logits are the one-process gradient's blocks."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 8, 6, 5)).astype(np.float32) * 2
    targets = rng.integers(0, 5, (4, 8, 6)).astype(np.int64)
    mask = np.array([1, 1, 1, 0], np.float32)
    weights = (1.0, 10.0, 30.0, 10.0, 2.0)
    res = pool.run("losses_shares", 2, logits, targets, mask, weights)
    lg = torch.from_numpy(logits).requires_grad_(True)
    pm = torch.from_numpy(mask).reshape(-1, 1, 1) * torch.ones(4, 8, 6)
    w = torch.tensor(weights)
    ce = losses.cross_entropy_2d(lg, torch.from_numpy(targets), w, pm)
    dice = losses.dice_loss(lg, torch.from_numpy(targets), w, pm)
    (g,) = torch.autograd.grad(ce + dice, [lg])
    ce, dice = float(ce.detach()), float(dice.detach())
    jpm = jnp.asarray(pm.numpy())
    jce = float(jlosses.cross_entropy_2d(jnp.asarray(logits),
                                         jnp.asarray(targets),
                                         jnp.asarray(weights), jpm))
    jdice = float(jlosses.dice_loss(jnp.asarray(logits), jnp.asarray(targets),
                                    jnp.asarray(weights), jpm))
    assert sum(r[0] for r in res) == pytest.approx(ce, rel=1e-5)
    assert sum(r[1] for r in res) == pytest.approx(dice, rel=1e-5)
    assert ce == pytest.approx(jce, rel=1e-5)
    assert dice == pytest.approx(jdice, rel=1e-5)
    for rank, (_, _, grad) in enumerate(res):
        d, s = divmod(rank, 2)
        np.testing.assert_allclose(
            grad, g.numpy()[2 * d:2 * d + 2, 4 * s:4 * s + 4], rtol=1e-5,
            atol=1e-7)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_packed_serving_data_parallel(pool, int8):
    """``batch_sharding(mesh, None).local`` -> ``PackedInfer`` -> ``gather``
    on a 4 x 1 mesh: the counterpart of tests/test_pallas_packed.py's
    shard_map serving, labels equal to one process's."""
    tp = {k: v.numpy() for k, v in zoo.make(
        "robo_unet", device="cpu",
        generator=torch.Generator().manual_seed(19)).state_dict().items()}
    rng = np.random.default_rng(20)
    x = rng.standard_normal((8, 32, 64, 3)).astype(np.float32)
    for gathered, whole, local_n in pool.run("packed_serving", {}, tp, x,
                                             int8):
        assert local_n == 8 // WORLD
        np.testing.assert_array_equal(gathered, whole)
