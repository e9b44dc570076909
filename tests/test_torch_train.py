"""The port's training slice against the JAX package's, on the CPU.

The layers (train-mode batch norm with and without a sample mask, the
augmentation given the JAX draws, the schedules, the optimizer transforms,
the pruning helpers and the checkpoint names), then the train step from the
same carried weights, batch, draws and class weights with an L1 term:
one plain-SGD step within rtol = atol = 1e-4 on every parameter and
running statistic (loss within 1e-5 relative), three Adam steps with the
same loss (1e-4 relative) and ``correct`` trajectories (within 1e-3 of
the real pixels: argmax flips at near-ties), for the flagship,
``--UNet``, ``--v2`` and the Dice loss; then ``Trainer.train_run`` over two
epochs against the JAX one, with the JAX package's permutations and
augmentation draws injected, its per-epoch metric line within 1e-3.

jax.random and torch's generators differ, so every test hands the port the
values the JAX package drew (``jax_sample_draws`` repeats its key splits).
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synth_data import make_dataset_root  # noqa: E402

from robocupvision_tpu.data import device_cache as jdevice_cache  # noqa: E402
from robocupvision_tpu.data.datasets import SSYUVDataset as JSSYUV  # noqa: E402
from robocupvision_tpu.models import layers as jlayers  # noqa: E402
from robocupvision_tpu.models import zoo as jzoo  # noqa: E402
from robocupvision_tpu.ops import color as jcolor  # noqa: E402
from robocupvision_tpu.ops import nn as jnn  # noqa: E402
from robocupvision_tpu.ops import pruning as jpruning  # noqa: E402
from robocupvision_tpu.train import loop as jloop  # noqa: E402
from robocupvision_tpu.train import naming as jnaming  # noqa: E402
from robocupvision_tpu.train import optim as joptim  # noqa: E402
from robocupvision_tpu.train import schedules as jschedules  # noqa: E402
from robocupvision_tpu.train import step as jstep  # noqa: E402
from robocupvision_tpu_torch.cli.train import model_hyper  # noqa: E402
from robocupvision_tpu_torch.data import device_cache  # noqa: E402
from robocupvision_tpu_torch.export import torch_io  # noqa: E402
from robocupvision_tpu_torch.models import layers, zoo  # noqa: E402
from robocupvision_tpu_torch.ops import color, nn, pruning  # noqa: E402
from robocupvision_tpu_torch.train import loop, naming, optim, schedules  # noqa: E402
from robocupvision_tpu_torch.train import step as tstep  # noqa: E402

H, W = 48, 64
WEIGHTS = (1, 10, 30, 10, 2)
DICE_WEIGHTS = (1, 2, 6, 3, 2)


def jax_sample_draws(key):
    """The flip and jitter values ``augment_sample`` draws from ``key``."""
    kf, kj = jax.random.split(key)
    kb, kc, ks, kh = jax.random.split(kj, 4)
    h = 3.1415 / 6
    return (bool(jax.random.uniform(kf, ()) > 0.5),
            float(jax.random.uniform(kb, (), minval=-0.3, maxval=0.3)),
            float(jax.random.uniform(kc, (), minval=0.7, maxval=1.3)),
            float(jax.random.uniform(ks, (), minval=0.7, maxval=1.3)),
            float(jax.random.uniform(kh, (), minval=-h, maxval=h)))


def jax_batch_draws(aug_rng, n):
    """``augment_batch``'s draws for n samples, as the port's dict."""
    vals = [jax_sample_draws(k) for k in jax.random.split(aug_rng, n)]
    flip, b, c, s, h = zip(*vals)
    return {"flip": torch.tensor(flip),
            **{k: torch.tensor(v, dtype=torch.float32)
               for k, v in zip("bcsh", (b, c, s, h))}}


def jax_step_draws(rng, n):
    """The draws of the JAX train step called with ``rng``."""
    aug_rng, _ = jax.random.split(rng)
    return jax_batch_draws(aug_rng, n)


def small_hyper(unet=False, v2=False):
    """train.py's row of the variant at planes 4 (the belly halved too)."""
    h = model_hyper(unet, v2)
    return dict(h, planes=4, belly_planes=h["belly_planes"] // 2)


VARIANTS = {"flagship": dict(small_hyper()),
            "unet": dict(small_hyper(unet=True), pool=True),
            "v2": dict(small_hyper(v2=True), v2=True)}


def _models(kw, seed=0):
    jm = jzoo.make("robo_unet", **kw)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = zoo.make("robo_unet", device="cpu", **kw)
    tm.load_state_dict(torch_io.from_jax_params(tm.registry, jp))
    return jm, jp, tm


def _batch(seed, n=4, pad=1):
    rng = np.random.default_rng(seed)
    low = rng.standard_normal((n, H // 8, W // 8, 3)).astype(np.float32)
    imgs = np.repeat(np.repeat(low, 8, axis=1), 8, axis=2)
    labs = rng.integers(0, 5, (n, H // 8, W // 8))
    labs = np.repeat(np.repeat(labs, 8, axis=1), 8, axis=2).astype(np.int32)
    mask = np.ones(n, np.float32)
    mask[n - pad:] = 0
    return imgs, labs, mask


def _assert_params_close(got, want_jax, reg, tol):
    want = torch_io.from_jax_params(reg, {k: np.asarray(v)
                                          for k, v in want_jax.items()})
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                   rtol=tol, atol=tol, err_msg=k)


# ---- layers -------------------------------------------------------------------


@pytest.mark.parametrize("mask", [None, [1, 1, 1, 0], [0, 0, 0, 0]],
                         ids=["unmasked", "one_padded", "all_padding"])
def test_train_batch_norm_matches_jax(mask):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 5, 6, 3)) * 2 + 1).astype(np.float32)
    g, b = rng.random(3).astype(np.float32) + 0.5, rng.standard_normal(3).astype(np.float32)
    rm, rv = rng.standard_normal(3).astype(np.float32), rng.random(3).astype(np.float32) + 1
    m = None if mask is None else np.asarray(mask, np.float32)
    want = jnn.batch_norm(*(jnp.asarray(a) for a in (x, g, b, rm, rv)),
                          train=True,
                          sample_mask=None if m is None else jnp.asarray(m))
    got = nn.batch_norm_train(*(torch.from_numpy(a) for a in (x, g, b, rm, rv)),
                              sample_mask=None if m is None else torch.from_numpy(m))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-5,
                                   atol=1e-5)
    if mask is not None and not any(mask):
        np.testing.assert_array_equal(got[1].numpy(), rm)
        np.testing.assert_array_equal(got[2].numpy(), rv)


def test_padded_slot_leaves_train_forward_unchanged():
    """The real samples of a batch with a padded slot see the statistics
    of the real samples alone, whatever the padded slot holds."""
    _, _, tm = _models(VARIANTS["flagship"])
    imgs, _, mask = _batch(2)
    x = torch.from_numpy(imgs)
    noisy = x.clone()
    noisy[-1] = 100.0
    out = []
    for batch in (x, noisy):
        with layers.bn_stats_mask(torch.from_numpy(mask)):
            out.append(tm.apply(tm.flat(), batch, train=True))
    torch.testing.assert_close(out[0][0][:3], out[1][0][:3])
    for k in out[0][1]:
        torch.testing.assert_close(out[0][1][k], out[1][1][k])


def test_augment_with_jax_draws_matches_jax():
    rng = np.random.default_rng(3)
    imgs = rng.standard_normal((6, 8, 10, 3)).astype(np.float32)
    labs = rng.integers(0, 5, (6, 8, 10)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    want_i, want_l = jcolor.augment_batch(key, jnp.asarray(imgs),
                                          jnp.asarray(labs))
    draws = jax_batch_draws(key, 6)
    assert 0 < int(draws["flip"].sum()) < 6  # both branches run
    got_i, got_l = color.augment_batch(torch.from_numpy(imgs),
                                       torch.from_numpy(labs), draws)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_augment_sample_with_jax_draws_matches_jax():
    rng = np.random.default_rng(5)
    img = rng.standard_normal((8, 10, 3)).astype(np.float32)
    lab = rng.integers(0, 5, (8, 10)).astype(np.int32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want_i, want_l = jcolor.augment_sample(key, jnp.asarray(img),
                                               jnp.asarray(lab))
        flip, b, c, s, h = jax_sample_draws(key)
        got_i, got_l = color.augment_sample(
            torch.from_numpy(img), torch.from_numpy(lab),
            {"flip": torch.tensor(flip), "b": b, "c": c, "s": s, "h": h})
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_draw_augment_ranges():
    d = color.draw_augment(torch.Generator().manual_seed(0), 4096)
    assert 0.45 < float(d["flip"].float().mean()) < 0.55
    for k, lo, hi in (("b", -0.3, 0.3), ("c", 0.7, 1.3), ("s", 0.7, 1.3),
                      ("h", -3.1415 / 6, 3.1415 / 6)):
        assert lo <= float(d[k].min()) and float(d[k].max()) < hi, k
        assert abs(float(d[k].mean()) - (lo + hi) / 2) < 0.02 * (hi - lo), k


def test_schedules_match_jax():
    cases = [("StepLR", ([0.1], 3, 0.5)), ("MultiStepLR", ([0.1], [2, 5])),
             ("ExponentialLR", ([0.1], 0.9)),
             ("CosineAnnealingLR", ([1e-3], 10, 1e-4)),
             ("LambdaLR", ([0.2], lambda e: 1.0 / (e + 1)))]
    for name, args in cases:
        a, b = getattr(schedules, name)(*args), getattr(jschedules, name)(*args)
        for _ in range(12):
            assert a.get_lr() == b.get_lr(), name
            a.step()
            b.step()
    fired = []
    for mod, log in ((schedules, fired), (jschedules, [])):
        s = mod.ReduceLROnPlateau(1.0, patience=1, cooldown=1,
                                  cb=lambda log=log: log.append(1))
        lrs = [s.step(m) for m in (5, 4, 4, 4, 4, 4, 3, 3, 3)]
        log.append(lrs)
    j = jschedules.ReduceLROnPlateau(1.0, patience=1, cooldown=1)
    assert fired[-1] == [j.step(m) for m in (5, 4, 4, 4, 4, 4, 3, 3, 3)]
    assert fired.count(1) >= 1


@pytest.mark.parametrize("tx", ["adam", "sgd", "sgd_momentum_wd"])
def test_optimizer_transforms_match_optax(tx):
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    if tx == "adam":
        ours, theirs = optim.adam(), joptim.adam()
    elif tx == "sgd":
        ours, theirs = optim.sgd(), joptim.sgd()
    else:
        ours, theirs = optim.sgd(0.9, 1e-2), joptim.sgd(0.9, 1e-2)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ts, js = ours.init(tp), theirs.init(jp)
    for i in range(4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 10.0 ** -i
             for k, v in params.items()}
        td, ts = ours.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        jd, js = theirs.update({k: jnp.asarray(v) for k, v in g.items()},
                               js, jp)
        tp = optim.apply_updates(tp, td, 0.01, {"a": 10.0})
        jp = joptim.apply_updates(jp, jd, jnp.float32(0.01), {"a": 10.0})
        for k in params:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)


def test_transfer_multipliers_match_jax():
    order = zoo.make("robo_unet", device="cpu", **small_hyper()).param_order
    for t in range(5):
        ours = optim.transfer_multipliers(order, t)
        assert ours == joptim.transfer_multipliers(order, t)
        tens = {k for k, v in ours.items() if v == 10.0}
        assert tens == {k for k in order if any(
            k.startswith(f"downPart.Level{i}.") for i in range(t))}


def test_checkpoint_names_match_jax():
    for kw in (dict(), dict(finetune=True, v2=True, no_ball=True, top_cam=True),
               dict(no_scale=True, unet=True, no_line=True, bottom_cam=True),
               dict(finetune=True, no_goal=True, no_robot=True)):
        ours, theirs = naming.Flags(**kw), jnaming.Flags(**kw)
        for args in ((0,), (2,), (0, True, 37, 12)):
            assert naming.train_ckpt_name(ours, *args) \
                == jnaming.train_ckpt_name(theirs, *args)
        assert naming.train_load_name(ours) == jnaming.train_load_name(theirs)


def test_pruning_matches_jax():
    _, jp, tm = _models(VARIANTS["flagship"], seed=5)
    state = tm.state_dict()
    new, masks = pruning.prune_threshold(state, tm.param_order, verbose=False)
    jnew, jmasks = jpruning.prune_threshold(
        {k: np.asarray(v) for k, v in jp.items()}, tm.param_order,
        verbose=False)
    assert set(masks) == set(jmasks)
    carried = torch_io.to_jax_params(tm.registry, new)
    for k in jnew:
        np.testing.assert_array_equal(carried[k], np.asarray(jnew[k]),
                                      err_msg=k)
    assert float(pruning.near_zero_fraction(new, tm.param_order)) \
        == pytest.approx(float(jpruning.near_zero_fraction_traceable(
            {k: jnp.asarray(v) for k, v in jnew.items()}, tm.param_order)),
            rel=1e-6)
    assert pruning.count_zero_weights(new, tm.param_order) == pytest.approx(
        float(pruning.near_zero_fraction(new, tm.param_order)), rel=1e-6)


# ---- the train step ----------------------------------------------------------


def _steps(variant, loss, tx_name, n_steps, lr, transfer=0):
    """(port losses, JAX losses, port corrects, JAX corrects, port state,
    JAX state, registry) after ``n_steps`` from the same carried weights,
    batch and draws."""
    kw = VARIANTS[variant]
    jm, jp, tm = _models(kw, seed=11)
    weights = DICE_WEIGHTS if loss == "dice" else WEIGHTS
    common = dict(num_classes=5, loss=loss, class_weights=weights,
                  l1_decay=1e-6, out_size=1.0 / (H * W))
    tcfg, jcfg = tstep.StepCfg(**common), jstep.StepCfg(**common)
    ttx, jtx = (optim.adam(), joptim.adam()) if tx_name == "adam" \
        else (optim.sgd(), joptim.sgd())
    mult = optim.transfer_multipliers(tm.param_order, transfer) \
        if transfer else None
    tfn = tstep.make_train_step(tm, ttx, tcfg, mult)
    jfn = jstep.make_train_step(jm, jtx, jcfg, mult, donate=False)
    tst = tstep.init_state(tm, ttx)
    jst = jstep.TrainState(jp, jtx.init(jlayers.split_params(jp)[0]))
    imgs, labs, mask = _batch(12)
    tl, jl, tc, jc = [], [], [], []
    for i in range(n_steps):
        rng = jax.random.PRNGKey(100 + i)
        jst, jo = jfn(jst, jnp.asarray(imgs), jnp.asarray(labs),
                      jnp.asarray(mask), rng, jnp.float32(lr), None)
        tst, to = tfn(tst, torch.from_numpy(imgs), torch.from_numpy(labs),
                      torch.from_numpy(mask), jax_step_draws(rng, 4), lr,
                      None)
        tl.append(float(to["loss"]))
        jl.append(float(jo["loss"]))
        tc.append(float(to["correct"]))
        jc.append(float(jo["correct"]))
        assert float(to["img_cnt"]) == float(jo["img_cnt"]) == 3.0
        assert float(to["reg"]) == pytest.approx(float(jo["reg"]), rel=1e-5)
    return tl, jl, tc, jc, tst, jst, tm.registry


@pytest.mark.parametrize("variant,loss", [("flagship", "ce2d"),
                                          ("unet", "ce2d"), ("v2", "ce2d"),
                                          ("flagship", "dice")])
def test_sgd_step_matches_jax(variant, loss):
    tl, jl, _, _, tst, jst, reg = _steps(variant, loss, "sgd", 1, 0.5)
    assert tl[0] == pytest.approx(jl[0], rel=1e-5)
    _assert_params_close(tst.params, jst.params, reg, 1e-4)


@pytest.mark.parametrize("variant,loss", [("flagship", "ce2d"),
                                          ("unet", "ce2d"), ("v2", "ce2d"),
                                          ("flagship", "dice")])
def test_adam_loss_trajectory_matches_jax(variant, loss):
    tl, jl, tc, jc, _, _, _ = _steps(variant, loss, "adam", 3, 1e-3)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[2] < tl[0]  # it learns
    # argmax flips at near-ties: at most 1e-3 of the 3 * H * W real pixels
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-3 * 3 * H * W)


def test_sgd_step_with_transfer_multipliers_matches_jax():
    tl, jl, _, _, tst, jst, reg = _steps("flagship", "ce2d", "sgd", 1, 0.1,
                                         transfer=2)
    assert tl[0] == pytest.approx(jl[0], rel=1e-5)
    _assert_params_close(tst.params, jst.params, reg, 1e-4)


def test_prune_masks_keep_pruned_weights_at_zero():
    _, _, tm = _models(VARIANTS["flagship"], seed=3)
    params, masks = pruning.prune_threshold(tm.state_dict(), tm.param_order,
                                            ratio=0.3, verbose=False)
    tx = optim.adam()
    cfg = tstep.StepCfg(num_classes=5, class_weights=WEIGHTS, l1_decay=1e-6)
    fn = tstep.make_train_step(tm, tx, cfg)
    trainable, _ = layers.split_params(params)
    st = tstep.TrainState(params, tx.init(trainable))
    imgs, labs, mask = _batch(13)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        st, _ = fn(st, torch.from_numpy(imgs), torch.from_numpy(labs),
                   torch.from_numpy(mask), color.draw_augment(gen, 4), 1e-2,
                   masks)
    moved = 0
    for k, m in masks.items():
        assert bool((st.params[k][m] == 0).all()), k
        moved += int((st.params[k][~m] != params[k][~m]).sum())
    assert moved > 0


def test_unported_step_options_raise():
    """Packed training refuses what the JAX package's asserts refuse
    (``pool``), and an unknown remat mode is a ValueError."""
    tm = zoo.make("robo_unet", device="cpu", **small_hyper())
    unet = zoo.make("robo_unet", device="cpu", **VARIANTS["unet"])
    with pytest.raises(AssertionError):
        tstep.make_train_step(unet, optim.adam(),
                              tstep.StepCfg(num_classes=5, packed=True))
    with pytest.raises(ValueError, match="remat"):
        tstep.make_train_step(tm, optim.adam(),
                              tstep.StepCfg(num_classes=5, remat="bogus"))


# ---- the slice: Trainer.train_run --------------------------------------------


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return make_dataset_root(str(tmp_path_factory.mktemp("rc_train")),
                             size=(H, W))


def jax_train_run_draws(seed, epochs, n, batch):
    """The permutations and per-batch draws of the JAX Trainer.train_run
    (one chunk) of a Trainer seeded with ``seed``."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    nb = -(-n // batch)
    perms, draws = [], []
    for ei in range(epochs):
        perm_rng, step_rng = jax.random.split(jax.random.fold_in(sub, ei))
        perms.append(np.asarray(jax.random.permutation(perm_rng, n)))
        for bi in range(nb):
            draws.append(jax_step_draws(jax.random.fold_in(step_rng, bi),
                                        batch))
    return perms, draws


def test_train_run_matches_jax(data_root):
    """Two epochs of train_run from the same carried weights with the JAX
    run's permutations and draws: every epoch's metric line (train loss,
    pixel accuracy, val loss, pixel, class accuracy, IoU, score) within
    1e-3, and the same best epoch."""
    train = JSSYUV(data_root, (H, W), True).load_all()
    val = JSSYUV(data_root, (H, W), False).load_all()
    kw = VARIANTS["flagship"]
    jm, jp, tm = _models(kw, seed=21)
    common = dict(num_classes=5, class_weights=WEIGHTS, l1_decay=1e-6,
                  out_size=1.0 / (H * W))
    batch, epochs, lrs = 5, 2, [1e-3, 5e-4]
    jtr = jloop.Trainer(jm, joptim.adam(), jstep.StepCfg(**common),
                        jdevice_cache.DeviceCache.from_numpy(*train),
                        jdevice_cache.DeviceCache.from_numpy(*val), batch)
    jtr.set_params({k: np.asarray(v) for k, v in jp.items()})
    jbest, jbp, jms = jtr.train_run(epochs, lrs)

    ttr = loop.Trainer(tm, optim.adam(), tstep.StepCfg(**common),
                       device_cache.DeviceCache.from_numpy(*train, device="cpu"),
                       device_cache.DeviceCache.from_numpy(*val, device="cpu"),
                       batch)
    ttr.init()
    perms, draws = jax_train_run_draws(12345678, epochs, train[0].shape[0],
                                       batch)
    perms, draws = iter(perms), iter(draws)
    ttr.draw_perm = lambda n: torch.from_numpy(np.array(next(perms)))
    ttr.draw_augment = lambda n: next(draws)
    tbest, tbp, tms = ttr.train_run(epochs, lrs)
    for k in ("train_loss", "train_reg", "train_pixel_acc", "val_loss",
              "pixel_acc", "mean_class_acc", "mean_iou", "score", "pruned"):
        np.testing.assert_allclose(tms[k], np.asarray(jms[k]), rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    np.testing.assert_allclose(tms["conf"], np.asarray(jms["conf"]),
                               atol=1e-3)
    np.testing.assert_array_equal(tms["better"], np.asarray(jms["better"]))
    assert tbest == pytest.approx(jbest, abs=1e-3)
    assert (tbp is None) == (jbp is None)
    if tbp is not None:
        # Adam moves a weight by about lr a step whatever its gradient, so
        # a near-zero gradient's sign flip can part the two by up to
        # steps * lr; all but a few weights agree within 1e-3
        want = torch_io.from_jax_params(
            tm.registry, {k: np.asarray(v) for k, v in jbp.items()})
        steps = epochs * -(-train[0].shape[0] // batch)
        diffs = np.concatenate([np.abs(tbp[k] - want[k].numpy()).ravel()
                                for k in want])
        assert diffs.max() <= steps * max(lrs)
        assert np.mean(diffs > 1e-3) < 1e-3


# ---- the CLI ------------------------------------------------------------------

LAB = ["--labSize", str(H), str(W)]


def _cli(argv):
    from robocupvision_tpu_torch.cli import train as tcli

    return tcli.main(argv, device="cpu")


def test_train_cli_end_to_end(data_root, tmp_path, monkeypatch, capsys):
    """train.py on the synthetic set at 48x64: rc 0, the best checkpoint
    under the reference's name, readable by the JAX package; the masked
    flags write their own name. f32 training turns TF32 off."""
    from robocupvision_tpu.train import checkpoint as jckpt
    from robocupvision_tpu_torch.train import checkpoint

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert _cli(["--root", data_root, "--epochs", "3", "--batchSize", "8"]
                + LAB) == 0
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    out = capsys.readouterr().out
    assert "Saving best model" in out and "[Epoch Val 3/3" in out
    path = "checkpoints/best.weights"
    reg = zoo.make("robo_unet", device="cpu", **model_hyper(False, False)
                   ).registry
    ours = checkpoint.load_any(path, reg)
    theirs = jckpt.load_any(path, jzoo.make("robo_unet", **model_hyper(
        False, False)).registry)
    carried = torch_io.to_jax_params(reg, ours)
    for k in theirs:
        np.testing.assert_array_equal(carried[k], theirs[k], err_msg=k)
    assert _cli(["--root", data_root, "--epochs", "1", "--batchSize", "8",
                 "--noBall", "--noLine"] + LAB) == 0
    assert os.path.exists("checkpoints/bestNoBallNoLine.weights")


@pytest.mark.parametrize("flags,name", [(["--UNet"], "bestUNet"),
                                        (["--v2", "--bf16"], "bestv2"),
                                        (["--bf16", "--useDice"], "best")])
def test_train_cli_variants(data_root, tmp_path, monkeypatch, capsys, flags,
                            name):
    monkeypatch.chdir(tmp_path)
    assert _cli(["--root", data_root, "--epochs", "1", "--batchSize", "8"]
                + flags + LAB) == 0
    assert "[Epoch Train 1/1" in capsys.readouterr().out
    assert os.path.exists(f"checkpoints/{name}.weights")


def test_train_cli_resume_matches_uninterrupted(data_root, tmp_path,
                                                monkeypatch):
    """A --resume run killed after its first chunk and restarted ends with
    the same best checkpoint as a run never stopped."""
    from robocupvision_tpu_torch.train import checkpoint

    argv = ["--root", data_root, "--epochs", "3", "--batchSize", "8",
            "--chunkEpochs", "1", "--resume"] + LAB
    reg = zoo.make("robo_unet", device="cpu", **model_hyper(False, False)
                   ).registry
    (tmp_path / "a").mkdir()
    monkeypatch.chdir(tmp_path / "a")
    assert _cli(argv) == 0
    want = checkpoint.load_any("checkpoints/best.weights", reg)
    assert [f for f in os.listdir("checkpoints") if "resume" in f] == []

    class Kill(Exception):
        pass

    real = checkpoint.save_resume

    def killing(*a, **k):
        real(*a, **k)
        raise Kill

    (tmp_path / "b").mkdir()
    monkeypatch.chdir(tmp_path / "b")
    monkeypatch.setattr(checkpoint, "save_resume", killing)
    with pytest.raises(Kill):
        _cli(argv)
    assert os.path.exists("checkpoints/best.weights.resume-T0-1e-06.npz")
    monkeypatch.setattr(checkpoint, "save_resume", real)
    assert _cli(argv) == 0
    got = checkpoint.load_any("checkpoints/best.weights", reg)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_train_cli_finetune_prunes(data_root, tmp_path, monkeypatch, capsys):
    """--finetune loads the un-finetuned weights, runs its decay sweep and
    the prune-and-finetune phase, and writes the pruned name."""
    monkeypatch.chdir(tmp_path)
    assert _cli(["--root", data_root, "--epochs", "1", "--batchSize", "8"]
                + LAB) == 0
    assert _cli(["--root", data_root, "--epochs", "1", "--batchSize", "8",
                 "--finetune", "--chunkEpochs", "0"] + LAB) == 0
    out = capsys.readouterr().out
    assert "Loading checkpoints/best.weights" in out
    assert "Finetuning" in out and "[Epoch Val 25/25]" in out
    assert os.path.exists("checkpoints/bestFinetune.weights")
    pruned = [f for f in os.listdir("checkpoints")
              if f.startswith("bestFinetune") and "_" in f]
    assert pruned, os.listdir("checkpoints")


def test_train_cli_rejects_all_background(capsys):
    assert _cli(["--noBall", "--noGoal", "--noRobot", "--noLine"]) == -1
    assert "non-background" in capsys.readouterr().out


def test_trainer_epoch_valid_and_pruned_match_jax(data_root):
    """``train_epoch`` (the JAX run's permutation and draws injected),
    ``valid_epoch`` and ``pruned_fraction`` against the JAX Trainer's, from
    the same carried weights set by ``set_params``."""
    train = JSSYUV(data_root, (H, W), True).load_all()
    val = JSSYUV(data_root, (H, W), False).load_all()
    jm, jp, tm = _models(VARIANTS["v2"], seed=23)
    common = dict(num_classes=5, class_weights=WEIGHTS, l1_decay=1e-6,
                  out_size=1.0 / (H * W))
    batch = 5
    jtr = jloop.Trainer(jm, joptim.adam(), jstep.StepCfg(**common),
                        jdevice_cache.DeviceCache.from_numpy(*train),
                        jdevice_cache.DeviceCache.from_numpy(*val), batch)
    jtr.set_params({k: np.asarray(v) for k, v in jp.items()})
    ttr = loop.Trainer(tm, optim.adam(), tstep.StepCfg(**common),
                       device_cache.DeviceCache.from_numpy(*train, device="cpu"),
                       device_cache.DeviceCache.from_numpy(*val, device="cpu"),
                       batch)
    ttr.set_params(tm.state_dict())
    _, sub = jax.random.split(jax.random.PRNGKey(12345678))
    perm_rng, step_rng = jax.random.split(sub)
    nb = -(-train[0].shape[0] // batch)
    draws = iter([jax_step_draws(jax.random.fold_in(step_rng, bi), batch)
                  for bi in range(nb)])
    ttr.draw_perm = lambda n: torch.from_numpy(np.array(
        jax.random.permutation(perm_rng, n)))
    ttr.draw_augment = lambda n: next(draws)
    want, got = jtr.train_epoch(1e-3), ttr.train_epoch(1e-3)
    for k in ("loss", "reg"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-4,
                                                abs=1e-6), k
    # argmax flips at near-ties: within 1e-3 of the pixels (0.1 points)
    assert got.pixel_acc == pytest.approx(want.pixel_acc, abs=0.1)
    want, got = jtr.valid_epoch(), ttr.valid_epoch()
    for k in ("loss", "pixel_acc", "mean_class_acc", "mean_iou", "score"):
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-3), k
    # percentages of each label's pixels: a few argmax flips move them
    np.testing.assert_allclose(got["conf"], want["conf"], atol=0.1)
    assert ttr.pruned_fraction() == pytest.approx(jtr.pruned_fraction(),
                                                  abs=1e-3)
    assert set(ttr.params_numpy()) == set(tm.state_dict())
