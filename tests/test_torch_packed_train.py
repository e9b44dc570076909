"""The port's packed training graph and ``StepCfg.remat`` against the JAX
package's, on the CPU.

The gather maps (``build_train_pack_maps``, built over the port's torch
layouts) pick exactly the weight JAX's ``_gather_index_map`` picks, after
the layout transform; ``packed_train_apply`` against JAX's and against
the port's own unpacked train-mode forward (planes 4, depth 4, levels 2,
belly 2 x 16, (3, 48, 64, 3) inputs: logits at atol 2e-4 / rtol 1e-4,
the new running statistics at atol 1e-5 / rtol 1e-4); one plain-SGD
packed step (class weights, L1 term, one padded sample) against JAX's
packed step and the port's unpacked step at atol 1e-5 / rtol 1e-4, then
three Adam steps whose losses and ``correct`` counts stay together;
``remat`` none, dots and full equal to one another (loss within 1e-6,
params at atol 1e-6 / rtol 1e-5), also with a padded sample and dropout
(LabelProp with dropout, PB_FCN_2 classifying), where a recompute outside
the step's contexts would change the gradients.

jax.random and torch's generators differ, so the port gets the values
the JAX package drew (augmentation draws recomputed from its keys).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robocupvision_tpu.models import layers as jlayers
from robocupvision_tpu.models import packed as jpacked
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu.train import optim as joptim
from robocupvision_tpu.train import step as jstep
from robocupvision_tpu_torch.export import torch_io
from robocupvision_tpu_torch.models import layers, packed, zoo
from robocupvision_tpu_torch.ops import color
from robocupvision_tpu_torch.train import optim
from robocupvision_tpu_torch.train import step as tstep

H, W = 48, 64
KW = dict(planes=4, depth=4, levels=2, belly_size=2, belly_planes=16)
STEP = dict(num_classes=5, class_weights=(1, 10, 30, 10, 2), l1_decay=1e-6,
            out_size=1.0 / (H * W))


def _models(family="robo_unet", kw=KW, seed=0):
    jm = jzoo.make(family, **kw)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = zoo.make(family, device="cpu", **kw)
    tm.load_state_dict(torch_io.from_jax_params(tm.registry, jp))
    return jm, jp, tm


def jax_step_draws(rng, n):
    """``augment_batch``'s draws inside the JAX train step called with
    ``rng``, as the port's dict."""
    aug_rng, _ = jax.random.split(rng)
    vals = []
    for k in jax.random.split(aug_rng, n):
        kf, kj = jax.random.split(k)
        kb, kc, ks, kh = jax.random.split(kj, 4)
        h = 3.1415 / 6
        vals.append((bool(jax.random.uniform(kf, ()) > 0.5),
                     float(jax.random.uniform(kb, (), minval=-0.3, maxval=0.3)),
                     float(jax.random.uniform(kc, (), minval=0.7, maxval=1.3)),
                     float(jax.random.uniform(ks, (), minval=0.7, maxval=1.3)),
                     float(jax.random.uniform(kh, (), minval=-h, maxval=h))))
    flip, b, c, s, hh = zip(*vals)
    return {"flip": torch.tensor(flip),
            **{k: torch.tensor(v, dtype=torch.float32)
               for k, v in zip("bcsh", (b, c, s, hh))}}


def _batch(seed=11, n=6):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((n, H, W, 3)).astype(np.float32)
    targets = rng.integers(0, 5, (n, H, W)).astype(np.int32)
    mask = np.ones(n, np.float32)
    mask[-1] = 0  # one padded slot
    return imgs, targets, mask


def _close(got, want, atol, rtol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


# ---- the gather maps ------------------------------------------------------------


def _weight_name(conv):
    return conv + (".weight" if conv.startswith("segmenter") else
                   ".conv.weight")


MAP_CONVS = ["downPart.Level0.layers.Conv0", "downPart.Level1.layers.Conv0",
             "downPart.Level1.layers.Conv1", "downPart.Level2.layers.Conv0",
             "upPart.Up1", "upPart.Up2", "segmenter.layers.Class"]


@pytest.mark.parametrize("conv", MAP_CONVS)
def test_gather_maps_pick_jax_weights(conv):
    """The packed kernel gathered from the torch-layout leaf, carried to
    HWIO, equals JAX's gather from its HWIO leaf, and every structural
    zero sits where JAX's does."""
    jm, jp, tm = _models(seed=1)
    jmaps = jpacked.build_train_pack_maps(jm)
    maps = packed.build_train_pack_maps(tm)
    assert set(maps.gathers) == set(jmaps.idx) == set(MAP_CONVS)
    assert maps.tile == jmaps.tile
    wname = _weight_name(conv)
    want = np.asarray(jpacked._gather_weight(jp, wname, jmaps.idx[conv]))
    got = packed._gather_weight(tm.flat(), wname, maps.gathers[conv]).numpy()
    np.testing.assert_array_equal(np.transpose(got, (2, 3, 1, 0)), want)
    # the gathered positions are exactly JAX's non-sentinel ones
    n = tm.flat()[wname].numel()
    g = maps.gathers[conv]
    read = np.zeros(int(np.prod(g.shape)), bool)
    read[g.pos.numpy()] = True
    np.testing.assert_array_equal(
        np.transpose(read.reshape(g.shape), (2, 3, 1, 0)),
        jmaps.idx[conv] != n)
    assert 0 < read.sum() < read.size


def test_gather_carries_gradients_to_the_leaf():
    """Autograd's gather backward scatter-adds onto the weight: the
    gradient of sum(packed * g) is, per weight, the sum of g over the
    packed positions reading it."""
    _, _, tm = _models(seed=2)
    maps = packed.build_train_pack_maps(tm)
    conv = "upPart.Up1"
    w = tm.flat()[_weight_name(conv)].detach().clone().requires_grad_(True)
    gather = maps.gathers[conv]
    g = torch.randn(gather.shape, generator=torch.Generator().manual_seed(0))
    wp = packed._gather_weight({"w": w}, "w", gather)
    (grad,) = torch.autograd.grad((wp * g).sum(), [w])
    want = torch.zeros(w.numel()).index_add_(
        0, gather.src, g.reshape(-1)[gather.pos])
    torch.testing.assert_close(grad.reshape(-1), want)


# ---- the forward ----------------------------------------------------------------


def test_packed_train_apply_matches_jax_and_unpacked():
    jm, jp, tm = _models()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, H, W, 3)).astype(np.float32)
    want, jmut = jpacked.packed_train_apply(
        jpacked.build_train_pack_maps(jm), jp, jnp.asarray(x), train=True)
    maps = packed.build_train_pack_maps(tm)
    got, mut = packed.packed_train_apply(maps, tm.flat(), torch.from_numpy(x))
    assert tuple(got.shape) == (3, H // 4, W // 4, 16, 5)
    _close(got.detach().numpy(), want, 2e-4, 1e-4)
    assert set(mut) == set(jmut)
    for k in jmut:
        _close(mut[k].numpy(), jmut[k], 1e-5, 1e-4, k)
    # against the port's unpacked train-mode forward, unpacked per pixel
    ref, ref_mut = tm.apply(tm.flat(), torch.from_numpy(x), train=True)
    n, hp, wp, t, c = got.shape
    full = packed.depth_to_space(got.reshape(n, hp, wp, t * c), 4)
    _close(full.detach().numpy(), ref.detach().numpy(), 2e-4, 1e-4)
    assert set(ref_mut) == set(mut)
    for k in ref_mut:
        _close(mut[k].numpy(), ref_mut[k].numpy(), 1e-5, 1e-4, k)
    # eval mode: the running statistics, no new ones
    ev, none = packed.packed_train_apply(maps, tm.flat(), torch.from_numpy(x),
                                         train=False)
    assert none == {}
    full = packed.depth_to_space(ev.reshape(n, hp, wp, t * c), 4)
    _close(full.numpy(), tm(torch.from_numpy(x)).numpy(), 2e-4, 1e-4)


def test_pack_targets_matches_jax():
    rng = np.random.default_rng(4)
    t = rng.integers(0, 5, (2, H, W)).astype(np.int32)
    np.testing.assert_array_equal(
        packed.pack_targets(torch.from_numpy(t)).numpy(),
        np.asarray(jpacked.pack_targets(jnp.asarray(t))))


@pytest.mark.parametrize("kw", [dict(pool=True), dict(v2=True),
                                dict(levels=1), dict(belly_size=0),
                                dict(class_size=3), dict(depth=3)],
                         ids=["pool", "v2", "levels1", "no_belly",
                              "class_size3", "depth3"])
def test_packed_training_refuses_what_jax_refuses(kw):
    tm = zoo.make("robo_unet", device="cpu", **{**KW, **kw})
    with pytest.raises(AssertionError):
        packed.build_train_pack_maps(tm)
    with pytest.raises(AssertionError):
        tstep.make_train_step(tm, optim.sgd(), tstep.StepCfg(
            num_classes=5, packed=True))


def test_packed_training_is_robo_unet_ce2d_only():
    with pytest.raises(AssertionError):
        packed.build_train_pack_maps(zoo.make("pb_fcn", device="cpu",
                                              planes=8))
    tm = zoo.make("robo_unet", device="cpu", **KW)
    with pytest.raises(AssertionError):
        tstep.make_train_step(tm, optim.sgd(), tstep.StepCfg(
            num_classes=5, loss="dice", packed=True))
    with pytest.raises(AssertionError):  # H, W divisible by 8
        packed.packed_train_apply(packed.build_train_pack_maps(tm),
                                  tm.flat(), torch.zeros(1, 44, 64, 3))


# ---- the train step -------------------------------------------------------------


def _run_steps(tx_name, n_steps, lr, packed_port=True):
    """(port losses, JAX losses, port corrects, JAX corrects, port state,
    JAX state, port unpacked state, its losses, registry) after
    ``n_steps`` from the same carried weights, batch and draws."""
    jm, jp, tm = _models(seed=5)
    mk = (lambda: (optim.adam(), joptim.adam())) if tx_name == "adam" \
        else (lambda: (optim.sgd(), joptim.sgd()))
    ttx, jtx = mk()
    jfn = jstep.make_train_step(jm, jtx, jstep.StepCfg(**STEP, packed=True),
                                donate=False)
    tfn = tstep.make_train_step(tm, ttx, tstep.StepCfg(**STEP,
                                                       packed=packed_port))
    ufn = tstep.make_train_step(tm, ttx, tstep.StepCfg(**STEP))
    jst = jstep.TrainState(jp, jtx.init(jlayers.split_params(jp)[0]))
    tst, ust = tstep.init_state(tm, ttx), tstep.init_state(tm, ttx)
    imgs, tgt, mask = _batch()
    out = {k: [] for k in ("tl", "jl", "ul", "tc", "jc", "uc")}
    for i in range(n_steps):
        rng = jax.random.PRNGKey(100 + i)
        jst, jo = jfn(jst, jnp.asarray(imgs), jnp.asarray(tgt),
                      jnp.asarray(mask), rng, jnp.float32(lr), None)
        draws = jax_step_draws(rng, imgs.shape[0])
        args = (torch.from_numpy(imgs), torch.from_numpy(tgt),
                torch.from_numpy(mask), draws, lr, None)
        tst, to = tfn(tst, *args)
        ust, uo = ufn(ust, *args)
        for tag, o in (("t", to), ("j", jo), ("u", uo)):
            out[tag + "l"].append(float(o["loss"]))
            out[tag + "c"].append(float(o["correct"]))
        assert float(to["img_cnt"]) == float(jo["img_cnt"]) == 5.0
    return out, tst, jst, ust, tm.registry


def _assert_params_close(got, want, atol, rtol):
    for k, v in want.items():
        _close(got[k].detach().numpy(), v.detach().numpy(), atol, rtol, k)


def test_packed_sgd_step_matches_jax_and_unpacked():
    """Plain SGD, so the parameter delta is lr * grad: the packed step's
    gradients (through the gathers) against JAX's packed step and the
    port's unpacked step."""
    out, tst, jst, ust, reg = _run_steps("sgd", 1, 1e-3)
    assert out["tl"][0] == pytest.approx(out["jl"][0], abs=1e-4)
    assert out["tl"][0] == pytest.approx(out["ul"][0], abs=1e-4)
    want = torch_io.from_jax_params(reg, {k: np.asarray(v)
                                          for k, v in jst.params.items()})
    _assert_params_close(tst.params, want, 1e-5, 1e-4)
    _assert_params_close(tst.params, ust.params, 1e-5, 1e-4)


def test_packed_adam_trajectory_matches_jax_and_unpacked():
    """Three Adam steps: the losses stay together (Adam's rescaling
    amplifies reassociation noise on near-zero gradients, so parameters
    are not compared), and ``correct`` within 1e-3 of the real pixels
    (argmax flips at near-ties)."""
    out, _, _, _, _ = _run_steps("adam", 3, 1e-3)
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-4)
    np.testing.assert_allclose(out["tl"], out["ul"], rtol=1e-4)
    for other in ("jc", "uc"):
        np.testing.assert_allclose(out["tc"], out[other], rtol=0,
                                   atol=1e-3 * 5 * H * W)
    assert out["tl"][2] < out["tl"][0]


# ---- remat ------------------------------------------------------------------------


def _remat_runs(family, kw, cfg_kw, x, tgt, mask, draws, keep, tx_name):
    """One step of each remat mode from the same weights and inputs."""
    _, _, tm = _models(family, kw, seed=6)
    outs = {}
    for remat in ("none", "dots", "full"):
        tx = optim.adam() if tx_name == "adam" else optim.sgd(0.9, 1e-3)
        fn = tstep.make_train_step(tm, tx, tstep.StepCfg(**cfg_kw,
                                                         remat=remat))
        outs[remat] = fn(tstep.init_state(tm, tx), x, tgt, mask, draws, 1e-3,
                         None, keep)
    return outs


def _assert_remat_equal(outs):
    for remat in ("dots", "full"):
        assert abs(float(outs[remat][1]["loss"])
                   - float(outs["none"][1]["loss"])) < 1e-6
        for k, v in outs["none"][0].params.items():
            _close(outs[remat][0].params[k].numpy(), v.numpy(), 1e-6, 1e-5,
                   f"{remat}: {k}")


@pytest.mark.parametrize("packed_step", [False, True],
                         ids=["unpacked", "packed"])
def test_remat_step_matches_plain(packed_step):
    imgs, tgt, mask = _batch(12, n=4)
    mask[:] = 1
    draws = color.draw_augment(torch.Generator().manual_seed(0), 4)
    outs = _remat_runs("robo_unet", KW, dict(STEP, packed=packed_step),
                       torch.from_numpy(imgs), torch.from_numpy(tgt),
                       torch.from_numpy(mask), draws, None, "adam")
    _assert_remat_equal(outs)


# (family, zoo kwargs, step configuration, input shape): a padded sample
# and dropout, whose masks reach the blocks through the train-mode contexts
DROPOUT_NETS = {
    "label_prop_dropout": ("label_prop", dict(planes=8, dropout=0.2),
                           dict(num_classes=5, augment_mode="legacy",
                                jitter=False, class_weights=(1, 6, 1, 3, 2),
                                out_size=1.0 / (H * W)), (4, H, W, 8)),
    "pb_fcn_2_class": ("pb_fcn_2", dict(planes=8, belly_planes=16,
                                        classify=True),
                       dict(num_classes=5, loss="ce",
                            augment_mode="legacy_hflip"), (4, 32, 32, 3)),
}


@pytest.mark.parametrize("net", list(DROPOUT_NETS))
def test_remat_with_padding_and_dropout_matches_plain(net):
    """A recompute that ran outside the step's train-mode contexts (BN in
    eval mode, or without the sample mask, or without the drops) would
    give other gradients: here the padded sample holds large values and
    the keep masks drop channels."""
    family, kw, cfg_kw, shape = DROPOUT_NETS[net]
    rng = np.random.default_rng(13)
    x = rng.standard_normal(shape).astype(np.float32)
    x[-1] = 50.0  # the padded sample
    n = shape[0]
    tgt = rng.integers(0, 5, n if cfg_kw.get("loss") == "ce"
                       else (n, H, W)).astype(np.int32)
    mask = np.ones(n, np.float32)
    mask[-1] = 0
    gen = torch.Generator().manual_seed(1)
    _, _, tm = _models(family, kw)
    keep = tm.draw_dropout(gen, n, shape[1:3])
    assert any(not bool(k.all()) for k in keep.values())
    draws = color.AUGMENT_MODES[cfg_kw["augment_mode"]][0](gen, n)
    outs = _remat_runs(family, kw, cfg_kw, torch.from_numpy(x),
                       torch.from_numpy(tgt), torch.from_numpy(mask), draws,
                       keep, "sgd")
    _assert_remat_equal(outs)
    # the step moved the params: the comparison is not of a no-op
    trainable, _ = layers.split_params(tm.flat())
    assert any(not torch.equal(outs["full"][0].params[k], v)
               for k, v in trainable.items())


def test_remat_rejects_unknown_mode():
    tm = zoo.make("robo_unet", device="cpu", **KW)
    with pytest.raises(ValueError, match="remat"):
        tstep.make_train_step(tm, optim.sgd(), tstep.StepCfg(
            num_classes=5, remat="bogus"))


def test_packed_remat_and_bf16_run():
    """The options combine: packed with remat="dots" in bf16 gives the
    packed f32 step's loss within bf16's rounding."""
    _, _, tm = _models(seed=7)
    imgs, tgt, mask = _batch(14, n=3)
    args = (torch.from_numpy(imgs), torch.from_numpy(tgt),
            torch.from_numpy(mask), color.draw_augment(
                torch.Generator().manual_seed(2), 3), 1e-3, None)
    losses = []
    for extra in (dict(), dict(remat="dots", compute_dtype="bfloat16")):
        cfg = dataclasses.replace(tstep.StepCfg(**STEP, packed=True), **extra)
        fn = tstep.make_train_step(tm, optim.adam(), cfg)
        _, out = fn(tstep.init_state(tm, optim.adam()), *args)
        losses.append(float(out["loss"]))
    assert np.isfinite(losses).all()
    assert losses[1] == pytest.approx(losses[0], rel=2e-2)
