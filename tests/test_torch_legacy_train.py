"""The port's legacy training pipeline against the JAX package's, on the
CPU, at small size (planes 8, 32x32 patches, 48x64 frames).

The new ops (adaptive pooling, dropout with the JAX keep mask injected,
the legacy augmentation and the random enhancers with the JAX draws
recomputed from its keys), the train-mode forwards of PB_FCN, PB_FCN_2
and LabelProp (logits and new BN running statistics within 1e-4), one SGD
step of each (momentum, weight decay, class weights, a padded sample)
within 1e-4 on every parameter, the classification loss and counts, the
``ce`` validation, ``prune_band`` (exact), and ``run_plateau_training``
driven by a stub trainer with a scripted loss (the same learning rates,
rollbacks, saves, prints and best as the JAX function).

jax.random and torch's generators differ, so every test hands the port
the values the JAX package drew.
"""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robocupvision_tpu.data import device_cache as jdevice_cache
from robocupvision_tpu.models import layers as jlayers
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu.ops import color as jcolor
from robocupvision_tpu.ops import losses as jlosses
from robocupvision_tpu.ops import metrics as jmetrics
from robocupvision_tpu.ops import nn as jnn
from robocupvision_tpu.ops import pruning as jpruning
from robocupvision_tpu.train import legacy as jlegacy
from robocupvision_tpu.train import loop as jloop
from robocupvision_tpu.train import optim as joptim
from robocupvision_tpu.train import step as jstep
from robocupvision_tpu_torch.data import datasets, device_cache
from robocupvision_tpu_torch.export import torch_io
from robocupvision_tpu_torch.models import layers, zoo
from robocupvision_tpu_torch.ops import color, losses, metrics, nn, pruning
from robocupvision_tpu_torch.train import legacy, loop, optim
from robocupvision_tpu_torch.train import step as tstep

H, W = 48, 64
PATCH = 32

# (family, zoo kwargs, input channels, classify): the nets at planes 8
NETS = {
    "pb_fcn_class": ("pb_fcn", dict(planes=8, classify=True), 3),
    "pb_fcn_seg": ("pb_fcn", dict(planes=8), 3),
    "pb_fcn_2_class": ("pb_fcn_2", dict(planes=8, belly_planes=16,
                                        classify=True), 3),
    "pb_fcn_2_seg": ("pb_fcn_2", dict(planes=8, belly_planes=16), 3),
    "label_prop": ("label_prop", dict(planes=8), 8),
    "label_prop_dropout": ("label_prop", dict(planes=8, dropout=0.2), 8),
}


def _models(net, seed=0):
    family, kw, _ = NETS[net]
    jm = jzoo.make(family, **kw)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = zoo.make(family, device="cpu", **kw)
    tm.load_state_dict(torch_io.from_jax_params(tm.registry, jp))
    return jm, jp, tm


def _classify(net):
    return NETS[net][1].get("classify", False)


def _images(rng, n, h, w, grey=True):
    """YUV-normalized images (the legacy datasets' form) of random RGB, a
    few pixels black, white or grey, so the jitter's HSV conversion meets
    its s = 0 and hue-wrap branches."""
    rgb = rng.random((n, h, w, 3)).astype(np.float32)
    if grey:
        rgb[:, 0, :4] = 0.0
        rgb[:, 1, :4] = 1.0
        rgb[:, 2, :4] = 0.5
        rgb[:, 3, :4] = [0.9, 0.05, 0.1]  # red: its hue wraps past 0
    return np.stack([datasets.legacy_normalize(im) for im in rgb])


def _batch(net, seed, n=4, pad=1):
    """(inputs, targets, sample mask) for ``net``: 32x32 patches and class
    indices to classify, 48x64 frames (LabelProp: 8 channels) and label
    maps (blocks of 8x8) to segment; the last ``pad`` samples padded."""
    rng = np.random.default_rng(seed)
    cin = NETS[net][2]
    if _classify(net):
        x = _images(rng, n, PATCH, PATCH)
        y = rng.integers(0, 5, n).astype(np.int32)
    else:
        x = _images(rng, n, H, W) if cin == 3 else \
            rng.standard_normal((n, H, W, cin)).astype(np.float32)
        y = rng.integers(0, 5, (n, H // 8, W // 8))
        y = np.repeat(np.repeat(y, 8, axis=1), 8, axis=2).astype(np.int32)
    mask = np.ones(n, np.float32)
    mask[n - pad:] = 0
    return x, y, mask


# ---- the JAX package's draws, recomputed from its keys -----------------------


def jax_legacy_draws(key, n, use_vflip=True):
    """``legacy_augment_batch``'s draws for n samples, as the port's dict."""
    out = {k: [] for k in ("hflip", "vflip", "b", "c", "s", "h", "order")}
    for k in jax.random.split(key, n):
        kh_, kv_, kj = jax.random.split(k, 3)
        kb, kc, ks, kh, kp = jax.random.split(kj, 5)
        out["hflip"].append(bool(jax.random.uniform(kh_, ()) < 0.5))
        out["vflip"].append(use_vflip
                            and bool(jax.random.uniform(kv_, ()) < 0.5))
        out["b"].append(float(jax.random.uniform(kb, (), minval=0.5,
                                                 maxval=1.5)))
        out["c"].append(float(jax.random.uniform(kc, (), minval=0.5,
                                                 maxval=1.5)))
        out["s"].append(float(jax.random.uniform(ks, (), minval=0.6,
                                                 maxval=1.4)))
        out["h"].append(float(jax.random.uniform(kh, (), minval=-0.3,
                                                 maxval=0.3)))
        out["order"].append(np.asarray(jax.random.permutation(kp, 4)))
    return {"hflip": torch.tensor(out["hflip"]),
            "vflip": torch.tensor(out["vflip"]),
            **{k: torch.tensor(out[k], dtype=torch.float32) for k in "bcsh"},
            "order": torch.from_numpy(np.stack(out["order"])).long()}


def jax_dropout_keep(tm, key, n):
    """The keep masks the JAX forward draws from ``key`` at ``tm``'s
    dropout sites: PB_FCN_2's one site takes the key itself, LabelProp's
    seven take its 7-way split in site order."""
    sites = tm.dropout_sites
    if not sites:
        return None
    keys = [key] if len(sites) == 1 else jax.random.split(key, len(sites))
    return {site: torch.from_numpy(np.array(jax.random.bernoulli(
        k, 1.0 - p, (n, 1, 1, c)))) for (site, (c, p)), k in
        zip(sites.items(), keys)}


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# ---- ops ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dropout", "dropout2d"])
def test_dropout_with_jax_mask_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 6, 7)).astype(np.float32)
    key, p = jax.random.PRNGKey(4), 0.3
    fn = getattr(jnn, kind)
    want = fn(key, jnp.asarray(x), p, True)
    shape = x.shape if kind == "dropout" else (3, 1, 1, 7)
    keep = np.array(jax.random.bernoulli(key, 1.0 - p, shape))
    assert 0 < keep.sum() < keep.size
    got = getattr(nn, kind)(torch.from_numpy(x), torch.from_numpy(keep), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a mean: the summation order differs
    _close(nn.adaptive_avg_pool_1(torch.from_numpy(x)).numpy(),
           jnn.adaptive_avg_pool_1(jnp.asarray(x)), 1e-6)


def test_draw_keep_rate_and_dropout2d_shape_check():
    keep = nn.draw_keep(torch.Generator().manual_seed(0), (4096, 1, 1, 8),
                        0.25)
    assert keep.dtype == torch.bool
    assert abs(float(keep.float().mean()) - 0.75) < 0.01
    with pytest.raises(ValueError):
        nn.dropout2d(torch.zeros(2, 3, 3, 8), torch.ones(2, 3, 3, 8,
                                                         dtype=torch.bool),
                     0.5)


def test_hsv_round_trip_matches_jax():
    rng = np.random.default_rng(1)
    rgb = rng.random((6, 7, 3)).astype(np.float32)
    rgb[0] = 0.0              # black: maxc == 0
    rgb[1] = 0.4              # grey: no range, h = s = 0
    rgb[2, :, 0] = 1.0        # red maxima
    rgb[2, :, 1:] = 0.1
    jh = jcolor._rgb_to_hsv(jnp.asarray(rgb))
    th = color._rgb_to_hsv(torch.from_numpy(rgb))
    for a, b in zip(th, jh):
        _close(a.numpy(), b, 1e-6)
    assert float(th[1][0].abs().max()) == float(th[1][1].abs().max()) == 0
    back = color._hsv_to_rgb(*th)
    _close(back.numpy(), jcolor._hsv_to_rgb(*jh), 1e-6)
    # shifted hues wrap below 0 and past 1
    shifted = (th[0] - 0.3) % 1.0
    _close(color._hsv_to_rgb(shifted, th[1], th[2]).numpy(),
           jcolor._hsv_to_rgb((jh[0] - 0.3) % 1.0, jh[1], jh[2]), 1e-5)


@pytest.mark.parametrize("mode,jitter", [("legacy", True), ("legacy", False),
                                         ("legacy_hflip", True),
                                         ("legacy_hflip", False)])
def test_legacy_augment_with_jax_draws_matches_jax(mode, jitter):
    """Flips exact, pixels within 1e-5, with the JAX draws recomputed from
    its keys; the images hold black, white, grey and red pixels."""
    rng = np.random.default_rng(2)
    imgs = _images(rng, 6, 12, 10)
    labs = rng.integers(0, 5, (6, 12, 10)).astype(np.int32)
    vflip = mode == "legacy"
    key = jax.random.PRNGKey(11)
    want_i, want_l = jcolor.legacy_augment_batch(
        key, jnp.asarray(imgs), jnp.asarray(labs), jitter, vflip)
    draws = jax_legacy_draws(key, 6, vflip)
    assert 0 < int(draws["hflip"].sum()) < 6
    assert (0 < int(draws["vflip"].sum()) < 6) == vflip
    got_i, got_l = color.legacy_augment_batch(
        torch.from_numpy(imgs), torch.from_numpy(labs), draws, jitter)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    if jitter:
        _close(got_i.numpy(), want_i, 1e-5)
    else:
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # images alone (the classification step) take the same path
    alone, none = color.legacy_augment_batch(torch.from_numpy(imgs), None,
                                             draws, jitter)
    assert none is None and torch.equal(alone, got_i)


def _all_orders_draws(rng, n, hflip, vflip):
    """Draws for n samples, sample i taking the i % 24-th of the 24 op
    orders, with the given flips and random factors."""
    perms = list(itertools.permutations(range(4)))
    u = torch.from_numpy(rng.random((4, n)).astype(np.float32))
    return {"hflip": torch.full((n,), hflip), "vflip": torch.full((n,), vflip),
            "b": 0.5 + u[0], "c": 0.5 + u[1], "s": 0.6 + 0.8 * u[2],
            "h": -0.3 + 0.6 * u[3],
            "order": torch.tensor([perms[i % 24] for i in range(n)])}


@pytest.mark.parametrize("hflip,vflip", [(True, False), (False, True),
                                         (True, True)])
def test_contrast_mean_is_the_unflipped_images(hflip, vflip):
    """The identity K4's first pass rests on, in the plain code, over all
    24 orders: the contrast op of a flipped batch blends toward the mean
    grey of the unflipped image run through the ops before contrast. With
    contrast factor 0 the op outputs that mean as a grey image, which the
    ops after it keep uniform, so each output image is one value, read
    from the mean, and the same flipped or not."""
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(_images(rng, 24, 12, 10))
    draws = _all_orders_draws(rng, 24, hflip, vflip)
    draws["c"] = torch.zeros(24)
    flipped, _ = color.legacy_augment_batch_plain(imgs, None, draws)
    plain, _ = color.legacy_augment_batch_plain(
        imgs, None, {**draws, "hflip": torch.zeros(24, dtype=torch.bool),
                     "vflip": torch.zeros(24, dtype=torch.bool)})
    for out in (flipped, plain):
        assert torch.equal(out, out[:, :1, :1].expand_as(out))
    # the means differ only by the order of their sums
    _close(flipped.numpy(), plain.numpy(), 1e-6)
    assert float(plain[:, 0, 0, 0].std()) > 0.05  # the orders' means differ


def test_legacy_augment_on_cpu_runs_the_plain_code():
    """CPU tensors take the plain code, and K4 launches nothing."""
    from robocupvision_tpu_torch.ops import cuda_kernels

    rng = np.random.default_rng(6)
    imgs = torch.from_numpy(_images(rng, 24, 12, 10))
    labs = torch.from_numpy(rng.integers(0, 5, (24, 12, 10)))
    draws = _all_orders_draws(rng, 24, True, True)
    before = cuda_kernels.legacy_jitter.launches
    for jitter in (True, False):
        got_i, got_l = color.legacy_augment_batch(imgs, labs, draws, jitter)
        want_i, want_l = color.legacy_augment_batch_plain(imgs, labs, draws,
                                                          jitter)
        assert torch.equal(got_i, want_i) and torch.equal(got_l, want_l)
    assert cuda_kernels.legacy_jitter.launches == before


def test_draw_legacy_augment_ranges():
    d = color.draw_legacy_augment(torch.Generator().manual_seed(0), 4096)
    assert abs(float(d["hflip"].float().mean()) - 0.5) < 0.03
    assert abs(float(d["vflip"].float().mean()) - 0.5) < 0.03
    for k, lo, hi in (("b", 0.5, 1.5), ("c", 0.5, 1.5), ("s", 0.6, 1.4),
                      ("h", -0.3, 0.3)):
        assert lo <= float(d[k].min()) and float(d[k].max()) < hi, k
    assert torch.equal(d["order"].sort(dim=1).values,
                       torch.arange(4).expand(4096, 4))
    # every op leads in about a quarter of the samples
    lead = torch.bincount(d["order"][:, 0], minlength=4).float() / 4096
    assert float((lead - 0.25).abs().max()) < 0.03
    d = color.draw_legacy_augment(torch.Generator().manual_seed(0), 64,
                                  use_vflip=False)
    assert not bool(d["vflip"].any())


def _jax_enhance_draws(key, img_shape):
    """The draws of a JAX ``random_*`` call with ``key``, as the port's
    dict: the gate and, after the factor key's split, u, v and the
    noise."""
    kg, kf = jax.random.split(key)
    ka, ks_ = jax.random.split(kf)
    return {"gate": torch.tensor(float(jax.random.uniform(kg, ()))),
            "u": torch.tensor(float(jax.random.uniform(kf, ()))),
            "noise": torch.from_numpy(np.array(jax.random.normal(
                kf, img_shape, jnp.float32)))}, ka, ks_


@pytest.mark.parametrize("name", ["noise", "brightness", "contrast", "color",
                                  "hue"])
def test_random_enhancers_with_jax_draws_match_jax(name):
    rng = np.random.default_rng(3)
    img = (rng.random((9, 11, 3)) * 255).astype(np.float32)
    img[0, :3] = 128.0  # grey pixels
    fired = set()
    for seed in range(40):
        if seed >= 6 and fired == {True, False}:
            break
        key = jax.random.PRNGKey(seed)
        want = getattr(jcolor, "random_" + name)(key, jnp.asarray(img))
        d, ka, ks_ = _jax_enhance_draws(key, img.shape)
        if name == "hue":
            d["u"] = torch.tensor(float(jax.random.uniform(ka, ())))
            d["v"] = torch.tensor(float(jax.random.uniform(ks_, ())))
        got = getattr(color, "random_" + name)(torch.from_numpy(img), d)
        fired.add(float(d["gate"]) < 0.9)
        _close(got.numpy(), want, 1e-3 if name == "hue" else 1e-4, name)
    assert fired == {True, False}
    d = color.draw_random_enhance(torch.Generator().manual_seed(0), (4, 5, 3))
    assert d["noise"].shape == (4, 5, 3) and 0 <= float(d["u"]) < 1


def test_cross_entropy_and_class_batch_stats_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((9, 5)).astype(np.float32) * 3
    tgt = rng.integers(0, 5, 9).astype(np.int32)
    w = np.array([1, 6, 1.5, 3, 3], np.float32)
    mask = np.ones(9, np.float32)
    mask[-2:] = 0
    for ww, mm in ((None, None), (w, mask)):
        want = jlosses.cross_entropy(
            jnp.asarray(logits), jnp.asarray(tgt),
            None if ww is None else jnp.asarray(ww),
            None if mm is None else jnp.asarray(mm))
        got = losses.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(tgt),
            None if ww is None else torch.from_numpy(ww),
            None if mm is None else torch.from_numpy(mm))
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    pred = np.argmax(logits, -1)
    pred[0] = tgt[0]
    jconf, jcorrect = jmetrics.class_batch_stats(
        jnp.asarray(pred), jnp.asarray(tgt), 5, jnp.asarray(mask))
    conf, correct = metrics.class_batch_stats(
        torch.from_numpy(pred), torch.from_numpy(tgt), 5,
        torch.from_numpy(mask))
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jconf))
    assert float(correct) == float(jcorrect) >= 1
    assert float(conf.sum()) == 7


# ---- train-mode forwards and one SGD step ------------------------------------


@pytest.mark.parametrize("net", list(NETS))
def test_train_forward_matches_jax(net):
    """Logits and every new BN running statistic within 1e-4, one padded
    sample left out of the statistics, the JAX dropout masks injected."""
    jm, jp, tm = _models(net, seed=1)
    x, _, mask = _batch(net, 5)
    key = jax.random.PRNGKey(9)
    with jlayers.bn_stats_mask(jnp.asarray(mask)):
        want, jmut = jm.apply(jp, jnp.asarray(x), train=True, rng=key)
    keep = jax_dropout_keep(tm, key, x.shape[0])
    assert (keep is None) == (net not in ("pb_fcn_2_class",
                                          "label_prop_dropout"))
    with layers.bn_stats_mask(torch.from_numpy(mask)):
        got, mut = tm.apply(tm.flat(), torch.from_numpy(x), train=True,
                            dropout=keep)
    _close(got.detach().numpy(), want, 1e-4)
    assert set(mut) == set(jmut)
    for k in mut:
        _close(mut[k].numpy(), jmut[k], 1e-4, k)


def test_train_forward_without_dropout_masks_raises():
    _, _, tm = _models("pb_fcn_2_class")
    with pytest.raises(ValueError, match="classifier"):
        tm.apply(tm.flat(), torch.zeros((2, PATCH, PATCH, 3)), train=True)
    # a generator draws them; eval mode never drops
    out, _ = tm.apply(tm.flat(), torch.zeros((2, PATCH, PATCH, 3)),
                      train=True, dropout=torch.Generator().manual_seed(0))
    assert out.shape == (2, 1, 1, 5)
    assert torch.equal(tm.apply(tm.flat(), torch.ones(2, PATCH, PATCH, 3)),
                       tm(torch.ones(2, PATCH, PATCH, 3)))


# the CLIs' step configurations: (loss, augment mode, jitter, class weights)
STEP_CFGS = {
    "pb_fcn_class": ("ce", "legacy_hflip", True, ()),
    "pb_fcn_2_class": ("ce", "legacy_hflip", True, ()),
    "pb_fcn_seg": ("ce2d", "legacy", True, (1, 6, 1.5, 3, 3)),
    "pb_fcn_2_seg": ("ce2d", "legacy", True, (1, 6, 1.5, 3, 3)),
    "label_prop": ("ce2d", "legacy", False, (1, 6, 1, 3, 2)),
    "label_prop_dropout": ("ce2d", "legacy", False, (1, 6, 1, 3, 2)),
}


def _step_cfgs(net):
    loss, mode, jitter, cw = STEP_CFGS[net]
    common = dict(num_classes=5, loss=loss, class_weights=cw,
                  augment_mode=mode, jitter=jitter,
                  out_size=1.0 if loss == "ce" else 1.0 / (H * W))
    return tstep.StepCfg(**common), jstep.StepCfg(**common)


def _assert_params_close(got, want_jax, reg, tol):
    want = torch_io.from_jax_params(reg, {k: np.asarray(v)
                                          for k, v in want_jax.items()})
    for k, v in want.items():
        _close(got[k].detach().numpy(), v.numpy(), tol, k)


@pytest.mark.parametrize("net", list(NETS))
def test_sgd_step_matches_jax(net):
    """One SGD step (momentum 0.9, weight decay 1e-3, the CLI's class
    weights and augmentation, one padded sample) from the same carried
    weights, batch, augmentation draws and dropout masks: every parameter
    and running statistic within 1e-4, the loss within 1e-5 relative."""
    jm, jp, tm = _models(net, seed=2)
    tcfg, jcfg = _step_cfgs(net)
    ttx, jtx = optim.sgd(0.9, 1e-3), joptim.sgd(0.9, 1e-3)
    jfn = jstep.make_train_step(jm, jtx, jcfg, donate=False)
    tfn = tstep.make_train_step(tm, ttx, tcfg)
    x, y, mask = _batch(net, 6)
    rng = jax.random.PRNGKey(21)
    jst = jstep.TrainState(jp, jtx.init(jlayers.split_params(jp)[0]))
    jst, jo = jfn(jst, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), rng,
                  jnp.float32(0.1), None)
    aug_rng, drop_rng = jax.random.split(rng)
    draws = jax_legacy_draws(aug_rng, x.shape[0],
                             tcfg.augment_mode == "legacy")
    tst, to = tfn(tstep.init_state(tm, ttx), torch.from_numpy(x),
                  torch.from_numpy(y), torch.from_numpy(mask), draws, 0.1,
                  None, jax_dropout_keep(tm, drop_rng, x.shape[0]))
    assert float(to["loss"]) == pytest.approx(float(jo["loss"]), rel=1e-5)
    assert float(to["correct"]) == float(jo["correct"])
    assert float(to["img_cnt"]) == float(jo["img_cnt"]) == 3.0
    _assert_params_close(tst.params, jst.params, tm.registry, 1e-4)


# ---- the ce validation and a classification epoch through the Trainer --------


def test_classification_epoch_and_validation_match_jax():
    """PB_FCN_2 classifying (legacy_hflip, dropout, ce) through both
    Trainers from the same carried weights: ``train_epoch`` with the JAX
    permutation, draws and dropout masks injected (loss within 1e-4,
    accuracy within one sample), then ``valid_epoch``'s loss, confusion
    and accuracy within 1e-5."""
    jm, jp, tm = _models("pb_fcn_2_class", seed=3)
    rng = np.random.default_rng(7)
    tr = (_images(rng, 14, PATCH, PATCH), rng.integers(0, 5, 14).astype(np.int32))
    va = (_images(rng, 11, PATCH, PATCH), rng.integers(0, 5, 11).astype(np.int32))
    tcfg, jcfg = _step_cfgs("pb_fcn_2_class")
    batch, seed = 4, 12345678
    jtr = jloop.Trainer(jm, joptim.sgd(0.9, 1e-5), jcfg,
                        jdevice_cache.DeviceCache.from_numpy(*tr),
                        jdevice_cache.DeviceCache.from_numpy(*va), batch,
                        seed=seed)
    jtr.set_params({k: np.asarray(v) for k, v in jp.items()})
    ttr = loop.Trainer(tm, optim.sgd(0.9, 1e-5), tcfg,
                       device_cache.DeviceCache.from_numpy(*tr, device="cpu"),
                       device_cache.DeviceCache.from_numpy(*va, device="cpu"),
                       batch, seed=seed)
    ttr.init()
    # the JAX Trainer's scanned epoch: its key splits
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    perm_rng, step_rng = jax.random.split(sub)
    nb = -(-14 // batch)
    steps = [jax.random.split(jax.random.fold_in(step_rng, bi))
             for bi in range(nb)]
    draws = iter([jax_legacy_draws(a, batch, False) for a, _ in steps])
    keeps = iter([jax_dropout_keep(tm, d, batch) for _, d in steps])
    ttr.draw_perm = lambda n: torch.from_numpy(np.array(
        jax.random.permutation(perm_rng, n)))
    ttr.draw_augment = lambda n: next(draws)
    ttr.draw_dropout = lambda n: next(keeps)
    want, got = jtr.train_epoch(0.05), ttr.train_epoch(0.05)
    assert got.loss == pytest.approx(want.loss, rel=1e-4)
    assert got.pixel_acc == pytest.approx(want.pixel_acc, abs=100 / 14 + 1e-6)
    want, got = jtr.valid_epoch(), ttr.valid_epoch()
    assert set(got) == set(want) == {"loss", "conf", "acc"}
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5, abs=1e-5)
    _close(got["conf"], want["conf"], 1e-5)
    assert got["acc"] == pytest.approx(want["acc"], rel=1e-5, abs=1e-5)
    assert float(np.sum(got["conf"])) == 11


def test_ce_eval_step_matches_jax():
    jm, jp, tm = _models("pb_fcn_class", seed=4)
    tcfg, jcfg = _step_cfgs("pb_fcn_class")
    x, y, mask = _batch("pb_fcn_class", 8, n=6, pad=2)
    want = jstep.make_eval_step(jm, jcfg)(jp, jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(mask))
    got = tstep.make_eval_step(tm, tcfg)(torch.from_numpy(x),
                                         torch.from_numpy(y),
                                         torch.from_numpy(mask))
    assert set(got) == set(want)
    for k in got:
        _close(got[k].numpy(), want[k], 1e-5, k)
    assert float(got["img_cnt"]) == 4


def test_train_run_refuses_the_classification_loss():
    _, _, tm = _models("pb_fcn_class")
    tcfg, _ = _step_cfgs("pb_fcn_class")
    cache = device_cache.DeviceCache.from_numpy(
        np.zeros((2, PATCH, PATCH, 3), np.float32), np.zeros(2, np.int32),
        device="cpu")
    tr = loop.Trainer(tm, optim.sgd(), tcfg, cache, cache, 2)
    tr.init()
    with pytest.raises(ValueError, match="segmentation"):
        tr.train_run(1, [0.1])


# ---- pruning ------------------------------------------------------------------


@pytest.mark.parametrize("family,kw", [("pb_fcn", dict(planes=32)),
                                       ("label_prop", dict(planes=8))])
def test_prune_band_matches_jax(family, kw):
    """Masks and pruned params exact, each prunable tensor in the band.
    PB_FCN at the CLI's planes 32: at planes 8 its 10-weight segmenter can
    hold no share between 73 and 77 percent, and the search (in both
    packages, as in the reference) never ends."""
    jp = jzoo.make(family, **kw).init(jax.random.PRNGKey(5))
    tm = zoo.make(family, device="cpu", **kw)
    tm.load_state_dict(torch_io.from_jax_params(tm.registry, jp))
    new, masks = pruning.prune_band(tm.state_dict(), tm.registry,
                                    verbose=False)
    jnew, jmasks = jpruning.prune_band({k: np.asarray(v) for k, v in jp.items()},
                                       tm.param_order, verbose=False)
    assert list(masks) == list(jmasks)
    carried = torch_io.to_jax_params(tm.registry, new)
    for k in jnew:
        np.testing.assert_array_equal(carried[k], np.asarray(jnew[k]),
                                      err_msg=k)
    for k, m in masks.items():
        kind = tm.registry.specs[k].kind
        np.testing.assert_array_equal(
            torch_io.to_jax_layout(m.numpy(), kind), jmasks[k], err_msg=k)
        assert 0.73 <= float(m.float().mean()) <= 0.77, k


def test_prune_masks_keep_band_pruned_weights_at_zero():
    _, _, tm = _models("label_prop", seed=6)
    params, masks = pruning.prune_band(tm.state_dict(), tm.registry,
                                       verbose=False)
    tcfg, _ = _step_cfgs("label_prop")
    tx = optim.sgd(0.5, 1e-3)
    fn = tstep.make_train_step(tm, tx, tcfg)
    st = tstep.TrainState(params, tx.init(layers.split_params(params)[0]))
    x, y, mask = _batch("label_prop", 9)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        st, _ = fn(st, torch.from_numpy(x), torch.from_numpy(y),
                   torch.from_numpy(mask), color.draw_legacy_augment(gen, 4),
                   0.1, masks)
    for k, m in masks.items():
        assert bool((st.params[k][m] == 0).all()), k
        assert bool((st.params[k][~m] != params[k][~m]).any()), k


# ---- run_plateau_training -----------------------------------------------------

LOSSES = [5.0, 4.0, 4.5, 4.2, 4.1, 3.0, 3.5, 3.4, 3.6, 3.7, 2.0, 2.5, 2.6]


class StubTrainer:
    """A trainer whose validation loss follows ``LOSSES`` and whose params
    carry the epoch that wrote them (every element equals it), so that a
    rollback shows which checkpoint it reloaded."""

    def __init__(self, registry, shapes, log):
        self.model = type("M", (), {"registry": registry})()
        self.shapes, self.log = shapes, log
        self.epoch, self.params_epoch = 0, 0.0

    def train_epoch(self, lr, prune_masks=None):
        self.log.append(("lr", lr))
        self.epoch += 1
        self.params_epoch = float(self.epoch)
        return type("R", (), {"loss": 1.0 / self.epoch,
                              "pixel_acc": 10.0 * self.epoch})()

    def valid_epoch(self):
        conf = np.eye(2) * self.epoch
        return {"loss": LOSSES[self.epoch - 1], "conf": conf,
                "acc": 50.0 + self.epoch}

    def params_numpy(self):
        return {k: np.full(s, self.params_epoch, np.float32)
                for k, s in self.shapes.items()}

    def set_params(self, params, reset_opt=True):
        v = float(np.asarray(next(iter(params.values()))).ravel()[0])
        self.params_epoch = v
        self.log.append(("set_params", v, reset_opt))


def test_run_plateau_training_matches_jax(tmp_path, monkeypatch, capsys):
    """The same learning rates, rollbacks (which checkpoint, optimizer
    kept), saves, prints and returned best as the JAX function, from a
    scripted loss sequence that plateaus twice."""
    monkeypatch.chdir(tmp_path)
    jm = jzoo.make("label_prop", planes=4)
    tm = zoo.make("label_prop", device="cpu", planes=4)
    runs = {}
    for tag, fn, reg, shapes in (
            ("jax", jlegacy.run_plateau_training, jm.registry,
             {k: s.shape for k, s in jm.registry.specs.items()}),
            ("port", legacy.run_plateau_training, tm.registry,
             {k: s.torch_shape for k, s in tm.registry.specs.items()})):
        log = []
        saves = []
        tr = StubTrainer(reg, shapes, log)
        best = fn(tr, len(LOSSES), 0.1, f"{tag}/best.pth", patience=1,
                  threshold=1e-3, on_best=lambda v: saves.append(v["loss"]))
        runs[tag] = (log, saves, best, capsys.readouterr().out)
    jlog, jsaves, jbest, jout = runs["jax"]
    log, saves, best, out = runs["port"]
    assert log == jlog
    assert [e for e in log if e[0] == "set_params"], "no rollback"
    assert saves == jsaves
    assert set(best) == set(jbest)
    for k in best:
        np.testing.assert_array_equal(np.asarray(best[k]),
                                      np.asarray(jbest[k]), err_msg=k)
    assert out.replace("port/", "jax/") == jout
    assert "Best Model reloaded" in out
