"""The classifier baselines' families in the port's zoo (FCN, BNN L and
MC, the standalone Classifier and DownSampler) against the JAX package's,
on the CPU, with weights carried only by export/torch_io.py.

Each family in eval mode and in train mode (a padded sample left out of
the BN statistics, the JAX dropout keep masks injected: BNN's Dropout2d
after each conv and BNN L's element dropout after ``fc``), logits and
new running statistics within 1e-4; the weight carry round trip of each;
``conv_pool_double`` and element dropout alone; one SGD step of each
BNN with the classVal step configuration against JAX's."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robocupvision_tpu.models import layers as jlayers
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu.ops import nn as jnn
from robocupvision_tpu.train import optim as joptim
from robocupvision_tpu.train import step as jstep
from robocupvision_tpu_torch.data.datasets import legacy_normalize
from robocupvision_tpu_torch.export import torch_io
from robocupvision_tpu_torch.models import layers, zoo
from robocupvision_tpu_torch.train import optim
from robocupvision_tpu_torch.train import step as tstep

# (family, zoo kwargs, input (N, H, W, C))
NETS = {
    "fcn": ("fcn", dict(planes=8), (3, 48, 64, 3)),
    "bnn_l": ("bnn", dict(variant="L"), (4, 32, 32, 3)),
    "bnn_mc": ("bnn", dict(variant="MC"), (4, 32, 32, 3)),
    "classifier": ("classifier", dict(in_planes=16, num_classes=4,
                                      pool_size=4), (3, 8, 8, 16)),
    "downsampler": ("downsampler", dict(planes=8), (3, 32, 32, 3)),
    "downsampler_no_scale": ("downsampler", dict(planes=8, no_scale=True),
                             (2, 32, 48, 3)),
}


def _models(net, seed=0):
    family, kw, _ = NETS[net]
    jm = jzoo.make(family, **kw)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = zoo.make(family, device="cpu", **kw)
    tm.load_state_dict(torch_io.from_jax_params(tm.registry, jp))
    return jm, jp, tm


def _input(net, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(NETS[net][2]).astype(np.float32)


def _outputs(y):
    """A family's output as a list of arrays (the DownSampler's feature
    tuple, its f4 None unless no_scale)."""
    ys = y if isinstance(y, tuple) else (y,)
    return [None if a is None else np.asarray(
        a.detach().numpy() if isinstance(a, torch.Tensor) else a) for a in ys]


def _assert_outputs_close(got, want, tol=1e-4):
    got, want = _outputs(got), _outputs(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def jax_bnn_keep(key, tm, n, hw):
    """The keep masks the JAX BNN forward draws from ``key``: its 4-way
    split in site order (MC uses the first three), Dropout2d's at
    (n, 1, 1, C), the ``fc`` site's at the activation's shape."""
    keys = jax.random.split(key, 4)
    shapes = {site: keep.shape for site, keep in
              tm.draw_dropout(torch.Generator().manual_seed(0), n,
                              hw).items()}
    return {site: torch.from_numpy(np.array(jax.random.bernoulli(
        k, 1.0 - p, shapes[site])))
        for (site, (_, p)), k in zip(tm.dropout_sites.items(), keys)}


@pytest.mark.parametrize("net", list(NETS))
def test_eval_forward_matches_jax(net):
    jm, jp, tm = _models(net, seed=1)
    x = _input(net, 2)
    want, _ = jm.apply(jp, jnp.asarray(x))
    _assert_outputs_close(tm(torch.from_numpy(x)), want)


@pytest.mark.parametrize("net", list(NETS))
def test_train_forward_matches_jax(net):
    jm, jp, tm = _models(net, seed=3)
    x = _input(net, 4)
    mask = np.ones(x.shape[0], np.float32)
    mask[-1] = 0
    key = jax.random.PRNGKey(5)
    family = NETS[net][0]
    with jlayers.bn_stats_mask(jnp.asarray(mask)):
        want, jmut = jm.apply(jp, jnp.asarray(x), train=True,
                              rng=key if family == "bnn" else None)
    keep = jax_bnn_keep(key, tm, x.shape[0], x.shape[1:3]) \
        if family == "bnn" else None
    if keep is not None:
        assert all(0 < int(k.sum()) < k.numel() for k in keep.values())
    with layers.bn_stats_mask(torch.from_numpy(mask)):
        got, mut = tm.apply(tm.flat(), torch.from_numpy(x), train=True,
                            dropout=keep)
    _assert_outputs_close(got, want)
    assert set(mut) == set(jmut)
    for k in mut:
        np.testing.assert_allclose(mut[k].numpy(), np.asarray(jmut[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("net", list(NETS))
def test_weight_carry_round_trips(net):
    """export/torch_io carries every family's params both ways: the
    registries agree in names, order and HWIO shapes, and port -> JAX ->
    port is the identity."""
    jm, jp, tm = _models(net, seed=6)
    assert list(tm.registry.specs) == list(jm.registry.specs)
    for name, spec in tm.registry.specs.items():
        assert spec.shape == jm.registry.specs[name].shape, name
    back = torch_io.to_jax_params(tm.registry, tm.state_dict())
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    again = torch_io.from_jax_params(tm.registry, back)
    for k, v in tm.state_dict().items():
        assert torch.equal(again[k], v), k


def test_bnn_dropout_sites_and_shapes():
    bl = zoo.make("bnn", device="cpu", variant="L")
    assert bl.dropout_sites == {"conv1": (8, 0.25), "conv2": (16, 0.25),
                                "conv3": (16, 0.25), "fc": (512, 0.5)}
    keep = bl.draw_dropout(torch.Generator().manual_seed(0), 5, (32, 32))
    assert {k: tuple(v.shape) for k, v in keep.items()} == {
        "conv1": (5, 1, 1, 8), "conv2": (5, 1, 1, 16),
        "conv3": (5, 1, 1, 16), "fc": (5, 1, 1, 512)}
    keep = bl.draw_dropout(torch.Generator().manual_seed(0), 2, (64, 64))
    assert tuple(keep["fc"].shape) == (2, 5, 5, 512)
    with pytest.raises(ValueError, match="fc"):
        bl.draw_dropout(torch.Generator().manual_seed(0), 2)
    # a generator draws them at the input's shape
    out, _ = bl.apply(bl.flat(), torch.zeros(2, 64, 64, 3), train=True,
                      dropout=torch.Generator().manual_seed(0))
    assert tuple(out.shape) == (2, 5, 5, 4)
    mc = zoo.make("bnn", device="cpu", variant="MC")
    assert set(mc.dropout_sites) == {"conv1", "conv2", "conv3"}
    with pytest.raises(ValueError, match="conv1"):
        mc.apply(mc.flat(), torch.zeros(2, 32, 32, 3), train=True)
    for family in ("fcn", "classifier", "downsampler"):
        assert zoo.make(family, device="cpu").draw_dropout(
            torch.Generator(), 2, (32, 32)) is None


def test_element_dropout_and_conv_pool_double_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 4, 6)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = jnn.dropout(key, jnp.asarray(x), 0.5, True)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(key, 0.5, x.shape)))
    with layers.train_mode({"fc": (keep, 0.5)}):
        got = layers.dropout(torch.from_numpy(x), "fc")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # eval mode, and a site without a mask: the identity
    assert torch.equal(layers.dropout(torch.from_numpy(x), "fc"),
                       torch.from_numpy(x))
    r = layers.Registry()
    layers.conv_pool_double_def(r, "b", 6, 8)
    jr = jlayers.Registry()
    jlayers.conv_pool_double_def(jr, "b", 6, 8)
    assert list(r.specs) == list(jr.specs)
    jp = jr.init(jax.random.PRNGKey(9))
    tp = torch_io.from_jax_params(r, jp)
    xin = rng.standard_normal((2, 12, 16, 6)).astype(np.float32)
    want = jlayers.conv_pool_double(jp, {}, "b", jnp.asarray(xin), False)
    got = layers.conv_pool_double(tp, "b", torch.from_numpy(xin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("variant", ["L", "MC"])
def test_bnn_sgd_step_matches_jax(variant):
    """One step of classVal's configuration (ce, legacy_hflip with
    jitter, SGD momentum 0.9, weight decay 5e-4), one padded sample, the
    JAX draws and keep masks injected: every parameter within 1e-4."""
    from test_torch_legacy_train import jax_legacy_draws

    jm = jzoo.make("bnn", variant=variant)
    jp = jm.init(jax.random.PRNGKey(10))
    tm = zoo.make("bnn", device="cpu", variant=variant)
    tm.load_state_dict(torch_io.from_jax_params(tm.registry, jp))
    common = dict(num_classes=4, loss="ce", augment_mode="legacy_hflip",
                  out_size=1.0)
    jtx, ttx = joptim.sgd(0.9, 5e-4), optim.sgd(0.9, 5e-4)
    jfn = jstep.make_train_step(jm, jtx, jstep.StepCfg(**common),
                                donate=False)
    tfn = tstep.make_train_step(tm, ttx, tstep.StepCfg(**common))
    rng = np.random.default_rng(11)
    x = np.stack([legacy_normalize(im) for im in
                  rng.random((6, 32, 32, 3)).astype(np.float32)])
    y = rng.integers(0, 4, 6).astype(np.int32)
    mask = np.ones(6, np.float32)
    mask[-1] = 0
    key = jax.random.PRNGKey(12)
    jst = jstep.TrainState(jp, jtx.init(jlayers.split_params(jp)[0]))
    jst, jo = jfn(jst, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
                  key, jnp.float32(0.05), None)
    aug_rng, drop_rng = jax.random.split(key)
    tst, to = tfn(tstep.init_state(tm, ttx), torch.from_numpy(x),
                  torch.from_numpy(y), torch.from_numpy(mask),
                  jax_legacy_draws(aug_rng, 6, False), 0.05, None,
                  jax_bnn_keep(drop_rng, tm, 6, (32, 32)))
    assert float(to["loss"]) == pytest.approx(float(jo["loss"]), rel=1e-5)
    assert float(to["correct"]) == float(jo["correct"])
    want = torch_io.from_jax_params(tm.registry, {
        k: np.asarray(v) for k, v in jst.params.items()})
    for k, v in want.items():
        np.testing.assert_allclose(tst.params[k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
