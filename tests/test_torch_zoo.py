"""The port's ROBO-UNet family (robocupvision_tpu_torch.models.zoo) against
the JAX package's: registry names, order and shapes, the weight carry
(export/torch_io.py), the logits of carried JAX ``init`` params at rtol =
atol = 2e-4 (conv reassociation, the bound of tests/test_pallas_packed.py)
for the flagship and the ``--UNet`` and ``--v2`` variants (their
hyper-table rows, BN statistics drawn from numpy), and the analytic op
counts test.py prints."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robocupvision_tpu.export import torch_io as jtorch_io
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu_torch.export import torch_io
from robocupvision_tpu_torch.models import zoo as tzoo

# the --UNet and --v2 rows of train.py's hyperparameter table
UNET = dict(pool=True, levels=3, belly_size=0)
V2 = dict(v2=True, levels=1, belly_size=9, class_size=3, belly_planes=64)
CFGS = [dict(), dict(no_scale=True), dict(levels=1, belly_size=3), UNET, V2,
        dict(no_scale=True, **UNET), dict(no_scale=True, **V2),
        dict(v2=True, pool=True, levels=2, class_size=3)]


@pytest.mark.parametrize("kw", CFGS)
def test_registry_matches_jax(kw):
    jreg = jzoo.make("robo_unet", **kw).registry
    model = tzoo.make("robo_unet", device="cpu", **kw)
    treg = model.registry
    assert treg.order == jreg.order
    for name in jreg.order:
        assert treg.specs[name].shape == jreg.specs[name].shape, name
        assert treg.specs[name].kind == jreg.specs[name].kind, name
    # the module's state_dict carries exactly the registry names, in order
    sd = model.state_dict()
    assert list(sd) == jreg.order
    for name, t in sd.items():
        assert tuple(t.shape) == treg.specs[name].torch_shape


def test_weight_carry_roundtrip_and_torch_layout():
    """from_jax_params is the JAX package's to_torch_state_dict, and
    to_jax_params inverts it exactly."""
    jm = jzoo.make("robo_unet")
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(3)).items()}
    reg = tzoo.make("robo_unet", device="cpu").registry
    sd = torch_io.from_jax_params(reg, jp)
    ref = jtorch_io.to_torch_state_dict(jm.registry, jp, include_counters=False)
    assert list(sd) == list(ref)
    for name in ref:
        np.testing.assert_array_equal(sd[name].numpy(), ref[name])
    back = torch_io.to_jax_params(reg, sd)
    for name in jp:
        np.testing.assert_array_equal(back[name], jp[name])


@pytest.mark.parametrize("kw,hw", [(dict(), (120, 160)),
                                   (dict(no_scale=True), (64, 64))])
def test_carried_params_give_jax_logits(kw, hw):
    jm = jzoo.make("robo_unet", **kw)
    jp = jm.init(jax.random.PRNGKey(0))
    model = tzoo.make("robo_unet", device="cpu", **kw)
    model.load_state_dict(torch_io.from_jax_params(
        model.registry, {k: np.asarray(v) for k, v in jp.items()}))
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    ref, _ = jm.apply(jp, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, *hw, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_make_seeded_and_variants_rejected():
    """Seeded construction is reproducible; the --v2 and --UNet variants,
    refused by earlier slices of the port, now build."""
    a = tzoo.make("robo_unet", device="cpu",
                  generator=torch.Generator().manual_seed(7)).state_dict()
    b = tzoo.make("robo_unet", device="cpu",
                  generator=torch.Generator().manual_seed(7)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["downPart.Level0.layers.Conv0.bn.weight"],
                       torch.ones(8))
    for kw, key in ((dict(v2=True), "upPart.Up1.conv.weight"),
                    (dict(pool=True), "downPart.Level1.layers.Conv0.conv.weight")):
        model = tzoo.make("robo_unet", device="cpu", **kw)
        assert model.cfg.v2 == kw.get("v2", False)
        assert model.cfg.pool == kw.get("pool", False)
        assert key in model.state_dict()


def _perturbed(jm, seed):
    """JAX init params with BN running statistics drawn from numpy, so the
    BN of every block is exercised."""
    rng = np.random.default_rng(seed)
    jp = {k: np.array(v) for k, v in jm.init(jax.random.PRNGKey(seed)).items()}
    for k in jp:
        if k.endswith(".running_mean"):
            jp[k] = rng.standard_normal(jp[k].shape).astype(np.float32) * 0.3
        elif k.endswith(".running_var"):
            jp[k] = (0.5 + rng.random(jp[k].shape)).astype(np.float32)
    return jp


@pytest.mark.parametrize("kw", [UNET, V2, dict(no_scale=True, **UNET)],
                         ids=["unet", "v2", "unet_no_scale"])
def test_variant_logits_match_jax(kw):
    jm = jzoo.make("robo_unet", **kw)
    jp = _perturbed(jm, 4)
    model = tzoo.make("robo_unet", device="cpu", **kw)
    model.load_state_dict(torch_io.from_jax_params(model.registry, jp))
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref, _ = jm.apply({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 64, 64, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kw", [dict(), UNET, V2, dict(no_scale=True, **V2),
                                dict(v2=True, pool=True, levels=2, class_size=3)],
                         ids=["flagship", "unet", "v2", "v2_no_scale", "v2_pool"])
def test_get_computations_matches_jax(kw):
    """Dense, and from params with pruned=True: a quarter of every kernel
    zeroed, so each layer's non-zero share enters its count."""
    jm = jzoo.make("robo_unet", **kw)
    jp = _perturbed(jm, 6)
    rng = np.random.default_rng(7)
    for k, v in jp.items():
        if v.ndim == 4:
            v[rng.random(v.shape) < 0.25] = 0.0
    model = tzoo.make("robo_unet", device="cpu", **kw)
    state = torch_io.from_jax_params(model.registry, jp)
    assert tzoo.robo_unet_get_computations(model.cfg) \
        == jzoo.robo_unet_get_computations(jm.cfg)
    got = tzoo.robo_unet_get_computations(model.cfg, state, pruned=True)
    want = jzoo.robo_unet_get_computations(jm.cfg, jp, pruned=True)
    assert got == want
    assert got != tzoo.robo_unet_get_computations(model.cfg)
