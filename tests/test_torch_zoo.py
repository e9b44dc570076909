"""The port's flagship ROBO-UNet (robocupvision_tpu_torch.models.zoo)
against the JAX package's: registry names, order and shapes, the weight
carry (export/torch_io.py), and the logits of carried JAX ``init`` params
at rtol = atol = 2e-4 (conv reassociation, the bound of
tests/test_pallas_packed.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robocupvision_tpu.export import torch_io as jtorch_io
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu_torch.export import torch_io
from robocupvision_tpu_torch.models import zoo as tzoo

CFGS = [dict(), dict(no_scale=True), dict(levels=1, belly_size=3)]


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
    a = tzoo.make("robo_unet", device="cpu",
                  generator=torch.Generator().manual_seed(7)).state_dict()
    b = tzoo.make("robo_unet", device="cpu",
                  generator=torch.Generator().manual_seed(7)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["downPart.Level0.layers.Conv0.bn.weight"],
                       torch.ones(8))
    for kw in (dict(v2=True), dict(pool=True)):
        with pytest.raises(NotImplementedError):
            tzoo.make("robo_unet", device="cpu", **kw)
