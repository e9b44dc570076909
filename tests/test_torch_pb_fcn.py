"""The port's PB_FCN and PB_FCN_2 families (robocupvision_tpu_torch.models.
zoo) against the JAX package's: registry names, order, shapes and kinds,
the weight carry (export/torch_io.py) both ways, and the logits of carried
JAX params at rtol = atol = 2e-4 (conv reassociation), in the segmentation
and the classification modes. BN running statistics are perturbed so that
the eval-mode BN is exercised."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robocupvision_tpu.export import torch_io as jtorch_io
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu_torch.export import torch_io
from robocupvision_tpu_torch.models import zoo as tzoo

CFGS = [("pb_fcn", dict()), ("pb_fcn", dict(no_scale=True)),
        ("pb_fcn", dict(classify=True)), ("pb_fcn", dict(kernel_size=3)),
        ("pb_fcn_2", dict()), ("pb_fcn_2", dict(classify=True))]


def _jax_params(jm, seed):
    """JAX init params with BN running stats drawn from numpy."""
    rng = np.random.default_rng(seed)
    p = {k: np.array(v) for k, v in jm.init(jax.random.PRNGKey(seed)).items()}
    for k in p:
        if k.endswith(".running_mean"):
            p[k] = rng.standard_normal(p[k].shape).astype(np.float32) * 0.3
        elif k.endswith(".running_var"):
            p[k] = (0.5 + rng.random(p[k].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("family,kw", CFGS)
def test_registry_matches_jax(family, kw):
    jreg = jzoo.make(family, **kw).registry
    model = tzoo.make(family, device="cpu", **kw)
    treg = model.registry
    assert treg.order == jreg.order
    for name in jreg.order:
        assert treg.specs[name].shape == jreg.specs[name].shape, name
        assert treg.specs[name].kind == jreg.specs[name].kind, name
    sd = model.state_dict()
    assert list(sd) == jreg.order
    for name, t in sd.items():
        assert tuple(t.shape) == treg.specs[name].torch_shape


@pytest.mark.parametrize("family,kw", [("pb_fcn", dict(no_scale=True)),
                                       ("pb_fcn_2", dict())])
def test_weight_carry_both_ways(family, kw):
    """from_jax_params is the JAX package's to_torch_state_dict, and
    to_jax_params its from_torch_state_dict, on these registries too."""
    jm = jzoo.make(family, **kw)
    jp = _jax_params(jm, 3)
    reg = tzoo.make(family, device="cpu", **kw).registry
    sd = torch_io.from_jax_params(reg, jp)
    ref = jtorch_io.to_torch_state_dict(jm.registry, jp, include_counters=False)
    assert list(sd) == list(ref)
    for name in ref:
        np.testing.assert_array_equal(sd[name].numpy(), ref[name])
    back = torch_io.to_jax_params(reg, sd)
    jback = jtorch_io.from_torch_state_dict(jm.registry, sd)
    for name in jp:
        np.testing.assert_array_equal(back[name], jp[name])
        np.testing.assert_array_equal(jback[name], jp[name])


@pytest.mark.parametrize("family,kw,hw", [
    ("pb_fcn", dict(), (32, 64)), ("pb_fcn", dict(no_scale=True), (64, 64)),
    ("pb_fcn", dict(classify=True), (64, 64)),
    ("pb_fcn", dict(no_scale=True, classify=True), (64, 64)),
    ("pb_fcn_2", dict(), (64, 64)), ("pb_fcn_2", dict(classify=True), (64, 64))])
def test_carried_params_give_jax_logits(family, kw, hw):
    jm = jzoo.make(family, **kw)
    jp = _jax_params(jm, 0)
    model = tzoo.make(family, device="cpu", **kw)
    model.load_state_dict(torch_io.from_jax_params(model.registry, jp))
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    ref, _ = jm.apply({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_make_pb_fcn_is_seeded():
    a = tzoo.make("pb_fcn", device="cpu",
                  generator=torch.Generator().manual_seed(7)).state_dict()
    b = tzoo.make("pb_fcn", device="cpu",
                  generator=torch.Generator().manual_seed(7)).state_dict()
    c = tzoo.make("pb_fcn", device="cpu",
                  generator=torch.Generator().manual_seed(8)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["FCN.conv0.conv.weight"], c["FCN.conv0.conv.weight"])
