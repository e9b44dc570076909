"""The port's LabelProp family (robocupvision_tpu_torch.models.zoo) and its
packed graph (models/packed.build_packed_label_prop) against the JAX
package's, at planes=8 on (2, 48, 64, 8) inputs: registry names, order,
shapes and kinds; the weight carry both ways; zoo logits at rtol = atol =
2e-4 (conv reassociation); the packed graphs in f32 (plain, and the chain
graph with and without the folded stem and the dilated mid chain, against
JAX's chain graph in interpret mode) at 2e-4 on logits, labels equal but
where JAX's top-2 logits lie within 1e-4 (ties); bf16 labels >= 0.995
against JAX's bf16 chain graph. BN running statistics are perturbed so
that every folded affine is exercised."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robocupvision_tpu.export import torch_io as jtorch_io
from robocupvision_tpu.models import packed as jpacked
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu_torch.export import torch_io
from robocupvision_tpu_torch.models import packed as tpacked
from robocupvision_tpu_torch.models import zoo as tzoo

SHAPE = (2, 48, 64, 8)


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


@pytest.fixture(scope="module")
def lp():
    """planes=8 LabelProp in both packages with the same weights, and a
    numpy-seeded input."""
    jm = jzoo.make("label_prop", planes=8)
    jp = _jax_params(jm, 3)
    model = tzoo.make("label_prop", planes=8, device="cpu")
    model.load_state_dict(torch_io.from_jax_params(model.registry, jp))
    x = np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)
    return {"jm": jm, "jp": jp, "model": model, "x": x}


@pytest.mark.parametrize("kw", [dict(), dict(planes=16, num_classes=3)])
def test_registry_matches_jax(kw):
    jreg = jzoo.make("label_prop", **kw).registry
    model = tzoo.make("label_prop", device="cpu", **kw)
    treg = model.registry
    assert treg.order == jreg.order
    for name in jreg.order:
        assert treg.specs[name].shape == jreg.specs[name].shape, name
        assert treg.specs[name].kind == jreg.specs[name].kind, name
    sd = model.state_dict()
    assert list(sd) == jreg.order
    for name, t in sd.items():
        assert tuple(t.shape) == treg.specs[name].torch_shape


def test_weight_carry_both_ways(lp):
    reg = lp["model"].registry
    sd = torch_io.from_jax_params(reg, lp["jp"])
    ref = jtorch_io.to_torch_state_dict(lp["jm"].registry, lp["jp"],
                                        include_counters=False)
    assert list(sd) == list(ref)
    for name in ref:
        np.testing.assert_array_equal(sd[name].numpy(), ref[name])
    back = torch_io.to_jax_params(reg, sd)
    jback = jtorch_io.from_torch_state_dict(lp["jm"].registry, sd)
    for name in lp["jp"]:
        np.testing.assert_array_equal(back[name], lp["jp"][name])
        np.testing.assert_array_equal(jback[name], lp["jp"][name])


@pytest.mark.parametrize("planes,hw", [(8, (48, 64)), (16, (32, 32))])
def test_zoo_logits_match_jax(planes, hw):
    jm = jzoo.make("label_prop", planes=planes)
    jp = _jax_params(jm, planes)
    model = tzoo.make("label_prop", planes=planes, device="cpu")
    model.load_state_dict(torch_io.from_jax_params(model.registry, jp))
    x = np.random.default_rng(1).standard_normal((2, *hw, 8)).astype(np.float32)
    ref, _ = jm.apply({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def _jax_graph(lp, dtype, **kw):
    if kw.get("pallas"):
        kw = dict(kw, pallas_interpret=True)
    return jpacked.build_packed_label_prop(lp["jm"], lp["jp"], dtype=dtype, **kw)


@pytest.mark.parametrize("kw", [
    dict(), dict(stem_group=0),
    dict(pallas=True),
    dict(pallas=True, pallas_mid=True),
    dict(pallas=True, pallas_fold_stem=True, pallas_mid=True)])
def test_packed_f32_matches_jax(lp, kw):
    """Logits of the port's packed graph within 2e-4 of JAX's same graph;
    labels (the fused argmax head on chain graphs) equal JAX's argmax except
    at ties."""
    ref = np.asarray(_jax_graph(lp, jnp.float32, **kw).logits(
        jnp.asarray(lp["x"])))
    pi = tpacked.build_packed_label_prop(lp["model"], None, torch.float32,
                                         device="cpu", **kw)
    x = torch.from_numpy(lp["x"])
    with torch.no_grad():
        logits, labels = pi.logits(x).numpy(), pi.infer(x).numpy()
    assert logits.shape == ref.shape == (*SHAPE[:3], 5)
    np.testing.assert_allclose(logits, ref, rtol=2e-4, atol=2e-4)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-4
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(labels[clear], ref.argmax(-1)[clear])


def test_packed_bf16_chain_label_agreement(lp):
    kw = dict(pallas=True, pallas_fold_stem=True, pallas_mid=True)
    ref = np.asarray(_jax_graph(lp, jnp.bfloat16, **kw).infer(
        jnp.asarray(lp["x"])))
    pi = tpacked.build_packed_label_prop(lp["model"], None, torch.bfloat16,
                                         device="cpu", **kw)
    with torch.no_grad():
        got = pi.infer(torch.from_numpy(lp["x"])).numpy()
    agree = np.mean(got == ref)
    assert agree >= 0.995, agree


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fold", [False, True])
def test_fused_argmax_head_equals_argmax_of_logits(lp, dtype, fold):
    """The chain graph's fused head emits argmax over the same graph's
    logits (rounded to the chain dtype) exactly, ties included; without the
    fused head the graph argmaxes its logits itself."""
    x = torch.from_numpy(lp["x"])
    kw = dict(pallas=True, pallas_fold_stem=fold, pallas_mid=True)
    pi = tpacked.build_packed_label_prop(lp["model"], None, dtype,
                                         device="cpu", **kw)
    unfused = tpacked.build_packed_label_prop(lp["model"], None, dtype,
                                              device="cpu",
                                              pallas_argmax_head=False, **kw)
    with torch.no_grad():
        want = torch.argmax(pi.logits(x), dim=-1).to(torch.int32)
        assert torch.equal(pi.infer(x), want)
        assert torch.equal(unfused.infer(x), want)


def test_chain_graph_stages(lp):
    """The three chains of the served graph: the folded-stem down chain,
    the dilated mid chain and the up chain whose classifier carries the 1x1
    skip kernel over ``top`` (skip 1)."""
    ch = tpacked.build_packed_label_prop(
        lp["model"], None, torch.float32, pallas=True, pallas_fold_stem=True,
        pallas_mid=True, device="cpu").chains
    assert [st.stem_f for st in ch["down"]] == [4, 0, 0]
    assert [tuple(st.w.shape) for st in ch["down"]] == [
        (6, 3, 32, 32), (3, 3, 32, 16), (3, 3, 16, 4)]
    assert [st.dil for st in ch["mid"]] == [2, 2, 2]
    head = ch["up"][-1]
    assert head.skip_idx == 1 and tuple(head.skip_w.shape) == (1, 1, 32, 80)
    assert tuple(head.w.shape) == (1, 1, 64, 80) and head.scale is None


@pytest.mark.parametrize("kw", [dict(stem_group=6), dict(stem_group=-4),
                                dict(stem_group=8, pallas=True,
                                     pallas_fold_stem=True)])
def test_bad_stem_groups_raise(lp, kw):
    """Only the group == f stem is ported: a wider group raises."""
    with pytest.raises(ValueError):
        tpacked.build_packed_label_prop(lp["model"], None, torch.float32,
                                        device="cpu", **kw)


def test_builder_takes_label_prop_only():
    with pytest.raises(ValueError):
        tpacked.build_packed_label_prop(tzoo.make("pb_fcn", device="cpu"),
                                        device="cpu")
