"""The port's packed graphs (robocupvision_tpu_torch.models.packed) against
the JAX package's, on the CPU at f32: the port's chain graphs (whose chains
take the plain path on CPU tensors) and plain graphs against JAX's
``pallas=False`` graph and its ``pallas_interpret=True`` chain graph. The
flagship at QVGA and at a small ``no_scale`` input, in its two-chain form
and its full chain form (``pallas_fold_stem``, ``pallas_deep``); PB_FCN_2
through ``build_packed_infer``; PB_FCN through ``build_packed_pb_fcn``
with ``pallas`` and ``pallas_deep`` off and on; the ``--UNet`` and
``--v2`` variants (their hyper-table rows, and the off-table ``levels=3``
and ``v2_pool`` corners) in their plain and chain graphs. Weights enter
both sides only through the weight carry (export/torch_io.py). Logits at
rtol = atol = 2e-4; labels by tests/test_pallas_packed.py's rule: at most
a 2e-5 mismatch share, and only where the top-2 logit gap is below 1e-4
(an argmax tie). bf16 labels against the JAX package's bf16 graph at the
agreement tests/test_pallas_packed.py holds its own chains to (0.99 for
``--UNet``, whose pools flip their selection on sub-ulp ties; 0.995
otherwise)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robocupvision_tpu.models import packed as jpacked
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu.ops.color import raw_camera_preprocess as jraw_preprocess
from robocupvision_tpu_torch.export import torch_io
from robocupvision_tpu_torch.models import packed as tpacked
from robocupvision_tpu_torch.models import zoo as tzoo


def _assert_labels_match(got, ref, ref_logits, max_mismatch=2e-5):
    got, ref = np.asarray(got).astype(np.int64), np.asarray(ref).astype(np.int64)
    assert got.shape == ref.shape
    mism = got != ref
    frac = float(np.mean(mism))
    assert frac <= max_mismatch, frac
    if frac:
        lg = np.asarray(ref_logits, np.float32)
        gaps = np.abs(np.take_along_axis(lg, got[..., None], -1)
                      - np.take_along_axis(lg, ref[..., None], -1))[mism[..., None]]
        assert np.max(gaps) < 1e-4, np.max(gaps)


def _pair(kw, seed=0, family="robo_unet", randomize_bn=False):
    jm = jzoo.make(family, **kw)
    jp = {k: np.array(v) for k, v in jm.init(jax.random.PRNGKey(seed)).items()}
    if randomize_bn:  # BN running stats from numpy: the BN fold is exercised
        rng = np.random.default_rng(seed)
        for k in jp:
            if k.endswith(".running_mean"):
                jp[k] = rng.standard_normal(jp[k].shape).astype(np.float32) * 0.3
            elif k.endswith(".running_var"):
                jp[k] = (0.5 + rng.random(jp[k].shape)).astype(np.float32)
    model = tzoo.make(family, device="cpu", **kw)
    model.load_state_dict(torch_io.from_jax_params(model.registry, jp))
    return jm, {k: jnp.asarray(v) for k, v in jp.items()}, model


def _check_serving_forms(pi, x, ref_logits, ref_labels):
    """logits, infer and the infer_u8_packed pair of a port graph against
    the JAX reference logits and labels."""
    np.testing.assert_allclose(pi.logits(x).numpy(), ref_logits,
                               rtol=2e-4, atol=2e-4)
    got = pi.infer(x)
    assert got.dtype == torch.int32
    _assert_labels_match(got, ref_labels, ref_logits)
    fn, unpack = pi.infer_u8_packed()
    packed_labels = fn(x)
    assert packed_labels.dtype == torch.uint8
    np.testing.assert_array_equal(unpack(packed_labels), got.numpy())


@pytest.mark.parametrize("kw,hw", [(dict(), (120, 160)),
                                   (dict(no_scale=True), (64, 64))])
def test_packed_graph_matches_jax(kw, hw):
    jm, jp, model = _pair(kw)
    r = np.random.default_rng(1)
    x = r.standard_normal((2, *hw, 3)).astype(np.float32)
    x_u8 = r.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    jbase = jpacked.build_packed_infer(jm, jp, dtype=jnp.float32)
    jchain = jpacked.build_packed_infer(jm, jp, dtype=jnp.float32, pallas=True,
                                        pallas_interpret=True)
    ref_logits = np.asarray(jbase.logits(jnp.asarray(x)))
    ref_labels = np.asarray(jbase.infer(jnp.asarray(x)))
    for pallas in (True, False):
        pi = tpacked.build_packed_infer(model, None, torch.float32,
                                        pallas=pallas, device="cpu")
        np.testing.assert_allclose(pi.logits(x).numpy(), ref_logits,
                                   rtol=2e-4, atol=2e-4)
        got = pi.infer(x)
        assert got.dtype == torch.int32
        _assert_labels_match(got, ref_labels, ref_logits)
    # serving forms of the chain graph, against the JAX chain graph
    pi = tpacked.build_packed_infer(model, None, torch.float32, pallas=True,
                                    device="cpu")
    _assert_labels_match(pi.infer(x), jchain.infer(jnp.asarray(x)), ref_logits)
    fn, unpack = pi.infer_u8_packed()
    jfn, junpack = jchain.infer_u8_packed()
    _assert_labels_match(unpack(fn(x)), junpack(jfn(jnp.asarray(x))), ref_logits)
    u8 = pi.infer_u8_io(x_u8)
    assert u8.dtype == torch.uint8
    ref_u8_logits = np.asarray(jbase.logits(
        jraw_preprocess(jnp.asarray(x_u8))))
    _assert_labels_match(u8, jchain.infer_u8_io(jnp.asarray(x_u8)), ref_u8_logits)
    fn4, unpack4 = pi.infer_u4_packed()
    np.testing.assert_array_equal(unpack4(fn4(x)), unpack(fn(x)))


def test_bf16_packed_graph_close_to_jax():
    """bf16 (the serving dtype): logits within bf16 tolerance and labels in
    near-total agreement with the JAX bf16 chain graph."""
    jm, jp, model = _pair(dict(), seed=4)
    x = np.random.default_rng(4).standard_normal((1, 120, 160, 3)).astype(np.float32)
    jchain = jpacked.build_packed_infer(jm, jp, dtype=jnp.bfloat16, pallas=True,
                                        pallas_interpret=True)
    pi = tpacked.build_packed_infer(model, None, torch.bfloat16, pallas=True,
                                    device="cpu")
    np.testing.assert_allclose(pi.logits(x).float().numpy(),
                               np.asarray(jchain.logits(jnp.asarray(x))
                                          .astype(jnp.float32)),
                               rtol=0.05, atol=0.05)
    agree = np.mean(pi.infer(x).numpy() == np.asarray(jchain.infer(jnp.asarray(x))))
    assert agree > 0.999, agree


@pytest.mark.parametrize("args", [
    dict(f_in=4, f_out=2, stride=2), dict(f_in=2, f_out=2),
    dict(f_in=1, f_out=2, transpose=True), dict(f_in=2, f_out=4, transpose=True),
    dict(f_in=4, f_out=4, k=1)])
def test_packers_match_jax(args):
    args = dict(args)
    k = args.pop("k", 3)
    w = np.random.default_rng(2).standard_normal((k, k, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(tpacked.pack_conv_weight(w, **args),
                                  jpacked.pack_conv_weight(w, **args))
    w3 = w if k == 3 else np.random.default_rng(3).standard_normal(
        (3, 3, 3, 5)).astype(np.float32)
    for group in (4, 8):
        np.testing.assert_array_equal(
            tpacked.pack_stem_weight_grouped(w3, 4, group),
            jpacked.pack_stem_weight_grouped(w3, 4, group))


def test_space_to_depth_roundtrip_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 8, 12, 3)).astype(np.float32)
    got = tpacked.space_to_depth(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpacked.space_to_depth(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tpacked.depth_to_space(got, 4).numpy(), x)


@pytest.mark.parametrize("argmax_head", [True, False])
def test_full_chain_graph_matches_jax(argmax_head):
    """The flagship with the folded stem and the deep chain (three chains):
    against JAX's plain packed graph, and its labels against JAX's
    interpreted full chain graph."""
    jm, jp, model = _pair(dict(no_scale=True), seed=2, randomize_bn=True)
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jbase = jpacked.build_packed_infer(jm, jp, dtype=jnp.float32)
    ref_logits = np.asarray(jbase.logits(jnp.asarray(x)))
    ref_labels = np.asarray(jbase.infer(jnp.asarray(x)))
    pi = tpacked.build_packed_infer(model, None, torch.float32, pallas=True,
                                    pallas_fold_stem=True, pallas_deep=True,
                                    pallas_argmax_head=argmax_head,
                                    device="cpu")
    assert [len(pi.chains[k]) for k in ("down", "deep", "up")] == [5, 6, 3]
    assert pi.chains["down"][0].stem_f == 4
    _check_serving_forms(pi, x, ref_logits, ref_labels)
    if argmax_head:
        jchain = jpacked.build_packed_infer(
            jm, jp, dtype=jnp.float32, pallas=True, pallas_interpret=True,
            pallas_fold_stem=True, pallas_deep=True)
        _assert_labels_match(pi.infer(x), jchain.infer(jnp.asarray(x)),
                             ref_logits)


def test_full_chain_graph_launches_three_chains_a_frame():
    """Each served frame of the full chain graph makes three chain calls,
    tagged as the JAX package tags them: the folded-stem down chain, the
    deep chain, the up chain with its head."""
    model = tzoo.make("robo_unet", no_scale=True, device="cpu")
    pi = tpacked.build_packed_infer(model, None, torch.float32, pallas=True,
                                    pallas_fold_stem=True, pallas_deep=True,
                                    device="cpu")
    calls = []
    orig = pi._chain

    def record(tag, x, stages, skips=()):
        calls.append((tag, [st.argmax_groups for st in stages]))
        return orig(tag, x, stages, skips)

    pi._chain = record
    fn, _ = pi.infer_u8_packed()
    fn(np.zeros((1, 64, 64, 3), np.float32))
    assert [t for t, _ in calls] == ["down", "deep", "up"]
    assert calls[-1][1][-1] == 16


@pytest.mark.parametrize("pallas", [False, True])
def test_pb_fcn_2_packed_graph_matches_jax(pallas):
    """PB_FCN_2 (the tester's --v2 net) rides the flagship plan."""
    jm, jp, model = _pair(dict(), seed=5, family="pb_fcn_2", randomize_bn=True)
    x = np.random.default_rng(6).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jbase = jpacked.build_packed_infer(jm, jp, dtype=jnp.float32)
    kw = dict(pallas=True, pallas_fold_stem=True, pallas_deep=True) if pallas \
        else {}
    pi = tpacked.build_packed_infer(model, None, torch.float32, device="cpu",
                                    **kw)
    _check_serving_forms(pi, x, np.asarray(jbase.logits(jnp.asarray(x))),
                         np.asarray(jbase.infer(jnp.asarray(x))))


@pytest.mark.parametrize("no_scale,hw", [(False, (32, 64)), (True, (64, 64))])
def test_pb_fcn_packed_graph_matches_jax(no_scale, hw):
    """build_packed_pb_fcn with pallas and pallas_deep off and on, against
    JAX's plain packed graph; the deep chain graph's labels also against
    JAX's interpreted one."""
    jm, jp, model = _pair(dict(no_scale=no_scale), seed=7, family="pb_fcn",
                          randomize_bn=True)
    x = np.random.default_rng(8).standard_normal((2, *hw, 3)).astype(np.float32)
    jbase = jpacked.build_packed_pb_fcn(jm, jp, dtype=jnp.float32)
    ref_logits = np.asarray(jbase.logits(jnp.asarray(x)))
    ref_labels = np.asarray(jbase.infer(jnp.asarray(x)))
    for kw in (dict(), dict(pallas=True), dict(pallas=True, pallas_deep=True)):
        pi = tpacked.build_packed_pb_fcn(model, None, torch.float32,
                                         device="cpu", **kw)
        _check_serving_forms(pi, x, ref_logits, ref_labels)
    assert [st.dil for st in pi.chains["down"]] == [1, 1, 1, 1, 2]
    assert [st.relu_only for st in pi.chains["down"]] == [False, False, True,
                                                          False, True]
    assert [st.dil for st in pi.chains["deep"]] == [2] * 5
    if not no_scale:
        jchain = jpacked.build_packed_pb_fcn(jm, jp, dtype=jnp.float32,
                                            pallas=True, pallas_interpret=True,
                                            pallas_deep=True)
        _assert_labels_match(pi.infer(x), jchain.infer(jnp.asarray(x)),
                             ref_logits)


def test_unported_build_options_raise():
    model = tzoo.make("robo_unet", device="cpu", levels=3)
    # strided levels=3 plans chain their up region only: no folded stem
    assert tpacked.build_packed_infer(model, None, torch.float32, pallas=True,
                                      device="cpu").chains["down"] is None
    with pytest.raises(ValueError):
        tpacked.build_packed_infer(model, None, torch.float32, pallas=True,
                                   pallas_fold_stem=True, device="cpu")
    unet = tzoo.make("robo_unet", device="cpu", pool=True, levels=3,
                     belly_size=0)
    with pytest.raises(ValueError):  # the deep chain is the strided plans'
        tpacked.build_packed_infer(unet, None, torch.float32, pallas=True,
                                   pallas_deep=True, device="cpu")
    no_belly = tzoo.make("robo_unet", device="cpu", belly_size=0)
    with pytest.raises(ValueError):  # the deep chain needs a PB belly
        tpacked.build_packed_infer(no_belly, None, torch.float32, pallas=True,
                                   pallas_deep=True, device="cpu")
    with pytest.raises(ValueError):  # PB_FCN has its own builder
        tpacked.build_packed_infer(tzoo.make("pb_fcn", device="cpu"), None,
                                   torch.float32, device="cpu")
    with pytest.raises(ValueError):  # the packed PB_FCN is its segment mode
        tpacked.build_packed_pb_fcn(tzoo.make("pb_fcn", classify=True,
                                              device="cpu"), device="cpu")
    # int8: a graph with no chains, and one already quantized, are refused
    plain = tpacked.build_packed_infer(model, None, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="chain graph"):
        tpacked.quantize_int8(plain, np.zeros((1, 64, 64, 3), np.float32))
    chained = tpacked.build_packed_infer(model, None, torch.float32,
                                         pallas=True, device="cpu")
    q = tpacked.quantize_int8(chained, np.zeros((1, 64, 64, 3), np.float32))
    with pytest.raises(ValueError, match="already quantized"):
        tpacked.quantize_int8(q, np.zeros((1, 64, 64, 3), np.float32))


# the --UNet and --v2 rows of train.py's hyperparameter table, and the
# off-table corners the plan must still cover (tests/test_packed_infer.py)
_VARIANTS = {
    "unet": dict(pool=True, levels=3, belly_size=0),
    "v2": dict(v2=True, levels=1, belly_size=9, class_size=3, belly_planes=64),
    "levels3": dict(levels=3, belly_size=0),
    "v2_pool": dict(v2=True, pool=True, levels=2, class_size=3),
}


@pytest.mark.parametrize("variant,no_scale,chain_kw,lens", [
    ("unet", False, dict(), [6, 3]),
    ("unet", False, dict(pallas_fold_stem=True), [8, 3]),
    ("unet", True, dict(pallas_fold_stem=True), [8, 3]),
    ("v2", False, dict(pallas_fold_stem=True, pallas_deep=True), [3, 9, 3]),
    ("v2", True, dict(pallas_fold_stem=True, pallas_deep=True), [3, 9, 3]),
    ("levels3", False, dict(), [None, 3]),
    ("v2_pool", False, dict(pallas_fold_stem=True), [5, 3]),
])
def test_variant_packed_graphs_match_jax(variant, no_scale, chain_kw, lens):
    """The plain and chain graphs of a variant against JAX's plain packed
    graph (which the JAX package's tests hold its chains to): logits, the
    fused-argmax labels and the serving forms."""
    jm, jp, model = _pair(dict(no_scale=no_scale, **_VARIANTS[variant]),
                          seed=9, randomize_bn=True)
    x = np.random.default_rng(10).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jbase = jpacked.build_packed_infer(jm, jp, dtype=jnp.float32)
    ref_logits = np.asarray(jbase.logits(jnp.asarray(x)))
    ref_labels = np.asarray(jbase.infer(jnp.asarray(x)))
    plain = tpacked.build_packed_infer(model, None, torch.float32, device="cpu")
    np.testing.assert_allclose(plain.logits(x).numpy(), ref_logits,
                               rtol=2e-4, atol=2e-4)
    _assert_labels_match(plain.infer(x), ref_labels, ref_logits)
    pi = tpacked.build_packed_infer(model, None, torch.float32, pallas=True,
                                    device="cpu", **chain_kw)
    got = [None if pi.chains[k] is None else len(pi.chains[k])
           for k in ("down", "deep", "up") if k in pi.chains]
    assert got == lens
    _check_serving_forms(pi, x, ref_logits, ref_labels)


def test_unet_chain_graph_matches_interpreted_jax_chains():
    """The --UNet chain graph's labels against the JAX package's own chain
    graph (its Pallas kernels in interpret mode), at QVGA's 32x64 corner."""
    jm, jp, model = _pair(_VARIANTS["unet"], seed=11, randomize_bn=True)
    x = np.random.default_rng(12).standard_normal((1, 32, 64, 3)).astype(np.float32)
    jbase = jpacked.build_packed_infer(jm, jp, dtype=jnp.float32)
    jchain = jpacked.build_packed_infer(jm, jp, dtype=jnp.float32, pallas=True,
                                        pallas_interpret=True,
                                        pallas_fold_stem=True)
    pi = tpacked.build_packed_infer(model, None, torch.float32, pallas=True,
                                    pallas_fold_stem=True, device="cpu")
    _assert_labels_match(pi.infer(x), jchain.infer(jnp.asarray(x)),
                         np.asarray(jbase.logits(jnp.asarray(x))))


@pytest.mark.parametrize("variant,min_agree", [("unet", 0.99), ("v2", 0.995)])
def test_variant_bf16_graphs_close_to_jax(variant, min_agree):
    """bf16 (the serving dtype): the port's chain graph against the JAX
    package's bf16 packed graph, and the fused argmax head equal to the
    argmax of the same graph's logits, ties included."""
    kw = dict(pallas_fold_stem=True) if variant == "unet" \
        else dict(pallas_fold_stem=True, pallas_deep=True)
    jm, jp, model = _pair(_VARIANTS[variant], seed=13, randomize_bn=True)
    x = np.random.default_rng(14).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jbf16 = jpacked.build_packed_infer(jm, jp, dtype=jnp.bfloat16)
    pi = tpacked.build_packed_infer(model, None, torch.bfloat16, pallas=True,
                                    device="cpu", **kw)
    labels = pi.infer(x)
    agree = np.mean(labels.numpy() == np.asarray(jbf16.infer(jnp.asarray(x))))
    assert agree >= min_agree, agree
    logits = pi.logits(x)
    assert logits.dtype == torch.bfloat16
    assert torch.equal(labels.long(), torch.argmax(logits.float(), dim=-1))


def test_packed_max_pool_matches_zoo_pool():
    """packed_max_pool on the packed grid is the plain 2x2 max pool."""
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (2, 16, 24, 6)).astype(np.float32))
    from robocupvision_tpu_torch.ops import nn as tnn
    for f in (4, 2):
        got = tpacked.packed_max_pool(tpacked.space_to_depth(x, f), f)
        want = tpacked.space_to_depth(tnn.max_pool(x, 2, 2), f // 2)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        tpacked.packed_max_pool(x, 1)
