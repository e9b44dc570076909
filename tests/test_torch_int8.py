"""The port's static int8 serving (robocupvision_tpu_torch.ops.cuda_packed's
``chain_stats``, ``quantize_chain_stages`` and int8 ``chain_reference``;
models/packed.quantize_int8) against the JAX package's, on the CPU, for the
five families at the shapes of tests/test_pallas_packed.py's
``test_quantize_int8_families``: the flagship full chain graph, ``--UNet``
(pool stages), ``--v2`` (3x3 ``skip_w``), LabelProp (1x1 ``skip_w``, a
dilated mid chain) and PB_FCN (``relu_only``, dilated deep chain).

Tolerances: calibration statistics (max and 99.9th percentile of |stage
input|) within rtol 1e-6 of JAX's ``collect``; quantized weights
bit-identical and scales equal; the int8 ``chain_reference`` within 1e-5 of
JAX's on the same quantized stages (the bound tests/test_pallas_packed.py
holds its int8 kernel to); quantized graphs' labels equal to the JAX
quantized graph's on >= 0.999 of the pixels (f32; the JAX graph runs its
chains through its plain reference), and agreeing with the float graph on
> 0.97 of them (> 0.88 for PB_FCN, as the JAX test holds its own) in
bf16. The K2 kernel's int8 stages are held against ``chain_reference`` on
the card in tests/test_torch_cuda_kernels.py."""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robocupvision_tpu.models import packed as jpacked
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu.ops import pallas_packed as jppk
from robocupvision_tpu_torch.export import torch_io
from robocupvision_tpu_torch.models import packed as tpacked
from robocupvision_tpu_torch.models import zoo as tzoo
from robocupvision_tpu_torch.ops import cuda_packed as tppk

# family -> (zoo family, zoo kwargs, input shape, chain-graph flags)
_FAMILIES = {
    "flagship": ("robo_unet", dict(), (1, 64, 64, 3),
                 dict(pallas_fold_stem=True, pallas_deep=True)),
    "unet": ("robo_unet", dict(pool=True, levels=3, belly_size=0),
             (1, 64, 64, 3), dict(pallas_fold_stem=True)),
    "v2": ("robo_unet", dict(v2=True, levels=1, belly_size=9, belly_planes=64,
                             class_size=3),
           (1, 64, 64, 3), dict(pallas_fold_stem=True, pallas_deep=True)),
    "label_prop": ("label_prop", dict(), (1, 64, 64, 8),
                   dict(pallas_fold_stem=True, pallas_mid=True)),
    "pb_fcn": ("pb_fcn", dict(), (1, 32, 64, 3), dict(pallas_deep=True)),
}
_BUILDERS = {"robo_unet": (jpacked.build_packed_infer,
                           tpacked.build_packed_infer),
             "label_prop": (jpacked.build_packed_label_prop,
                            tpacked.build_packed_label_prop),
             "pb_fcn": (jpacked.build_packed_pb_fcn,
                        tpacked.build_packed_pb_fcn)}
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _graphs(family, dt):
    """(JAX chain graph, port chain graph, input) of one family: the same
    random weights (BN running stats perturbed, so every BN fold is
    exercised) in both packages through the weight carry."""
    zfam, kw, shape, flags = _FAMILIES[family]
    seed = 83 + list(_FAMILIES).index(family)
    jm = jzoo.make(zfam, **kw)
    rng = np.random.default_rng(seed)
    params = {k: np.array(v) for k, v in jm.init(jax.random.PRNGKey(seed)).items()}
    for k in params:
        if k.endswith(".running_mean"):
            params[k] = rng.standard_normal(params[k].shape).astype(np.float32) * 0.3
        elif k.endswith(".running_var"):
            params[k] = (0.5 + rng.random(params[k].shape)).astype(np.float32)
    model = tzoo.make(zfam, device="cpu", **kw)
    model.load_state_dict(torch_io.from_jax_params(model.registry, params))
    jdt, tdt = _DT[dt]
    jbuild, tbuild = _BUILDERS[zfam]
    jg = jbuild(jm, {k: jnp.asarray(v) for k, v in params.items()}, jdt,
                pallas=True, pallas_interpret=True, **flags)
    tg = tbuild(model, None, tdt, pallas=True, device="cpu", **flags)
    x = np.random.default_rng(81).standard_normal(shape).astype(np.float32)
    return jg, tg, x


def _jax_collect(jg, x, pct):
    col = {}
    probe = dataclasses.replace(jg, chains={**jg.chains, "collect": col,
                                            "collect_pct": pct})
    probe._logits_packed(jnp.asarray(x))
    return col


def _port_collect(tg, x, pct):
    col = {}
    probe = dataclasses.replace(tg, chains={**tg.chains, "collect": col,
                                            "collect_pct": pct})
    probe._logits_packed(torch.from_numpy(x))
    return col


def _np(a, dtype=np.float32):
    return None if a is None else np.array(jnp.asarray(a).astype(dtype))


def _port_stage(st):
    """A JAX ChainStage as the port's: kernels and vectors in f32, an int8
    stage's kernel in int8 with its scales."""
    def t(a, dtype=np.float32):
        return None if a is None else torch.from_numpy(_np(a, dtype))
    q = bool(st.x_scale) and not st.pool
    return tppk.ChainStage(w=t(st.w, np.int8 if q else np.float32), b=t(st.b),
                           scale=t(st.scale), shift=t(st.shift), rbb=st.rbb,
                           skip_idx=st.skip_idx, emit=st.emit,
                           stem_f=st.stem_f, relu_only=st.relu_only,
                           dil=st.dil, argmax_groups=st.argmax_groups,
                           skip_w=t(st.skip_w), pool=st.pool,
                           x_scale=st.x_scale, w_scale=t(st.w_scale))


@pytest.mark.parametrize("pct", [None, 99.9])
@pytest.mark.parametrize("family", list(_FAMILIES))
def test_calibration_statistics_match_jax(family, pct):
    """Every chain's per-stage statistic of |stage input| (the chain input,
    then each stage's output at the chain dtype), from the port's one
    all-stages-emitted chain call, equals JAX's chain_reference ``collect``."""
    jg, tg, x = _graphs(family, "f32")
    want, got = _jax_collect(jg, x, pct), _port_collect(tg, x, pct)
    assert sorted(got) == sorted(want)
    for tag in want:
        assert len(got[tag]) == len(tg.chains[tag])
        np.testing.assert_allclose(got[tag], want[tag], rtol=1e-6)


@pytest.mark.parametrize("n", [1, 7, 1000, 20001])
def test_percentile_matches_jnp_quantile(n):
    a = np.random.default_rng(n).standard_normal((n,)).astype(np.float32)
    for pct in (0.0, 50.0, 99.5, 99.9, 100.0):
        want = float(jnp.quantile(jnp.abs(jnp.asarray(a)), pct / 100.0))
        assert tppk._abs_stat(torch.from_numpy(a), pct) == pytest.approx(
            want, rel=1e-6, abs=0)


@pytest.mark.parametrize("family", list(_FAMILIES))
def test_quantize_chain_stages_matches_jax(family):
    """From the same statistics: int8 kernels bit-identical, w_scale and
    x_scale equal, pool stages only rescaled (their tables kept)."""
    jg, tg, x = _graphs(family, "f32")
    col = _jax_collect(jg, x, None)
    for tag, stats in col.items():
        want = jppk.quantize_chain_stages(jg.chains[tag], stats)
        got = tppk.quantize_chain_stages(tg.chains[tag], stats)
        for g, w, orig in zip(got, want, tg.chains[tag]):
            assert g.x_scale == w.x_scale
            if w.pool:
                assert g.w_scale is None and g.pool_src is orig.pool_src
                continue
            assert g.w.dtype == torch.int8
            np.testing.assert_array_equal(g.w.numpy(), _np(w.w, np.int8))
            np.testing.assert_array_equal(g.w_scale.numpy(), _np(w.w_scale))
    with pytest.raises(ValueError):
        tppk.quantize_chain_stages(tg.chains["up"], [1.0])


def _three_stage():
    """tests/test_pallas_packed.py's int8 case: a 3x3 rbb stage, a dilated
    relu-only stage with an identity skip, a 1x1 head, on (2, 16, 16, 16)."""
    rng = np.random.default_rng(71)
    x = rng.standard_normal((2, 16, 16, 16)).astype(np.float32) * 0.7
    sk = rng.standard_normal((2, 16, 16, 16)).astype(np.float32) * 0.5

    def st(shape, **kw):
        return jppk.ChainStage(
            w=jnp.asarray(rng.standard_normal(shape) * 0.3, jnp.float32),
            b=rng.standard_normal(16).astype(np.float32) * 0.1, **kw)

    stages = [st((3, 3, 16, 16), scale=0.5 + rng.random(16).astype(np.float32),
                 shift=rng.standard_normal(16).astype(np.float32) * 0.1,
                 rbb=True, emit=True),
              st((3, 3, 16, 16), relu_only=True, dil=2, skip_idx=0),
              st((1, 1, 16, 16))]
    return x, stages, [sk]


def _family_chain(family, tag, head):
    """(x, stages, skips) of one chain of a family's f32 graph, recorded
    from a JAX float forward, with the graph's own chain input and skips."""
    jg, _, x = _graphs(family, "f32")
    calls = []
    orig = jg._chain

    def rec(t, cx, stages, skips=(), band=None):
        calls.append((t, np.array(cx), [np.array(s) for s in skips]))
        return orig(t, cx, stages, skips=skips, band=band)

    probe = dataclasses.replace(jg)
    probe._chain = rec
    probe._logits_packed(jnp.asarray(x))
    cx, skips = next((c, s) for t, c, s in calls if t == tag)
    stages = jg.chains[tag]
    if head:
        stages = jppk.with_argmax_head(stages, 16)
    return cx, stages, skips


# case -> (family, chain, argmax head) of a graph's chain
_CHAIN_CASES = {"flagship_stem": ("flagship", "down", False),
                "unet_pool": ("unet", "down", False),
                "label_prop_skip_w1": ("label_prop", "up", False),
                "v2_skip_w3": ("v2", "up", False),
                "v2_skip_w3_head": ("v2", "up", True)}


@pytest.mark.parametrize("case", ["three_stage"] + list(_CHAIN_CASES))
def test_int8_chain_reference_matches_jax(case):
    """The int8 chain_reference (quantized input, exact integer convs, f32
    dequant and epilogue, requantization between stages, argmax on the
    rounded logits) against JAX's on the same quantized stages."""
    if case == "three_stage":
        x, stages, skips = _three_stage()
    else:
        x, stages, skips = _family_chain(*_CHAIN_CASES[case])
    col = []
    jskips = [jnp.asarray(s) for s in skips]
    jppk.chain_reference(jnp.asarray(x), stages, skips=jskips, collect=col)
    qst = jppk.quantize_chain_stages(stages, col)
    want = jppk.chain_reference(jnp.asarray(x), qst, skips=jskips)
    got = tppk.chain_reference(torch.from_numpy(x), [_port_stage(s) for s in qst],
                               [torch.from_numpy(s) for s in skips])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype == np.int32:
            assert np.mean(g.numpy() == w) >= 0.9999
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", list(_FAMILIES))
def test_quantize_int8_families(family):
    """quantize_int8 on each family: labels agree with the JAX quantized
    graph (f32) and with the float graph (bf16, the serving dtype); infer ==
    argmax(logits); the infer_u8_packed pair round-trips; the input graph
    is left float; a quantized graph or one without chains is refused."""
    jg, tg, x = _graphs(family, "f32")
    jq = jpacked.quantize_int8(jg, jnp.asarray(x))
    tq = tpacked.quantize_int8(tg, x)
    # the JAX quantized graph's chains through its plain reference (the
    # ``collect`` map routes its _chain there; the statistics are unused)
    jref = dataclasses.replace(jq, chains={**jq.chains, "collect": {}})
    agree_jax = np.mean(tq.infer(x).numpy() == np.asarray(jref.infer(jnp.asarray(x))))
    assert agree_jax >= 0.999, agree_jax

    _, tg16, _ = _graphs(family, "bf16")
    q16 = tpacked.quantize_int8(tg16, x)
    labels = q16.infer(x)
    agree = np.mean(labels.numpy() == tg16.infer(x).numpy())
    assert agree > (0.88 if family == "pb_fcn" else 0.97), agree
    want = torch.argmax(q16.logits(x).float(), dim=-1)
    assert torch.equal(labels.long(), want)
    device_fn, host_unpack = q16.infer_u8_packed()
    np.testing.assert_array_equal(host_unpack(device_fn(x)),
                                  want.numpy().astype(np.uint8))
    for tag in ("down", "mid", "deep", "up"):
        assert all(not st.x_scale for st in tg16.chains.get(tag) or [])
        assert all(st.x_scale > 0 for st in q16.chains.get(tag) or [])
    with pytest.raises(ValueError, match="already quantized"):
        tpacked.quantize_int8(q16, x)
    with pytest.raises(ValueError, match="chain graph"):
        tpacked.quantize_int8(dataclasses.replace(tg16, chains=None), x)


@pytest.mark.parametrize("pct", [None, 99.5])
def test_quantize_int8_calibration_statistic_matches_jax(pct):
    """``pct`` picks the calibration statistic (max, or a percentile)
    as the JAX package's does: labels agree with its quantized graph
    (f32); an unknown string is refused."""
    jg, tg, x = _graphs("pb_fcn", "f32")
    jq = jpacked.quantize_int8(jg, jnp.asarray(x), pct=pct)
    tq = tpacked.quantize_int8(tg, x, pct=pct)
    jref = dataclasses.replace(jq, chains={**jq.chains, "collect": {}})
    agree = np.mean(tq.infer(x).numpy()
                    == np.asarray(jref.infer(jnp.asarray(x))))
    assert agree >= 0.999, agree
    with pytest.raises(ValueError, match="pct"):
        tpacked.quantize_int8(tg, x, pct="max")


def test_int8_chain_on_cpu_is_chain_reference():
    """On CPU tensors fused_conv_chain runs the plain version, int8 too,
    and counts its calls there."""
    x, stages, skips = _three_stage()
    col = []
    jppk.chain_reference(jnp.asarray(x), stages,
                         skips=[jnp.asarray(s) for s in skips], collect=col)
    qst = [_port_stage(s) for s in jppk.quantize_chain_stages(stages, col)]
    xt, st = torch.from_numpy(x), [torch.from_numpy(s) for s in skips]
    before = tppk.chain_reference.calls
    got = tppk.fused_conv_chain(xt, qst, st)
    assert tppk.chain_reference.calls == before + 1
    for g, w in zip(got, tppk.chain_reference(xt, qst, st)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["rbb", "affine", "head", "pool"])
def test_flip_step_bounds_one_flipped_input_integer(case):
    """Moving one integer of a quantized stage's input by one moves no
    output element by more than int8_flip_step, which int8_mismatch then
    reports as at most one step; the kernel's multi-stage int8 check on the
    card rests on this bound."""
    rng = np.random.default_rng(97)

    def t(*shape, s=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * s)

    if case == "pool":
        st = tpacked._pool_chain_stage(2, 4, torch.float32, "cpu")
    else:
        affine = case in ("rbb", "affine")
        st = tppk.ChainStage(w=t(3, 3, 8, 8, s=0.3), b=t(8, s=0.1),
                             scale=t(8) if affine else None,
                             shift=t(8, s=0.1) if affine else None,
                             rbb=case == "rbb")
    cin = int(st.w.shape[2])
    x = t(1, 10, 12, cin)
    _, stats = tppk.chain_stats(x, [st])
    qst = tppk.quantize_chain_stages([st], stats)
    xs = qst[0].x_scale
    q = tppk._quantize(x, xs)
    y, z, c = 4, 5, 3
    if case == "pool":  # raise the largest of output lane 0's four sources
        src = qst[0].pool_src[:, 0]
        c = int(src[torch.argmax(q[0, y, z, src])])
    assert abs(float(q[0, y, z, c])) < 127
    x2 = x.clone()
    x2[0, y, z, c] = float(q[0, y, z, c] + 1) * xs
    moved = (tppk._quantize(x2, xs) - q).abs()
    assert float(moved.sum()) == 1.0 and float(moved[0, y, z, c]) == 1.0
    ref = tppk.chain_reference(x, qst)[0]
    got = tppk.chain_reference(x2, qst)[0]
    step = tppk.int8_output_steps(qst)[0]
    assert step == tppk.int8_flip_step(qst[0]) > 0
    d = float((got - ref).abs().max())
    # up to the f32 rounding of the outputs themselves
    assert 0 < d <= step + 1e-5 * float(ref.abs().max()), (d, step)
    frac, worst = tppk.int8_mismatch(got, ref, step)
    # one input pixel reaches at most 3 x 3 output pixels, every channel
    assert 0 < round(frac * ref.numel()) <= 9 * ref.shape[-1] and worst <= 1.0
    assert tppk.int8_mismatch(ref, ref, step) == (0.0, 0.0)


def test_int8_skip_conv_follows_kernel_tap_order():
    """A float skip conv summed in another order moves the int8 reference
    on a constructed tie: 2**24 + 1 rounds to 2**24 (half to even), so the
    kernel's order (channels 0, 1, 2) gives 0 where the reverse gives 1.
    The reference takes the kernel's order."""
    skip = torch.zeros((1, 2, 2, 3))
    skip[0, 0, 0] = torch.tensor([2.0 ** 24, 1.0, -2.0 ** 24])
    sw = torch.ones((1, 1, 3, 1))
    ordered = tppk.skip_conv_in_tap_order(skip, sw)
    assert float(ordered[0, 0, 0, 0]) == 0.0
    acc = torch.zeros(())
    for ci in (2, 1, 0):  # another order of the same terms
        acc = acc + skip[0, 0, 0, ci] * sw[0, 0, ci, 0]
    assert float(acc) == 1.0
    st = tppk.ChainStage(w=torch.zeros((1, 1, 4, 1), dtype=torch.int8),
                        b=torch.tensor([0.25]), x_scale=1.0,
                        w_scale=torch.tensor([1.0]), skip_idx=0, skip_w=sw,
                        emit=True)
    (y,) = tppk.chain_reference(torch.ones((1, 2, 2, 4)), [st], [skip])
    assert float(y[0, 0, 0, 0]) == 0.25
