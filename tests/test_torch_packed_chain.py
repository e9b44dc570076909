"""The port's fused conv chain (robocupvision_tpu_torch.ops.cuda_packed)
against the JAX package's ``chain_reference`` on JAX's own stages: the
flagship's down and up chains from ``build_packed_infer(pallas=True)`` at
QVGA (packed grid 30x40), its folded-stem down chain (``stem_f``) and deep
chain from ``pallas_fold_stem=True, pallas_deep=True``, and PB_FCN's down
chain (``relu_only``, and ``dil`` on its appended stage), deep chain
(``dil``) and up chain from ``build_packed_pb_fcn(pallas=True,
pallas_deep=True)``, LabelProp's up chain from
``build_packed_label_prop(pallas=True)``, whose classifier takes a 1x1
``skip_w`` kernel, and a synthetic chain with a 3x3 ``skip_w`` stage.

Tolerances: f32 at rtol = atol = 2e-4 (conv reassociation); bf16 per
element at two bf16 ulps of the reference plus 2**-8 of its largest
magnitude (``bf16_tolerance``), because both sides round every stage to
bf16 and a sum that lands on the other side of a rounding boundary moves by
one bf16 ulp, which the later stages carry. Labels: f32 equal, bf16 >= 0.999 agreement. The K2 kernel is
held against ``chain_reference`` on the card in
tests/test_torch_cuda_kernels.py."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robocupvision_tpu.models import packed as jpacked
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu.ops import pallas_packed as jppk
from robocupvision_tpu_torch.ops import cuda_packed as tppk

_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jax_chains(jdtype):
    model = jzoo.make("robo_unet")
    params = model.init(jax.random.PRNGKey(5))
    return jpacked.build_packed_infer(model, params, dtype=jdtype, pallas=True,
                                      pallas_interpret=True).chains


def _np32(a):
    return None if a is None else np.array(jnp.asarray(a, jnp.float32))


def _port_stage(st):
    def t(a):
        return None if a is None else torch.from_numpy(_np32(a))
    return tppk.ChainStage(w=t(st.w), b=t(st.b), scale=t(st.scale),
                           shift=t(st.shift), rbb=st.rbb, skip_idx=st.skip_idx,
                           emit=st.emit, stem_f=st.stem_f,
                           relu_only=st.relu_only, dil=st.dil,
                           argmax_groups=st.argmax_groups,
                           skip_w=t(st.skip_w))


def _input(seed, shape, tdtype):
    """Chain-dtype values shared by both sides (bf16 rounded once, RNE)."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                         .astype(np.float32)).to(tdtype)
    return x, jnp.asarray(x.float().numpy()).astype(_jdt(tdtype))


def _jdt(tdtype):
    return jnp.bfloat16 if tdtype == torch.bfloat16 else jnp.float32


def _assert_outputs_match(got, ref, dt, tdtype):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.array(r.astype(jnp.float32)) if r.dtype != jnp.int32 else np.asarray(r)
        assert tuple(g.shape) == r.shape
        if g.dtype == torch.int32:
            agree = np.mean(g.numpy() == r)
            assert agree >= (1.0 if dt == "f32" else 0.999), agree
        elif dt == "f32":
            assert g.dtype == tdtype
            np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=2e-4)
        else:
            assert g.dtype == tdtype
            err = (g.float() - torch.from_numpy(r)).abs()
            tol = tppk.bf16_tolerance(torch.from_numpy(r))
            assert bool((err <= tol).all()), float(err.max())


def _randomized(params, seed):
    """Params with BN running stats drawn from numpy, so the BN fold of
    every affine stage is exercised."""
    rng = np.random.default_rng(seed)
    out = {k: np.array(v) for k, v in params.items()}
    for k in out:
        if k.endswith(".running_mean"):
            out[k] = rng.standard_normal(out[k].shape).astype(np.float32) * 0.3
        elif k.endswith(".running_var"):
            out[k] = (0.5 + rng.random(out[k].shape)).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in out.items()}


def _jax_feature_chains(family, jdtype):
    if family == "flagship":
        model = jzoo.make("robo_unet")
        params = _randomized(model.init(jax.random.PRNGKey(11)), 11)
        return jpacked.build_packed_infer(
            model, params, dtype=jdtype, pallas=True, pallas_interpret=True,
            pallas_fold_stem=True, pallas_deep=True).chains
    model = jzoo.make("pb_fcn", no_scale=True)
    params = _randomized(model.init(jax.random.PRNGKey(12)), 12)
    return jpacked.build_packed_pb_fcn(model, params, dtype=jdtype, pallas=True,
                                      pallas_interpret=True,
                                      pallas_deep=True).chains


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("which,head", [("down", False), ("up", False),
                                        ("up", True)])
def test_chain_reference_matches_jax(dt, which, head):
    jdtype, tdtype = _DT[dt]
    stages = _jax_chains(jdtype)[which]
    if head:
        stages = jppk.with_argmax_head(stages, 16)
    tstages = [_port_stage(s) for s in stages]
    cin = int(stages[0].w.shape[2])
    x_t, x_j = _input(1, (2, 30, 40, cin), tdtype)
    skips_t, skips_j = [], []
    if which == "up":
        for i, c in enumerate((64, 128)):  # feats1, feats0 widths
            s_t, s_j = _input(2 + i, (2, 30, 40, c), tdtype)
            skips_t.append(s_t)
            skips_j.append(s_j)
    ref = jppk.chain_reference(x_j, stages, skips=skips_j)
    got = tppk.fused_conv_chain(x_t, tstages, skips=skips_t)  # CPU: the plain path
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.array(r.astype(jnp.float32)) if r.dtype != jnp.int32 else np.asarray(r)
        assert tuple(g.shape) == r.shape
        if g.dtype == torch.int32:
            agree = np.mean(g.numpy() == r)
            assert agree >= (1.0 if dt == "f32" else 0.999), agree
        elif dt == "f32":
            assert g.dtype == tdtype
            np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=2e-4)
        else:
            assert g.dtype == tdtype
            err = (g.float() - torch.from_numpy(r)).abs()
            tol = tppk.bf16_tolerance(torch.from_numpy(r))
            assert bool((err <= tol).all()), float(err.max())


# (family, chain, head): input shape and skip widths of each chain
_FEATURE_CASES = {
    ("flagship", "down"): ((2, 120, 160, 3), ()),      # stem_f: raw image
    ("flagship", "deep"): ((2, 8, 10, 64), ()),
    ("pb_fcn", "down"): ((2, 16, 24, 48), ()),          # relu_only, dil
    ("pb_fcn", "deep"): ((2, 8, 10, 64), ()),           # dil
    ("pb_fcn", "up"): ((2, 16, 24, 32), (64, 128)),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("family,which,head", [
    ("flagship", "down", False), ("flagship", "deep", False),
    ("pb_fcn", "down", False), ("pb_fcn", "deep", False),
    ("pb_fcn", "up", False), ("pb_fcn", "up", True)])
def test_chain_reference_matches_jax_stage_features(dt, family, which, head):
    """stem_f, dil and relu_only stages, and the chains they sit in (the
    flagship's deep chain is plain stages only), on the CPU path against
    JAX's chain_reference."""
    jdtype, tdtype = _DT[dt]
    stages = _jax_feature_chains(family, jdtype)[which]
    if head:
        stages = jppk.with_argmax_head(stages, 16)
    tstages = [_port_stage(s) for s in stages]
    shape, skip_c = _FEATURE_CASES[(family, which)]
    x_t, x_j = _input(3, shape, tdtype)
    skips = [_input(4 + i, shape[:3] + (c,), tdtype)
             for i, c in enumerate(skip_c)]
    ref = jppk.chain_reference(x_j, stages, skips=[s[1] for s in skips])
    got = tppk.fused_conv_chain(x_t, tstages, skips=[s[0] for s in skips])
    _assert_outputs_match(got, ref, dt, tdtype)


def test_stem_chain_grid_and_emits():
    """A stem_f=4 chain takes the raw image and runs on the /4 grid; its
    stage 0 output (feats0) is emitted first."""
    stages = [_port_stage(s) for s in _jax_feature_chains("flagship",
                                                          jnp.float32)["down"]]
    x, _ = _input(9, (1, 64, 96, 3), torch.float32)
    outs = tppk.fused_conv_chain(x, stages)
    assert [tuple(o.shape) for o in outs] == [(1, 16, 24, 128), (1, 16, 24, 64),
                                              (1, 16, 24, 32)]


def test_argmax_head_equals_argmax_of_logits():
    """First max wins, on the logits rounded to the chain dtype."""
    stages = [_port_stage(s) for s in _jax_chains(jnp.bfloat16)["up"]]
    x, _ = _input(7, (1, 30, 40, 32), torch.bfloat16)
    skips = [_input(8 + i, (1, 30, 40, c), torch.bfloat16)[0]
             for i, c in enumerate((64, 128))]
    logits = tppk.chain_reference(x, stages, skips)[-1]
    labels = tppk.chain_reference(x, tppk.with_argmax_head(stages, 16), skips)[-1]
    ref = torch.argmax(logits.float().reshape(1, 30, 40, 16, 5), dim=-1)
    assert labels.dtype == torch.int32
    assert torch.equal(labels.long(), ref)


def test_halo_depths():
    w3, w1 = torch.zeros(3, 3, 4, 4), torch.zeros(1, 1, 4, 4)
    st = [tppk.ChainStage(w=w, b=torch.zeros(4)) for w in (w3, w3, w1, w3, w1)]
    assert tppk._halo_depths(st) == [2, 1, 1, 0, 0]
    # a dilated stage reaches dil * (K // 2) rows: it deepens every halo
    # before it
    st[1] = dataclasses.replace(st[1], dil=2)
    assert tppk._halo_depths(st) == [3, 1, 1, 0, 0]


@pytest.mark.parametrize("field", [dict(w_scale=torch.ones(4)), dict(pool=True),
                                   dict(pool=True, skip_w=torch.zeros(3, 3, 4, 4),
                                        skip_idx=0),
                                   dict(pool=True, x_scale=0.1),
                                   dict(x_scale=0.1),
                                   dict(x_scale=0.1, skip_w=torch.zeros(1, 1, 4, 4),
                                        skip_idx=0)])
def test_unported_stage_features_raise(field):
    st = tppk.ChainStage(w=torch.zeros(3, 3, 4, 4), b=torch.zeros(4), **field)
    with pytest.raises(NotImplementedError):
        tppk.fused_conv_chain(torch.zeros(1, 4, 4, 4), [st])


@pytest.mark.parametrize("stages", [
    # a stem stage after stage 0, a dilated stem, a stem kernel of the
    # wrong height, a zero dilation, a relu-only argmax head
    lambda w3, ws: [tppk.ChainStage(w=w3, b=torch.zeros(4)),
                    tppk.ChainStage(w=ws, b=torch.zeros(4), stem_f=4)],
    lambda w3, ws: [tppk.ChainStage(w=ws, b=torch.zeros(4), stem_f=4, dil=2)],
    lambda w3, ws: [tppk.ChainStage(w=ws, b=torch.zeros(4), stem_f=2)],
    lambda w3, ws: [tppk.ChainStage(w=w3, b=torch.zeros(4), dil=0)],
    lambda w3, ws: [tppk.ChainStage(w=w3, b=torch.zeros(4), relu_only=True,
                                    argmax_groups=2)]])
def test_misplaced_stage_features_raise(stages):
    w3, ws = torch.zeros(3, 3, 4, 4), torch.zeros(6, 3, 4, 4)
    with pytest.raises(ValueError):
        tppk.fused_conv_chain(torch.zeros(1, 8, 8, 4), stages(w3, ws))


def _lp_up_chain(jdtype):
    """LabelProp's up chain [upConv2 + skip 0, upConv3, classifier + 1x1
    skip_w over skip 1] from the JAX package's builder, planes=8 (widths
    4 -> 16 -> 64 -> 80 on the packed grid, skips 16 and 32 wide)."""
    model = jzoo.make("label_prop", planes=8)
    params = _randomized(model.init(jax.random.PRNGKey(13)), 13)
    return jpacked.build_packed_label_prop(model, params, dtype=jdtype,
                                           pallas=True,
                                           pallas_interpret=True).chains["up"]


def _skip_w3_chain(jdtype, seed=14):
    """A synthetic chain whose second stage is the v2 split concat's form:
    a 3x3 conv of the previous stage plus a 3x3 conv of skip 0 (12 channels
    wide, not the stage's 8), before its bias and affine."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                           * 0.3).astype(jdtype)

    def v(c):
        return jnp.asarray(rng.standard_normal(c).astype(np.float32) * 0.1)

    return [jppk.ChainStage(w=a(3, 3, 6, 8), b=v(8), scale=1 + v(8),
                            shift=v(8), rbb=False),
            jppk.ChainStage(w=a(3, 3, 8, 8), b=v(8), scale=1 + v(8),
                            shift=v(8), rbb=True, skip_idx=0,
                            skip_w=a(3, 3, 12, 8), emit=True),
            jppk.ChainStage(w=a(1, 1, 8, 10), b=v(10))]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["lp_up", "lp_up_head", "skip_w3",
                                  "skip_w3_head"])
def test_chain_reference_matches_jax_skip_w(dt, case):
    """skip_w stages (K = 1 and K = 3) on the CPU path against JAX's
    chain_reference: the skip's conv summed before the bias, no identity
    add after the epilogue, the skip as wide as skip_w's Cin."""
    jdtype, tdtype = _DT[dt]
    if case.startswith("lp_up"):
        stages = _lp_up_chain(jdtype)
        shape, skip_c = (2, 12, 16, 4), (16, 32)
    else:
        stages = _skip_w3_chain(jdtype)
        shape, skip_c = (2, 9, 11, 6), (12,)
    if case.endswith("head"):
        stages = jppk.with_argmax_head(stages, 2 if case == "skip_w3_head"
                                       else 16)
    x_t, x_j = _input(15, shape, tdtype)
    skips = [_input(16 + i, shape[:3] + (c,), tdtype)
             for i, c in enumerate(skip_c)]
    ref = jppk.chain_reference(x_j, stages, skips=[s[1] for s in skips])
    got = tppk.fused_conv_chain(x_t, [_port_stage(s) for s in stages],
                                skips=[s[0] for s in skips])
    _assert_outputs_match(got, ref, dt, tdtype)


def test_skip_w_replaces_the_identity_add():
    """A zero skip kernel adds nothing: the stage equals the same stage
    with no skip at all, not one with the identity skip added."""
    w = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (3, 3, 4, 4)).astype(np.float32))
    x, _ = _input(18, (1, 6, 7, 4), torch.float32)
    skip, _ = _input(19, (1, 6, 7, 4), torch.float32)
    plain = tppk.ChainStage(w=w, b=torch.zeros(4))
    zero_skip = dataclasses.replace(plain, skip_idx=0,
                                    skip_w=torch.zeros(1, 1, 4, 4))
    want = tppk.fused_conv_chain(x, [plain])[0]
    assert torch.equal(tppk.fused_conv_chain(x, [zero_skip], [skip])[0], want)


@pytest.mark.parametrize("skip_w,skip_idx", [
    (torch.zeros(3, 4, 4), 0),           # not 4-D
    (torch.zeros(2, 2, 4, 4), 0),        # K not in (1, 3)
    (torch.zeros(1, 3, 4, 4), 0),        # not square
    (torch.zeros(1, 1, 4, 5), 0),        # Cout differs from the stage's
    (torch.zeros(1, 1, 4, 4), -1)])      # no skip to convolve
def test_bad_skip_w_raises(skip_w, skip_idx):
    st = tppk.ChainStage(w=torch.zeros(3, 3, 4, 4), b=torch.zeros(4),
                         skip_w=skip_w, skip_idx=skip_idx)
    with pytest.raises(ValueError):
        tppk.fused_conv_chain(torch.zeros(1, 4, 4, 4), [st],
                              [torch.zeros(1, 4, 4, 4)])
