"""The port's fused conv chain (robocupvision_tpu_torch.ops.cuda_packed)
against the JAX package's ``chain_reference`` on JAX's own stages: the
flagship's down and up chains from ``build_packed_infer(pallas=True)`` at
QVGA (packed grid 30x40), its folded-stem down chain (``stem_f``) and deep
chain from ``pallas_fold_stem=True, pallas_deep=True``, and PB_FCN's down
chain (``relu_only``, and ``dil`` on its appended stage), deep chain
(``dil``) and up chain from ``build_packed_pb_fcn(pallas=True,
pallas_deep=True)``, LabelProp's up chain from
``build_packed_label_prop(pallas=True)``, whose classifier takes a 1x1
``skip_w`` kernel, a synthetic chain with a 3x3 ``skip_w`` stage, and the
``--UNet`` down chain (``pool`` stages) and ``--v2`` up chain (3x3
``skip_w`` stages and a 3x3 head) from ``build_packed_infer``. Pool stages
alone are exact: a pool chain equals JAX's chain_reference and
``packed_max_pool`` bit for bit.

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
                           skip_w=t(st.skip_w), pool=st.pool)


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


_SEL = np.zeros((1, 4, 16, 4), np.float32)  # a valid f_in 2, c 4 stack
for _t, _src in enumerate((0, 1, 2, 3)):
    _SEL[0, _t, 4 * _src:4 * _src + 4] = np.eye(4)
_SEL_T = torch.from_numpy(_SEL)


_W8 = torch.zeros(3, 3, 4, 4, dtype=torch.int8)


@pytest.mark.parametrize("field", [
    # w_scale on a float stage
    dict(w_scale=torch.ones(4)),
    # w_scale on a float pool stage
    dict(w_scale=torch.ones(4), pool=True),
    # a quantized conv stage without w_scale (with a conv'd skip)
    dict(x_scale=0.1, w=_W8, skip_w=torch.zeros(3, 3, 4, 4), skip_idx=0),
    # w_scale on a quantized pool stage
    dict(pool=True, x_scale=0.1, w_scale=torch.ones(4)),
    # a quantized conv stage with a float kernel
    dict(x_scale=0.1, w_scale=torch.ones(4)),
    # a w_scale that is not (Cout,), beside a 1x1 conv'd skip
    dict(x_scale=0.1, w=_W8, w_scale=torch.ones(3),
         skip_w=torch.zeros(1, 1, 4, 4), skip_idx=0)])
def test_unported_stage_features_raise(field):
    """Malformed int8 stages raise ValueError, on the CPU path as on the
    card: the JAX kernel's asserts (w_scale exactly on quantized conv
    stages) and the port's own (an int8 kernel, a (Cout,) w_scale)."""
    field = dict(field)
    w = _SEL_T if field.get("pool") else field.pop("w", torch.zeros(3, 3, 4, 4))
    st = tppk.ChainStage(w=w, b=torch.zeros(4), **field)
    x = torch.zeros(1, 4, 4, 16 if field.get("pool") else 4)
    with pytest.raises(ValueError):
        tppk.fused_conv_chain(x, [st], [torch.zeros(1, 4, 4, 4)])


@pytest.mark.parametrize("scales", [(0.1, 0.0), (0.0, 0.1), (-0.1, -0.1)])
def test_mixed_or_negative_int8_chain_raises(scales):
    """Every stage of a chain is quantized or none is; a scale is > 0."""
    stages = [tppk.ChainStage(w=_W8 if s else torch.zeros(3, 3, 4, 4),
                              b=torch.zeros(4), x_scale=s,
                              w_scale=torch.ones(4) if s else None)
              for s in scales]
    with pytest.raises(ValueError):
        tppk.fused_conv_chain(torch.zeros(1, 4, 4, 4), stages)


@pytest.mark.parametrize("w,field", [
    # a conv kernel, not the (1, 4, Cin, Cout) stack
    (torch.zeros(3, 3, 4, 4), dict()),
    (torch.zeros(1, 3, 16, 4), dict()),
    # the JAX kernel's asserts: the selection stack only
    (torch.from_numpy(_SEL), dict(scale=torch.ones(4), shift=torch.zeros(4))),
    (torch.from_numpy(_SEL), dict(relu_only=True)),
    (torch.from_numpy(_SEL), dict(skip_idx=0)),
    (torch.from_numpy(_SEL), dict(skip_w=torch.zeros(3, 3, 4, 4), skip_idx=0)),
    (torch.from_numpy(_SEL), dict(stem_f=4)),
    (torch.from_numpy(_SEL), dict(argmax_groups=2)),
    # selection matrices that are not one 1 per column
    (torch.from_numpy(_SEL * 2), dict()),
    (torch.from_numpy(_SEL + _SEL[:, :, ::-1]), dict()),
    (torch.from_numpy(_SEL * (np.arange(4) != 2)), dict())])
def test_bad_pool_stage_raises(w, field):
    st = tppk.ChainStage(w=w, b=torch.zeros(4), pool=True, **field)
    with pytest.raises(ValueError):
        tppk.fused_conv_chain(torch.zeros(1, 4, 4, 16), [st],
                              [torch.zeros(1, 4, 4, 4)])


def test_bad_pool_src_raises():
    st = tppk.ChainStage(w=torch.from_numpy(_SEL), b=torch.zeros(4), pool=True,
                         pool_src=torch.zeros(4, 8, dtype=torch.int32))
    with pytest.raises(ValueError):
        tppk.fused_conv_chain(torch.zeros(1, 4, 4, 16), [st])


@pytest.mark.parametrize("f_in,c", [(4, 8), (2, 32), (2, 3)])
def test_pool_stage_table_matches_its_stack(f_in, c):
    """The builder's pool stage carries the table of source lanes that the
    kernel reads: the one its selection stack gives, and for each output
    lane (qy*fo + qx)*c + ch the input lanes of packed_max_pool."""
    from robocupvision_tpu_torch.models import packed as tpacked

    st = tpacked._pool_chain_stage(f_in, c, torch.float32, "cpu")
    assert st.pool_src.dtype == torch.int32
    assert torch.equal(st.pool_src, tppk.pool_table(st.w))
    fo = f_in // 2
    x = torch.arange(f_in * f_in * c, dtype=torch.float32).reshape(1, 1, 1, -1)
    want = tpacked.packed_max_pool(x, f_in).reshape(-1)
    assert fo * fo * c == want.numel()
    assert torch.equal(st.pool_src.max(dim=0).values.float(), want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("f_in", [4, 2])
def test_packed_max_pool_matches_jax(dt, f_in):
    from robocupvision_tpu_torch.models import packed as tpacked

    _, tdtype = _DT[dt]
    x_t, x_j = _input(30 + f_in, (2, 5, 7, f_in * f_in * 3), tdtype)
    got = tpacked.packed_max_pool(x_t, f_in)
    want = jpacked.packed_max_pool(x_j, f_in)
    assert got.dtype == tdtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _pool_stage_pair(f_in, c, jdtype, **kw):
    """The JAX builder's pool stage and the port's copy of it."""
    jst = jpacked._pool_chain_stage(f_in, c, jdtype, **kw)
    return jst, _port_stage(jst)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["f4", "f2", "f4_f2"])
def test_pool_chains_match_jax_exactly(dt, case):
    """Pool-only chains (f_in 4 and 2 as stage 0; f_in 2 after an f_in 4
    pool, mid-chain, both emitted) against JAX's chain_reference and
    packed_max_pool, bit for bit."""
    from robocupvision_tpu_torch.models import packed as tpacked

    jdtype, tdtype = _DT[dt]
    f_in = 2 if case == "f2" else 4
    pairs = [_pool_stage_pair(f_in, 3, jdtype, emit=True)]
    if case == "f4_f2":
        pairs.append(_pool_stage_pair(2, 3, jdtype))
    x_t, x_j = _input(40, (2, 6, 5, f_in * f_in * 3), tdtype)
    ref = jppk.chain_reference(x_j, [j for j, _ in pairs])
    got = tppk.fused_conv_chain(x_t, [t for _, t in pairs])
    assert len(got) == len(ref) == len(pairs)
    want = [tpacked.packed_max_pool(x_t, f_in)]
    if case == "f4_f2":
        want.append(tpacked.packed_max_pool(want[0], 2))
    for g, r, w in zip(got, ref, want):
        assert g.dtype == tdtype
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(r.astype(jnp.float32)))
        assert torch.equal(g, w)


def _variant_chains(variant, jdtype):
    """The JAX package's chains of a --UNet (folded stem) or --v2 (folded
    stem, deep chain) graph at QVGA, BN statistics from numpy."""
    kw = dict(pool=True, levels=3, belly_size=0) if variant == "unet" else \
        dict(v2=True, levels=1, belly_size=9, class_size=3, belly_planes=64)
    model = jzoo.make("robo_unet", **kw)
    params = _randomized(model.init(jax.random.PRNGKey(21)), 21)
    return jpacked.build_packed_infer(
        model, params, dtype=jdtype, pallas=True, pallas_interpret=True,
        pallas_fold_stem=True, pallas_deep=variant == "v2").chains


# (variant, chain): input shape and skip widths at a 64x96 input
_VARIANT_CASES = {
    ("unet", "down"): ((2, 64, 96, 3), ()),          # stem_f, pool x2
    ("unet", "up"): ((2, 16, 24, 32), (64, 128)),
    ("v2", "deep"): ((2, 4, 6, 64), ()),             # 9 stages
    ("v2", "up"): ((2, 16, 24, 64), (64, 128)),      # 3x3 skip_w, 3x3 head
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("variant,which,head", [
    ("unet", "down", False), ("unet", "up", True), ("v2", "deep", False),
    ("v2", "up", False), ("v2", "up", True)])
def test_chain_reference_matches_jax_variants(dt, variant, which, head):
    """The --UNet and --v2 chains as the JAX package builds them, on the
    CPU path against its chain_reference."""
    jdtype, tdtype = _DT[dt]
    stages = _variant_chains(variant, jdtype)[which]
    if head:
        stages = jppk.with_argmax_head(stages, 16)
    shape, skip_c = _VARIANT_CASES[(variant, which)]
    x_t, x_j = _input(22, shape, tdtype)
    skips = [_input(23 + i, shape[:3] + (c,), tdtype)
             for i, c in enumerate(skip_c)]
    ref = jppk.chain_reference(x_j, stages, skips=[s[1] for s in skips])
    got = tppk.fused_conv_chain(x_t, [_port_stage(s) for s in stages],
                                skips=[s[0] for s in skips])
    _assert_outputs_match(got, ref, dt, tdtype)


def test_stage_cap_holds_the_longest_chain():
    """RCV_MAX_STAGES in conv_chain.cu equals the wrapper's _MAX_STAGES and
    holds every chain build_packed_infer builds: the --v2 deep chain's 9
    stages, the --UNet folded-stem down chain's 8."""
    import pathlib
    import re

    from robocupvision_tpu_torch.models import packed as tpacked
    from robocupvision_tpu_torch.models import zoo as tzoo

    src = (pathlib.Path(tppk.__file__).parents[1] / "csrc" / "conv_chain.cu"
           ).read_text()
    cap = int(re.search(r"#define RCV_MAX_STAGES (\d+)", src).group(1))
    assert cap == tppk._MAX_STAGES
    longest = 0
    for kw, extra in ((dict(no_scale=True, v2=True, levels=1, belly_size=9,
                            class_size=3, belly_planes=64),
                       dict(pallas_fold_stem=True, pallas_deep=True)),
                      (dict(no_scale=True, pool=True, levels=3, belly_size=0),
                       dict(pallas_fold_stem=True)),
                      (dict(no_scale=True), dict(pallas_fold_stem=True,
                                                 pallas_deep=True))):
        model = tzoo.make("robo_unet", device="cpu", **kw)
        ch = tpacked.build_packed_infer(model, None, torch.float32, pallas=True,
                                        device="cpu", **extra).chains
        longest = max([longest] + [len(v) for v in ch.values()
                                   if isinstance(v, list)])
    assert longest == 9 and cap >= longest


@pytest.mark.parametrize("struct,mirror", [("RcvStage", "_Stage"),
                                           ("RcvChain", "_Chain")])
def test_descriptor_mirror_matches_the_kernel(struct, mirror):
    """The ctypes mirror names the C struct's fields in the C order, and
    the whole descriptor (the kernel's parameter block) stays well under
    the 4 KB a kernel may take."""
    import ctypes
    import pathlib
    import re

    src = (pathlib.Path(tppk.__file__).parents[1] / "csrc" / "conv_chain.cu"
           ).read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    names = []
    for line in body.split("\n"):
        decl = line.split("//")[0].strip()
        if decl:
            decl = re.sub(r"\[[^]]*\]", "", decl.rstrip(";"))
            names += [v.strip().split()[-1].lstrip("*")
                      for v in decl.split(",")]
    assert names == [f[0] for f in getattr(tppk, mirror)._fields_]
    assert ctypes.sizeof(tppk._Chain) <= 2304


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
