"""The port's fused conv chain (robocupvision_tpu_torch.ops.cuda_packed)
against the JAX package's ``chain_reference`` on the flagship's own down
and up stages, taken from the JAX ``build_packed_infer(pallas=True)``
chains at QVGA (packed grid 30x40).

Tolerances: f32 at rtol = atol = 2e-4 (conv reassociation); bf16 per
element at two bf16 ulps of the reference plus 2**-8 of its largest
magnitude (``bf16_tolerance``), because both sides round every stage to
bf16 and a sum that lands on the other side of a rounding boundary moves by
one bf16 ulp, which the later stages carry. Labels: f32 equal, bf16 >= 0.999 agreement. The K2 kernel is
held against ``chain_reference`` on the card in
tests/test_torch_cuda_kernels.py."""

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
                           emit=st.emit, argmax_groups=st.argmax_groups)


def _input(seed, shape, tdtype):
    """Chain-dtype values shared by both sides (bf16 rounded once, RNE)."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                         .astype(np.float32)).to(tdtype)
    return x, jnp.asarray(x.float().numpy()).astype(_jdt(tdtype))


def _jdt(tdtype):
    return jnp.bfloat16 if tdtype == torch.bfloat16 else jnp.float32


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


@pytest.mark.parametrize("field", [dict(stem_f=4), dict(dil=2),
                                   dict(relu_only=True), dict(pool=True),
                                   dict(x_scale=0.1),
                                   dict(skip_w=torch.zeros(1, 1, 4, 4))])
def test_unported_stage_features_raise(field):
    st = tppk.ChainStage(w=torch.zeros(3, 3, 4, 4), b=torch.zeros(4), **field)
    with pytest.raises(NotImplementedError):
        tppk.fused_conv_chain(torch.zeros(1, 4, 4, 4), [st])
