"""The port's experimental separable-conv blocks
(robocupvision_tpu_torch/models/experimental.py) against the JAX package's,
on the CPU: ConvSep at stride 1 (dilated) and 2 and trConvSep, in eval and
train mode (the new BN running statistics too), on the same seeded params
carried through export/torch_io.py. The registries compare equal, spec for
spec. Outputs within rtol = atol = 1e-5 (f32)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from robocupvision_tpu.models import experimental as jex
from robocupvision_tpu.models import layers as jL
from robocupvision_tpu_torch.export import torch_io
from robocupvision_tpu_torch.models import experimental as tex
from robocupvision_tpu_torch.models import layers as tL


def _registries(block):
    jr, tr = jL.Registry(), tL.Registry()
    if block == "conv_sep":
        jex.conv_sep_def(jr, "", 6, 8, 3)
        tex.conv_sep_def(tr, "", 6, 8, 3)
    else:
        jex.tr_conv_sep_def(jr, "blk", 6, 8)
        tex.tr_conv_sep_def(tr, "blk", 6, 8)
    return jr, tr


def _params(reg, seed):
    """Seeded JAX-layout params: kernels and BN affines from a normal, the
    running variances positive."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in reg.specs.items():
        a = rng.standard_normal(spec.shape).astype(np.float32) * 0.5
        if spec.kind == "bn_rv":
            a = (0.5 + rng.random(spec.shape)).astype(np.float32)
        out[name] = a
    return out


@pytest.mark.parametrize("block", ["conv_sep", "tr_conv_sep"])
def test_registries_match_jax(block):
    jr, tr = _registries(block)
    assert [(s.name, s.shape, s.kind) for s in jr.specs.values()] == \
        [(s.name, s.shape, s.kind) for s in tr.specs.values()]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("block,stride", [("conv_sep", 1), ("conv_sep", 2),
                                          ("tr_conv_sep", 2)])
def test_blocks_match_jax(block, stride, train):
    jr, tr = _registries(block)
    jp = _params(jr, seed=stride + 3 * train)
    tp = torch_io.from_jax_params(tr, jp)
    x = np.random.default_rng(7).standard_normal((2, 12, 16, 6)).astype(
        np.float32)
    jmut = {}
    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    if block == "conv_sep":
        want = jex.conv_sep(jparams, jmut, "", jnp.asarray(x), 3, stride,
                            train=train)
    else:
        want = jex.tr_conv_sep(jparams, jmut, "blk", jnp.asarray(x),
                               train=train)

    def run():
        if block == "conv_sep":
            return tex.conv_sep(tp, "", torch.from_numpy(x), 3, stride)
        return tex.tr_conv_sep(tp, "blk", torch.from_numpy(x))

    if train:
        with tL.train_mode() as tmut:
            got = run()
        assert set(tmut) == set(jmut)
        for k in jmut:
            np.testing.assert_allclose(tmut[k].numpy(), np.asarray(jmut[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    else:
        got = run()
        assert not jmut
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
