"""K3 ``fused_conv3x3_block``'s plain version against the JAX package's
Pallas kernel (interpret mode), at the JAX test's shapes and bound
(rtol = atol = 1e-4, tests/test_pallas_kernels.py), and the wrapper's
refusals. The CUDA kernel itself is held against the plain version on the
card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from robocupvision_tpu.ops.pallas_kernels import fused_conv3x3_block as jblock
from robocupvision_tpu_torch.ops.cuda_kernels import (
    fused_conv3x3_block, fused_conv3x3_block_plain)


def _inputs(seed, h=16, w=24, c=8, co=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, h, w, c)).astype(np.float32),
            (rng.standard_normal((3, 3, c, co)) * 0.2).astype(np.float32),
            rng.standard_normal(co).astype(np.float32),
            (rng.random(co) + 0.5).astype(np.float32),
            rng.standard_normal(co).astype(np.float32))


@pytest.mark.parametrize("relu_before_bn", [True, False])
@pytest.mark.parametrize("tile", [8, 4])
def test_plain_matches_jax_kernel(relu_before_bn, tile):
    arrs = _inputs(2)
    want = jblock(*(jnp.asarray(a) for a in arrs), tile=tile, interpret=True,
                  relu_before_bn=relu_before_bn)
    got = fused_conv3x3_block(*(torch.from_numpy(a) for a in arrs),
                              relu_before_bn=relu_before_bn, tile=tile)
    assert got.shape == (1, 16, 24, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_plain_matches_jax_kernel_bf16():
    """bf16 input: the weights are rounded to bf16 and the output stored
    at bf16 on both sides; within two bf16 ulps of the JAX kernel."""
    arrs = _inputs(3)
    x = jnp.asarray(arrs[0], jnp.bfloat16)
    want = np.asarray(jblock(x, *(jnp.asarray(a) for a in arrs[1:]),
                             interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(arrs[0]).to(torch.bfloat16)
    got = fused_conv3x3_block_plain(
        xt, *(torch.from_numpy(a) for a in arrs[1:]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=2 * 2.0 ** -8, atol=1e-6)


def test_border_is_zero_padding():
    """A constant image: border pixels see fewer taps than inner ones."""
    x = torch.ones((1, 8, 8, 1))
    w = torch.ones((3, 3, 1, 1))
    z = torch.zeros(1)
    y = fused_conv3x3_block(x, w, z, torch.ones(1), z)[0, ..., 0]
    assert float(y[0, 0]) == 4.0 and float(y[0, 3]) == 6.0
    assert float(y[3, 3]) == 9.0


@pytest.mark.parametrize("case", ["batch2", "tile", "tile0", "w_shape",
                                  "b_shape", "rank"])
def test_refusals_raise_value_error(case):
    x, w, b, sc, sh = (torch.from_numpy(a) for a in _inputs(4))
    kw = {}
    if case == "batch2":
        x = torch.cat([x, x])
    elif case == "tile":
        kw["tile"] = 5
    elif case == "tile0":
        kw["tile"] = 0
    elif case == "w_shape":
        w = w[:, :, :4]
    elif case == "b_shape":
        b = b[:3]
    elif case == "rank":
        x = x[0]
    with pytest.raises(ValueError):
        fused_conv3x3_block(x, w, b, sc, sh, **kw)
