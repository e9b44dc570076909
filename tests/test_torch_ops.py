"""The port's ops (robocupvision_tpu_torch.ops) against the JAX package's on
the same numpy inputs, at f32 on the CPU (atol 1e-5: the two frameworks
sum the conv taps in different orders)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from robocupvision_tpu.ops import color as jcolor
from robocupvision_tpu.ops import nn as jnn
from robocupvision_tpu_torch.ops import color as tcolor
from robocupvision_tpu_torch.ops import init as tinit
from robocupvision_tpu_torch.ops import nn as tnn

ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k,stride,padding,dilation", [
    (3, 1, 1, 1), (3, 2, 1, 1), (1, 1, 0, 1), (3, 1, 2, 2)])
def test_conv2d_matches_jax(k, stride, padding, dilation):
    r = _rng(0)
    x = r.standard_normal((2, 12, 10, 5)).astype(np.float32)
    w = r.standard_normal((k, k, 5, 7)).astype(np.float32)  # JAX HWIO
    b = r.standard_normal((7,)).astype(np.float32)
    ref = jnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     stride=stride, padding=padding, dilation=dilation)
    got = tnn.conv2d(_t(x), _t(np.transpose(w, (3, 2, 0, 1))), _t(b),
                     stride=stride, padding=padding, dilation=dilation)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_conv_transpose2d_matches_jax():
    """k3/s2/p1/op1: the JAX kernel is pre-flipped HWIO, torch's is the
    unflipped (in, out, kh, kw) -- the export/torch_io.py layout map."""
    r = _rng(1)
    x = r.standard_normal((2, 6, 7, 4)).astype(np.float32)
    w_torch = r.standard_normal((4, 3, 3, 3)).astype(np.float32)
    b = r.standard_normal((3,)).astype(np.float32)
    w_jax = np.transpose(w_torch[:, :, ::-1, ::-1], (2, 3, 0, 1))
    ref = jnn.conv_transpose2d(jnp.asarray(x), jnp.asarray(w_jax),
                               jnp.asarray(b))
    got = tnn.conv_transpose2d(_t(x), _t(w_torch), _t(b))
    assert got.shape == (2, 12, 14, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_eval_batch_norm_matches_jax():
    r = _rng(2)
    x = r.standard_normal((2, 5, 6, 4)).astype(np.float32)
    g, b, rm = (r.standard_normal((4,)).astype(np.float32) for _ in range(3))
    rv = r.uniform(0.2, 2.0, (4,)).astype(np.float32)
    ref, _, _ = jnn.batch_norm(*(jnp.asarray(a) for a in (x, g, b, rm, rv)),
                               train=False)
    got = tnn.batch_norm(*(_t(a) for a in (x, g, b, rm, rv)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_relu_and_max_pool_match_jax():
    x = _rng(3).standard_normal((2, 8, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(tnn.relu(_t(x)).numpy(),
                                  np.asarray(jnn.relu(jnp.asarray(x))))
    np.testing.assert_array_equal(tnn.max_pool(_t(x), 2, 2).numpy(),
                                  np.asarray(jnn.max_pool(jnp.asarray(x), 2, 2)))


def test_raw_camera_preprocess_matches_jax():
    x = _rng(4).integers(0, 256, (2, 8, 10, 3), dtype=np.uint8)
    ref = jcolor.raw_camera_preprocess(jnp.asarray(x))
    got = tcolor.raw_camera_preprocess(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tcolor.rgb_to_yuv(_t(x.astype(np.float32) / 255)).numpy(),
        np.asarray(jcolor.rgb_to_yuv(jnp.asarray(x.astype(np.float32) / 255))),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["conv", "tconv", "linear"])
def test_init_distributions(kind):
    """Same distributions as the JAX package's ops/init.py (U(-bound, bound)
    with torch's fan_in), in torch layout, reproducible from the generator."""
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        if kind == "conv":
            return tinit.conv_weight(gen, 3, 3, 16, 32), 1 / np.sqrt(16 * 9), (32, 16, 3, 3)
        if kind == "tconv":
            return tinit.tconv_weight(gen, 3, 3, 16, 32), 1 / np.sqrt(32 * 9), (16, 32, 3, 3)
        return tinit.linear_weight(gen, 64, 8), 1 / np.sqrt(64), (8, 64)

    w, bound, shape = draw(5)
    assert tuple(w.shape) == shape
    assert float(w.abs().max()) <= bound
    assert float(w.abs().max()) > 0.9 * bound          # spans the interval
    assert abs(float(w.mean())) < 0.1 * bound
    assert torch.equal(w, draw(5)[0])
    assert not torch.equal(w, draw(6)[0])
