"""The port's optical flow (robocupvision_tpu_torch.ops.optflow) against the
JAX package's ops/optflow.py on the CPU: the Farneback's pieces
(``_resize_bilinear`` at the pyramid's shapes within 1e-6,
``_sep_filter`` and ``_poly_expansion`` within 1e-5 of the largest
magnitude), ``optflow_torch`` against ``optflow_jax`` (median endpoint
difference <= 1e-4 px, and <= 1e-3 px wherever the JAX flow's last 2x2
system has |det| above 1e-3 of its median), ``warp_labels_torch`` equal
to ``warp_labels_jax`` on the same flow, and the cv2 pair equal to the
JAX package's. Then tests/test_objmetrics_optflow.py's flow checks for
the port (shift recovery, the pure-shift warp, the envelope against cv2
and discontinuous motion), held to the JAX module. The JAX flows of the
affine scenes are computed once per module."""


import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp
from scipy.signal import convolve2d

from robocupvision_tpu.ops import optflow as joptflow
from robocupvision_tpu_torch.ops import optflow

# tests/test_objmetrics_optflow.py:147-148
MOTIONS = [(3, 1, 0.0), (-2, 2, 0.0), (1, -1, 1.5), (5, 0, 0.0)]
INNER = (slice(16, -16), slice(16, -16))


def _shifted_pair(h=60, w=80, dx=3, dy=1):
    rng = np.random.default_rng(0)
    base = convolve2d(rng.random((h + 20, w + 20)).astype(np.float32),
                      np.ones((5, 5)) / 25, mode="same")
    a = (base[10:10 + h, 10:10 + w] * 255).astype(np.uint8)
    b = (base[10 - dy:10 - dy + h, 10 - dx:10 - dx + w] * 255).astype(np.uint8)
    return a, b


def _rc_scene(h=120, w=160, seed=0):
    """tests/test_objmetrics_optflow.py's frame: smoothed texture, a ball
    disc, a robot box and a field line, with its label map."""
    rng = np.random.default_rng(seed)
    img = convolve2d(rng.random((h + 20, w + 20)), np.ones((7, 7)) / 49,
                     mode="same")[10:10 + h, 10:10 + w]
    yy, xx = np.mgrid[0:h, 0:w]
    ball = (yy - 40) ** 2 + (xx - 60) ** 2 < 64
    img[ball] = 1.0
    img[70:100, 100:115] = 0.15
    img[:, 30:32] = 0.9
    lab = np.zeros((h, w), np.int32)
    lab[ball] = 1
    lab[70:100, 100:115] = 2
    lab[:, 30:32] = 4
    return (img * 255).astype(np.uint8), lab


def _affine_pair(seed, dx, dy, ang, size=(120, 160)):
    img, lab = _rc_scene(*size, seed=seed)
    h, w = img.shape
    m = cv2.getRotationMatrix2D((w / 2, h / 2), ang, 1.0)
    m[0, 2] += dx
    m[1, 2] += dy
    img2 = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REPLICATE)
    return img, img2, lab


@jax.jit
def _jax_last_det(img_prev, img_next):
    """det of the 2x2 systems of optflow_jax's last update (its defaults),
    recomputed from the JAX package's helpers."""
    a = jnp.asarray(img_prev, jnp.float32) / 255.0
    b = jnp.asarray(img_next, jnp.float32) / 255.0
    h, w = a.shape
    flow = None
    for lev in (1, 0):
        hw = (max(h // 2 ** lev, 8), max(w // 2 ** lev, 8))
        al = joptflow._resize_bilinear(a[..., None], hw)[..., 0]
        bl = joptflow._resize_bilinear(b[..., None], hw)[..., 0]
        flow = jnp.zeros(hw + (2,), jnp.float32) if flow is None \
            else joptflow._resize_bilinear(flow, hw) * 2.0
        A1, b1, _ = joptflow._poly_expansion(al, 3, 1.5)
        A2, b2, _ = joptflow._poly_expansion(bl, 3, 1.5)
        win = max(15 // 2 ** lev, 5)
        for it in range(2):
            if lev == 0 and it == 1:
                break
            flow = joptflow._flow_update(A1, b1, A2, b2, flow, winsize=win)
    # the last update's sample and normal equations (ops/optflow.py:128-172)
    yy, xx = jnp.mgrid[0:h, 0:w].astype(jnp.float32)
    sx = jnp.clip(xx + flow[..., 0], 0, w - 1)
    sy = jnp.clip(yy + flow[..., 1], 0, h - 1)
    x0, y0 = jnp.floor(sx).astype(jnp.int32), jnp.floor(sy).astype(jnp.int32)
    x1, y1 = jnp.minimum(x0 + 1, w - 1), jnp.minimum(y0 + 1, h - 1)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    f = A2.reshape(h, w, 4)
    A2w = (f[y0, x0] * (1 - wx) * (1 - wy) + f[y0, x1] * wx * (1 - wy)
           + f[y1, x0] * (1 - wx) * wy + f[y1, x1] * wx * wy)
    A = 0.5 * (A1 + A2w.reshape(h, w, 2, 2))
    G = jnp.einsum("hwki,hwkj->hwij", A, A).reshape(h, w, 4)
    box = jnp.ones((15,), jnp.float32)
    g = [joptflow._sep_filter(G[..., i], box, box) for i in range(4)]
    return g[0] * g[3] - g[1] * g[2]


@pytest.fixture(scope="module")
def affine():
    """The four affine scenes at 120x160 and one at 48x64 with the JAX
    package's flows (and their last |det|) and the cv2 flows."""
    out = []
    for seed, motion in enumerate(MOTIONS):
        out.append(_affine_pair(seed, *motion))
    out.append(_affine_pair(0, *MOTIONS[2], size=(48, 64)))
    res = []
    for img, img2, lab in out:
        res.append(dict(img=img, img2=img2, lab=lab,
                        jax=np.array(joptflow.optflow_jax(img, img2)),
                        det=np.abs(np.asarray(_jax_last_det(img, img2))),
                        cv2=optflow.optflow_cv2(img, img2)))
    return res


# ---------------------------------------------------------------------------
# the Farneback's pieces against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,hw", [((120, 160), (60, 80)),
                                      ((240, 320), (120, 160)),
                                      ((48, 64), (24, 32)),
                                      ((15, 20), (8, 10)),
                                      ((9, 11), (8, 8)),
                                      ((60, 80), (120, 160)),
                                      ((48, 64), (48, 64))])
def test_resize_bilinear_matches_jax(shape, hw):
    """The pyramid's shrinks (antialiased), its flow upsampling (two
    channels) and the identity; within 1e-6."""
    x = np.random.default_rng(shape[0]).random(shape + (2,)).astype(np.float32)
    want = np.asarray(joptflow._resize_bilinear(jnp.asarray(x), hw))
    got = optflow._resize_bilinear(torch.from_numpy(x), hw).numpy()
    assert got.shape == want.shape == hw + (2,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("nx,ny", [(3, 3), (7, 2), (15, 15)])
def test_sep_filter_matches_jax(nx, ny):
    """Replicate borders, height pass then width pass, taps not flipped
    (asymmetric kernels); within 1e-5 of the largest magnitude."""
    rng = np.random.default_rng(nx)
    img = rng.random((30, 41)).astype(np.float32)
    kx = rng.standard_normal(2 * nx + 1).astype(np.float32)
    ky = rng.standard_normal(2 * ny + 1).astype(np.float32)
    want = np.asarray(joptflow._sep_filter(jnp.asarray(img), jnp.asarray(kx),
                                           jnp.asarray(ky)))
    got = optflow._sep_filter(torch.from_numpy(img), torch.from_numpy(kx),
                              torch.from_numpy(ky)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # a stack filters map by map
    stack = optflow._sep_filter(torch.from_numpy(np.stack([img, img[::-1]])),
                                torch.from_numpy(kx), torch.from_numpy(ky))
    np.testing.assert_allclose(stack[0].numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,sigma", [(3, 1.5), (5, 1.1)])
def test_poly_expansion_matches_jax(n, sigma):
    """A, b and c within 1e-5 of their largest magnitude; the Gaussian
    kernel equal within 1e-7."""
    img = np.random.default_rng(n).random((48, 64)).astype(np.float32)
    want = joptflow._poly_expansion(jnp.asarray(img), n, sigma)
    got = optflow._poly_expansion(torch.from_numpy(img), n, sigma)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    np.testing.assert_allclose(optflow._gaussian_kernel(n, sigma).numpy(),
                               np.asarray(joptflow._gaussian_kernel(n, sigma)),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("case", range(len(MOTIONS) + 1))
def test_optflow_torch_matches_jax(affine, case):
    """The four affine scenes at 120x160 and one at 48x64: the median
    endpoint difference <= 1e-4 px, and <= 1e-3 px at every pixel whose
    last 2x2 system (in the JAX run) has |det| above 1e-3 of its median."""
    c = affine[case]
    got = optflow.optflow_torch(c["img"], c["img2"])
    assert got.dtype == torch.float32 and got.shape == c["img"].shape + (2,)
    epe = np.hypot(*(got.numpy() - c["jax"]).transpose(2, 0, 1))
    assert np.median(epe) <= 1e-4, np.median(epe)
    solid = c["det"] > 1e-3 * np.median(c["det"])
    assert solid.mean() > 0.9
    assert epe[solid].max() <= 1e-3, epe[solid].max()


def test_optflow_torch_scales_integer_images():
    """uint8 frames are divided by 255; the same frames as floats in [0, 1]
    and as tensors give the same flow."""
    a, b = _shifted_pair(48, 64)
    u8 = optflow.optflow_torch(a, b)
    f32 = optflow.optflow_torch(torch.from_numpy(a).float() / 255.0,
                                torch.from_numpy(b).float() / 255.0)
    np.testing.assert_array_equal(u8.numpy(), f32.numpy())
    np.testing.assert_array_equal(
        optflow.optflow_torch(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        u8.numpy())


def _flows(kind, h, w, rng):
    if kind == "random":
        return rng.normal(0, 3, (h, w, 2)).astype(np.float32)
    if kind == "halves":  # exact .5 offsets: round half to even
        return (rng.integers(-6, 7, (h, w, 2)) + 0.5).astype(np.float32)
    # off the frame on every side
    f = rng.normal(0, 1, (h, w, 2)).astype(np.float32)
    f[: h // 2, :, 0] -= w
    f[h // 2:, :, 1] += h
    f[:, : w // 3, 1] -= 2 * h
    return f


@pytest.mark.parametrize("kind", ["random", "halves", "off_frame"])
@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
def test_warp_labels_torch_equals_jax(kind, dtype):
    rng = np.random.default_rng(len(kind))
    h, w = 30, 41
    lab = rng.integers(0, 5, (h, w)).astype(dtype)
    flow = _flows(kind, h, w, rng)
    want = np.asarray(joptflow.warp_labels_jax(jnp.asarray(lab),
                                               jnp.asarray(flow)))
    got = optflow.warp_labels_torch(torch.from_numpy(lab), flow)
    assert got.dtype == torch.from_numpy(lab).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "off_frame":
        assert (got.numpy() == 0).mean() > 0.5


def test_cv2_pair_equals_jax():
    """optflow_cv2 and update_labels_cv2 give the JAX package's arrays
    bit for bit, from arrays and from tensors."""
    a, b = _shifted_pair(48, 64)
    flow = optflow.optflow_cv2(a, b)
    want = joptflow.optflow_cv2(a, b)
    assert flow.dtype == want.dtype and flow.shape == (2, 48, 64)
    np.testing.assert_array_equal(flow, want)
    np.testing.assert_array_equal(
        optflow.optflow_cv2(torch.from_numpy(a), torch.from_numpy(b)), want)
    lab = np.random.default_rng(2).integers(0, 5, (48, 64))
    got = optflow.update_labels_cv2(lab, flow)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, joptflow.update_labels_cv2(lab, flow))
    np.testing.assert_array_equal(
        optflow.update_labels_cv2(torch.from_numpy(lab), torch.from_numpy(flow)),
        got)


def test_cv2_missing_raises_import_error(monkeypatch):
    monkeypatch.setattr(optflow, "cv2", None)
    a, b = _shifted_pair(16, 16)
    with pytest.raises(ImportError, match="cv2"):
        optflow.optflow_cv2(a, b)
    with pytest.raises(ImportError, match="cv2"):
        optflow.update_labels_cv2(a, np.zeros((2, 16, 16), np.float32))


# ---------------------------------------------------------------------------
# tests/test_objmetrics_optflow.py's flow checks, for the port
# ---------------------------------------------------------------------------


def test_optflow_cv2_recovers_shift():
    a, b = _shifted_pair(dx=3, dy=1)
    flow = optflow.optflow_cv2(a, b)
    inner = (slice(20, -20), slice(20, -20))
    assert abs(np.median(flow[0][inner]) - 3) < 0.7
    assert abs(np.median(flow[1][inner]) - 1) < 0.7


def test_update_labels_cv2_matches_jax():
    rng = np.random.default_rng(1)
    lab = rng.integers(0, 5, (30, 40))
    flow = rng.normal(0, 2, (2, 30, 40)).astype(np.float32)
    np.testing.assert_array_equal(optflow.update_labels_cv2(lab, flow),
                                  joptflow.update_labels_cv2(lab, flow))


def test_optflow_torch_recovers_shift():
    a, b = _shifted_pair(dx=3, dy=1)
    flow = optflow.optflow_torch(a, b).numpy()
    inner = (slice(20, -20), slice(20, -20))
    assert abs(np.median(flow[inner][..., 0]) - 3) < 1.0
    assert abs(np.median(flow[inner][..., 1]) - 1) < 1.0


def test_warp_labels_torch_pure_shift():
    lab = torch.zeros((20, 30), dtype=torch.int32)
    lab[5:10, 5:10] = 2
    flow = torch.zeros((20, 30, 2))
    flow[..., 0] = 4.0  # sample from x+4 -> content moves left by 4
    out = optflow.warp_labels_torch(lab, flow)
    assert (out[5:10, 1:6] == 2).all()
    assert int(out[:, 10:].sum()) == 0


def _warp_agreement(lab, fl_cv, fl_t):
    w_cv = optflow.update_labels_cv2(lab, fl_cv)
    w_t = optflow.warp_labels_torch(torch.from_numpy(lab),
                                    torch.from_numpy(fl_t)).numpy()
    fg = (w_cv[INNER] > 0) | (w_t[INNER] > 0)
    return (float(np.mean(w_cv[INNER] == w_t[INNER])),
            float(np.mean(w_cv[INNER][fg] == w_t[INNER][fg])))


@pytest.mark.parametrize("case", range(len(MOTIONS)))
def test_optflow_torch_agreement_envelope_vs_cv2(affine, case):
    """The JAX package's envelope for its Farneback against cv2's, for the
    port's: median endpoint difference <= 0.2 px, p90 <= 0.5, warped
    labels agreeing >= 0.995 overall and >= 0.99 on the foreground; and
    the port's agreement within 1e-3 of the JAX flow's."""
    c = affine[case]
    fl_t = optflow.optflow_torch(c["img"], c["img2"]).numpy()
    epe = np.hypot(fl_t[..., 0] - c["cv2"][0], fl_t[..., 1] - c["cv2"][1])[INNER]
    assert np.median(epe) <= 0.2, np.median(epe)
    assert np.quantile(epe, 0.9) <= 0.5, np.quantile(epe, 0.9)
    agree, fg_agree = _warp_agreement(c["lab"], c["cv2"], fl_t)
    assert agree >= 0.995 and fg_agree >= 0.99, (agree, fg_agree)
    jagree, jfg = _warp_agreement(c["lab"], c["cv2"], c["jax"])
    assert abs(agree - jagree) <= 1e-3 and abs(fg_agree - jfg) <= 1e-3


def test_optflow_torch_agreement_on_discontinuous_motion():
    """An independently moving ball over a static background."""
    h, w = 120, 160
    rng = np.random.default_rng(5)
    bg = convolve2d(rng.random((h + 20, w + 20)), np.ones((7, 7)) / 49,
                    mode="same")[10:10 + h, 10:10 + w]
    yy, xx = np.mgrid[0:h, 0:w]

    def frame(cx):
        img = bg.copy()
        ball = (yy - 40) ** 2 + (xx - cx) ** 2 < 64
        img[ball] = 1.0
        img[70:100, 100:115] = 0.15
        lab = np.zeros((h, w), np.int32)
        lab[ball] = 1
        lab[70:100, 100:115] = 2
        return (img * 255).astype(np.uint8), lab

    img1, lab1 = frame(60)
    img2, _ = frame(64)
    fl_cv = optflow.optflow_cv2(img1, img2)
    fl_t = optflow.optflow_torch(img1, img2).numpy()
    epe = np.hypot(fl_t[..., 0] - fl_cv[0], fl_t[..., 1] - fl_cv[1])[INNER]
    assert np.quantile(epe, 0.9) <= 0.5, np.quantile(epe, 0.9)
    agree, fg_agree = _warp_agreement(lab1, fl_cv, fl_t)
    assert agree >= 0.995 and fg_agree >= 0.99, (agree, fg_agree)
