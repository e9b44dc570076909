"""Dense optical flow and label warping (the JAX package's ops/optflow.py;
reference transform.py:185-198).

The reference uses cv2's Farneback flow (a) to warp predictions along a
sequence for chained label-propagation scoring (test.py:132-146) and (b)
as the classical baseline the LP net is compared against
(validLabelProp.py:108-114).

Two implementations:
- ``optflow_cv2`` / ``update_labels_cv2``: the reference's cv2 calls with
  its parameters (host, evaluation only).
- ``optflow_torch``: the JAX package's Farneback (``optflow_jax``) in plain
  PyTorch: polynomial expansion by separable filtering, then per-pixel 2x2
  solves over a two-level pyramid, on the inputs' device.
  ``warp_labels_torch`` is its nearest-neighbour gather warp.

The pieces run on stacks where the JAX package runs one map at a time
(both frames' expansions at once, the six box-filtered fields of an update
at once), with the JAX package's arithmetic on each map.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

try:
    import cv2  # type: ignore
except ImportError:  # pragma: no cover
    cv2 = None

FARNEBACK_PARAMS = dict(pyr_scale=0.5, levels=2, winsize=15, iterations=2,
                        poly_n=7, poly_sigma=1.5, flags=0)


def _need_cv2() -> None:
    if cv2 is None:
        raise ImportError("cv2 (OpenCV) is not installed: optflow_cv2 and "
                          "update_labels_cv2 need it; optflow_torch and "
                          "warp_labels_torch do not")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def optflow_cv2(img_prev, img_next) -> np.ndarray:
    """(2, H, W) flow, channel 0 = x displacement (reference optFlow)."""
    _need_cv2()
    flow = cv2.calcOpticalFlowFarneback(_host(img_prev), _host(img_next),
                                        None, **FARNEBACK_PARAMS)
    return flow.transpose(2, 0, 1)


def update_labels_cv2(old_lab, flow) -> np.ndarray:
    """Warp a label map along flow, nearest, 0-fill (reference
    updateLabels)."""
    _need_cv2()
    old = _host(old_lab)
    flow = _host(flow)
    idx = np.indices(old.shape)
    x = (idx[1] + flow[0]).astype("float32")
    y = (idx[0] + flow[1]).astype("float32")
    ans = cv2.remap(old.astype("float32"), x, y, cv2.INTER_NEAREST,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    return ans.astype("int64")


# ---------------------------------------------------------------------------
# Farneback in PyTorch
# ---------------------------------------------------------------------------


def _gaussian_kernel(n: int, sigma: float) -> torch.Tensor:
    x = torch.arange(-n, n + 1, dtype=torch.float32)
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / torch.sum(g)


def _sep_filter(img: torch.Tensor, kx: torch.Tensor,
                ky: torch.Tensor) -> torch.Tensor:
    """Separable 2-D correlation with replicate borders on (..., H, W):
    the height pass, then the width pass, each over the valid span of the
    edge-padded map (F.conv2d correlates: the taps are not flipped)."""
    nx = (kx.shape[0] - 1) // 2
    ny = (ky.shape[0] - 1) // 2
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    p = F.pad(img.reshape(-1, 1, h, w), (nx, nx, ny, ny), mode="replicate")
    out = F.conv2d(p, ky.reshape(1, 1, -1, 1))
    out = F.conv2d(out, kx.reshape(1, 1, 1, -1))
    return out.reshape(*lead, h, w)


@functools.lru_cache(maxsize=None)
def _moments(n: int, sigma: float,
             device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g0, g1, g2) the 1-D moment kernels (3, 2n + 1) and the inverse of
    the basis' Gram matrix (6, 6), float32, computed on the host and kept
    on ``device``: the card and the CPU expand with the same inverse."""
    x = torch.arange(-n, n + 1, dtype=torch.float32)
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g0, g1, g2 = g, g * x, g * x * x
    s0, s2, s4 = torch.sum(g0), torch.sum(g2), torch.sum(g2 * x * x)
    z = torch.zeros(())
    G = torch.stack([
        torch.stack([s0 * s0, z, z, s2 * s0, s0 * s2, z]),
        torch.stack([z, s2 * s0, z, z, z, z]),
        torch.stack([z, z, s0 * s2, z, z, z]),
        torch.stack([s2 * s0, z, z, s4 * s0, s2 * s2, z]),
        torch.stack([s0 * s2, z, z, s2 * s2, s0 * s4, z]),
        torch.stack([z, z, z, z, z, s2 * s2]),
    ])
    return (torch.stack([g0, g1, g2]).to(device),
            torch.linalg.inv(G).to(device))


def _poly_expansion(img: torch.Tensor, n: int = 3, sigma: float = 1.5):
    """Farneback quadratic expansion f ~ x^T A x + b^T x + c per pixel of
    (..., H, W) maps -> A (..., H, W, 2, 2), b (..., H, W, 2), c.

    Weighted least squares against the basis {1, x, y, x^2, y^2, xy} with a
    Gaussian applicability, solved in closed form via the separable-moment
    trick (all terms are separable correlations)."""
    (g0, g1, g2), ginv = _moments(n, float(sigma), img.device)
    pairs = ((g0, g0), (g1, g0), (g0, g1), (g2, g0), (g0, g2), (g1, g1))
    # x, y moments: m00, m10, m01, m20, m02, m11
    m = torch.stack([_sep_filter(img, kx, ky) for kx, ky in pairs], dim=-1)
    coef = torch.einsum("ij,...j->...i", ginv, m)  # c, bx, by, axx, ayy, axy
    c, bx, by, axx, ayy, axy = coef.unbind(-1)
    A = torch.stack([torch.stack([axx, axy / 2], -1),
                     torch.stack([axy / 2, ayy], -1)], -2)
    b = torch.stack([bx, by], -1)
    return A, b, c


def _flow_update(A1, b1, A2, b2, flow, winsize: int = 15) -> torch.Tensor:
    """One Farneback displacement update from two expansions + prior flow
    (all (H, W, ...)): field 2 sampled bilinearly at x + flow, the normal
    equations summed over a box window, each pixel's 2x2 system solved."""
    h, w = b1.shape[:2]
    dev = b1.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    fx, fy = flow[..., 0], flow[..., 1]
    sx = torch.clamp(xx + fx, 0, w - 1)
    sy = torch.clamp(yy + fy, 0, h - 1)
    x0 = torch.floor(sx).to(torch.int32)
    y0 = torch.floor(sy).to(torch.int32)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    wx = (sx - x0)[..., None]
    wy = (sy - y0)[..., None]
    # A2 and b2 sampled together from one flattened (H * W, 6) field
    f = torch.cat([A2.reshape(h * w, 4), b2.reshape(h * w, 2)], dim=-1)
    f00 = f[(y0 * w + x0).long()]
    f01 = f[(y0 * w + x1).long()]
    f10 = f[(y1 * w + x0).long()]
    f11 = f[(y1 * w + x1).long()]
    s = (f00 * (1 - wx) * (1 - wy) + f01 * wx * (1 - wy)
         + f10 * (1 - wx) * wy + f11 * wx * wy)
    A2w = s[..., :4].reshape(h, w, 2, 2)
    b2w = s[..., 4:]

    A = 0.5 * (A1 + A2w)
    db = -0.5 * (b2w - b1) + torch.einsum("hwij,hwj->hwi", A, flow)

    # G = A^T A and h = A^T db summed over a box window, then solved
    G = torch.einsum("hwki,hwkj->hwij", A, A).reshape(h, w, 4)
    rhs = torch.einsum("hwki,hwk->hwi", A, db)
    box = torch.ones((winsize,), dtype=torch.float32, device=dev)
    filt = _sep_filter(torch.cat([G, rhs], -1).permute(2, 0, 1), box, box)
    g11, g12, g21, g22, h0, h1 = filt.unbind(0)
    det = g11 * g22 - g12 * g21
    det = torch.where(torch.abs(det) < 1e-9,
                      torch.full_like(det, 1e-9), det)
    u = (g22 * h0 - g12 * h1) / det
    v = (-g21 * h0 + g11 * h1) / det
    return torch.stack([u, v], -1)


def _resize_bilinear(img: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(H, W, C) -> (h, w, C) linear resize over H and W, antialiased
    when it shrinks (jax.image.resize's "linear")."""
    x = img.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=hw, mode="bilinear", align_corners=False,
                        antialias=True)
    return out[0].permute(1, 2, 0)


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    """f32 convolutions and matmuls on the card (no TF32) inside the block,
    whatever the caller has set: a TF32 filter keeps 10 mantissa bits,
    and the 2x2 solves amplify that error where a system is near
    singular."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def optflow_torch(img_prev, img_next, levels: int = 2, iterations: int = 2,
                  winsize: int = 15, poly_n: int = 3,
                  poly_sigma: float = 1.5) -> torch.Tensor:
    """Farneback flow mapping prev -> next: (H, W, 2) float32 on the
    inputs' device ((H, W) tensors, or arrays, which run on the CPU), in
    f32 throughout (no TF32 on the card).

    Same algorithm family as cv2's (pyramidal polynomial-expansion flow);
    its constants differ slightly, so outputs are comparable, not equal.
    An integer image is scaled by 1/255."""
    with _no_tf32():
        return _optflow(img_prev, img_next, levels, iterations, winsize,
                        poly_n, poly_sigma)


def _optflow(img_prev, img_next, levels, iterations, winsize, poly_n,
             poly_sigma) -> torch.Tensor:
    a = torch.as_tensor(img_prev)
    b = torch.as_tensor(img_next, device=a.device)
    scale_in = 1.0 if a.is_floating_point() else 255.0
    ab = torch.stack([a, b]).to(torch.float32) / scale_in
    h, w = a.shape

    flow = None
    for lev in reversed(range(levels)):
        scale = 2 ** lev
        hw = (max(h // scale, 8), max(w // scale, 8))
        abl = _resize_bilinear(ab.permute(1, 2, 0), hw).permute(2, 0, 1)
        if flow is None:
            flow = torch.zeros(hw + (2,), dtype=torch.float32, device=a.device)
        else:
            flow = _resize_bilinear(flow, hw) * 2.0
        (A1, A2), (b1, b2), _ = _poly_expansion(abl, poly_n, poly_sigma)
        for _ in range(iterations):
            flow = _flow_update(A1, b1, A2, b2, flow,
                                winsize=max(winsize // scale, 5))
    return flow


def warp_labels_torch(old_lab, flow) -> torch.Tensor:
    """Nearest-neighbour label warp: out[y, x] = old[y + v, x + u] (halves
    rounded to even), 0 outside; on the label map's device, in its dtype."""
    old = torch.as_tensor(old_lab)
    flow = torch.as_tensor(flow, device=old.device)
    h, w = old.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.int32, device=old.device),
                            torch.arange(w, dtype=torch.int32, device=old.device),
                            indexing="ij")
    sx = torch.round(xx + flow[..., 0]).to(torch.int32)
    sy = torch.round(yy + flow[..., 1]).to(torch.int32)
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    sx = torch.clamp(sx, 0, w - 1)
    sy = torch.clamp(sy, 0, h - 1)
    return torch.where(valid, old[sy.long(), sx.long()],
                       torch.zeros((), dtype=old.dtype, device=old.device))
