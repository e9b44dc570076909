"""Colour constants, the serving-side camera preprocessing, the
training augmentation of train.py (horizontal flip and YUV jitter), the
legacy pipeline's (flips and an RGB ColorJitter) and the reference's
standalone random enhancers.

rgb2yuv uses skimage.color's BT.601 constants (the legacy pipeline's
ToYUV), and the per-domain normalization constants are the reference's;
both copied from the JAX package's ops/color.py.

Each augmentation is split in two: ``draw_augment`` (``draw_legacy_augment``,
``draw_random_enhance``) draws each sample's values from a
``torch.Generator``, and ``augment_batch`` (``legacy_augment_batch``, the
``random_*`` functions) applies given draws. The JAX package draws from
``jax.random``, whose numbers torch cannot reproduce, so a test hands both
the same draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

# skimage.color.yuv_from_rgb
YUV_FROM_RGB = np.array(
    [[0.299, 0.587, 0.114],
     [-0.14714119, -0.28886916, 0.43601035],
     [0.61497538, -0.51496512, -0.10001026]], np.float32)

RGB_FROM_YUV = np.linalg.inv(YUV_FROM_RGB)

# Per-domain normalization constants (reference dataset.py:74-75)
MEAN_SYNTHETIC = (0.36269532, 0.41144562, 0.282713)
STD_SYNTHETIC = (0.31111388, 0.21010718, 0.34060917)
MEAN_FINETUNE = (0.34190056, 0.4833289, 0.48565758)
STD_FINETUNE = (0.47421749, 0.13846053, 0.1714848)


def rgb_to_yuv(rgb: torch.Tensor) -> torch.Tensor:
    """NHWC (or HWC) RGB in [0, 1] -> YUV, skimage semantics."""
    m = torch.as_tensor(YUV_FROM_RGB, dtype=rgb.dtype, device=rgb.device)
    return torch.einsum("...c,dc->...d", rgb, m)


def normalize(img: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.as_tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def raw_camera_preprocess(x_u8: torch.Tensor, mean=(0.5, 0.0, 0.0),
                          std: float = 0.5) -> torch.Tensor:
    """Raw uint8 RGB frames -> the legacy serving input (/255, ToYUV,
    normalize) as ONE affine: ``x @ (YUV^T / (255*std)) - mean/std``, in
    f32 on the frames' device."""
    a = torch.as_tensor(np.ascontiguousarray(YUV_FROM_RGB.T / (255.0 * std)),
                        dtype=torch.float32, device=x_u8.device)
    c = -torch.as_tensor(mean, dtype=torch.float32, device=x_u8.device) / std
    return torch.einsum("...c,cd->...d", x_u8.float(), a) + c


# the jitter ranges of the reference's dataset.py:19-39
JITTER_B, JITTER_C, JITTER_S, JITTER_H = 0.3, 0.3, 0.3, 3.1415 / 6


def draw_augment(gen: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
    """One batch's draws, on the generator's device: per sample a
    0.5-probability flip (bool) and the jitter's brightness ``b`` in
    [-0.3, 0.3), contrast ``c`` and saturation ``s`` in [0.7, 1.3), hue
    ``h`` in [-pi/6, pi/6), each uniform, as ``augment_sample`` of the JAX
    package draws them."""
    u = torch.rand((5, n), generator=gen, device=gen.device)
    return {"flip": u[0] > 0.5,
            "b": -JITTER_B + 2 * JITTER_B * u[1],
            "c": (1 - JITTER_C) + 2 * JITTER_C * u[2],
            "s": (1 - JITTER_S) + 2 * JITTER_S * u[3],
            "h": -JITTER_H + 2 * JITTER_H * u[4]}


def yuv_color_jitter(img: torch.Tensor, b, c, s, h) -> torch.Tensor:
    """YUV-space jitter (reference dataset.py:19-39) of NHWC images with
    per-sample values (N,): Y -> (Y + b) * c, UV through the rotation-scale
    [[s cos h, -sin h], [sin h, s cos h]]."""
    def col(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=img.device).reshape(-1, 1, 1)

    b, c, s, h = col(b), col(c), col(s), col(h)
    u, v = img[..., 1], img[..., 2]
    y = (img[..., 0] + b) * c
    u2 = s * torch.cos(h) * u + -torch.sin(h) * v
    v2 = torch.sin(h) * u + s * torch.cos(h) * v
    return torch.stack([y, u2, v2], dim=-1).to(img.dtype)


def augment_sample(img: torch.Tensor, label: torch.Tensor,
                   draws: Dict[str, torch.Tensor], jitter: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`augment_batch` of one (H, W, 3) image and its (H, W) label;
    ``draws`` holds one value each (0-d or (1,))."""
    one = {k: torch.as_tensor(v).reshape(1) for k, v in draws.items()}
    i, l = augment_batch(img[None], label[None], one, jitter)
    return i[0], l[0]


def _flip(x: torch.Tensor, where: torch.Tensor, dim: int) -> torch.Tensor:
    """x with the samples where ``where`` (N,) holds mirrored along
    ``dim``."""
    sel = where.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(sel, x.flip(dim), x)


def augment_batch(imgs: torch.Tensor, labels: Optional[torch.Tensor],
                  draws: Dict[str, torch.Tensor], jitter: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Train-time augmentation of an NHWC batch and its (N, H, W) labels
    (None: images only) with the given draws: the flipped samples
    mirrored left-right (image and label), then, with ``jitter``, the YUV
    jitter of every image (reference dataset.py:126-131)."""
    imgs = _flip(imgs, draws["flip"], 2)
    if labels is not None:
        labels = _flip(labels, draws["flip"], 2)
    if jitter:
        imgs = yuv_color_jitter(imgs, draws["b"], draws["c"], draws["s"],
                                draws["h"])
    return imgs, labels


# ---------------------------------------------------------------------------
# The legacy pipeline's augmentation (trainer.py:88-104): HorizontalFlip,
# VerticalFlip and torchvision's ColorJitter(0.5, 0.5, 0.4, 0.3) on the RGB
# image before its YUV conversion. The legacy datasets hold YUV-normalized
# images, so the apply inverts the (linear) normalization and YUV
# transform, jitters in RGB with torchvision's formulas and converts back.
# As in torchvision, each sample applies the four jitter ops in an order
# of its own (ColorJitter.get_params shuffles its op list).
# ---------------------------------------------------------------------------

# ColorJitter(brightness, contrast, saturation, hue) of the legacy stacks
LEGACY_B, LEGACY_C, LEGACY_S, LEGACY_H = 0.5, 0.5, 0.4, 0.3
_GRAY_W = np.array([0.299, 0.587, 0.114], np.float32)  # PIL convert("L")
_LEGACY_MEAN = (0.5, 0.0, 0.0)  # Normalize([.5, 0, 0], [.5, .5, .5])
# K4's constants as the plain code rounds them to f32 (``cuda_kernels
# .legacy_jitter``): RGB_FROM_YUV and YUV_FROM_RGB row-major, the grey weights
LEGACY_JITTER_TABLES = np.concatenate([
    np.asarray(RGB_FROM_YUV, np.float32).ravel(),
    np.asarray(YUV_FROM_RGB, np.float32).ravel(), _GRAY_W])


def draw_legacy_augment(gen: torch.Generator, n: int, use_vflip: bool = True
                        ) -> Dict[str, torch.Tensor]:
    """One batch's legacy draws, on the generator's device, per sample: a
    0.5-probability horizontal flip ``hflip`` and vertical flip ``vflip``
    (always False without ``use_vflip``: classTrainer's stack has none,
    classTrainer.py:55-62), the jitter's brightness ``b`` and contrast
    ``c`` factors in [0.5, 1.5), saturation ``s`` in [0.6, 1.4), hue shift
    ``h`` in [-0.3, 0.3) (turns), and ``order`` (N, 4), the op applied at
    each of the four positions (0 brightness, 1 contrast, 2 saturation,
    3 hue), a uniform permutation."""
    u = torch.rand((6, n), generator=gen, device=gen.device)
    order = torch.argsort(torch.rand((n, 4), generator=gen,
                                     device=gen.device), dim=1)
    return {"hflip": u[0] < 0.5,
            "vflip": (u[1] < 0.5) & use_vflip,
            "b": (1 - LEGACY_B) + 2 * LEGACY_B * u[2],
            "c": (1 - LEGACY_C) + 2 * LEGACY_C * u[3],
            "s": (1 - LEGACY_S) + 2 * LEGACY_S * u[4],
            "h": -LEGACY_H + 2 * LEGACY_H * u[5],
            "order": order}


def _rgb_to_hsv(rgb: torch.Tensor):
    """(..., 3) RGB in [0, 1] -> (h in turns, s, v), colorsys semantics
    (a grey pixel has h = s = 0)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(dim=-1).values
    minc = rgb.min(dim=-1).values
    v = maxc
    rng = maxc - minc
    zero = torch.zeros((), dtype=rgb.dtype, device=rgb.device)
    s = torch.where(maxc > 0, rng / torch.clamp_min(maxc, 1e-12), zero)
    safe = torch.clamp_min(rng, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng > 0, (h / 6.0) % 1.0, zero)
    return h, s, v


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
    """The inverse of :func:`_rgb_to_hsv`: (..., 3) RGB."""
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = (i.to(torch.int64) % 6)[..., None]

    def pick(*vals):
        return torch.stack(vals, dim=-1).gather(-1, sector)[..., 0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def rgb_color_jitter(rgb: torch.Tensor, b, c, s, h, order) -> torch.Tensor:
    """torchvision-style ColorJitter of NHWC RGB images in [0, 1] with
    per-sample values (N,) and op order (N, 4): at each position every
    sample takes its own op of the four (a ``torch.where`` over the four
    results, so the batch runs as one)."""
    def col(t):
        return torch.as_tensor(t, dtype=torch.float32,
                               device=rgb.device).reshape(-1, 1, 1, 1)

    b_f, c_f, s_f, shift = col(b), col(c), col(s), col(h)[..., 0]
    gray_w = torch.as_tensor(_GRAY_W, device=rgb.device)

    def brightness(img):  # img * U(1-b, 1+b)
        return torch.clamp(img * b_f, 0.0, 1.0)

    def contrast(img):  # blend toward the mean of the grayscale image
        mean_gray = (img @ gray_w).mean(dim=(1, 2)).reshape(-1, 1, 1, 1)
        return torch.clamp(c_f * img + (1 - c_f) * mean_gray, 0.0, 1.0)

    def saturation(img):  # blend toward the per-pixel grayscale
        gray = (img @ gray_w)[..., None]
        return torch.clamp(s_f * img + (1 - s_f) * gray, 0.0, 1.0)

    def hue(img):  # shift the HSV hue (torchvision's unit: turns)
        hh, ss, vv = _rgb_to_hsv(img)
        return torch.clamp(_hsv_to_rgb((hh + shift) % 1.0, ss, vv), 0.0, 1.0)

    order = torch.as_tensor(order, device=rgb.device).reshape(-1, 1, 1, 1, 4)
    img = rgb.float()
    for i in range(4):
        out = [op(img) for op in (brightness, contrast, saturation, hue)]
        at = order[..., i]
        img = torch.where(at == 0, out[0], torch.where(
            at == 1, out[1], torch.where(at == 2, out[2], out[3])))
    return img.to(rgb.dtype)


def legacy_augment_batch(imgs: torch.Tensor, labels: Optional[torch.Tensor],
                         draws: Dict[str, torch.Tensor], jitter: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The legacy augmentation of a batch of YUV-normalized NHWC images
    and their (N, H, W) labels (None: images only) with the given draws
    (:func:`draw_legacy_augment`): the horizontal, then the vertical flips
    of image and label, then, with ``jitter``, the RGB ColorJitter. CUDA
    tensors go through K4 (``cuda_kernels.legacy_jitter``, which raises
    on what it does not take), others through
    :func:`legacy_augment_batch_plain`."""
    if imgs.device.type == "cuda":
        from robocupvision_tpu_torch.ops import cuda_kernels

        return cuda_kernels.legacy_jitter(imgs, labels, draws, jitter,
                                          LEGACY_JITTER_TABLES)
    return legacy_augment_batch_plain(imgs, labels, draws, jitter)


def legacy_augment_batch_plain(
        imgs: torch.Tensor, labels: Optional[torch.Tensor],
        draws: Dict[str, torch.Tensor], jitter: bool = True
        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`legacy_augment_batch` in plain PyTorch, on any device: each
    flip as a ``flip`` and a ``torch.where``, and :func:`rgb_color_jitter`,
    which runs every op at every position."""
    imgs = _flip(_flip(imgs, draws["hflip"], 2), draws["vflip"], 1)
    if labels is not None:
        labels = _flip(_flip(labels, draws["hflip"], 2), draws["vflip"], 1)
    if jitter:
        mean = torch.as_tensor(_LEGACY_MEAN, dtype=imgs.dtype,
                               device=imgs.device)
        # invert Normalize([.5, 0, 0], [.5, .5, .5]) and the YUV transform
        yuv = imgs * 0.5 + mean
        rgb = torch.clamp(torch.einsum(
            "...c,dc->...d", yuv.float(),
            torch.as_tensor(RGB_FROM_YUV, device=imgs.device)), 0.0, 1.0)
        rgb = rgb_color_jitter(rgb, draws["b"], draws["c"], draws["s"],
                               draws["h"], draws["order"])
        yuv = rgb_to_yuv(rgb)
        imgs = ((yuv - mean.to(yuv.dtype)) / 0.5).to(imgs.dtype)
    return imgs, labels


# StepCfg.augment_mode -> (draw(gen, n), apply(imgs, labels, draws,
# jitter)): ssyuv (train.py), legacy (trainer.py:88-104) and legacy_hflip,
# the legacy stack without its vertical flip (classTrainer.py:55-62)
AUGMENT_MODES = {
    "ssyuv": (draw_augment, augment_batch),
    "legacy": (lambda gen, n: draw_legacy_augment(gen, n, use_vflip=True),
               legacy_augment_batch),
    "legacy_hflip": (lambda gen, n: draw_legacy_augment(gen, n,
                                                        use_vflip=False),
                     legacy_augment_batch),
}


# ---------------------------------------------------------------------------
# The reference's standalone Random* transforms (transform.py:88-137), which
# no reference entry point calls. The enhance_* functions are PIL's
# ImageEnhance formulas on an (H, W, 3) float RGB image in [0, 255]; the
# random_* functions apply one with given draws behind the reference's
# 0.9-probability gate.
# ---------------------------------------------------------------------------


def add_noise(img: torch.Tensor, noise: torch.Tensor,
              std: float = 0.05) -> torch.Tensor:
    """RandomNoise's body (transform.py:88-93): ``noise`` (standard normal,
    img's shape) scaled by ``std`` and added, with no clipping (the
    reference adds it after ToTensor)."""
    return img + std * noise.to(img.device, img.dtype)


def enhance_brightness(img: torch.Tensor, factor) -> torch.Tensor:
    """PIL ImageEnhance.Brightness: a blend from black, img * factor."""
    return torch.clamp(img * factor, 0.0, 255.0)


def enhance_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    """PIL ImageEnhance.Contrast: a blend from the constant image of the
    rounded mean of the grayscale conversion."""
    gray = torch.round(img @ torch.as_tensor(_GRAY_W, device=img.device))
    mean = torch.floor(gray.mean() + 0.5)
    return torch.clamp(mean + factor * (img - mean), 0.0, 255.0)


def enhance_color(img: torch.Tensor, factor) -> torch.Tensor:
    """PIL ImageEnhance.Color: a blend from the per-pixel grayscale."""
    gray = torch.round(img @ torch.as_tensor(_GRAY_W, device=img.device)
                       )[..., None]
    return torch.clamp(gray + factor * (img - gray), 0.0, 255.0)


def hue_shift_saturating(img: torch.Tensor, amount, subtract) -> torch.Tensor:
    """RandomHue's body (transform.py:120-137): the HSV hue on PIL's 0..255
    scale shifted by ``amount`` with a saturating add or subtract (the
    reference's ImageChops clip the hue rather than wrap it)."""
    h, s, v = _rgb_to_hsv(img / 255.0)
    h255 = h * 255.0
    h255 = torch.where(torch.as_tensor(subtract, device=img.device),
                       torch.clamp(h255 - amount, 0.0, 255.0),
                       torch.clamp(h255 + amount, 0.0, 255.0))
    return torch.clamp(_hsv_to_rgb(h255 / 255.0, s, v) * 255.0, 0.0, 255.0)


def draw_random_enhance(gen: torch.Generator, shape
                        ) -> Dict[str, torch.Tensor]:
    """The draws of one ``random_*`` call on an image of ``shape``, on the
    generator's device: the gate ``gate``, two uniforms ``u`` and ``v``
    (the factor 0.5 + u; the hue's amount floor(30 u) and direction
    v >= 0.5) and standard normal ``noise`` of the image's shape."""
    u = torch.rand((3,), generator=gen, device=gen.device)
    return {"gate": u[0], "u": u[1], "v": u[2],
            "noise": torch.randn(tuple(shape), generator=gen,
                                 device=gen.device)}


def _gated(img: torch.Tensor, gate, out: torch.Tensor,
           p: float = 0.9) -> torch.Tensor:
    return torch.where(torch.as_tensor(gate, device=img.device) < p, out, img)


def random_noise(img: torch.Tensor, d: Dict[str, torch.Tensor]):
    return _gated(img, d["gate"], add_noise(img, d["noise"]))


def random_brightness(img: torch.Tensor, d: Dict[str, torch.Tensor]):
    return _gated(img, d["gate"], enhance_brightness(img, 0.5 + d["u"]))


def random_contrast(img: torch.Tensor, d: Dict[str, torch.Tensor]):
    return _gated(img, d["gate"], enhance_contrast(img, 0.5 + d["u"]))


def random_color(img: torch.Tensor, d: Dict[str, torch.Tensor]):
    return _gated(img, d["gate"], enhance_color(img, 0.5 + d["u"]))


def random_hue(img: torch.Tensor, d: Dict[str, torch.Tensor]):
    # the reference builds its shift image with astype('uint8'), which
    # truncates random() * 30 to an integer shift of 0..29
    return _gated(img, d["gate"], hue_shift_saturating(
        img, torch.floor(d["u"] * 30.0), d["v"] >= 0.5))
