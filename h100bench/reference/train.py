"""The plain reference of a train step: the augmentations (frozen copies of
the reference's transforms), the loss, the L1 term and the optimizers,
in plain PyTorch and f32.

- train.py's augmentation (dataset.py:126-131): a 0.5-probability
  horizontal flip of image and label, then the YUV jitter
  Y' = (Y + b) c,  [U' V'] = [[s cos h, -sin h], [sin h, s cos h]] [U V].
- trainer.py's (trainer.py:88-104): horizontal and vertical flips, then
  torchvision's ColorJitter(0.5, 0.5, 0.4, 0.3) on the RGB image, its four
  ops in an order of each sample's own, before ToYUV and Normalize.
- CrossEntropyLoss2d: the class-weighted mean NLL over pixels,
  sum(w[t] nll) / sum(w[t]); train.py adds l1 * sum|p| over the params.
- torch.optim.Adam and torch.optim.SGD(momentum, weight_decay).

The draws (flips, jitter values, op orders, the epoch's permutation) are
made here from the benchmark's own generator and handed to the program
and to this reference alike. This module imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

Params = Dict[str, torch.Tensor]

_YUV = torch.tensor(((0.299, 0.587, 0.114),
                     (-0.14714119, -0.28886916, 0.43601035),
                     (0.61497538, -0.51496512, -0.10001026)),
                    dtype=torch.float64)
_RGB = torch.linalg.inv(_YUV)
_GRAY = (0.299, 0.587, 0.114)          # PIL's convert("L")
_LEGACY_MEAN = (0.5, 0.0, 0.0)


# -- draws --------------------------------------------------------------------

def draw_ssyuv(gen: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
    """train.py's draws: flip (p 0.5), brightness b in [-0.3, 0.3),
    contrast c and saturation s in [0.7, 1.3), hue h in [-pi/6, pi/6)."""
    u = torch.rand((5, n), generator=gen, device=gen.device)
    jh = 3.1415 / 6
    return {"flip": u[0] > 0.5, "b": -0.3 + 0.6 * u[1],
            "c": 0.7 + 0.6 * u[2], "s": 0.7 + 0.6 * u[3],
            "h": -jh + 2 * jh * u[4]}


def draw_legacy(gen: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
    """trainer.py's draws: hflip, vflip (p 0.5 each), brightness and
    contrast factors in [0.5, 1.5), saturation in [0.6, 1.4), hue shift in
    [-0.3, 0.3) turns, and the order of the four jitter ops."""
    u = torch.rand((6, n), generator=gen, device=gen.device)
    order = torch.argsort(torch.rand((n, 4), generator=gen,
                                     device=gen.device), dim=1)
    return {"hflip": u[0] < 0.5, "vflip": u[1] < 0.5,
            "b": 0.5 + u[2], "c": 0.5 + u[3], "s": 0.6 + 0.8 * u[4],
            "h": -0.3 + 0.6 * u[5], "order": order}


DRAWS = {"ssyuv": draw_ssyuv, "legacy": draw_legacy}


# -- augmentations (NHWC images, NHW labels) ----------------------------------

def _flip(x: torch.Tensor, where: torch.Tensor, dim: int) -> torch.Tensor:
    sel = where.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(sel, x.flip(dim), x)


def augment_ssyuv(imgs, labels, d):
    imgs, labels = _flip(imgs, d["flip"], 2), _flip(labels, d["flip"], 2)
    b, c, s, h = (d[k].reshape(-1, 1, 1) for k in "bcsh")
    y = (imgs[..., 0] + b) * c
    u, v = imgs[..., 1], imgs[..., 2]
    u2 = s * torch.cos(h) * u - torch.sin(h) * v
    v2 = torch.sin(h) * u + s * torch.cos(h) * v
    return torch.stack([y, u2, v2], dim=-1), labels


def _hsv(rgb):
    """colorsys.rgb_to_hsv on (..., 3), hue in turns; grey: h = s = 0."""
    r, g, b = rgb.unbind(-1)
    mx, mn = rgb.max(-1).values, rgb.min(-1).values
    d = mx - mn
    s = torch.where(mx > 0, d / mx.clamp_min(1e-12), torch.zeros_like(mx))
    dd = d.clamp_min(1e-12)
    rc, gc, bc = (mx - r) / dd, (mx - g) / dd, (mx - b) / dd
    h = torch.where(r == mx, bc - gc,
                    torch.where(g == mx, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(d > 0, (h / 6.0) % 1.0, torch.zeros_like(h))
    return h, s, mx


def _rgb(h, s, v):
    """colorsys.hsv_to_rgb on tensors."""
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = i.long() % 6
    table = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
             (v, p, q)]
    out = torch.zeros(h.shape + (3,), dtype=h.dtype, device=h.device)
    for k, (a, b, c) in enumerate(table):
        out = torch.where((i == k)[..., None], torch.stack([a, b, c], -1),
                          out)
    return out


def color_jitter(rgb, d):
    """ColorJitter with each sample's factors and op order."""
    col = {k: d[k].reshape(-1, 1, 1, 1) for k in "bcs"}
    shift = d["h"].reshape(-1, 1, 1)
    gray_w = torch.tensor(_GRAY, device=rgb.device)

    def op(k, img):
        if k == 0:
            return (img * col["b"]).clamp(0, 1)
        if k == 1:
            m = (img @ gray_w).mean(dim=(1, 2)).reshape(-1, 1, 1, 1)
            return (col["c"] * img + (1 - col["c"]) * m).clamp(0, 1)
        if k == 2:
            g = (img @ gray_w)[..., None]
            return (col["s"] * img + (1 - col["s"]) * g).clamp(0, 1)
        hh, ss, vv = _hsv(img)
        return _rgb((hh + shift) % 1.0, ss, vv).clamp(0, 1)

    img = rgb
    for pos in range(4):
        at = d["order"][:, pos].reshape(-1, 1, 1, 1)
        outs = [op(k, img) for k in range(4)]
        img = torch.where(at == 0, outs[0], torch.where(
            at == 1, outs[1], torch.where(at == 2, outs[2], outs[3])))
    return img


def augment_legacy(imgs, labels, d):
    for key, dim in (("hflip", 2), ("vflip", 1)):
        imgs, labels = _flip(imgs, d[key], dim), _flip(labels, d[key], dim)
    dev = imgs.device
    mean = torch.tensor(_LEGACY_MEAN, device=dev)
    yuv = imgs * 0.5 + mean
    rgb = (yuv @ _RGB.to(dev, torch.float32).T).clamp(0, 1)
    rgb = color_jitter(rgb, d)
    yuv = rgb @ _YUV.to(dev, torch.float32).T
    return (yuv - mean) / 0.5, labels


AUGMENTS = {"ssyuv": augment_ssyuv, "legacy": augment_legacy}


# -- loss and optimizers ------------------------------------------------------

def ce2d(logits: torch.Tensor, targets: torch.Tensor,
         weights: Sequence[float]) -> torch.Tensor:
    """(N, C, H, W) logits, (N, H, W) targets."""
    logp = torch.log_softmax(logits, dim=1)
    t = targets.long()
    nll = -logp.gather(1, t[:, None])[:, 0]
    w = torch.tensor(weights, dtype=torch.float32, device=logits.device)[t]
    return (w * nll).sum() / w.sum()


def is_trainable(name: str) -> bool:
    return not name.endswith((".running_mean", ".running_var"))


class Adam:
    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m, self.v, self.t = {}, {}, 0

    def step(self, p: Params, g: Params) -> Params:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        out = {}
        for k, gk in g.items():
            m = self.b1 * self.m.get(k, 0) + (1 - self.b1) * gk
            v = self.b2 * self.v.get(k, 0) + (1 - self.b2) * gk * gk
            self.m[k], self.v[k] = m, v
            out[k] = p[k] - self.lr * (m / c1) / (torch.sqrt(v / c2)
                                                  + self.eps)
        return out


class SGD:
    def __init__(self, lr, momentum=0.0, weight_decay=0.0):
        self.lr, self.mom, self.wd = lr, momentum, weight_decay
        self.buf = {}

    def step(self, p: Params, g: Params) -> Params:
        out = {}
        for k, gk in g.items():
            d = gk + self.wd * p[k]
            if self.mom:
                d = d if k not in self.buf else self.mom * self.buf[k] + d
                self.buf[k] = d
            out[k] = p[k] - self.lr * d
        return out


def optimizer(spec: dict):
    if spec["name"] == "adam":
        return Adam(spec["lr"])
    if spec["name"] == "sgd":
        return SGD(spec["lr"], spec.get("momentum", 0.0),
                   spec.get("weight_decay", 0.0))
    raise ValueError(spec["name"])


def run_steps(forward: Callable, params: Params, batches: List[tuple],
              draws: List[dict], augment: str, weights: Sequence[float],
              l1: float, opt_spec: dict) -> dict:
    """The reference's steps from ``params`` over ``batches`` ((N, H, W, 3)
    images, (N, H, W) labels) with ``draws``: each step augments, runs the
    train-mode forward, takes the loss plus ``l1`` sum|p| and its gradients
    by autograd, and updates. Returns each step's loss, the first step's
    gradients and the params after the last step (trainable leaves)."""
    p = {k: v.detach().clone() for k, v in params.items()
         if is_trainable(k)}
    state = {k: v for k, v in params.items() if not is_trainable(k)}
    opt = optimizer(opt_spec)
    losses, first_grads = [], None
    for (imgs, labels), d in zip(batches, draws):
        x, t = AUGMENTS[augment](imgs, labels, d)
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        with torch.enable_grad():
            logits = forward({**leaves, **state},
                             x.permute(0, 3, 1, 2).contiguous())
            loss = ce2d(logits, t, weights)
            if l1:
                loss = loss + l1 * sum(v.abs().sum()
                                       for _, v in sorted(leaves.items()))
            # a head the forward does not reach gets a zero gradient
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        g = dict(zip(leaves, grads))
        if first_grads is None:
            first_grads = {k: v.detach() for k, v in g.items()}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            p = opt.step(p, g)
    return {"losses": losses, "grads": first_grads, "params": p}
