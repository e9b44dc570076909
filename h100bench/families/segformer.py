"""SegFormer (Xie et al., arXiv:2105.15203; NVlabs/SegFormer, the MiT
encoder of ``mmseg/models/backbones/mix_transformer.py`` and the all-MLP
head of ``mmseg/models/decode_heads/segformer_head.py``), in eval mode: its
plain reference forward, its FLOPs, and the draws of its LayerNorm kinds.
It has no K2 chain.

The forward is plain PyTorch in f32, written from the layer equations:
every LayerNorm, the GELU, the attention's softmax and the bilinear
resizes are spelled out, not taken from the library's fused ops. It
imports nothing of the program or of the benchmark: the tier-1 tests load
this file by its path. The caller turns TF32 off (``reference.tf32``).

Parameters are the NVlabs state_dict names, {name: tensor}: convs (out, in,
kh, kw), the depthwise convs (C, 1, 3, 3), linears (out, in).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
TORCH_LN_EPS = 1e-5   # nn.LayerNorm's default: the patch embeds, the sr norms
BLOCK_LN_EPS = 1e-6   # mit_b2's norm_layer: the blocks' and stages' norms
BN_EPS = 1e-5

# LayerNorm weights in [0.8, 1.2), biases in [-0.1, 0.1): (span, offset)
WEIGHT_KINDS = {"ln_w": (0.4, 0.8), "ln_b": (0.2, -0.1)}


def _patch(stage: int) -> Tuple[int, int]:
    """(kernel, stride) of a stage's patch embed (stages from 0)."""
    return (7, 4) if stage == 0 else (3, 2)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


def _grid(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H*W, C) -> (N, C, H, W)."""
    return t.transpose(1, 2).reshape(t.shape[0], -1, h, w)


def _layer_norm(p: Params, name: str, t: torch.Tensor,
                eps: float) -> torch.Tensor:
    mean = t.mean(dim=-1, keepdim=True)
    var = ((t - mean) ** 2).mean(dim=-1, keepdim=True)
    return (t - mean) / torch.sqrt(var + eps) * p[name + ".weight"] \
        + p[name + ".bias"]


def _linear(p: Params, name: str, t: torch.Tensor) -> torch.Tensor:
    return t @ p[name + ".weight"].T + p[name + ".bias"]


def _gelu(t: torch.Tensor) -> torch.Tensor:
    return 0.5 * t * (1.0 + torch.erf(t / math.sqrt(2.0)))


def _interp_matrix(n_in: int, n_out: int, like: torch.Tensor):
    """(n_out, n_in) weights of a linear resize along one axis,
    align_corners False: output o reads the input at (o + 0.5) n_in / n_out
    - 0.5, clamped at 0, between its two neighbours."""
    src = ((torch.arange(n_out, dtype=torch.float64) + 0.5)
           * (n_in / n_out) - 0.5).clamp_min(0.0)
    i0 = src.floor().long()
    i1 = (i0 + 1).clamp_max(n_in - 1)
    lam = src - i0
    rows = torch.arange(n_out)
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    m[rows, i0] += 1.0 - lam
    m[rows, i1] += lam
    return m.to(like)


def _bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, *size), bilinear, align_corners False."""
    mh = _interp_matrix(x.shape[2], size[0], x)
    mw = _interp_matrix(x.shape[3], size[1], x)
    return torch.einsum("oh,nchw,pw->ncop", mh, x, mw)


def _attention(p: Params, name: str, t: torch.Tensor, h: int, w: int,
               heads: int, sr: int) -> torch.Tensor:
    """mix_transformer.Attention: queries from every token, keys and values
    from the grid reduced by a stride-``sr`` conv and a LayerNorm."""
    n, l, c = t.shape
    q = _linear(p, name + ".q", t).reshape(n, l, heads, c // heads)
    kv_in = t
    if sr > 1:
        y = F.conv2d(_grid(t, h, w), p[name + ".sr.weight"],
                     p[name + ".sr.bias"], stride=sr)
        kv_in = _layer_norm(p, name + ".norm", _tokens(y), TORCH_LN_EPS)
    kv = _linear(p, name + ".kv", kv_in).reshape(n, -1, 2, heads, c // heads)
    k, v = kv.permute(2, 0, 3, 1, 4)            # each (N, heads, L', d)
    scores = q.transpose(1, 2) @ k.transpose(-2, -1) / math.sqrt(c // heads)
    a = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    a = a / a.sum(dim=-1, keepdim=True)
    return _linear(p, name + ".proj", (a @ v).transpose(1, 2).reshape(n, l, c))


def _mix_ffn(p: Params, name: str, t: torch.Tensor, h: int,
             w: int) -> torch.Tensor:
    y = _linear(p, name + ".fc1", t)
    c = y.shape[-1]
    y = F.conv2d(_grid(y, h, w), p[name + ".dwconv.dwconv.weight"],
                 p[name + ".dwconv.dwconv.bias"], padding=1, groups=c)
    return _linear(p, name + ".fc2", _gelu(_tokens(y)))


def forward(p: Params, cfg: dict, x: torch.Tensor,
            train: bool = False) -> torch.Tensor:
    """SegFormer, eval mode: (N, 3, H, W) -> (N, classes, H, W) logits."""
    if train:
        raise ValueError("the SegFormer reference is eval mode only")
    n = x.shape[0]
    feats: List[torch.Tensor] = []
    h = x
    for i, (c, heads, depth, sr) in enumerate(zip(
            cfg["embed_dims"], cfg["num_heads"], cfg["depths"],
            cfg["sr_ratios"])):
        k, s = _patch(i)
        pe = f"backbone.patch_embed{i + 1}"
        y = F.conv2d(h, p[pe + ".proj.weight"], p[pe + ".proj.bias"],
                     stride=s, padding=k // 2)
        gh, gw = y.shape[2:]
        t = _layer_norm(p, pe + ".norm", _tokens(y), TORCH_LN_EPS)
        for j in range(depth):
            b = f"backbone.block{i + 1}.{j}"
            t = t + _attention(p, b + ".attn",
                               _layer_norm(p, b + ".norm1", t, BLOCK_LN_EPS),
                               gh, gw, heads, sr)
            t = t + _mix_ffn(p, b + ".mlp",
                             _layer_norm(p, b + ".norm2", t, BLOCK_LN_EPS),
                             gh, gw)
        t = _layer_norm(p, f"backbone.norm{i + 1}", t, BLOCK_LN_EPS)
        h = _grid(t, gh, gw)
        feats.append(h)
    # SegFormerHead: c4, c3, c2 to c1's size, then the fuse and the pred
    quarter = feats[0].shape[2:]
    parts = []
    for i in (4, 3, 2, 1):
        f = feats[i - 1]
        y = _grid(_linear(p, f"decode_head.linear_c{i}.proj", _tokens(f)),
                  *f.shape[2:])
        parts.append(y if i == 1 else _bilinear(y, quarter))
    y = F.conv2d(torch.cat(parts, dim=1),
                 p["decode_head.linear_fuse.conv.weight"])
    bn = "decode_head.linear_fuse.bn"
    y = (y - p[bn + ".running_mean"].reshape(1, -1, 1, 1)) \
        / torch.sqrt(p[bn + ".running_var"].reshape(1, -1, 1, 1) + BN_EPS) \
        * p[bn + ".weight"].reshape(1, -1, 1, 1) \
        + p[bn + ".bias"].reshape(1, -1, 1, 1)
    y = F.conv2d(torch.clamp_min(y, 0.0), p["decode_head.linear_pred.weight"],
                 p["decode_head.linear_pred.bias"])
    return _bilinear(y, x.shape[2:])   # EncoderDecoder's resize to the frame


def _out_taps(n_in: int, k: int, stride: int, pad: int) -> Tuple[int, int]:
    """(output size, positions at which the taps of one axis read the
    input): padding taps do no work."""
    n_out = (n_in + 2 * pad - k) // stride + 1
    taps = sum(1 for d in range(k) for o in range(n_out)
               if 0 <= o * stride + d - pad < n_in)
    return n_out, taps


def flops(cfg: dict, h: int, w: int) -> int:
    """Forward FLOPs of one (h, w) frame: two per multiply-add of every
    linear, every conv (the taps that land inside the input) and the
    attention's two products (q k^T and its weights times v). Left out:
    biases, LayerNorms, BatchNorm, softmax, GELU, ReLU, the residual adds,
    the concat and the bilinear resizes, so a share of a peak built on it
    cannot read high."""
    macs, cin, grids = 0, 3, []
    for i, (c, depth, sr) in enumerate(zip(
            cfg["embed_dims"], cfg["depths"], cfg["sr_ratios"])):
        k, s = _patch(i)
        h, th = _out_taps(h, k, s, k // 2)
        w, tw = _out_taps(w, k, s, k // 2)
        grids.append((h, w))
        macs += th * tw * cin * c                      # patch embed
        tokens = h * w
        keys, sr_macs = tokens, 0
        if sr > 1:
            hs, ths = _out_taps(h, sr, sr, 0)
            ws, tws = _out_taps(w, sr, sr, 0)
            keys, sr_macs = hs * ws, ths * tws * c * c
        hidden = c * cfg["mlp_ratio"]
        _, dh = _out_taps(h, 3, 1, 1)
        _, dw = _out_taps(w, 3, 1, 1)
        macs += depth * (tokens * c * c                # q
                         + sr_macs + keys * c * 2 * c  # sr conv, kv
                         + 2 * tokens * keys * c       # q k^T, weights v
                         + tokens * c * c              # proj
                         + 2 * tokens * c * hidden     # fc1, fc2
                         + dh * dw * hidden)           # depthwise 3x3
        cin = c
    d = cfg["decoder_dim"]
    for (gh, gw), c in zip(grids, cfg["embed_dims"]):
        macs += gh * gw * c * d                        # linear_c{i}
    quarter = grids[0][0] * grids[0][1]
    macs += quarter * (4 * d * d + d * cfg["num_classes"])  # fuse, pred
    return 2 * macs
