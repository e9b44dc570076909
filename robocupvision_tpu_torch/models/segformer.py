"""SegFormer (Xie et al., "SegFormer: Simple and Efficient Design for
Semantic Segmentation with Transformers", arXiv:2105.15203), at B2 by
default: the MiT encoder (NVlabs/SegFormer
``mmseg/models/backbones/mix_transformer.py``, ``mit_b2``) and the all-MLP
decoder (``mmseg/models/decode_heads/segformer_head.py``), in eval mode,
and its served graph.

Parameters carry the NVlabs state_dict names (``backbone.patch_embed1.proj``,
``backbone.block1.0.attn.q``, ``decode_head.linear_fuse.conv``, ...; the
decode head's unused ``conv_seg`` is left out). Activations run as tokens
(N, H*W, C), the NHWC layout flattened, so the convs take them as NHWC
views without a copy. The eval forward, stage i = 1..4:

  patch embed   conv k x k, stride s, padding k // 2 (k, s = 7, 4 at stage
                1, else 3, 2) -> LayerNorm (eps 1e-5)
  depths[i] x   x += Attn(LN(x)); x += MixFFN(LN(x))     (LN eps 1e-6)
    Attn        q = linear(x); k, v = linear(LN(conv_{sr x sr, stride sr}(x)))
                (LN eps 1e-5), or linear(x) where sr = 1; softmax(q k^T /
                sqrt(64)) v per head of 64; output linear; all with biases
    MixFFN      fc1 (C -> 4C) -> depthwise 3x3 with bias -> exact GELU ->
                fc2 (4C -> C)
  LayerNorm (eps 1e-6)

then the decoder, 768 wide, as NVlabs writes it: each stage's tokens
through a linear C_i -> 768, bilinear to 1/4 of the frame (align_corners
False), concatenated as [c4, c3, c2, c1], a 1x1 conv 3072 -> 768 without
bias -> BN -> ReLU, a 1x1 conv 768 -> classes, and bilinear back to the
frame, as mmseg's EncoderDecoder resizes its logits.

The port evaluates that decoder folded (``fold_head``). A bilinear resize
(align_corners False) is a per-channel spatial map whose weights sum to 1,
the fuse a per-pixel linear map and eval-mode BN a per-channel affine map,
so BN(fuse(cat[up(L_4 x_4), ..., L_1 x_1])) = sum_i up(W'_i x_i) + b' with

  W'_i = s * (F_i W_i)                 one C_i -> 768 matrix a stage
  b'   = s * sum_i F_i b_i + t         a constant passes through a resize

(``F_i`` the fuse's slice for stage i, ``W_i``, ``b_i`` its linear, BN's
``s = gamma / sqrt(var + eps)``, ``t = beta - mean s``), exact in real
arithmetic: each ``y_i = x_i W'_i^T`` runs at its stage's own resolution,
and ``ops/cuda_kernels.seg_head`` (K5 on the card) gathers
``W_pred ReLU(y_1 + up(y_2) + up(y_3) + up(y_4) + b') + b_pred`` at 1/4
of the frame. No 3072-channel map and no upsampled 768-channel map is
made. Attention runs through
``torch.nn.functional.scaled_dot_product_attention``; the rest through
PyTorch's own ops and K5.

While the tracer records (utils/profiling.py) a forward is the span
``seg.encoder``, then ``seg.decoder``; both are timed on the card when the
input is on one, each attention call adds one to the counter ``mit.attn``
and each K5 call one to ``k5.calls``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from robocupvision_tpu_torch.device import DeviceLike, resolve_device
from robocupvision_tpu_torch.models import layers as L
from robocupvision_tpu_torch.ops import nn
from robocupvision_tpu_torch.ops.color import raw_camera_preprocess
from robocupvision_tpu_torch.ops.cuda_kernels import seg_head
from robocupvision_tpu_torch.utils import profiling

Params = L.Params

TORCH_LN_EPS = 1e-5   # nn.LayerNorm's default: patch embeds, reductions
BLOCK_LN_EPS = 1e-6   # mit_b2's norm_layer: the blocks' and the stages' LNs
FUSE_BN_EPS = 1e-5    # the decoder's BatchNorm2d


@dataclasses.dataclass(frozen=True)
class SegFormerCfg:
    embed_dims: Tuple[int, ...] = (64, 128, 320, 512)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    depths: Tuple[int, ...] = (3, 4, 6, 3)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    mlp_ratio: int = 4
    decoder_dim: int = 768
    num_classes: int = 5

    def __post_init__(self):
        for f in ("embed_dims", "num_heads", "depths", "sr_ratios"):
            object.__setattr__(self, f, tuple(getattr(self, f)))
        if any(c % h for c, h in zip(self.embed_dims, self.num_heads)):
            raise ValueError(f"embed_dims {self.embed_dims} do not split "
                             f"into num_heads {self.num_heads}")


def _patch(stage: int) -> Tuple[int, int]:
    """(kernel, stride) of a stage's patch embed (stages from 1)."""
    return (7, 4) if stage == 1 else (3, 2)


def segformer_registry(cfg: SegFormerCfg) -> L.Registry:
    r = L.Registry()
    stages = list(zip(range(1, 5), cfg.embed_dims, cfg.depths, cfg.sr_ratios))
    cin = 3
    for i, c, _, _ in stages:
        r.conv(f"backbone.patch_embed{i}.proj", cin, c, _patch(i)[0])
        r.ln(f"backbone.patch_embed{i}.norm", c)
        cin = c
    for i, c, depth, sr in stages:
        hidden = c * cfg.mlp_ratio
        for j in range(depth):
            b = f"backbone.block{i}.{j}"
            r.ln(b + ".norm1", c)
            r.linear(b + ".attn.q", c, c)
            r.linear(b + ".attn.kv", c, 2 * c)
            r.linear(b + ".attn.proj", c, c)
            if sr > 1:
                r.conv(b + ".attn.sr", c, c, sr)
                r.ln(b + ".attn.norm", c)
            r.ln(b + ".norm2", c)
            r.linear(b + ".mlp.fc1", c, hidden)
            r.conv(b + ".mlp.dwconv.dwconv", 1, hidden, 3)   # depthwise
            r.linear(b + ".mlp.fc2", hidden, c)
        r.ln(f"backbone.norm{i}", c)
    d = cfg.decoder_dim
    for i in (4, 3, 2, 1):
        r.linear(f"decode_head.linear_c{i}.proj", cfg.embed_dims[i - 1], d)
    r.conv("decode_head.linear_fuse.conv", 4 * d, d, 1, bias=False)
    r.bn("decode_head.linear_fuse.bn", d)
    r.conv("decode_head.linear_pred", d, cfg.num_classes, 1)
    return r


def _linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def _ln(p: Params, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], eps)


def _attention(p: Params, name: str, x: torch.Tensor, hw, heads: int,
               sr: int) -> torch.Tensor:
    """Efficient self-attention of tokens ``x`` (N, L, C) on an ``hw``
    grid: keys and values from the grid reduced ``sr`` times a side."""
    n, l, c = x.shape
    q = _linear(p, name + ".q", x)
    kv_in = x
    if sr > 1:
        y = nn.conv2d(x.view(n, *hw, c), p[name + ".sr.weight"],
                      p[name + ".sr.bias"], stride=sr)
        kv_in = _ln(p, name + ".norm", y.reshape(n, -1, c), TORCH_LN_EPS)
    kv = _linear(p, name + ".kv", kv_in)
    profiling.count("mit.attn")

    def split(t):   # (N, L, C) -> (N, heads, L, C / heads)
        return t.unflatten(-1, (heads, c // heads)).transpose(1, 2)

    o = F.scaled_dot_product_attention(split(q), split(kv[..., :c]),
                                       split(kv[..., c:]))
    return _linear(p, name + ".proj", o.transpose(1, 2).reshape(n, l, c))


def _mix_ffn(p: Params, name: str, x: torch.Tensor, hw) -> torch.Tensor:
    n, l, _ = x.shape
    h = _linear(p, name + ".fc1", x)
    c = h.shape[-1]
    h = nn.conv2d(h.view(n, *hw, c), p[name + ".dwconv.dwconv.weight"],
                  p[name + ".dwconv.dwconv.bias"], padding=1, groups=c)
    return _linear(p, name + ".fc2", F.gelu(h.reshape(n, l, c)))


def _encode(cfg: SegFormerCfg, p: Params,
            x: torch.Tensor) -> List[Tuple[torch.Tensor, Tuple[int, int]]]:
    """NHWC frames -> each stage's (tokens (N, H_i*W_i, C_i), (H_i, W_i))."""
    n = x.shape[0]
    feats = []
    for i, (c, heads, depth, sr) in enumerate(zip(
            cfg.embed_dims, cfg.num_heads, cfg.depths, cfg.sr_ratios), 1):
        k, s = _patch(i)
        pe = f"backbone.patch_embed{i}"
        y = nn.conv2d(x, p[pe + ".proj.weight"], p[pe + ".proj.bias"],
                      stride=s, padding=k // 2)
        hw = tuple(y.shape[1:3])
        t = _ln(p, pe + ".norm", y.reshape(n, -1, c), TORCH_LN_EPS)
        for j in range(depth):
            b = f"backbone.block{i}.{j}"
            t = t + _attention(p, b + ".attn",
                               _ln(p, b + ".norm1", t, BLOCK_LN_EPS),
                               hw, heads, sr)
            t = t + _mix_ffn(p, b + ".mlp",
                             _ln(p, b + ".norm2", t, BLOCK_LN_EPS), hw)
        t = _ln(p, f"backbone.norm{i}", t, BLOCK_LN_EPS)
        feats.append((t, hw))
        x = t.view(n, *hw, c)
    return feats


@dataclasses.dataclass(frozen=True)
class FoldedHead:
    """The decoder folded (module docstring): ``stage_w[i - 1]`` is W'_i
    (768, C_i), ``bias`` b' (768,), ``pred_w`` (classes, 768) and
    ``pred_b`` (classes,) the pred conv's."""
    stage_w: Tuple[torch.Tensor, ...]
    bias: torch.Tensor
    pred_w: torch.Tensor
    pred_b: torch.Tensor


def fold_head(cfg: SegFormerCfg, p: Params,
              dtype: Optional[torch.dtype] = None) -> FoldedHead:
    """The decoder of the NVlabs-named parameters ``p`` folded, composed in
    f64 on their device and rounded to ``dtype`` (default: that of
    ``p``'s stage linears)."""
    d = cfg.decoder_dim
    dtype = dtype or p["decode_head.linear_c1.proj.weight"].dtype

    def f64(name):
        return p["decode_head." + name].double()

    fuse = f64("linear_fuse.conv.weight").reshape(d, 4 * d)
    bn = "linear_fuse.bn."
    s = torch.rsqrt(f64(bn + "running_var") + FUSE_BN_EPS) \
        * f64(bn + "weight")
    bias = f64(bn + "bias") - f64(bn + "running_mean") * s
    stage_w = []
    for i in (1, 2, 3, 4):   # the concat is [c4, c3, c2, c1]
        f_i = fuse[:, (4 - i) * d:(5 - i) * d]
        lin = f"linear_c{i}.proj."
        stage_w.append((s[:, None] * (f_i @ f64(lin + "weight"))).to(dtype))
        bias = bias + s * (f_i @ f64(lin + "bias"))
    return FoldedHead(tuple(stage_w), bias.to(dtype),
                      p["decode_head.linear_pred.weight"].reshape(
                          cfg.num_classes, d).to(dtype),
                      p["decode_head.linear_pred.bias"].to(dtype))


def _decode(head: FoldedHead, feats, frame) -> torch.Tensor:
    """The stages' tokens -> NHWC logits at ``frame`` (H, W), through the
    folded head."""
    n = feats[0][0].shape[0]
    ys = [F.linear(t, w).view(n, *hw, -1)
          for (t, hw), w in zip(feats, head.stage_w)]
    logits = seg_head(ys, head.bias, head.pred_w, head.pred_b)
    return nn.resize_bilinear(logits, frame)


def _forward(cfg: SegFormerCfg, p: Params, head: FoldedHead,
             x: torch.Tensor) -> torch.Tensor:
    card = x.is_cuda
    with profiling.span("seg.encoder", card=card):
        feats = _encode(cfg, p, x)
    with profiling.span("seg.decoder", card=card):
        return _decode(head, feats, x.shape[1:3])


def segformer_apply(cfg: SegFormerCfg, p: Params,
                    x: torch.Tensor) -> torch.Tensor:
    """NHWC frames -> NHWC logits at the frames' (H, W), in eval mode; the
    decoder folded from ``p`` on the fly."""
    if L.in_train_mode():
        raise ValueError("the SegFormer runs in eval mode only: its "
                         "training is not ported")
    return _forward(cfg, p, fold_head(cfg, p), x)


class SegFormerInfer:
    """A SegFormer's served graph from its NVlabs-named state dict
    ``params``: the encoder's weights rounded to ``dtype`` once, and the
    decoder folded once (``fold_head``, f64, then rounded to ``dtype``),
    on ``device``."""

    def __init__(self, cfg: SegFormerCfg, params: Params,
                 dtype: torch.dtype, device: torch.device):
        self.cfg, self.dtype, self.device = cfg, dtype, device
        self.params = {k: v.detach().to(device=device, dtype=dtype)
                       for k, v in params.items()
                       if k.startswith("backbone.")}
        self.head = fold_head(cfg, {k: v.detach().to(device)
                                    for k, v in params.items()
                                    if k.startswith("decode_head.")}, dtype)

    def infer_u8_io(self, x_u8) -> torch.Tensor:
        """Raw camera bytes in, label bytes out: (N, H, W, 3) uint8 RGB ->
        (N, H, W) uint8 labels, the argmax of the full-resolution logits
        (ops/color.raw_camera_preprocess: /255, ToYUV, Normalize)."""
        x = raw_camera_preprocess(torch.as_tensor(x_u8, device=self.device))
        logits = _forward(self.cfg, self.params, self.head, x.to(self.dtype))
        return torch.argmax(logits, dim=-1).to(torch.uint8)


def build_segformer_infer(model, params: Optional[Params] = None,
                          dtype: torch.dtype = torch.float32,
                          device: DeviceLike = None) -> SegFormerInfer:
    """The served graph of a zoo SegFormer (``model``; ``params``: its
    state_dict, default the model's own), in ``dtype``, on ``device``
    (``cuda`` unless the caller passes another). Sets no global flag: TF32
    and cuDNN stay as PyTorch's defaults leave them."""
    dev = resolve_device(device)
    state = model.state_dict() if params is None else params
    return SegFormerInfer(model.cfg, state, dtype, dev)
