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

then the decoder, 768 wide: each stage's tokens through a linear C_i -> 768,
bilinear to 1/4 of the frame (align_corners False), concatenated as [c4,
c3, c2, c1], a 1x1 conv 3072 -> 768 without bias -> BN -> ReLU, a 1x1 conv
768 -> classes, and bilinear back to the frame, as mmseg's EncoderDecoder
resizes its logits. Attention runs through
``torch.nn.functional.scaled_dot_product_attention``; everything else
through PyTorch's own ops.

While the tracer records (utils/profiling.py) a forward is the span
``seg.encoder``, then ``seg.decoder``; both are timed on the card when the
input is on one, and each attention call adds one to the counter
``mit.attn``.
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
from robocupvision_tpu_torch.utils import profiling

Params = L.Params

TORCH_LN_EPS = 1e-5   # nn.LayerNorm's default: patch embeds, reductions
BLOCK_LN_EPS = 1e-6   # mit_b2's norm_layer: the blocks' and the stages' LNs


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


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to ``hw`` (align_corners False)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


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


def _decode(cfg: SegFormerCfg, p: Params, feats, frame) -> torch.Tensor:
    """The stages' tokens -> NHWC logits at ``frame`` (H, W)."""
    n = feats[0][0].shape[0]
    quarter = feats[0][1]
    parts = []
    for i in (4, 3, 2, 1):
        t, hw = feats[i - 1]
        y = _linear(p, f"decode_head.linear_c{i}.proj", t).view(n, *hw, -1)
        parts.append(y if i == 1 else _resize(y, quarter))
    h = nn.conv2d(torch.cat(parts, dim=-1),
                  p["decode_head.linear_fuse.conv.weight"])
    bn = "decode_head.linear_fuse.bn"
    h = nn.relu(nn.batch_norm(h, p[bn + ".weight"], p[bn + ".bias"],
                              p[bn + ".running_mean"],
                              p[bn + ".running_var"]))
    logits = nn.conv2d(h, p["decode_head.linear_pred.weight"],
                       p["decode_head.linear_pred.bias"])
    return _resize(logits, frame)


def segformer_apply(cfg: SegFormerCfg, p: Params,
                    x: torch.Tensor) -> torch.Tensor:
    """NHWC frames -> NHWC logits at the frames' (H, W), in eval mode."""
    if L.in_train_mode():
        raise ValueError("the SegFormer runs in eval mode only: its "
                         "training is not ported")
    card = x.is_cuda
    with profiling.span("seg.encoder", card=card):
        feats = _encode(cfg, p, x)
    with profiling.span("seg.decoder", card=card):
        return _decode(cfg, p, feats, x.shape[1:3])


class SegFormerInfer:
    """A SegFormer's served graph: its weights rounded to ``dtype`` once,
    on ``device``."""

    def __init__(self, cfg: SegFormerCfg, params: Params,
                 dtype: torch.dtype, device: torch.device):
        self.cfg, self.dtype, self.device = cfg, dtype, device
        self.params = params

    def infer_u8_io(self, x_u8) -> torch.Tensor:
        """Raw camera bytes in, label bytes out: (N, H, W, 3) uint8 RGB ->
        (N, H, W) uint8 labels, the argmax of the full-resolution logits
        (ops/color.raw_camera_preprocess: /255, ToYUV, Normalize)."""
        x = raw_camera_preprocess(torch.as_tensor(x_u8, device=self.device))
        logits = segformer_apply(self.cfg, self.params, x.to(self.dtype))
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
    weights = {k: v.detach().to(device=dev, dtype=dtype)
               for k, v in state.items()}
    return SegFormerInfer(model.cfg, weights, dtype, dev)
