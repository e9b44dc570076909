"""The SegFormer's folded decoder (models/segformer.py ``fold_head``) and
K5's plain version (ops/cuda_kernels.py ``seg_head_plain``) on the CPU: the
folded decoder against the unfolded one NVlabs writes (written out here) at
64x96 with B2's widths, in f64 and in f32; the plain head against a
resize-add-ReLU-pred spelled out with explicit bilinear taps; the fold's
biases and BatchNorm statistics; and the served graph's folded head. K5
itself is held to the plain version on the card
(tests/test_torch_cuda_kernels.py)."""

import math

import pytest
import torch

from robocupvision_tpu_torch.models import segformer
from robocupvision_tpu_torch.ops import cuda_kernels, nn

FRAME = (64, 96)
B2 = segformer.SegFormerCfg()
# test_torch_segformer.py's tolerance for f32 on the CPU
REL_TOL = 3e-5


def decoder_params(cfg: segformer.SegFormerCfg, seed: int,
                   dtype=torch.float64) -> dict:
    """The decoder's NVlabs-named parameters, all random: He-normal
    weights, biases in [-0.1, 0.1), BN scales in [0.8, 1.2), running means
    in [-0.5, 0.5) and variances in [0.5, 2)."""
    gen = torch.Generator().manual_seed(seed)
    reg = segformer.segformer_registry(cfg)
    p = {}
    for s in reg.specs.values():
        if not s.name.startswith("decode_head."):
            continue
        shape = s.torch_shape
        u = torch.rand(shape, generator=gen, dtype=torch.float64)
        if s.name.endswith("running_mean"):
            t = u - 0.5
        elif s.name.endswith("running_var"):
            t = 0.5 + 1.5 * u
        elif s.name.endswith("bn.weight"):
            t = 0.8 + 0.4 * u
        elif s.name.endswith("weight"):
            t = torch.randn(shape, generator=gen, dtype=torch.float64) \
                * math.sqrt(2.0 / math.prod(shape[1:]))
        else:
            t = 0.2 * u - 0.1
        p[s.name] = t.to(dtype)
    return p


def stage_tokens(cfg, n: int, frame, seed: int, dtype=torch.float64):
    """Random stage tokens as the encoder shapes them: stage i at 1/2^(i+1)
    of ``frame`` (the patch embeds' strided convs), C_i wide."""
    gen = torch.Generator().manual_seed(seed)
    h, w = (-(-s // 4) for s in frame)
    feats = []
    for c in cfg.embed_dims:
        feats.append((torch.randn(n, h * w, c, generator=gen,
                                  dtype=torch.float64).to(dtype), (h, w)))
        h, w = -(-h // 2), -(-w // 2)
    return feats


def unfolded_decode(cfg, p, feats, frame):
    """NVlabs' all-MLP decoder, unfolded: each stage's linear,
    bilinear to 1/4 of the frame, the [c4, c3, c2, c1] concat, the 1x1 fuse
    without bias, BN, ReLU, the 768 -> K pred conv, bilinear to the frame."""
    n = feats[0][0].shape[0]
    quarter = feats[0][1]
    parts = []
    for i in (4, 3, 2, 1):
        t, hw = feats[i - 1]
        lin = f"decode_head.linear_c{i}.proj."
        y = torch.nn.functional.linear(t, p[lin + "weight"],
                                       p[lin + "bias"]).view(n, *hw, -1)
        parts.append(y if i == 1 else nn.resize_bilinear(y, quarter))
    h = nn.conv2d(torch.cat(parts, dim=-1),
                  p["decode_head.linear_fuse.conv.weight"])
    bn = "decode_head.linear_fuse.bn."   # eval mode, in h's own dtype
    h = nn.relu((h - p[bn + "running_mean"])
                / torch.sqrt(p[bn + "running_var"] + 1e-5)
                * p[bn + "weight"] + p[bn + "bias"])
    logits = nn.conv2d(h, p["decode_head.linear_pred.weight"],
                       p["decode_head.linear_pred.bias"])
    return nn.resize_bilinear(logits, frame)


def folded_decode(cfg, p, feats, frame):
    return segformer._decode(segformer.fold_head(cfg, p), feats, frame)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_folded_decoder_matches_unfolded_f64():
    """Exact in real arithmetic: in f64 the two agree to rounding."""
    p = decoder_params(B2, 1)
    feats = stage_tokens(B2, 2, FRAME, 2)
    want = unfolded_decode(B2, p, feats, FRAME)
    got = folded_decode(B2, p, feats, FRAME)
    assert got.dtype == torch.float64 and got.shape == (2, *FRAME, 5)
    assert rel_err(got, want) <= 1e-10


def test_folded_decoder_matches_unfolded_f32():
    """In f32 the fold (composed in f64, rounded once) and the unfolded
    decoder round differently: within the tolerance the port's forward
    is held to against the reference."""
    p64 = decoder_params(B2, 3)
    feats64 = stage_tokens(B2, 2, FRAME, 4)
    want = unfolded_decode(B2, p64, feats64, FRAME)
    p = {k: v.float() for k, v in p64.items()}
    feats = [(t.float(), hw) for t, hw in feats64]
    got = folded_decode(B2, p, feats, FRAME)
    assert got.dtype == torch.float32
    assert rel_err(got.double(), want) <= REL_TOL
    assert rel_err(unfolded_decode(B2, p, feats, FRAME).double(),
                   want) <= REL_TOL


def explicit_up(y: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize of NHWC ``y`` to ``hw`` with align_corners False,
    its taps written out: source index (dst + 0.5) * in / out - 0.5,
    clamped at 0; the second tap clamped at the last row or column."""
    def taps(n_in, n_out):
        i0, i1, l1 = [], [], []
        for d in range(n_out):
            s = max((d + 0.5) * n_in / n_out - 0.5, 0.0)
            a = int(s)
            i0.append(a)
            i1.append(min(a + 1, n_in - 1))
            l1.append(s - a)
        return (torch.tensor(i0), torch.tensor(i1),
                torch.tensor(l1, dtype=y.dtype))

    ry0, ry1, ly = taps(y.shape[1], hw[0])
    rx0, rx1, lx = taps(y.shape[2], hw[1])
    ly, lx = ly[None, :, None, None], lx[None, None, :, None]
    rows = y[:, ry0] * (1 - ly) + y[:, ry1] * ly
    return rows[:, :, rx0] * (1 - lx) + rows[:, :, rx1] * lx


@pytest.mark.parametrize("sizes", [
    ((16, 24), (8, 12), (4, 6), (2, 3)),      # the 64x96 frame's stages
    ((13, 17), (7, 9), (4, 5), (2, 3)),       # odd sizes
    ((61, 83), (31, 42), (16, 21), (8, 11)),
    ((1, 1), (1, 1), (1, 1), (1, 1)),         # a 1x1 map
    ((5, 3), (9, 2), (1, 4), (3, 1)),         # stages larger than the first
])
def test_plain_head_matches_explicit(sizes):
    gen = torch.Generator().manual_seed(5)
    d, k = 12, 5
    ys = [torch.randn(2, *hw, d, generator=gen, dtype=torch.float64)
          for hw in sizes]
    bias = torch.randn(d, generator=gen, dtype=torch.float64)
    w_pred = torch.randn(k, d, generator=gen, dtype=torch.float64)
    b_pred = torch.randn(k, generator=gen, dtype=torch.float64)
    h = ys[0] + bias + sum(explicit_up(y, sizes[0]) for y in ys[1:])
    want = torch.clamp_min(h, 0) @ w_pred.T + b_pred
    got = cuda_kernels.seg_head(ys, bias, w_pred, b_pred)
    assert got.shape == (2, *sizes[0], k)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    got32 = cuda_kernels.seg_head([y.float() for y in ys], bias.float(),
                                  w_pred.float(), b_pred.float())
    assert got32.dtype == torch.float32
    assert rel_err(got32.double(), want) <= 1e-5


def test_fold_bias_and_batch_norm():
    """b' = s * sum_i F_i b_i + t and W'_i = s * F_i W_i with BN's running
    statistics: zero tokens give b' at every pixel of the unfolded
    decoder's BN output, and a token one-hot in a channel of stage i gives
    b' plus that channel's column of W'_i."""
    cfg = segformer.SegFormerCfg(embed_dims=(8, 12, 16, 20),
                                 num_heads=(1, 1, 1, 1), decoder_dim=24)
    p = decoder_params(cfg, 7)
    head = segformer.fold_head(cfg, p)
    bn = "decode_head.linear_fuse.bn."
    s = p[bn + "weight"] / torch.sqrt(p[bn + "running_var"] + 1e-5)
    t = p[bn + "bias"] - p[bn + "running_mean"] * s
    assert float((s - 1).abs().min()) > 1e-3 and float(t.abs().max()) > 0.1

    def pre_relu(feats):   # the unfolded decoder up to BN, at one pixel
        parts = [torch.nn.functional.linear(
            f, p[f"decode_head.linear_c{i}.proj.weight"],
            p[f"decode_head.linear_c{i}.proj.bias"])
            for i, f in zip((4, 3, 2, 1), feats[::-1])]
        fuse = p["decode_head.linear_fuse.conv.weight"].reshape(
            cfg.decoder_dim, -1)
        return fuse @ torch.cat(parts) * s + t

    zeros = [torch.zeros(c, dtype=torch.float64) for c in cfg.embed_dims]
    assert float((pre_relu(zeros) - head.bias).abs().max()) <= 1e-12
    for i, c in enumerate(cfg.embed_dims):
        x = [z.clone() for z in zeros]
        x[i][c // 2] = 1.0
        col = head.stage_w[i][:, c // 2]
        assert float((pre_relu(x) - head.bias - col).abs().max()) <= 1e-12
    assert head.pred_w.shape == (5, cfg.decoder_dim)


def test_fold_composes_in_f64_and_rounds_once():
    """An f32 fold of f32 parameters is the f64 fold of the same values
    rounded to f32, bit for bit; a bf16 fold rounds that once more."""
    p = {k: v.float() for k, v in decoder_params(B2, 9).items()}
    want = segformer.fold_head(B2, {k: v.double() for k, v in p.items()})
    for dtype in (torch.float32, torch.bfloat16):
        got = segformer.fold_head(B2, p, dtype)
        for a, b in zip((*got.stage_w, got.bias, got.pred_w, got.pred_b),
                        (*want.stage_w, want.bias, want.pred_w,
                         want.pred_b)):
            assert a.dtype == dtype and torch.equal(a, b.to(dtype))


def test_served_graph_holds_the_folded_head():
    """The served graph folds once, from the unrounded state dict: its
    head is the f64 fold rounded to the served dtype, and it holds no
    decoder weight besides."""
    from robocupvision_tpu_torch.models import zoo

    cfg = segformer.SegFormerCfg(embed_dims=(8, 8, 16, 16),
                                 num_heads=(1, 1, 1, 1), depths=(1, 1, 1, 1),
                                 decoder_dim=16)
    model = zoo.make("segformer", device="cpu",
                     generator=torch.Generator().manual_seed(0),
                     **{k: getattr(cfg, k) for k in (
                         "embed_dims", "num_heads", "depths",
                         "decoder_dim")})
    state = model.state_dict()
    want = segformer.fold_head(model.cfg, {k: v.double()
                                           for k, v in state.items()})
    pi = segformer.build_segformer_infer(model, dtype=torch.bfloat16,
                                         device="cpu")
    assert not any(k.startswith("decode_head.") for k in pi.params)
    assert torch.equal(pi.head.bias, want.bias.bfloat16())
    assert all(torch.equal(a, b.bfloat16())
               for a, b in zip(pi.head.stage_w, want.stage_w))
    labels = pi.infer_u8_io(torch.zeros((1, 32, 48, 3), dtype=torch.uint8))
    assert labels.shape == (1, 32, 48) and labels.dtype == torch.uint8


@pytest.mark.parametrize("bad", ["three_maps", "n", "d", "w_pred", "bias",
                                 "b_pred", "empty"])
def test_head_refuses_mismatched_shapes(bad):
    ys = [torch.zeros(2, h, h, 8) for h in (8, 4, 2, 1)]
    args = dict(bias=torch.zeros(8), w_pred=torch.zeros(5, 8),
                b_pred=torch.zeros(5))
    if bad == "three_maps":
        ys = ys[:3]
    elif bad == "n":
        ys[2] = torch.zeros(3, 2, 2, 8)
    elif bad == "d":
        ys[1] = torch.zeros(2, 4, 4, 12)
    elif bad == "empty":
        ys[3] = torch.zeros(2, 0, 1, 8)
    elif bad == "w_pred":
        args["w_pred"] = torch.zeros(5, 12)
    else:
        args[bad] = torch.zeros(3)
    with pytest.raises(ValueError):
        cuda_kernels.seg_head(ys, **args)
