"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
without one. They import no JAX, so they also run on a machine that has only
PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: counts exactly; chains in f32 at rtol = atol = 2e-4 (conv
reassociation, TF32 off), in bf16 per element at two bf16 ulps of the
reference plus 2**-8 of its largest magnitude (``bf16_tolerance``: a
rounding flip carried through the later stages), labels >= 0.9999 (f32) /
0.999 (bf16) agreement. The band splits only the halo recompute, so every
band gives bit-identical results, for dilated, folded-stem, conv'd-skip
(``skip_w``) and pool chains too. A pool stage is exact: bit-identical to
``packed_max_pool``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from robocupvision_tpu_torch.models import packed, zoo
from robocupvision_tpu_torch.ops import cuda_packed as ckp
from robocupvision_tpu_torch.ops.cuda_kernels import (confusion_count,
                                                      confusion_count_plain)

_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(seed, shape, dtype, dev):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=dev, dtype=dtype)


_U8, _I32, _I64 = torch.uint8, torch.int32, torch.int64
_VGA = (480, 640)
# (pred dtype, tgt dtype, C, B, (H, W), distribution, layout): every
# pairing of uint8, int32 and int64; C in {1, 2, 5, 16}; odd, tiny and VGA
# sizes; the main paths' maps; int64 maps carry labels beyond the int32
# range (chip_smoke.widen_labels); "offset" maps start one element into a
# larger tensor (unaligned bases and per-image offsets; the uint8 pair is
# never aligned at the same pixel)
_K1_CASES = [
    (_U8, _U8, 5, 1, _VGA, "frame", "contiguous"),
    (_U8, _I32, 5, 1, _VGA, "random", "contiguous"),        # serving
    (_U8, _I64, 5, 3, (121, 161), "random", "contiguous"),
    (_I32, _U8, 2, 3, (3, 5), "frame", "contiguous"),
    (_I32, _I32, 5, 64, (120, 160), "random", "contiguous"),
    (_I32, _I64, 16, 1, _VGA, "frame", "contiguous"),
    (_I64, _U8, 1, 3, (1, 1), "random", "contiguous"),
    (_I64, _I32, 5, 64, (120, 160), "frame", "contiguous"),  # training
    (_I64, _I64, 16, 3, (121, 161), "random", "contiguous"),
    (_U8, _U8, 16, 64, (3, 5), "random", "contiguous"),
    (_I32, _I32, 1, 1, (121, 161), "frame", "contiguous"),
    (_I64, _I64, 2, 1, _VGA, "random", "contiguous"),
    (_I64, _I32, 5, 16, (240, 320), "random", "contiguous"),  # test.py
    (_I32, _I64, 2, 64, (1, 1), "random", "contiguous"),
    (_U8, _I64, 16, 64, (121, 161), "frame", "contiguous"),
    (_U8, _I32, 5, 3, (121, 161), "random", "offset"),
    (_I64, _U8, 5, 3, (121, 161), "frame", "offset"),
    (_I32, _I32, 16, 3, (121, 161), "random", "offset"),
    (_U8, _U8, 5, 3, (121, 161), "random", "offset"),
]


def _k1_case(pdt, tdt, c, b, size, dist, layout, seed, dev):
    import chip_smoke

    extra = 1 if layout == "offset" else 0
    pred, tgt = chip_smoke.k1_maps(dist, (b + extra, *size), c, pdt, tdt,
                                   seed, dev)
    if pdt == torch.int64:
        pred = chip_smoke.widen_labels(pred, seed + 1)
    if tdt == torch.int64:
        tgt = chip_smoke.widen_labels(tgt, seed + 2)
    if layout == "offset":
        n = b * size[0] * size[1]
        pred = pred.flatten()[1:1 + n].view(b, *size)
        tgt = tgt[1:] if (pdt, tdt) != (_U8, _U8) else tgt[:b]
    return pred, tgt


@pytest.mark.cuda
@pytest.mark.parametrize("pdt,tdt,c,b,size,dist,layout", _K1_CASES)
def test_confusion_kernel_matches_plain(cuda_device, pdt, tdt, c, b, size,
                                        dist, layout):
    """K1 equals its plain count (on the CPU) exactly (C <= 5 counts in
    per-thread counters, C = 16 in per-warp histograms); one wrapper call
    is one counted launch and, for contiguous maps, one device launch in
    the profiler (no cast, fill or conversion kernel beside it); the counts
    are f32 on the maps' card."""
    import chip_smoke

    pred, tgt = _k1_case(pdt, tdt, c, b, size, dist, layout,
                         _K1_CASES.index((pdt, tdt, c, b, size, dist, layout)),
                         cuda_device)
    ref = confusion_count_plain(pred.cpu(), tgt.cpu(), c)
    before = confusion_count.launches
    got = confusion_count(pred, tgt, c)
    torch.cuda.synchronize()
    assert confusion_count.launches == before + 1
    assert got.dtype == torch.float32 and got.device == pred.device
    assert torch.equal(got.cpu(), ref)
    if layout == "contiguous":
        rows = chip_smoke.profile_calls(lambda: confusion_count(pred, tgt, c),
                                        8)
        assert chip_smoke.k1_device_launches(rows) == 1, rows


def _qvga_chains(dt, dev):
    model = zoo.make("robo_unet", device=dev,
                     generator=torch.Generator().manual_seed(5))
    return packed.build_packed_infer(model, None, dt, pallas=True,
                                     device=dev).chains


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("which,head", [("down", False), ("up", False),
                                        ("up", True)])
def test_chain_kernel_matches_reference(cuda_device, monkeypatch, dt, which,
                                        head):
    tdtype = _DT[dt]
    stages = _qvga_chains(tdtype, cuda_device)[which]
    if head:
        stages = ckp.with_argmax_head(stages, 16)
    cin = int(stages[0].w.shape[2])
    x = _randn(1, (2, 30, 40, cin), tdtype, cuda_device)
    skips = [_randn(2 + i, (2, 30, 40, c), tdtype, cuda_device)
             for i, c in enumerate((64, 128))] if which == "up" else []
    ref = ckp.chain_reference(x, stages, skips)
    outs = {}
    for band in (1, 5, 30):
        monkeypatch.setattr(ckp, "choose_band", lambda n, h, dev: band)
        before = ckp.fused_conv_chain.launches
        outs[band] = ckp.fused_conv_chain(x, stages, skips)
        torch.cuda.synchronize()
        assert ckp.fused_conv_chain.launches == before + 1
    for band in (5, 30):
        for a, b in zip(outs[1], outs[band]):
            assert torch.equal(a, b), band
    assert len(outs[1]) == len(ref)
    for g, r in zip(outs[1], ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        if g.dtype == torch.int32:
            agree = (g == r).float().mean().item()
            assert agree >= (0.999 if dt == "bf16" else 0.9999), agree
        elif dt == "f32":
            torch.testing.assert_close(g, r, rtol=2e-4, atol=2e-4)
        else:
            err = (g.float() - r.float()).abs()
            assert bool((err <= ckp.bf16_tolerance(r)).all()), err.max()


def _feature_chain(case, dt, dev):
    """(x, stages, skips) of a chain that exercises a K2 stage feature, from
    the port's own builders at small sizes: the flagship's folded-stem down
    chain (stem_f) and deep chain at QVGA, PB_FCN's down chain (relu_only,
    and dil on its appended stage), deep chain (dil) and up chain with its
    head at a 128x128 input (packed grid 32x32, deep grid 8x8)."""
    tdtype = _DT[dt]
    if case.startswith("flagship"):
        model = zoo.make("robo_unet", device=dev,
                         generator=torch.Generator().manual_seed(6))
        ch = packed.build_packed_infer(model, None, tdtype, pallas=True,
                                       pallas_fold_stem=True, pallas_deep=True,
                                       device=dev).chains
        if case == "flagship_stem":
            return _randn(20, (2, 120, 160, 3), tdtype, dev), ch["down"], []
        return _randn(21, (2, 8, 10, 64), tdtype, dev), ch["deep"], []
    model = zoo.make("pb_fcn", no_scale=True, device=dev,
                     generator=torch.Generator().manual_seed(7))
    ch = packed.build_packed_pb_fcn(model, None, tdtype, pallas=True,
                                    pallas_deep=True, device=dev).chains
    if case == "pb_fcn_down_dil":
        return _randn(22, (2, 32, 32, 48), tdtype, dev), ch["down"], []
    if case == "pb_fcn_down":
        return _randn(22, (2, 32, 32, 48), tdtype, dev), ch["down"][:4], []
    if case == "pb_fcn_deep":
        return _randn(23, (2, 8, 8, 64), tdtype, dev), ch["deep"], []
    skips = [_randn(25 + i, (2, 32, 32, c), tdtype, dev)
             for i, c in enumerate((64, 128))]
    return (_randn(24, (2, 32, 32, 32), tdtype, dev),
            ckp.with_argmax_head(ch["up"], 16), skips)


def _assert_chain_close(got, ref, dt):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        if g.dtype == torch.int32:
            agree = (g == r).float().mean().item()
            assert agree >= (0.999 if dt == "bf16" else 0.9999), agree
        elif dt == "f32":
            torch.testing.assert_close(g, r, rtol=2e-4, atol=2e-4)
        else:
            err = (g.float() - r.float()).abs()
            assert bool((err <= ckp.bf16_tolerance(r)).all()), err.max()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["flagship_stem", "flagship_deep",
                                  "pb_fcn_down", "pb_fcn_down_dil",
                                  "pb_fcn_deep", "pb_fcn_up_head"])
def test_chain_kernel_stage_features_match_reference(cuda_device, dt, case):
    """stem_f, dil and relu_only stages on the card against chain_reference."""
    x, stages, skips = _feature_chain(case, dt, cuda_device)
    before = ckp.fused_conv_chain.launches
    got = ckp.fused_conv_chain(x, stages, skips)
    torch.cuda.synchronize()
    assert ckp.fused_conv_chain.launches == before + 1
    _assert_chain_close(got, ckp.chain_reference(x, stages, skips), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("case,bands", [("flagship_stem", (1, 5, 30)),
                                        ("pb_fcn_deep", (1, 2, 8)),
                                        ("pb_fcn_down_dil", (1, 4, 32))])
def test_chain_kernel_band_sweep_new_features(cuda_device, monkeypatch, case,
                                              bands):
    """Every band gives bit-identical results on a stem_f chain and on
    dil=2 chains (their halos are deeper: reach = dil * (K // 2))."""
    x, stages, skips = _feature_chain(case, "bf16", cuda_device)
    outs = []
    for band in bands:
        monkeypatch.setattr(ckp, "choose_band", lambda n, h, dev: band)
        outs.append(ckp.fused_conv_chain(x, stages, skips))
    torch.cuda.synchronize()
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    _assert_chain_close(outs[0], ckp.chain_reference(x, stages, skips), "bf16")


def _skip_w_chain(case, dt, dev):
    """(x, stages, skips) of a chain with a skip_w stage: LabelProp's up
    chain at planes=32 on its 30x40 grid (upConv2 + skip 0, upConv3, the
    classifier with its (1, 1, 128, 80) skip kernel over skip 1), with or
    without the argmax head, or a synthetic chain whose middle stage adds
    a 3x3 conv of a 24-wide skip to its 16-wide conv (the v2 split
    concat's form) on a 30x20 grid."""
    tdtype = _DT[dt]
    if case.startswith("lp_up"):
        model = zoo.make("label_prop", device=dev,
                         generator=torch.Generator().manual_seed(8))
        up = packed.build_packed_label_prop(model, None, tdtype, pallas=True,
                                            device=dev).chains["up"]
        if case == "lp_up_head":
            up = ckp.with_argmax_head(up, 16)
        skips = [_randn(31 + i, (2, 30, 40, c), tdtype, dev)
                 for i, c in enumerate((64, 128))]
        return _randn(30, (2, 30, 40, 16), tdtype, dev), up, skips

    def w(seed, *shape):
        return (_randn(seed, shape, torch.float32, dev) * 0.2).to(tdtype)

    def v(seed, c):
        return _randn(seed, (c,), torch.float32, dev) * 0.1

    stages = [ckp.ChainStage(w=w(40, 3, 3, 8, 16), b=v(41, 16),
                             scale=1 + v(42, 16), shift=v(43, 16), rbb=False),
              ckp.ChainStage(w=w(44, 3, 3, 16, 16), b=v(45, 16),
                             scale=1 + v(46, 16), shift=v(47, 16), skip_idx=0,
                             skip_w=w(48, 3, 3, 24, 16), emit=True),
              ckp.ChainStage(w=w(49, 1, 1, 16, 8), b=v(50, 8))]
    return (_randn(51, (2, 30, 20, 8), tdtype, dev), stages,
            [_randn(52, (2, 30, 20, 24), tdtype, dev)])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["lp_up", "lp_up_head", "skip_w3"])
def test_chain_kernel_skip_w_matches_reference(cuda_device, monkeypatch, dt,
                                               case):
    """skip_w stages, K = 1 (LabelProp's classifier) and K = 3, against
    chain_reference; bands 1, 5 and 30 give bit-identical outputs."""
    x, stages, skips = _skip_w_chain(case, dt, cuda_device)
    outs = []
    for band in (1, 5, 30):
        monkeypatch.setattr(ckp, "choose_band", lambda n, h, dev: band)
        before = ckp.fused_conv_chain.launches
        outs.append(ckp.fused_conv_chain(x, stages, skips))
        torch.cuda.synchronize()
        assert ckp.fused_conv_chain.launches == before + 1
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    _assert_chain_close(outs[0], ckp.chain_reference(x, stages, skips), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lp_up", "skip_w3"])
def test_chain_kernel_rejects_wrong_skip_widths(cuda_device, case):
    """A conv'd skip must be as wide as its kernel's Cin (not the stage's
    Cout); an identity skip as wide as the stage's Cout."""
    x, stages, skips = _skip_w_chain(case, "f32", cuda_device)
    cout = int(stages[-1 if case == "lp_up" else 1].w.shape[3])
    conv_skip = skips[-1]
    for bad in (conv_skip[..., :-8].contiguous(),       # narrower than Cin
                conv_skip[..., :cout].contiguous()):    # the stage's Cout
        with pytest.raises(ValueError, match="channels wide"):
            ckp.fused_conv_chain(x, stages, skips[:-1] + [bad])
    if case == "lp_up":  # skip 0 is upConv2's identity skip
        with pytest.raises(ValueError, match="channels wide"):
            ckp.fused_conv_chain(x, stages,
                                 [skips[0][..., :-8].contiguous(), skips[1]])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_chain_kernel_takes_unaligned_weight_views(cuda_device, dt):
    """A kernel that is a view at an offset not a multiple of 16 bytes is
    copied before the launch, not read with misaligned vector loads."""
    tdtype = _DT[dt]
    flat = _randn(9, (1 + 3 * 3 * 8 * 8,), tdtype, cuda_device)
    w = flat[1:].view(3, 3, 8, 8)
    assert w.data_ptr() % 16 != 0
    st = ckp.ChainStage(w=w, b=_randn(10, (8,), torch.float32, cuda_device),
                        scale=_randn(11, (8,), torch.float32, cuda_device),
                        shift=_randn(12, (8,), torch.float32, cuda_device))
    x = _randn(13, (1, 12, 16, 8), tdtype, cuda_device)
    got = ckp.fused_conv_chain(x, [st])[0]
    ref = ckp.chain_reference(x, [st])[0]
    torch.cuda.synchronize()
    tol = ckp.bf16_tolerance(ref) if dt == "bf16" else 2e-4 * (1 + ref.abs())
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_do_not_take(cuda_device,
                                                      monkeypatch):
    p = torch.zeros((1, 8, 8), dtype=torch.float32, device=cuda_device)
    with pytest.raises(TypeError):
        confusion_count(p, p, 5)
    lab = torch.zeros((1, 8, 8), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        confusion_count(lab, lab, 17)
    big = torch.zeros((65536, 1, 1), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(RuntimeError):  # the kernel's grid holds 65535 images
        confusion_count(big, big, 5)
    assert torch.equal(confusion_count(lab, lab, 6).cpu()[0, 0, 0],
                       torch.tensor(64.0))  # the workspace is zero again
    st = ckp.ChainStage(w=torch.zeros(3, 3, 4, 4, device=cuda_device),
                        b=torch.zeros(4, device=cuda_device))
    with pytest.raises(TypeError):
        ckp.fused_conv_chain(torch.zeros(1, 8, 8, 4, dtype=torch.float16,
                                         device=cuda_device), [st])
    monkeypatch.setattr(ckp, "choose_band", lambda n, h, dev: 3)
    with pytest.raises(ValueError):
        ckp.fused_conv_chain(torch.zeros(1, 8, 8, 4, device=cuda_device), [st])


def _pool_stage(f_in, c, tdtype, dev, **kw):
    return packed._pool_chain_stage(f_in, c, tdtype, dev, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["builder", "from_stack"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("f_in,c", [(4, 8), (2, 16)])
def test_pool_stage_is_packed_max_pool(cuda_device, monkeypatch, dt, f_in, c,
                                       table):
    """A pool-only chain (the pool as stage 0, reading the chain input) is
    bit-identical to packed_max_pool at bands 1, 5 and 30, with the
    builder's table of source lanes or the one the wrapper derives from
    the selection stack alone."""
    tdtype = _DT[dt]
    x = _randn(60 + f_in, (2, 30, 40, f_in * f_in * c), tdtype, cuda_device)
    want = packed.packed_max_pool(x, f_in)
    st = _pool_stage(f_in, c, tdtype, cuda_device)
    if table == "from_stack":
        st = dataclasses.replace(st, pool_src=None)
    for band in (1, 5, 30):
        monkeypatch.setattr(ckp, "choose_band", lambda n, h, dev: band)
        before = ckp.fused_conv_chain.launches
        got = ckp.fused_conv_chain(x, [st])
        torch.cuda.synchronize()
        assert ckp.fused_conv_chain.launches == before + 1
        assert got[0].dtype == tdtype and torch.equal(got[0], want), band


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pool_stage_mid_chain(cuda_device, monkeypatch, dt):
    """conv -> pool -> conv: the pool's emitted output is packed_max_pool
    of the kernel's own emitted conv output, bit for bit, at every band,
    and the chain agrees with chain_reference."""
    tdtype = _DT[dt]

    def v(seed, n):
        return _randn(seed, (n,), torch.float32, cuda_device) * 0.1

    w1 = (_randn(70, (3, 3, 32, 64), torch.float32, cuda_device) * 0.2).to(tdtype)
    w2 = (_randn(71, (3, 3, 16, 24), torch.float32, cuda_device) * 0.2).to(tdtype)
    stages = [ckp.ChainStage(w=w1, b=v(72, 64), scale=1 + v(73, 64),
                             shift=v(74, 64), emit=True),
              _pool_stage(2, 16, tdtype, cuda_device, emit=True),
              ckp.ChainStage(w=w2, b=v(75, 24), scale=1 + v(76, 24),
                             shift=v(77, 24), rbb=False)]
    x = _randn(78, (2, 30, 40, 32), tdtype, cuda_device)
    outs = []
    for band in (1, 5, 30):
        monkeypatch.setattr(ckp, "choose_band", lambda n, h, dev: band)
        outs.append(ckp.fused_conv_chain(x, stages))
        torch.cuda.synchronize()
        assert torch.equal(outs[-1][1], packed.packed_max_pool(outs[-1][0], 2))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    _assert_chain_close(outs[0], ckp.chain_reference(x, stages), dt)


def _variant_chain(case, dt, dev):
    """(x, stages, skips) of the --UNet and --v2 chains from the port's
    builder at QVGA: the --UNet folded-stem down chain (stem, Level0.Conv1,
    pool, two convs, pool, two convs: 8 stages), the --v2 deep chain (9
    stages) and the --v2 up chain, whose last two stages add their concat
    skip through a 3x3 skip_w kernel (the head with the argmax)."""
    tdtype = _DT[dt]
    if case == "unet_down":
        model = zoo.make("robo_unet", device=dev, pool=True, levels=3,
                         belly_size=0, generator=torch.Generator().manual_seed(9))
        ch = packed.build_packed_infer(model, None, tdtype, pallas=True,
                                       pallas_fold_stem=True, device=dev).chains
        return _randn(80, (2, 120, 160, 3), tdtype, dev), ch["down"], []
    model = zoo.make("robo_unet", device=dev, v2=True, levels=1, belly_size=9,
                     class_size=3, belly_planes=64,
                     generator=torch.Generator().manual_seed(10))
    ch = packed.build_packed_infer(model, None, tdtype, pallas=True,
                                   pallas_fold_stem=True, pallas_deep=True,
                                   device=dev).chains
    if case == "v2_deep":
        return _randn(81, (2, 8, 10, 64), tdtype, dev), ch["deep"], []
    up = ckp.with_argmax_head(ch["up"], 16) if case == "v2_up_head" else ch["up"]
    skips = [_randn(82 + i, (2, 30, 40, c), tdtype, dev)
             for i, c in enumerate((64, 128))]
    return _randn(84, (2, 30, 40, 64), tdtype, dev), up, skips


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["unet_down", "v2_deep", "v2_up",
                                  "v2_up_head"])
def test_chain_kernel_variants_match_reference(cuda_device, monkeypatch, dt,
                                               case):
    """The --UNet and --v2 chains (pool stages, a 9-stage chain, a 3x3 head
    with a 3x3 skip_w and the argmax) against chain_reference; bands 1 and
    2 bit-identical."""
    x, stages, skips = _variant_chain(case, dt, cuda_device)
    outs = []
    for band in (1, 2):
        monkeypatch.setattr(ckp, "choose_band", lambda n, h, dev: band)
        before = ckp.fused_conv_chain.launches
        outs.append(ckp.fused_conv_chain(x, stages, skips))
        torch.cuda.synchronize()
        assert ckp.fused_conv_chain.launches == before + 1
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    _assert_chain_close(outs[0], ckp.chain_reference(x, stages, skips), dt)


# ---------------------------------------------------------------------------
# int8 stages
# ---------------------------------------------------------------------------


def _dyadic(seed, shape, denom, dev, dtype):
    """Values k / denom, |k| <= 8: exact in bf16, and every sum of their
    products exact in f32 in any order (a skip conv then matches cuDNN's
    bit for bit)."""
    k = np.random.default_rng(seed).integers(-8, 9, shape).astype(np.float32)
    return torch.from_numpy(k / denom).to(device=dev, dtype=dtype)


def _int8_case(case, dt, dev):
    """(x, float stages, skips) of one int8 test chain. Single stages, one
    per feature: 3x3 (rbb affine), 1x1, dilated relu-only, the folded stem,
    a 1x1 and a 3x3 skip_w (dyadic skips and skip kernels), a pool, the
    argmax head; and chains: the 3-stage case of the JAX package's int8
    test (identity skip, dilation, requantization between stages), the
    --UNet down chain (two pools), the --v2 up chain with its head (3x3
    skip_w) and LabelProp's up chain (1x1 skip_w)."""
    tdtype = _DT[dt]

    def w(seed, *shape):
        return (_randn(seed, shape, torch.float32, dev) * 0.2).to(tdtype)

    def v(seed, c):
        return _randn(seed, (c,), torch.float32, dev) * 0.1

    def conv(seed, k, cin, cout, **kw):
        return ckp.ChainStage(w=w(seed, k, k, cin, cout), b=v(seed + 1, cout),
                              scale=1 + v(seed + 2, cout),
                              shift=v(seed + 3, cout), **kw)

    x16 = _randn(90, (2, 30, 40, 16), tdtype, dev)
    if case == "conv3x3":
        return x16, [conv(100, 3, 16, 32)], []
    if case == "conv1x1":
        return x16, [conv(104, 1, 16, 24, rbb=False)], []
    if case == "dil":
        return x16, [ckp.ChainStage(w=w(108, 3, 3, 16, 16), b=v(109, 16),
                                    relu_only=True, dil=2)], []
    if case == "stem_f":
        st = _feature_chain("flagship_stem", dt, dev)[1][0]
        return _randn(91, (2, 120, 160, 3), tdtype, dev), [st], []
    if case in ("skip_w1", "skip_w3"):
        k = int(case[-1])
        st = conv(110, k, 16, 16, skip_idx=0,
                  skip_w=_dyadic(114, (k, k, 24, 16), 64, dev, tdtype))
        return x16, [st], [_dyadic(115, (2, 30, 40, 24), 8, dev, tdtype)]
    if case == "pool":
        return (_randn(92, (2, 30, 40, 128), tdtype, dev),
                [_pool_stage(4, 8, tdtype, dev)], [])
    if case == "argmax":
        return x16, ckp.with_argmax_head(
            [ckp.ChainStage(w=w(116, 1, 1, 16, 80), b=v(117, 80))], 16), []
    if case == "three_stage":
        stages = [conv(120, 3, 16, 16, emit=True),
                  ckp.ChainStage(w=w(124, 3, 3, 16, 16), b=v(125, 16),
                                 relu_only=True, dil=2, skip_idx=0),
                  ckp.ChainStage(w=w(126, 1, 1, 16, 16), b=v(127, 16))]
        return x16, stages, [_randn(93, (2, 30, 40, 16), tdtype, dev)]
    if case == "unet_down":
        return _variant_chain("unet_down", dt, dev)
    if case == "v2_up_head":
        return _variant_chain("v2_up_head", dt, dev)
    return _skip_w_chain("lp_up_head", dt, dev)


_INT8_SINGLE = ["conv3x3", "conv1x1", "dil", "stem_f", "skip_w1", "skip_w3",
                "pool", "argmax"]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", _INT8_SINGLE + ["three_stage", "unet_down",
                                                 "v2_up_head", "lp_up_head"])
def test_int8_chain_kernel_matches_reference(cuda_device, monkeypatch, dt,
                                             case):
    """An int8 chain, calibrated through the kernel (chain_stats) and
    quantized, against the int8 chain_reference: bands 1, 2 and 5
    bit-identical; a chain without a skip_w stage equal (every f32 step is
    the reference's); with one (the reference sums the float skip conv in
    the kernel's order), labels equal, a single stage within 1e-6 of
    max|ref|, and every element of a longer chain within the JAX
    package's int8 gate (rtol = atol = 1e-5 in f32, bf16_tolerance in
    bf16; int8_mismatch counts the elements outside it)."""
    x, stages, skips = _int8_case(case, dt, cuda_device)
    _, stats = ckp.chain_stats(x, stages, skips)
    qst = ckp.quantize_chain_stages(stages, stats)
    outs = []
    for band in (1, 2, 5):
        monkeypatch.setattr(ckp, "choose_band", lambda n, h, dev: band)
        before = ckp.fused_conv_chain.launches
        outs.append(ckp.fused_conv_chain(x, qst, skips))
        torch.cuda.synchronize()
        assert ckp.fused_conv_chain.launches == before + 1
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    ref = ckp.chain_reference(x, qst, skips)
    assert len(outs[0]) == len(ref)
    exact = all(st.skip_w is None for st in qst)
    for g, r, step in zip(outs[0], ref, ckp.int8_output_steps(qst)):
        assert g.dtype == r.dtype and g.shape == r.shape
        if exact:
            assert torch.equal(g, r)
        elif g.dtype == torch.int32:
            assert torch.equal(g, r)
        elif case in _INT8_SINGLE:
            err = (g.float() - r.float()).abs().max().item()
            assert err <= 1e-6 * r.float().abs().max().item(), err
        else:
            frac, worst = ckp.int8_mismatch(g, r, step)
            assert frac == 0, (frac, worst)


@pytest.mark.cuda
def test_int8_chain_kernel_takes_unaligned_weight_views(cuda_device):
    """int8 kernels and w_scale rows that are views at odd offsets are
    copied before the launch."""
    x, stages, _ = _int8_case("conv3x3", "f32", cuda_device)
    _, stats = ckp.chain_stats(x, stages)
    st = ckp.quantize_chain_stages(stages, stats)[0]
    flat = torch.zeros(1 + st.w.numel(), dtype=torch.int8, device=cuda_device)
    flat[1:] = st.w.flatten()
    fs = torch.zeros(1 + st.w_scale.numel(), device=cuda_device)
    fs[1:] = st.w_scale
    odd = dataclasses.replace(st, w=flat[1:].view(st.w.shape), w_scale=fs[1:])
    assert odd.w.data_ptr() % 16 != 0 and odd.w_scale.data_ptr() % 16 != 0
    got = ckp.fused_conv_chain(x, [odd])[0]
    torch.cuda.synchronize()
    assert torch.equal(got, ckp.fused_conv_chain(x, [st])[0])
    ref = ckp.chain_reference(x, [st])[0]
    assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["three_stage", "unet_down", "lp_up_head"])
@pytest.mark.parametrize("pct", [None, 99.9])
def test_calibration_through_kernel_matches_reference(cuda_device, dt, case,
                                                      pct):
    """chain_stats through K2 (every stage emitted) against the same
    statistics of chain_reference's outputs; the chain's own outputs come
    back unchanged. The kernel's float outputs differ from the reference's
    by f32 reassociation (two bf16 ulps in bf16), so the statistics agree
    to that."""
    x, stages, skips = _int8_case(case, dt, cuda_device)
    before = ckp.chain_reference.calls
    outs, stats = ckp.chain_stats(x, stages, skips, pct=pct)
    assert ckp.chain_reference.calls == before
    emitted = [dataclasses.replace(st, emit=True) for st in stages]
    ref_outs = ckp.chain_reference(x, emitted, skips)
    want = [ckp._abs_stat(t, pct) for t in [x] + ref_outs[:-1]]
    np.testing.assert_allclose(stats, want,
                               rtol=2e-4 if dt == "f32" else 2 ** -7)
    direct = ckp.fused_conv_chain(x, stages, skips)
    assert len(outs) == len(direct)
    for a, b in zip(outs, direct):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("relu_before_bn", [True, False])
@pytest.mark.parametrize("shape,tile", [((24, 40, 16, 48), 8),
                                        ((16, 33, 20, 40), 16),
                                        ((12, 70, 3, 5), 4),
                                        ((20, 48, 24, 40), 4),
                                        ((40, 64, 16, 32), 10)])
def test_conv_block_kernel_matches_plain(cuda_device, dt, relu_before_bn,
                                         shape, tile):
    """K3 against its plain version: f32 within rtol = atol = 1e-5, bf16
    within ``conv_block_bf16_tolerance`` (one bf16 ulp); widths that are
    not multiples of the kernel's 32 columns, 32 output channels or 16
    input channels (24 -> 40: not of 16 either; 3 -> 5 and 20 -> 40: not
    of 8, so the bf16 kernel stages them without 16-byte copies), and row
    tiles of 4, 8, 10 (a partial pass of its eight rows) and 16."""
    from robocupvision_tpu_torch.ops.cuda_kernels import (
        conv_block_bf16_tolerance, fused_conv3x3_block,
        fused_conv3x3_block_plain)

    h, w, c, co = shape
    x = _randn(31, (1, h, w, c), _DT[dt], cuda_device)
    wk = _randn(32, (3, 3, c, co), torch.float32, cuda_device) * 0.2
    b, sh = (_randn(s, (co,), torch.float32, cuda_device) for s in (33, 34))
    sc = _randn(35, (co,), torch.float32, cuda_device).abs() + 0.5
    before = fused_conv3x3_block.launches
    got = fused_conv3x3_block(x, wk, b, sc, sh, relu_before_bn, tile)
    torch.cuda.synchronize()
    assert fused_conv3x3_block.launches == before + 1
    assert got.dtype == x.dtype and got.shape == (1, h, w, co)
    ref = fused_conv3x3_block_plain(x, wk, b, sc, sh, relu_before_bn)
    if dt == "f32":
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        err = (got.float() - ref.float()).abs()
        assert bool((err <= conv_block_bf16_tolerance(ref)).all())


@pytest.mark.cuda
def test_conv_block_kernel_rejects_what_it_does_not_take(cuda_device):
    from robocupvision_tpu_torch.ops.cuda_kernels import fused_conv3x3_block

    x = torch.zeros((1, 8, 8, 4), device=cuda_device)
    w = torch.zeros((3, 3, 4, 4), device=cuda_device)
    v = torch.zeros(4, device=cuda_device)
    with pytest.raises(TypeError):
        fused_conv3x3_block(x.half(), w, v, v, v)
    with pytest.raises(ValueError):
        fused_conv3x3_block(x.transpose(1, 2), w, v, v, v)
    with pytest.raises(ValueError):
        fused_conv3x3_block(x, w.cpu(), v, v, v)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(24))  # chip_smoke.FUZZ_SEEDS
def test_chain_kernel_fuzz_matches_reference(cuda_device, monkeypatch, seed):
    """K2 on a random chain (chip_smoke.fuzz_chain: K in {1, 3}, dil in {1,
    2}, every epilogue, identity and skip_w skips, stem_f, pool and emits,
    random zero blocks in every kernel, a random band) in bf16, f32 and
    int8 against chain_reference: bf16 per element within
    ``bf16_tolerance``, f32 within rtol = atol = 2e-4, int8 equal without
    a skip_w stage and within rtol = atol = 1e-5 (``bf16_tolerance`` in
    bf16) with one, labels the first maximum of the kernel's own logits
    (themselves held to the reference). The same cases run as
    chip_smoke.py's k2_fuzz phase."""
    import chip_smoke

    cases, band = chip_smoke.fuzz_cases(seed, cuda_device)
    monkeypatch.setattr(ckp, "choose_band", lambda n, h, d: band)
    for dt, (x, stages, skips) in cases.items():
        head = stages[-1].argmax_groups
        logits = [dataclasses.replace(st, argmax_groups=0) for st in stages]
        got = ckp.fused_conv_chain(x, logits, skips)
        ref = ckp.chain_reference(x, logits, skips)
        torch.cuda.synchronize()
        quant = bool(stages[0].x_scale)
        exact = quant and all(st.skip_w is None for st in stages)
        for g, r in zip(got, ref):
            g, r = g.float(), r.float()
            d = (g - r).abs()
            if exact:
                assert torch.equal(g, r), (dt, float(d.max()))
            elif x.dtype == torch.bfloat16:
                assert bool((d <= ckp.bf16_tolerance(r)).all()), \
                    (dt, float(d.max()))
            elif quant:
                assert bool((d <= 1e-5 + 1e-5 * r.abs()).all()), \
                    (dt, float(d.max()))
            else:
                torch.testing.assert_close(g, r, rtol=2e-4, atol=2e-4)
        if head:
            labels = ckp.fused_conv_chain(x, stages, skips)[-1]
            lg = got[-1].float()
            n, h, w, c = lg.shape
            want = torch.argmax(lg.reshape(n, h, w, head, c // head), dim=-1)
            assert torch.equal(labels, want.to(torch.int32))



@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(8, 24), (24, 40), (40, 8), (5, 39),
                                      (39, 77)])  # chip_smoke.WIDTH_PAIRS
def test_bf16_chain_kernel_at_slim_widths(cuda_device, cin, cout):
    """K2 in bf16 at the widths structured pruning gives (8, 24, 40: the
    mma_nt = 8 tap loop and partial 16-channel k chunks; 5, 39, 77: scalar
    loads), every stage kind of chip_smoke.width_chain (rbb, dilated
    bn-relu with an identity skip, relu-only with a 3x3 skip_w, an argmax
    head), against chain_reference within ``bf16_tolerance``, labels >=
    0.999. The same chains run in chip_smoke.py's k2_fuzz phase."""
    import chip_smoke

    x, stages, skips = chip_smoke.width_chain(cin, cout, cuda_device)
    before = ckp.fused_conv_chain.launches
    got = ckp.fused_conv_chain(x, stages, skips)
    torch.cuda.synchronize()
    assert ckp.fused_conv_chain.launches == before + 1
    _assert_chain_close(got, ckp.chain_reference(x, stages, skips), "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("round_to", [8, 1])
def test_chain_kernel_on_slim_flagship(cuda_device, dt, round_to):
    """Every K2 chain of a slim flagship (prune_channels at ratio 0.4, then
    compact) at QVGA, two-chain and full-chain graphs, against
    chain_reference."""
    import chip_smoke

    from robocupvision_tpu_torch.ops import slim

    model = zoo.make("robo_unet", device="cpu",
                     generator=torch.Generator().manual_seed(8))
    masked, _ = slim.prune_channels(model.state_dict(),
                                    slim.channel_groups(model), 0.4,
                                    round_to=round_to, verbose=False)
    state, _ = slim.compact(model, masked)
    model = model.to(cuda_device)
    x = _randn(31, (1, 120, 160, 3), torch.float32, cuda_device)
    for kw in (dict(), dict(pallas_fold_stem=True, pallas_deep=True)):
        pi = packed.build_packed_infer(model, state, _DT[dt], pallas=True,
                                       device=cuda_device, **kw)
        calls = chip_smoke.record_chain_calls(pi, pi.infer, x)
        assert len(calls) == (3 if kw else 2)
        for cx, stages, skips in calls:
            _assert_chain_close(ckp.fused_conv_chain(cx, stages, skips),
                                ckp.chain_reference(cx, stages, skips), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["flagship_stem", "pb_fcn_down_dil",
                                  "pb_fcn_up_head"])
def test_chain_op_is_the_direct_launch(cuda_device, dt, case):
    """K2 through the torch.library op (what an exported graph calls):
    one counted launch a call, bit-identical to the direct launch, and
    against chain_reference at the kernel's tolerance."""
    x, stages, skips = _feature_chain(case, dt, cuda_device)
    stages = ckp.with_tables(stages)
    want = ckp.fused_conv_chain(x, stages, skips)
    before = ckp.fused_conv_chain.launches
    got = ckp.fused_conv_chain_op(x, stages, skips)
    torch.cuda.synchronize()
    assert ckp.fused_conv_chain.launches == before + 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _assert_chain_close(got, ckp.chain_reference(x, stages, skips), dt)


@pytest.mark.cuda
def test_export_serving_round_trip_on_card(cuda_device, tmp_path):
    """A pallas and an int8 PB_FCN artifact traced on the card reload,
    launch K2 once a chain a frame through the op, and label a frame as the
    live graph does, bit for bit."""
    from robocupvision_tpu_torch.export import aot

    model = zoo.make("pb_fcn", planes=8, no_scale=True, device=cuda_device,
                     generator=torch.Generator().manual_seed(3))
    x = _randn(30, (1, 64, 96, 3), torch.float32, cuda_device)
    for int8 in (False, True):
        out = aot.export_serving(str(tmp_path), model, hw=(64, 96),
                                 dtype=torch.float32, pallas=True, int8=int8,
                                 calib_x=x if int8 else None,
                                 fname=f"s{int(int8)}.pt2")
        fn = aot.load_serving(out)
        live = packed.build_packed_pb_fcn(model, None, torch.float32,
                                          pallas=True, device=cuda_device)
        if int8:
            live = packed.quantize_int8(live, x)
        before = ckp.fused_conv_chain.launches
        got = fn(x)
        torch.cuda.synchronize()
        assert ckp.fused_conv_chain.launches == before + 2
        assert torch.equal(got, live.infer_u8(x))


_K4_LABELS = {"i64": torch.int64, "i32": torch.int32, "u8": torch.uint8,
              "none": None}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,labels,jitter", [
    ((24, 48, 64, 3), "i64", True),    # four pixels a thread
    ((24, 48, 64, 3), "i32", True),
    ((24, 48, 64, 3), "u8", True),
    ((48, 32, 32, 3), "none", True),   # classification patches
    ((24, 37, 53, 3), "i32", True),    # odd: a pixel a thread
    ((24, 37, 53, 3), "none", True),
    ((24, 48, 64, 3), "i64", False),   # flips alone
    ((24, 37, 53, 3), "u8", False),
    ((24, 48, 64, 8), "i64", False),   # LabelProp's 8 channels
    ((24, 37, 53, 8), "i32", False),
])
def test_legacy_jitter_kernel_matches_plain(cuda_device, shape, labels,
                                            jitter):
    """K4 through ``legacy_augment_batch`` against
    ``legacy_augment_batch_plain`` with the same draws: every one of the 24
    op orders, each flip on and off, black, white, grey, saturated and
    r == g == max pixels (``chip_smoke.k4_inputs``); images within 2e-5 in
    normalized YUV (exact without the jitter), labels exact."""
    import chip_smoke
    from robocupvision_tpu_torch.ops import color
    from robocupvision_tpu_torch.ops.cuda_kernels import legacy_jitter

    imgs, lab, draws = chip_smoke.k4_inputs(shape, _K4_LABELS[labels], 7,
                                            cuda_device)
    before = legacy_jitter.launches
    got_i, got_l = color.legacy_augment_batch(imgs, lab, draws, jitter)
    torch.cuda.synchronize()
    assert legacy_jitter.launches == before + (2 if jitter else 1)
    want_i, want_l = color.legacy_augment_batch_plain(
        imgs.cpu(), None if lab is None else lab.cpu(),
        {k: v.cpu() for k, v in draws.items()}, jitter)
    if jitter:
        err = float((got_i.cpu() - want_i).abs().max())
        assert err <= chip_smoke.K4_TOL, err
    else:
        assert torch.equal(got_i.cpu(), want_i)
    if lab is None:
        assert got_l is None
    else:
        assert got_l.dtype == lab.dtype and torch.equal(got_l.cpu(), want_l)


@pytest.mark.cuda
def test_legacy_jitter_kernel_takes_drawn_and_strided_draws(cuda_device):
    """The Trainer's own draws (``draw_legacy_augment`` on the card) and a
    mesh rank's strided view of them give what the plain version gives."""
    import chip_smoke
    from robocupvision_tpu_torch.ops import color

    imgs, lab, _ = chip_smoke.k4_inputs((16, 48, 64, 3), torch.int64, 8,
                                        cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    whole = color.draw_legacy_augment(gen, 32)
    for draws in (color.draw_legacy_augment(gen, 16),
                  {k: v[1::2] for k, v in whole.items()}):
        got_i, got_l = color.legacy_augment_batch(imgs, lab, draws)
        want_i, want_l = color.legacy_augment_batch_plain(imgs, lab, draws)
        assert float((got_i - want_i).abs().max()) <= chip_smoke.K4_TOL
        assert torch.equal(got_l, want_l)


@pytest.mark.cuda
def test_legacy_jitter_kernel_rejects_what_it_does_not_take(cuda_device):
    from robocupvision_tpu_torch.ops import color
    from robocupvision_tpu_torch.ops.cuda_kernels import legacy_jitter

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    draws = color.draw_legacy_augment(gen, 2)
    x = torch.zeros((2, 8, 8, 3), device=cuda_device)
    lab = torch.zeros((2, 8, 8), dtype=torch.int64, device=cuda_device)
    before = legacy_jitter.launches
    with pytest.raises(TypeError):
        color.legacy_augment_batch(x.bfloat16(), lab, draws)
    with pytest.raises(ValueError):
        color.legacy_augment_batch(x.transpose(1, 2), lab, draws)
    with pytest.raises(ValueError):
        color.legacy_augment_batch(x, lab.transpose(1, 2), draws)
    with pytest.raises(TypeError):
        color.legacy_augment_batch(x, lab.to(torch.int16), draws)
    with pytest.raises(ValueError):  # the jitter takes 3 channels
        color.legacy_augment_batch(torch.zeros((2, 8, 8, 8),
                                               device=cuda_device), lab, draws)
    with pytest.raises(ValueError):
        color.legacy_augment_batch(x, lab.cpu(), draws)
    with pytest.raises(ValueError):
        legacy_jitter(x.cpu(), lab.cpu(), draws, True,
                      color.LEGACY_JITTER_TABLES)
    with pytest.raises(ValueError):  # the constants in f64
        legacy_jitter(x, lab, draws, True,
                      color.LEGACY_JITTER_TABLES.astype(np.float64))
    assert legacy_jitter.launches == before


# ---- K5: the SegFormer's folded head gather ---------------------------------


def _k5_inputs(n, sizes, d, k, dtype, dev, seed=0):
    """Stage maps of ``sizes`` (the first the output's), standard normal,
    at ``dtype``; b' with sd 0.5 (a ReLU that cuts about half the
    channels); W_pred with sd 1 / sqrt(D); b_pred standard normal."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    ys = [randn(n, *hw, d).to(dtype) for hw in sizes]
    return ys, 0.5 * randn(d), randn(k, d) / d ** 0.5, randn(k)


def _quarter_stages(h, w):
    """The SegFormer's stage sizes from its quarter-resolution (h, w): each
    stage's stride-2 patch embed takes ceil(size / 2)."""
    sizes = [(h, w)]
    for _ in range(3):
        h, w = -(-h // 2), -(-w // 2)
        sizes.append((h, w))
    return sizes


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significant bits) of |x|, 0 where x is 0."""
    r = x.float().abs()
    _, e = torch.frexp(r)
    return torch.where(r > 0, torch.ldexp(torch.ones_like(r), e - 8),
                       torch.zeros_like(r))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case,n,sizes,d,k", [
    ("b32_vga", 32, _quarter_stages(120, 160), 768, 5),   # the cell's batch
    ("odd_61x83", 3, _quarter_stages(61, 83), 768, 5),     # ragged tiles
    ("one_pixel", 2, [(1, 1)] * 4, 768, 5),
    ("narrow", 2, _quarter_stages(13, 37), 8, 5),          # one warp, 2 lanes
    ("classes_19", 2, _quarter_stages(24, 40), 256, 19),   # 3 launches
    ("larger_stages", 2, [(5, 3), (9, 2), (1, 4), (3, 1)], 64, 6),
    # 1,024 channels read from maps twice as wide: the staged columns hold
    # the tile to 4 pixels, fewer than a group of 8
    ("small_tile", 1, [(3, 10)] + [(6, 20)] * 3, 1024, 5),
])
def test_seg_head_kernel_matches_plain(cuda_device, dt, case, n, sizes, d, k):
    """K5 against ``seg_head_plain`` on the same tensors (PyTorch's CUDA
    resize, TF32 off): f32 within 1e-5 of the largest logit (sums of 768
    products in another order), bf16 within two bf16 ulps of each logit
    (both round an f32 sum once; the floor 2**-8 of the largest logit
    covers logits near 0, where the f32 sums' order moves them by more
    than their own ulp)."""
    from robocupvision_tpu_torch.ops.cuda_kernels import (seg_head,
                                                          seg_head_plain)

    ys, bias, w_pred, b_pred = _k5_inputs(n, sizes, d, k, _DT[dt],
                                          cuda_device)
    before = seg_head.launches
    got = seg_head(ys, bias, w_pred, b_pred)
    torch.cuda.synchronize()
    assert seg_head.launches == before + -(-k // 8)
    want = seg_head_plain(ys, bias, w_pred, b_pred)
    assert got.shape == want.shape == (n, *sizes[0], k)
    assert got.dtype == want.dtype == _DT[dt]
    err = (got.float() - want.float()).abs()
    if dt == "f32":
        assert float(err.max()) <= 1e-5 * float(want.abs().max())
    else:
        floor = want.float().abs().clamp_min(
            float(want.float().abs().max()) * 2.0 ** -8)
        assert bool((err <= 2 * bf16_ulp(floor)).all()), float(err.max())


@pytest.mark.cuda
def test_seg_head_kernel_rejects_what_it_does_not_take(cuda_device):
    from robocupvision_tpu_torch.ops.cuda_kernels import seg_head

    ys, bias, w_pred, b_pred = _k5_inputs(2, _quarter_stages(8, 12), 16, 5,
                                          torch.float32, cuda_device)
    before = seg_head.launches

    def call(maps=ys, b=bias, w=w_pred):
        return seg_head(maps, b, w, b_pred)

    with pytest.raises(ValueError):   # device: one map on the CPU
        call([ys[0], ys[1].cpu(), ys[2], ys[3]])
    with pytest.raises(ValueError):   # device: the weights on the CPU
        call(w=w_pred.cpu())
    with pytest.raises(TypeError):    # dtype: f16
        call([y.half() for y in ys])
    with pytest.raises(TypeError):    # dtype: f32 and bf16 mixed
        call([ys[0], ys[1].bfloat16(), ys[2], ys[3]])
    with pytest.raises(ValueError):   # contiguity
        call([ys[0].transpose(1, 2).contiguous().transpose(1, 2), *ys[1:]])
    with pytest.raises(ValueError):   # shape: D not a multiple of 4
        m, b, w, _ = _k5_inputs(2, _quarter_stages(8, 12), 6, 5,
                                torch.float32, cuda_device)
        call(m, b, w)
    with pytest.raises(ValueError):   # shape: D beyond the block
        m, b, w, _ = _k5_inputs(1, [(2, 2)] * 4, 1028, 5, torch.float32,
                                cuda_device)
        call(m, b, w)
    with pytest.raises(ValueError):   # shape: bias
        call(b=bias[:8])
    with pytest.raises(ValueError):   # alignment: a map one channel in
        flat = torch.zeros(ys[0].numel() + 1, device=cuda_device)
        call([flat[1:].view(ys[0].shape), *ys[1:]])
    assert seg_head.launches == before
