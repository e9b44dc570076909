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
band gives bit-identical results.
"""

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


@pytest.mark.cuda
@pytest.mark.parametrize("c,lo,hi", [(5, 0, 5), (2, 0, 2), (5, -2, 8)])
def test_confusion_kernel_matches_plain(cuda_device, c, lo, hi):
    r = np.random.default_rng(21 + c)
    pred = torch.from_numpy(r.integers(lo, hi, (4, 48, 64)).astype(np.int32))
    tgt = torch.from_numpy(r.integers(lo, hi, (4, 48, 64)))  # int64, cast inside
    p, t = pred.to(cuda_device), tgt.to(cuda_device)
    before = confusion_count.launches
    got = confusion_count(p, t, c)
    torch.cuda.synchronize()
    assert confusion_count.launches == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(got.cpu(), confusion_count_plain(pred, tgt, c))


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
    st = ckp.ChainStage(w=torch.zeros(3, 3, 4, 4, device=cuda_device),
                        b=torch.zeros(4, device=cuda_device))
    with pytest.raises(TypeError):
        ckp.fused_conv_chain(torch.zeros(1, 8, 8, 4, dtype=torch.float16,
                                         device=cuda_device), [st])
    monkeypatch.setattr(ckp, "choose_band", lambda n, h, dev: 3)
    with pytest.raises(ValueError):
        ckp.fused_conv_chain(torch.zeros(1, 8, 8, 4, device=cuda_device), [st])
