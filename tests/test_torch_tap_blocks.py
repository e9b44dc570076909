"""The tap block lists K2's tap loops walk (ops/cuda_packed.tap_blocks), on
the CPU: for every conv stage the packers build (the flagship full chain
graph, ``--UNet``, ``--v2``, PB_FCN and LabelProp at the small widths of
tests/test_torch_int8.py, float and int8), every block left out of a list
is all zeros and every listed block holds a non-zero, at both
granularities (MMA: (tap, 16-channel chunk) per 16- or 8-wide output tile;
CUDA cores: (tap, channel) per COB-wide group); the listed multiply-adds
lie between the non-zero weights' and the dense kernels'; each stage's
lists were read from the very tensors it holds. Also random kernels with
zeroed blocks, the header hash of csrc/build.py, and stale lists.
Exact: lists are sets of indices."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from robocupvision_tpu_torch.csrc import build
from robocupvision_tpu_torch.models import packed as tpacked
from robocupvision_tpu_torch.models import zoo as tzoo
from robocupvision_tpu_torch.ops import cuda_packed as tppk

# family -> (zoo family, zoo kwargs, input shape, chain-graph flags), as in
# tests/test_torch_int8.py
_FAMILIES = {
    "flagship": ("robo_unet", dict(), (1, 64, 64, 3),
                 dict(pallas_fold_stem=True, pallas_deep=True)),
    "unet": ("robo_unet", dict(pool=True, levels=3, belly_size=0),
             (1, 64, 64, 3), dict(pallas_fold_stem=True)),
    "v2": ("robo_unet", dict(v2=True, levels=1, belly_size=9, belly_planes=64,
                             class_size=3),
           (1, 64, 64, 3), dict(pallas_fold_stem=True, pallas_deep=True)),
    "label_prop": ("label_prop", dict(), (1, 64, 64, 8),
                   dict(pallas_fold_stem=True, pallas_mid=True)),
    "pb_fcn": ("pb_fcn", dict(), (1, 32, 64, 3), dict(pallas_deep=True)),
}
_BUILDERS = {"robo_unet": tpacked.build_packed_infer,
             "label_prop": tpacked.build_packed_label_prop,
             "pb_fcn": tpacked.build_packed_pb_fcn}


def _graph(fam, dtype=torch.float32):
    zfam, kw, shape, flags = _FAMILIES[fam]
    model = tzoo.make(zfam, device="cpu", generator=torch.Generator()
                      .manual_seed(3), **kw)
    pi = _BUILDERS[zfam](model, None, dtype, pallas=True, device="cpu",
                         **flags)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(shape)
                         .astype(np.float32))
    return pi, x


def _conv_stages(chains):
    return [(tag, i, st) for tag, sts in chains.items()
            if isinstance(sts, list) for i, st in enumerate(sts)
            if not st.pool]


def _block_nonzero(k, kind, taps, t, kblk):
    """Whether block (tap, k) of tile/group t of kernel k holds a non-zero."""
    kh, kw, cin, cout = k.shape
    tap, kk = kblk
    gran, width = (16, taps.mma_nt) if kind == "mma" else (1, taps.cob)
    blk = k.reshape(kh * kw, cin, cout)[tap, kk * gran:(kk + 1) * gran,
                                        t * width:(t + 1) * width]
    return bool((blk != 0).any())


def _check_lists(st):
    taps = st.taps
    kerns = [st.w] + ([] if st.skip_w is None else [st.skip_w])
    cout = int(st.w.shape[3])
    # dense: every (tap, channel) row of every group holds a non-zero
    assert taps.dense == all(
        bool((k.reshape(-1, int(k.shape[2]), cout // taps.cob, taps.cob)
              != 0).any(dim=-1).all()) for k in kerns)
    for kind in ("mma", "cc"):
        lists = taps.lists(kind)
        gran, width = (16, taps.mma_nt) if kind == "mma" else (1, taps.cob)
        n = -(-cout // width)
        assert set(lists) == {(t, s) for t in range(n) for s in range(2)}
        for (t, s), blocks in lists.items():
            if s >= len(kerns):
                assert blocks == []
                continue
            k = kerns[s]
            kh, kw, cin, _ = k.shape
            assert blocks == sorted(blocks)  # the dense loop's order
            listed = set(blocks)
            for tap in range(kh * kw):
                for kk in range(-(-int(cin) // gran)):
                    nz = _block_nonzero(k, kind, taps, t, (tap, kk))
                    assert nz == ((tap, kk) in listed), (kind, t, s, tap, kk)


@pytest.mark.parametrize("fam", list(_FAMILIES))
@pytest.mark.parametrize("quant", [False, True])
def test_packer_lists_hold_exactly_the_nonzero_blocks(fam, quant):
    pi, x = _graph(fam)
    if quant:
        pi = tpacked.quantize_int8(pi, x)
    stages = _conv_stages(pi.chains)
    assert stages
    for tag, i, st in stages:
        # built where the stage was built, from the very tensors it holds
        assert st.taps is not None, (tag, i)
        assert st.taps.w is st.w and st.taps.skip_w is st.skip_w, (tag, i)
        assert st.taps.cob == tppk.kernel_cob(
            int(st.w.shape[3]), quant, st.skip_w is not None)
        assert (st.w.dtype == torch.int8) == quant
        assert torch.equal(st.taps.table.cpu(),
                           torch.from_numpy(st.taps.host))
        _check_lists(st)


def _listed_macs(st, kind):
    """Multiply-adds a pixel that the stage's ``kind`` lists ("mma" or
    "cc") walk, counting only weights inside the kernel (chunk padding past
    Cin or Cout is none)."""
    taps = st.taps
    kerns = [st.w] + ([] if st.skip_w is None else [st.skip_w])
    gran, width = (16, taps.mma_nt) if kind == "mma" else (1, taps.cob)
    cout = int(st.w.shape[3])
    total = 0
    for (t, s), blocks in taps.lists(kind).items():
        cin = int(kerns[s].shape[2]) if s < len(kerns) else 0
        n = min(width, cout - t * width)
        total += sum(min(gran, cin - k * gran) * n for _, k in blocks)
    return total


@pytest.mark.parametrize("fam", list(_FAMILIES))
def test_listed_work_lies_between_needed_and_dense(fam):
    """Per pixel: the multiply-adds of the non-zero weights (chain_work's
    ``needed``) <= the listed ones <= the dense kernels' (``dense``); where
    at most a quarter of the weights are non-zero (the packed stages), the
    MMA lists skip at least half of the dense work."""
    pi, _ = _graph(fam)
    tot = {"needed": 0, "mma": 0, "cc": 0, "dense": 0}
    for _, _, st in _conv_stages(pi.chains):
        kerns = [st.w] + ([] if st.skip_w is None else [st.skip_w])
        needed = sum(int(torch.count_nonzero(k)) for k in kerns)
        dense = sum(k.numel() for k in kerns)
        for kind in ("mma", "cc"):
            listed = _listed_macs(st, kind)
            assert needed <= listed <= dense
            tot[kind] += listed
        tot["needed"] += needed
        tot["dense"] += dense
    assert tot["needed"] <= tot["cc"] <= tot["mma"] <= tot["dense"]


def _zeroed_kernel(rng, shape, blocks):
    """Random (KH, KW, Cin, Cout) kernel without zeros, but for the
    (tap, cin slice, cout slice) blocks in ``blocks``."""
    w = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    w *= rng.choice([-1.0, 1.0], shape)
    kh, kw = shape[:2]
    for tap, ci, co in blocks:
        w[tap // kw, tap % kw, ci, co] = 0.0
    return torch.from_numpy(w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_random_zeroed_blocks_give_the_expected_lists(dtype):
    rng = np.random.default_rng(7)
    # Cin 24 (a 16-chunk and a half one), Cout 40 (16-tiles do not divide:
    # 8-wide MMA tiles, COB 8 / int8 COB 8)
    w = _zeroed_kernel(rng, (3, 3, 24, 40), [
        (0, slice(0, 16), slice(0, 8)),     # MMA block (0, 0) of tile 0
        (4, slice(16, 24), slice(32, 40)),  # MMA block (4, 1) of tile 4
        (8, slice(0, 24), slice(8, 16)),    # tap 8 of tile 1, both chunks
        (2, 5, slice(0, 40)),               # CUDA-core row (2, 5), all groups
    ])
    if dtype == torch.int8:
        w = torch.clamp(torch.round(w * 50), -127, 127).to(torch.int8)
    else:
        w = w.to(dtype)
    taps = tppk.tap_blocks(w)
    assert taps.mma_nt == 8
    assert taps.cob == 8
    mma = taps.lists("mma")
    everything = {(tap, k) for tap in range(9) for k in range(2)}
    assert set(mma[(0, 0)]) == everything - {(0, 0)}
    assert set(mma[(4, 0)]) == everything - {(4, 1)}
    assert set(mma[(1, 0)]) == everything - {(8, 0), (8, 1)}
    for t in (2, 3):
        assert set(mma[(t, 0)]) == everything
    assert all(mma[(t, 1)] == [] for t in range(5))
    cc = taps.lists("cc")
    rows = {(tap, ci) for tap in range(9) for ci in range(24)}
    assert set(cc[(0, 0)]) == rows - {(0, ci) for ci in range(16)} - {(2, 5)}
    assert set(cc[(4, 0)]) == rows - {(4, ci) for ci in range(16, 24)} \
        - {(2, 5)}
    assert set(cc[(1, 0)]) == rows - {(8, ci) for ci in range(24)} - {(2, 5)}
    assert set(cc[(2, 0)]) == rows - {(2, 5)}


def test_skip_w_lists_and_dense_stages():
    """A skip_w stage lists both kernels (source 1 the skip kernel, at the
    skip's Cin); a kernel without zero rows is dense."""
    rng = np.random.default_rng(8)
    w = _zeroed_kernel(rng, (1, 1, 32, 16), [(0, slice(16, 32), slice(0, 16))])
    sw = _zeroed_kernel(rng, (3, 3, 12, 16), [(3, slice(0, 12), slice(0, 16))])
    taps = tppk.tap_blocks(w, sw)
    assert taps.mma_nt == 16 and taps.cob == 16
    assert taps.lists("mma") == {(0, 0): [(0, 0)],
                                 (0, 1): [(t, 0) for t in range(9) if t != 3]}
    cc = taps.lists("cc")
    assert cc[(0, 0)] == [(0, ci) for ci in range(16)]
    assert cc[(0, 1)] == [(t, ci) for t in range(9) if t != 3
                          for ci in range(12)]
    assert not taps.dense
    full = tppk.tap_blocks(torch.ones(3, 3, 8, 16))
    assert full.dense
    assert full.lists("cc") == {(0, 0): [(t, ci) for t in range(9)
                                         for ci in range(8)], (0, 1): []}
    assert tppk.kernel_cob(80, True, True) == 4
    assert tppk.kernel_cob(80, True, False) == 8
    assert tppk.kernel_cob(6, False, False) == 1


def test_stale_lists_are_read_again():
    """A stage whose kernel was replaced after its lists were built, or that
    has none, gets lists read from the kernel it holds."""
    w = torch.ones(3, 3, 8, 16)
    st = tppk.ChainStage(w=w, b=torch.zeros(16), taps=tppk.tap_blocks(w))
    assert tppk._taps_of(st) is st.taps
    w2 = w.clone()
    w2[1, 1] = 0.0
    for stale in (dataclasses.replace(st, w=w2),
                  dataclasses.replace(st, w=w2, taps=None)):
        taps = tppk._taps_of(stale)
        assert taps.w is w2
        assert (4, 0) not in taps.lists("mma")[(0, 0)]
        assert taps.lists("mma")[(0, 0)] == [(t, 0) for t in range(9)
                                             if t != 4]
    x = torch.ones(1, 4, 4, 8)
    got = tppk.fused_conv_chain(x, [dataclasses.replace(st, w=w2)])[0]
    assert torch.equal(got, tppk.chain_reference(
        x, [dataclasses.replace(st, w=w2, taps=None)])[0])


def test_library_name_hashes_the_headers(tmp_path, monkeypatch):
    """Editing a header (or the source) gives the library another name, so
    a stale build is never loaded."""
    src = tmp_path / "csrc"
    shutil.copytree(build.SRC_DIR, src,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", src / "build")
    headers = sorted(src.glob("*.cuh"))
    assert [h.name for h in headers] == ["mma_taps.cuh"]
    before = {s: build.lib_path(s) for s in build.SOURCES}
    assert before == {s: build.lib_path(s) for s in build.SOURCES}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {s: build.lib_path(s) for s in build.SOURCES}
    assert all(after[s] != before[s] for s in build.SOURCES)
    (src / "conv_block.cu").write_text((src / "conv_block.cu").read_text()
                                       + "\n")
    assert build.lib_path("conv_block.cu") != after["conv_block.cu"]
    assert build.lib_path("conv_chain.cu") == after["conv_chain.cu"]
