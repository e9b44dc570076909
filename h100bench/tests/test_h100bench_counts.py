"""The frozen counts against shapes worked by hand and against a brute
count of the taps that land inside the input."""

import pytest
import torch
import torch.nn.functional as F

from h100bench import core, counts
from h100bench.reference import nets


def family(name):
    return core.load_module("families", core.config(name)["family"])


PLAIN_CONV, PLAIN_TCONV = F.conv2d, F.conv_transpose2d


def brute_taps(c: counts.Conv) -> int:
    """Taps that read the input: an all-ones conv of an all-ones image."""
    x = torch.ones((1, 1, c.h_in, c.w_in), dtype=torch.float64)
    w = torch.ones((1, 1, c.k, c.k), dtype=torch.float64)
    if c.transposed:
        y = PLAIN_TCONV(x, w, stride=2, padding=1, output_padding=1)
    else:
        y = PLAIN_CONV(x, w, stride=c.stride, padding=c.pad, dilation=c.dil)
    assert tuple(y.shape[2:]) == c.out_hw
    return int(y.sum())


@pytest.mark.parametrize("k,stride,pad,dil,h,w", [
    (3, 1, 1, 1, 4, 4), (3, 2, 1, 1, 9, 6), (3, 1, 2, 2, 7, 5),
    (1, 1, 0, 1, 3, 8), (3, 2, 1, 1, 30, 40), (3, 1, 2, 2, 30, 40)])
def test_conv_taps(k, stride, pad, dil, h, w):
    c = counts.Conv("c", 3, 5, k, stride, pad, dil, h, w)
    assert c.macs == brute_taps(c) * 15
    assert c.flops == 2 * c.macs


@pytest.mark.parametrize("h,w", [(2, 2), (3, 5), (30, 40)])
def test_transposed_taps(h, w):
    c = counts.Conv("t", 4, 2, 3, 2, 1, 1, h, w, transposed=True)
    assert c.macs == brute_taps(c) * 8


def test_hand_worked():
    # 3x3, pad 1 on 4x4: 3 + 4 + 3 valid rows per tap row, squared
    assert counts.Conv("c", 1, 1, 3, 1, 1, 1, 4, 4).macs == 100
    # k3/s2 tconv of 2x2 into 4x4: taps 0, 1, 2 reach 1, 2, 2 inputs a row
    assert counts.Conv("t", 1, 1, 3, 2, 1, 1, 2, 2, transposed=True).macs \
        == 25


@pytest.mark.parametrize("name", ["robo_unet_vga", "pb_fcn_vga"])
def test_model_flops_match_the_reference_forward(name, monkeypatch):
    """Every conv the reference forward runs, counted by brute force."""
    cfg = core.config(name)
    seen = []
    plain_conv, plain_tconv = F.conv2d, F.conv_transpose2d

    def conv2d(x, w, b=None, stride=1, padding=0, dilation=1):
        c = counts.Conv("", w.shape[1], w.shape[0], w.shape[-1], stride,
                        padding, dilation, x.shape[2], x.shape[3])
        seen.append(brute_taps(c) * c.cin * c.cout)
        return plain_conv(x, w, b, stride, padding, dilation)

    def tconv(x, w, b=None, stride=2, padding=1, output_padding=1):
        c = counts.Conv("", w.shape[0], w.shape[1], 3, 2, 1, 1, x.shape[2],
                        x.shape[3], transposed=True)
        seen.append(brute_taps(c) * c.cin * c.cout)
        return plain_tconv(x, w, b, stride, padding, output_padding)

    monkeypatch.setattr(nets.F, "conv2d", conv2d)
    monkeypatch.setattr(nets.F, "conv_transpose2d", tconv)
    h, w = 64, 96
    params = {}
    fam = family(name)
    for c in fam.convs(cfg["cfg"], h, w):
        shape = (c.cin, c.cout, c.k, c.k) if c.transposed \
            else (c.cout, c.cin, c.k, c.k)
        params[c.name + ".weight"] = torch.zeros(shape)
        bn = c.name.rsplit(".", 1)[0] + ".bn"
        for s in ("weight", "bias", "running_mean", "running_var"):
            params[f"{bn}.{s}"] = torch.ones(c.cout)
    fam.forward(params, cfg["cfg"], torch.zeros(1, 3, h, w))
    assert 2 * sum(seen) == counts.model_flops(cfg, h, w)


def test_flagship_vga_flops_by_hand():
    """The stem alone by hand: 3 -> 8 channels, 3x3, padding 1 on 480x640:
    (480 + 2 * 479) * (640 + 2 * 639) taps; the whole net about 4.65
    GFLOP a frame."""
    cfg = core.config("robo_unet_vga")
    stem = family("robo_unet_vga").convs(cfg["cfg"], 480, 640)[0]
    assert stem.macs == (480 + 2 * 479) * (640 + 2 * 639) * 3 * 8
    assert 4.6e9 < counts.model_flops(cfg, 480, 640) < 4.7e9


def test_k2_chains_robo_unet_by_hand():
    cfg = core.config("robo_unet_vga")
    chains = {c.tag: c for c in counts.k2_chains(cfg, 1, 64, 96)}
    names = {t: [v.name for v in c.convs] for t, c in chains.items()}
    assert names["down"] == [f"downPart.Level{lv}.layers.Conv{i}.conv"
                             for lv, i in ((0, 0), (1, 0), (1, 1), (2, 0),
                                           (2, 1))]
    assert names["deep"] == ["downPart.Level4.layers.Conv1.conv"] + [
        f"PB.PB_1.layers.Conv{i}.conv" for i in range(4)] + [
        "PB.PB_2.layers.Conv0.conv"]
    assert names["up"] == ["upPart.Up2.conv", "upPart.Up3.conv",
                           "segmenter.layers.Class"]
    up = chains["up"]
    # input 16x24x32, skips 32x48x16 and 64x96x8, all bf16; Up2, Up3
    # kernels bf16 with bias, scale, shift f32; the 1x1 head with its bias
    read = 16 * 24 * 32 * 2 + 32 * 48 * 16 * 2 + 64 * 96 * 8 * 2 \
        + (9 * 32 * 16 * 2 + 3 * 16 * 4) + (9 * 16 * 8 * 2 + 3 * 8 * 4) \
        + (8 * 5 * 2 + 5 * 4)
    assert up.read_bytes == read == 183940
    assert up.write_bytes == 64 * 96 * 4       # int32 labels


def test_k2_chains_hold_no_conv_twice():
    for name in ("robo_unet_vga", "pb_fcn_vga"):
        cfg = core.config(name)
        chains = counts.k2_chains(cfg, 2, 64, 96)
        convs = [c.name for ch in chains for c in ch.convs]
        assert len(convs) == len(set(convs))
        every = {c.name for c in family(name).convs(cfg["cfg"], 64, 96)}
        assert set(convs) <= every
        total = counts.model_flops(cfg, 64, 96)
        assert sum(ch.flops for ch in chains) < total


# (size, forward FLOPs of an image, each K2 chain of a batch of 32 as
# (tag, FLOPs, bytes read, bytes written)): frozen, so that any change to
# the counts shows
PARENT_COUNTS = {
    "robo_unet_vga": [
        ((480, 640), 4650944192, [
            ("down", 1187631552, 59018640, 275251200),
            ("deep", 2041577472, 11609088, 9830400),
            ("up", 377181440, 275263108, 39321600)]),
        ((240, 320), 1136430272, [
            ("down", 295223232, 14781840, 68812800),
            ("deep", 490340352, 4236288, 2457600),
            ("up", 93973760, 68824708, 9830400)])],
    "pb_fcn_vga": [
        ((480, 640), 3868989696, [
            ("down", 1708729344, 118063360, 629145600),
            ("deep", 1307574272, 12196608, 9830400),
            ("up", 377181440, 550525908, 39321600)])],
}


@pytest.mark.parametrize("name,size,flops,chains", [
    pytest.param(name, size, flops, chains, id=f"{name}-{size[0]}x{size[1]}")
    for name, cases in sorted(PARENT_COUNTS.items())
    for size, flops, chains in cases])
def test_counts_are_the_parents(name, size, flops, chains):
    """At the frame and at the training size (PB_FCN trains at its frame
    size): the family's FLOPs and K2 chains, to the integer."""
    cfg = core.config(name)
    assert {tuple(cfg["frame"]), tuple(cfg["train"]["size"])} == {
        s for s, _, _ in PARENT_COUNTS[name]}
    assert counts.model_flops(cfg, *size) == flops
    assert family(name).flops(cfg["cfg"], *size) == flops
    got = [(c.tag, c.flops, c.read_bytes, c.write_bytes)
           for c in counts.k2_chains(cfg, 32, *size)]
    assert got == chains


def test_bound_is_the_larger_side():
    c = counts.Chain("x", (counts.Conv("c", 8, 8, 3, 1, 1, 1, 10, 10),),
                     1000, 500)
    assert c.seconds(1.0, 1e12) == c.flops
    assert c.seconds(1e20, 1.0) == 1500
