"""The plain reference against the port, on the CPU at a small size: the
forwards, the camera preprocessing, the augmentations, the loss and the
checked train steps (Adam and SGD). Tolerances are f32 rounding of two
differently ordered computations of the same sums."""

import hashlib

import pytest
import torch

from conftest import small_run
from h100bench import checks, core, program, trainkit
from h100bench.reference import nets
from h100bench.reference import train as ref_train

CELLS = {"robo_unet": "robo_unet_vga.train_b128",
         "pb_fcn": "pb_fcn_vga.train_legacy_b32"}


@pytest.mark.parametrize("family", sorted(CELLS))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_port(family, train, cpu_threads):
    r = small_run(CELLS[family])
    model, w = program.model(r.config, 5, torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 64, 96, 3), generator=gen)
    with torch.no_grad():
        if train:
            got, _ = model.apply(model.flat(), x, train=True, dropout={})
        else:
            got = model(x)
        want = core.load_module("families", family).forward(
            w, r.config["cfg"], x.permute(0, 3, 1, 2), train=train)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-4,
                               atol=1e-4)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()) \
        .hexdigest()


# sha256 of the seeded weights (seed 2**31 + 11, in state_dict order) and
# of the reference's logits on them, eval and train: frozen, so that any
# change to the draws or to the reference's arithmetic shows
PARENT = {
    "robo_unet_vga": (
        "a03c43bd0475d579f2c4ba24414ecef473cf45a801facd62e9eee22c408d363f",
        "22fb3c9bb1c6eb0f057317b086ca6db77c0de821bcb7cd12e344d7d0ddbdd21e",
        "65547deb7fc51ef38be256629c7e6f82b8190cbed0f86e313b39cf859b436704"),
    "pb_fcn_vga": (
        "ee8a674b4bfc1b55503518a5c5a23a2cb1884bf372d352804be38861e874367d",
        "5fa85fe1e34d1ff76a46615b0b8dd56795014afa0cf457c549bd1fd200d2d752",
        "2be5e59d2dfca2c33ccabbf54f5efad4fa90b45ac672870379dd72e60f23e217"),
}


@pytest.mark.parametrize("name", sorted(PARENT))
def test_weights_and_forward_are_the_parents(name, cpu_threads):
    """The same seed draws the same weights, and the family's forward
    gives the same logits, bit for bit. The logits are computed in f64
    and rounded to f32, so that the digest does not hang on the order in
    which a CPU's f32 conv kernels sum."""
    cfg = core.config(name)
    _, w = program.model(cfg, 2 ** 31 + 11, torch.device("cpu"))
    want_w, want_eval, want_train = PARENT[name]
    assert digest(torch.cat([v.reshape(-1) for v in w.values()])) == want_w
    fwd = core.load_module("families", cfg["family"]).forward
    x = torch.randn((2, 3, 32, 48), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(7))
    p64 = {k: v.double() for k, v in w.items()}
    with torch.no_grad():
        for train, want in ((False, want_eval), (True, want_train)):
            y = fwd(p64, cfg["cfg"], x, train=train)
            assert digest(y.float()) == want


def test_camera_input_matches_port():
    from robocupvision_tpu_torch.ops.color import raw_camera_preprocess

    x = torch.randint(0, 256, (2, 8, 12, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(nets.camera_input(x).permute(0, 2, 3, 1),
                               raw_camera_preprocess(x), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["ssyuv", "legacy"])
def test_augmentation_matches_port(mode):
    from robocupvision_tpu_torch.ops import color

    gen = torch.Generator().manual_seed(3)
    imgs = torch.randn((6, 16, 20, 3), generator=gen) * 0.6
    labels = torch.randint(0, 5, (6, 16, 20), generator=gen)
    d = ref_train.DRAWS[mode](gen, 6)
    _, apply = color.AUGMENT_MODES[mode]
    got_i, got_l = apply(imgs, labels, d, True)
    want_i, want_l = ref_train.AUGMENTS[mode](imgs, labels, d)
    torch.testing.assert_close(got_i, want_i, rtol=1e-4, atol=1e-4)
    assert torch.equal(got_l, want_l)


def test_loss_matches_port():
    from robocupvision_tpu_torch.ops import losses

    gen = torch.Generator().manual_seed(4)
    logits = torch.randn((2, 8, 10, 5), generator=gen)
    t = torch.randint(0, 5, (2, 8, 10), generator=gen)
    w = (1, 10, 30, 10, 2)
    torch.testing.assert_close(
        losses.cross_entropy_2d(logits, t,
                                torch.tensor(w, dtype=torch.float32)),
        ref_train.ce2d(logits.permute(0, 3, 1, 2), t, w), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_checked_steps_match_port(cell, cpu_threads):
    """The program's checked steps against the reference's: each number
    far under its limit on the CPU, and K1's counts (the plain count on
    the CPU) exact."""
    r = small_run(cell)
    kit = trainkit.Kit(r)
    kit.warm_up()
    kit.release()
    ref = kit.reference_side()
    first = kit.side["losses"][0]
    assert abs(first - ref["losses"][0]) <= 1e-5 * abs(ref["losses"][0])
    # at 32x48 the deepest BatchNorms see a few pixels, and Adam moves a
    # leaf whose gradient is rounding noise by its whole step: the later
    # steps and the worst leaf drift further than the first loss
    gaps = kit.gaps(kit.side, ref)
    assert gaps["loss_gap"] < 1e-3
    assert gaps["grad_gap"] < 1e-2
    assert gaps["change_gap"] < 0.1
    assert checks.k1_count_gap(kit.evals) == 0.0
    assert len(kit.side["losses"]) == r.traffic["check_steps"]


def test_half_batch_fault_reads_high(cpu_threads):
    """Half of each batch left out, the mean over the rest: the loss and
    the first gradient move far past rounding."""
    r = small_run("pb_fcn_vga.train_legacy_b32")
    kit = trainkit.Kit(r)
    kit.warm_up()
    kit.release()
    ref = kit.reference_side()
    gaps = kit.gaps(kit.reference_side(half=True), ref)
    assert gaps["loss_gap"] > 1e-3 or gaps["grad_gap"] > 1e-2


def test_logit_gap():
    logits = torch.tensor([[[[2.0]], [[0.5]], [[1.0]]]])   # (1, 3, 1, 1)
    assert checks.logit_gap(logits, torch.tensor([[[0]]])) == 0.0
    assert checks.logit_gap(logits, torch.tensor([[[2]]])) == 1.0
    assert checks.logit_gap(logits, torch.tensor([[[7]]])) == float("inf")


def test_worst_leaf_gap_uses_median_floor():
    prog = {"a": 1.0, "b": 2.0, "c": 1e-9}
    ref = {"a": 1.0, "b": 1.0, "c": 0.0}
    # c is measured against the median leaf's norm (1.0), not its own 0
    assert checks.worst_leaf_gap(prog, ref, ref) == 1.0
    assert checks.counted_leaves({"a": 1.0, "b": 1.0, "c": 1e-4}) == ["a", "b"]


def test_sub_seeds_differ_and_take_large_seeds():
    seeds = {core.sub_seed(2 ** 31 + 5, k) for k in range(4)}
    assert len(seeds) == 4 and all(0 <= s < 2 ** 63 for s in seeds)
