"""The port's SegFormer (models/segformer.py) against the plain reference
that the benchmark holds it to (h100bench/families/segformer.py, loaded by
its path), on seeded random weights on the CPU: the zoo forward's logits
and the served graph's labels, at a reduced size and at B2's published
widths; B2's parameter count; the reference's frozen FLOP count; and the
eval-only contract."""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from robocupvision_tpu_torch.models import layers as L
from robocupvision_tpu_torch.models import segformer, zoo

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load(rel: str):
    path = REPO / rel
    spec = importlib.util.spec_from_file_location(
        "plain_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("h100bench/families/segformer.py")
NETS = _load("h100bench/reference/nets.py")   # the reference's camera input

REDUCED = dict(embed_dims=(16, 32, 48, 64), num_heads=(1, 1, 1, 1),
               depths=(2, 1, 1, 1), sr_ratios=(8, 4, 2, 1))
FRAME = (64, 96)
# f32 on the CPU on both sides; the two differ in the order of their sums
# (the library's LayerNorm, attention and resizes against the reference's
# spelled-out ones), a few ulps an op through up to 16 residual blocks:
# measured 1.5e-6 of the largest logit at the reduced size and up to
# 5.9e-6 at B2's widths. 3e-5 leaves 5x room above that. A slip of an op
# fails it: a resize with the other corner rule reads 0.26, the tanh GELU
# 2.4e-4; a LayerNorm eps of 1e-6 for 1e-5 (1.3e-5) it cannot see.
REL_TOL = 3e-5


def draw(cfg: segformer.SegFormerCfg, seed: int) -> zoo.Model:
    """A model with every parameter random: He-normal kernels, biases in
    [-0.1, 0.1), LayerNorm and BatchNorm scales and variances in [0.8,
    1.2)."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for s in segformer.segformer_registry(cfg).specs.values():
        shape = s.torch_shape
        if s.kind in ("conv_w", "lin_w"):
            fan = math.prod(shape[1:])
            params[s.name] = torch.randn(shape, generator=gen) \
                * math.sqrt(2.0 / fan)
        elif s.kind in ("ln_w", "bn_w", "bn_rv"):
            params[s.name] = 0.8 + 0.4 * torch.rand(shape, generator=gen)
        else:
            params[s.name] = 0.2 * torch.rand(shape, generator=gen) - 0.1
    return zoo.Model("segformer", cfg, params)


def reference_cfg(cfg: segformer.SegFormerCfg) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in vars(cfg).items()}


@pytest.fixture(scope="module")
def b2():
    return draw(segformer.SegFormerCfg(), 22)


def frames(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, *FRAME, 3), dtype=np.uint8)


def check_against_reference(model: zoo.Model, u8: np.ndarray):
    x = NETS.camera_input(torch.from_numpy(u8))           # (N, 3, H, W)
    with torch.no_grad():
        ref = REF.forward({k: v.clone() for k, v in model.state_dict()
                           .items()}, reference_cfg(model.cfg), x)
        got = model(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        labels = segformer.build_segformer_infer(
            model, device="cpu").infer_u8_io(u8)
    assert got.shape == ref.shape == (len(u8), 5, *FRAME)
    tol = REL_TOL * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol
    # each logit within tol: the argmax can differ only where the top two
    # lie within 2 tol (and the served input is rounded once more, in f32)
    top2 = ref.topk(2, dim=1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
    assert labels.dtype == torch.uint8 and labels.shape == (len(u8), *FRAME)
    assert sure.float().mean() > 0.99
    assert torch.equal(labels[sure].long(), ref.argmax(dim=1)[sure])


def test_reduced_matches_reference():
    check_against_reference(draw(segformer.SegFormerCfg(**REDUCED), 7),
                            frames(3, 1))


def test_published_widths_match_reference(b2):
    check_against_reference(b2, frames(2, 2))


def test_b2_parameters(b2):
    """27,350,469 learnable parameters at 5 classes, 24,196,288 of them in
    the encoder; the NVlabs state_dict names; no reduction at stage 4."""
    specs = b2.registry.specs.values()
    learn = [s for s in specs if L.is_weight(s.name)]
    assert sum(math.prod(s.torch_shape) for s in learn) == 27_350_469
    assert sum(math.prod(s.torch_shape) for s in learn
               if s.name.startswith("backbone.")) == 24_196_288
    names = set(b2.state_dict())
    assert {"backbone.patch_embed1.proj.weight", "backbone.block1.2.attn.sr"
            ".weight", "backbone.block3.5.mlp.dwconv.dwconv.weight",
            "backbone.norm4.bias", "decode_head.linear_c1.proj.weight",
            "decode_head.linear_fuse.bn.running_var",
            "decode_head.linear_pred.bias"} <= names
    assert "backbone.block4.0.attn.sr.weight" not in names
    assert b2.state_dict()["backbone.block2.0.mlp.dwconv.dwconv.weight"] \
        .shape == (512, 1, 3, 3)


def test_reference_flops_frozen():
    """143.3 GFLOP a VGA frame, the count mfu.label divides by."""
    cfg = reference_cfg(segformer.SegFormerCfg())
    assert REF.flops(cfg, 480, 640) == 143_320_805_760


def test_eval_only():
    model = draw(segformer.SegFormerCfg(**REDUCED), 3)
    x = torch.zeros(1, 32, 32, 3)
    with pytest.raises(ValueError, match="eval mode only"):
        model.apply(model.flat(), x, train=True)
    with pytest.raises(ValueError, match="eval mode only"):
        REF.forward(model.state_dict(), reference_cfg(model.cfg),
                    x.permute(0, 3, 1, 2), train=True)


def test_served_graph_rounds_weights_once():
    model = draw(segformer.SegFormerCfg(**REDUCED), 5)
    pi = segformer.build_segformer_infer(model, dtype=torch.bfloat16,
                                         device="cpu")
    assert {v.dtype for v in pi.params.values()} == {torch.bfloat16}
    assert all(v.dtype == torch.float32 for v in model.state_dict().values())
    labels = pi.infer_u8_io(frames(1, 4))
    assert labels.dtype == torch.uint8 and labels.shape == (1, *FRAME)
