"""The port's packed flagship graph (robocupvision_tpu_torch.models.packed)
against the JAX package's, on the CPU at f32: the port's
``build_packed_infer(pallas=True)`` (whose chains take the plain path on
CPU tensors) and ``pallas=False`` against JAX's ``pallas=False`` graph and
its ``pallas=True, pallas_interpret=True`` graph, at QVGA and at a small
``no_scale`` input. Weights enter both sides only through the weight carry
(export/torch_io.py). Logits at rtol = atol = 2e-4; labels by
tests/test_pallas_packed.py's rule: at most a 2e-5 mismatch share, and only
where the top-2 logit gap is below 1e-4 (an argmax tie)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robocupvision_tpu.models import packed as jpacked
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu.ops.color import raw_camera_preprocess as jraw_preprocess
from robocupvision_tpu_torch.export import torch_io
from robocupvision_tpu_torch.models import packed as tpacked
from robocupvision_tpu_torch.models import zoo as tzoo


def _assert_labels_match(got, ref, ref_logits, max_mismatch=2e-5):
    got, ref = np.asarray(got).astype(np.int64), np.asarray(ref).astype(np.int64)
    assert got.shape == ref.shape
    mism = got != ref
    frac = float(np.mean(mism))
    assert frac <= max_mismatch, frac
    if frac:
        lg = np.asarray(ref_logits, np.float32)
        gaps = np.abs(np.take_along_axis(lg, got[..., None], -1)
                      - np.take_along_axis(lg, ref[..., None], -1))[mism[..., None]]
        assert np.max(gaps) < 1e-4, np.max(gaps)


def _pair(kw, seed=0):
    jm = jzoo.make("robo_unet", **kw)
    jp = jm.init(jax.random.PRNGKey(seed))
    model = tzoo.make("robo_unet", device="cpu", **kw)
    model.load_state_dict(torch_io.from_jax_params(
        model.registry, {k: np.asarray(v) for k, v in jp.items()}))
    return jm, jp, model


@pytest.mark.parametrize("kw,hw", [(dict(), (120, 160)),
                                   (dict(no_scale=True), (64, 64))])
def test_packed_graph_matches_jax(kw, hw):
    jm, jp, model = _pair(kw)
    r = np.random.default_rng(1)
    x = r.standard_normal((2, *hw, 3)).astype(np.float32)
    x_u8 = r.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    jbase = jpacked.build_packed_infer(jm, jp, dtype=jnp.float32)
    jchain = jpacked.build_packed_infer(jm, jp, dtype=jnp.float32, pallas=True,
                                        pallas_interpret=True)
    ref_logits = np.asarray(jbase.logits(jnp.asarray(x)))
    ref_labels = np.asarray(jbase.infer(jnp.asarray(x)))
    for pallas in (True, False):
        pi = tpacked.build_packed_infer(model, None, torch.float32,
                                        pallas=pallas, device="cpu")
        np.testing.assert_allclose(pi.logits(x).numpy(), ref_logits,
                                   rtol=2e-4, atol=2e-4)
        got = pi.infer(x)
        assert got.dtype == torch.int32
        _assert_labels_match(got, ref_labels, ref_logits)
    # serving forms of the chain graph, against the JAX chain graph
    pi = tpacked.build_packed_infer(model, None, torch.float32, pallas=True,
                                    device="cpu")
    _assert_labels_match(pi.infer(x), jchain.infer(jnp.asarray(x)), ref_logits)
    fn, unpack = pi.infer_u8_packed()
    jfn, junpack = jchain.infer_u8_packed()
    _assert_labels_match(unpack(fn(x)), junpack(jfn(jnp.asarray(x))), ref_logits)
    u8 = pi.infer_u8_io(x_u8)
    assert u8.dtype == torch.uint8
    ref_u8_logits = np.asarray(jbase.logits(
        jraw_preprocess(jnp.asarray(x_u8))))
    _assert_labels_match(u8, jchain.infer_u8_io(jnp.asarray(x_u8)), ref_u8_logits)
    fn4, unpack4 = pi.infer_u4_packed()
    np.testing.assert_array_equal(unpack4(fn4(x)), unpack(fn(x)))


def test_bf16_packed_graph_close_to_jax():
    """bf16 (the serving dtype): logits within bf16 tolerance and labels in
    near-total agreement with the JAX bf16 chain graph."""
    jm, jp, model = _pair(dict(), seed=4)
    x = np.random.default_rng(4).standard_normal((1, 120, 160, 3)).astype(np.float32)
    jchain = jpacked.build_packed_infer(jm, jp, dtype=jnp.bfloat16, pallas=True,
                                        pallas_interpret=True)
    pi = tpacked.build_packed_infer(model, None, torch.bfloat16, pallas=True,
                                    device="cpu")
    np.testing.assert_allclose(pi.logits(x).float().numpy(),
                               np.asarray(jchain.logits(jnp.asarray(x))
                                          .astype(jnp.float32)),
                               rtol=0.05, atol=0.05)
    agree = np.mean(pi.infer(x).numpy() == np.asarray(jchain.infer(jnp.asarray(x))))
    assert agree > 0.999, agree


@pytest.mark.parametrize("args", [
    dict(f_in=4, f_out=2, stride=2), dict(f_in=2, f_out=2),
    dict(f_in=1, f_out=2, transpose=True), dict(f_in=2, f_out=4, transpose=True),
    dict(f_in=4, f_out=4, k=1)])
def test_packers_match_jax(args):
    args = dict(args)
    k = args.pop("k", 3)
    w = np.random.default_rng(2).standard_normal((k, k, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(tpacked.pack_conv_weight(w, **args),
                                  jpacked.pack_conv_weight(w, **args))
    w3 = w if k == 3 else np.random.default_rng(3).standard_normal(
        (3, 3, 3, 5)).astype(np.float32)
    for group in (4, 8):
        np.testing.assert_array_equal(
            tpacked.pack_stem_weight_grouped(w3, 4, group),
            jpacked.pack_stem_weight_grouped(w3, 4, group))


def test_space_to_depth_roundtrip_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 8, 12, 3)).astype(np.float32)
    got = tpacked.space_to_depth(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpacked.space_to_depth(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tpacked.depth_to_space(got, 4).numpy(), x)


def test_unported_build_options_raise():
    model = tzoo.make("robo_unet", device="cpu")
    for kw in (dict(pallas_fold_stem=True), dict(pallas_deep=True)):
        with pytest.raises(NotImplementedError):
            tpacked.build_packed_infer(model, None, torch.float32, pallas=True,
                                       device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        tpacked.quantize_int8(None)
