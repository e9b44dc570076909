"""The port's confusion counts and segmentation metrics against the JAX
package's, exactly (integer counts in f32): the plain count against
``confusion_matrix_pallas(..., interpret=True)`` and the einsum path,
out-of-range labels and ``sample_mask`` included. The K1 kernel itself is
held against the plain count on the card in tests/test_torch_cuda_kernels.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from robocupvision_tpu.ops import metrics as jmetrics
from robocupvision_tpu.ops.pallas_kernels import confusion_matrix_pallas
from robocupvision_tpu_torch.ops import metrics as tmetrics
from robocupvision_tpu_torch.ops.cuda_kernels import (confusion_count,
                                                      confusion_count_plain)


def _maps(seed, b=3, h=16, w=24, c=5, lo=0, hi=None):
    r = np.random.default_rng(seed)
    hi = c if hi is None else hi
    return (r.integers(lo, hi, (b, h, w)).astype(np.int32),
            r.integers(lo, hi, (b, h, w)).astype(np.int32))


@pytest.mark.parametrize("c,lo,hi", [(5, 0, None), (2, 0, None),
                                     (4, -2, 7)])  # out-of-range labels
def test_plain_confusion_matches_pallas_and_einsum(c, lo, hi):
    pred, tgt = _maps(c + lo, c=c, lo=lo, hi=hi)
    ref = np.asarray(confusion_matrix_pallas(jnp.asarray(pred), jnp.asarray(tgt),
                                             c, interpret=True))
    got = confusion_count_plain(torch.from_numpy(pred), torch.from_numpy(tgt), c)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the wrapper takes the plain path for CPU tensors, int64 maps included
    via = confusion_count(torch.from_numpy(pred).long(), torch.from_numpy(tgt), c)
    np.testing.assert_array_equal(via.numpy(), ref)
    ein = jmetrics.seg_batch_stats(jnp.asarray(pred), jnp.asarray(tgt), c,
                                   impl="einsum").conf
    np.testing.assert_array_equal(got.sum(0).numpy(), np.asarray(ein))


# int64 labels beyond the int32 range: the JAX package casts both maps to
# int32, so such a label counts by its low 32 bits (2**32 + 1 as 1,
# -2**32 + 2 as 2) or, where those read negative (2**31 + 3), not at all
_WIDE_LABELS = np.array([2**32 + 1, 2**31 + 3, -1, 4, -2**32 + 2, 2**33 + 4,
                         2**31, 2**32 - 1], np.int64)


@pytest.mark.parametrize("wide", ["pred", "tgt", "both"])
def test_int64_labels_count_by_their_low_32_bits(wide):
    c = 4
    r = np.random.default_rng(41)
    maps = {k: r.integers(0, c, (3, 16, 24)).astype(np.int64)
            for k in ("pred", "tgt")}
    for k in (("pred", "tgt") if wide == "both" else (wide,)):
        hit = r.random(maps[k].shape) < 0.3
        maps[k][hit] = r.choice(_WIDE_LABELS, int(hit.sum()))
    pred, tgt = maps["pred"], maps["tgt"]
    ref = np.asarray(confusion_matrix_pallas(jnp.asarray(pred), jnp.asarray(tgt),
                                             c, interpret=True))
    assert ref.sum() > 0 and ref.sum() < pred.size  # some counted, some skipped
    jref = jmetrics.seg_batch_stats(jnp.asarray(pred), jnp.asarray(tgt), c,
                                    impl="einsum")
    np.testing.assert_array_equal(ref.sum(0), np.asarray(jref.conf))
    tp, tt = torch.from_numpy(pred), torch.from_numpy(tgt)
    np.testing.assert_array_equal(confusion_count_plain(tp, tt, c).numpy(), ref)
    np.testing.assert_array_equal(confusion_count(tp, tt, c).numpy(), ref)
    got = tmetrics.seg_batch_stats(pred, tgt, c, device="cpu")
    for field in ("conf", "iou_sum", "lab_cnts", "correct", "img_cnt"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(jref, field)), field)


@pytest.mark.parametrize("mask", [None, [1.0, 0.0, 1.0]])
@pytest.mark.parametrize("impl", ["auto", "einsum"])
def test_seg_batch_stats_and_finalize_match_jax(mask, impl):
    pred, tgt = _maps(11, lo=-1, hi=6)
    jm = None if mask is None else jnp.asarray(mask)
    ref = jmetrics.seg_batch_stats(jnp.asarray(pred), jnp.asarray(tgt), 5, jm,
                                   impl="einsum")
    got = tmetrics.seg_batch_stats(pred, tgt, 5, mask, impl=impl, device="cpu")
    for field in ("conf", "iou_sum", "lab_cnts", "correct", "img_cnt"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)), field)
    # host accumulation over two batches, then the reference's printed metrics
    acc_t = tmetrics.SegAccum.zero(5) + tmetrics.seg_batch_stats_host(
        pred, tgt, 5, mask, device="cpu") + tmetrics.seg_batch_stats_host(
        tgt, pred, 5, mask, device="cpu")
    acc_j = jmetrics.SegAccum.zero(5) + jmetrics.seg_batch_stats_host(
        jnp.asarray(pred), jnp.asarray(tgt), 5, jm) + jmetrics.seg_batch_stats_host(
        jnp.asarray(tgt), jnp.asarray(pred), 5, jm)
    fin_t = tmetrics.seg_finalize(acc_t, 1.0 / pred[0].size)
    fin_j = jmetrics.seg_finalize(acc_j, 1.0 / pred[0].size)
    for key in fin_j:
        np.testing.assert_allclose(np.asarray(fin_t[key]), np.asarray(fin_j[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


def test_seg_batch_stats_rejects_unknown_impl():
    pred, tgt = _maps(0)
    with pytest.raises(ValueError):
        tmetrics.seg_batch_stats(pred, tgt, 5, impl="pallas", device="cpu")


@pytest.mark.parametrize("flags", [(False, False, False, False),
                                   (True, False, False, False),
                                   (False, True, True, False),
                                   (True, True, True, True)])
def test_label_tables_match_jax(flags):
    """The class-ablation remap and the palette used when scoring served
    frames (ops/labels.py) equal the JAX package's."""
    from robocupvision_tpu.ops import labels as jlabels
    from robocupvision_tpu_torch.ops import labels as tlabels

    lab = np.random.default_rng(11).integers(0, 5, (2, 6, 7)).astype(np.int32)
    np.testing.assert_array_equal(tlabels.mask_label_table(*flags),
                                  jlabels.mask_label_table(*flags))
    np.testing.assert_array_equal(
        tlabels.mask_label(torch.from_numpy(lab), *flags).numpy(),
        np.asarray(jlabels.mask_label(jnp.asarray(lab), *flags)))
    np.testing.assert_array_equal(tlabels.colorize(lab[0]), jlabels.colorize(lab[0]))
