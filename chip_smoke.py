"""Drive the PyTorch port's serving, evaluation and training paths once
on an NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in robocupvision_tpu_torch/csrc,
holds each kernel against its plain PyTorch version at the shapes the
paths give it, and drives each main path at full width, with
the launch counters set to 0 just before it and read just after:
  - the flagship ROBO-UNet's two-chain packed graph
    (``build_packed_infer(..., torch.bfloat16, pallas=True)``), VGA frames
    through ``ServingPipeline``, scored by the confusion-count kernel;
  - the same with the full chain graph (``pallas_fold_stem=True,
    pallas_deep=True``: three chains a frame);
  - the PB_FCN deployment net through the tester's serve-and-score loop
    (``cli/tester.py``, ``--noScale --packed --pallas``, f32), from a
    checkpoint the port wrote and read back;
  - the LabelProp net (planes 32) through validLabelProp's serve-and-score
    loop (``cli/validLabelProp.py``, ``--packed --pallas``, f32: three
    chains a frame pair, the classifier's channel-slice skip as a ``skip_w``
    stage), from a checkpoint the port wrote and read back, after its
    ``weightsLP`` deployment export;
  - the ``--UNet`` ROBO-UNet (VGA) through ``ServingPipeline`` with its
    folded-stem chain graph (two chains a frame, its down chain holding
    the two ``pool`` stages), and the ``--v2`` ROBO-UNet with its folded
    stem and deep chain (three chains a frame, its head and last up taking
    their concat skip through 3x3 ``skip_w`` kernels);
  - both through test.py's evaluation loop (``cli/test.py evaluate``, the
    ``--noScale`` working size 240x320, batch 16), held to the same loop
    on the CPU;
  - int8 serving (``quantize_int8``): the flagship's bf16 full chain graph
    quantized on the first frame and served through ``ServingPipeline``,
    PB_FCN through the tester's loop and LabelProp through validLabelProp's
    loop with ``--int8`` (f32), each calibrated through K2, with
    ``chain_reference`` called no time.
  - training: train.py's per-combo loop (``cli/train.py train_combo``) on
    the flagship at QVGA, batch 64, 3 epochs in f32 and 3 in bf16, its
    validation scored by the confusion-count kernel every epoch;
  - the legacy pipeline's loops (``legacy_train``): classTrainer's
    ``train_classifier`` (PB_FCN, then PB_FCN_2 with --v2), trainer's
    ``train_segmenter`` from that checkpoint, then with --finetune --prune
    from its output, and labelPropTrain's ``train_label_prop``, at full
    width on seeded in-memory frames, segmentation validation on the
    confusion-count kernel;
  - the rest of training (``train_variants``): the flagship's packed,
    remat "dots" and remat "full" train steps at QVGA, b64, each through a
    Trainer epoch and its validation (K1 once a validation batch), timed
    in f32 and bf16 beside the plain step (ms, kernels and idle share a
    step, peak memory) and held to the plain step on the card; the
    streamed epoch (``train_streamed``): uint8 frames through
    ``Trainer.train_epoch_streamed`` and its validation, images/s against
    the cached epoch; and the classifier baselines (``classifier_clis``):
    classVal's ``train_baseline`` (the DownSampler + Classifier pair,
    ``--hessL``, ``--hessMC``) and objDetEval's ``train_detector`` at b64
    on seeded 32x32 patches;
  - the trained-net int8 envelope (``int8_trained``): PB_FCN, the --v2
    ROBO-UNet and LabelProp trained 30 epochs, quantized at four
    calibration statistics, int8 chain graphs served against the float
    ones on K2.
K2's int8 stages are held against the int8 ``chain_reference`` on every
chain of the five families (VGA b1, bf16 and f32) and on one stage per
feature, and K2 against ``chain_reference`` on random chains with random
zero blocks in bf16, f32 and int8 (``k2_fuzz``). K3, the fused conv3x3
block, has no caller: it is held against its plain version alone, beside
cuDNN, at the QVGA packed widths, at VGA and at widths that are no
multiples of 16. One call of each K2 chain of a prepared graph and one
K3 call must make no copy to the host (``no_host_copy``), and the device
fps phase splits each graph's card time into K2 and the plain parts with
``torch.profiler``.

    python3 chip_smoke.py --dump-chains PATH [INPUTS]
    python3 chip_smoke.py --compare-chains PATH_A PATH_B
    python3 chip_smoke.py --time-chains
    python3 chip_smoke.py --time-k1

save K2's outputs on every f32 chain of the five families (on the inputs
of the dump INPUTS when given), and compare two such dumps bit for bit (a
copy of this script beside an older tree's package dumps that tree's
kernel); print K2's card time alone (``torch.profiler``) on every
chain and single-stage case; and print K1's costs on the maps the main
paths give it (``K1_PATH_CASES``, recorded by ``K1Recorder`` in every
path's counted run) at two label distributions: its card time alone, its
device launches a call, its CUDA-event time, its bytes bound and the
``torch.bincount`` yardstick (the same lines ``phase_k1`` prints).
Every phase prints one JSON line; the line before the last is the card's
name and power limit as nvidia-smi reports them, and the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, if
any phase fails, and at once when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.float32: 67e12,    # f32 outside the tensor cores
              torch.int8: 1979e12}     # dense tensor-core int8 (OP/s)
VGA = (480, 640)
N_FRAMES = 32
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` on the current stream, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(t) -> int:
    return t.numel() * t.element_size()


class Checks:
    def __init__(self) -> None:
        self.failed = []

    def expect(self, ok: bool, what: str) -> bool:
        if not ok:
            self.failed.append(what)
        return ok


# ---------------------------------------------------------------------------
# K1: confusion counts
# ---------------------------------------------------------------------------


# (case, (B, H, W), pred dtype, tgt dtype): the maps K1 is given on the
# main paths, as the path phases record them (``K1Recorder``); "b8_vga" is
# a batch of eight served frames, which no path scores at once
K1_PATH_CASES = [
    ("serving", (1, *VGA), torch.uint8, torch.int32),
    ("tester", (1, *VGA), torch.int32, torch.int32),
    ("valid_label_prop", (2, 120, 160), torch.int32, torch.int32),
    ("test_cli", (16, 240, 320), torch.int64, torch.int32),
    ("train_val", (64, 120, 160), torch.int64, torch.int32),
    ("legacy_seg_val", (32, 120, 160), torch.int64, torch.int32),
    ("legacy_finetune_val", (8, 120, 160), torch.int64, torch.int32),
    ("legacy_lp_val", (16, 120, 160), torch.int64, torch.int32),
    ("b8_vga", (8, *VGA), torch.int32, torch.int32),
]
K1_DISTRIBUTIONS = ("random", "frame")
K1_CLASSES = 5
L2_FLUSH_BYTES = 96 << 20  # more than the H100's 50 MB L2


def l2_flusher(dev):
    """A call that reads L2_FLUSH_BYTES of another buffer, so that what a
    kernel reads next comes from device memory (a read, so that no dirty
    line is left for the next kernel to write back)."""
    buf = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    return lambda: buf.max()


def k1_maps(kind: str, shape, num_classes: int, pred_dtype, tgt_dtype,
            seed: int, dev):
    """A (pred, tgt) pair of label maps on ``dev``, from a
    ``torch.Generator`` seed. ``random``: both uniform in [-1, C + 2), the
    worst case for a histogram (out-of-range labels on both maps; -1 reads
    255 in uint8). ``frame``: like a served frame, ~80% of target pixels
    class 0 and the rest blobs of 16x16 pixels of the other classes, pred
    equal to tgt on ~95% of pixels and uniform in [0, C) elsewhere."""
    g = torch.Generator().manual_seed(seed)
    b, h, w = shape
    if kind == "random":
        pred = torch.randint(-1, num_classes + 2, shape, generator=g)
        tgt = torch.randint(-1, num_classes + 2, shape, generator=g)
    elif kind == "frame":
        hc, wc = -(-h // 16), -(-w // 16)
        cls = torch.randint(1, max(num_classes, 2), (b, hc, wc), generator=g)
        blob = torch.rand((b, hc, wc), generator=g) < 0.2
        cls = torch.where(blob, cls, 0) if num_classes > 1 else cls * 0
        tgt = cls[:, torch.arange(h) // 16][:, :, torch.arange(w) // 16]
        flip = torch.rand(shape, generator=g) < 0.05
        pred = torch.where(flip, torch.randint(0, num_classes, shape,
                                               generator=g), tgt)
    else:
        raise ValueError(f"unknown label distribution {kind!r}")
    return (pred.to(pred_dtype).contiguous().to(dev),
            tgt.to(tgt_dtype).contiguous().to(dev))


def widen_labels(t: torch.Tensor, seed: int) -> torch.Tensor:
    """An int64 map with labels beyond the int32 range on ~1/3 of its
    pixels: multiples of 2**32 added (the low 32 bits, which count, kept)
    or 2**31 + 3 (negative as int32: skipped)."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(t.shape, generator=g).to(t.device)
    t = t.to(torch.int64)
    t = torch.where(u < 0.2, t + 2**32 * (1 + (u * 100).long() % 3), t)
    return torch.where((u >= 0.2) & (u < 0.3), t.new_tensor(2**31 + 3), t)


def profile_calls(fn, calls: int, before=None, tries: int = 6):
    """torch.profiler over ``calls`` calls of ``fn``, ``before()`` run
    ahead of each: per call, every device row as (name, events, ms). The
    trace is kept only from a second profiler step on (the first, a few
    calls, warms the tracer up: the first kernels after it starts can go
    unrecorded). The tracer can still drop events: a trace that comes back
    without device time, or with a row whose events are no whole number a
    call, is taken again, up to ``tries`` times in all (then the last one
    is returned, or None if it holds no device time; three tries have come
    back empty on an H100)."""
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as tprofile

    for _ in range(tries):
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA],
                      schedule=schedule(wait=0, warmup=1, active=1,
                                        repeat=1)) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")]
        rows = [(e.key, e.count / calls,
                 e.self_device_time_total / 1e3 / calls) for e in events]
        if (sum(r[2] for r in rows) > 0
                and all(e.count % calls == 0 for e in events)):
            return rows
    return rows if sum(r[2] for r in rows) > 0 else None


def k1_card_ms(rows, name="confusion_kernel"):
    got = sum(ms for key, _, ms in rows or () if name in key)
    return got if got > 0 else None


def k1_device_launches(rows, name="confusion_kernel"):
    """Device launches a ``confusion_count`` call, from ``profile_calls``
    rows: all device events over the ``confusion_kernel`` events (one a
    call), so that events the tracer drops from every row alike leave the
    ratio as it is; None when the trace holds no ``confusion_kernel``."""
    kernel = sum(n for key, n, _ in rows or () if name in key)
    return sum(n for _, n, _ in rows) / kernel if kernel > 0 else None


def k1_time_case(count, plain, pred, tgt, num_classes: int, flush_l2,
                 calls: int = 50) -> dict:
    """K1's costs on one map pair: its card time alone with L2 flushed
    before each call (``card_ms``, the profiler's ``confusion_kernel``
    rows) and warm (back to back), the device events a call and their
    time (warm, and cold without the flush's own rows: an older wrapper's
    casts read the cold maps, its kernel their warm copies), the CUDA-event
    time a call (the wrapper's host work included),
    the plain count's time, the ``torch.bincount`` yardstick's card time
    (every device row of the call) and CUDA-event time (that call syncs on
    the host), and the bytes bound at the maps' own dtypes. Where a map is
    int64, also ``card_ms_i32``: the kernel's card time with L2 flushed on
    the same maps cast to int32 ahead of the call (for an older wrapper,
    which casts int64 maps itself, its kernel on cold int32 maps)."""
    b = pred.shape[0]
    nc2 = num_classes * num_classes
    call = lambda: count(pred, tgt, num_classes)  # noqa: E731
    warm = profile_calls(call, calls)
    cold = profile_calls(call, calls, before=flush_l2)
    flush_rows = {key for key, _, _ in profile_calls(flush_l2, 3) or ()}
    valid = ((pred >= 0) & (pred < num_classes)
             & (tgt >= 0) & (tgt < num_classes))
    bidx = torch.arange(b, device=pred.device).view(b, 1, 1).expand_as(pred)
    flat = (bidx * nc2 + pred.long() * num_classes + tgt.long())[valid]
    lib = lambda: torch.bincount(flat, minlength=b * nc2)  # noqa: E731
    lib_rows = profile_calls(lib, calls)
    moved = nbytes(pred) + nbytes(tgt) + b * nc2 * 4
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    card = k1_card_ms(cold)
    res = {"shape": list(pred.shape), "pred": str(pred.dtype)[6:],
           "tgt": str(tgt.dtype)[6:], "classes": num_classes,
           "card_ms": card, "card_ms_warm": k1_card_ms(warm),
           "device_ms_per_call_cold": (sum(
               ms for key, _, ms in cold if key not in flush_rows) if cold
               else None),
           "launches_per_call": k1_device_launches(warm),
           "device_ms_per_call": (sum(ms for _, _, ms in warm) if warm
                                  else None),
           "device_rows": ([[k[:60], n, ms] for k, n, ms in warm] if warm
                           else None),
           "event_ms": cuda_ms(call, 200),
           "plain_ms": cuda_ms(lambda: plain(pred, tgt, num_classes), 10),
           "bincount_card_ms": (sum(ms for _, _, ms in lib_rows) if lib_rows
                                else None),
           "bincount_event_ms": cuda_ms(lib, 50),
           "bound_ms": bound_ms, "bound_by": "bytes", "bytes": moved,
           "bound_share": bound_ms / card if card else None}
    if torch.int64 in (pred.dtype, tgt.dtype):
        p32, t32 = pred.to(torch.int32), tgt.to(torch.int32)
        res["card_ms_i32"] = k1_card_ms(profile_calls(
            lambda: count(p32, t32, num_classes), calls, before=flush_l2))
    lib_counts = torch.bincount(flat, minlength=b * nc2).view(b, num_classes,
                                                              num_classes)
    res["bincount_equal"] = bool(torch.equal(lib_counts.float(),
                                             plain(pred, tgt, num_classes)))
    return res


def k1_timings(dev, chk: Checks) -> dict:
    """``k1_time_case`` at every main-path case and both distributions,
    each held to the plain count first; then the card time at C = 16 at
    B = 8 VGA (the kernel's per-warp histograms), off the main paths. Uses
    only what every version of the port has, so a copy of this script next
    to an older tree's package times that tree's K1. Returns the results
    by (case, distribution)."""
    from robocupvision_tpu_torch.ops.cuda_kernels import (confusion_count,
                                                          confusion_count_plain)

    flush_l2 = l2_flusher(dev)
    out = {}
    for i, (case, shape, pdt, tdt) in enumerate(K1_PATH_CASES):
        for j, kind in enumerate(K1_DISTRIBUTIONS):
            pred, tgt = k1_maps(kind, shape, K1_CLASSES, pdt, tdt,
                                SEED + 100 + 10 * i + j, dev)
            got = confusion_count(pred, tgt, K1_CLASSES)
            ref = confusion_count_plain(pred, tgt, K1_CLASSES)
            exact = bool(torch.equal(got, ref))
            chk.expect(exact, f"K1 {case} {kind}: counts differ from plain")
            res = {"phase": "k1_time", "case": case, "dist": kind,
                   "exact": exact,
                   "max_abs_err": float((got - ref).abs().max()),
                   **k1_time_case(confusion_count, confusion_count_plain,
                                  pred, tgt, K1_CLASSES, flush_l2)}
            chk.expect(res["bincount_equal"],
                       f"K1 {case} {kind}: bincount yardstick disagrees")
            emit(res)
            out[case, kind] = res
    for j, kind in enumerate(K1_DISTRIBUTIONS):
        pred, tgt = k1_maps(kind, (8, *VGA), 16, torch.int32, torch.int32,
                            SEED + 190 + j, dev)
        fn = lambda: confusion_count(pred, tgt, 16)  # noqa: E731
        chk.expect(bool(torch.equal(fn(), confusion_count_plain(pred, tgt,
                                                                16))),
                   f"K1 C=16 {kind}: != plain")
        emit({"phase": "k1_time", "case": "b8_vga_c16", "dist": kind,
              "card_ms": k1_card_ms(profile_calls(fn, 30, before=flush_l2))})
    return out


def phase_k1(dev, chk: Checks) -> dict:
    """K1 on the maps the main paths give it (``K1_PATH_CASES``), at both
    label distributions: held to its plain count, timed (``k1_timings``),
    and one device launch a call (the profiler). Then held alone on what
    the paths do not give it: odd and tiny sizes, offset views that leave
    the maps unaligned, int64 labels beyond the int32 range, C = 1 and 16.
    Returns the timings by (case, distribution)."""
    from robocupvision_tpu_torch.ops.cuda_kernels import (confusion_count,
                                                          confusion_count_plain)

    out = k1_timings(dev, chk)
    for (case, kind), res in out.items():
        chk.expect(res["launches_per_call"] == 1,
                   f"K1 {case} {kind}: {res['launches_per_call']} device "
                   "launches a call, not 1")

    def held(tag, pred, tgt, c):
        ok = bool(torch.equal(confusion_count(pred, tgt, c),
                              confusion_count_plain(pred, tgt, c)))
        chk.expect(ok, f"K1 {tag}: counts differ from the plain count")
        return ok

    edge = {}
    for i, (tag, shape, pdt, tdt, c, kind) in enumerate([
            ("odd_i64_u8", (3, 121, 161), torch.int64, torch.uint8, 5,
             "random"),
            ("tiny_1x1", (3, 1, 1), torch.uint8, torch.int64, 2, "random"),
            ("tiny_3x5", (1, 3, 5), torch.int32, torch.uint8, 5, "frame"),
            ("c1_vga", (1, *VGA), torch.uint8, torch.uint8, 1, "frame"),
            ("c16_vga", (1, *VGA), torch.int64, torch.int64, 16, "frame"),
            ("c16_random", (2, 121, 161), torch.int32, torch.int64, 16,
             "random")]):
        pred, tgt = k1_maps(kind, shape, c, pdt, tdt, SEED + 200 + i, dev)
        if pdt == torch.int64:
            pred = widen_labels(pred, SEED + 250 + i)
        if tdt == torch.int64:
            tgt = widen_labels(tgt, SEED + 260 + i)
        edge[tag] = held(tag, pred, tgt, c)
    # offset views: the maps start one element into a larger tensor, so
    # their bases (and, at odd hw, their per-image offsets) lose the
    # 16-byte alignment, each map by another amount
    # (the last pair has no pixel at which both are aligned)
    for i, (pdt, tdt) in enumerate([(torch.uint8, torch.int32),
                                    (torch.int64, torch.uint8),
                                    (torch.int32, torch.int32),
                                    (torch.uint8, torch.uint8)]):
        shape = (3, 121, 161)
        base_p, base_t = k1_maps("random", (4, 121, 161), 5, pdt, tdt,
                                 SEED + 270 + i, dev)
        pred = base_p.flatten()[1:1 + 3 * 121 * 161].view(shape)
        tgt = base_t[1:] if i < 3 else base_t[:3]
        edge[f"offset_{i}"] = held(f"offset view {i}", pred, tgt, 5)
    emit({"phase": "k1_confusion_count_edges", "exact": edge})
    return out


class K1Recorder:
    """Stands in for ``ops.metrics.confusion_count`` (``install``) and
    passes every call on to the wrapper; while ``active`` (a main path's
    counted run) it records each call's (shape, pred dtype, tgt dtype, C),
    and while ``verify`` it also holds each call's counts to
    ``confusion_count_plain`` on the same maps (``torch.equal``; the plain
    count launches no K1), tallying ``verified`` and ``unequal``."""

    def __init__(self) -> None:
        self.fn, self.active, self.seen = None, False, {}
        self.verify, self.verified, self.unequal = False, 0, 0

    def install(self) -> None:
        from robocupvision_tpu_torch.ops import metrics

        self.fn = metrics.confusion_count
        metrics.confusion_count = self

    def __call__(self, pred, tgt, num_classes, *args, **kw):
        if self.active:
            key = (tuple(pred.shape), pred.dtype, tgt.dtype, num_classes)
            self.seen[key] = self.seen.get(key, 0) + 1
        out = self.fn(pred, tgt, num_classes, *args, **kw)
        if self.verify:
            from robocupvision_tpu_torch.ops.cuda_kernels import (
                confusion_count_plain)

            self.verified += 1
            self.unequal += not torch.equal(
                out, confusion_count_plain(pred, tgt, num_classes))
        return out

    def check(self, chk: Checks) -> None:
        """Every recorded call is one of ``K1_PATH_CASES`` at C = 5."""
        known = {(shape, pdt, tdt, K1_CLASSES)
                 for _, shape, pdt, tdt in K1_PATH_CASES}
        emit({"phase": "k1_path_calls", "calls": [
            [list(k[0]), str(k[1])[6:], str(k[2])[6:], k[3], n]
            for k, n in self.seen.items()]})
        chk.expect(bool(self.seen) and set(self.seen) <= known,
                   f"K1 main-path calls {sorted(map(str, self.seen))} not "
                   "all in K1_PATH_CASES")


K1_REC = K1Recorder()


# ---------------------------------------------------------------------------
# K2: fused conv chains, on the inputs the serving path gives them
# ---------------------------------------------------------------------------


def record_chain_calls(pi, fn, x, tags=None):
    """Run ``fn(x)`` on PackedInfer ``pi`` and return every chain call it
    made as (x, stages, skips), in order; their chain tags are appended to
    ``tags`` when given."""
    calls = []
    orig = pi._chain

    def recorder(tag, cx, stages, skips=()):
        calls.append((cx.contiguous(), list(stages),
                      [s.contiguous() for s in skips]))
        if tags is not None:
            tags.append(tag)
        return orig(tag, cx, stages, skips)

    pi._chain = recorder
    try:
        fn(x)
    finally:
        del pi._chain
    torch.cuda.synchronize()
    return calls


def chain_grid(x, stages):
    """(N, H, W) of the chain's grid: the raw image / f for a stem chain."""
    n, h, w, _ = x.shape
    f = stages[0].stem_f or 1
    return n, h // f, w // f


def chain_work(x, stages, skips, outs):
    """Bytes the chain must move (inputs once, outputs once, kernels at the
    chain dtype, bias and affine in f32) and its operations (2 per
    multiply-add): ``dense`` is what the kernel issues over every packed
    tap, ``needed`` counts only the taps whose packed weight is non-zero --
    the packing scatters each original weight into one phase, so most
    packed taps are structural zeros, and ``needed`` equals the unpacked
    convolutions' own work. A pool stage does no multiply-adds (it gathers
    and compares) and reads its (4, Cout) int32 table of source lanes, not
    its selection stack. An int8 chain reads its input and its conv
    kernels at 1 byte (its skips, skip kernels and outputs stay at the
    chain dtype) and its w_scale rows in f32."""
    quant = bool(stages[0].x_scale)
    moved = (x.numel() if quant else nbytes(x)) \
        + sum(nbytes(s) for s in skips) + sum(nbytes(o) for o in outs)
    dense = needed = 0
    n, h, w = chain_grid(x, stages)
    for st in stages:
        if st.pool:
            moved += 4 * 4 * int(st.w.shape[3])
            continue
        # a skip_w stage's skip kernel is read and applied like its own
        kernels = [st.w] + ([] if st.skip_w is None else [st.skip_w])
        moved += (1 if quant else x.element_size()) * st.w.numel() + 4 * (
            st.b.numel() + (0 if st.scale is None else 2 * st.scale.numel())
            + (0 if st.w_scale is None else st.w_scale.numel()))
        if st.skip_w is not None:
            moved += x.element_size() * st.skip_w.numel()
        dense += 2 * n * h * w * sum(k.numel() for k in kernels)
        needed += 2 * n * h * w * sum(int(torch.count_nonzero(k))
                                      for k in kernels)
    return moved, dense, needed


def chain_features(stages):
    """The K2 stage features a chain launches."""
    feats = {"plain"}
    for st in stages:
        if st.stem_f:
            feats.add("stem_f")
        if st.dil != 1:
            feats.add("dil")
        if st.relu_only:
            feats.add("relu_only")
        if st.argmax_groups:
            feats.add("argmax_head")
        if st.skip_w is not None:
            feats.add("skip_w")
        if st.pool:
            feats.add("pool")
        if st.x_scale:
            feats.add("int8")
    return sorted(feats)


def check_chain(tag, call, chk: Checks, iters: int,
                single: bool = False, timed: bool = True) -> dict:
    """One chain call on K2 against ``chain_reference`` on the same inputs,
    with times and bounds. Float chains: see below. int8 chains (every
    stage quantized): without a ``skip_w`` stage every f32 step is the
    reference's, so every output equal; with one (the reference sums the
    float skip conv in the kernel's order), every element within the JAX
    package's int8 gate, rtol = atol = 1e-5 in f32 (``bf16_tolerance`` in
    bf16; ``int8_mismatch`` counts the elements outside it, and the
    excess of the worst in units of ``int8_flip_step``), ``single`` (one
    stage) also within 1e-6 of max|ref|, labels equal."""
    from robocupvision_tpu_torch.ops import cuda_packed as ckp

    x, stages, skips = call
    dt = x.dtype
    quant = bool(stages[0].x_scale)
    exact = quant and all(st.skip_w is None for st in stages)
    steps = ckp.int8_output_steps(stages) if quant else None
    got = ckp.fused_conv_chain(x, stages, skips)
    ref = ckp.chain_reference(x, stages, skips)
    torch.cuda.synchronize()
    n, h, _ = chain_grid(x, stages)
    res = {"phase": "k2_int8" if quant else "k2_fused_conv_chain",
           "case": tag, "dtype": str(dt),
           "input": list(x.shape), "stages": len(stages),
           "features": chain_features(stages),
           "band": ckp.choose_band(n, h, x.device)}
    err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.dtype == torch.int32:
            agree = float((g == r).float().mean())
            res["label_agreement"] = agree
            want = 1.0 if quant else (
                0.999 if dt == torch.bfloat16 else 0.9999)
            chk.expect(agree >= want, f"K2 {tag}: label agreement {agree}")
            continue
        if quant:
            d = (g.float() - r.float()).abs()
            e, rmax = float(d.max()), float(r.float().abs().max())
            err = max(err, e)
            frac, worst = ckp.int8_mismatch(g, r, steps[i])
            res.setdefault("outputs", []).append(
                {"max_abs_err": e, "ref_max_abs": rmax,
                 "rel_to_max": e / max(rmax, 1e-30),
                 "outside_tolerance": frac,
                 "outside_tolerance_n": round(frac * g.numel()),
                 "flip_step": steps[i], "outlier_excess_in_steps": worst})
            equal = bool(torch.equal(g, r))
            res["outputs"][-1]["equal"] = equal
            if exact:
                ok = equal
            else:
                ok = frac == 0 and (not single or e <= 1e-6 * rmax)
            chk.expect(ok, f"K2 {tag}: int8 output {i} max abs err {e} "
                           f"(max|ref| {rmax}), {frac} outside tolerance, "
                           f"{worst} flip steps over it"
                           + (" (must be equal)" if exact else ""))
            continue
        # f32: rtol = atol = 2e-4 and a relative L2 error under 1e-4 (which
        # still holds outputs that are small beside atol, as PB_FCN's deep
        # chain gives under the default init); bf16: two ulps of |ref| +
        # 2^-8 max|ref| per element, never more than 0.05, and a relative
        # L2 error under 1e-2
        g, r = g.float(), r.float()
        d = (g - r).abs()
        e = float(d.max())
        err = max(err, e)
        rel_l2 = float(torch.linalg.vector_norm(g - r)
                       / torch.linalg.vector_norm(r).clamp_min(1e-30))
        if dt == torch.bfloat16:
            ok = bool((d <= ckp.bf16_tolerance(r)).all()) and e <= 0.05 \
                and rel_l2 < 1e-2
        else:
            ok = bool(torch.allclose(g, r, rtol=2e-4, atol=2e-4)) \
                and rel_l2 < 1e-4
        res.setdefault("outputs", []).append(
            {"max_abs_err": e, "ref_mean_abs": float(r.abs().mean()),
             "ref_max_abs": float(r.abs().max()), "rel_l2": rel_l2})
        chk.expect(ok, f"K2 {tag}: output {i} max abs err {e}, "
                       f"rel L2 {rel_l2}")
    res["max_abs_err"] = err
    if not timed:
        return res
    moved, dense, needed = chain_work(x, stages, skips, got)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = needed / PEAK_FLOPS[torch.int8 if quant else dt] * 1e3
    res.update(kernel_ms=cuda_ms(lambda: ckp.fused_conv_chain(x, stages, skips),
                                 iters),
               plain_ms=cuda_ms(lambda: ckp.chain_reference(x, stages, skips),
                                iters),
               bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=moved, flops_needed=needed, flops_dense=dense)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# K2 fuzz: random chains against chain_reference
# ---------------------------------------------------------------------------

FUZZ_SEEDS = 24


def _zero_blocks(w, rng, share):
    """``w`` (KH, KW, Cin, Cout) with about ``share`` of its (tap, 8-channel,
    8-channel) blocks and a few whole (tap, channel) rows set to zero: lists
    that skip more than the packers' structural zeros."""
    kh, kw, cin, cout = w.shape
    for tap in range(kh * kw):
        for ci in range(0, cin, 8):
            for co in range(0, cout, 8):
                if rng.random() < share:
                    w[tap // kw, tap % kw, ci:ci + 8, co:co + 8] = 0.0
        if rng.random() < 0.2:
            w[tap // kw, tap % kw, int(rng.integers(cin)), :] = 0.0
    return w


def fuzz_chain(seed: int, dev):
    """A random f32 chain for K2 against ``chain_reference``: ``(x, stages,
    skips, band)``. K in {1, 3} and dil in {1, 2}; every epilogue (rbb and
    bn-relu affines, ``relu_only``, the bias-only head, with an argmax on
    some); identity and ``skip_w`` skips (K 1 and 3); a ``stem_f`` stage 0,
    ``pool`` stages and emits; widths that are and are not multiples of 8
    and 16; random zero blocks in every kernel; and the band (rows a block)
    any divisor of H, so multi-band grids recompute halos. Weights are
    scaled by 1/sqrt(fan-in) so values stay near 1 over the stages."""
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops import cuda_packed as ckp

    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(1, 3))
    h = int(rng.choice([6, 8, 12, 16]))
    w = int(rng.choice([5, 12, 20, 33, 40]))
    widths = [8, 12, 16, 20, 24, 32, 40, 48, 64, 80]

    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def conv_w(k_h, k_w, cin, cout):
        fan = k_h * k_w * cin
        return t(_zero_blocks(arr(k_h, k_w, cin, cout, scale=fan ** -0.5),
                              rng, float(rng.choice([0.0, 0.5, 0.8]))))

    stages, skips = [], []
    f = int(rng.choice([0, 0, 2, 4]))
    cin0 = 3 if f else int(rng.choice(widths))
    x = t(arr(n, h * (f or 1), w * (f or 1), cin0))
    cin = f * cin0 if f else cin0
    n_stages = int(rng.integers(1, 5))
    argmax = bool(rng.random() < 0.4)
    for i in range(n_stages):
        last = i == n_stages - 1
        if (i > 0 and not last and cin % 4 == 0 and rng.random() < 0.2):
            st = packed._pool_chain_stage(2, cin // 4, torch.float32, dev)
            stages.append(dataclasses.replace(st, emit=bool(rng.random() < 0.5)))
            cin //= 4
            continue
        if i == 0 and f:
            k_h, k_w, dil = f + 2, 3, 1
        else:
            k = int(rng.choice([1, 3]))
            k_h = k_w = k
            dil = int(rng.choice([1, 2])) if k == 3 else 1
        if last and argmax:
            groups = int(rng.choice([1, 2, 4]))
            cout = groups * int(rng.choice([3, 5]))
        else:
            cout = int(rng.choice(widths))
        kw = dict(w=conv_w(k_h, k_w, cin, cout), b=t(arr(cout, scale=0.1)),
                  stem_f=f if i == 0 else 0, dil=dil,
                  emit=bool(rng.random() < 0.4))
        epi = "head" if last and argmax else str(rng.choice(
            ["rbb", "bn_relu", "relu_only", "head"]))
        if epi in ("rbb", "bn_relu"):
            kw.update(scale=t(rng.uniform(0.5, 1.2, cout).astype(np.float32)),
                      shift=t(arr(cout, scale=0.1)), rbb=epi == "rbb")
        elif epi == "relu_only":
            kw["relu_only"] = True
        skip = str(rng.choice(["none", "none", "identity", "skip_w"]))
        if epi != "head" and skip != "none" and len(skips) < 4:
            if skip == "identity":
                skips.append(t(arr(n, h, w, cout, scale=0.5)))
            else:
                sk = int(rng.choice([1, 3]))
                sc = int(rng.choice([8, 12, 16, 24]))
                skips.append(t(arr(n, h, w, sc, scale=0.5)))
                kw["skip_w"] = conv_w(sk, sk, sc, cout)
            kw["skip_idx"] = len(skips) - 1
        stages.append(ckp.ChainStage(**kw))
        cin = cout
    if argmax:
        groups = int(rng.choice([g for g in (1, 2, 4)
                                 if int(stages[-1].w.shape[3]) % g == 0
                                 and stages[-1].scale is None
                                 and not stages[-1].relu_only] or [0]))
        if groups:
            stages = ckp.with_argmax_head(stages, groups)
    bands = [b for b in range(1, h + 1) if h % b == 0]
    return x, stages, skips, int(rng.choice(bands))


def fuzz_cases(seed: int, dev):
    """The chain of ``fuzz_chain(seed)`` in three forms: {"bf16", "f32",
    "int8"} -> (x, stages, skips), kernels and inputs at the chain dtype
    with their tap lists attached as the packers attach them; the int8
    chain quantized (f32 on even seeds, bf16 on odd ones) from statistics
    of the float chain (``chain_reference``); plus the band."""
    from robocupvision_tpu_torch.ops import cuda_packed as ckp

    x, stages, skips, band = fuzz_chain(seed, dev)

    def at(dt):
        out = []
        for st in stages:
            if st.pool:
                out.append(dataclasses.replace(st, w=st.w.to(dt)))
                continue
            w = st.w.to(dt)
            sw = None if st.skip_w is None else st.skip_w.to(dt)
            out.append(dataclasses.replace(st, w=w, skip_w=sw,
                                           taps=ckp.tap_blocks(w, sw)))
        return x.to(dt), out, [s.to(dt) for s in skips]

    cases = {"bf16": at(torch.bfloat16), "f32": at(torch.float32)}
    qx, qst, qsk = cases["f32" if seed % 2 == 0 else "bf16"]
    emitted = [dataclasses.replace(st, emit=True, argmax_groups=0)
               for st in qst]
    outs = ckp.chain_reference(qx, emitted, qsk)
    stats = [ckp._abs_stat(o, None) for o in [qx] + outs[:-1]]
    cases["int8"] = (qx, ckp.quantize_chain_stages(qst, stats), qsk)
    return cases, band


def phase_k2_fuzz(dev, chk: Checks) -> dict:
    """K2 on FUZZ_SEEDS random chains (``fuzz_cases``) in bf16, f32 and
    int8, each against ``chain_reference`` by ``check_chain``'s gates (bf16
    per element within ``bf16_tolerance``, f32 within rtol = atol = 2e-4
    and relative L2 under 1e-4, int8 equal without a ``skip_w`` stage and
    within the int8 gate with one), at the chain's band. An argmax head's
    labels must equal the first maximum of the kernel's own logits (the
    same chain without the head), which are held to the reference."""
    from robocupvision_tpu_torch.ops import cuda_packed as ckp

    res = {"phase": "k2_fuzz", "seeds": FUZZ_SEEDS, "cases": 0, "failed": [],
           "features": set()}
    choose = ckp.choose_band
    try:
        for seed in range(FUZZ_SEEDS):
            cases, band = fuzz_cases(seed, dev)
            ckp.choose_band = lambda n, h, d, band=band: band
            for dt, (x, stages, skips) in cases.items():
                tag = f"fuzz{seed}_{dt}"
                before = len(chk.failed)
                head = stages[-1].argmax_groups
                logits = [dataclasses.replace(st, argmax_groups=0)
                          for st in stages]
                r = check_chain(tag, (x, logits, skips), chk, 0, timed=False)
                if head:
                    labels = ckp.fused_conv_chain(x, stages, skips)[-1]
                    lg = ckp.fused_conv_chain(x, logits, skips)[-1].float()
                    n_, h_, w_, c_ = lg.shape
                    want = torch.argmax(lg.reshape(n_, h_, w_, head,
                                                   c_ // head), dim=-1)
                    chk.expect(bool(torch.equal(labels, want.to(torch.int32))),
                               f"K2 {tag}: argmax labels are not the first "
                               "maximum of the kernel's logits")
                res["cases"] += 1
                res["features"] |= set(r["features"]) | (
                    {"argmax_head"} if head else set())
                if len(chk.failed) > before:
                    res["failed"].append(tag)
    finally:
        ckp.choose_band = choose
    res["features"] = sorted(res["features"])
    emit(res)
    return res


def phase_k2(model, dev, chk: Checks) -> dict:
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops.color import raw_camera_preprocess

    results = {}
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    for dt in (torch.bfloat16, torch.float32):
        pi = packed.build_packed_infer(model, None, dt, pallas=True, device=dev)
        fn, _ = pi.infer_u8_packed()
        for b in (1, 8):
            frames = torch.randint(0, 256, (b, *VGA, 3), generator=g,
                                   dtype=torch.uint8).to(dev)
            x = raw_camera_preprocess(frames)
            down, up = record_chain_calls(pi, pi.logits, x)
            _, up_head = record_chain_calls(pi, fn, x)
            iters = 10 if b == 1 else 3
            for tag, call in (("down", down), ("up", up), ("up_argmax", up_head)):
                key = f"{tag}_b{b}_{'bf16' if dt == torch.bfloat16 else 'f32'}"
                results[key] = check_chain(key, call, chk, iters)
    return results


def phase_k2_features(flagship, pb_fcn, dev, chk: Checks) -> dict:
    """K2's stem_f, dil and relu_only stages, on the chains and inputs the
    full-width graphs give them: the flagship's folded-stem down chain and
    deep chain, and PB_FCN's down chain with and without its dilated stage,
    its deep chain and its up chain with the head; VGA, b1 and b8, bf16 and
    f32."""
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops.color import raw_camera_preprocess

    results = {}
    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    for dt in (torch.bfloat16, torch.float32):
        name = "bf16" if dt == torch.bfloat16 else "f32"
        fl = packed.build_packed_infer(flagship, None, dt, pallas=True,
                                       pallas_fold_stem=True, pallas_deep=True,
                                       device=dev)
        pb = {deep: packed.build_packed_pb_fcn(pb_fcn, None, dt, pallas=True,
                                               pallas_deep=deep, device=dev)
              for deep in (False, True)}
        for b in (1, 8):
            frames = torch.randint(0, 256, (b, *VGA, 3), generator=g,
                                   dtype=torch.uint8).to(dev)
            x = raw_camera_preprocess(frames)
            stem_down, deep, _ = record_chain_calls(fl, fl.logits, x)
            pb_down_dil, pb_deep, _ = record_chain_calls(pb[True],
                                                         pb[True].logits, x)
            fn, _ = pb[False].infer_u8_packed()
            pb_down, pb_up_head = record_chain_calls(pb[False], fn, x)
            iters = 10 if b == 1 else 3
            for tag, call in (("stem_down", stem_down), ("deep", deep),
                              ("pb_fcn_down", pb_down),
                              ("pb_fcn_down_dil", pb_down_dil),
                              ("pb_fcn_deep", pb_deep),
                              ("pb_fcn_up_argmax", pb_up_head)):
                key = f"{tag}_b{b}_{name}"
                results[key] = check_chain(key, call, chk, iters)
    return results


def lp_graph(lp_model, dt, dev):
    """LabelProp's chain graph as ``validLabelProp.py --packed --pallas``
    builds it: folded-stem down chain, dilated mid chain, up chain."""
    from robocupvision_tpu_torch.models import packed

    return packed.build_packed_label_prop(lp_model, None, dt, pallas=True,
                                          pallas_fold_stem=True,
                                          pallas_mid=True, device=dev)


def phase_k2_lp(lp_model, dev, chk: Checks) -> dict:
    """K2 on LabelProp's three chains at planes 32, on the inputs a random
    (2, 120, 160, 8) frame pair gives them, bf16 and f32: the folded-stem
    down chain [pre, down1, down2], the dilated mid chain [conv1, conv2,
    conv3] on the 15x20 grid, and the up chain [upConv2 + skip, upConv3,
    classifier + 1x1 skip_w over ``top``] in its logits form (where a wrong
    skip_w shows) and with the argmax head."""
    results = {}
    g = torch.Generator(device="cpu").manual_seed(SEED + 7)
    for dt in (torch.bfloat16, torch.float32):
        name = "bf16" if dt == torch.bfloat16 else "f32"
        pi = lp_graph(lp_model, dt, dev)
        x = torch.randn((2, 120, 160, 8), generator=g).to(dev)
        down, mid, up = record_chain_calls(pi, pi.logits, x)
        _, _, up_head = record_chain_calls(pi, pi.infer, x)
        for tag, call in (("lp_down", down), ("lp_mid", mid), ("lp_up", up),
                          ("lp_up_argmax", up_head)):
            key = f"{tag}_{name}"
            results[key] = check_chain(key, call, chk, 20)
    return results


def phase_k2_pool(dev, chk: Checks) -> dict:
    """K2's pool stage, bit-identical (``torch.equal``) to
    ``packed_max_pool``: a pool-only chain at f_in 4 (the --UNet VGA
    feats0, (1, 120, 160, 128)) and at f_in 2 ((1, 120, 160, 64)), f32 and
    bf16; and a conv -> pool -> conv chain whose pool output must be
    ``packed_max_pool`` of the kernel's own conv output at bands 1, 5 and
    30."""
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops import cuda_packed as ckp

    g = torch.Generator(device="cpu").manual_seed(SEED + 10)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    res = {"phase": "k2_pool", "cases": {}}
    choose = ckp.choose_band
    try:
        for dt in (torch.bfloat16, torch.float32):
            name = "bf16" if dt == torch.bfloat16 else "f32"
            for f_in, c in ((4, 8), (2, 16)):
                x = randn(1, 120, 160, f_in * f_in * c).to(dt)
                st = packed._pool_chain_stage(f_in, c, dt, dev)
                got = ckp.fused_conv_chain(x, [st])[0]
                want = packed.packed_max_pool(x, f_in)
                torch.cuda.synchronize()
                exact = bool(torch.equal(got, want))
                chk.expect(exact, f"K2 pool f_in {f_in} {name}: not "
                                  "bit-identical to packed_max_pool")
                res["cases"][f"pool_f{f_in}_{name}"] = {
                    "exact": exact,
                    "kernel_ms": cuda_ms(lambda: ckp.fused_conv_chain(x, [st]),
                                         20),
                    "packed_max_pool_ms": cuda_ms(
                        lambda: packed.packed_max_pool(x, f_in), 20)}
            stages = [ckp.ChainStage(w=(randn(3, 3, 32, 64) * 0.2).to(dt),
                                     b=randn(64) * 0.1, scale=1 + randn(64) * 0.1,
                                     shift=randn(64) * 0.1, emit=True),
                      packed._pool_chain_stage(2, 16, dt, dev, emit=True),
                      ckp.ChainStage(w=(randn(3, 3, 16, 24) * 0.2).to(dt),
                                     b=randn(24) * 0.1, scale=1 + randn(24) * 0.1,
                                     shift=randn(24) * 0.1, rbb=False)]
            x = randn(2, 30, 40, 32).to(dt)
            for band in (1, 5, 30):
                ckp.choose_band = lambda n, h, d, band=band: band
                conv, pooled, _ = ckp.fused_conv_chain(x, stages)
                torch.cuda.synchronize()
                exact = bool(torch.equal(pooled,
                                         packed.packed_max_pool(conv, 2)))
                chk.expect(exact, f"K2 conv-pool-conv band {band} {name}: "
                                  "pool not bit-identical")
                res["cases"][f"conv_pool_conv_band{band}_{name}"] = {
                    "exact": exact}
    finally:
        ckp.choose_band = choose
    emit(res)
    return res


def phase_k2_variants(variants, dev, chk: Checks) -> dict:
    """K2 on the --UNet and --v2 chains at VGA, b1 and b8, bf16 and f32,
    on the inputs their serving graphs (``variants``: tag -> (model, build
    flags)) give them: the --UNet folded-stem down chain (stem,
    Level0.Conv1, pool, two convs, pool, two convs) and up chain with its
    head; the --v2 folded-stem down chain, its 9-stage deep chain, and its
    up chain (3x3 skip_w stages, a 3x3 head) in logits form (where a wrong
    skip_w shows) and with the head."""
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops.color import raw_camera_preprocess

    results = {}
    g = torch.Generator(device="cpu").manual_seed(SEED + 11)
    for dt in (torch.bfloat16, torch.float32):
        name = "bf16" if dt == torch.bfloat16 else "f32"
        graphs = {tag: packed.build_packed_infer(net, None, dt, pallas=True,
                                                 device=dev, **kw)
                  for tag, (net, kw) in variants.items()}
        for b in (1, 8):
            frames = torch.randint(0, 256, (b, *VGA, 3), generator=g,
                                   dtype=torch.uint8).to(dev)
            x = raw_camera_preprocess(frames)
            calls = {}
            calls["unet_down"], _ = record_chain_calls(
                graphs["unet"], graphs["unet"].logits, x)
            _, calls["unet_up_argmax"] = record_chain_calls(
                graphs["unet"], graphs["unet"].infer_u8_packed()[0], x)
            calls["v2_down"], calls["v2_deep"], calls["v2_up"] = \
                record_chain_calls(graphs["v2"], graphs["v2"].logits, x)
            calls["v2_up_argmax"] = record_chain_calls(
                graphs["v2"], graphs["v2"].infer_u8_packed()[0], x)[-1]
            iters = 10 if b == 1 else 3
            for tag, call in calls.items():
                key = f"{tag}_b{b}_{name}"
                results[key] = check_chain(key, call, chk, iters)
    return results


def int8_single_cases(model, dt, dev):
    """One int8 stage per feature at the serving grids, float stages to be
    calibrated: a 3x3 (rbb affine) and a 1x1 conv on the VGA packed grid,
    a dilated relu-only 3x3 on the deep 30x40 grid, the flagship's folded
    stem on a raw VGA image, a 1x1 (LabelProp's classifier widths) and a
    3x3 (the --v2 split concat's) ``skip_w`` stage, whose skips and skip
    kernels are dyadic (k/8, k/64, |k| <= 8: their float conv sums exactly
    in any order, so cuDNN's matches the kernel's bit for bit), --UNet's
    first pool, and the argmax head. Returns {case: (x, stages, skips)}."""
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops import cuda_packed as ckp

    g = torch.Generator(device="cpu").manual_seed(SEED + 20)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def dyadic(denom, *shape):
        k = torch.randint(-8, 9, shape, generator=g).float()
        return (k / denom).to(device=dev, dtype=dt)

    def conv(k, cin, cout, **kw):
        return ckp.ChainStage(w=randn(k, k, cin, cout, scale=0.1).to(dt),
                              b=randn(cout, scale=0.1),
                              scale=1 + randn(cout, scale=0.1),
                              shift=randn(cout, scale=0.1), **kw)

    stem = packed.build_packed_infer(model, None, dt, pallas=True,
                                     pallas_fold_stem=True, pallas_deep=True,
                                     device=dev).chains["down"][0]
    return {
        "conv3x3": (randn(1, 120, 160, 64).to(dt), [conv(3, 64, 64)], []),
        "conv1x1": (randn(1, 120, 160, 128).to(dt),
                    [conv(1, 128, 64, rbb=False)], []),
        "dil": (randn(1, 30, 40, 64).to(dt),
                [ckp.ChainStage(w=randn(3, 3, 64, 64, scale=0.1).to(dt),
                                b=randn(64, scale=0.1), relu_only=True,
                                dil=2)], []),
        "stem_f": (randn(1, *VGA, 3).to(dt), [stem], []),
        "skip_w1": (randn(1, 120, 160, 16).to(dt),
                    [ckp.ChainStage(w=randn(1, 1, 16, 80, scale=0.1).to(dt),
                                    b=randn(80, scale=0.1), skip_idx=0,
                                    skip_w=dyadic(64, 1, 1, 128, 80))],
                    [dyadic(8, 1, 120, 160, 128)]),
        "skip_w3": (randn(1, 120, 160, 64).to(dt),
                    [conv(3, 64, 64, rbb=False, skip_idx=0,
                          skip_w=dyadic(64, 3, 3, 64, 64))],
                    [dyadic(8, 1, 120, 160, 64)]),
        "pool": (randn(1, 120, 160, 128).to(dt),
                 [packed._pool_chain_stage(4, 8, dt, dev)], []),
        "argmax": (randn(1, 120, 160, 32).to(dt), ckp.with_argmax_head(
            [ckp.ChainStage(w=randn(1, 1, 32, 80, scale=0.1).to(dt),
                            b=randn(80, scale=0.1))], 16), []),
    }


def int8_graphs(flagship, variants, pb_model, lp_model, dt, dev):
    """The five families' chain graphs as they are served, with the input
    each is calibrated and checked on: the flagship full chain graph, the
    --UNet and --v2 graphs (``variants``: tag -> (model, build flags)) and
    PB_FCN with and without ``pallas_deep`` on a VGA camera frame, and
    LabelProp on a random (2, 120, 160, 8) pair."""
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops.color import raw_camera_preprocess

    g = torch.Generator(device="cpu").manual_seed(SEED + 21)
    frame = raw_camera_preprocess(torch.randint(
        0, 256, (1, *VGA, 3), generator=g, dtype=torch.uint8).to(dev))
    graphs = {"flagship": packed.build_packed_infer(
        flagship, None, dt, pallas=True, pallas_fold_stem=True,
        pallas_deep=True, device=dev)}
    for tag, (net, kw) in variants.items():
        graphs[tag] = packed.build_packed_infer(net, None, dt, pallas=True,
                                                device=dev, **kw)
    for deep in (False, True):
        graphs["pb_fcn_deep" if deep else "pb_fcn"] = \
            packed.build_packed_pb_fcn(pb_model, None, dt, pallas=True,
                                       pallas_deep=deep, device=dev)
    out = {tag: (pi, frame) for tag, pi in graphs.items()}
    out["label_prop"] = (lp_graph(lp_model, dt, dev),
                         torch.randn((2, 120, 160, 8), generator=g).to(dev))
    return out


def phase_k2_int8(flagship, variants, pb_model, lp_model, dev,
                  chk: Checks) -> dict:
    """K2's int8 stages at VGA b1 (LabelProp: its pair), bf16 and f32: every
    chain of the five families, each graph quantized by ``quantize_int8``
    on the phase's input (calibrated through the kernel), its chains as
    that input gives them (the up chain with and without the argmax head);
    then one stage per feature (``int8_single_cases``), calibrated through
    the kernel by ``chain_stats``. Each against the int8 ``chain_reference``
    by ``check_chain``'s int8 rule."""
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops import cuda_packed as ckp

    results = {}
    for dt in (torch.bfloat16, torch.float32):
        name = "bf16" if dt == torch.bfloat16 else "f32"
        for fam, (pi, x) in int8_graphs(flagship, variants, pb_model,
                                        lp_model, dt, dev).items():
            q = packed.quantize_int8(pi, x)
            tags = []
            calls = record_chain_calls(q, q.logits, x, tags)
            calls.append(record_chain_calls(q, q.infer, x)[-1])
            tags.append("up_argmax")
            for tag, call in zip(tags, calls):
                key = f"{fam}_{tag}_{name}"
                results[key] = check_chain(key, call, chk, 5)
        for case, (x, stages, skips) in int8_single_cases(flagship, dt,
                                                          dev).items():
            _, stats = ckp.chain_stats(x, stages, skips)
            qst = ckp.quantize_chain_stages(stages, stats)
            key = f"single_{case}_{name}"
            results[key] = check_chain(key, (x, qst, skips), chk, 10,
                                       single=True)
    return results


# ---------------------------------------------------------------------------
# K3: the fused conv3x3 block (no path calls it: held alone)
# ---------------------------------------------------------------------------

# the TPU record's QVGA widths, VGA, and widths that are no multiples of 16
K3_SHAPES = [(120, 160, 64, 64), (120, 160, 128, 128), (480, 640, 64, 64),
             (120, 160, 24, 40)]


def phase_k3(dev, chk: Checks) -> dict:
    """K3 against its plain version at the QVGA packed widths the TPU
    record used and at VGA, bf16 and f32, both epilogue orders: f32 within
    rtol = atol = 1e-5, bf16 within ``conv_block_bf16_tolerance`` (one bf16
    ulp). Times from CUDA events: the kernel (its weights at x's dtype
    beforehand, as cuDNN's are), the plain version, and the library
    yardstick, cuDNN's conv (NCHW views of the same tensors, its kernel
    laid out OIHW beforehand) plus the same epilogue, used nowhere in the
    port. The bound: 2 * 9 * C * Co * H * W FLOP over the dtype's
    peak, or x, the kernel at x's dtype, three f32 vectors and the output
    over the memory rate, whichever is longer."""
    import torch.nn.functional as F

    from robocupvision_tpu_torch.ops.cuda_kernels import (
        conv_block_bf16_tolerance, fused_conv3x3_block,
        fused_conv3x3_block_plain)

    results = {}
    g = torch.Generator().manual_seed(SEED + 20)
    for h, w, c, co in K3_SHAPES:
        x32 = torch.randn((1, h, w, c), generator=g).to(dev)
        wk = (torch.randn((3, 3, c, co), generator=g) * (2.0 / (9 * c)) ** 0.5
              ).to(dev)
        b, sh = (torch.randn(co, generator=g).to(dev) * 0.1 for _ in range(2))
        sc = (torch.rand(co, generator=g) + 0.5).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(dt)
            wk_dt = wk.to(dt)
            w_oihw = wk_dt.permute(3, 2, 0, 1).contiguous()
            b_dt = b.to(dt)
            for rbb in (True, False):
                tag = (f"{h}x{w}_{c}to{co}_{'bf16' if dt == torch.bfloat16 else 'f32'}"
                       f"_{'relu_bn' if rbb else 'bn_relu'}")
                got = fused_conv3x3_block(x, wk_dt, b, sc, sh, rbb)
                ref = fused_conv3x3_block_plain(x, wk_dt, b, sc, sh, rbb)

                def library():
                    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b_dt,
                                 padding=1).float()
                    y = torch.clamp_min(y, 0) * sc.view(-1, 1, 1) \
                        + sh.view(-1, 1, 1) if rbb else torch.clamp_min(
                            y * sc.view(-1, 1, 1) + sh.view(-1, 1, 1), 0)
                    return y.to(dt).permute(0, 2, 3, 1)

                lib = library()
                torch.cuda.synchronize()
                d = (got.float() - ref.float()).abs()
                if dt == torch.float32:
                    ok = bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-5))
                else:
                    ok = bool((d <= conv_block_bf16_tolerance(ref)).all())
                chk.expect(ok, f"K3 {tag}: max abs err {float(d.max())} "
                               f"against the plain version")
                flops = 2 * 9 * c * co * h * w
                moved = nbytes(x) + 9 * c * co * x.element_size() \
                    + 3 * co * 4 + h * w * co * x.element_size()
                t_bytes = moved / HBM_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS[dt] * 1e3
                big = h * w >= 480 * 640
                res = {"phase": "k3_conv_block", "case": tag,
                       "shape": [1, h, w, c], "cout": co, "dtype": str(dt),
                       "relu_before_bn": rbb,
                       "max_abs_err": float(d.max()),
                       "ref_max_abs": float(ref.float().abs().max()),
                       "library_max_abs_err_vs_plain": float(
                           (lib.float() - ref.float()).abs().max()),
                       "kernel_ms": cuda_ms(lambda: fused_conv3x3_block(
                           x, wk_dt, b, sc, sh, rbb), 10 if big else 50),
                       "plain_ms": cuda_ms(lambda: fused_conv3x3_block_plain(
                           x, wk_dt, b, sc, sh, rbb), 5 if big else 20),
                       "library_ms": cuda_ms(library, 10 if big else 50),
                       "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
                       "ops_ms": t_ops,
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations", "flops": flops, "bytes": moved}
                res["kernel_over_library"] = res["kernel_ms"] / res["library_ms"]
                emit(res)
                results[tag] = res
    return results


def phase_no_host_copy(model, dev, chk: Checks) -> dict:
    """One K2 call for each chain of the flagship's bf16 full chain graph
    and of its int8 form, and one K3 call, on prepared inputs (the graphs'
    stages carry their tap lists), under
    ``torch.cuda.set_sync_debug_mode("error")``: any copy to the host or
    other synchronising call in them raises."""
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops import cuda_packed as ckp
    from robocupvision_tpu_torch.ops.color import raw_camera_preprocess
    from robocupvision_tpu_torch.ops.cuda_kernels import fused_conv3x3_block

    g = torch.Generator(device="cpu").manual_seed(SEED + 30)
    frame = raw_camera_preprocess(torch.randint(
        0, 256, (1, *VGA, 3), generator=g, dtype=torch.uint8).to(dev))
    pi = packed.build_packed_infer(model, None, torch.bfloat16, pallas=True,
                                   pallas_fold_stem=True, pallas_deep=True,
                                   device=dev)
    q = packed.quantize_int8(pi, frame)
    calls = record_chain_calls(pi, pi.logits, frame) \
        + record_chain_calls(q, q.logits, frame)
    k3 = (torch.randn((1, 120, 160, 64), generator=g).to(dev, torch.bfloat16),
          torch.randn((3, 3, 64, 64), generator=g).to(dev, torch.bfloat16),
          *(torch.randn(64, generator=g).to(dev) for _ in range(3)))

    def run():
        for x, stages, skips in calls:
            ckp.fused_conv_chain(x, stages, skips)
        fused_conv3x3_block(*k3)

    run()  # builds and loads the libraries first
    torch.cuda.synchronize()
    res = {"phase": "no_host_copy", "k2_calls": len(calls), "k3_calls": 1}
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
        res["ok"] = True
    except RuntimeError as e:
        res["ok"], res["error"] = False, str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    chk.expect(res["ok"], f"no_host_copy: {res.get('error')}")
    emit(res)
    return res


# ---------------------------------------------------------------------------
# serving: the main paths
# ---------------------------------------------------------------------------


def serve(pi, frames, device_fn, host_unpack=None):
    from robocupvision_tpu_torch.utils.serving import ServingPipeline

    pipe = ServingPipeline(device_fn, host_postprocess=host_unpack, depth=2,
                           device=pi.device)
    out = list(pipe.map(frames))
    return np.stack([np.asarray(o).reshape(VGA) for o in out])


def camera_packed(pi):
    """``infer_u8_packed``'s pair for raw uint8 camera frames: the device
    function preprocesses on the card (as ``infer_u8_io`` does) first."""
    from robocupvision_tpu_torch.ops.color import raw_camera_preprocess

    device_fn, host_unpack = pi.infer_u8_packed()
    return (lambda x_u8: device_fn(raw_camera_preprocess(x_u8))), host_unpack


def top2_gap(logits):
    """Per-pixel gap between the two largest logits (host numpy)."""
    top2 = logits.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu().numpy()


def flagship_reference(model, dev, frames) -> dict:
    """What the flagship serving paths are held against: the plain zoo
    forward in f32 (TF32 off), and the plain packed bf16 graph
    (``pallas=False``, no K2), whose logit error against the f32 forward is
    the bf16 tie band."""
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops.color import raw_camera_preprocess

    def logits_of(fn):
        with torch.no_grad():
            return torch.cat([fn(raw_camera_preprocess(
                torch.from_numpy(f).to(dev))) for f in frames]).float()

    ref_logits = logits_of(model)
    plain = packed.build_packed_infer(model, None, torch.bfloat16,
                                      pallas=False, device=dev)
    plain_logits = logits_of(plain.logits)
    ref = {"labels": ref_logits.argmax(-1).cpu().numpy(),
           "gap": top2_gap(ref_logits),
           "plain_bf16_labels": plain_logits.argmax(-1).cpu().numpy(),
           "plain_bf16_err": float((plain_logits - ref_logits).abs().max()),
           "logits_of": logits_of, "ref_logits": ref_logits}
    ref["plain_bf16_agreement"] = float(
        (ref["plain_bf16_labels"] == ref["labels"]).mean())
    return ref


def phase_serving(model, dev, chk: Checks, frames, targets, ref, tag: str,
                  graph: dict, chains_per_frame: int) -> dict:
    """One ROBO-UNet main path: ``frames`` through ``ServingPipeline``
    (depth 2) with ``infer_u8_packed`` on the bf16 chain graph built with
    ``graph``, each served map scored by ``seg_batch_stats`` (K1), with the
    launch counters set to 0 just before and read just after; then the
    same graph's other serving forms and its f32 build."""
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops import metrics
    from robocupvision_tpu_torch.ops.cuda_kernels import confusion_count
    from robocupvision_tpu_torch.ops.cuda_packed import fused_conv_chain

    res = {"phase": "serving", "graph": tag, "frames": len(frames),
           "shape": [1, *VGA, 3], "pallas": graph}
    pi = packed.build_packed_infer(model, None, torch.bfloat16, pallas=True,
                                   device=dev, **graph)
    device_fn, host_unpack = camera_packed(pi)

    # --- the main path: serve through the pipeline, score every frame ----
    fused_conv_chain.launches = 0
    confusion_count.launches = 0
    K1_REC.active = True
    t0 = time.perf_counter()
    served = serve(pi, frames, device_fn, host_unpack)
    acc = metrics.SegAccum.zero(5)
    for lab, tgt in zip(served, targets):
        acc = acc + metrics.seg_batch_stats_host(lab[None], tgt, 5,
                                                     device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    K1_REC.active = False
    launches = {"fused_conv_chain": fused_conv_chain.launches,
                "confusion_count": confusion_count.launches}
    res["main_path_launches"] = launches
    res["main_path_s"] = wall
    chk.expect(launches["fused_conv_chain"] == chains_per_frame * len(frames),
               f"{tag}: chain launches {launches['fused_conv_chain']} != "
               f"{chains_per_frame}/frame")
    chk.expect(launches["confusion_count"] == len(frames),
               f"{tag}: K1 launches {launches['confusion_count']} != 1/scored "
               "batch")

    # served bf16 labels against the f32 reference, beside the witness that
    # runs no K2 (the plain packed bf16 graph): the chain graph may disagree
    # with the reference at most 0.1% of pixels more often than the witness
    # does, and only where the reference's top-2 logits lie within twice
    # the witness's logit error
    chain_err = float((ref["logits_of"](pi.logits) - ref["ref_logits"])
                      .abs().max())
    mism = served != ref["labels"]
    agree = 1.0 - float(mism.mean())
    max_gap = float(ref["gap"][mism].max()) if mism.any() else 0.0
    res.update(bf16_agreement=agree,
               bf16_plain_graph_agreement=ref["plain_bf16_agreement"],
               bf16_chains_vs_plain_graph_agreement=float(
                   (served == ref["plain_bf16_labels"]).mean()),
               bf16_logit_max_abs_err=chain_err,
               bf16_plain_graph_logit_max_abs_err=ref["plain_bf16_err"],
               bf16_mismatch_max_top2_gap=max_gap)
    chk.expect(agree >= ref["plain_bf16_agreement"] - 1e-3,
               f"{tag}: bf16 served label agreement {agree} < plain bf16 "
               f"graph's {ref['plain_bf16_agreement']} - 0.001")
    chk.expect(max_gap <= 2 * ref["plain_bf16_err"],
               f"{tag}: bf16 mismatch at a top-2 gap {max_gap} > 2x the plain "
               f"bf16 graph's logit err {ref['plain_bf16_err']}")

    # infer_u8_io: the same frames, on-device preprocessing, (N, H, W) out
    fused_conv_chain.launches = 0
    served_io = serve(pi, frames, pi.infer_u8_io)
    res["u8_io_chain_launches"] = fused_conv_chain.launches
    chk.expect(fused_conv_chain.launches == chains_per_frame * len(frames),
               f"{tag}: infer_u8_io chain launches != {chains_per_frame}/frame")
    chk.expect(bool(np.array_equal(served_io, served)),
               f"{tag}: infer_u8_io labels differ from infer_u8_packed labels")

    # f32 serve through the same kernels: >= 0.999 against the reference
    pi32 = packed.build_packed_infer(model, None, torch.float32, pallas=True,
                                     device=dev, **graph)
    fn32, unpack32 = camera_packed(pi32)
    fused_conv_chain.launches = 0
    served32 = serve(pi32, frames, fn32, unpack32)
    agree32 = float((served32 == ref["labels"]).mean())
    gap32 = float(ref["gap"][served32 != ref["labels"]].max()) \
        if agree32 < 1 else 0.0
    res.update(f32_agreement=agree32, f32_mismatch_max_top2_gap=gap32,
               f32_chain_launches=fused_conv_chain.launches)
    chk.expect(agree32 >= 0.999, f"{tag}: f32 served label agreement {agree32}")

    # scoring: K1 (impl auto) equals the plain einsum count, every field
    lab_d = torch.from_numpy(served).to(dev)
    tgt_d = torch.from_numpy(targets[:, 0]).to(dev)
    a = metrics.to_host(metrics.seg_batch_stats(lab_d, tgt_d, 5, device=dev))
    e = metrics.to_host(metrics.seg_batch_stats(lab_d, tgt_d, 5, impl="einsum",
                                                device=dev))
    same = all(np.array_equal(getattr(a, f), getattr(e, f))
               for f in ("conf", "iou_sum", "lab_cnts", "correct", "img_cnt"))
    chk.expect(same, f"{tag}: seg_batch_stats K1 != einsum")
    fin = metrics.seg_finalize(acc, 1.0 / (VGA[0] * VGA[1]))
    res.update(scoring_equal_einsum=same, mean_iou=float(fin["mean_iou"]),
               pixel_acc=float(fin["pixel_acc"]))

    t0 = time.perf_counter()
    serve(pi, frames, device_fn, host_unpack)
    res["pipeline_fps_b1_bf16"] = len(frames) / (time.perf_counter() - t0)
    emit(res)
    return res


def reference_chains(pi):
    """``pi`` with its chains run by ``chain_reference`` (the plain
    version) on the card instead of K2: the witness a served int8 graph is
    held to. Delete the attribute to restore K2."""
    from robocupvision_tpu_torch.ops import cuda_packed as ckp

    pi._chain = lambda tag, x, stages, skips=(): ckp.chain_reference(
        x.contiguous(), stages, [s.contiguous() for s in skips])
    return pi


def phase_serving_int8(model, dev, chk: Checks, frames) -> dict:
    """The int8 main path: the flagship's bf16 full chain graph
    (``pallas_fold_stem``, ``pallas_deep``) quantized by ``quantize_int8``
    on the first camera frame (the calibration pass runs K2, 3 launches)
    and then served for every frame through ``ServingPipeline``
    (``infer_u8_packed``, 3 K2 launches a frame). The counters are set to 0
    just before the calibration and again before serving, read after each;
    ``chain_reference`` must not be called in either. The served labels are
    held to the same int8 graph with its chains run by ``chain_reference``
    (>= 0.999) and compared with the float chain graph's."""
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops import cuda_packed as ckp
    from robocupvision_tpu_torch.ops.color import raw_camera_preprocess

    res = {"phase": "serving_int8", "graph": "chains3",
           "frames": len(frames), "shape": [1, *VGA, 3], "dtype": "bfloat16"}
    pi = packed.build_packed_infer(model, None, torch.bfloat16, pallas=True,
                                   pallas_fold_stem=True, pallas_deep=True,
                                   device=dev)
    calib = raw_camera_preprocess(torch.from_numpy(frames[0]).to(dev))

    # --- the main path: calibrate, then serve ---------------------------
    ckp.fused_conv_chain.launches = 0
    ckp.chain_reference.calls = 0
    t0 = time.perf_counter()
    q = packed.quantize_int8(pi, calib)
    torch.cuda.synchronize()
    res["quantize_s"] = time.perf_counter() - t0
    res["quantize_chain_launches"] = ckp.fused_conv_chain.launches
    device_fn, host_unpack = camera_packed(q)
    ckp.fused_conv_chain.launches = 0
    t0 = time.perf_counter()
    served = serve(q, frames, device_fn, host_unpack)
    wall = time.perf_counter() - t0
    # nothing here is scored: K1 is not on this path
    res["main_path_launches"] = {"fused_conv_chain": ckp.fused_conv_chain.launches}
    res["chain_reference_calls"] = ckp.chain_reference.calls
    res["pipeline_fps_b1_int8"] = len(frames) / wall
    chk.expect(res["quantize_chain_launches"] == 3,
               f"serving_int8: calibration ran {res['quantize_chain_launches']}"
               " K2 launches, not 3")
    chk.expect(ckp.fused_conv_chain.launches == 3 * len(frames),
               f"serving_int8: {ckp.fused_conv_chain.launches} K2 launches, "
               "not 3 a frame")
    chk.expect(res["chain_reference_calls"] == 0,
               f"serving_int8: chain_reference ran "
               f"{res['chain_reference_calls']} times on the int8 path")

    # the witnesses, outside the counted run
    ref_fn, ref_unpack = camera_packed(reference_chains(q))
    via_ref = serve(q, frames, ref_fn, ref_unpack)
    del q._chain
    fl_fn, fl_unpack = camera_packed(pi)
    float_labels = serve(pi, frames, fl_fn, fl_unpack)
    res["agreement_with_chain_reference"] = float((served == via_ref).mean())
    res["agreement_with_float_chain_graph"] = float(
        (served == float_labels).mean())
    chk.expect(res["agreement_with_chain_reference"] >= 0.999,
               f"serving_int8: labels agree "
               f"{res['agreement_with_chain_reference']} with the int8 graph "
               "through chain_reference")
    emit(res)
    return res


def device_split(fn, calls: int) -> dict:
    """The card's time a call of ``fn`` from ``torch.profiler``, split into
    K2 (the ``chain_kernel`` launches) and everything else (the graph's
    plain parts: cuDNN convs, the preprocessing, pads and adds), with the
    kernel counts a call. None where the trace holds no device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    k2 = [e for e in kern if "chain_kernel" in e.key]
    other = [e for e in kern if "chain_kernel" not in e.key]

    def ms(evs):
        return sum(e.self_device_time_total for e in evs) / 1e3 / calls

    if not kern:
        return {"k2_ms": None, "plain_parts_ms": None, "device_ms": None}
    return {"k2_ms": ms(k2), "plain_parts_ms": ms(other),
            "device_ms": ms(kern),
            "k2_kernels": sum(e.count for e in k2) / calls,
            "plain_parts_kernels": sum(e.count for e in other) / calls,
            "plain_parts_top": [[e.key[:60], e.self_device_time_total / 1e3
                                 / calls] for e in sorted(
                                     other, key=lambda e:
                                     -e.self_device_time_total)[:4]]}


def phase_device_fps(model, variants, dev, frames) -> dict:
    """Device frames/s of the bf16 serving function (CUDA events) at b1 and
    b8: the flagship's plain packed graph, its two-chain graph and the
    full chain graph (folded stem + deep chain), and the --UNet and --v2
    chain graphs the serving phases run (``variants``: tag -> (model,
    build flags)); at b1 each graph's card time split into K2 and the plain
    parts by ``torch.profiler`` (``device_split``)."""
    from robocupvision_tpu_torch.models import packed

    fps = {}
    graphs = [(tag, model, kw) for tag, kw in (
        ("plain", dict(pallas=False)),
        ("chains2", dict(pallas=True)),
        ("chains3", dict(pallas=True, pallas_fold_stem=True,
                         pallas_deep=True)))]
    graphs += [(tag, net, dict(pallas=True, **kw))
               for tag, (net, kw) in variants.items()]
    split = {}
    for tag, net, kw in graphs:
        pib = packed.build_packed_infer(net, None, torch.bfloat16,
                                        device=dev, **kw)
        fnb, _ = camera_packed(pib)
        for b in (1, 8):
            xb = torch.from_numpy(np.concatenate(frames[:b])).to(dev)
            ms = cuda_ms(lambda: fnb(xb), 10 if b == 1 else 5)
            fps[f"{tag}_b{b}"] = b / ms * 1e3
            if b == 1:
                split[tag] = device_split(lambda: fnb(xb), 10)
    res = {"phase": "device_fps_bf16", "fps": fps, "device_split_b1": split}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# PB_FCN through the tester's serve-and-score loop
# ---------------------------------------------------------------------------


def phase_tester(pb_model, dev, chk: Checks) -> dict:
    """The PB_FCN deployment net (planes 32, no_scale, VGA) the way
    ``tester.py --noScale --packed --pallas`` serves it: saved with the
    port's ``checkpoint.save``, read back with ``load_any``, then f32
    frames through ``serve_and_score`` at pipeline 1 and 2, with and
    without ``pallas_deep``. Labels are held to the plain zoo forward in f32
    (>= 0.999, mismatches only at ties), K1's confusion to the einsum, and
    the launch counters to 2 (3 with the deep chain) K2 launches and 1 K1
    launch a frame."""
    from robocupvision_tpu_torch.cli import tester
    from robocupvision_tpu_torch.data.datasets import legacy_normalize
    from robocupvision_tpu_torch.models import packed, zoo
    from robocupvision_tpu_torch.ops import metrics
    from robocupvision_tpu_torch.ops.cuda_kernels import confusion_count
    from robocupvision_tpu_torch.ops.cuda_packed import fused_conv_chain
    from robocupvision_tpu_torch.train import checkpoint

    res = {"phase": "tester_pb_fcn", "frames": N_FRAMES, "shape": [1, *VGA, 3],
           "dtype": "float32"}
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here, prefix=".chip_smoke_") as tmp:
        path = os.path.join(tmp, "pth", "bestModelSegVGA.pth")
        checkpoint.save(path, pb_model.registry, pb_model.state_dict())
        loaded = checkpoint.load_any(path, pb_model.registry)
    state = pb_model.state_dict()
    same = list(loaded) == list(state) and all(
        torch.equal(loaded[k], state[k].cpu()) for k in state)
    chk.expect(same, "PB_FCN checkpoint did not read back exactly")
    model = zoo.make("pb_fcn", planes=32, num_classes=5, kernel_size=1,
                     no_scale=True, device=dev,
                     generator=torch.Generator().manual_seed(SEED + 99))
    model.load_state_dict(loaded)
    res["checkpoint_roundtrip_exact"] = same

    rng = np.random.default_rng(SEED + 6)
    frames = [legacy_normalize(rng.integers(0, 256, (*VGA, 3)).astype(
        np.float32) / 255.0) for _ in range(N_FRAMES)]
    targets = rng.integers(0, 5, (N_FRAMES, *VGA)).astype(np.int32)
    with torch.no_grad():
        ref_logits = [model(torch.from_numpy(f[None]).to(dev)) for f in frames]
    ref_labels = np.stack([r.argmax(-1).cpu().numpy()[0] for r in ref_logits])
    gap = np.stack([top2_gap(r)[0] for r in ref_logits])

    runs = {}
    for deep in (False, True):
        pi = packed.build_packed_pb_fcn(model, None, torch.float32, pallas=True,
                                        pallas_deep=deep, device=dev)
        with torch.no_grad():
            err = max(float((pi.logits(torch.from_numpy(f[None]).to(dev))
                             - r).abs().max())
                      for f, r in zip(frames[:4], ref_logits[:4]))
        per_frame = 3 if deep else 2
        for depth in (1, 2):
            served = np.zeros((N_FRAMES, *VGA), np.int64)

            def keep(i, labels):
                served[i] = labels

            # --- a main path: the tester's loop, counters around it -------
            fused_conv_chain.launches = 0
            confusion_count.launches = 0
            K1_REC.active = True
            with torch.no_grad():
                acc, t_total, n = tester.serve_and_score(
                    pi.infer, zip(frames, targets), 5, pipeline=depth,
                    on_mask=keep, device=dev)
            K1_REC.active = False
            k2, k1 = fused_conv_chain.launches, confusion_count.launches
            key = f"{'deep' if deep else 'two_chain'}_pipeline{depth}"
            mism = served != ref_labels
            agree = 1.0 - float(mism.mean())
            max_gap = float(gap[mism].max()) if mism.any() else 0.0
            fin = metrics.seg_finalize(acc, 1.0 / (VGA[0] * VGA[1]))
            runs[key] = {"frames": n, "ms_per_frame": t_total / n * 1000,
                         "launches": {"fused_conv_chain": k2,
                                      "confusion_count": k1},
                         "f32_agreement": agree,
                         "mismatch_max_top2_gap": max_gap,
                         "logit_max_abs_err_4_frames": err,
                         "metric_line": metric_line(fin),
                         "pixel_acc": float(fin["pixel_acc"]),
                         "mean_iou": float(fin["mean_iou"])}
            if key == "two_chain_pipeline1":
                float_run = (served.copy(), runs[key])
            chk.expect(n == N_FRAMES, f"tester {key}: served {n} frames")
            chk.expect(k2 == per_frame * N_FRAMES,
                       f"tester {key}: K2 launches {k2} != {per_frame}/frame")
            chk.expect(k1 == N_FRAMES,
                       f"tester {key}: K1 launches {k1} != 1/frame")
            chk.expect(agree >= 0.999, f"tester {key}: f32 agreement {agree}")
            chk.expect(max_gap <= max(1e-4, 2 * err),
                       f"tester {key}: mismatch at a top-2 gap {max_gap} > "
                       f"the tie band {max(1e-4, 2 * err)}")
            if depth == 1:
                lab_d = torch.from_numpy(served).to(dev)
                tgt_d = torch.from_numpy(targets).to(dev)
                a = metrics.to_host(metrics.seg_batch_stats(lab_d, tgt_d, 5,
                                                            device=dev))
                e = metrics.to_host(metrics.seg_batch_stats(
                    lab_d, tgt_d, 5, impl="einsum", device=dev))
                eq = all(np.array_equal(getattr(a, f), getattr(e, f))
                         for f in ("conf", "iou_sum", "lab_cnts", "correct",
                                   "img_cnt"))
                runs[key]["scoring_equal_einsum"] = eq
                chk.expect(eq, f"tester {key}: seg_batch_stats K1 != einsum")
    res["runs"] = runs
    emit(res)
    res["int8"] = phase_tester_int8(model, frames, targets, float_run, dev, chk)
    return res


def metric_line(fin) -> str:
    """The CLIs' printed validation line."""
    return ("Validation Pixel Acc: %.2f Mean Class Acc: %.2f Mean IoU: %.2f"
            % (float(fin["pixel_acc"]), float(fin["mean_class_acc"]),
               float(fin["mean_iou"])))


def phase_tester_int8(model, frames, targets, float_run, dev,
                      chk: Checks) -> dict:
    """``tester.py --noScale --packed --pallas --int8`` as the tester
    builds it (the two-chain f32 PB_FCN graph, quantized on the first
    frame), its frames through ``serve_and_score`` at pipeline 1: the
    counters set to 0 just before the calibration and again before the
    loop; 2 K2 launches (calibration), then 2 K2 and 1 K1 launch a frame, no
    ``chain_reference`` call. Labels held to the same int8 graph through
    ``chain_reference`` on 4 frames (>= 0.999); the metric line beside the
    float run's."""
    from robocupvision_tpu_torch.cli import tester
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops import cuda_packed as ckp
    from robocupvision_tpu_torch.ops import metrics
    from robocupvision_tpu_torch.ops.cuda_kernels import confusion_count

    pi = packed.build_packed_pb_fcn(model, None, torch.float32, pallas=True,
                                    device=dev)
    served = np.zeros((len(frames), *VGA), np.int64)

    def keep(i, labels):
        served[i] = labels

    # --- the main path: calibrate, then the tester's loop ----------------
    ckp.fused_conv_chain.launches = 0
    ckp.chain_reference.calls = 0
    with torch.no_grad():
        q = packed.quantize_int8(pi, frames[0][None])
        cal = ckp.fused_conv_chain.launches
        ckp.fused_conv_chain.launches = 0
        confusion_count.launches = 0
        K1_REC.active = True
        acc, t_total, n = tester.serve_and_score(
            q.infer, zip(frames, targets), 5, pipeline=1, on_mask=keep,
            device=dev)
    K1_REC.active = False
    k2, k1 = ckp.fused_conv_chain.launches, confusion_count.launches
    ref_calls = ckp.chain_reference.calls
    with torch.no_grad():
        via_ref = np.stack([reference_chains(q).infer(
            torch.from_numpy(f[None]).to(dev)).cpu().numpy()[0]
            for f in frames[:4]])
    del q._chain
    fin = metrics.seg_finalize(acc, 1.0 / (VGA[0] * VGA[1]))
    float_served, float_res = float_run
    res = {"phase": "tester_int8", "frames": n, "dtype": "float32",
           "ms_per_frame": t_total / n * 1000,
           "float_ms_per_frame": float_res["ms_per_frame"],
           "calibration_launches": cal,
           "main_path_launches": {"fused_conv_chain": k2,
                                  "confusion_count": k1},
           "chain_reference_calls": ref_calls,
           "metric_line": metric_line(fin),
           "float_metric_line": float_res["metric_line"],
           "agreement_with_chain_reference_4_frames": float(
               (served[:4] == via_ref).mean()),
           "agreement_with_float": float((served == float_served).mean())}
    chk.expect(n == len(frames), f"tester_int8: served {n} frames")
    chk.expect(cal == 2 and k2 == 2 * n and k1 == n,
               f"tester_int8: launches {cal} + {k2} K2, {k1} K1")
    chk.expect(ref_calls == 0, f"tester_int8: chain_reference ran {ref_calls}"
                               " times")
    chk.expect(res["agreement_with_chain_reference_4_frames"] >= 0.999,
               "tester_int8: labels agree "
               f"{res['agreement_with_chain_reference_4_frames']} with "
               "chain_reference")
    emit(res)
    return res


# ---------------------------------------------------------------------------
# LabelProp through validLabelProp's serve-and-score loop
# ---------------------------------------------------------------------------


def phase_valid_label_prop(lp_model, dev, chk: Checks) -> dict:
    """The LabelProp net (planes 32, 5 classes) the way ``validLabelProp.py
    --packed --pallas`` serves it: saved with the port's
    ``checkpoint.save`` and read back with ``load_any``; its ``weightsLP``
    export written (``weights.dat`` must hold LabelProp(32)'s 92,837 float32
    values, ``net.cfg`` must parse); then 32 (2, 120, 160, 8) frame pairs
    from ``build_lp_pairs`` through ``serve_and_score`` on the f32 chain
    graph, the counters set to 0 just before and read just after: 3 K2
    launches and 1 K1 launch a pair. Labels are held to the plain zoo
    forward in f32 (>= 0.999, mismatches only at ties), K1's confusion to
    the einsum's. The plain zoo forward and the plain packed graph go
    through the same loop for their ms per image."""
    from robocupvision_tpu_torch.cli import validLabelProp
    from robocupvision_tpu_torch.cli.labelPropTrain import build_lp_pairs
    from robocupvision_tpu_torch.export import deploy, netcfg
    from robocupvision_tpu_torch.models import packed, zoo
    from robocupvision_tpu_torch.ops import metrics
    from robocupvision_tpu_torch.ops.cuda_kernels import confusion_count
    from robocupvision_tpu_torch.ops.cuda_packed import fused_conv_chain
    from robocupvision_tpu_torch.train import checkpoint

    lp_shape = (120, 160)
    res = {"phase": "valid_label_prop", "pairs": N_FRAMES,
           "shape": [2, *lp_shape, 8], "dtype": "float32"}
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here, prefix=".chip_smoke_") as tmp:
        path = os.path.join(tmp, "pth", "bestModelLP.pth")
        checkpoint.save(path, lp_model.registry, lp_model.state_dict())
        loaded = checkpoint.load_any(path, lp_model.registry)
        model = zoo.make("label_prop", planes=32, num_classes=5, device=dev,
                         generator=torch.Generator().manual_seed(SEED + 98))
        model.load_state_dict(loaded)
        out = deploy.export_deployment(os.path.join(tmp, "weightsLP"), model)
        dat_bytes = os.path.getsize(os.path.join(out, "weights.dat"))
        secs = netcfg.parse_cfg(os.path.join(out, "net.cfg"))
    state = lp_model.state_dict()
    same = list(loaded) == list(state) and all(
        torch.equal(loaded[k], state[k].cpu()) for k in state)
    chk.expect(same, "LabelProp checkpoint did not read back exactly")
    chk.expect(dat_bytes == 92837 * 4,
               f"weightsLP/weights.dat holds {dat_bytes} bytes, not 92837 * 4")
    cfg_ok = (secs[0][0] == "net" and secs[-1][0] == "softmax"
              and sum(name == "convolutional" for name, _ in secs) == 8
              and sum(name == "transposedconv" for name, _ in secs) == 3)
    chk.expect(cfg_ok, "weightsLP/net.cfg does not parse to LabelProp's graph")
    res.update(checkpoint_roundtrip_exact=same, weights_dat_bytes=dat_bytes,
               net_cfg_sections=len(secs), net_cfg_ok=cfg_ok)

    rng = np.random.default_rng(SEED + 8)
    pairs = [build_lp_pairs(
        rng.standard_normal((1, 2, *lp_shape, 3)).astype(np.float32),
        rng.integers(0, 5, (1, 2, *lp_shape)), 5) for _ in range(N_FRAMES)]
    with torch.no_grad():
        ref_logits = [model(torch.from_numpy(x).to(dev)) for x, _ in pairs]
    ref_labels = np.stack([r.argmax(-1).cpu().numpy() for r in ref_logits])
    gap = np.stack([top2_gap(r) for r in ref_logits])

    pi = lp_graph(model, torch.float32, dev)
    with torch.no_grad():
        err = max(float((pi.logits(torch.from_numpy(x).to(dev)) - r)
                        .abs().max()) for (x, _), r in zip(pairs[:4],
                                                         ref_logits[:4]))
    served = np.zeros((N_FRAMES, 2, *lp_shape), np.int64)

    def keep(i, labels):
        served[i // 2, i % 2] = labels

    # --- the main path: validLabelProp's loop, counters around it ----------
    fused_conv_chain.launches = 0
    confusion_count.launches = 0
    K1_REC.active = True
    with torch.no_grad():
        acc, t_total, n = validLabelProp.serve_and_score(
            pi.infer, pairs, 5, on_mask=keep, device=dev)
    K1_REC.active = False
    k2, k1 = fused_conv_chain.launches, confusion_count.launches
    launches = {"fused_conv_chain": k2, "confusion_count": k1}
    mism = served != ref_labels
    agree = 1.0 - float(mism.mean())
    max_gap = float(gap[mism].max()) if mism.any() else 0.0
    fin = metrics.seg_finalize(acc, 1.0 / (lp_shape[0] * lp_shape[1]))
    res.update(images=n, ms_per_image=t_total / n * 1000,
               main_path_launches=launches, f32_agreement=agree,
               mismatch_max_top2_gap=max_gap, logit_max_abs_err_4_pairs=err,
               metric_line=metric_line(fin),
               pixel_acc=float(fin["pixel_acc"]),
               mean_iou=float(fin["mean_iou"]))
    chk.expect(n == 2 * N_FRAMES, f"validLabelProp served {n} images")
    chk.expect(k2 == 3 * N_FRAMES, f"validLabelProp: K2 launches {k2} != 3/pair")
    chk.expect(k1 == N_FRAMES, f"validLabelProp: K1 launches {k1} != 1/pair")
    chk.expect(agree >= 0.999, f"validLabelProp: f32 agreement {agree}")
    chk.expect(max_gap <= max(1e-4, 2 * err),
               f"validLabelProp: mismatch at a top-2 gap {max_gap} > the tie "
               f"band {max(1e-4, 2 * err)}")

    # scoring: K1 (impl auto) equals the plain einsum count, every field
    lab_d = torch.from_numpy(served.reshape(-1, *lp_shape)).to(dev)
    tgt_d = torch.from_numpy(np.concatenate([t for _, t in pairs])).to(dev)
    a = metrics.to_host(metrics.seg_batch_stats(lab_d, tgt_d, 5, device=dev))
    e = metrics.to_host(metrics.seg_batch_stats(lab_d, tgt_d, 5,
                                                impl="einsum", device=dev))
    eq = all(np.array_equal(getattr(a, f), getattr(e, f))
             for f in ("conf", "iou_sum", "lab_cnts", "correct", "img_cnt"))
    res["scoring_equal_einsum"] = eq
    chk.expect(eq, "validLabelProp: seg_batch_stats K1 != einsum")

    # the CLI's other graphs through the same loop, for their ms per image
    plain_packed = packed.build_packed_label_prop(model, None, torch.float32,
                                                  device=dev)
    for tag, infer in (("zoo", lambda x: torch.argmax(model(x), dim=-1)),
                       ("packed", plain_packed.infer)):
        with torch.no_grad():
            _, t, m = validLabelProp.serve_and_score(infer, pairs, 5,
                                                     device=dev)
        res[f"{tag}_ms_per_image"] = t / m * 1000
    emit(res)
    res["int8"] = phase_valid_label_prop_int8(model, pairs, served, res, dev,
                                              chk)
    return res


def phase_valid_label_prop_int8(model, pairs, float_served, float_res, dev,
                                chk: Checks) -> dict:
    """``validLabelProp.py --packed --pallas --int8``: the f32 chain graph
    quantized on the first pair, the pairs through ``serve_and_score``:
    the counters set to 0 just before the calibration and again before the
    loop; 3 K2 launches (calibration), then 3 K2 and 1 K1 launch a pair, no
    ``chain_reference`` call. Labels held to the same int8 graph through
    ``chain_reference`` on 4 pairs (>= 0.999); the metric line beside the
    float run's."""
    from robocupvision_tpu_torch.cli import validLabelProp
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops import cuda_packed as ckp
    from robocupvision_tpu_torch.ops import metrics
    from robocupvision_tpu_torch.ops.cuda_kernels import confusion_count

    pi = lp_graph(model, torch.float32, dev)
    served = np.zeros(float_served.shape, np.int64)

    def keep(i, labels):
        served[i // 2, i % 2] = labels

    # --- the main path: calibrate, then validLabelProp's loop ------------
    ckp.fused_conv_chain.launches = 0
    ckp.chain_reference.calls = 0
    with torch.no_grad():
        q = packed.quantize_int8(pi, pairs[0][0])
        cal = ckp.fused_conv_chain.launches
        ckp.fused_conv_chain.launches = 0
        confusion_count.launches = 0
        K1_REC.active = True
        acc, t_total, n = validLabelProp.serve_and_score(
            q.infer, pairs, 5, on_mask=keep, device=dev)
    K1_REC.active = False
    k2, k1 = ckp.fused_conv_chain.launches, confusion_count.launches
    ref_calls = ckp.chain_reference.calls
    with torch.no_grad():
        via_ref = np.stack([reference_chains(q).infer(
            torch.from_numpy(x).to(dev)).cpu().numpy() for x, _ in pairs[:4]])
    del q._chain
    h, w = float_served.shape[-2:]
    fin = metrics.seg_finalize(acc, 1.0 / (h * w))
    res = {"phase": "valid_label_prop_int8", "images": n, "dtype": "float32",
           "ms_per_image": t_total / n * 1000,
           "float_ms_per_image": float_res["ms_per_image"],
           "calibration_launches": cal,
           "main_path_launches": {"fused_conv_chain": k2,
                                  "confusion_count": k1},
           "chain_reference_calls": ref_calls,
           "metric_line": metric_line(fin),
           "float_metric_line": float_res["metric_line"],
           "agreement_with_chain_reference_4_pairs": float(
               (served[:4] == via_ref).mean()),
           "agreement_with_float": float((served == float_served).mean())}
    chk.expect(n == 2 * len(pairs), f"validLabelProp_int8: served {n} images")
    chk.expect(cal == 3 and k2 == 3 * len(pairs) and k1 == len(pairs),
               f"validLabelProp_int8: launches {cal} + {k2} K2, {k1} K1")
    chk.expect(ref_calls == 0, "validLabelProp_int8: chain_reference ran "
                               f"{ref_calls} times")
    chk.expect(res["agreement_with_chain_reference_4_pairs"] >= 0.999,
               "validLabelProp_int8: labels agree "
               f"{res['agreement_with_chain_reference_4_pairs']} with "
               "chain_reference")
    emit(res)
    return res


# ---------------------------------------------------------------------------
# --UNet and --v2 through test.py's evaluation loop
# ---------------------------------------------------------------------------


def eval_set(n: int, seed: int, size=(240, 320), paint: bool = False):
    """``n`` frames at ``size``, by default test.py's --noScale working
    size: smooth random images (16x16 blocks of normal noise, so a random
    net's maps hold blobs rather than speckle) and labels of a few
    rectangles per class, from a seeded numpy generator. ``paint``: each
    rectangle also painted into the image in its class's colour (plus
    noise), so that a net can learn the labels."""
    h, w = size
    rng = np.random.default_rng(seed)
    low = rng.standard_normal((n, -(-h // 16), -(-w // 16), 3)
                              ).astype(np.float32)
    imgs = np.ascontiguousarray(
        np.repeat(np.repeat(low, 16, axis=1), 16, axis=2)[:, :h, :w])
    labs = np.zeros((n, h, w), np.int32)
    if paint:
        colours = rng.standard_normal((5, 3)).astype(np.float32) * 2
    for i in range(n):
        for c in range(1, 5):
            for _ in range(2):
                y, x = rng.integers(0, h - 40), rng.integers(0, w - 40)
                bh, bw = rng.integers(8, 40, 2)
                labs[i, y:y + bh, x:x + bw] = c
                if paint:
                    imgs[i, y:y + bh, x:x + bw] = colours[c] + 0.3 * \
                        rng.standard_normal((bh, bw, 3)).astype(np.float32)
    return imgs, labs


def phase_test_cli(models: dict, dev, chk: Checks) -> dict:
    """test.py's evaluation loop (``cli/test.py evaluate``, f32, the
    reference's class weights) for each model: 40 frames in a
    ``DeviceCache`` on the card, batch 16, so the last batch holds 8 padded
    samples that its mask drops; the K1 and K2 counters set to 0 just
    before and read just after (1 K1 launch a batch, no K2: test.py runs
    the zoo forward). Then each batch again, outside the counted run: K1
    on the batch's (16, 240, 320) maps must equal its plain count, and the
    masked statistics the two give must be equal. Last, the same loop over
    the same inputs on the CPU: its metric line (loss, score, pixel
    accuracy, class accuracy, IoU) must match within 1e-3, its object-level
    IoU/Dist rates exactly."""
    from robocupvision_tpu_torch.cli import test
    from robocupvision_tpu_torch.data.device_cache import (DeviceCache,
                                                           epoch_batches)
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops.cuda_kernels import (confusion_count,
                                                          confusion_count_plain)
    from robocupvision_tpu_torch.ops.cuda_packed import fused_conv_chain
    from robocupvision_tpu_torch.ops.metrics import seg_batch_stats, to_host
    from robocupvision_tpu_torch.train.step import StepCfg, make_eval_step

    n, batch = 40, 16
    n_batches = -(-n // batch)
    imgs, labs = eval_set(n, SEED + 12)
    out_size = 1.0 / (imgs.shape[1] * imgs.shape[2])
    cfg = StepCfg(num_classes=5, class_weights=(1, 10, 30, 5, 2),
                  out_size=out_size)
    d_thresholds = [d * 2 for d in test.D_THRESHOLDS]
    res = {"phase": "test_cli", "frames": n, "batch": batch,
           "shape": list(imgs.shape), "dtype": "float32", "runs": {}}
    for tag, model in models.items():
        cache = DeviceCache.from_numpy(imgs, labs, device=dev)
        # --- a main path: test.py's loop, the counters around it ----------
        confusion_count.launches = fused_conv_chain.launches = 0
        K1_REC.active = True
        t0 = time.perf_counter()
        card = test.evaluate(model, epoch_batches(cache, batch), cfg,
                             test.THRESHOLDS, d_thresholds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        K1_REC.active = False
        launches = {"confusion_count": confusion_count.launches,
                    "fused_conv_chain": fused_conv_chain.launches}
        # K1 against its plain count on every batch of that loop
        step = make_eval_step(model, cfg)
        k1_equal, stats_equal, padded = True, True, 0
        for x, tgt, mask in epoch_batches(cache, batch):
            pred = step(x, tgt, mask)["pred"]
            k1_equal &= torch.equal(confusion_count(pred, tgt, 5),
                                    confusion_count_plain(pred, tgt, 5))
            got, want = (to_host(seg_batch_stats(pred, tgt, 5, mask, impl=i,
                                                 device=dev))
                         for i in ("auto", "einsum"))
            stats_equal &= all(np.array_equal(getattr(got, f.name),
                                              getattr(want, f.name))
                               for f in dataclasses.fields(got))
            padded += int((mask == 0).sum())
        cpu_model = zoo.make("robo_unet", device="cpu", **{
            f.name: getattr(model.cfg, f.name)
            for f in dataclasses.fields(model.cfg)})
        cpu_model.load_state_dict(model.state_dict())
        cpu = test.evaluate(cpu_model, epoch_batches(DeviceCache.from_numpy(
            imgs, labs, device="cpu"), batch), cfg, test.THRESHOLDS,
            d_thresholds)
        line, cpu_line = (test.metric_line(0.0, r, out_size)
                          for r in (card, cpu))
        diff = max(abs(a - b) for a, b in zip(
            test.metric_values(0.0, card, out_size),
            test.metric_values(0.0, cpu, out_size)))
        obj_diff = float(max(np.abs(card["iou"] - cpu["iou"]).max(),
                             np.abs(card["dist"] - cpu["dist"]).max()))
        res["runs"][tag] = {"metric_line": line, "cpu_metric_line": cpu_line,
                            "max_abs_diff": diff, "iou": card["iou"].tolist(),
                            "dist": card["dist"].tolist(),
                            "iou_dist_max_abs_diff_vs_cpu": obj_diff,
                            "k1_equal_plain_every_batch": k1_equal,
                            "masked_stats_equal_plain": stats_equal,
                            "padded_samples": padded,
                            "launches": launches,
                            "batches": card["batches"], "seconds": wall}
        chk.expect(card["batches"] == n_batches and card["images"] == n
                   and padded == n_batches * batch - n,
                   f"test_cli {tag}: {card['batches']} batches, "
                   f"{card['images']} images, {padded} padded")
        chk.expect(launches == {"confusion_count": n_batches,
                                "fused_conv_chain": 0},
                   f"test_cli {tag}: launches {launches}, want 1 K1 a "
                   f"batch and no K2")
        chk.expect(k1_equal and stats_equal,
                   f"test_cli {tag}: K1 or its masked statistics != plain")
        chk.expect(diff <= 1e-3,
                   f"test_cli {tag}: metric line {line} vs the CPU's "
                   f"{cpu_line}")
        chk.expect(obj_diff == 0,
                   f"test_cli {tag}: IoU/Dist rates differ from the CPU's "
                   f"by {obj_diff}")
    emit(res)
    return res


# ---------------------------------------------------------------------------
# training: train.py's per-combo loop on the flagship at QVGA
# ---------------------------------------------------------------------------

TRAIN_N, VAL_N, TRAIN_EPOCHS = 512, 120, 3


def phase_train(dev, chk: Checks) -> dict:
    """train.py's combo (``cli/train.py train_combo``) on the flagship at
    full width at the default QVGA working size (120x160), batch 64 (what
    train.py uses without --noScale), on 512 train and 120 val frames made
    from a seeded numpy generator (``eval_set``) and held in
    ``DeviceCache``s on the card (the last validation batch has 8 padded
    samples): 3 epochs in f32, then 3 with --bf16, ``--chunkEpochs 1`` so
    that each epoch ends in its metric fetch. The counters are set to 0
    just before each run and read just after: K1 once per validation batch
    and epoch, no K2 or K3. Steps/s from epochs 2 and 3 (host clock from
    the end of epoch 1 to the end of epoch 3, each epoch with its
    validation and fetch). The train loss must fall, and the best
    checkpoint (written in a temporary directory) must read back and score
    its epoch's score within 1e-3; on each validation batch of that
    re-scoring K1 must equal its plain count and the masked statistics
    through K1 those through the plain count. Then one train step (plain
    SGD, lr 0.1, so the parameters move by the gradients) from the same
    weights, batch and draws on the card and on the CPU: every parameter
    and running statistic within rtol = atol = 1e-3 in f32 (cuDNN against
    the CPU's convs), and the train step alone timed on the card at b64,
    f32 and bf16, and five more under ``torch.profiler`` (``step_profile``:
    kernel time, kernels a step and the card's idle share)."""
    from robocupvision_tpu_torch.cli import train
    from robocupvision_tpu_torch.data.device_cache import (DeviceCache,
                                                           epoch_batches)
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops import color
    from robocupvision_tpu_torch.ops.cuda_kernels import (
        confusion_count, confusion_count_plain, fused_conv3x3_block)
    from robocupvision_tpu_torch.ops.cuda_packed import fused_conv_chain
    from robocupvision_tpu_torch.ops.metrics import (seg_batch_stats,
                                                     seg_finalize, to_host)
    from robocupvision_tpu_torch.train import checkpoint, optim
    from robocupvision_tpu_torch.train import step as tstep

    size = (120, 160)
    imgs, labs = eval_set(TRAIN_N + VAL_N, SEED + 30, size, paint=True)
    train_cache = DeviceCache.from_numpy(imgs[:TRAIN_N], labs[:TRAIN_N],
                                         device=dev)
    val_cache = DeviceCache.from_numpy(imgs[TRAIN_N:], labs[TRAIN_N:],
                                       device=dev)
    batch = 64
    nb, vnb = -(-TRAIN_N // batch), -(-VAL_N // batch)
    res = {"phase": "train", "model": "robo_unet flagship (model_hyper)",
           "shape": [batch, *size, 3], "train_frames": TRAIN_N,
           "val_frames": VAL_N, "epochs": TRAIN_EPOCHS, "runs": {}}
    here = os.path.dirname(os.path.abspath(__file__))
    cwd = os.getcwd()
    for tag, extra in (("f32", []), ("bf16", ["--bf16"])):
        opt = train.build_parser().parse_args(
            ["--epochs", str(TRAIN_EPOCHS), "--chunkEpochs", "1"] + extra)
        setup = train.Setup.from_opt(opt)
        marks, losses = [], []

        def after_chunk(off, ms):
            marks.append(time.perf_counter())
            losses.extend(float(v) for v in ms["train_loss"])

        with tempfile.TemporaryDirectory(dir=here,
                                         prefix=".chip_smoke_") as tmp:
            os.chdir(tmp)
            try:
                # --- a main path: train.py's combo, the counters around it
                confusion_count.launches = fused_conv_chain.launches = 0
                K1_REC.active = True
                fused_conv3x3_block.launches = 0
                t0 = time.perf_counter()
                best = train.train_combo(setup, train_cache, val_cache, 0,
                                         opt.decay / 10, dev,
                                         after_chunk=after_chunk)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                K1_REC.active = False
                launches = {"confusion_count": confusion_count.launches,
                            "fused_conv_chain": fused_conv_chain.launches,
                            "fused_conv3x3_block": fused_conv3x3_block.launches}
                model = zoo.make("robo_unet", device=dev,
                                 **train.model_hyper(False, False))
                state = checkpoint.load_any("checkpoints/best.weights",
                                            model.registry)
            finally:
                os.chdir(cwd)
        model.load_state_dict(state)
        # the best checkpoint re-scored, and K1 against its plain count on
        # every validation batch at the shapes of that run
        ev = tstep.make_eval_step(model, train.step_cfg(setup, 0.0))
        ncls = setup.flags.num_classes
        acc, k1_equal, stats_equal, padded = None, True, True, 0
        for x, tgt, mask in epoch_batches(val_cache, batch):
            out = ev(x, tgt, mask)
            acc = out["acc"] if acc is None else acc + out["acc"]
            pred = out["pred"]
            k1_equal &= torch.equal(confusion_count(pred, tgt, ncls),
                                    confusion_count_plain(pred, tgt, ncls))
            got, want = (to_host(seg_batch_stats(pred, tgt, ncls, mask,
                                                 impl=i, device=dev))
                         for i in ("auto", "einsum"))
            stats_equal &= all(np.array_equal(getattr(got, f.name),
                                              getattr(want, f.name))
                               for f in dataclasses.fields(got))
            padded += int((mask == 0).sum())
        rescore = float(seg_finalize(acc, setup.out_size)["score"])
        steps_per_s = 2 * nb / (marks[2] - marks[0])
        finite = all(bool(torch.isfinite(v).all()) for v in state.values())
        res["runs"][tag] = {
            "train_loss": losses, "best_score": best,
            "checkpoint_rescore": rescore, "checkpoint_finite": finite,
            "k1_equal_plain": k1_equal, "stats_equal_plain": stats_equal,
            "val_padded_samples": padded,
            "launches": launches, "steps_per_s_epochs_2_3": steps_per_s,
            "epoch_s": [marks[0] - t0] + [b - a for a, b in
                                          zip(marks, marks[1:])],
            "seconds": wall}
        chk.expect(launches == {"confusion_count": vnb * TRAIN_EPOCHS,
                                "fused_conv_chain": 0,
                                "fused_conv3x3_block": 0},
                   f"train {tag}: launches {launches}, want "
                   f"{vnb * TRAIN_EPOCHS} K1 and no K2, K3")
        chk.expect(len(losses) == TRAIN_EPOCHS and losses[-1] < losses[0],
                   f"train {tag}: train loss {losses} does not fall")
        chk.expect(finite and abs(rescore - best) <= 1e-3,
                   f"train {tag}: best checkpoint scores {rescore}, its "
                   f"epoch {best}")
        chk.expect(k1_equal and stats_equal
                   and padded == vnb * batch - VAL_N,
                   f"train {tag}: on the validation batches K1 equal to "
                   f"plain {k1_equal}, masked statistics equal "
                   f"{stats_equal}, {padded} padded samples")

    # one train step on the card and on the CPU, and the step's own time
    model = zoo.make("robo_unet", device=dev,
                     generator=torch.Generator().manual_seed(SEED + 31),
                     **train.model_hyper(False, False))
    cpu_model = zoo.make("robo_unet", device="cpu",
                         **train.model_hyper(False, False))
    cpu_model.load_state_dict(model.state_dict())
    cfg = tstep.StepCfg(num_classes=5, class_weights=(1, 10, 30, 10, 2),
                        l1_decay=1e-6, out_size=1.0 / (size[0] * size[1]))
    x, tgt, mask = next(epoch_batches(train_cache, 8))
    mask = mask.clone()
    mask[-1] = 0  # one padded slot
    draws = color.draw_augment(torch.Generator().manual_seed(SEED + 32), 8)
    outs = []
    for m, d in ((model, dev), (cpu_model, torch.device("cpu"))):
        fn = tstep.make_train_step(m, optim.sgd(), cfg)
        st = tstep.init_state(m, optim.sgd())
        outs.append(fn(st, x.to(d), tgt.to(d), mask.to(d),
                       {k: v.to(d) for k, v in draws.items()}, 0.1, None))
    (gst, gout), (cst, cout) = outs
    worst, worst_name = 0.0, ""
    for k, v in cst.params.items():
        d = (gst.params[k].cpu() - v).abs() - 1e-3 * v.abs()
        if float(d.max()) > worst or not worst_name:
            worst, worst_name = float(d.max()), k
    step_ok = worst <= 1e-3
    res["card_vs_cpu_step"] = {
        "batch": 8, "optimizer": "sgd", "lr": 0.1,
        "loss": [float(gout["loss"]), float(cout["loss"])],
        "worst_abs_err_over_rtol": worst, "worst_param": worst_name}
    chk.expect(step_ok and abs(float(gout["loss"]) - float(cout["loss"]))
               <= 1e-3 * abs(float(cout["loss"])),
               f"train: the card's step differs from the CPU's: {worst} at "
               f"{worst_name}, loss {float(gout['loss'])} vs "
               f"{float(cout['loss'])}")
    tx = optim.adam()
    step_ms, profile = {}, {}
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        fn = tstep.make_train_step(model, tx, dataclasses.replace(
            cfg, compute_dtype=dtype))
        st = tstep.init_state(model, tx)
        xb, tb, mb = next(epoch_batches(train_cache, batch))
        gen = torch.Generator(device=dev).manual_seed(SEED + 33)

        def one():
            nonlocal st
            st, _ = fn(st, xb, tb, mb, color.draw_augment(gen, batch), 1e-3,
                       None)

        for _ in range(3):
            one()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            one()
        torch.cuda.synchronize()
        step_ms[tag] = (time.perf_counter() - t0) / 20 * 1e3
        profile[tag] = step_profile(one, 5)
    res["train_step_ms_b64"] = step_ms
    res["train_steps_per_s_b64"] = {k: 1e3 / v for k, v in step_ms.items()}
    res["train_step_profile_b64"] = profile
    # the card's idle share of the step timed without the profiler: its
    # kernel time under the profiler over that step's wall time
    res["train_step_idle_share_b64"] = {
        k: (None if profile[k]["device_ms"] is None
            else 1 - profile[k]["device_ms"] / step_ms[k]) for k in step_ms}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# The legacy pipeline (classTrainer -> trainer -> labelPropTrain) and the
# trained-net int8 envelope
# ---------------------------------------------------------------------------


def draw_scene(rng, h: int, w: int):
    """One synthetic RoboCup frame, as tests/synth_data.py draws it: a
    field gradient, a line stripe (4), goal posts (3), a robot box (2) and
    a ball disc (1) -> (RGB in [0, 1] float32 (h, w, 3), labels int32)."""
    img = np.zeros((h, w, 3), np.float32)
    img[..., 1] = np.linspace(0.2, 0.5, h)[:, None]
    lab = np.zeros((h, w), np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    ly = rng.integers(h // 4, 3 * h // 4)
    stripe = (yy >= ly) & (yy < ly + max(h // 16, 1))
    img[stripe], lab[stripe] = 0.9, 4
    gx = rng.integers(0, w - w // 8)
    post = (xx >= gx) & (xx < gx + max(w // 20, 1)) & (yy < h // 2)
    img[post], lab[post] = [0.8, 0.1, 0.1], 3
    rx, ry = rng.integers(0, w - w // 5), rng.integers(h // 3, h - h // 4)
    box = (xx >= rx) & (xx < rx + w // 6) & (yy >= ry) & (yy < ry + h // 5)
    img[box], lab[box] = [0.1, 0.7, 0.2], 2
    cx, cy, r = rng.integers(0, w), rng.integers(h // 2, h), max(h // 10, 2)
    disc = (xx - cx) ** 2 + (yy - cy) ** 2 < r ** 2
    img[disc], lab[disc] = [0.1, 0.2, 0.9], 1
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.round(np.clip(img, 0, 1) * 255) / 255, lab


def scene_set(n: int, seed: int, size):
    """n scenes: RGB (n, h, w, 3) in [0, 1] and labels (n, h, w) int32."""
    rng = np.random.default_rng(seed)
    rgb, labs = zip(*(draw_scene(rng, *size) for _ in range(n)))
    return np.stack(rgb).astype(np.float32), np.stack(labs)


def patch_set(n: int, seed: int, size: int = 32):
    """n classification patches of four classes (background, ball, robot,
    goal, drawn as tests/synth_data.py draws them) as ImageFolder gives
    them (ToYUV, Normalize), with their class indices."""
    from robocupvision_tpu_torch.data.datasets import legacy_normalize

    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 4, n).astype(np.int32)
    yy, xx = np.mgrid[0:size, 0:size]
    imgs = np.full((n, size, size, 3), 0.3, np.float32)
    for i, c in enumerate(cls):
        if c == 1:
            imgs[i][(xx - size // 2) ** 2 + (yy - size // 2) ** 2
                    < (size // 3) ** 2] = [0.1, 0.2, 0.9]
        elif c == 2:
            imgs[i, size // 4:3 * size // 4, size // 4:3 * size // 4] = \
                [0.1, 0.7, 0.2]
        elif c == 3:
            imgs[i, :, size // 3:size // 2] = [0.8, 0.1, 0.1]
    imgs += rng.normal(0, 0.05, imgs.shape).astype(np.float32)
    return legacy_normalize(np.clip(imgs, 0, 1)), cls


def lp_pair_set(n: int, seed: int, size):
    """n LabelProp frame pairs (a scene and the scene moved 2 pixels right,
    as tests/synth_data.py's sequences move), YUV-normalized as LPDataSet
    gives the synthetic domain, through ``build_lp_pairs``: (2n, h, w, 8)
    inputs and (2n, h, w) targets."""
    from robocupvision_tpu_torch.cli.labelPropTrain import build_lp_pairs
    from robocupvision_tpu_torch.data.datasets import _cv2_rgb2yuv
    from robocupvision_tpu_torch.ops.color import (MEAN_SYNTHETIC,
                                                   STD_SYNTHETIC)

    rgb, labs = scene_set(n, seed, size)
    rgb = np.stack([rgb, np.roll(rgb, 2, axis=2)], axis=1)
    labs = np.stack([labs, np.roll(labs, 2, axis=2)], axis=1)
    yuv = (_cv2_rgb2yuv(rgb) - np.asarray(MEAN_SYNTHETIC, np.float32)) \
        / np.asarray(STD_SYNTHETIC, np.float32)
    return build_lp_pairs(yuv.astype(np.float32), labs, 5)


class Tee(io.TextIOBase):
    """Writes go on to ``out`` and into ``text``."""

    def __init__(self, out) -> None:
        self.out, self.buf = out, io.StringIO()

    def write(self, s: str) -> int:
        self.out.write(s)
        return self.buf.write(s)

    def flush(self) -> None:
        self.out.flush()

    @property
    def text(self) -> str:
        return self.buf.getvalue()


@contextlib.contextmanager
def plateau_runs(patience: int):
    """Runs every ``run_plateau_training`` call made inside (the CLIs'
    loops build their own Trainer) with the plateau's ``patience`` set to
    the given one; yields a list that gets each call's Trainer and prune
    masks."""
    from robocupvision_tpu_torch.train import legacy

    real, seen = legacy.run_plateau_training, []

    def run(tr, *a, **kw):
        kw["patience"] = patience
        seen.append((tr, kw.get("prune_masks")))
        return real(tr, *a, **kw)

    legacy.run_plateau_training = run
    try:
        yield seen
    finally:
        legacy.run_plateau_training = real


def time_train_step(tr, dev, prune_masks=None) -> dict:
    """The loop's own train step (``tr.train_step``, its draws and the
    loop's ``prune_masks`` gradient masking included) on the first batch
    of its train cache at its batch: 20 steps after 3 on the host clock
    (synchronised), then 5 under ``torch.profiler``; the card's idle share
    is the profiler's kernel time a step over the unprofiled step's
    time."""
    from robocupvision_tpu_torch.data.device_cache import epoch_batches

    x, t, m = next(epoch_batches(tr.train_cache, tr.batch_size))
    st = tr.state
    n = m.shape[0]
    masks = None if prune_masks is None else {
        k: torch.as_tensor(v).to(dev) for k, v in prune_masks.items()}

    def one():
        nonlocal st
        st, _ = tr.train_step(st, x, t, m, tr.draw_augment(n)
                              if tr.cfg.augment else None, 1e-3, masks,
                              tr.draw_dropout(n))

    for _ in range(3):
        one()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(20):
        one()
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) / 20 * 1e3
    prof = step_profile(one, 5)
    return {"step_ms": ms, "step_profile": prof,
            "idle_share": None if prof["device_ms"] is None
            else 1 - prof["device_ms"] / ms}


def card_vs_cpu_step(tr, dev) -> dict:
    """One SGD step (momentum 0.9, weight decay 1e-3, lr 0.1) of the
    loop's net and step configuration from its trained params, on a batch
    of 8 with one padded slot and the same augmentation draws and dropout
    masks, on the card and on the CPU: the worst |card - CPU| over
    rtol 1e-3 of every parameter and running statistic, and the losses."""
    from robocupvision_tpu_torch.data.device_cache import epoch_batches
    from robocupvision_tpu_torch.models import layers, zoo
    from robocupvision_tpu_torch.ops import color
    from robocupvision_tpu_torch.train import optim
    from robocupvision_tpu_torch.train import step as tstep

    cpu_model = zoo.make(tr.model.family, device="cpu",
                         **dataclasses.asdict(tr.model.cfg))
    x, t, m = next(epoch_batches(tr.train_cache, 8))
    m = m.clone()
    m[-1] = 0
    gen = torch.Generator().manual_seed(SEED + 60)
    draws = color.AUGMENT_MODES[tr.cfg.augment_mode][0](gen, 8)
    keep = cpu_model.draw_dropout(gen, 8)
    outs = []
    for model, d in ((tr.model, dev), (cpu_model, torch.device("cpu"))):
        tx = optim.sgd(0.9, 1e-3)
        params = {k: v.detach().to(d).clone()
                  for k, v in tr.state.params.items()}
        st = tstep.TrainState(params, tx.init(layers.split_params(params)[0]))
        fn = tstep.make_train_step(model, tx, tr.cfg)
        outs.append(fn(st, x.to(d), t.to(d), m.to(d),
                       {k: v.to(d) for k, v in draws.items()}, 0.1, None,
                       None if keep is None
                       else {k: v.to(d) for k, v in keep.items()}))
    (gst, gout), (cst, cout) = outs
    worst, name = -1.0, ""
    for k, v in cst.params.items():
        e = float(((gst.params[k].cpu() - v).abs() - 1e-3 * v.abs()).max())
        if e > worst:
            worst, name = e, k
    return {"loss": [float(gout["loss"]), float(cout["loss"])],
            "worst_abs_err_over_rtol": worst, "worst_param": name}


LEGACY_CLASS_N, LEGACY_SEG_N, LEGACY_LP_N = (128, 48), (96, 40), (32, 12)


def phase_legacy_train(dev, chk: Checks, smi: str) -> list:
    """The legacy pipeline's three training loops at full width, each the
    way its CLI runs it, on in-memory frames from seeded generators (the
    card's machine has no Pillow to read PNGs): ``classTrainer
    .train_classifier`` (PB_FCN planes 32 with kernel 1, then ``--v2``'s
    PB_FCN_2 at its defaults; 32x32 patches of four classes, batch 32 and
    64), ``trainer.train_segmenter`` (PB_FCN from the classifier's
    checkpoint at the CLI's scale-4 working size 120x160, batch 32, then
    ``--finetune --prune`` from its output, batch 8) and
    ``labelPropTrain.train_label_prop`` (LabelProp planes 32, 120x160 pairs
    from ``build_lp_pairs``, batch 16), in that order, in a temporary
    working directory. The counters are set to 0 just before each loop and
    read just after: K1 once per segmentation validation batch and epoch
    (none when classifying: ``class_batch_stats`` is plain), and K1's
    counts on every such batch equal to ``confusion_count_plain``
    (``K1Recorder.verify``); no K2 or K3. Each loop must write the CLI's
    checkpoint name and its train loss (its printed lines) must be finite
    and fall; ``plateau_runs`` sets the plateau's patience to -1 in the
    first loop, so that it fires and rolls back to the best checkpoint
    after every epoch, and to 0 in the others. After ``--prune`` every band-pruned weight
    must still be 0. Then each loop's own train step is timed at its
    batch with its prune masks (``time_train_step``) and one SGD step of its net on the card
    held within rtol = atol = 1e-3 of the CPU's (``card_vs_cpu_step``)."""
    import shutil

    from robocupvision_tpu_torch.cli import classTrainer, labelPropTrain, trainer
    from robocupvision_tpu_torch.data.device_cache import (DeviceCache,
                                                           num_batches)
    from robocupvision_tpu_torch.data.datasets import legacy_normalize
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops import pruning
    from robocupvision_tpu_torch.train import checkpoint

    def caches(imgs, labs, n_train):
        return (DeviceCache.from_numpy(imgs[:n_train], labs[:n_train],
                                       device=dev),
                DeviceCache.from_numpy(imgs[n_train:], labs[n_train:],
                                       device=dev))

    size = (120, 160)
    imgs, labs = patch_set(sum(LEGACY_CLASS_N), SEED + 50)
    class_sets = caches(imgs, labs, LEGACY_CLASS_N[0])
    rgb, labs = scene_set(sum(LEGACY_SEG_N), SEED + 51, size)
    seg_sets = caches(legacy_normalize(rgb), labs, LEGACY_SEG_N[0])
    inputs, targets = lp_pair_set(sum(LEGACY_LP_N), SEED + 52, size)
    lp_sets = caches(inputs, targets, 2 * LEGACY_LP_N[0])
    # (loop, CLI module, loop function, argv, caches, patience, checkpoint)
    loops = [
        ("train_classifier", classTrainer, classTrainer.train_classifier,
         ["--epochs", "4"], class_sets, -1, "pth/bestModel.pth"),
        ("train_classifier --v2", classTrainer, classTrainer.train_classifier,
         ["--epochs", "3", "--v2"], class_sets, 0, "pth/bestModelv2.pth"),
        ("train_segmenter", trainer, trainer.train_segmenter,
         ["--epochs", "4"], seg_sets, 0, "pth/bestModelSeg.pth"),
        ("train_segmenter --finetune --prune", trainer,
         trainer.train_segmenter, ["--epochs", "3", "--finetune", "--prune"],
         seg_sets, 0, "pth/bestModelSegbothFinetunedPruned.pth"),
        ("train_label_prop", labelPropTrain, labelPropTrain.train_label_prop,
         ["--epochs", "4"], lp_sets, 0, "pth/bestModelLP.pth"),
    ]
    results = []
    here = os.path.dirname(os.path.abspath(__file__))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=here, prefix=".chip_smoke_") as tmp:
        os.chdir(tmp)
        try:
            for name, cli, fn, argv, (tc, vc), patience, ckpt in loops:
                opt = cli.build_parser().parse_args(argv)
                if opt.__dict__.get("prune"):
                    # --finetune --prune starts from the segmenter's output
                    shutil.copy("pth/bestModelSeg.pth",
                                "pth/bestModelSegbothFinetuned.pth")
                tee = Tee(sys.stdout)
                # --- a main path: the CLI's loop, the counters around it
                with plateau_runs(patience) as seen, \
                        contextlib.redirect_stdout(tee):
                    best, launches, verified, unequal, wall = counted_run(
                        lambda: fn(opt, tc, vc, dev))
                tr, prune_masks = seen[0]
                text = tee.text
                train_loss = [float(v) for v in re.findall(
                    r"Epoch \[\d+\] Training Loss: (\S+)", text)]
                segment = tr.cfg.loss != "ce"
                want_k1 = opt.epochs * num_batches(vc.n, tr.batch_size) \
                    if segment else 0
                res = {"phase": "legacy_train", "loop": name,
                       "family": tr.model.family,
                       "cfg": dataclasses.asdict(tr.model.cfg),
                       "batch": tr.batch_size,
                       "input": list(tc.images.shape[1:]),
                       "train_n": tc.n, "val_n": vc.n, "epochs": opt.epochs,
                       "patience": patience, "train_loss": train_loss,
                       "best_val_loss": best["loss"],
                       "best_val_acc": best["acc"],
                       "rollbacks": text.count("Best Model reloaded"),
                       "checkpoint": ckpt,
                       "checkpoint_written": os.path.exists(ckpt),
                       "launches": launches,
                       "k1_verified": verified,
                       "k1_unequal_plain": unequal,
                       "seconds": wall}
                if opt.__dict__.get("prune"):
                    reg = tr.model.registry
                    _, masks = pruning.prune_band(checkpoint.load_any(
                        "pth/bestModelSegbothFinetuned.pth", reg), reg,
                        verbose=False)
                    out = checkpoint.load_any(ckpt, reg)
                    res["pruned_nonzero"] = sum(
                        int((out[k][m] != 0).sum()) for k, m in masks.items())
                    res["pruned_share"] = float(sum(
                        int(m.sum()) for m in masks.values()) / sum(
                        m.numel() for m in masks.values()))
                    chk.expect(res["pruned_nonzero"] == 0,
                               f"legacy {name}: {res['pruned_nonzero']} "
                               "band-pruned weights moved off 0")
                res.update(time_train_step(tr, dev, prune_masks))
                res["card_vs_cpu_step"] = card_vs_cpu_step(tr, dev)
                res["card"] = smi
                emit(res)
                results.append(res)
                step = res["card_vs_cpu_step"]
                chk.expect(res["checkpoint_written"],
                           f"legacy {name}: no {ckpt}")
                chk.expect(len(train_loss) == opt.epochs
                           and all(np.isfinite(train_loss))
                           and train_loss[-1] < train_loss[0],
                           f"legacy {name}: train loss {train_loss} does not "
                           "fall")
                chk.expect(launches == {"confusion_count": want_k1,
                                        "fused_conv_chain": 0,
                                        "fused_conv3x3_block": 0},
                           f"legacy {name}: launches {launches}, want "
                           f"{want_k1} K1 and no K2, K3")
                chk.expect(verified == want_k1 and unequal == 0,
                           f"legacy {name}: K1 equal to plain on "
                           f"{verified - unequal} of {want_k1} validation "
                           "batches")
                chk.expect(step["worst_abs_err_over_rtol"] <= 1e-3
                           and abs(step["loss"][0] - step["loss"][1])
                           <= 1e-3 * abs(step["loss"][1]),
                           f"legacy {name}: the card's SGD step differs from "
                           f"the CPU's: {step}")
        finally:
            os.chdir(cwd)
    chk.expect(sum(r["rollbacks"] for r in results) >= 1,
               "legacy: no plateau rollback")
    return results


# ---------------------------------------------------------------------------
# The rest of training: the packed and remat steps, the streamed epoch and
# the classifier baselines' loops
# ---------------------------------------------------------------------------


def counted_run(fn):
    """``fn()`` as a main path: the launch counters set to 0 just before
    and read just after, K1 held to its plain count on every call
    (``K1Recorder.verify``). -> (fn's result, launches, K1 calls verified,
    K1 calls unequal to plain, seconds)."""
    from robocupvision_tpu_torch.ops.cuda_kernels import (confusion_count,
                                                          fused_conv3x3_block)
    from robocupvision_tpu_torch.ops.cuda_packed import fused_conv_chain

    confusion_count.launches = fused_conv_chain.launches = 0
    fused_conv3x3_block.launches = 0
    K1_REC.active = K1_REC.verify = True
    K1_REC.verified = K1_REC.unequal = 0
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        K1_REC.active = K1_REC.verify = False
    wall = time.perf_counter() - t0
    return out, {"confusion_count": confusion_count.launches,
                 "fused_conv_chain": fused_conv_chain.launches,
                 "fused_conv3x3_block": fused_conv3x3_block.launches}, \
        K1_REC.verified, K1_REC.unequal, wall


def worst_over_tol(got, want, rtol: float) -> tuple:
    """max over every tensor of max(|got - want| - rtol * |want|), and the
    name where it is largest (compare with the atol)."""
    worst, name = -1.0, ""
    for k, v in want.items():
        e = float(((got[k] - v).abs() - rtol * v.abs()).max())
        if e > worst:
            worst, name = e, k
    return worst, name


TRAIN_VARIANTS = {"plain": {}, "packed": dict(packed=True),
                  "remat_dots": dict(remat="dots"),
                  "remat_full": dict(remat="full")}


def phase_train_variants(dev, chk: Checks, smi: str) -> dict:
    """The train step's variants (``StepCfg.packed``, ``remat`` "dots"
    and "full") on the flagship ROBO-UNet at its defaults, QVGA 120x160,
    b64, class weights (1, 10, 30, 10, 2), L1 1e-6, Adam (the JAX bench's
    setting), beside the plain step from the same weights. Main paths,
    one per variant, with the counters set to 0 just before and read just
    after: a Trainer epoch (512 seeded frames, f32) and its validation
    (120 frames, the last batch with 8 padded samples), K1 once per
    validation batch and equal to ``confusion_count_plain`` on each, no K2
    or K3. Then each variant's step alone in f32 (no TF32) and bf16: ms a
    step (10 steps after 2, host clock, synchronised), kernels a step and
    the card's idle share (``step_profile``, 3 steps), and the peak memory
    of one step (``max_memory_allocated`` after
    ``reset_peak_memory_stats``). Held on the card: one plain-SGD packed
    step (lr 1e-2, one padded sample, the same draws) against the
    unpacked one at atol 1e-5 / rtol 1e-4, and the dots and full steps
    against none at atol = rtol = 1e-4, beside the gap between two runs
    of the plain step."""
    from robocupvision_tpu_torch.cli import train
    from robocupvision_tpu_torch.data.device_cache import (DeviceCache,
                                                           epoch_batches,
                                                           num_batches)
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops import color
    from robocupvision_tpu_torch.train import optim
    from robocupvision_tpu_torch.train import step as tstep
    from robocupvision_tpu_torch.train.loop import Trainer

    size, batch = (120, 160), 64
    imgs, labs = eval_set(TRAIN_N + VAL_N, SEED + 70, size, paint=True)
    train_cache = DeviceCache.from_numpy(imgs[:TRAIN_N], labs[:TRAIN_N],
                                         device=dev)
    val_cache = DeviceCache.from_numpy(imgs[TRAIN_N:], labs[TRAIN_N:],
                                       device=dev)
    model = zoo.make("robo_unet", device=dev,
                     generator=torch.Generator().manual_seed(SEED + 71),
                     **train.model_hyper(False, False))
    base = tstep.StepCfg(num_classes=5, class_weights=(1, 10, 30, 10, 2),
                         l1_decay=1e-6, out_size=1.0 / (size[0] * size[1]))
    vnb = num_batches(VAL_N, batch)
    t_phase = time.perf_counter()
    res = {"phase": "train_variants", "model": "robo_unet flagship "
           "(model_hyper)", "shape": [batch, *size, 3], "optimizer": "adam",
           "card": smi, "main_paths": {}, "steps": {}}
    for tag, kw in TRAIN_VARIANTS.items():
        if tag == "plain":  # phase_train's main path
            continue
        tr = Trainer(model, optim.adam(), dataclasses.replace(base, **kw),
                     train_cache, val_cache, batch, seed=SEED + 72)
        tr.init()
        (ep, val), launches, verified, unequal, wall = counted_run(
            lambda: (tr.train_epoch(1e-3), tr.valid_epoch()))
        res["main_paths"][tag] = {
            "train_loss": ep.loss, "val_loss": val["loss"],
            "val_score": val["score"], "launches": launches,
            "k1_per_validation_epoch": launches["confusion_count"],
            "k1_verified": verified, "k1_unequal_plain": unequal,
            "seconds": wall}
        chk.expect(launches == {"confusion_count": vnb,
                                "fused_conv_chain": 0,
                                "fused_conv3x3_block": 0},
                   f"train_variants {tag}: launches {launches}, want {vnb} "
                   "K1 and no K2, K3")
        chk.expect(verified == vnb and unequal == 0,
                   f"train_variants {tag}: K1 equal to plain on "
                   f"{verified - unequal} of {vnb} validation batches")
        chk.expect(bool(np.isfinite([ep.loss, val["loss"]]).all()),
                   f"train_variants {tag}: loss {ep.loss}, {val['loss']}")

    xb, tb, mb = next(epoch_batches(train_cache, batch))
    tx = optim.adam()
    for dt in ("float32", "bfloat16"):
        for tag, kw in TRAIN_VARIANTS.items():
            fn = tstep.make_train_step(model, tx, dataclasses.replace(
                base, compute_dtype=dt, **kw))
            st = tstep.init_state(model, tx)
            gen = torch.Generator(device=dev).manual_seed(SEED + 73)

            def one():
                nonlocal st
                st, _ = fn(st, xb, tb, mb, color.draw_augment(gen, batch),
                           1e-3, None)

            for _ in range(2):
                one()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(10):
                one()
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) / 10 * 1e3
            resident = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            one()
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev)
            prof = step_profile(one, 3)
            res["steps"][f"{tag}_{dt}"] = {
                "step_ms": ms, "kernels": prof["kernels"],
                "device_ms": prof["device_ms"],
                "idle_share": None if prof["device_ms"] is None
                else 1 - prof["device_ms"] / ms,
                "peak_mb": peak / 2 ** 20,
                "peak_over_resident_mb": (peak - resident) / 2 ** 20,
                "top": prof["top"]}
            del st, fn

    # the variants' parameters after one plain-SGD step from one start
    mask = mb.clone()
    mask[-1] = 0
    draws = color.draw_augment(torch.Generator(device=dev).manual_seed(
        SEED + 74), batch)
    after = {}
    for tag, kw in [("plain", {}), ("plain_again", {})] + [
            (t, k) for t, k in TRAIN_VARIANTS.items() if t != "plain"]:
        fn = tstep.make_train_step(model, optim.sgd(),
                                   dataclasses.replace(base, **kw))
        st, out = fn(tstep.init_state(model, optim.sgd()), xb, tb, mask,
                     draws, 1e-2, None)
        after[tag] = (st.params, float(out["loss"]))
    ref, ref_loss = after["plain"]
    held = {}
    for tag, (atol, rtol) in (("plain_again", (0.0, 0.0)),
                              ("packed", (1e-5, 1e-4)),
                              ("remat_dots", (1e-4, 1e-4)),
                              ("remat_full", (1e-4, 1e-4))):
        worst, name = worst_over_tol(after[tag][0], ref, rtol)
        held[tag] = {"atol": atol, "rtol": rtol,
                     "worst_abs_err_over_rtol": worst, "worst_param": name,
                     "loss": after[tag][1], "plain_loss": ref_loss}
        if tag != "plain_again":
            chk.expect(worst <= atol and abs(after[tag][1] - ref_loss)
                       <= rtol * abs(ref_loss),
                       f"train_variants: the {tag} SGD step differs from the "
                       f"plain one: {held[tag]}")
    res["sgd_step_vs_plain"] = held
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


STREAM_N = 512


def phase_train_streamed(dev, chk: Checks, smi: str) -> dict:
    """``Trainer.train_epoch_streamed`` on the flagship at b64, QVGA: 512
    seeded uint8 frames and uint8 labels on the host, copied from pinned
    memory on a side stream and normalized on the card
    (``device_transform``). The main path, with the counters set to 0 just
    before and read just after: one shuffled streamed epoch (Adam) and its
    validation (120 frames in a ``DeviceCache``), K1 once per validation
    batch and equal to its plain count. Images/s of the streamed epoch
    against ``train_epoch`` over the same frames normalized once into a
    ``DeviceCache`` (host clock, synchronised; two epochs of each in turns:
    streamed, cached, cached, streamed, after one of each to warm). And an
    unshuffled streamed epoch (plain SGD, lr 1e-2) against the cached
    epoch in the same order from the same weights and draws: every
    parameter and running statistic within atol = rtol = 1e-4."""
    from robocupvision_tpu_torch.cli import train
    from robocupvision_tpu_torch.data.device_cache import (DeviceCache,
                                                           epoch_batches,
                                                           num_batches)
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.train import optim
    from robocupvision_tpu_torch.train import step as tstep
    from robocupvision_tpu_torch.train.loop import Trainer

    size, batch = (120, 160), 64
    t_phase = time.perf_counter()
    imgs, labs = eval_set(STREAM_N + VAL_N, SEED + 80, size, paint=True)
    frames = np.clip(np.round(imgs * 32 + 128), 0, 255).astype(np.uint8)
    labels = labs.astype(np.uint8)

    def normalize(x, y):
        return (x.float() - 128.0) / 32.0, y.int()

    ds = list(zip(frames[:STREAM_N], labels[:STREAM_N]))  # (frame, label)
    cached = DeviceCache(*normalize(torch.from_numpy(frames[:STREAM_N]).to(dev),
                                    torch.from_numpy(labels[:STREAM_N]).to(dev)),
                         STREAM_N)
    val_cache = DeviceCache(*normalize(torch.from_numpy(frames[STREAM_N:]).to(dev),
                                       torch.from_numpy(labels[STREAM_N:]).to(dev)),
                            VAL_N)
    model = zoo.make("robo_unet", device=dev,
                     generator=torch.Generator().manual_seed(SEED + 81),
                     **train.model_hyper(False, False))
    cfg = tstep.StepCfg(num_classes=5, class_weights=(1, 10, 30, 10, 2),
                        l1_decay=1e-6, out_size=1.0 / (size[0] * size[1]))
    vnb = num_batches(VAL_N, batch)
    tr = Trainer(model, optim.adam(), cfg, cached, val_cache, batch,
                 seed=SEED + 82)
    tr.init()
    (ep, val), launches, verified, unequal, wall = counted_run(
        lambda: (tr.train_epoch_streamed(1e-3, ds, device_transform=normalize),
                 tr.valid_epoch()))
    res = {"phase": "train_streamed", "model": "robo_unet flagship "
           "(model_hyper)", "shape": [batch, *size, 3], "frames": STREAM_N,
           "frame_dtype": "uint8", "card": smi, "train_loss": ep.loss,
           "val_loss": val["loss"], "launches": launches,
           "k1_per_validation_epoch": launches["confusion_count"],
           "k1_verified": verified, "k1_unequal_plain": unequal,
           "seconds": wall}
    chk.expect(launches == {"confusion_count": vnb, "fused_conv_chain": 0,
                            "fused_conv3x3_block": 0},
               f"train_streamed: launches {launches}, want {vnb} K1 and no "
               "K2, K3")
    chk.expect(verified == vnb and unequal == 0 and np.isfinite(ep.loss),
               f"train_streamed: K1 equal to plain on {verified - unequal} of "
               f"{vnb} validation batches, loss {ep.loss}")

    def streamed():
        tr.train_epoch_streamed(1e-3, ds, device_transform=normalize)

    def cached_epoch():
        tr.train_epoch(1e-3)

    rates = {"streamed": [], "cached": []}
    for kind, fn in (("streamed", streamed), ("cached", cached_epoch),
                     ("cached", cached_epoch), ("streamed", streamed),
                     ("streamed", streamed), ("cached", cached_epoch)):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        rates[kind].append(STREAM_N / (time.perf_counter() - t0))
    # the first of each warmed up
    res["images_per_s"] = {k: v[1:] for k, v in rates.items()}
    res["images_per_s_warmup"] = {k: v[0] for k, v in rates.items()}

    sgd = Trainer(model, optim.sgd(), cfg, cached, val_cache, batch,
                  seed=SEED + 83)
    p0 = {k: v.clone() for k, v in model.flat().items()}
    g0 = sgd.gen.get_state()
    sgd.set_params(p0)
    sgd.train_epoch_streamed(1e-2, ds, shuffle=False,
                             device_transform=normalize)
    streamed_params = {k: v.clone() for k, v in sgd.state.params.items()}
    sgd.set_params(p0)
    sgd.gen.set_state(g0)
    sgd._steps(epoch_batches(cached, batch), 1e-2, None)
    worst, name = worst_over_tol(streamed_params, sgd.state.params, 1e-4)
    res["unshuffled_vs_cached"] = {"worst_abs_err_over_rtol": worst,
                                   "worst_param": name}
    chk.expect(worst <= 1e-4, f"train_streamed: the unshuffled streamed epoch "
               f"differs from the cached one: {worst} at {name}")
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


CLASS_CLI_N = (512, 128)


def phase_classifier_clis(dev, chk: Checks, smi: str) -> list:
    """The classifier baselines' loops the way their CLIs run them, at b64
    on seeded in-memory 32x32 patches of four classes (``patch_set``; 512
    train, 128 val; the card's machine has no Pillow): ``classVal
    .train_baseline`` (the DownSampler(32) + Classifier pair, then
    ``--hessL`` and ``--hessMC``) and ``objDetEval.train_detector`` (BNN
    L), 4 epochs for the pair and 6 for each BNN (whose loss leaves ln 4
    later), in a temporary working directory. The counters are
    set to 0 just before each loop and read just after: no K1 (the class
    confusion is plain), K2 or K3. Each must write its CLI's checkpoint
    files and its train loss must be finite and fall; the pair runs with
    the plateau's patience -1 (a rollback through its two-file ``load_fn``
    after every epoch), the others with the CLIs' 10. Then each loop's own
    step is timed at b64 (``time_train_step``: ms a step, kernels a step
    and the card's idle share)."""
    from robocupvision_tpu_torch.cli import classVal, objDetEval
    from robocupvision_tpu_torch.data.device_cache import DeviceCache

    imgs, labs = patch_set(sum(CLASS_CLI_N), SEED + 90)
    n = CLASS_CLI_N[0]
    tc = DeviceCache.from_numpy(imgs[:n], labs[:n], device=dev)
    vc = DeviceCache.from_numpy(imgs[n:], labs[n:], device=dev)
    # (loop, CLI module, loop function, argv, patience, checkpoints)
    loops = [
        ("classVal", classVal, classVal.train_baseline, ["--epochs", "4"],
         -1, ["pth/bestModelB.pth", "pth/bestClassB.pth"]),
        ("classVal --hessL", classVal, classVal.train_baseline,
         ["--epochs", "6", "--hessL"], 10, ["pth/bestModelHessL.pth"]),
        ("classVal --hessMC", classVal, classVal.train_baseline,
         ["--epochs", "6", "--hessMC"], 10, ["pth/bestModelHessMC.pth"]),
        ("objDetEval", objDetEval, objDetEval.train_detector,
         ["--epochs", "6"], 10, ["pth/bestModelHessL.pth"]),
    ]
    results = []
    here = os.path.dirname(os.path.abspath(__file__))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=here, prefix=".chip_smoke_") as tmp:
        os.chdir(tmp)
        try:
            for name, cli, fn, argv, patience, files in loops:
                opt = cli.build_parser().parse_args(argv)
                tee = Tee(sys.stdout)
                with plateau_runs(patience) as seen, \
                        contextlib.redirect_stdout(tee):
                    best, launches, _, _, wall = counted_run(
                        lambda: fn(opt, tc, vc, dev))
                tr, _ = seen[0]
                text = tee.text
                train_loss = [float(v) for v in re.findall(
                    r"Epoch \[\d+\] Training Loss: (\S+)", text)]
                res = {"phase": "classifier_clis", "loop": name,
                       "family": tr.model.family, "batch": tr.batch_size,
                       "input": list(tc.images.shape[1:]), "train_n": tc.n,
                       "val_n": vc.n, "epochs": opt.epochs,
                       "patience": patience, "train_loss": train_loss,
                       "best_val_loss": best["loss"],
                       "best_val_acc": best["acc"],
                       "rollbacks": text.count("Best Model reloaded"),
                       "false_neg_lines": text.count("False Neg"),
                       "checkpoints": {f: os.path.exists(f) for f in files},
                       "launches": launches, "seconds": wall, "card": smi}
                res.update(time_train_step(tr, dev))
                emit(res)
                results.append(res)
                chk.expect(all(res["checkpoints"].values()),
                           f"classifier_clis {name}: checkpoints "
                           f"{res['checkpoints']}")
                chk.expect(len(train_loss) == opt.epochs
                           and all(np.isfinite(train_loss))
                           and train_loss[-1] < train_loss[0],
                           f"classifier_clis {name}: train loss {train_loss} "
                           "does not fall")
                chk.expect(launches == {"confusion_count": 0,
                                        "fused_conv_chain": 0,
                                        "fused_conv3x3_block": 0},
                           f"classifier_clis {name}: launches {launches}, "
                           "want none")
                if cli is objDetEval:
                    chk.expect(res["false_neg_lines"] >= 1,
                               f"classifier_clis {name}: no false-negative "
                               "report")
        finally:
            os.chdir(cwd)
    chk.expect(results[0]["rollbacks"] >= 1,
               "classifier_clis: no plateau rollback of the pair")
    return results


INT8_TRAINED_HW = (48, 64)
INT8_TRAINED_FLOOR, INT8_TRAINED_TARGET = 0.95, 0.97


def phase_int8_trained(dev, chk: Checks, smi: str) -> dict:
    """The trained-net int8 envelope of tests/test_int8_families.py on the
    card: PB_FCN (planes 16), the --v2 ROBO-UNet (planes 8, levels 1,
    belly 5 x 32) and LabelProp (planes 16), each trained 30 epochs with
    Adam at batch 6 without augmentation on 24 seeded 48x64 scenes (the
    test's size; LabelProp on 12 scene pairs, both directions), then built
    as its bf16 chain graph (PB_FCN with its deep chain, --v2 with the
    folded stem and deep chain, LabelProp with the folded stem and mid
    chain), quantized by ``quantize_int8`` on 4 held-out frames at the
    calibration statistic max, 99.9, 99.5 and "auto", and served on 8
    others: the int8 chain graph's labels against the float chain graph's,
    both on K2. The counters are set to 0 just before the quantize-and-
    serve runs and read just after. Fails under the test's floor: the
    best agreement >= 0.95 and "auto" >= best - 0.02."""
    from robocupvision_tpu_torch.data.device_cache import DeviceCache
    from robocupvision_tpu_torch.models import packed, zoo
    from robocupvision_tpu_torch.ops.color import (MEAN_SYNTHETIC,
                                                   STD_SYNTHETIC)
    from robocupvision_tpu_torch.ops.cuda_kernels import confusion_count
    from robocupvision_tpu_torch.ops.cuda_packed import fused_conv_chain
    from robocupvision_tpu_torch.train import optim
    from robocupvision_tpu_torch.train import step as tstep
    from robocupvision_tpu_torch.train.loop import Trainer

    hw = INT8_TRAINED_HW
    rgb, labs = scene_set(36, SEED + 70, hw)
    seg = ((rgb - np.asarray(MEAN_SYNTHETIC, np.float32))
           / np.asarray(STD_SYNTHETIC, np.float32), labs)
    lp = lp_pair_set(18, SEED + 71, hw)
    bf16 = torch.bfloat16
    families = {
        "pb_fcn": (dict(family="pb_fcn", planes=16), seg, 24, 3e-3,
                   (1., 10., 30., 10., 2.),
                   lambda m, p: packed.build_packed_pb_fcn(
                       m, p, bf16, pallas=True, pallas_deep=True,
                       device=dev)),
        "v2": (dict(family="robo_unet", v2=True, planes=8, levels=1, depth=4,
                    belly_size=5, belly_planes=32), seg, 24, 1e-3,
               (1., 10., 30., 10., 2.),
               lambda m, p: packed.build_packed_infer(
                   m, p, bf16, pallas=True, pallas_fold_stem=True,
                   pallas_deep=True, device=dev)),
        "label_prop": (dict(family="label_prop", planes=16), lp, 24, 1e-3,
                       (1., 6., 1., 3., 2.),
                       lambda m, p: packed.build_packed_label_prop(
                           m, p, bf16, pallas=True, pallas_fold_stem=True,
                           pallas_mid=True, device=dev)),
    }
    res = {"phase": "int8_trained", "input_hw": list(hw), "epochs": 30,
           "batch": 6, "floor": INT8_TRAINED_FLOOR,
           "target": INT8_TRAINED_TARGET, "card": smi, "families": {}}
    for tag, (kw, (x, y), n_train, lr, cw, build) in families.items():
        kw = dict(kw)
        model = zoo.make(kw.pop("family"), device=dev,
                         generator=torch.Generator().manual_seed(SEED + 72),
                         **kw)
        cfg = tstep.StepCfg(num_classes=5, class_weights=cw,
                            out_size=1.0 / (hw[0] * hw[1]), augment=False)
        tr = Trainer(model, optim.adam(), cfg,
                     DeviceCache.from_numpy(x[:n_train], y[:n_train],
                                            device=dev), None, 6)
        tr.init()
        t0 = time.perf_counter()
        losses = [tr.train_epoch(lr).loss for _ in range(30)]
        train_s = time.perf_counter() - t0
        calib = torch.from_numpy(x[n_train:n_train + 4]).to(dev)
        held = torch.from_numpy(x[n_train + 4:n_train + 12]).to(dev)
        # --- a main path: quantize_int8 and the served graphs
        confusion_count.launches = fused_conv_chain.launches = 0
        K1_REC.active = True
        f = build(model, tr.state.params)
        ref = f.infer(held)
        agree = {}
        for pct in (None, 99.9, 99.5, "auto"):
            q = packed.quantize_int8(f, calib, pct=pct)
            agree["max" if pct is None else str(pct)] = float(
                (q.infer(held) == ref).float().mean())
        torch.cuda.synchronize(dev)
        K1_REC.active = False
        launches = {"confusion_count": confusion_count.launches,
                    "fused_conv_chain": fused_conv_chain.launches}
        best = max(agree.values())
        res["families"][tag] = {
            "cfg": dataclasses.asdict(model.cfg), "lr": lr,
            "train_loss_first_last": [losses[0], losses[-1]],
            "train_s": train_s, "agreement": agree, "best": best,
            "auto_pct": packed.INT8_PCT_DEFAULTS[
                packed._int8_family_key(f)],
            "meets_target": best >= INT8_TRAINED_TARGET,
            "launches": launches}
        chk.expect(np.isfinite(losses[-1]) and losses[-1] < losses[0],
                   f"int8_trained {tag}: train loss {losses[0]} -> "
                   f"{losses[-1]}")
        chk.expect(best >= INT8_TRAINED_FLOOR
                   and agree["auto"] >= best - 0.02,
                   f"int8_trained {tag}: agreement {agree} under the floor "
                   f"{INT8_TRAINED_FLOOR} (auto >= best - 0.02)")
        chk.expect(launches["fused_conv_chain"] > 0
                   and launches["confusion_count"] == 0,
                   f"int8_trained {tag}: launches {launches}")
    emit(res)
    return res


def step_profile(fn, steps: int) -> dict:
    """``steps`` calls of ``fn`` under ``torch.profiler``: the wall time a
    step (host clock, synchronised), the card's kernel time a step, the
    kernels a step and the card's idle share, and the five kernels with
    the most time. Device times come from the trace (CUPTI); where it holds
    none they read None (not measured)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    # the kernels' own rows (an op's row carries its kernels' time too)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    measured = dev_ms > 0
    return {"wall_ms": wall_ms,
            "device_ms": dev_ms if measured else None,
            "kernels": sum(e.count for e in kern) / steps if measured
            else None,
            "device_idle_share": 1 - dev_ms / wall_ms if measured else None,
            "top": [[e.key[:80], e.self_device_time_total / 1e3 / steps,
                     e.count / steps] for e in top]}


def k2_entry(cases, launches, features) -> dict:
    """The ``kernels`` line's K2 object: times, bound and error summed (err:
    max) over the chains of one served frame."""
    return {"name": "fused_conv_chain", "route": "cuda",
            "source": "robocupvision_tpu_torch/csrc/conv_chain.cu",
            "replaces": "robocupvision_tpu/ops/pallas_packed.py:348",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": sum(r["kernel_ms"] for r in cases),
            "plain_ms": sum(r["plain_ms"] for r in cases),
            "bound_ms": sum(r["bound_ms"] for r in cases),
            "bound_by": ("operations" if sum(r["ops_ms"] for r in cases)
                         > sum(r["bytes_ms"] for r in cases) else "bytes"),
            "library_ms": None, "features": features}


def port_models(dev) -> dict:
    """The nets every phase drives, full width, weights from seeds: the
    flagship, PB_FCN, LabelProp, and the --UNet and --v2 ROBO-UNets."""
    from robocupvision_tpu_torch.cli.train import model_hyper
    from robocupvision_tpu_torch.models import zoo

    return {
        "flagship": zoo.make("robo_unet", no_scale=True, device=dev,
                             generator=torch.Generator().manual_seed(SEED)),
        "pb_fcn": zoo.make("pb_fcn", planes=32, num_classes=5, kernel_size=1,
                           no_scale=True, device=dev,
                           generator=torch.Generator().manual_seed(SEED + 4)),
        "label_prop": zoo.make("label_prop", planes=32, num_classes=5,
                               device=dev, generator=torch.Generator()
                               .manual_seed(SEED + 9)),
        # the --UNet and --v2 nets at VGA (model_hyper sets neither flag)
        "unet": zoo.make("robo_unet", no_scale=True, pool=True, device=dev,
                         generator=torch.Generator().manual_seed(SEED + 13),
                         **model_hyper(True, False)),
        "v2": zoo.make("robo_unet", no_scale=True, v2=True, device=dev,
                       generator=torch.Generator().manual_seed(SEED + 14),
                       **model_hyper(False, True)),
    }


def dump_chain_outputs(path: str, inputs: str = None) -> int:
    """``--dump-chains PATH [INPUTS]``: K2's outputs on every f32 chain of
    the five families' float graphs (``int8_graphs``' inputs), with the
    chains' inputs and skips, saved to PATH; with INPUTS (an earlier dump)
    every chain runs on that dump's inputs and skips instead, so that two
    versions of the kernel are held to each other bit for bit on the same
    inputs (``--compare-chains``; the graphs' plain parts between chains,
    cuDNN convs, need not repeat their last bit from one process to the
    next). Uses only what every version of the port has, so a copy of this
    script next to an older tree's package dumps that tree's kernel."""
    from robocupvision_tpu_torch.ops import cuda_packed as ckp

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    m = port_models(dev)
    variants = {"unet": (m["unet"], dict(pallas_fold_stem=True)),
                "v2": (m["v2"], dict(pallas_fold_stem=True,
                                     pallas_deep=True))}
    given = torch.load(inputs) if inputs else {}
    out = {}
    for fam, (pi, x) in int8_graphs(m["flagship"], variants, m["pb_fcn"],
                                    m["label_prop"], torch.float32,
                                    dev).items():
        calls = record_chain_calls(pi, pi.logits, x)
        calls.append(record_chain_calls(pi, pi.infer, x)[-1])
        for i, (cx, stages, skips) in enumerate(calls):
            key = f"{fam}_{i}"
            if key in given:
                cx = given[key]["x"].to(dev)
                skips = [t.to(dev) for t in given[key]["skips"]]
            outs = ckp.fused_conv_chain(cx, stages, skips)
            out[key] = {"x": cx.cpu(), "skips": [t.cpu() for t in skips],
                        "outs": [o.cpu() for o in outs]}
    torch.save(out, path)
    emit({"phase": "dump_chains", "path": path, "chains": len(out),
          "inputs_from": inputs})
    return 0


def chain_device_ms(call, calls: int) -> float:
    """The card time of one K2 launch on ``call`` = (x, stages, skips):
    torch.profiler's ``chain_kernel`` rows over ``calls`` launches, so the
    wrapper's host time (which CUDA events around a short chain measure)
    counts for nothing. None where the trace holds no device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from robocupvision_tpu_torch.ops import cuda_packed as ckp

    x, stages, skips = call
    ckp.fused_conv_chain(x, stages, skips)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ckp.fused_conv_chain(x, stages, skips)
        torch.cuda.synchronize()
    t = sum(e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "chain_kernel" in e.key)
    return t / 1e3 / calls if t > 0 else None


def time_chain_kernels() -> int:
    """``--time-chains``: K2's card time alone (``chain_device_ms``) on
    every chain of the five families' float and int8 graphs at VGA b1
    (LabelProp: its pair), f32 and bf16, and on the single-stage cases of
    ``int8_single_cases``, float and int8, printed as one JSON line. Uses
    only what every version of the port has (see ``--dump-chains``)."""
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops import cuda_packed as ckp

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    m = port_models(dev)
    variants = {"unet": (m["unet"], dict(pallas_fold_stem=True)),
                "v2": (m["v2"], dict(pallas_fold_stem=True,
                                     pallas_deep=True))}
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        for fam, (pi, x) in int8_graphs(m["flagship"], variants, m["pb_fcn"],
                                        m["label_prop"], dt, dev).items():
            for kind, g in (("float", pi),
                            ("int8", packed.quantize_int8(pi, x))):
                tags = []
                calls = record_chain_calls(g, g.logits, x, tags)
                calls.append(record_chain_calls(g, g.infer, x)[-1])
                tags.append("up_argmax")
                for tag, call in zip(tags, calls):
                    out[f"{fam}_{tag}_{kind}_{name}"] = chain_device_ms(call,
                                                                        10)
        for case, (x, stages, skips) in int8_single_cases(m["flagship"], dt,
                                                          dev).items():
            _, stats = ckp.chain_stats(x, stages, skips)
            out[f"single_{case}_float_{name}"] = chain_device_ms(
                (x, stages, skips), 20)
            out[f"single_{case}_int8_{name}"] = chain_device_ms(
                (x, ckp.quantize_chain_stages(stages, stats), skips), 20)
    emit({"phase": "time_chains", "device_ms": out})
    return 0


def time_k1() -> int:
    """``--time-k1``: ``k1_timings`` alone (every main-path case of K1 at
    both label distributions, and C = 16), one JSON line a case, then a
    summary line. Uses only what every version of the port has, so a copy
    of this script beside an older tree's package times that tree's K1.
    Exits 1 if a count differs from the plain one."""
    chk = Checks()
    out = k1_timings(torch.device("cuda"), chk)
    emit({"phase": "time_k1", "nvidia_smi": smi_line(),
          **{key: {f"{c}_{d}": r[key] for (c, d), r in out.items()}
             for key in ("card_ms", "launches_per_call", "event_ms",
                         "bound_share")},
          "card_ms_i32": {f"{c}_{d}": r["card_ms_i32"]
                          for (c, d), r in out.items() if "card_ms_i32" in r},
          "failed": chk.failed})
    return 1 if chk.failed else 0


def compare_chain_outputs(a: str, b: str) -> int:
    """``--compare-chains A B``: whether every chain output in dump A
    equals dump B's (``torch.equal``), and whether they ran on the same
    inputs; exits 1 on any difference."""
    da, db = torch.load(a), torch.load(b)
    res = {"phase": "compare_chains", "chains": len(da), "outputs": 0,
           "differ": [],
           "same_inputs": all(torch.equal(da[k]["x"], db[k]["x"])
                              for k in da if k in db)}
    for key, entry in da.items():
        outs = entry["outs"]
        for i, (x, y) in enumerate(zip(outs, db.get(key, {}).get("outs",
                                                                  []))):
            res["outputs"] += 1
            if not torch.equal(x, y):
                res["differ"].append([key, i, float(
                    (x.float() - y.float()).abs().max())])
        if key not in db or len(db[key]["outs"]) != len(outs):
            res["differ"].append([key, "missing"])
    res["equal"] = (not res["differ"] and set(da) == set(db)
                    and res["same_inputs"])
    emit(res)
    return 0 if res["equal"] else 1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dump-chains"]:
        return dump_chain_outputs(*sys.argv[2:4])
    if sys.argv[1:2] == ["--time-chains"]:
        return time_chain_kernels()
    if sys.argv[1:2] == ["--time-k1"]:
        return time_k1()
    if sys.argv[1:2] == ["--compare-chains"]:
        return compare_chain_outputs(sys.argv[2], sys.argv[3])
    from robocupvision_tpu_torch.csrc import build
    from robocupvision_tpu_torch.ops.cuda_kernels import fused_conv3x3_block

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = smi_line()
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "card", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s,
          "ptxas": {s: p.with_suffix(".log").read_text().strip().splitlines()
                    [-4:] for s, p in libs.items()
                    if p.with_suffix(".log").exists()}})

    chk = Checks()
    nets = port_models(dev)
    model, pb_model, lp_model = (nets[k] for k in ("flagship", "pb_fcn",
                                                    "label_prop"))
    unet, v2 = nets["unet"], nets["v2"]
    graphs = {"unet": (unet, dict(pallas_fold_stem=True)),
              "v2": (v2, dict(pallas_fold_stem=True, pallas_deep=True))}
    k1 = phase_k1(dev, chk)
    k2 = phase_k2(model, dev, chk)
    k2f = phase_k2_features(model, pb_model, dev, chk)
    k2lp = phase_k2_lp(lp_model, dev, chk)
    phase_k2_pool(dev, chk)
    k2v = phase_k2_variants(graphs, dev, chk)
    k2q = phase_k2_int8(model, graphs, pb_model, lp_model, dev, chk)
    k2z = phase_k2_fuzz(dev, chk)
    k3 = phase_k3(dev, chk)
    phase_no_host_copy(model, dev, chk)
    fused_conv3x3_block.launches = 0  # no main path below calls K3

    K1_REC.install()  # records K1's maps in every main path's counted run
    rng = np.random.default_rng(SEED + 3)
    frames = [rng.integers(0, 256, (1, *VGA, 3), dtype=np.uint8)
              for _ in range(N_FRAMES)]
    targets = rng.integers(0, 5, (N_FRAMES, 1, *VGA)).astype(np.int32)
    ref = flagship_reference(model, dev, frames)
    sv2 = phase_serving(model, dev, chk, frames, targets, ref, "chains2",
                        dict(), 2)
    sv3 = phase_serving(model, dev, chk, frames, targets, ref, "chains3",
                        dict(pallas_fold_stem=True, pallas_deep=True), 3)
    del ref
    variants = {}
    for (tag, (net, graph)), per_frame in zip(graphs.items(), (2, 3)):
        ref = flagship_reference(net, dev, frames)
        variants[tag] = phase_serving(net, dev, chk, frames, targets, ref, tag,
                                      graph, per_frame)
        del ref
    sq = phase_serving_int8(model, dev, chk, frames)
    phase_device_fps(model, graphs, dev, frames)
    ts = phase_tester(pb_model, dev, chk)
    vlp = phase_valid_label_prop(lp_model, dev, chk)
    tc = phase_test_cli({"unet": unet, "v2": v2}, dev, chk)
    k3_launches = fused_conv3x3_block.launches
    tr = phase_train(dev, chk)
    lt = phase_legacy_train(dev, chk, smi)
    tv = phase_train_variants(dev, chk, smi)
    tsr = phase_train_streamed(dev, chk, smi)
    cc = phase_classifier_clis(dev, chk, smi)
    it = phase_int8_trained(dev, chk, smi)
    K1_REC.check(chk)

    # the main paths' launches; K1's shapes: one (1, 480, 640) map pair
    # scored per frame; K2's: the bf16 VGA b1 chains of one frame of the
    # full chain graph (folded-stem down, deep, up with its head)
    main_runs = [sv2["main_path_launches"], sv3["main_path_launches"]] + [
        r["launches"] for r in ts["runs"].values()] + [
        vlp["main_path_launches"]] + [
        v["main_path_launches"] for v in variants.values()] + [
        r["launches"] for r in tc["runs"].values()] + [
        sq["main_path_launches"], ts["int8"]["main_path_launches"],
        vlp["int8"]["main_path_launches"]] + [
        r["launches"] for r in tr["runs"].values()] + [
        r["launches"] for r in lt] + [
        r["launches"] for r in tv["main_paths"].values()] + [
        tsr["launches"]] + [r["launches"] for r in cc] + [
        f["launches"] for f in it["families"].values()]
    # K1's entry: the tester's map pair, the case of earlier PRs' entries
    k1m = k1["tester", "random"]
    # K3 has no caller: its entry is the QVGA 64->64 bf16 Conv-block case
    k3m = k3["120x160_64to64_bf16_relu_bn"]
    features = sorted({f for r in list(k2.values()) + list(k2f.values())
                       + list(k2lp.values()) + list(k2v.values())
                       + list(k2q.values()) + [k2z]
                       for f in r["features"]})
    kernels = [
        {"name": "confusion_count", "route": "cuda",
         "source": "robocupvision_tpu_torch/csrc/confusion.cu",
         "replaces": "robocupvision_tpu/ops/pallas_kernels.py:120",
         "launches": sum(r.get("confusion_count", 0) for r in main_runs),
         "max_abs_err": k1m["max_abs_err"], "ms": k1m["event_ms"],
         "plain_ms": k1m["plain_ms"], "bound_ms": k1m["bound_ms"],
         "bound_by": "bytes", "library_ms": k1m["bincount_event_ms"],
         "card_ms": k1m["card_ms"],
         "launches_per_call": k1m["launches_per_call"],
         "library_card_ms": k1m["bincount_card_ms"],
         "case": [k1m["shape"], k1m["pred"], k1m["tgt"], "random"]},
        k2_entry([k2f["stem_down_b1_bf16"], k2f["deep_b1_bf16"],
                  k2["up_argmax_b1_bf16"]],
                 sum(r["fused_conv_chain"] for r in main_runs), features),
        {"name": "fused_conv3x3_block", "route": "cuda",
         "source": "robocupvision_tpu_torch/csrc/conv_block.cu",
         "replaces": "robocupvision_tpu/ops/pallas_kernels.py:64",
         "launches": k3_launches + sum(r.get("fused_conv3x3_block", 0)
                                       for r in main_runs),
         "max_abs_err": k3m["max_abs_err"], "ms": k3m["kernel_ms"],
         "plain_ms": k3m["plain_ms"], "bound_ms": k3m["bound_ms"],
         "bound_by": k3m["bound_by"], "library_ms": k3m["library_ms"],
         "case": k3m["case"]},
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    if chk.failed:
        print("chip_smoke FAILED:\n  " + "\n  ".join(chk.failed),
              file=sys.stderr, flush=True)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
