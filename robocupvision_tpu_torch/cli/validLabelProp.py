"""Label-propagation evaluation CLI, the reference's ``python
validLabelProp.py`` (the JAX package's cli/validLabelProp.py).

Loads the LabelProp checkpoint (pth/bestModelLP{Finetuned}{Pruned}.pth),
writes its deployment export to ./weightsLP, serves the LPDataSet val
pairs (both temporal directions, one (2, 120, 160, 8) pair a call), writes
colourized predictions to output/LabelProp/{Real,Synthetic}/, and prints
pixel accuracy, mean class accuracy, mean IoU, the normalized confusion
matrix and the mean per-image latency in ms. ``--packed`` serves the
lane-packed graph in f32 (``--pallas``: its three fused chains, kernel K2
on CUDA; ``--int8``: those chains quantized to int8, calibrated on the
first val pair); scores go through ``seg_batch_stats`` (kernel K1 on CUDA).

    python -m robocupvision_tpu_torch.cli.validLabelProp --packed --pallas

runs on the CUDA card; ``main(argv, device="cpu")`` runs the plain
PyTorch path on the CPU. ``--optFlow`` scores the classical baseline
instead of the net (no checkpoint is loaded and no ``weightsLP`` written):
each frame's prediction is the other frame's labels warped along the
Farneback flow between them, by cv2 on the host (``ops/optflow.py``
``optflow_cv2`` / ``update_labels_cv2``; cv2 must be installed), or with
``--jaxFlow`` by the Farneback port on the device (``optflow_torch`` /
``warp_labels_torch``); the loop is ``flow_and_score``. The flow
baselines time nothing: their latency line prints 0, as the JAX CLI's
does.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from robocupvision_tpu_torch.device import (DeviceLike, resolve_device,
                                            synchronize)
from robocupvision_tpu_torch.ops.metrics import SegAccum, seg_batch_stats_host

NUM_CLASSES = 5
IMG_SIZE = (120, 160)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Label propagation evaluation")
    p.add_argument("--finetuned", action="store_true", default=False)
    p.add_argument("--pruned", action="store_true", default=False)
    p.add_argument("--optFlow", action="store_true", default=False,
                   help="score the optical-flow baseline (cv2 Farneback) "
                   "instead of the net")
    p.add_argument("--jaxFlow", action="store_true", default=False,
                   help="with --optFlow: the Farneback port on the device "
                   "instead of cv2 (ops/optflow.optflow_torch)")
    p.add_argument("--packed", action="store_true", default=False,
                   help="lane-packed LP inference graph (exact rewrite)")
    p.add_argument("--pallas", action="store_true", default=False,
                   help="with --packed: run the packed conv regions as fused "
                   "chain kernels (exact rewrite; ops/cuda_packed.py)")
    p.add_argument("--int8", action="store_true", default=False,
                   help="with --packed --pallas: static int8 PTQ serving, "
                   "calibrating per-stage activation scales on the first val "
                   "pair (approximate; framework extension, "
                   "models/packed.quantize_int8)")
    p.add_argument("--root", type=str,
                   default=os.environ.get("ROBOCUP_DATA", "./data"))
    return p


def serve_and_score(infer: Callable,
                    pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
                    num_classes: int = NUM_CLASSES,
                    on_mask: Optional[Callable[[int, np.ndarray], None]] = None,
                    device: DeviceLike = None) -> Tuple[SegAccum, float, int]:
    """Serve ``pairs``, (inputs (2, H, W, 8) float32, targets (2, H, W) int)
    frame pairs built by ``build_lp_pairs``, one pair a call through
    ``infer`` ((2, H, W, 8) tensor on ``device`` -> (2, H, W) int labels),
    and score each served pair against its targets with
    ``seg_batch_stats``. ``on_mask(i, labels)`` sees every served (H, W) map
    in order. Each call is timed alone, from its input on the device to its
    synchronise, as the reference does (validLabelProp.py:133-139). Returns
    (host accumulator, seconds, images served)."""
    dev = resolve_device(device)
    acc = SegAccum.zero(num_classes)
    t_total = 0.0
    n = 0
    for inputs, targets in pairs:
        x = torch.from_numpy(np.ascontiguousarray(inputs)).to(dev)
        synchronize(dev)
        beg = time.perf_counter()
        pred = infer(x)
        synchronize(dev)
        t_total += time.perf_counter() - beg
        if on_mask is not None:
            for j, labels in enumerate(pred.cpu().numpy()):
                on_mask(n + j, labels)
        n += int(pred.shape[0])
        acc = acc + seg_batch_stats_host(pred, targets, num_classes, device=dev)
    return acc, t_total, n


def flow_and_score(flow: Callable, warp: Callable,
                   pairs: Iterable[Tuple[object, object]],
                   num_classes: int = NUM_CLASSES,
                   on_mask: Optional[Callable[[int, np.ndarray], None]] = None,
                   device: DeviceLike = None) -> Tuple[SegAccum, int]:
    """The optical-flow baseline over ``pairs`` of (labels (2, H, W) int,
    grays (2, H, W) uint8), arrays or tensors as ``flow`` and ``warp``
    take them: each frame's prediction is the other frame's labels warped
    along the flow from it (``warp(labels[1], flow(grays[1], grays[0]))``,
    then the other way), stacked as an int64 (2, H, W) pair and scored
    against the pair's labels with ``seg_batch_stats`` on ``device``.
    ``on_mask(i, labels)`` sees every predicted (H, W) map in order.
    Returns (host accumulator, images scored)."""
    dev = resolve_device(device)
    acc = SegAccum.zero(num_classes)
    n = 0
    for labs, grays in pairs:
        pred = torch.stack([
            torch.as_tensor(warp(labs[1], flow(grays[1], grays[0]))),
            torch.as_tensor(warp(labs[0], flow(grays[0], grays[1])))
        ]).to(torch.int64)
        if on_mask is not None:
            for j, labels in enumerate(pred.cpu().numpy()):
                on_mask(n + j, labels)
        n += 2
        acc = acc + seg_batch_stats_host(pred, labs, num_classes, device=dev)
    return acc, n


def main(argv=None, device: DeviceLike = None) -> int:
    opt = build_parser().parse_args(argv)
    dev = resolve_device(device)

    from robocupvision_tpu_torch.cli.labelPropTrain import build_lp_pairs
    from robocupvision_tpu_torch.data.datasets import LPDataSet
    from robocupvision_tpu_torch.export import deploy
    from robocupvision_tpu_torch.models import packed as packed_mod
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops import optflow
    from robocupvision_tpu_torch.ops.labels import colorize
    from robocupvision_tpu_torch.ops.metrics import seg_finalize
    from robocupvision_tpu_torch.train import checkpoint

    if opt.int8 and not (opt.packed and opt.pallas):
        print("--int8 requires --packed --pallas")
        return -1
    fine_str = "Finetuned" if opt.finetuned else ""
    prune_str = "Pruned" if opt.pruned else ""
    out_dir = os.path.join("output", "LabelProp",
                           "Real" if opt.finetuned else "Synthetic")
    os.makedirs(out_dir, exist_ok=True)

    ds = LPDataSet(opt.root, train=False, img_size=IMG_SIZE,
                   finetune=opt.finetuned, len_seq=2)
    if len(ds) == 0:
        print(f"No LabelProp data under {opt.root}")
        return -1
    out_size = 1.0 / (IMG_SIZE[0] * IMG_SIZE[1])

    def write_mask(i, labels):
        from PIL import Image

        Image.fromarray(colorize(labels, NUM_CLASSES)).save(
            os.path.join(out_dir, "%d.png" % i))

    if opt.optFlow:
        def frames():
            for i in range(len(ds)):
                _, labs, grays = ds[i]
                if opt.jaxFlow:
                    yield (torch.from_numpy(labs).to(dev),
                           torch.from_numpy(grays).to(dev))
                else:
                    yield labs, grays

        pair = (optflow.optflow_torch, optflow.warp_labels_torch) \
            if opt.jaxFlow else (optflow.optflow_cv2, optflow.update_labels_cv2)
        acc, img_cnt = flow_and_score(*pair, frames(), NUM_CLASSES,
                                      on_mask=write_mask, device=dev)
        t_total = 0.0
    else:
        model = zoo.make("label_prop", num_classes=NUM_CLASSES, planes=32,
                         device=dev)
        path = "pth/bestModelLP" + fine_str + prune_str + ".pth"
        print(f"Loading {path}")
        model.load_state_dict(checkpoint.load_any(path, model.registry))
        deploy.export_deployment("./weightsLP", model)

        if opt.packed:
            # f32: the packed graph's labels stay those of the plain graph
            # but for argmax ties; --pallas runs the three fused chains (K2
            # on CUDA)
            pk = dict(pallas=True, pallas_fold_stem=True, pallas_mid=True) \
                if opt.pallas else {}
            pi = packed_mod.build_packed_label_prop(model, None, torch.float32,
                                                    device=dev, **pk)
            if opt.int8:
                imgs0, labs0, _ = ds[0]
                calib, _ = build_lp_pairs(imgs0[None], labs0[None], NUM_CLASSES)
                pi = packed_mod.quantize_int8(pi, calib)
            infer = pi.infer
        else:
            def infer(x):
                return torch.argmax(model(x), dim=-1)

        def pairs():
            for i in range(len(ds)):
                imgs, labs, _ = ds[i]
                yield build_lp_pairs(imgs[None], labs[None], NUM_CLASSES)

        with torch.no_grad():
            acc, t_total, img_cnt = serve_and_score(
                infer, pairs(), NUM_CLASSES, on_mask=write_mask, device=dev)

    fin = seg_finalize(acc, out_size)
    print("Validation Pixel Acc: %.2f Mean Class Acc: %.2f Mean IoU: %.2f"
          % (float(fin["pixel_acc"]), float(fin["mean_class_acc"]),
             float(fin["mean_iou"])))
    print(np.array_str(np.asarray(fin["conf"]), precision=2, suppress_small=True))
    print(t_total / max(img_cnt, 1) * 1000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
