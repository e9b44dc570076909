"""Per-image inference CLI, the reference's ``python tester.py`` (the JAX
package's cli/tester.py).

Loads the legacy-pipeline checkpoint (pth/bestModelSeg...), serves the
SSDataSet val split one frame at a time, writes colourized PNG masks to
output/, and prints pixel accuracy, mean class accuracy, mean IoU, the
normalized confusion matrix and the mean per-frame latency in ms.
``--packed`` serves the lane-packed graph in f32 (``--pallas``: its fused
chains, kernel K2 on CUDA; ``--int8``: those chains quantized to int8,
calibrated on the first val frame); scores go through ``seg_batch_stats``
(kernel K1 on CUDA). ``--dump`` writes the robot's deployment pair
(net.cfg + weights2.dat, or weights.dat with ``--pruned``) under
./weights/<variant>/, and with ``--aot`` the traced serving graph
(serving.pt2, export/aot.py) at the first frame's shape, its fused chains
as K2 op nodes with ``--pallas``, int8 with ``--int8``.

    python -m robocupvision_tpu_torch.cli.tester --noScale --packed --pallas

runs on the CUDA card; ``main(argv, device="cpu")`` runs the plain PyTorch
path on the CPU.
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Per-image inference + export")
    for flag, h in [("--finetuned", "Use finetuned net and dataset"),
                    ("--pruned", "Use pruned net"), ("--pruned2", "Use pruned2 net"),
                    ("--noScale", "Use VGA resolution"), ("--v2", "Use PB-FCNv2"),
                    ("--noBall", "Treat Ball as Background"),
                    ("--noGoal", "Treat Goal as Background"),
                    ("--noRobot", "Treat Robot as Background"),
                    ("--noLine", "Treat Lines as Background"),
                    ("--topCam", "Use Top Camera images only"),
                    ("--bottomCam", "Use Bottom Camera images only"),
                    ("--dump", "Dump model parameters"),
                    ("--aot", "with --dump: also write the traced serving "
                     "graph (serving.pt2, torch.export -- framework "
                     "extension, export/aot.py)"),
                    ("--useCuda", "(accepted for compatibility; the CUDA "
                     "card is used)"),
                    ("--packed", "lane-packed inference graph "
                     "(exact rewrite; framework extension)"),
                    ("--pallas", "with --packed: run the packed conv regions "
                     "as fused chain kernels (exact rewrite; framework "
                     "extension, ops/cuda_packed.py)"),
                    ("--int8", "with --packed --pallas: static int8 PTQ "
                     "serving, calibrating per-stage activation scales on "
                     "the first val frame (approximate; framework "
                     "extension, models/packed.quantize_int8)")]:
        p.add_argument(flag, help=h, action="store_true", default=False)
    p.add_argument("--root", type=str, default=os.environ.get("ROBOCUP_DATA", "./data"))
    p.add_argument("--pipeline", type=int, default=1, metavar="DEPTH",
                   help="keep DEPTH frames in flight (software-pipelined "
                   "serving; overlaps dispatch/compute/readback -- framework "
                   "extension, utils/serving.py). 1 = the reference's serial "
                   "per-frame timing (tester.py:142-144)")
    return p


def serve_and_score(infer: Callable, frames: Iterable[Tuple[np.ndarray, np.ndarray]],
                    num_classes: int, pipeline: int = 1,
                    on_mask: Optional[Callable[[int, np.ndarray], None]] = None,
                    device: DeviceLike = None) -> Tuple[SegAccum, float, int]:
    """Serve ``frames``, (img (H, W, 3) float32, lab (H, W) int) pairs with
    the labels already remapped, one at a time through ``infer`` ((1, H, W,
    3) tensor on ``device`` -> (1, H, W) int labels), and score each served
    map against its label with ``seg_batch_stats``. ``on_mask(i, labels)``
    sees every served (H, W) map in frame order.

    ``pipeline == 1`` times each call alone (input already on the device,
    then the call to its synchronise), as the reference does; ``pipeline >
    1`` keeps that many frames in flight (utils/serving.ServingPipeline) and
    times the whole loop, end to end. Returns (host accumulator, seconds,
    frames served)."""
    from robocupvision_tpu_torch.utils.serving import ServingPipeline

    dev = resolve_device(device)
    acc = SegAccum.zero(num_classes)

    def consume(i, pred, lab):
        if on_mask is not None:
            on_mask(i, pred.numpy()[0])
        return seg_batch_stats_host(pred, lab[None], num_classes, device=dev)

    n = 0
    if pipeline > 1:
        pipe = ServingPipeline(infer, depth=pipeline, device=dev)
        labs = []
        t0 = time.perf_counter()
        for img, lab in frames:
            labs.append(lab)
            got = pipe.submit(img[None])
            if got is not None:
                acc = acc + consume(n, got, labs[n])
                n += 1
        for got in pipe.flush():
            acc = acc + consume(n, got, labs[n])
            n += 1
        return acc, time.perf_counter() - t0, n
    t_total = 0.0
    for img, lab in frames:
        x = torch.from_numpy(np.ascontiguousarray(img[None])).to(dev)
        synchronize(dev)
        beg = time.perf_counter()
        pred = infer(x)
        synchronize(dev)
        t_total += time.perf_counter() - beg
        acc = acc + consume(n, pred.cpu(), lab)
        n += 1
    return acc, t_total, n


def dump(model, dump_dir: str, fname: str, v2: bool = False,
         aot_hw: Optional[Tuple[int, int]] = None, pallas: bool = False,
         int8: bool = False, calib_x=None) -> Optional[str]:
    """``--dump``: the deployment pair of ``model`` under ``dump_dir``
    (net.cfg + ``fname``; ``v2``, PB_FCN_2, only the weights, its
    classification head left out as the reference's substring test does).
    With ``aot_hw`` (``--aot``), also the traced f32 serving graph at that
    frame shape: its fused chains as K2 op nodes with ``pallas``, int8
    with ``int8`` (calibrated on ``calib_x``). Returns the artifact's path,
    or None."""
    from robocupvision_tpu_torch.export import aot, deploy, weights_io

    if v2:
        weights_io.save_params(dump_dir, model.registry, model.state_dict(),
                               fname=fname, skip_classifier=True)
    else:
        deploy.export_deployment(dump_dir, model, fname=fname)
    print(f"Dumped weights to {dump_dir}/{fname}")
    if aot_hw is None:
        return None
    # the traced graph is shape-specialized, as the served one
    out = aot.export_serving(dump_dir, model, hw=aot_hw, dtype=torch.float32,
                             pallas=pallas, int8=int8, calib_x=calib_x)
    print(f"Dumped AOT serving graph to {out}")
    return out


def main(argv=None, device: DeviceLike = None) -> int:
    opt = build_parser().parse_args(argv)
    dev = resolve_device(device)

    from robocupvision_tpu_torch.data.datasets import SSDataSet
    from robocupvision_tpu_torch.models import packed as packed_mod
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops.labels import colorize, mask_label_table
    from robocupvision_tpu_torch.ops.metrics import seg_finalize
    from robocupvision_tpu_torch.train import checkpoint, naming

    flags = naming.Flags(v2=opt.v2, no_scale=opt.noScale, no_ball=opt.noBall,
                         no_goal=opt.noGoal, no_robot=opt.noRobot,
                         no_line=opt.noLine, top_cam=opt.topCam,
                         bottom_cam=opt.bottomCam)
    if flags.num_classes <= 1:
        print("You need to have at least one non-background class!")
        return -1
    if opt.int8 and not (opt.packed and opt.pallas):
        print("--int8 requires --packed --pallas")
        return -1

    prune_str = "Pruned" if opt.pruned else ("Pruned2" if opt.pruned2 else "")
    camera = flags.camera
    cam_load = camera if opt.finetuned else ""
    scale = 1 if opt.noScale else 4
    lab_size = (480 // scale, 640 // scale)
    out_size = 1.0 / (lab_size[0] * lab_size[1])
    num_classes = flags.num_classes

    root = os.path.join(opt.root, "FinetuneHorizon") if opt.finetuned else opt.root
    out_dir = "./output/FinetuneHorizon/" if opt.finetuned else "./output/"
    os.makedirs(out_dir, exist_ok=True)

    ds = SSDataSet(root, split="val", camera=camera, scale=scale)
    if len(ds) == 0:
        print(f"No data found under {root}")
        return -1

    if opt.v2:
        model = zoo.make("pb_fcn_2", classify=False, num_classes=num_classes,
                         device=dev)
    else:
        model = zoo.make("pb_fcn", planes=32, num_classes=num_classes,
                         kernel_size=1, no_scale=opt.noScale, classify=False,
                         device=dev)

    path = naming.legacy_model_name(flags, seg=True, finetuned=opt.finetuned,
                                    pruned=prune_str, camera=cam_load)
    print(f"Loading {path}")
    model.load_state_dict(checkpoint.load_any(path, model.registry))

    if opt.dump:
        # the reference's path formula (tester.py:122): "./weights/" +
        # the variant's parts
        dump_dir = "./weights/" + ("VGA" if opt.noScale else "") + \
            ("v2" if opt.v2 else "") + ("NoBall" if opt.noBall else "") + \
            ("NoGoal" if opt.noGoal else "") + ("NoRobot" if opt.noRobot else "") + \
            ("NoLine" if opt.noLine else "") + cam_load
        dump(model, dump_dir, "weights.dat" if opt.pruned else "weights2.dat",
             v2=opt.v2,
             aot_hw=tuple(ds[0][0].shape[:2]) if opt.aot else None,
             pallas=opt.pallas, int8=opt.int8,
             calib_x=ds[0][0][None] if opt.int8 else None)

    table = mask_label_table(opt.noBall, opt.noRobot, opt.noGoal, opt.noLine)

    if opt.packed:
        # f32: the packed graph's labels stay those of the plain graph but
        # for argmax ties; --pallas runs the fused chains (K2 on CUDA)
        pk = dict(pallas=True) if opt.pallas else {}
        build = packed_mod.build_packed_infer if opt.v2 \
            else packed_mod.build_packed_pb_fcn
        pi = build(model, None, torch.float32, device=dev, **pk)
        if opt.int8:
            pi = packed_mod.quantize_int8(pi, ds[0][0][None])
        infer = pi.infer
    else:
        def infer(x):
            return torch.argmax(model(x), dim=-1)

    def write_mask(i, labels):
        from PIL import Image

        Image.fromarray(colorize(labels, 5)).save(
            os.path.join(out_dir, "%d.png" % i))

    frames = ((img, table[lab]) for img, lab in (ds[i] for i in range(len(ds))))
    with torch.no_grad():
        acc, t_total, n = serve_and_score(infer, frames, num_classes,
                                          pipeline=opt.pipeline,
                                          on_mask=write_mask, device=dev)
    if opt.pipeline > 1:
        print(f"Pipelined serving (depth {opt.pipeline}): end-to-end wall "
              f"per frame below")

    fin = seg_finalize(acc, out_size)
    print("Validation Pixel Acc: %.2f Mean Class Acc: %.2f Mean IoU: %.2f"
          % (float(fin["pixel_acc"]), float(fin["mean_class_acc"]),
             float(fin["mean_iou"])))
    print(np.array_str(np.asarray(fin["conf"]), precision=2, suppress_small=True))
    print(t_total / max(n, 1) * 1000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
