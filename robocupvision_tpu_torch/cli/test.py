"""Full evaluation CLI, the reference's ``python test.py`` (the JAX
package's cli/test.py; reference test.py:215-353).

Evaluates the family of ROBO-UNet checkpoints the flags select
(checkpoints/best{Finetune}{v2}{VGA}{UNet}...: transfer or pruned variants
sorted descending, then the base), with the architecture of the flags
(``--UNet``, ``--v2`` or the flagship, train.py's hyperparameter table), on
the SSYUVDataset val split held on the device: it prints each net's
analytic op counts, then its pruned share, loss, score, pixel accuracy,
mean class accuracy and mean IoU, and object-level (precision + recall) / 2
at the IoU thresholds {0.75, 0.5, 0.25, 0.1, 0.05} and the centre-distance
thresholds {1.25, 2.5, 5, 10, 20} (x2 at VGA). Scores go through
``seg_batch_stats`` (kernel K1 on CUDA), one launch per batch.

    python -m robocupvision_tpu_torch.cli.test --root $DATA --noScale --UNet

runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
``--lProp`` evaluates the first checkpoint on the LabelProp val sequences
instead (four frames a batch) and scores label propagation too: frame 0's
prediction is frame 1's warped along the Farneback flow, each later
frame's the previous propagated map warped along the flow back to it; the
CLI runs cv2's Farneback on the host (``ops/optflow.py``; cv2 must be
installed), and ``evaluate`` takes any flow and warp pair.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from robocupvision_tpu_torch.device import DeviceLike, resolve_device

THRESHOLDS = (0.75, 0.5, 0.25, 0.1, 0.05)
D_THRESHOLDS = (1.25, 2.5, 5, 10, 20)
LEN_SEQ = 4  # --lProp: frames a LabelProp sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Segmentation evaluation")
    for flag, h in [("--finetune", "Finetuning"), ("--v2", "Use v2 architecture"),
                    ("--noScale", "Use VGA resolution"), ("--UNet", "Use Vanilla U-Net"),
                    ("--useDice", "Use Dice Loss"), ("--noBall", "Treat Ball as Background"),
                    ("--noGoal", "Treat Goal as Background"),
                    ("--noRobot", "Treat Robot as Background"),
                    ("--noLine", "Treat Lines as Background"),
                    ("--topCam", "Use Top Camera images only"),
                    ("--bottomCam", "Use Bottom Camera images only"),
                    ("--transfer", "Evaluate transfer checkpoints"),
                    ("--lProp", "Test label propagation")]:
        p.add_argument(flag, help=h, action="store_true", default=False)
    p.add_argument("--root", type=str,
                   default=os.environ.get("ROBOCUP_DATA", "../../Data/RoboCup"))
    p.add_argument("--batchSize", type=int, default=None)
    p.add_argument("--bf16", help="bfloat16 compute (f32 master weights)",
                   action="store_true", default=False)
    p.add_argument("--labSize", help="Override working resolution H W "
                   "(testing aid; the reference sizes are the default)",
                   type=int, nargs=2, default=None)
    return p


def evaluate(model, batches: Iterable[tuple], cfg,
             thresholds: Sequence[float] = THRESHOLDS,
             d_thresholds: Sequence[float] = D_THRESHOLDS,
             flow: Optional[Callable] = None,
             warp: Optional[Callable] = None) -> dict:
    """One net over ``batches`` of (imgs, labels, sample_mask) on the
    model's device (``epoch_batches``), as test.py's loop scores them:
    returns {"acc": the host SegAccum, "loss": the mean batch loss,
    "batches", "images": the valid images, "iou", "dist": the object-level
    (precision + recall) / 2 per threshold, averaged over the images}.

    With ``flow`` and ``warp`` (``--lProp``), each batch is a sequence
    (imgs, labels, sample_mask, grays) whose (B, H, W) uint8 grays are in
    the form ``flow`` takes; the predictions are propagated along it
    (``pred_lp[0] = warp(pred[1], flow(g0, g1))``, ``pred_lp[i] =
    warp(pred_lp[i-1], flow(g_i, g_{i-1}))``) and scored the same way into
    "iou_lp" and "dist_lp"."""
    from robocupvision_tpu_torch.ops import objmetrics
    from robocupvision_tpu_torch.ops.labels import mask_label_table
    from robocupvision_tpu_torch.ops.metrics import SegAccum, to_host
    from robocupvision_tpu_torch.train.step import make_eval_step

    step = make_eval_step(model, cfg)
    table = mask_label_table(*cfg.mask_flags)
    classes = np.arange(cfg.num_classes)[:, None, None, None]
    acc = SegAccum.zero(cfg.num_classes)
    tot_loss, n_batches, img_cnt = 0.0, 0, 0
    rec_prec = np.zeros((2, len(thresholds)))
    rec_prec_lp = np.zeros((2, len(thresholds)))
    for imgs, tgt, mask, *grays in batches:
        out = step(imgs, tgt, mask)
        acc = acc + to_host(out["acc"])
        tot_loss += float(out["loss"])
        n_batches += 1
        valid = mask.cpu().numpy() > 0
        pred = out["pred"].cpu().numpy()[valid]
        tgt = table[tgt.cpu().numpy()][valid]
        img_cnt += pred.shape[0]
        # (C, B, H, W) per-class masks
        mask_tgt = (tgt[None] == classes).astype(np.int64)
        rec_prec += objmetrics.get_prec_recall_multi(
            (pred[None] == classes).astype(np.int64), mask_tgt, thresholds,
            d_thresholds)
        if flow is not None:
            g = grays[0]
            src = out["pred"][torch.as_tensor(valid, device=imgs.device)]
            pred_lp = [warp(src[1], flow(g[0], g[1]))]
            for i in range(1, pred.shape[0]):
                pred_lp.append(warp(pred_lp[-1], flow(g[i], g[i - 1])))
            pred_lp = np.stack([np.asarray(torch.as_tensor(p).cpu())
                                for p in pred_lp])
            rec_prec_lp += objmetrics.get_prec_recall_multi(
                (pred_lp[None] == classes).astype(np.int64), mask_tgt,
                thresholds, d_thresholds)
    rec_prec /= max(img_cnt, 1)
    res = {"acc": acc, "loss": tot_loss / max(n_batches, 1),
           "batches": n_batches, "images": img_cnt, "iou": rec_prec[0],
           "dist": rec_prec[1]}
    if flow is not None:
        rec_prec_lp /= max(img_cnt, 1)
        res.update(iou_lp=rec_prec_lp[0], dist_lp=rec_prec_lp[1])
    return res


def metric_values(prune: float, res: dict, out_size: float) -> tuple:
    """The numbers of test.py's [Validate] line: (pruned share, mean
    loss, score, pixel accuracy, mean class accuracy, mean IoU)."""
    from robocupvision_tpu_torch.ops.metrics import seg_finalize

    fin = seg_finalize(res["acc"], out_size)
    return (prune, res["loss"], float(fin["score"]), float(fin["pixel_acc"]),
            float(fin["mean_class_acc"]), float(fin["mean_iou"]))


def metric_line(prune: float, res: dict, out_size: float) -> str:
    """test.py's [Validate] line."""
    return ("[Validate][Losses: pruned %f, total %f, avg: %f]"
            "[Pixel Acc: %f, Mean Class Acc: %f, Mean IoU: %f]"
            % metric_values(prune, res, out_size))


def main(argv=None, device: DeviceLike = None) -> int:
    opt = build_parser().parse_args(argv)
    dev = resolve_device(device)

    from robocupvision_tpu_torch.cli.train import model_hyper
    from robocupvision_tpu_torch.data.datasets import LPDataSet, SSYUVDataset
    from robocupvision_tpu_torch.data.device_cache import (DeviceCache,
                                                           epoch_batches)
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops import optflow
    from robocupvision_tpu_torch.ops.pruning import count_zero_weights
    from robocupvision_tpu_torch.train import checkpoint, naming
    from robocupvision_tpu_torch.train.step import StepCfg

    flags = naming.Flags(finetune=opt.finetune, v2=opt.v2, no_scale=opt.noScale,
                         unet=opt.UNet, no_ball=opt.noBall, no_goal=opt.noGoal,
                         no_robot=opt.noRobot, no_line=opt.noLine,
                         top_cam=opt.topCam, bottom_cam=opt.bottomCam)
    if flags.num_classes <= 1:
        print("You need to have at least one non-background class!")
        return -1
    camera = flags.camera
    if camera != "both" and not opt.finetune:
        print("You can only select camera images for the finetune dataset. "
              "Using both cameras by default")
        camera = "both"

    scale = 2 if opt.noScale else 4
    lab_size = tuple(opt.labSize) if opt.labSize else (480 // scale, 640 // scale)
    out_size = 1.0 / (lab_size[0] * lab_size[1])
    d_thresholds = [d * 2 for d in D_THRESHOLDS] if opt.noScale \
        else list(D_THRESHOLDS)

    # checkpoint family selection (test.py:264-288)
    name = naming.test_ckpt_glob_base(flags)
    weights_path = []
    if opt.transfer:
        weights_path = sorted(glob.glob(name + "T*.weights"), reverse=True)
    elif opt.finetune:
        weights_path = sorted(glob.glob(name + "*_*.weights"), reverse=True)
    weights_path += [name + ".weights"]
    for token, enabled in [("VGA", opt.noScale), ("v2", opt.v2),
                           ("UNet", opt.UNet), ("NoBall", opt.noBall),
                           ("NoGoal", opt.noGoal), ("NoRobot", opt.noRobot),
                           ("NoLine", opt.noLine)]:
        if not enabled:
            weights_path = [p for p in weights_path if token not in p]
    if opt.lProp:
        weights_path = weights_path[:1]

    num_classes = flags.num_classes
    weights = [1, 2, 6, 3, 2] if opt.useDice else [1, 10, 30, 5, 2]
    if opt.finetune:
        weights = [1, 5, 2, 6, 4]
    keep = [True, not opt.noBall, not opt.noRobot, not opt.noGoal, not opt.noLine]
    cfg = StepCfg(num_classes=num_classes,
                  loss="dice" if opt.useDice else "ce2d",
                  class_weights=tuple(w for w, k in zip(weights, keep) if k),
                  mask_flags=(opt.noBall, opt.noRobot, opt.noGoal, opt.noLine),
                  out_size=out_size,
                  compute_dtype="bfloat16" if opt.bf16 else "float32")
    batch_size = opt.batchSize or (16 if (opt.finetune or opt.noScale) else 64)

    if opt.lProp:
        lp = LPDataSet(opt.root, train=False, img_size=lab_size,
                       finetune=opt.finetune, len_seq=LEN_SEQ)
        if len(lp) == 0:
            print(f"No LabelProp data under {opt.root}")
            return -1

        def batches():
            for si in range(len(lp)):
                imgs, labs, grays = lp[si]
                yield (torch.from_numpy(imgs).to(dev),
                       torch.from_numpy(labs).to(dev),
                       torch.ones((imgs.shape[0],), dtype=torch.float32,
                                  device=dev), grays)
    else:
        ds = SSYUVDataset(opt.root, lab_size, False, opt.finetune, camera)
        if len(ds) == 0:
            print(f"No data found under {opt.root}")
            return -1
        cache = DeviceCache.from_numpy(*ds.load_all(), device=dev)

    for w_path in weights_path:
        if not os.path.exists(w_path):
            print(f"(skipping missing {w_path})")
            continue
        print("#" * 54)
        print(f"###### Testing {w_path} ######")
        print("#" * 54)

        model = zoo.make("robo_unet", no_scale=opt.noScale,
                         num_classes=num_classes, pool=opt.UNet, v2=opt.v2,
                         device=dev, **model_hyper(opt.UNet, opt.v2))
        state = checkpoint.load_any(w_path, model.registry)
        model.load_state_dict(state)
        comp = zoo.robo_unet_get_computations(model.cfg, state, pruned=True)
        print([round(c) for c in comp])
        print(round(sum(comp)))

        if opt.lProp:
            res = evaluate(model, batches(), cfg, THRESHOLDS, d_thresholds,
                           flow=optflow.optflow_cv2,
                           warp=optflow.update_labels_cv2)
        else:
            res = evaluate(model, epoch_batches(cache, batch_size), cfg,
                           THRESHOLDS, d_thresholds)
        prune = count_zero_weights(state, model.param_order)
        print(metric_line(prune, res, out_size))
        print("Normal")
        print("IoU:", res["iou"])
        print("Dist:", res["dist"])
        if opt.lProp:
            print("LP")
            print("IoU:", res["iou_lp"])
            print("Dist:", res["dist_lp"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
