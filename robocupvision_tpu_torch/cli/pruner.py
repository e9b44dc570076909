"""Iterative pruning CLI, the reference's ``python pruner.py`` (the JAX
package's cli/pruner.py; reference pruner.py:16-295).

Loads the finetuned legacy checkpoint and runs ``--iters`` iterations of
{ reload the best -> size-adaptive top-k pruning at (iter+1)*8% -> a
cosine-annealed SGD finetune with masked gradients for (iter+1) *
``--epochsPerIter`` epochs }, saving
pth/bestModelSeg{...}FinetunedPruned2.pth on the best validation loss. The
dataset is decoded once and kept on the device; the iterations run in
:func:`prune_iterations`, which takes the train and val ``DeviceCache``.

Intentional deviation: class weights use the boolean keep-filter
(weights[classIndices == 1]) like every other entry point. The reference's
pruner.py:125 gathers by the 0/1 *values* (weights[classIndices]), an
apparent typo that gives near-uniform weights; see PARITY.md deviations.

    python -m robocupvision_tpu_torch.cli.pruner --root $DATA

runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Dict, Optional

import numpy as np

from robocupvision_tpu_torch.device import DeviceLike, no_tf32, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Iterative pruning")
    for flag in ["--noScale", "--v2", "--noBall", "--noGoal", "--noRobot",
                 "--noLine", "--topCam", "--bottomCam"]:
        p.add_argument(flag, action="store_true", default=False)
    p.add_argument("--root", type=str,
                   default=os.environ.get("ROBOCUP_DATA", "./data"))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--epochsPerIter", type=int, default=10)
    p.add_argument("--batchSize", type=int, default=8)
    return p


def flags_of(opt: argparse.Namespace):
    from robocupvision_tpu_torch.train import naming

    return naming.Flags(v2=opt.v2, no_scale=opt.noScale, no_ball=opt.noBall,
                        no_goal=opt.noGoal, no_robot=opt.noRobot,
                        no_line=opt.noLine, top_cam=opt.topCam,
                        bottom_cam=opt.bottomCam)


def prune_iterations(opt: argparse.Namespace, train_cache, val_cache,
                     device: DeviceLike = None,
                     on_iter: Optional[Callable] = None) -> Dict:
    """The pruning iterations of the flags ``opt`` on the two caches, from
    the finetuned checkpoint in the working directory. ``on_iter(it,
    masks, trainer)`` is called after each iteration's finetune. Returns
    the best validation metrics (``loss``, ``pixel_acc``,
    ``mean_class_acc``, ``mean_iou``, ``conf``; empty without a
    validated epoch)."""
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops import pruning as prune_ops
    from robocupvision_tpu_torch.train import checkpoint, naming, optim
    from robocupvision_tpu_torch.train.loop import Trainer
    from robocupvision_tpu_torch.train.schedules import CosineAnnealingLR
    from robocupvision_tpu_torch.train.step import StepCfg

    dev = resolve_device(device)
    no_tf32()
    flags = flags_of(opt)
    camera = flags.camera
    num_classes = flags.num_classes
    h, w = train_cache.images.shape[1:3]
    if opt.v2:
        model = zoo.make("pb_fcn_2", classify=False, num_classes=num_classes,
                         device=dev)
    else:
        model = zoo.make("pb_fcn", planes=32, num_classes=num_classes,
                         kernel_size=1, no_scale=opt.noScale, classify=False,
                         device=dev)

    weights = [1, 4, 2, 4, 1.5]
    keep = [True, not opt.noBall, not opt.noRobot, not opt.noGoal,
            not opt.noLine]
    cw = tuple(wt for wt, k in zip(weights, keep) if k)

    load_path = naming.legacy_model_name(flags, seg=True, finetuned=True,
                                         camera=camera)
    print(f"Loading {load_path}")
    params = checkpoint.load_any(load_path, model.registry)

    save_path = naming.legacy_model_name(flags, seg=True, finetuned=True,
                                         pruned="Pruned2", camera=camera)

    lr, momentum = 1e-2, 0.1
    prune_am = 0.08
    low_t = 500 if opt.v2 else 1000
    high_t = 15000 if opt.v2 else 50000

    cfg = StepCfg(num_classes=num_classes, loss="ce2d", class_weights=cw,
                  mask_flags=(opt.noBall, opt.noRobot, opt.noGoal, opt.noLine),
                  augment=True, augment_mode="legacy", out_size=1.0 / (h * w))

    final_best: Dict = {}
    for it in range(opt.iters):
        limit = (it + 1) * opt.epochsPerIter
        if it > 0 and checkpoint.exists(save_path):
            print("Best Model reloaded")
            params = checkpoint.load_any(save_path, model.registry)
        params, masks = prune_ops.prune_topk(params, model.registry,
                                             (it + 1) * prune_am, low_t,
                                             high_t)
        tx = optim.sgd(momentum=momentum, weight_decay=1e-3)
        tr = Trainer(model, tx, cfg, train_cache, val_cache, opt.batchSize)
        tr.set_params(params)
        sched = CosineAnnealingLR([lr], limit, 1e-3)

        best_loss = float("inf")
        for epoch in range(limit):
            cur_lr = sched.step()[0]  # the reference steps before the epoch
            res = tr.train_epoch(cur_lr, prune_masks=masks)
            print("Epoch [%d] Training Loss: %.4f Training Pixel Acc: %.2f"
                  % (epoch + 1, res.loss, res.pixel_acc))
            val = tr.valid_epoch()
            print("Epoch [%d] Validation Loss: %.4f Validation Pixel Acc: %.2f "
                  "Mean Class Acc: %.2f IoU: %.2f"
                  % (epoch + 1, val["loss"], val["pixel_acc"],
                     val["mean_class_acc"], val["mean_iou"]))
            if val["loss"] < best_loss:
                best_loss = val["loss"]
                final_best = val
                print(np.array_str(np.asarray(val["conf"]), precision=2,
                                   suppress_small=True))
                checkpoint.save(save_path, model.registry, tr.params_numpy())
        if on_iter is not None:
            on_iter(it, masks, tr)
        params = tr.params_numpy()
    return final_best


def main(argv=None, device: DeviceLike = None) -> int:
    opt = build_parser().parse_args(argv)
    flags = flags_of(opt)
    if flags.num_classes <= 1:
        print("You need to have at least one non-background class!")
        return -1
    dev = resolve_device(device)

    from robocupvision_tpu_torch.data.datasets import SSDataSet
    from robocupvision_tpu_torch.data.device_cache import DeviceCache

    scale = 1 if opt.noScale else 4
    root = os.path.join(opt.root, "FinetuneHorizon")
    train_ds = SSDataSet(root, "train", flags.camera, scale)
    val_ds = SSDataSet(root, "val", flags.camera, scale)
    if len(train_ds) == 0 or len(val_ds) == 0:
        print(f"No data under {root}")
        return -1
    train_cache = DeviceCache.from_numpy(*train_ds.load_all(), device=dev)
    val_cache = DeviceCache.from_numpy(*val_ds.load_all(), device=dev)
    final_best = prune_iterations(opt, train_cache, val_cache, dev)
    print("Optimization finished Validation Loss: %.4f Pixel Acc: %.2f "
          "Mean Class Acc: %.2f IoU: %.2f"
          % (final_best.get("loss", 0), final_best.get("pixel_acc", 0),
             final_best.get("mean_class_acc", 0),
             final_best.get("mean_iou", 0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
