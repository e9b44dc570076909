"""Legacy segmentation training CLI, the reference's ``python trainer.py``
(the JAX package's cli/trainer.py; reference trainer.py:16-316).

The same flags, prints and checkpoint names: SSDataSet frames, PB_FCN or
with ``--v2`` PB_FCN_2 started from classTrainer's (or, with
``--finetune``, trainer's) pth/bestModel*.pth, the v2 decoder and head
reset to a fresh init when not finetuning, SGD (momentum 0.5, 0.1 when
finetuning; weight decay 1e-3) with plateau rollback, the legacy
augmentation, ``--prune`` (band pruning and masked gradients, with
``--finetune``), the best epoch on the validation loss saved to
pth/bestModelSeg{VGA}{v2}{ablations}{cam}{Finetuned}{Pruned}.pth. The
dataset is decoded once and kept on the device; the training runs in
:func:`train_segmenter`, which takes the train and val ``DeviceCache``.

    python -m robocupvision_tpu_torch.cli.trainer --root $DATA

runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

from robocupvision_tpu_torch.device import DeviceLike, no_tf32, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Legacy segmentation training")
    for flag in ["--finetune", "--prune", "--noScale", "--v2", "--noBall",
                 "--noGoal", "--noRobot", "--noLine", "--topCam", "--bottomCam"]:
        p.add_argument(flag, action="store_true", default=False)
    p.add_argument("--root", type=str,
                   default=os.environ.get("ROBOCUP_DATA", "./data"))
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batchSize", type=int, default=None)
    p.add_argument("--plotPort", type=int, default=None,
                   help="Serve live loss plots on this port (0 = ephemeral; "
                        "the reference's Visdom used 8097)")
    return p


def flags_of(opt: argparse.Namespace):
    from robocupvision_tpu_torch.train import naming

    return naming.Flags(finetune=opt.finetune, v2=opt.v2,
                        no_scale=opt.noScale, no_ball=opt.noBall,
                        no_goal=opt.noGoal, no_robot=opt.noRobot,
                        no_line=opt.noLine, top_cam=opt.topCam,
                        bottom_cam=opt.bottomCam)


def train_segmenter(opt: argparse.Namespace, train_cache, val_cache,
                    device: DeviceLike = None) -> Dict:
    """The segmentation training of the flags ``opt`` on the two caches:
    the model from its pretrained checkpoint (in the working directory),
    the band pruning of ``--finetune --prune``, the plateau-rollback loop
    with the loss curves and its checkpoint. Returns the best validation
    metrics (``loss``, ``pixel_acc``, ``mean_class_acc``, ``mean_iou``,
    ``conf``)."""
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops import pruning as prune_ops
    from robocupvision_tpu_torch.train import checkpoint, naming, optim
    from robocupvision_tpu_torch.train.legacy import run_plateau_training
    from robocupvision_tpu_torch.train.loop import Trainer
    from robocupvision_tpu_torch.train.step import StepCfg
    from robocupvision_tpu_torch.utils.plotting import LinePlotter

    dev = resolve_device(device)
    no_tf32()
    flags = flags_of(opt)
    # only the finetune set has camera sidecars (main says so)
    camera = flags.camera if opt.finetune else "both"
    h, w = train_cache.images.shape[1:3]
    num_classes = flags.num_classes
    if opt.v2:
        model = zoo.make("pb_fcn_2", classify=False, num_classes=num_classes,
                         device=dev)
    else:
        model = zoo.make("pb_fcn", planes=32, num_classes=num_classes,
                         kernel_size=1, no_scale=opt.noScale, classify=False,
                         device=dev)

    weights = [1, 6, 1.5, 3, 3]
    if opt.finetune:
        weights = [1, 4, 2, 4, 1.5]
    keep = [True, not opt.noBall, not opt.noRobot, not opt.noGoal,
            not opt.noLine]
    cw = tuple(wt for wt, k in zip(weights, keep) if k)

    # the pretrained backbone (trainer.py:146-151)
    load_path = naming.legacy_model_name(
        flags, seg=opt.finetune, finetuned=opt.prune,
        camera=camera if opt.prune else None)
    print(f"Loading {load_path}")
    params = checkpoint.load_any(load_path, model.registry)
    if opt.v2 and not opt.finetune:
        # the decoder and head start afresh (trainer.py:153-159): the
        # model's own weights are the fresh init
        fresh = model.state_dict()
        for k in params:
            if k.startswith(("upPart.", "segmenter.")):
                params[k] = fresh[k].cpu()

    prune_masks = None
    if opt.finetune and opt.prune:
        params, prune_masks = prune_ops.prune_band(params, model.registry)

    epochs = opt.epochs
    if epochs is None:
        epochs = (250 if opt.noScale else 500) if opt.finetune else \
            (100 if opt.noScale else 200)
    lr = 1e-1 * (0.1 if opt.finetune else 1.0)
    momentum = 0.1 if opt.finetune else 0.5
    patience = (25 if opt.noScale else 50) if opt.finetune else \
        (10 if opt.noScale else 20)
    batch = opt.batchSize or (8 if (opt.finetune or opt.noScale) else 32)

    cfg = StepCfg(num_classes=num_classes, loss="ce2d", class_weights=cw,
                  mask_flags=(opt.noBall, opt.noRobot, opt.noGoal, opt.noLine),
                  augment=True, augment_mode="legacy", out_size=1.0 / (h * w))
    tx = optim.sgd(momentum=momentum, weight_decay=1e-3)
    tr = Trainer(model, tx, cfg, train_cache, val_cache, batch)
    tr.set_params(params)

    save_path = naming.legacy_model_name(
        flags, seg=True, finetuned=opt.finetune,
        pruned="Pruned" if opt.prune else "",
        camera=camera if opt.finetune else "")
    # the loss curves, the reference's Visdom LinePlotter("RoboCup")
    # (trainer.py:193,241,299); --plotPort N serves them live
    plotter = LinePlotter("RoboCup")
    srv = None
    if opt.plotPort is not None:
        srv = plotter.serve(opt.plotPort)
        print(f"Live plots: http://127.0.0.1:{srv.server_address[1]}")
    try:
        best = run_plateau_training(tr, epochs, lr, save_path,
                                    patience=patience,
                                    prune_masks=prune_masks, select="loss",
                                    plotter=plotter)
    finally:
        if srv is not None:
            srv.shutdown()
    plotter.render()
    return best


def main(argv=None, device: DeviceLike = None) -> int:
    opt = build_parser().parse_args(argv)
    flags = flags_of(opt)
    if flags.num_classes <= 1:
        print("You need to have at least one non-background class!")
        return -1
    dev = resolve_device(device)
    camera = flags.camera
    if camera != "both" and not opt.finetune:
        print("You can only select camera images for the finetune dataset. "
              "Using both cameras by default")
        camera = "both"

    from robocupvision_tpu_torch.data.datasets import SSDataSet
    from robocupvision_tpu_torch.data.device_cache import DeviceCache

    scale = 1 if opt.noScale else 4
    root = os.path.join(opt.root, "FinetuneHorizon") if opt.finetune \
        else opt.root
    train_ds = SSDataSet(root, "train", camera, scale)
    val_ds = SSDataSet(root, "val", camera, scale)
    if len(train_ds) == 0 or len(val_ds) == 0:
        print(f"No data under {root}")
        return -1
    train_cache = DeviceCache.from_numpy(*train_ds.load_all(), device=dev)
    val_cache = DeviceCache.from_numpy(*val_ds.load_all(), device=dev)
    best = train_segmenter(opt, train_cache, val_cache, dev)
    print("Optimization finished Validation Loss: %.4f Pixel Acc: %.2f "
          "Mean Class Acc: %.2f IoU: %.2f"
          % (best["loss"], best.get("pixel_acc", 0),
             best.get("mean_class_acc", 0), best.get("mean_iou", 0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
