"""Classification pretraining CLI, the reference's ``python classTrainer.py``
(the JAX package's cli/classTrainer.py; reference classTrainer.py:14-193).

The same flags, prints and checkpoint name: ImageFolder patches,
PB_FCN(classify=True) or with ``--v2`` PB_FCN_2(classify=True), SGD
(momentum 0.9, weight decay 1e-5) with plateau rollback (factor 0.5,
patience 20, threshold 1e-3), the legacy augmentation without its vertical
flip, the best epoch on the validation loss saved to
pth/bestModel{VGA}{v2}{ablations}.pth for trainer.py to start from. The
dataset is decoded once and kept on the device; the training runs in
:func:`train_classifier`, which takes the train and val ``DeviceCache``.

    python -m robocupvision_tpu_torch.cli.classTrainer --root $DATA

runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

from robocupvision_tpu_torch.device import DeviceLike, no_tf32, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Classification pretraining")
    for flag in ["--noScale", "--v2", "--noBall", "--noGoal", "--noRobot",
                 "--noLine"]:
        p.add_argument(flag, action="store_true", default=False)
    p.add_argument("--root", type=str,
                   default=os.environ.get("ROBOCUP_DATA", "./data"))
    p.add_argument("--epochs", type=int, default=200)
    return p


def flags_of(opt: argparse.Namespace):
    from robocupvision_tpu_torch.train import naming

    return naming.Flags(v2=opt.v2, no_scale=opt.noScale, no_ball=opt.noBall,
                        no_goal=opt.noGoal, no_robot=opt.noRobot,
                        no_line=opt.noLine)


def train_classifier(opt: argparse.Namespace, train_cache, val_cache,
                     device: DeviceLike = None) -> Dict:
    """The classification training of the flags ``opt`` on the two caches
    (patches and class indices): the model, the plateau-rollback loop and
    its checkpoint. Returns the best validation metrics (``loss``,
    ``acc``, ``conf``)."""
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.train import naming, optim
    from robocupvision_tpu_torch.train.legacy import run_plateau_training
    from robocupvision_tpu_torch.train.loop import Trainer
    from robocupvision_tpu_torch.train.step import StepCfg

    dev = resolve_device(device)
    no_tf32()
    flags = flags_of(opt)
    num_classes = flags.num_classes
    if opt.v2:
        model = zoo.make("pb_fcn_2", classify=True, num_classes=num_classes,
                         device=dev)
    else:
        model = zoo.make("pb_fcn", planes=32, num_classes=num_classes,
                         kernel_size=1, no_scale=opt.noScale, classify=True,
                         device=dev)
    batch = 64 if opt.v2 else 32
    cfg = StepCfg(num_classes=num_classes, loss="ce",
                  mask_flags=(opt.noBall, opt.noRobot, opt.noGoal, opt.noLine),
                  augment=True, augment_mode="legacy_hflip", jitter=True,
                  out_size=1.0)
    tx = optim.sgd(momentum=0.9, weight_decay=1e-5)
    tr = Trainer(model, tx, cfg, train_cache, val_cache, batch)
    tr.init()
    return run_plateau_training(
        tr, opt.epochs, 1e-2, naming.legacy_model_name(flags),
        patience=20, factor=0.5,
        threshold=1e-3, select="loss")


def main(argv=None, device: DeviceLike = None) -> int:
    opt = build_parser().parse_args(argv)
    if flags_of(opt).num_classes <= 1:
        print("You need to have at least one non-background class!")
        return -1
    dev = resolve_device(device)

    from robocupvision_tpu_torch.data.datasets import ImageFolder
    from robocupvision_tpu_torch.data.device_cache import DeviceCache

    train_ds = ImageFolder(os.path.join(opt.root, "Classification", "train"))
    val_ds = ImageFolder(os.path.join(opt.root, "Classification", "val"))
    if len(train_ds) == 0 or len(val_ds) == 0:
        print(f"No classification data under {opt.root}")
        return -1
    train_cache = DeviceCache.from_numpy(*train_ds.load_all(), device=dev)
    val_cache = DeviceCache.from_numpy(*val_ds.load_all(), device=dev)
    best = train_classifier(opt, train_cache, val_cache, dev)
    print("Finished: Best Validation Loss: %.4f Best Validation Acc: %.2f"
          % (best["loss"], best["acc"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
