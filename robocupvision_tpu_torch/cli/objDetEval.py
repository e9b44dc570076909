"""BNN classifier evaluation CLI, the reference's ``python objDetEval.py``
(the JAX package's cli/objDetEval.py; reference objDetEval.py:15-189).

Trains BNN L (the default; ``--hessMC`` for the small net) on the
Classification/correctBBsTrain patches, validating on
Classification/correctBBs, with SGD (momentum 0.9, weight decay 5e-4) and
plateau rollback (factor 0.2, patience 10, threshold 1e-3), the best epoch
on the validation accuracy, saved as pth/bestModelHess{L,MC}.pth. At each
new best, and at the end, it prints the accuracy, false-negative and
false-positive rates over the confusion's foreground rows and columns
(:func:`fp_fn_stats`). The training runs in :func:`train_detector`,
which takes the train and val ``DeviceCache``.

    python -m robocupvision_tpu_torch.cli.objDetEval --root $DATA

runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np

from robocupvision_tpu_torch.device import DeviceLike, no_tf32, resolve_device

NUM_CLASSES = 4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BNN object-detection evaluation")
    p.add_argument("--hessL", action="store_true", default=False)
    p.add_argument("--hessMC", action="store_true", default=False)
    p.add_argument("--root", type=str,
                   default=os.environ.get("ROBOCUP_DATA", "./data"))
    p.add_argument("--epochs", type=int, default=40)
    return p


def fp_fn_stats(conf: np.ndarray):
    """objDetEval.py:171-179: (accuracy, false negatives, false positives)
    in percent over the foreground block of the confusion (rows: truth,
    columns: prediction)."""
    total = float(conf[:, 1:4].sum())
    tot_acc = float(conf[1, 1] + conf[2, 2] + conf[3, 3])
    fp = float(conf[1:4, :].sum()) - tot_acc
    if total == 0:
        return 0.0, 0.0, 0.0
    return tot_acc / total * 100, 100 - tot_acc / total * 100, fp / total * 100


def _print_stats(prefix: str, conf) -> None:
    acc, fn, fp = fp_fn_stats(np.asarray(conf))
    print("%s: Accuracy: %.4f False Neg: %.2f False Pos: %.2f"
          % (prefix, acc, fn, fp))


def train_detector(opt: argparse.Namespace, train_cache, val_cache,
                   device: DeviceLike = None) -> Dict:
    """The training of the flags ``opt`` on the two caches (32x32 patches
    and class indices), with the report at each new best. Returns the best
    validation metrics (``loss``, ``acc``, ``conf``)."""
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.train import optim
    from robocupvision_tpu_torch.train.legacy import run_plateau_training
    from robocupvision_tpu_torch.train.loop import Trainer
    from robocupvision_tpu_torch.train.step import StepCfg

    dev = resolve_device(device)
    no_tf32()
    variant = "MC" if opt.hessMC else "L"
    model = zoo.make("bnn", variant=variant, num_classes=NUM_CLASSES,
                     device=dev)
    cfg = StepCfg(num_classes=NUM_CLASSES, loss="ce", augment=True,
                  augment_mode="legacy_hflip", jitter=True, out_size=1.0)
    tx = optim.sgd(momentum=0.9, weight_decay=5e-4)
    tr = Trainer(model, tx, cfg, train_cache, val_cache, 64)
    tr.init()
    return run_plateau_training(
        tr, opt.epochs, 1e-2, f"pth/bestModelHess{variant}.pth", patience=10,
        factor=0.2, threshold=1e-3, select="acc",
        on_best=lambda val: _print_stats("Best", val["conf"]))


def main(argv=None, device: DeviceLike = None) -> int:
    opt = build_parser().parse_args(argv)
    dev = resolve_device(device)

    from robocupvision_tpu_torch.data.datasets import ImageFolder
    from robocupvision_tpu_torch.data.device_cache import DeviceCache

    train_ds = ImageFolder(os.path.join(opt.root, "Classification",
                                        "correctBBsTrain"))
    val_ds = ImageFolder(os.path.join(opt.root, "Classification",
                                      "correctBBs"))
    if len(train_ds) == 0 or len(val_ds) == 0:
        print(f"No classification data under {opt.root}")
        return -1
    train_cache = DeviceCache.from_numpy(*train_ds.load_all(), device=dev)
    val_cache = DeviceCache.from_numpy(*val_ds.load_all(), device=dev)
    best = train_detector(opt, train_cache, val_cache, dev)
    print("Finished: Best Validation Loss: %.4f Best Validation Acc: %.2f"
          % (best["loss"], best["acc"]))
    if best.get("conf") is not None:
        _print_stats("Finished", best["conf"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
