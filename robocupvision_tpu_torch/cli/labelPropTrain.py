"""Label-propagation training CLI, the reference's ``python
labelPropTrain.py`` (the JAX package's cli/labelPropTrain.py; reference
labelPropTrain.py:18-319).

LPDataSet frame pairs, taken in both temporal directions as 8-channel
inputs [Y_t, Y_other, Y_t - Y_other, labelToPred(label_other)]
(:func:`build_lp_pairs`, which the serving CLI validLabelProp.py uses
too), the LabelProp net trained with weighted CE, SGD (lr 2e-1, x0.25 when
finetuning) with plateau rollback, horizontal and vertical flips without
colour jitter (which has no meaning on those inputs), ``--prune`` with
masked gradients, the best epoch on the validation loss saved to
pth/bestModelLP{Finetuned}{Pruned}.pth. The pairs are built once and kept
on the device; the training runs in :func:`train_label_prop`, which takes
the train and val ``DeviceCache``.

    python -m robocupvision_tpu_torch.cli.labelPropTrain --root $DATA

runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np

from robocupvision_tpu_torch.device import DeviceLike, no_tf32, resolve_device

NUM_CLASSES = 5


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Label propagation training")
    p.add_argument("--finetune", action="store_true", default=False)
    p.add_argument("--prune", action="store_true", default=False)
    p.add_argument("--root", type=str,
                   default=os.environ.get("ROBOCUP_DATA", "./data"))
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batchSize", type=int, default=8)
    return p


def build_lp_pairs(imgs: np.ndarray, labs: np.ndarray, num_classes: int):
    """(N, 2, H, W, 3) YUV images + (N, 2, H, W) labels -> (2N, H, W, 3 + C)
    inputs [Y_t, Y_other, Y_t - Y_other, labelToPred(label_other)] and
    (2N, H, W) targets, both temporal directions (reference
    labelPropTrain.py:178-193)."""
    n, _, h, w, _ = imgs.shape
    y = imgs[..., 0]  # (N, 2, H, W) luma channel
    oh = np.eye(num_classes, dtype=np.float32) * 2.0 - 1.0  # labelToPred rows
    inputs = np.zeros((2 * n, h, w, 3 + num_classes), np.float32)
    targets = np.zeros((2 * n, h, w), np.int32)
    for k, (a, b) in enumerate([(0, 1), (1, 0)]):
        inputs[k::2, ..., 0] = y[:, a]
        inputs[k::2, ..., 1] = y[:, b]
        inputs[k::2, ..., 2] = y[:, a] - y[:, b]
        inputs[k::2, ..., 3:] = oh[labs[:, b]]
        targets[k::2] = labs[:, a]
    return inputs, targets


def load_lp_cache(root: str, finetune: bool, train: bool, num_classes: int,
                  img_size=(120, 160), device: DeviceLike = None):
    """The LPDataSet pairs of one split as :func:`build_lp_pairs` inputs in
    a ``DeviceCache`` on ``device``; None when the split is empty."""
    from robocupvision_tpu_torch.data.datasets import LPDataSet
    from robocupvision_tpu_torch.data.device_cache import DeviceCache

    ds = LPDataSet(root, train=train, img_size=img_size, finetune=finetune,
                   len_seq=2)
    if len(ds) == 0:
        return None
    items = [ds[i] for i in range(len(ds))]
    inputs, targets = build_lp_pairs(np.stack([imgs for imgs, _, _ in items]),
                                     np.stack([labs for _, labs, _ in items]),
                                     num_classes)
    return DeviceCache.from_numpy(inputs, targets, device=device)


def train_label_prop(opt: argparse.Namespace, train_cache, val_cache,
                     device: DeviceLike = None) -> Dict:
    """The LabelProp training of the flags ``opt`` on the two caches of
    pairs: the model (``--finetune`` from its checkpoint in the working
    directory), the band pruning of ``--finetune --prune``, the
    plateau-rollback loop with the loss curves and its checkpoint. Returns
    the best validation metrics."""
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops import pruning as prune_ops
    from robocupvision_tpu_torch.train import checkpoint, optim
    from robocupvision_tpu_torch.train.legacy import run_plateau_training
    from robocupvision_tpu_torch.train.loop import Trainer
    from robocupvision_tpu_torch.train.step import StepCfg
    from robocupvision_tpu_torch.utils.plotting import LinePlotter

    dev = resolve_device(device)
    no_tf32()
    h, w = train_cache.images.shape[1:3]
    model = zoo.make("label_prop", num_classes=NUM_CLASSES, planes=32,
                     device=dev)
    cw = (1, 6, 1, 3, 2) if not opt.finetune else (1, 3, 0.5, 2, 1)
    lr = 2e-1 * (0.25 if opt.finetune else 1.0)
    momentum = 0.1 if opt.finetune else 0.5
    epochs = opt.epochs if opt.epochs is not None else \
        (500 if opt.finetune else 200)
    patience = 50 if opt.finetune else 20

    # the reference flips horizontally and vertically
    # (labelPropTrain.py:49-66); a colour jitter has no meaning on the
    # (Y, Y_other, diff, one-hot) inputs
    cfg = StepCfg(num_classes=NUM_CLASSES, loss="ce2d", class_weights=cw,
                  augment=True, augment_mode="legacy", jitter=False,
                  out_size=1.0 / (h * w))
    tx = optim.sgd(momentum=momentum, weight_decay=1e-3)
    tr = Trainer(model, tx, cfg, train_cache, val_cache, opt.batchSize * 2)
    tr.init()
    if opt.finetune:
        load_path = "pth/bestModelLP" + ("Finetuned" if opt.prune else "") \
            + ".pth"
        print(f"Loading {load_path}")
        tr.set_params(checkpoint.load_any(load_path, model.registry))

    prune_masks = None
    if opt.finetune and opt.prune:
        params, prune_masks = prune_ops.prune_band(tr.params_numpy(),
                                                   model.registry)
        tr.set_params(params)

    save_path = "pth/bestModelLP" + ("Finetuned" if opt.finetune else "") \
        + ("Pruned" if opt.prune else "") + ".pth"
    # the loss curves, like the reference's LinePlotter
    # (labelPropTrain.py:143,221,303)
    plotter = LinePlotter("main")
    best = run_plateau_training(tr, epochs, lr, save_path, patience=patience,
                                prune_masks=prune_masks, select="loss",
                                plotter=plotter)
    plotter.render()
    return best


def main(argv=None, device: DeviceLike = None) -> int:
    opt = build_parser().parse_args(argv)
    dev = resolve_device(device)
    train_cache = load_lp_cache(opt.root, opt.finetune, True, NUM_CLASSES,
                                device=dev)
    val_cache = load_lp_cache(opt.root, opt.finetune, False, NUM_CLASSES,
                              device=dev)
    if train_cache is None or val_cache is None:
        print(f"No LabelProp data under {opt.root}")
        return -1
    best = train_label_prop(opt, train_cache, val_cache, dev)
    print("Optimization finished Validation Loss: %.4f Total Acc: %.2f "
          "Mean Class Acc: %.2f IoU: %.2f"
          % (best["loss"], best.get("pixel_acc", 0),
             best.get("mean_class_acc", 0), best.get("mean_iou", 0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
