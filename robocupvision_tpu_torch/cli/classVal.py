"""Baseline-comparison training CLI, the reference's ``python classVal.py``
(the JAX package's cli/classVal.py; reference classVal.py:14-207).

Trains the DownSampler + Classifier pair (the encoder's second feature,
classified by a 4x4 max pool and a 1x1 conv), or a Hess et al. BNN
baseline (``--hessL`` / ``--hessMC``), on the Classification/trainBig
patches, validating on Classification/test: SGD (momentum 0.9, weight
decay 5e-4) with plateau rollback (factor 0.2, patience 10, threshold
1e-3), the legacy augmentation without its vertical flip, the best epoch
on the validation accuracy. The pair is saved as the reference saves it,
encoder and head apart: pth/bestModelB.pth and pth/bestClassB.pth; a
BNN as pth/bestModelHess{L,MC}.pth. The dataset is decoded once and kept
on the device; the training runs in :func:`train_baseline`, which takes
the train and val ``DeviceCache``.

    python -m robocupvision_tpu_torch.cli.classVal --root $DATA [--hessL]

runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional

import torch

from robocupvision_tpu_torch.device import DeviceLike, no_tf32, resolve_device

NUM_CLASSES = 4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Classifier baseline comparison")
    p.add_argument("--hessL", action="store_true", default=False)
    p.add_argument("--hessMC", action="store_true", default=False)
    p.add_argument("--root", type=str,
                   default=os.environ.get("ROBOCUP_DATA", "./data"))
    p.add_argument("--epochs", type=int, default=80)
    return p


class _ComboModel(torch.nn.Module):
    """The DownSampler encoder and the Classifier head as one model the
    Trainer takes, its params named ``down.*`` and ``head.*``.

    classVal.py:130-134 classifies from the encoder's second feature (f3).
    The reference's dropout argument there does not fit its own
    DownSampler (which takes none), so there is no dropout here either."""

    def __init__(self, num_feat: int, num_classes: int,
                 device: torch.device) -> None:
        super().__init__()
        from robocupvision_tpu_torch.models import zoo

        self.down = zoo.make("downsampler", planes=num_feat, device=device,
                             generator=torch.Generator().manual_seed(0))
        self.head = zoo.make("classifier", in_planes=num_feat * 2,
                             num_classes=num_classes, pool_size=4,
                             device=device,
                             generator=torch.Generator().manual_seed(1))
        self.family = "downsampler+classifier"

    @property
    def device(self) -> torch.device:
        return self.down.device

    @property
    def registry(self):
        from robocupvision_tpu_torch.models.layers import ParamSpec, Registry

        r = Registry()
        for part in ("down", "head"):
            for n, s in getattr(self, part).registry.specs.items():
                r.specs[f"{part}.{n}"] = ParamSpec(f"{part}.{n}", s.shape,
                                                   s.kind)
        return r

    def flat(self):
        return {f"{part}.{k}": v for part in ("down", "head")
                for k, v in getattr(self, part).flat().items()}

    def draw_dropout(self, gen, n, hw=None):
        return None

    @staticmethod
    def _split(params, part):
        pre = part + "."
        return {k[len(pre):]: v for k, v in params.items()
                if k.startswith(pre)}

    def apply(self, params, x, *, train: bool = False, dropout=None):
        pd, ph = self._split(params, "down"), self._split(params, "head")
        if not train:
            return self.head.apply(ph, self.down.apply(pd, x)[1])
        feats, mut = self.down.apply(pd, x, train=True)
        out, _ = self.head.apply(ph, feats[1], train=True)
        return out, {"down." + k: v for k, v in mut.items()}

    def split_state(self, params):
        """(encoder state, head state) of the combined params."""
        return self._split(params, "down"), self._split(params, "head")


def train_baseline(opt: argparse.Namespace, train_cache, val_cache,
                   device: DeviceLike = None) -> Dict:
    """The training of the flags ``opt`` on the two caches (32x32 patches
    and class indices): the model, the plateau-rollback loop and its
    checkpoints. Returns the best validation metrics (``loss``, ``acc``,
    ``conf``)."""
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.train import checkpoint as ckpt
    from robocupvision_tpu_torch.train import optim
    from robocupvision_tpu_torch.train.legacy import run_plateau_training
    from robocupvision_tpu_torch.train.loop import Trainer
    from robocupvision_tpu_torch.train.step import StepCfg

    dev = resolve_device(device)
    no_tf32()
    save_fn = load_fn = None
    if opt.hessL or opt.hessMC:
        variant = "MC" if opt.hessMC else "L"
        model = zoo.make("bnn", variant=variant, num_classes=NUM_CLASSES,
                         device=dev)
        save_path = f"pth/bestModelHess{variant}.pth"
    else:
        model = _ComboModel(32, NUM_CLASSES, dev)
        save_path = "pth/bestModelB.pth"  # the head: pth/bestClassB.pth

        # the reference saves encoder and head as two state dicts
        # (classVal.py:201-202), which this layout keeps
        def save_fn(params):
            down, head = model.split_state(params)
            ckpt.save("pth/bestModelB.pth", model.down.registry, down)
            ckpt.save("pth/bestClassB.pth", model.head.registry, head)

        def load_fn() -> Optional[Dict]:
            if not (ckpt.exists("pth/bestModelB.pth")
                    and ckpt.exists("pth/bestClassB.pth")):
                return None
            down = ckpt.load_any("pth/bestModelB.pth", model.down.registry)
            head = ckpt.load_any("pth/bestClassB.pth", model.head.registry)
            return {**{"down." + k: v for k, v in down.items()},
                    **{"head." + k: v for k, v in head.items()}}

    cfg = StepCfg(num_classes=NUM_CLASSES, loss="ce", augment=True,
                  augment_mode="legacy_hflip", jitter=True, out_size=1.0)
    tx = optim.sgd(momentum=0.9, weight_decay=5e-4)
    tr = Trainer(model, tx, cfg, train_cache, val_cache, 64)
    tr.init()
    return run_plateau_training(tr, opt.epochs, 1e-2, save_path,
                                patience=10, factor=0.2, threshold=1e-3,
                                select="acc", save_fn=save_fn,
                                load_fn=load_fn)


def main(argv=None, device: DeviceLike = None) -> int:
    opt = build_parser().parse_args(argv)
    dev = resolve_device(device)

    from robocupvision_tpu_torch.data.datasets import ImageFolder
    from robocupvision_tpu_torch.data.device_cache import DeviceCache

    train_ds = ImageFolder(os.path.join(opt.root, "Classification",
                                        "trainBig"))
    val_ds = ImageFolder(os.path.join(opt.root, "Classification", "test"))
    if len(train_ds) == 0 or len(val_ds) == 0:
        print(f"No classification data under {opt.root}")
        return -1
    train_cache = DeviceCache.from_numpy(*train_ds.load_all(), device=dev)
    val_cache = DeviceCache.from_numpy(*val_ds.load_all(), device=dev)
    best = train_baseline(opt, train_cache, val_cache, dev)
    print("Finished: Best Validation Loss: %.4f Best Validation Acc: %.2f"
          % (best["loss"], best["acc"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
