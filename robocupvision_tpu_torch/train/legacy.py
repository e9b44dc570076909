"""The legacy pipeline's shared loop: plateau-rollback training (the JAX
package's train/legacy.py).

Every legacy entry point (trainer.py:186-312, classTrainer.py:99-190,
labelPropTrain.py:136-316, and classVal/objDetEval) follows one scheme:
SGD with ReduceLROnPlateau, whose callback after each reduction reloads
the best checkpoint (keeping the optimizer state), best-model selection on
the validation loss (or accuracy), and the confusion printed at each new
best. This module holds that scheme once.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from robocupvision_tpu_torch.train import checkpoint
from robocupvision_tpu_torch.train.loop import Trainer
from robocupvision_tpu_torch.train.schedules import ReduceLROnPlateau


def run_plateau_training(
    tr: Trainer,
    epochs: int,
    lr: float,
    save_path: str,
    patience: int,
    factor: float = 0.5,
    threshold: float = 1e-4,
    select: str = "loss",          # "loss" (min val loss) or "acc" (max)
    prune_masks: Optional[Dict[str, np.ndarray]] = None,
    on_best: Optional[Callable[[Dict], None]] = None,
    label: str = "",
    save_fn: Optional[Callable[[Dict], None]] = None,
    load_fn: Optional[Callable[[], Optional[Dict]]] = None,
    plotter=None,
) -> Dict:
    """Runs the epoch loop; returns the best validation metrics dict.

    ``save_fn(params)`` / ``load_fn() -> params | None`` replace the
    single-file checkpoint at ``save_path`` (classVal writes the
    reference's two-file bestModelB/bestClassB layout through them).
    ``plotter``: a ``utils.plotting.LinePlotter``, which gets the train and
    val loss curves, as the reference's Visdom plots did
    (trainer.py:241,299)."""

    def rollback():
        print("Best Model reloaded")
        if load_fn is not None:
            params = load_fn()
            if params is not None:
                tr.set_params(params, reset_opt=False)
        elif checkpoint.exists(save_path):
            tr.set_params(checkpoint.load_any(save_path, tr.model.registry),
                          reset_opt=False)

    sched = ReduceLROnPlateau(lr, "min", factor=factor, patience=patience,
                              threshold=threshold, verbose=True, cb=rollback)
    best = {"loss": float("inf"), "acc": -float("inf")}
    for epoch in range(epochs):
        res = tr.train_epoch(sched.lr, prune_masks=prune_masks)
        print("Epoch [%d] %sTraining Loss: %.4f Training Acc: %.2f"
              % (epoch + 1, label, res.loss, res.pixel_acc))
        val = tr.valid_epoch()
        if plotter is not None:
            plotter.plot("loss", "train", epoch + 1, res.loss)
            plotter.plot("loss", "val", epoch + 1, val["loss"])
        if "pixel_acc" in val:
            print("Epoch [%d] %sValidation Loss: %.4f Validation Pixel Acc: "
                  "%.2f Mean Class Acc: %.2f IoU: %.2f"
                  % (epoch + 1, label, val["loss"], val["pixel_acc"],
                     val["mean_class_acc"], val["mean_iou"]))
        else:
            print("Epoch [%d] %sValidation Loss: %.4f Validation Acc: %.2f"
                  % (epoch + 1, label, val["loss"], val["acc"]))

        is_best = (val["loss"] < best["loss"] if select == "loss"
                   else val.get("acc", val.get("pixel_acc", 0)) > best["acc"])
        if is_best:
            best = {"loss": val["loss"],
                    "acc": val.get("acc", val.get("pixel_acc", 0)), **val}
            if "conf" in val and val["conf"] is not None:
                print(np.array_str(np.asarray(val["conf"]), precision=2,
                                   suppress_small=True))
            if save_fn is not None:
                save_fn(tr.params_numpy())
            else:
                checkpoint.save(save_path, tr.model.registry,
                                tr.params_numpy())
            if on_best is not None:
                on_best(val)
        sched.step(val["loss"])
    return best
