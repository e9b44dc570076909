"""Epoch-level LR schedules with the reference's semantics.

The reference vendors early-PyTorch schedulers (lr_scheduler.py) whose one
real modification is ``ReduceLROnPlateau(cb=...)`` — the callback fires after
every LR reduction and every training script uses it to RELOAD THE BEST
CHECKPOINT (trainer.py:186-192 etc.), i.e. plateau-triggered rollback. These
are fresh implementations of the same behavior; LR is a plain float consumed
by the jitted step as a traced scalar (no recompiles).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence


class EpochSchedule:
    """lr(epoch) schedules; epoch counts like the reference's last_epoch."""

    def __init__(self, base_lrs: Sequence[float]):
        self.base_lrs = list(base_lrs)
        self.last_epoch = 0

    def get_lr(self) -> List[float]:
        raise NotImplementedError

    def step(self, epoch: Optional[int] = None) -> List[float]:
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        return self.get_lr()

    @property
    def lr(self) -> float:
        return self.get_lr()[0]


class LambdaLR(EpochSchedule):
    def __init__(self, base_lrs, lr_lambda: Callable[[int], float]):
        super().__init__(base_lrs)
        self.lr_lambda = lr_lambda

    def get_lr(self):
        return [b * self.lr_lambda(self.last_epoch) for b in self.base_lrs]


class StepLR(EpochSchedule):
    def __init__(self, base_lrs, step_size: int, gamma: float = 0.1):
        super().__init__(base_lrs)
        self.step_size, self.gamma = step_size, gamma

    def get_lr(self):
        return [b * self.gamma ** (self.last_epoch // self.step_size)
                for b in self.base_lrs]


class MultiStepLR(EpochSchedule):
    def __init__(self, base_lrs, milestones: Sequence[int], gamma: float = 0.1):
        super().__init__(base_lrs)
        assert list(milestones) == sorted(milestones)
        self.milestones, self.gamma = list(milestones), gamma

    def get_lr(self):
        import bisect

        return [b * self.gamma ** bisect.bisect_right(self.milestones, self.last_epoch)
                for b in self.base_lrs]


class ExponentialLR(EpochSchedule):
    def __init__(self, base_lrs, gamma: float):
        super().__init__(base_lrs)
        self.gamma = gamma

    def get_lr(self):
        return [b * self.gamma ** self.last_epoch for b in self.base_lrs]


class CosineAnnealingLR(EpochSchedule):
    def __init__(self, base_lrs, t_max: int, eta_min: float = 0.0):
        super().__init__(base_lrs)
        self.t_max, self.eta_min = t_max, eta_min

    def get_lr(self):
        return [self.eta_min + (b - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.t_max)) / 2
                for b in self.base_lrs]


class ReduceLROnPlateau:
    """Plateau LR reduction with post-reduction callback (rollback hook).

    Semantics of reference lr_scheduler.py:213-364: patience counting,
    rel/abs threshold modes, cooldown, per-group min_lr, eps-gated updates,
    cb() fired after each reduction.
    """

    def __init__(self, lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 min_lr: float = 0.0, eps: float = 1e-8, verbose: bool = False,
                 cb: Optional[Callable[[], None]] = None):
        assert factor < 1.0 and mode in ("min", "max") \
            and threshold_mode in ("rel", "abs")
        self.current_lr = lr
        self.mode, self.factor = mode, factor
        self.patience, self.threshold = patience, threshold
        self.threshold_mode, self.cooldown = threshold_mode, cooldown
        self.min_lr, self.eps, self.verbose, self.cb = min_lr, eps, verbose, cb
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.last_epoch = -1

    def _is_better(self, a: float, best: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < best * (1.0 - self.threshold)
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def step(self, metric: float) -> float:
        self.last_epoch += 1
        if self._is_better(metric, self.best):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.current_lr * self.factor, self.min_lr)
            if self.current_lr - new_lr > self.eps:
                self.current_lr = new_lr
                if self.verbose:
                    print(f"Epoch {self.last_epoch}: reducing learning rate to "
                          f"{new_lr:.4e}.")
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
            if self.cb is not None:
                self.cb()
        return self.current_lr

    @property
    def lr(self) -> float:
        return self.current_lr
