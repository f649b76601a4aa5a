"""Learning-rate schedules of the training step.

Port of ``wav2sleep_tpu/train/scheduler.py``. ``exp_warmup_schedule`` is a
plain function of the optimizer's 0-based update count: a linear warm-up to
``lr_max`` over ``warmup_steps`` updates, then ``exp(-(step - warmup) /
tau)`` decay, evaluated at ``count + 1`` (the reference torch scheduler's
1-based step). ``PlateauController`` is the host-side ReduceLROnPlateau; the
LR scale it returns goes into the optimizer state's ``lr_scale``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable


def exp_warmup_schedule(lr_max: float, warmup_steps: int, tau: float) -> Callable[[int], float]:
    """Linear warm-up then exponential decay, as a function of the 0-based count."""

    def schedule(count: int) -> float:
        step = count + 1
        if step <= warmup_steps:
            return lr_max * step / warmup_steps
        return lr_max * math.exp(-(step - warmup_steps) / tau)

    return schedule


@dataclass
class PlateauController:
    """Host-side ReduceLROnPlateau (mode=min) with torch's defaults of the
    reference config (factor 0.1, patience 2, threshold 1e-5).

    ``min_lr`` floors the effective learning rate (``new_lr = max(old_lr *
    factor, min_lr)``); the controller tracks a multiplicative scale, so the
    floor is ``min_lr / base_lr``: pass the schedule's base LR as ``base_lr``.
    """

    factor: float = 0.1
    patience: int = 2
    threshold: float = 1e-5
    min_lr: float = 0.0
    base_lr: float = 1.0

    best: float = float('inf')
    num_bad_epochs: int = 0
    scale: float = 1.0

    def update(self, metric: float) -> float:
        """Feed the monitored metric; returns the current LR scale."""
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                min_scale = self.min_lr / self.base_lr if self.base_lr > 0 else 0.0
                self.scale = max(self.scale * self.factor, min_scale)
                self.num_bad_epochs = 0
        return self.scale

    def state_dict(self) -> dict:
        return {'best': self.best, 'num_bad_epochs': self.num_bad_epochs, 'scale': self.scale}

    def load_state_dict(self, state: dict) -> None:
        self.best = state['best']
        self.num_bad_epochs = state['num_bad_epochs']
        self.scale = state['scale']
