"""Learning-rate schedules, as ``autovc_tpu/train/schedule.py``.

``cosine_annealing`` and ``cosine_decay`` are step -> scale functions that
the train step folds into the learning rate; ``ReduceLROnPlateau`` is
stateful on the loss stream and runs on the host, feeding a scale into the
step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def cosine_annealing(step: int, t_max: int = 10_000, eta_min: float = 0.0, base: float = 1.0) -> float:
    """torch's CosineAnnealingLR in closed form: eta_min + (base - eta_min) *
    (1 + cos(pi * t / T)) / 2, periodic in 2 * T."""
    return eta_min + (base - eta_min) * (1.0 + math.cos(math.pi * step / t_max)) / 2.0


def cosine_decay(step: int, total_steps: int, eta_min_ratio: float = 0.01) -> float:
    """One-shot cosine decay from 1.0 to ``eta_min_ratio`` over
    ``total_steps``, clamped after."""
    t = min(step, total_steps) / max(total_steps, 1)
    return eta_min_ratio + (1.0 - eta_min_ratio) * (1.0 + math.cos(math.pi * t)) / 2.0


@dataclass
class ReduceLROnPlateau:
    """Host-side plateau controller with torch's defaults (mode 'min',
    factor 0.1, patience 10, relative threshold 1e-4)."""

    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    min_lr: float = 0.0
    scale: float = 1.0
    best: float = field(default=float("inf"))
    num_bad: int = 0

    def step(self, metric: float) -> float:
        """Feed the latest loss; returns the current learning-rate scale."""
        if not math.isfinite(metric):
            metric = float("inf")
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_lr)
                self.num_bad = 0
        return self.scale
