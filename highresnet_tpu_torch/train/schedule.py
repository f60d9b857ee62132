"""Host-side LR scheduling: ReduceLROnPlateau with torch semantics.

A copy of ``highresnet_tpu/train/schedule.py``: importing that module pulls
in ``highresnet_tpu.train``'s package, which imports flax and optax.
Matches torch.optim.lr_scheduler.ReduceLROnPlateau(mode='min', factor,
patience, threshold=1e-4, threshold_mode='rel') as the reference uses it
(src/train.py:154-155): after `patience` epochs without the monitored value
improving past best*(1 - threshold), multiply the LR by `factor`. Runs on
the host between epochs; the loop sets the new LR on the optimizer.
"""

from __future__ import annotations

import math


class ReduceLROnPlateau:
    def __init__(
        self,
        lr: float,
        factor: float = 0.97,
        patience: int = 2,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
        mode: str = "min",
    ):
        assert mode in ("min", "max")
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0

    def _is_better(self, value: float) -> bool:
        # exact torch 'rel' threshold semantics (no sign special-casing;
        # torch uses best*(1 -/+ threshold) regardless of best's sign)
        if self.mode == "min":
            return value < self.best * (1 - self.threshold)
        return value > self.best * (1 + self.threshold)

    def step(self, value: float) -> float:
        """Record this epoch's monitored value; return the (possibly new) LR."""
        if self._is_better(value):
            self.best = value
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self):
        return {
            "lr": self.lr,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
        }

    def load_state_dict(self, state):
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]
