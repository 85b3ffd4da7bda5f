"""Host-side learning-rate schedulers with the JAX package's semantics
(``equivariant_nn_zoo_tpu/run/lr_scheduler.py``).

They are not ``torch.optim.lr_scheduler``'s: ``ReduceLROnPlateau`` here has
no ``eps`` and no cooldown, and ``CosineAnnealingWarmRestarts`` counts
epochs from its own counter.  The trainer writes the returned rate into the
optimizer's parameter groups.
"""

from __future__ import annotations

import math


class ReduceLROnPlateau:
    """mode 'min', relative threshold."""

    def __init__(self, lr: float, factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = None
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        if self.best is None or metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def get_last_lr(self):
        return [self.lr]

    def state_dict(self):
        return {"lr": self.lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, state):
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]


class CosineAnnealingWarmRestarts:
    def __init__(self, lr: float, T_0: int = 10, T_mult: int = 1,
                 eta_min: float = 0.0):
        self.base_lr = lr
        self.lr = lr
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        self.t = 0

    def step(self, metric: float = None) -> float:
        self.t += 1
        t = self.t
        T = self.T_0
        while t >= T:
            t -= T
            T *= self.T_mult
        self.lr = (self.eta_min + (self.base_lr - self.eta_min)
                   * (1 + math.cos(math.pi * t / T)) / 2)
        return self.lr

    def get_last_lr(self):
        return [self.lr]

    def state_dict(self):
        return {"lr": self.lr, "t": self.t}

    def load_state_dict(self, state):
        self.lr = state["lr"]
        self.t = state["t"]


SCHEDULERS = {
    "ReduceLROnPlateau": ReduceLROnPlateau,
    "CosineAnnealingWarmRestarts": CosineAnnealingWarmRestarts,
    "none": None,
}
