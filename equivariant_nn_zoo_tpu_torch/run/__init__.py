"""Training: loss, metrics, learning-rate schedulers and the trainer."""

from .loss import Loss, LossStat, find_loss_function
from .lr_scheduler import SCHEDULERS
from .metrics import Metrics, RunningStats
from .trainer import Trainer

__all__ = ["Loss", "LossStat", "find_loss_function", "SCHEDULERS",
           "Metrics", "RunningStats", "Trainer"]
