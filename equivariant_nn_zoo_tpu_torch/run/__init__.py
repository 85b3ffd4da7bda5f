"""Training: loss, metrics, learning-rate schedulers, early stopping and
the trainer."""

from .early_stopping import EarlyStopping
from .loss import Loss, LossStat, find_loss_function
from .lr_scheduler import SCHEDULERS
from .metrics import Metrics, RunningStats
from .trainer import OPTIMIZERS, Trainer, TrainerWandB

__all__ = ["EarlyStopping", "Loss", "LossStat", "find_loss_function",
           "SCHEDULERS", "Metrics", "RunningStats", "OPTIMIZERS", "Trainer",
           "TrainerWandB"]
