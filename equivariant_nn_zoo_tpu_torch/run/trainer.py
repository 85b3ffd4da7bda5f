"""Trainer — the core of the supervised training engine.

PyTorch counterpart of the core of ``equivariant_nn_zoo_tpu/run/trainer.py``:
the optimizer (Adam with optax's defaults, optionally after a clip to a
global gradient norm), the exponential moving average of the parameters,
the loss and its running statistics, the metrics, one step per batch and
an epoch over given iterables of ``GraphBatch``es (training, then
validation with the EMA parameters, then the plateau scheduler on the
validation loss).

One step is eager PyTorch: forward, the masked loss, ``backward`` (through
the convolution's and self-connection's CUDA kernels on the card),
``optimizer.step`` and the EMA update.  With a force head
(``GradientOutput``, ``config_energy_force``) the forward already takes the
energy's gradient with ``create_graph``, so ``backward`` differentiates a
second time through every convolution; validation runs under
``torch.no_grad()``, where the head still computes forces.  Datasets and
loaders, checkpoints and resume, early stopping, the equivariance test,
profiling, logging to wandb, gradient accumulation and multi-device runs
are not ported yet.
"""

from __future__ import annotations

import copy
import logging
from time import perf_counter
from typing import Iterable, Optional

import torch

from ..data.graph_batch import GraphBatch
from .loss import Loss, LossStat
from .lr_scheduler import SCHEDULERS
from .metrics import Metrics

# optax.adam's keyword names and defaults -> torch.optim.Adam's
ADAM_DEFAULTS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}


def _prefixed(prefix: str, kwargs: dict) -> dict:
    """``{name: value}`` of the ``<prefix>_<name>`` entries of kwargs."""
    head = prefix + "_"
    return {k[len(head):]: v for k, v in kwargs.items() if k.startswith(head)}


def ema_decay(decay: float, num_updates: int, use_num_updates: bool) -> float:
    """The decay of update number ``num_updates`` (counted from 1):
    ``min(decay, (1 + n) / (10 + n))`` with ``use_num_updates``."""
    if use_num_updates:
        return min(decay, (1.0 + num_updates) / (10.0 + num_updates))
    return decay


class Trainer:
    def __init__(
        self,
        model: torch.nn.Module,
        loss_coeffs,
        metrics_components=None,
        metric_key: str = "validation_loss",
        learning_rate: float = 1e-2,
        lr_scheduler_name: str = "none",
        optimizer_name: str = "Adam",
        max_gradient_norm: Optional[float] = float("inf"),
        use_ema: bool = False,
        ema_decay: float = 0.999,
        ema_use_num_updates: bool = True,
        **kwargs,
    ):
        self.model = model
        self.metrics_components = metrics_components
        self.metric_key = metric_key
        self.learning_rate = learning_rate
        self.lr_scheduler_name = lr_scheduler_name
        self.optimizer_name = optimizer_name
        self.max_gradient_norm = (float(max_gradient_norm)
                                  if max_gradient_norm is not None
                                  else float("inf"))
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self.ema_use_num_updates = ema_use_num_updates
        self.kwargs = dict(kwargs)
        self.logger = logging.getLogger(__name__)
        self.iepoch = 0
        self.loss = Loss(loss_coeffs)
        self.loss_stat = LossStat(self.loss)
        self.train_on_keys = self.loss.keys
        self.init_objects()
        self.init_metrics()

    # ------------------------------------------------------------- objects

    def init_objects(self):
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.num_weights = sum(p.numel() for p in self.params)
        self.logger.info(f"Number of weights: {self.num_weights}")

        if self.optimizer_name != "Adam":
            raise NotImplementedError(
                f"optimizer {self.optimizer_name!r}: the port has Adam only")
        opt = dict(ADAM_DEFAULTS)
        for key, value in _prefixed("optimizer", self.kwargs).items():
            if key == "name":
                continue
            if key not in opt:
                raise ValueError(f"optimizer_{key}: Adam takes "
                                 f"{sorted(opt)}")
            opt[key] = value
        self.optimizer = torch.optim.Adam(
            self.params, lr=self.learning_rate,
            betas=(opt["b1"], opt["b2"]), eps=opt["eps"])

        if self.lr_scheduler_name not in SCHEDULERS:
            raise ValueError(f"lr_scheduler_name {self.lr_scheduler_name!r}")
        self.lr_sched = None
        if SCHEDULERS[self.lr_scheduler_name] is not None:
            sched = _prefixed("lr_scheduler", self.kwargs)
            sched.pop("name", None)
            self.lr_sched = SCHEDULERS[self.lr_scheduler_name](
                lr=self.learning_rate, **sched)

        # the EMA parameters are a copy, never an alias of the live ones
        self.ema_model = None
        self.ema_num_updates = 0
        if self.use_ema:
            self.ema_model = copy.deepcopy(self.model)
            self.ema_model.requires_grad_(False)
            self.ema_params = [p for p in self.ema_model.parameters()]

    def init_metrics(self):
        if self.metrics_components is None:
            self.metrics_components = []
            for key, func in self.loss.funcs.items():
                params = {"PerSpecies": type(func).__name__.lower()
                          .startswith("perspecies")}
                self.metrics_components.append((key, "mae", params))
                self.metrics_components.append((key, "rmse", params))
        self.metrics = Metrics(components=self.metrics_components)
        if not self.metric_key.lower().startswith(("validation", "training")):
            raise RuntimeError(
                "metric_key should start with either validation or training")

    # ------------------------------------------------------------ stepping

    def apply_gradients(self):
        """Clip (optax's ``clip_by_global_norm``), take the Adam step on
        the gradients in ``.grad`` and update the EMA."""
        if self.max_gradient_norm < float("inf"):
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < self.max_gradient_norm,
                                torch.ones_like(norm),
                                self.max_gradient_norm / norm)
            for g in grads:
                g.mul_(scale)
        self.optimizer.step()
        if self.use_ema:
            self.ema_num_updates += 1
            d = ema_decay(self.ema_decay, self.ema_num_updates,
                          self.ema_use_num_updates)
            with torch.no_grad():
                for e, p in zip(self.ema_params, self.model.parameters()):
                    e.mul_(d).add_(p, alpha=1.0 - d)

    def batch_step(self, data: GraphBatch, validation: bool = False):
        """One training step on ``data``, or with ``validation`` one
        evaluation with the EMA parameters (the live ones without EMA)."""
        if validation:
            model = self.ema_model if self.use_ema else self.model
            with torch.no_grad():
                out = model(data)
                loss, contrib = self.loss(out.data, data.data)
        else:
            self.optimizer.zero_grad(set_to_none=True)
            out = self.model(data)
            loss, contrib = self.loss(out.data, data.data)
            loss.backward()
            self.apply_gradients()
        self.batch_losses = self.loss_stat(
            loss.detach(), {k: v.detach() for k, v in contrib.items()})
        self.batch_metrics = self.metrics(out.data, data.data)

    def epoch_step(self, training: Iterable[GraphBatch],
                   validation: Iterable[GraphBatch]):
        """Train over ``training``, evaluate over ``validation``, then step
        the learning-rate scheduler on ``metric_key``."""
        if not hasattr(self, "wall"):
            self.wall = perf_counter()
        self.metrics_dict = {}
        self.loss_dict = {}
        for category, batches in (("training", training),
                                  ("validation", validation)):
            self.reset_metrics()
            for self.ibatch, batch in enumerate(batches):
                self.batch_step(batch, validation=category == "validation")
            self.metrics_dict[category] = self.metrics.current_result()
            self.loss_dict[category] = self.loss_stat.current_result()
        self.end_of_epoch_log()
        if self.lr_sched is not None:
            self._set_lr(self.lr_sched.step(self.mae_dict[self.metric_key]))
        self.iepoch += 1

    def reset_metrics(self):
        self.loss_stat.reset()
        self.metrics.reset()

    def _set_lr(self, lr: float):
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    @property
    def current_lr(self) -> float:
        if self.lr_sched is not None:
            return self.lr_sched.get_last_lr()[0]
        return self.learning_rate

    # -------------------------------------------------------------- logging

    def end_of_epoch_log(self):
        """Fill ``mae_dict`` (``LR``, ``epoch``, ``wall`` and
        ``<category>_<loss or metric>``) and log one line per category."""
        lr = self.current_lr
        wall = perf_counter() - self.wall
        self.mae_dict = dict(LR=lr, epoch=self.iepoch, wall=wall)
        for category in ("training", "validation"):
            met, _ = self.metrics.flatten_metrics(self.metrics_dict[category])
            line = f"{self.iepoch:10d} {wall:8.3f} {lr:8.3g}"
            for key, value in list(self.loss_dict[category].items()) + \
                    list(met.items()):
                line += f" {value:12.3g}"
                self.mae_dict[f"{category}_{key}"] = value
            self.logger.info(f"! {category.capitalize():10s} {line}")
