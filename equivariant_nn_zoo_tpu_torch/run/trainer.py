"""Trainer — the supervised training engine.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/run/trainer.py``: it owns
the model, the optimizer (``OPTIMIZERS``: Adam, AdamW, SGD and RMSprop
with optax's semantics and defaults, after an optional clip to a global
gradient norm), the exponential moving average of the parameters, the
learning-rate scheduler, the loss and metrics, early stopping, gradient
accumulation, the datasets and loaders (``set_dataset``), the epoch loop
with subdivision (``train``, ``epoch_step``), the equivariance-test hook,
parameter and gradient histograms (``watch_stats``), profiling, and
best / last / trainer checkpoints written atomically, with a resume
(``from_file``) that restores every state, random streams included.

One step is eager PyTorch: forward, the masked loss, ``backward`` (through
the convolution's and self-connection's CUDA kernels on the card), the
optimizer's step and the EMA update.  Batches come from the loader as host
batches in pinned memory and are copied to the card one batch ahead on a
side CUDA stream (``_device_prefetch``).

Checkpoints are pickles of nested dicts of numpy arrays: the parameters
under the JAX parameter tree's names (``utils.params``), so ``best.pt`` and
``last.pt`` load into either package; ``trainer.pt`` holds the optimizer's
state and the random streams as numpy too and unpickles without JAX.

A trainer built without ``workdir`` writes no file, and ``epoch_step``
also takes given iterables of batches (already on the model's device):
one pass over each, without subdivision.  The second positional argument
is ``loss_coeffs``; every other argument is a keyword of the JAX
trainer's signature.  Multi-device runs and logging to wandb are not
ported yet.
"""

from __future__ import annotations

import copy
import logging
import math
import os
from copy import deepcopy
from time import perf_counter
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..data.dataloader import DataLoader, estimate_capacities
from ..data.dataset import CondensedDataset
from ..ops.irreps import Irreps
from ..ops.wigner import irreps_d
from ..utils.params import load_jax_params, params_to_jax
from ..utils.saveload import (
    _numpyify,
    atomic_write_group,
    finish_all_writes,
    load_file,
    save_file,
)
from ..utils.utils import pruneArgs
from .early_stopping import EarlyStopping
from .loss import Loss, LossStat
from .lr_scheduler import SCHEDULERS
from .metrics import Metrics

# optax.adam's keyword names and defaults -> torch.optim.Adam's
ADAM_DEFAULTS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}


def _optax_only(**options):
    for key, value in options.items():
        if value:
            raise NotImplementedError(f"the port's optimizers take no "
                                      f"{key}={value!r}")


def adam(params, learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
         mu_dtype=None, nesterov=False):
    """``optax.adam``: mu / (sqrt(nu) + eps) with bias corrections."""
    _optax_only(eps_root=eps_root, mu_dtype=mu_dtype, nesterov=nesterov)
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2),
                            eps=eps)


def adamw(params, learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
          mu_dtype=None, weight_decay=1e-4, mask=None, nesterov=False):
    """``optax.adamw``: Adam's update plus ``weight_decay * param``, both
    scaled by the learning rate (optax's default decay 1e-4, not
    ``torch.optim.AdamW``'s 1e-2)."""
    _optax_only(eps_root=eps_root, mu_dtype=mu_dtype, mask=mask,
                nesterov=nesterov)
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)


def sgd(params, learning_rate, momentum=None, nesterov=False,
        accumulator_dtype=None):
    """``optax.sgd``: with ``momentum``, optax's trace t = g + momentum * t
    (``nesterov``: the update g + momentum * t) before the rate."""
    _optax_only(accumulator_dtype=accumulator_dtype)
    if momentum is None:
        return torch.optim.SGD(params, lr=learning_rate)
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           nesterov=nesterov)


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop`` with its defaults: nu = decay nu + (1 - decay) g^2
    from ``initial_scale``; the update g / sqrt(nu + eps) (``eps_in_sqrt``;
    else g / (sqrt(nu) + eps)), centered on the running mean with
    ``centered``, bias-corrected with ``bias_correction``; then the rate,
    then optax's trace with ``momentum`` (so the trace holds rate-scaled
    updates).  Not ``torch.optim.RMSprop``, whose g / (sqrt(v) + eps) with
    alpha 0.99 is another update.  ``_foreach`` over each group."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8, initial_scale=0.0,
                 eps_in_sqrt=True, centered=False, momentum=None,
                 nesterov=False, bias_correction=False):
        super().__init__(params, dict(
            lr=lr, decay=decay, eps=eps, initial_scale=initial_scale,
            eps_in_sqrt=eps_in_sqrt, centered=centered, momentum=momentum,
            nesterov=nesterov, bias_correction=bias_correction))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            decay, eps = group["decay"], group["eps"]
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["nu"] = torch.full_like(p, group["initial_scale"])
                    if group["centered"]:
                        st["mu"] = torch.zeros_like(p)
                    if group["momentum"] is not None:
                        st["trace"] = torch.zeros_like(p)
                    st["count"] = torch.zeros((), dtype=torch.float32)
            nu = [st["nu"] for st in states]
            torch._foreach_mul_(nu, decay)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - decay)
            nu_hat = nu
            if group["centered"]:
                mu = [st["mu"] for st in states]
                torch._foreach_mul_(mu, decay)
                torch._foreach_add_(mu, grads, alpha=1.0 - decay)
                mu_hat = mu
            if group["bias_correction"]:
                for st in states:
                    st["count"] += 1
                count = float(states[0]["count"])
                nu_hat = torch._foreach_div(nu, 1.0 - decay ** count)
                if group["centered"]:
                    mu_hat = torch._foreach_div(mu, 1.0 - decay ** count)
            if group["centered"]:
                nu_hat = torch._foreach_addcmul(nu_hat, mu_hat, mu_hat,
                                                value=-1.0)
            if group["eps_in_sqrt"]:
                denom = torch._foreach_add(nu_hat, eps)
                torch._foreach_sqrt_(denom)
            else:
                denom = torch._foreach_sqrt(nu_hat)
                torch._foreach_add_(denom, eps)
            update = torch._foreach_div(grads, denom)
            torch._foreach_mul_(update, -group["lr"])
            if group["momentum"] is not None:
                trace = [st["trace"] for st in states]
                torch._foreach_mul_(trace, group["momentum"])
                torch._foreach_add_(trace, update)
                if group["nesterov"]:
                    torch._foreach_add_(update, trace,
                                        alpha=group["momentum"])
                else:
                    update = trace
            torch._foreach_add_(params, update)


def rmsprop(params, learning_rate, **kwargs):
    return RMSprop(params, learning_rate, **kwargs)


OPTIMIZERS = {"Adam": adam, "AdamW": adamw, "SGD": sgd, "RMSprop": rmsprop}

# kernel families of a profile (profiling.txt), first match wins
PROFILE_FAMILIES = (
    ("conv walks (K1, K2, K4)", r"k1_walk|k2_walk|ext_|walk_|mlp_hidden"),
    ("species tables (K3, K3b)", r"species_sc|table_product|table_grad"),
    ("mix GEMM (row_mix)", r"rowmix::|gemm_kernel<"),
    ("hamiltonian head (K5, K6)", r"pairwise_|uvu_"),
    ("other", "."),
)


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


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _tensors(tree):
    """numpy arrays back to tensors, through dicts and lists."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return tree


_LOG_FILES = {}


def _workdir_logger(workdir):
    """A logger of its own for each workdir (a child of this module's),
    writing INFO and up to ``<workdir>/log.txt``; it propagates, so the
    application's handlers see the records too."""
    path = os.path.realpath(os.path.join(workdir, "log.txt"))
    if path not in _LOG_FILES:
        logger = logging.getLogger(__name__).getChild(
            f"workdir{len(_LOG_FILES)}")
        handler = logging.FileHandler(path)
        handler.setFormatter(logging.Formatter(
            "%(levelname)s - %(filename)s - %(asctime)s - %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        _LOG_FILES[path] = logger
    return _LOG_FILES[path]


class Trainer:
    def __init__(
        self,
        model: torch.nn.Module,
        loss_coeffs=None,
        metrics_components=None,
        metric_key: str = "validation_loss",
        learning_rate: float = 1e-2,
        lr_scheduler_name: str = "none",
        optimizer_name: str = "Adam",
        max_gradient_norm: Optional[float] = float("inf"),
        use_ema: bool = False,
        ema_decay: float = 0.999,
        ema_use_num_updates: bool = True,
        data_config: Optional[dict] = None,
        workdir: Optional[str] = None,
        seed: int = 0,
        train_on_keys: Optional[List[str]] = None,
        early_stopping_conds: Optional[EarlyStopping] = None,
        max_epochs: int = 1000000,
        batch_size: int = 5,
        grad_acc: int = 1,
        train_idcs=None,
        val_idcs=None,
        epoch_subdivision: int = 1,
        equivariance_test: bool = False,
        profiling: bool = False,
        log_period: int = 50,
        save_period: int = 1,
        watch_freq: int = 0,
        **kwargs,
    ):
        for key in (
            "data_config workdir seed loss_coeffs metrics_components "
            "metric_key max_epochs learning_rate lr_scheduler_name "
            "optimizer_name use_ema ema_decay ema_use_num_updates "
            "batch_size train_idcs val_idcs epoch_subdivision "
            "equivariance_test profiling log_period save_period watch_freq"
        ).split():
            setattr(self, key, locals()[key])
        self.max_gradient_norm = (float(max_gradient_norm)
                                  if max_gradient_norm is not None
                                  else float("inf"))
        self.grad_acc = max(1, int(grad_acc or 1))
        self.model = model
        self.device = next(model.parameters()).device
        self.logger = logging.getLogger(__name__)
        self.last_model_path = self.best_model_path = None
        self.trainer_save_path = None
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            self.last_model_path = os.path.join(workdir, "last.pt")
            self.best_model_path = os.path.join(workdir, "best.pt")
            self.trainer_save_path = os.path.join(workdir, "trainer.pt")
            self.logger = _workdir_logger(workdir)

        # random streams, all checkpointed for an exact resume
        self.split_rng = np.random.default_rng(seed)
        self.loader_rng_seed = seed

        self.kwargs = deepcopy(kwargs)
        self.best_metrics = float("inf")
        self.best_epoch = 0
        self.iepoch = 0
        self.dl_train = self.dl_val = None
        self._loader_state = None
        self._acc_count = 0
        self._copy_stream = None

        self.loss = Loss(loss_coeffs)
        self.loss_stat = LossStat(self.loss)
        self.train_on_keys = self.loss.keys
        self.early_stopping_conds = early_stopping_conds
        self.init_objects()
        self.init_metrics()

    # ------------------------------------------------------------- objects

    def init_objects(self):
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.num_weights = sum(p.numel() for p in self.params)
        self.logger.info(f"Number of weights: {self.num_weights}")

        if self.optimizer_name not in OPTIMIZERS:
            raise ValueError(f"optimizer_name {self.optimizer_name!r}: the "
                             f"port has {sorted(OPTIMIZERS)}")
        opt_kwargs = _prefixed("optimizer", self.kwargs)
        opt_kwargs.pop("name", None)
        self.optimizer = OPTIMIZERS[self.optimizer_name](
            self.params, self.learning_rate, **opt_kwargs)

        if self.lr_scheduler_name not in SCHEDULERS:
            raise ValueError(f"lr_scheduler_name {self.lr_scheduler_name!r}")
        self.lr_sched = None
        if SCHEDULERS[self.lr_scheduler_name] is not None:
            sched = _prefixed("lr_scheduler", self.kwargs)
            sched.pop("name", None)
            self.lr_sched = SCHEDULERS[self.lr_scheduler_name](
                lr=self.learning_rate, **sched)

        # early stopping watches validation_* unless a key names its
        # category (or is LR or wall, which go unprefixed)
        es_kwargs = _prefixed("early_stopping", self.kwargs)
        n_args = 0
        for key, item in list(es_kwargs.items()):
            if hasattr(item, "items"):
                new_dict = {}
                for k, v in item.items():
                    if k.lower().startswith(("validation", "training")) or \
                            k.lower() in ("lr", "wall"):
                        new_dict[k] = v
                    else:
                        new_dict[f"validation_{k}"] = v
                es_kwargs[key] = new_dict
                n_args += len(new_dict)
        if self.early_stopping_conds is None and n_args > 0:
            self.early_stopping_conds = EarlyStopping(**es_kwargs)

        # the EMA parameters are a copy, never an alias of the live ones
        self.ema_model = None
        self.ema_num_updates = 0
        if self.use_ema:
            self.ema_model = copy.deepcopy(self.model)
            self.ema_model.requires_grad_(False)
            self.ema_params = list(self.ema_model.parameters())
            self.live_params = list(self.model.parameters())

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

    def _grads(self):
        return [p.grad for p in self.params if p.grad is not None]

    def apply_gradients(self):
        """Clip (optax's ``clip_by_global_norm``), take the optimizer's
        step on the gradients in ``.grad`` and update the EMA."""
        if self.max_gradient_norm < float("inf"):
            grads = self._grads()
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.max_gradient_norm,
                                torch.ones_like(norm),
                                self.max_gradient_norm / norm)
            torch._foreach_mul_(grads, scale)
        self.optimizer.step()
        if self.use_ema:
            self.ema_num_updates += 1
            d = ema_decay(self.ema_decay, self.ema_num_updates,
                          self.ema_use_num_updates)
            with torch.no_grad():
                torch._foreach_mul_(self.ema_params, d)
                torch._foreach_add_(self.ema_params, self.live_params,
                                    alpha=1.0 - d)

    def batch_step(self, data, validation: bool = False):
        """One training step on ``data``, or with ``validation`` one
        evaluation with the EMA parameters (the live ones without EMA).
        With ``grad_acc`` K > 1 the gradients of K batches are summed in
        ``.grad`` and every K-th batch applies their mean (the EMA moves
        only then)."""
        if validation:
            model = self.ema_model if self.use_ema else self.model
            with torch.no_grad():
                out = model(data)
                loss, contrib = self.loss(out.data, data.data)
        else:
            if self._acc_count == 0:
                self.optimizer.zero_grad(set_to_none=True)
            out = self.model(data)
            loss, contrib = self.loss(out.data, data.data)
            loss.backward()
            self._acc_count += 1
            if self._acc_count >= self.grad_acc:
                if self.grad_acc > 1:
                    torch._foreach_div_(self._grads(), float(self.grad_acc))
                    self.apply_gradients()
                else:
                    self._step_with_watch()
                self._acc_count = 0
        if self.equivariance_test:
            self.equivarianceTest(out.data, data)
        self.batch_losses = self.loss_stat(
            loss.detach(), {k: v.detach() for k, v in contrib.items()})
        self.batch_metrics = self.metrics(out.data, data.data)

    def _step_with_watch(self):
        grads = None
        if self.watch_freq:
            self._watch_count = getattr(self, "_watch_count", 0) + 1
            if self._watch_count % self.watch_freq == 0:
                grads = {n: p.grad.detach().clone()
                         for n, p in self.model.named_parameters()
                         if p.grad is not None}
        self.apply_gradients()
        if grads is not None:
            self.watch_log(grads)

    # ---------------------------------------------------------- watch hook

    def watch_stats(self, grads):
        """Per-tensor parameter and gradient norms and histograms, the
        ``wandb.watch(model)`` equivalent: ``parameters/<name>`` and
        ``gradients/<name>`` map to ``(counts, bin_edges)`` numpy
        histograms, ``*_norm`` to floats."""
        stats = {}

        def add(prefix, named):
            for name, leaf in named:
                arr = _numpy(leaf).astype(np.float32).ravel()
                if arr.size == 0:
                    continue
                stats[f"{prefix}/{name}_norm"] = float(np.linalg.norm(arr))
                stats[f"{prefix}/{name}"] = np.histogram(arr, bins=64)

        add("parameters", self.model.named_parameters())
        if grads:
            add("gradients", grads.items())
        return stats

    def watch_log(self, grads):
        """Called every ``watch_freq`` training steps with that step's
        gradients (before the clip); records ``watch_dict``."""
        self.watch_dict = self.watch_stats(grads)

    # ------------------------------------------------- equivariance testing

    def equivarianceTest(self, out, batch):
        """Check that Wigner-rotated outputs have ~zero spread across a
        batch of rotated copies (``CondensedDataset.equivarianceTest``)."""
        if "_rotation_matrix" not in batch.data:
            return
        mats = _numpy(batch["_rotation_matrix"]).reshape(-1, 3, 3)
        g = int(_numpy(batch["_graph_mask"]).sum())
        mats = mats[:g]
        for key, value in out.items():
            if key not in batch.attrs or not isinstance(value, torch.Tensor):
                continue
            is_per, transform = batch.attrs[key]
            if not isinstance(transform, (str, Irreps)) or (
                    isinstance(transform, str) and str(transform).isdigit()):
                continue
            irreps = Irreps(transform)
            value = _numpy(value)
            if is_per == "graph":
                rows = value[:g].reshape(g, -1, irreps.dim)
            elif is_per == "node":
                # the spread across copies means something only when every
                # graph is a rotated copy with the same node count
                seg = _numpy(batch["_node_segment"]).reshape(-1)
                counts = np.bincount(seg, minlength=g + 1)[:g]
                if g == 0 or not np.all(counts == counts[0]):
                    self.logger.info(
                        f"equivariance test skipped for {key}: node counts "
                        f"differ across graphs (needs rotated copies)")
                    continue
                rows = np.stack([value[seg == i] for i in range(g)]).reshape(
                    g, int(counts[0]), irreps.dim)
            else:
                continue
            unrot = np.stack([rows[i] @ irreps_d(irreps, mats[i].T).T
                              for i in range(g)])
            old_std = rows.std(0).max()
            std = unrot.std(0).max()
            if old_std < 1e-3:
                self.logger.info(f"{key} too small to perform equivariance "
                                 f"test")
            elif std < 1e-3:
                self.logger.info(f"equivariance test succeeded for {key}")
            else:
                self.logger.warning(
                    f"equivariance test failed for {key} (std {std:.2e})")

    # ----------------------------------------------------------- datasets

    def set_dataset(self, dataset, validation_dataset=None):
        """Split (``split_rng``), select, estimate the capacities and build
        the loaders (host batches, pinned when the model is on the card)."""
        data_config = self.data_config
        n_train = data_config["n_train"]
        n_val = data_config["n_val"]
        if self.train_idcs is None or self.val_idcs is None:
            split = data_config.get("train_val_split", "random")
            if validation_dataset is None:
                total_n = len(dataset)
                if isinstance(n_train, float):
                    n_train = int(n_train * total_n)
                if isinstance(n_val, float):
                    n_val = int(n_val * total_n)
                if (n_train + n_val) > total_n:
                    raise ValueError(
                        "too little data for training and validation. "
                        "please reduce n_train and n_val")
                if split == "random":
                    idcs = self.split_rng.permutation(total_n)
                elif split == "sequential":
                    idcs = np.arange(total_n)
                else:
                    raise NotImplementedError(f"split mode {split}")
                self.train_idcs = idcs[:n_train]
                self.val_idcs = idcs[n_train: n_train + n_val]
            elif split == "random":
                self.train_idcs = self.split_rng.permutation(
                    len(dataset))[:n_train]
                self.val_idcs = self.split_rng.permutation(
                    len(validation_dataset))[:n_val]
            else:
                self.train_idcs = np.arange(n_train)
                self.val_idcs = np.arange(n_val)
        if validation_dataset is None:
            validation_dataset = dataset
        self.dataset_train = dataset.index_select(self.train_idcs)
        self.dataset_val = validation_dataset.index_select(self.val_idcs)

        node_cap, edge_cap = estimate_capacities(self.dataset_train,
                                                 self.batch_size)
        node_cap = data_config.get("node_capacity") or node_cap
        edge_cap = data_config.get("edge_capacity") or edge_cap
        dl_kwargs = dict(
            batch_size=self.batch_size, node_capacity=node_cap,
            edge_capacity=edge_cap, drop_last=True,
            seed=self.loader_rng_seed,
            num_workers=data_config.get("num_workers", 0),
            pin_memory=self.device.type == "cuda")
        for dl in (self.dl_train, self.dl_val):
            if dl is not None:
                dl.close()
        self.dl_train = DataLoader(
            self.dataset_train, shuffle=data_config.get("shuffle", True),
            **dl_kwargs)
        self.dl_val = DataLoader(self.dataset_val, shuffle=False, **dl_kwargs)
        # the loader's shuffle stream continues on resume
        if self._loader_state is not None:
            self.dl_train.load_state_dict(self._loader_state)
            self._loader_state = None

    # ------------------------------------------------------------- training

    def train(self):
        if self.dl_train is None:
            raise RuntimeError(
                "You must call `set_dataset()` before calling `train()`")
        self.init_log()
        self.wall = perf_counter()
        self.init_metrics()
        while not self.stop_cond:
            self.epoch_step()
            self.end_of_epoch_save()
        self.final_log()
        self.save()
        finish_all_writes()

    @property
    def stop_cond(self):
        if self.early_stopping_conds is not None and hasattr(self,
                                                             "mae_dict"):
            early_stop, early_stop_args, debug_args = \
                self.early_stopping_conds(self.mae_dict)
            if debug_args is not None:
                self.logger.debug(debug_args)
            if early_stop:
                self.stop_arg = early_stop_args
                return True
        if self.iepoch >= self.max_epochs:
            self.stop_arg = "max epochs"
            return True
        return False

    def reset_metrics(self):
        self.loss_stat.reset()
        self.metrics.reset()

    def _device_prefetch(self, it):
        """The loader's host batches on the model's device, one batch
        ahead.  On the card each pinned host batch is copied on a side
        CUDA stream while the step before it runs; the compute stream
        waits on that copy's event before it uses the batch, and
        ``record_stream`` tells the allocator that the compute stream uses
        the copies.  Everything runs on the calling thread."""
        if self.device.type != "cuda":
            yield from (b.to(self.device) for b in it)
            return
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        side = self._copy_stream
        main = torch.cuda.current_stream(self.device)

        def copy_ahead(host):
            with torch.cuda.stream(side):
                return host.to(self.device, non_blocking=True), \
                    side.record_event()

        def ready(dev, event):
            main.wait_event(event)
            for v in dev.data.values():
                v.record_stream(main)
            return dev

        pending = None
        for host in it:
            nxt = copy_ahead(host)
            if pending is not None:
                yield ready(*pending)
            pending = nxt
        if pending is not None:
            yield ready(*pending)

    def _run_category(self, category, iterable, n_batches, start=0):
        validation = category == "validation"
        self.reset_metrics()
        self.n_batches = n_batches
        for self.ibatch, batch in enumerate(iterable, start):
            self.batch_step(batch, validation=validation)
            if (self.ibatch + 1) % self.log_period == 0 or \
                    self.ibatch + 1 == n_batches:
                self.end_of_batch_log(batch_type=category)
        self.metrics_dict[category] = self.metrics.current_result()
        self.loss_dict[category] = self.loss_stat.current_result()

    def _end_of_division(self):
        self.end_of_epoch_log()
        if self.lr_sched is not None:
            self._set_lr(self.lr_sched.step(self.mae_dict[self.metric_key]))

    def epoch_step(self, training: Iterable = None,
                   validation: Iterable = None):
        """One epoch over the loaders of ``set_dataset``: ``epoch_subdivision``
        parts, each a share of the training batches, then of the
        validation batches, then a log line and the scheduler's step on
        ``metric_key``; with ``profiling`` the training batches run under
        ``torch.profiler``.  Given ``training`` and ``validation``
        iterables, one pass over each instead."""
        if not hasattr(self, "wall"):
            self.wall = perf_counter()
        if training is not None:
            self.metrics_dict, self.loss_dict = {}, {}
            for category, batches in (("training", training),
                                      ("validation", validation)):
                batches = list(batches)
                self._run_category(category, batches, len(batches))
            self._end_of_division()
            self.iepoch += 1
            return

        loaders = {"training": self.dl_train, "validation": self.dl_val}
        iterables = {k: self._device_prefetch(iter(dl))
                     for k, dl in loaders.items()}
        for idivision in range(self.epoch_subdivision):
            self.metrics_dict, self.loss_dict = {}, {}
            for category, dl in loaders.items():
                split_size = max(len(dl) // self.epoch_subdivision, 1)
                start = idivision * split_size
                stop = min((idivision + 1) * split_size, len(dl))
                part = (next(iterables[category], None)
                        for _ in range(start, stop))
                part = (b for b in part if b is not None)
                profiling = category == "training" and self.profiling
                prof = self._start_profile() if profiling else None
                self._run_category(category, part, len(dl), start)
                if prof is not None:
                    self._write_profiling_summary(prof)
            self._end_of_division()
        for it in iterables.values():  # an unused tail closes the pipeline
            it.close()
        self.iepoch += 1

        if self.data_config.get("reload", False):
            dataset = CondensedDataset(
                **pruneArgs(CondensedDataset, **dict(self.data_config)))
            self.set_dataset(dataset, validation_dataset=None)

    # ----------------------------------------------------------- profiling

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _write_profiling_summary(self, prof):
        """Stop ``prof``; write its kernel table to ``profiling.txt`` (device
        ms by kernel name and by family of ``PROFILE_FAMILIES``; on the
        CPU, host ms by operator) and the raw trace to
        ``<workdir>/profile/trace.json``."""
        import re

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        if not self.workdir:
            return
        rows = []
        for e in prof.key_averages():
            on_card = str(e.device_type).endswith("CUDA")
            if self.device.type == "cuda" and not on_card:
                continue
            us = (getattr(e, "self_device_time_total", 0) if on_card
                  else e.self_cpu_time_total)
            rows.append((us / 1e3, e.count, e.key))
        rows.sort(reverse=True)
        total = sum(r[0] for r in rows)
        fams = {}
        for ms, n, name in rows:
            label = next(lab for lab, pat in PROFILE_FAMILIES
                         if re.search(pat, name))
            fam = fams.setdefault(label, [0.0, 0])
            fam[0] += ms
            fam[1] += n
        where = "device" if self.device.type == "cuda" else "host"
        lines = [f"# {where} time of the training batches: {total:.3f} ms"]
        lines += [f"# family {lab}: {ms:.3f} ms, {n} launches"
                  for lab, (ms, n) in sorted(fams.items(),
                                             key=lambda kv: -kv[1][0])]
        lines += [f"{ms:10.3f} ms {n:6d} x {name}" for ms, n, name in rows]
        with open(os.path.join(self.workdir, "profiling.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        os.makedirs(os.path.join(self.workdir, "profile"), exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.workdir, "profile", "trace.json"))

    def _set_lr(self, lr: float):
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    @property
    def current_lr(self) -> float:
        if self.lr_sched is not None:
            return self.lr_sched.get_last_lr()[0]
        return self.learning_rate

    # -------------------------------------------------------------- logging

    def init_log(self):
        if self.iepoch > 0:
            self.logger.info("! Restarting training ...")
        else:
            self.logger.info("! Starting training ...")

    def final_log(self):
        self.logger.info(f"! Stop training: {self.stop_arg}")
        self.logger.info(f"Wall time: {perf_counter() - self.wall}")

    def end_of_batch_log(self, batch_type: str):
        line = f"  {self.iepoch + 1:5d} {self.ibatch + 1:5d}"
        for value in self.batch_losses.values():
            line += f" {float(value):12.3g}"
        self.logger.info(f"{batch_type} {line}")

    def end_of_epoch_log(self):
        """Fill ``mae_dict`` (``LR``, ``epoch``, ``wall`` and
        ``<category>_<loss or metric>``) and log one line per category."""
        lr = self.current_lr
        wall = perf_counter() - self.wall
        self.mae_dict = dict(LR=lr, epoch=self.iepoch, wall=wall)
        lines = {}
        for category in ("training", "validation"):
            met, skip_keys = self.metrics.flatten_metrics(
                self.metrics_dict[category],
                type_names=getattr(getattr(self, "dataset_train", None),
                                   "type_names", None))
            lines[category] = f"{self.iepoch:10d} {wall:8.3f} {lr:8.3g}"
            for key, value in self.loss_dict[category].items():
                lines[category] += f" {value:12.3g}"
                self.mae_dict[f"{category}_{key}"] = value
            for key, value in met.items():
                if key not in skip_keys:
                    lines[category] += f" {value:12.3g}"
                self.mae_dict[f"{category}_{key}"] = value
        self.logger.info("! Train      " + lines["training"])
        self.logger.info("! Validation " + lines["validation"])

    # ------------------------------------------------------------ save/load

    @property
    def init_keys(self):
        return [
            "data_config", "workdir", "seed", "loss_coeffs", "train_on_keys",
            "metrics_components", "metric_key", "max_epochs", "learning_rate",
            "lr_scheduler_name", "optimizer_name", "max_gradient_norm",
            "use_ema", "ema_decay", "ema_use_num_updates", "batch_size",
            "grad_acc", "train_idcs", "val_idcs", "epoch_subdivision",
        ]

    @property
    def params_dict(self):
        return self.as_dict(state_dict=False, training_progress=False,
                            kwargs=False)

    def as_dict(self, state_dict: bool = False,
                training_progress: bool = False, kwargs: bool = True):
        """The constructor's arguments; with ``state_dict`` the optimizer's
        state, the scheduler, the EMA (``{"params", "num_updates"}``),
        early stopping and the split and loader random streams; with
        ``training_progress`` the epoch, the best metric and the stop
        reason.  Tensors are numpy arrays."""
        dictionary = {key: getattr(self, key, None) for key in self.init_keys}
        if kwargs:
            dictionary.update({k: v for k, v in self.kwargs.items()
                               if not callable(v)})
        if state_dict:
            sd = {"opt_state": _numpyify(self.optimizer.state_dict())}
            if self.lr_sched is not None:
                sd["lr_sched"] = self.lr_sched.state_dict()
            if self.ema_model is not None:
                sd["ema"] = {"params": params_to_jax(self.ema_model),
                             "num_updates": self.ema_num_updates}
            if self.early_stopping_conds is not None:
                sd["early_stopping_conds"] = \
                    self.early_stopping_conds.state_dict()
            sd["split_rng_state"] = self.split_rng.bit_generator.state
            if self.dl_train is not None:
                sd["loader_state"] = self.dl_train.state_dict()
            dictionary["state_dict"] = sd
        if training_progress:
            dictionary["progress"] = {
                "iepoch": self.iepoch, "best_epoch": self.best_epoch,
                "best_metrics": self.best_metrics,
                "stop_arg": getattr(self, "stop_arg", None),
                "best_model_path": self.best_model_path,
                "last_model_path": self.last_model_path,
                "trainer_save_path": self.trainer_save_path,
            }
        return dictionary

    def end_of_epoch_save(self):
        """``best.pt`` (the EMA parameters) when ``metric_key`` improved;
        every ``save_period`` epochs ``trainer.pt`` and ``last.pt``, all in
        one atomic write group."""
        with atomic_write_group():
            current = self.mae_dict[self.metric_key]
            if current < self.best_metrics:
                self.best_metrics = current
                self.best_epoch = self.iepoch
                if self.workdir:
                    self.save_ema_model(self.best_model_path, blocking=False)
                self.logger.info(f"! Best model {self.best_epoch:8d} "
                                 f"{self.best_metrics:8.3f}")
            if self.workdir and self.save_period > 0 and \
                    (self.iepoch + 1) % self.save_period == 0:
                self.save(blocking=False)
                self.save_model(self.last_model_path, blocking=False)

    def save_model(self, path, blocking: bool = True):
        save_file(params_to_jax(self.model), path, enforced_format="pickle",
                  blocking=blocking)

    def save_ema_model(self, path, blocking: bool = True):
        model = self.ema_model if self.ema_model is not None else self.model
        save_file(params_to_jax(model), path, enforced_format="pickle",
                  blocking=blocking)

    def save(self, path=None, blocking: bool = True):
        path = path or self.trainer_save_path
        if path is None:
            return None
        state = self.as_dict(state_dict=True, training_progress=True)
        state["model_params"] = params_to_jax(self.model)
        save_file(state, path, enforced_format="pickle", blocking=blocking)
        return path

    # -------------------------------------------------------------- resume

    @classmethod
    def from_file(cls, path: str, model=None, **kwargs):
        """A trainer from ``trainer.pt`` (``from_dict``), or a fresh trainer
        whose model (and EMA) take the parameters of a bare parameter
        pickle (``best.pt``, ``last.pt``)."""
        dictionary = load_file(path, enforced_format="pickle")
        if "progress" in dictionary:
            return cls.from_dict(dictionary, model=model, **kwargs)
        load_jax_params(model, dictionary)
        trainer = cls(model=model, **kwargs)
        return trainer

    @classmethod
    def from_dict(cls, dictionary: dict, model=None, **overrides):
        """Restore a trainer: ``model`` (built, on its device) takes the saved
        parameters; the optimizer's state, the EMA, the scheduler, early
        stopping, the random streams and the progress are restored, so the
        run continues bit for bit.  A run that stopped properly is not
        resumed, except that one stopped at ``max_epochs`` continues when
        ``overrides`` raise ``max_epochs`` past its epoch."""
        dictionary = deepcopy(dictionary)
        state_dict = dictionary.pop("state_dict", None)
        progress = dictionary.pop("progress", {})
        params = dictionary.pop("model_params", None)
        stop_arg = progress.get("stop_arg")
        if stop_arg is not None and not (
                stop_arg == "max epochs"
                and overrides.get("max_epochs", -math.inf)
                > progress.get("iepoch", 0)):
            raise RuntimeError(
                f"The previous run has properly stopped with {stop_arg}. "
                "Refusing to resume.")
        if params is not None:
            load_jax_params(model, params)
        init_kwargs = dict(dictionary)
        init_kwargs.update(overrides)
        trainer = cls(model=model, **init_kwargs)
        if state_dict:
            if "opt_state" in state_dict:
                trainer.optimizer.load_state_dict(
                    _tensors(state_dict["opt_state"]))
            if "lr_sched" in state_dict and trainer.lr_sched is not None:
                trainer.lr_sched.load_state_dict(state_dict["lr_sched"])
                trainer._set_lr(trainer.lr_sched.get_last_lr()[0])
            if "ema" in state_dict and trainer.ema_model is not None:
                load_jax_params(trainer.ema_model,
                                state_dict["ema"]["params"])
                trainer.ema_num_updates = int(
                    state_dict["ema"]["num_updates"])
            if "early_stopping_conds" in state_dict and \
                    trainer.early_stopping_conds is not None:
                trainer.early_stopping_conds.load_state_dict(
                    state_dict["early_stopping_conds"])
            if "split_rng_state" in state_dict:
                trainer.split_rng.bit_generator.state = \
                    state_dict["split_rng_state"]
            trainer._loader_state = state_dict.get("loader_state")
        if progress:
            trainer.iepoch = progress.get("iepoch", 0)
            trainer.best_epoch = progress.get("best_epoch", 0)
            trainer.best_metrics = progress.get("best_metrics", float("inf"))
        return trainer

    @staticmethod
    def load_model_from_training_session(workdir, which="best.pt"):
        """The parameter tree of ``<workdir>/<which>`` (load it into a
        model with ``utils.load_jax_params``)."""
        return load_file(os.path.join(workdir, which),
                         enforced_format="pickle")
