"""VP-SDE diffusion: forward and reverse dynamics over a dict of diffusion
keys, the continuous score-matching loss, and the training and evaluation
step.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/run/sde_utils.py``.  Every
random draw goes through one explicit noise source that the caller passes
in (``Noise``: a ``torch.Generator`` on the batch's device; a test passes
a source that replays given arrays), in a fixed order:

- the loss: ``t`` (``uniform``, one per graph), then one ``normal`` per
  diffusion key (``VPSDE.marginal``);
- ``VPSDE.prior_sampling`` and ``VPSDE.sde``: one ``normal`` per key.

The step is eager PyTorch, one launch at a time: forward, loss, backward
(accumulated in the parameters' ``.grad``), and every ``grad_acc``-th step
the division, the clip, the NaN/Inf skip and Adam; the EMA on every step.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

import numpy as np
import torch

from ..data.graph_batch import GraphBatch
from .trainer import ADAM_DEFAULTS
from .trainer import ema_decay as _ema_decay


class Noise:
    """The draws of the SDE stack, from one ``torch.Generator`` on
    ``device`` seeded with ``seed``; float32, as the positions are."""

    def __init__(self, device="cuda", seed: int = 0):
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device)


def adam(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults (``optax.adam(lr)``) on ``model``'s
    parameters."""
    return torch.optim.Adam(
        model.parameters(), lr=lr,
        betas=(ADAM_DEFAULTS["b1"], ADAM_DEFAULTS["b2"]),
        eps=ADAM_DEFAULTS["eps"])


def with_t(batch: GraphBatch, t: torch.Tensor) -> GraphBatch:
    """``batch`` with the per-graph time ``t`` [G, 1]."""
    out = batch.replace(t=t)
    out.attrs["t"] = ("graph", "1x0e")
    return out


def _broadcast_t(batch, t):
    """Per-graph t -> per-node column, via the node segment (clamped)."""
    seg = batch["_node_segment"]
    g = t.shape[0]
    return t.reshape(-1)[seg.clamp(0, g - 1)][:, None]


class VPSDE:
    """Variance-preserving SDE over a dict {diffused key: dim}."""

    def __init__(self, diffusion_keys: Dict[str, int], beta_min=0.1,
                 beta_max=20, N=1000):
        self.beta_0 = float(beta_min)
        self.beta_1 = float(beta_max)
        self.N = int(N)
        self.discrete_betas = np.linspace(beta_min / N, beta_max / N, N)
        self.alphas = 1.0 - self.discrete_betas
        # coarse schedules (beta_max / N >= 1) drive the raw cumprod
        # negative; clamped to [0, 1], a zero tail is "fully noised", the
        # limit of the continuous marginal
        self.alphas_cumprod = np.clip(np.cumprod(self.alphas), 0.0, 1.0)
        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_1m_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)
        self.irreps = dict(diffusion_keys)

    @property
    def T(self):
        return 1

    def _log_mean_coeff(self, t):
        return (-0.25 * t ** 2 * (self.beta_1 - self.beta_0)
                - 0.5 * t * self.beta_0)

    def marginal_std(self, batch):
        t = _broadcast_t(batch, batch["t"])
        return torch.sqrt(1.0 - torch.exp(2.0 * self._log_mean_coeff(t)))

    def marginal(self, batch, noise, return_std=False):
        """Perturb the diffusion keys with the closed-form VP marginal:
        ``(batch, {"zs": {key: z}, "std": std})``."""
        if return_std:
            return self.marginal_std(batch)
        t = _broadcast_t(batch, batch["t"])
        log_mean_coeff = self._log_mean_coeff(t)
        std = torch.sqrt(1.0 - torch.exp(2.0 * log_mean_coeff))
        zs, updates = {}, {}
        for k in self.irreps:
            z = noise.normal(batch[k].shape)
            updates[k] = torch.exp(log_mean_coeff) * batch[k] + std * z
            zs[k] = z
        return batch.replace(**updates), {"zs": zs, "std": std}

    def sde(self, batch, noise, dt=None):
        """One forward Euler-Maruyama step."""
        if dt is None:
            dt = 1.0 / self.N
        t = _broadcast_t(batch, batch["t"])
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        diffusion = torch.sqrt(beta_t)
        updates = {}
        for k in self.irreps:
            x = batch[k]
            x_mean = x + (-0.5 * beta_t * x) * dt
            z = noise.normal(x.shape)
            updates[k] = x_mean + diffusion * np.sqrt(abs(dt)) * z
        return batch.replace(**updates)

    def prior_sampling(self, batch, noise):
        """N(0, 1) prior over the diffusion keys."""
        updates = {}
        for k, dim in self.irreps.items():
            n = batch[k].shape[0] if k in batch else \
                batch["_node_mask"].shape[0]
            updates[k] = noise.normal((n, dim))
        return batch.replace(**updates)

    def reverse(self, score_fn):
        """The reverse-time SDE; its ``sde(batch, noise)`` is one
        Euler-Maruyama step backwards in time."""
        fwd = self

        class RSDE:
            N = fwd.N
            T = fwd.T

            def sde(self, batch, noise):
                scores = score_fn(batch)
                t = _broadcast_t(batch, batch["t"])
                beta_t = fwd.beta_0 + t * (fwd.beta_1 - fwd.beta_0)
                diffusion = torch.sqrt(beta_t)
                dt = -1.0 / fwd.N
                batch = fwd.sde(batch, noise, dt)
                return batch.replace(**{
                    k: batch[k] - dt * diffusion ** 2 * scores[f"score_{k}"]
                    for k in fwd.irreps})

        return RSDE()


def get_score_fn(sde: VPSDE, model, train: bool = False) -> Callable:
    """score = -model_out / std - x, per diffusion key."""

    def score_fn(batch):
        out = model(batch)
        std = sde.marginal_std(batch)
        return {f"score_{k}": -out[f"score_{k}"] / std - batch[k]
                for k in sde.irreps}

    return score_fn


def get_sde_loss_fn(sde: VPSDE, train: bool, reduce_mean=True,
                    continuous=True, likelihood_weighting=True,
                    eps: float = 1e-5) -> Callable:
    """Continuous score-matching loss, masked over padded nodes:
    ``loss_fn(model, batch, noise) -> (total, {key: loss, "total":
    total})``."""

    def loss_fn(model, batch, noise):
        g = batch["_graph_mask"].shape[0]
        t = noise.uniform((g, 1)) * (sde.T - eps) + eps
        batch = with_t(batch, t)
        perturbed, misc = sde.marginal(batch, noise)
        scores = get_score_fn(sde, model, train)(perturbed)
        mask = batch["_node_mask"]
        n_real = mask.sum().clamp(min=1.0)
        losses = {}
        for k in sde.irreps:
            sq = (scores[f"score_{k}"] * misc["std"] + misc["zs"][k]) ** 2
            if reduce_mean:
                per_node = sq.mean(dim=-1, keepdim=True)
            else:
                per_node = 0.5 * sq.sum(dim=-1, keepdim=True)
            losses[k] = (per_node * mask).sum() / n_real
        total = sum(losses.values())
        losses["total"] = total
        return total, losses

    return loss_fn


def init_sde_state(model: torch.nn.Module, noise: Noise = None) -> dict:
    """The diffusion training state beside ``model`` and its optimizer:
    the EMA (a copy of the model, never an alias, and its update count),
    the step count and the noise source (by default a generator on the
    model's device).  The gradient accumulator is the parameters'
    ``.grad``, cleared here."""
    model.zero_grad(set_to_none=True)
    ema = copy.deepcopy(model)
    ema.requires_grad_(False)
    if noise is None:
        noise = Noise(next(model.parameters()).device)
    return {"ema": {"model": ema, "num_updates": 0}, "step": 0,
            "noise": noise}


def get_step_fn(sde: VPSDE, train: bool, model=None, optimizer=None,
                reduce_mean=False, continuous=True,
                likelihood_weighting=False, grad_clid_norm=None,
                grad_acc: int = 1, ema_decay: float = 0.999,
                ema_use_num_updates: bool = True) -> Callable:
    """``step_fn(state, batch) -> (state, loss, losses)``.

    Training: the loss's gradient is added to ``.grad``; every
    ``grad_acc``-th step the sum is divided by ``grad_acc``, clipped to the
    global norm ``grad_clid_norm``, and Adam steps unless a gradient is NaN
    or Inf (then the parameters and the optimizer's state, its step count
    too, stay as they were); the accumulator is cleared either way.  The
    EMA updates on every step.  Evaluation: the loss of the EMA model.
    ``model`` and ``optimizer`` (``adam``) are the training model and its
    optimizer; ``state`` comes from ``init_sde_state(model)``.
    """
    loss_fn = get_sde_loss_fn(
        sde, train, reduce_mean=reduce_mean, continuous=continuous,
        likelihood_weighting=likelihood_weighting)

    if not train:

        def eval_step(state, batch):
            with torch.no_grad():
                loss, losses = loss_fn(state["ema"]["model"], batch,
                                       state["noise"])
            return state, loss, losses

        return eval_step

    params = list(model.parameters())

    def apply_gradients():
        grads = []
        for p in params:
            if p.grad is None:  # optax steps every leaf, zeros included
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if grad_acc > 1:
            torch._foreach_div_(grads, float(grad_acc))
        if grad_clid_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            torch._foreach_mul_(grads, torch.clamp(
                grad_clid_norm / (norm + 1e-12), max=1.0))
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        # the step's one host read, once per applied step: a captured step
        # (a CUDA graph) will have to make the skip on the device
        if bool(finite):
            optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    def train_step(state, batch):
        loss, losses = loss_fn(model, batch, state["noise"])
        loss.backward()
        state["step"] += 1
        if state["step"] % grad_acc == 0:
            apply_gradients()
        ema = state["ema"]
        ema["num_updates"] += 1
        d = _ema_decay(ema_decay, ema["num_updates"], ema_use_num_updates)
        with torch.no_grad():
            ema_params = list(ema["model"].parameters())
            torch._foreach_mul_(ema_params, d)
            torch._foreach_add_(ema_params, params, alpha=1.0 - d)
        return state, loss.detach(), {k: v.detach()
                                      for k, v in losses.items()}

    return train_step
