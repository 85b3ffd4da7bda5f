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

The step is forward, loss, backward (accumulated in place in the
parameters' ``.grad``), and every ``grad_acc``-th step the division, the
clip, the NaN/Inf skip and Adam; the EMA on every step.  Nothing in it
reads the host: the skip takes the step and puts the old parameters and
optimizer state back where the gradients are not finite (JAX's
``lax.cond``), and the EMA's count lives on the device.  On a CUDA device,
in one process or under an NCCL process group, the steps are compiled
(``capture``, by default on): the step that applies and the micro-step
each run as a CUDA graph (``run.capture.Step``), with the noise
generators registered with them.  Under a process group the gradients are
views of flat buffers (``parallel.GradReducer``) that the step that
applies all-reduces before the division and the clip (captured under
NCCL, eager under gloo), so the gradients that the clip, the skip and
Adam read are the mean of all ranks': every rank skips a step together,
with no host read.  ``sde_state_dict`` and ``load_sde_state_dict``
turn the training state into a checkpoint of numpy arrays under the JAX
state's names (``params``, ``opt_state``, ``ema``, ``step``) and back.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

import numpy as np
import torch

from ..data.graph_batch import GraphBatch
from ..parallel import data_parallel as dp
from ..parallel import mesh
from ..utils.params import load_jax_params, params_to_jax
from ..utils.saveload import _numpyify
from . import capture as capture_mod
from .trainer import ADAM_DEFAULTS, _tensors
from .trainer import adam as _adam
from .trainer import ema_update


class Noise:
    """The draws of the SDE stack, from one ``torch.Generator`` on
    ``device`` seeded with ``seed``; float32, as the positions are.  A
    captured step registers the generator with its graphs, so each replay
    draws afresh (``capture.renews``)."""

    capturable = True

    def __init__(self, device="cuda", seed: int = 0):
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device)


def adam(model: torch.nn.Module, lr: float):
    """Adam with optax's defaults (``optax.adam(lr)``) on ``model``'s
    parameters (``trainer.Adam``: the rate and the count are tensors on
    the parameters' device)."""
    return _adam(model.parameters(), lr, **ADAM_DEFAULTS)


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
    the EMA (a copy of the model, never an alias, and its update count, an
    int32 tensor on the model's device), the step count (the host's) and
    the noise source (by default a generator on the model's device).  The
    gradient accumulator is the parameters' ``.grad``, zeroed here."""
    model.zero_grad(set_to_none=False)
    ema = copy.deepcopy(model)
    ema.requires_grad_(False)
    device = next(model.parameters()).device
    if noise is None:
        noise = Noise(device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    return {"ema": {"model": ema, "num_updates": count}, "step": 0,
            "noise": noise}


def sde_state_dict(state: dict, model: torch.nn.Module, optimizer) -> dict:
    """The training state as a checkpoint tree of numpy arrays: the
    parameters and the EMA's under the JAX parameter tree's names, the
    optimizer's state, the step and the noise generator's state.  Under a
    process group every rank calls it: ``noise_ranks`` holds each rank's
    generator state, so that each rank resumes its own draws."""
    out = {"params": params_to_jax(model),
           "opt_state": _numpyify(optimizer.state_dict()),
           "ema": {"params": params_to_jax(state["ema"]["model"]),
                   "num_updates": int(state["ema"]["num_updates"])},
           "step": state["step"]}
    generator = getattr(state["noise"], "generator", None)
    noise = generator.get_state().numpy() if generator is not None else None
    ranks = dp.gather_objects(noise)
    if noise is not None:
        out["noise"] = noise
    if len(ranks) > 1:
        out["noise_ranks"] = ranks
    return out


def load_sde_state_dict(tree: dict, state: dict, model: torch.nn.Module,
                        optimizer) -> dict:
    """Restore ``sde_state_dict``'s tree into ``model``, ``optimizer`` and
    ``state`` (from ``init_sde_state(model)``), each value copied into the
    tensor that holds it, so that captured steps keep reading them; where
    the optimizer had no state yet its tensors are new, in a new state
    dict, and a captured step built before the load captures anew.
    Returns ``state``."""
    load_jax_params(model, tree["params"])
    capture_mod.load_optimizer_state(optimizer, _tensors(tree["opt_state"]))
    load_jax_params(state["ema"]["model"], tree["ema"]["params"])
    state["ema"]["num_updates"].fill_(int(tree["ema"]["num_updates"]))
    state["step"] = int(tree["step"])
    # this rank's draws (rank 0's in a file of one rank); a rank the file
    # does not know keeps the stream of its own seed
    rank = mesh.rank()
    ranks = tree.get("noise_ranks") or [tree.get("noise")]
    noise = ranks[rank] if rank < len(ranks) else None
    generator = getattr(state["noise"], "generator", None)
    if generator is not None and noise is not None:
        generator.set_state(torch.from_numpy(np.array(noise)))
    return state


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _put(tensors, flat: torch.Tensor) -> None:
    """Copy ``flat`` (``_flat``'s layout) back into ``tensors``."""
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [c.view_as(t)
                                   for c, t in zip(parts, tensors)])


@torch.no_grad()
def _finite_step(optimizer, finite: torch.Tensor) -> None:
    """The optimizer's step, kept only where ``finite`` (a device bool):
    elsewhere the parameters and the optimizer's state, its step counts
    too, get their old values back (JAX's ``lax.cond`` around the update).
    A state tensor that the step itself made (Adam's first step) goes back
    to zeros, the state Adam starts from.  One ``where`` over each dtype's
    tensors laid end to end, not one per tensor."""
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def by_dtype(keep):
        out = {}
        for p in params:
            for t in (p, *optimizer.state.get(p, {}).values()):
                if torch.is_tensor(t) and keep(t):
                    out.setdefault(t.dtype, []).append(t)
        return out

    held = by_dtype(lambda t: True)
    old = {dt: _flat(ts) for dt, ts in held.items()}
    ids = {id(t) for ts in held.values() for t in ts}
    optimizer.step()
    for dt, ts in held.items():
        _put(ts, torch.where(finite, _flat(ts), old[dt]))
    for ts in by_dtype(lambda t: id(t) not in ids).values():
        new = _flat(ts)
        _put(ts, torch.where(finite, new, torch.zeros_like(new)))


def get_step_fn(sde: VPSDE, train: bool, model=None, optimizer=None,
                reduce_mean=False, continuous=True,
                likelihood_weighting=False, grad_clid_norm=None,
                grad_acc: int = 1, ema_decay: float = 0.999,
                ema_use_num_updates: bool = True,
                capture=None) -> Callable:
    """``step_fn(state, batch) -> (state, loss, losses)``.

    Training: the loss's gradient is added to ``.grad``; every
    ``grad_acc``-th step the sum is divided by ``grad_acc``, clipped to the
    global norm ``grad_clid_norm``, and Adam steps unless a gradient is NaN
    or Inf (then the parameters and the optimizer's state, its step count
    too, stay as they were); the accumulator is zeroed either way.  The
    EMA updates on every step.  Evaluation: the loss of the EMA model.
    ``model`` and ``optimizer`` (``adam``) are the training model and its
    optimizer; ``state`` comes from ``init_sde_state(model)``.
    Under a process group the step that applies averages the gradients
    over the ranks first (``parallel.GradReducer``; a parameter that gets
    no gradient averages zeros).  ``capture``: the steps as CUDA graphs
    (``run.capture.enabled``: by default on a CUDA device in one process
    or under NCCL; the device is ``model``'s, or the batch's when
    evaluating); ``False`` is eager.  A captured step draws from
    ``state["noise"]``'s generator, and, for a model with an in-model edge
    layer, from its ``EdgeRandom``: they are registered with the graphs.  A
    noise source whose draws a replay cannot renew (``capture.renews``: a
    test's source of given arrays) runs the steps eagerly, and
    ``capture=True`` with one raises.
    """
    loss_fn = get_sde_loss_fn(
        sde, train, reduce_mean=reduce_mean, continuous=continuous,
        likelihood_weighting=likelihood_weighting)
    compiled = {"owners": (), "steps": {}}

    def compiled_step(name, fn, *owners):
        """``fn`` as a ``capture.Step`` bound to ``owners``, the state's
        objects that its graphs read and draw from (a new noise source or
        EMA model gets new steps)."""
        if [id(o) for o in compiled["owners"]] != [id(o) for o in owners]:
            compiled.update(owners=owners, steps={})
        steps = compiled["steps"]
        if name not in steps:
            steps[name] = capture_mod.Step(
                name, fn, generators=lambda: capture_mod.generators(*owners))
        return steps[name]

    if not train:

        def evaluate(state, batch):
            with torch.no_grad():
                return loss_fn(state["ema"]["model"], batch, state["noise"])

        def eval_step(state, batch):
            if not capture_mod.enabled(capture, batch["_node_mask"].device,
                                       (state["noise"],
                                        state["ema"]["model"])):
                loss, losses = evaluate(state, batch)
                return state, loss, losses
            step = compiled_step("sde_eval", lambda b: evaluate(state, b),
                                 state["noise"], state["ema"]["model"])
            loss, losses = step(batch)
            return state, loss.clone(), {k: v.clone()
                                         for k, v in losses.items()}

        return eval_step

    params = list(model.parameters())
    # the gradients as views of flat buffers, made once (rank 0's
    # parameters broadcast to every rank under a process group)
    reducer = {"grads": dp.GradReducer(params)}
    # capture=True raises here where it cannot run at all; the noise source
    # is asked about on each call (the state carries it)
    capture_mod.enabled(capture, params[0].device, (model,))

    def apply_gradients():
        reducer["grads"].reduce()
        grads = reducer["grads"].grads()
        if grad_acc > 1:
            torch._foreach_div_(grads, float(grad_acc))
        if grad_clid_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            torch._foreach_mul_(grads, torch.clamp(
                grad_clid_norm / (norm + 1e-12), max=1.0))
        # the gradients after the all-reduce: every rank skips together
        _finite_step(optimizer, reducer["grads"].finite())
        reducer["grads"].zero_()

    def one_step(state, batch, applies):
        loss, losses = loss_fn(model, batch, state["noise"])
        loss.backward()
        if applies:
            apply_gradients()
        ema_update(list(state["ema"]["model"].parameters()), params,
                   state["ema"]["num_updates"], ema_decay,
                   ema_use_num_updates)
        return loss.detach(), {k: v.detach() for k, v in losses.items()}

    def train_step(state, batch):
        # optax steps every leaf, zeros included: every gradient is a
        # tensor the steps add to and zero in place (made again, and the
        # graphs with them, where a caller replaced one)
        if not reducer["grads"].attached():
            reducer["grads"] = dp.GradReducer(params)
            compiled.update(owners=(), steps={})
        state["step"] += 1
        applies = state["step"] % grad_acc == 0
        if not capture_mod.enabled(capture, params[0].device,
                                   (state["noise"], model)):
            loss, losses = one_step(state, batch, applies)
            return state, loss, losses
        name = "sde_apply" if applies else "sde_accumulate"
        # a load that replaced the optimizer's state (it had none yet)
        # replaced its dict too: new graphs then
        step = compiled_step(
            name, lambda b: one_step(state, b, applies), state["noise"],
            state["ema"]["model"], model, optimizer.state)
        loss, losses = step(batch)
        return state, loss.clone(), {k: v.clone() for k, v in losses.items()}

    return train_step
