"""Predictor-corrector and probability-flow ODE sampling for the VP-SDE.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/run/sde_sampling.py``:
predictor and corrector registries, the Euler-Maruyama predictor, the
Langevin corrector (SNR-scaled step), the ``none`` variants, the PC loop,
the Heun-integrated probability-flow ODE and ``get_sampling_fn``.

The reverse loop runs under ``torch.no_grad()`` (a ``GradientOutput`` head
still takes its position gradient), one iteration at a time: the PC
sampler's corrector then predictor, the ODE sampler's two Heun drifts.  An
iteration reads its time from a device table of the timesteps at a device
step counter, and writes the new state back into the batch it was given,
so it reads nothing from the host and nothing back to it.  On a CUDA
device in one process the iteration is compiled (``capture``, by default
on): captured once into a CUDA graph (``run.capture.Step``) and replayed
for every step, as the JAX samplers run their loop whole in one
``lax.fori_loop``; ``capture=False`` runs it eagerly.  The noise source
(``sde_utils.Noise``) is drawn in a fixed order: the prior, then per step
the corrector's normals (one per key and corrector step), then the
predictor's (one per key); a captured iteration draws from its generator
(registered with the graph, as is the in-model edge layer's).  A source
that a replay cannot renew (``run.capture.renews``: one that hands out
given arrays, with no ``capturable = True``) runs the loop eagerly by
default, and ``capture=True`` with it raises.

Edge vectors and lengths are dropped from the sampler's batch: every score
evaluation derives them from the current positions (``computeEdgeVector``
keeps a vector it is given).  The edge list is the input's for the
fully-connected molecule graphs of ``config_diffusion``; the protein
configs' first layer (``computeEdgeIndexDevice``) rebuilds it from the
current CA positions in every evaluation, into the input's static edge
buffer, on the device.
"""

from __future__ import annotations

import abc
from typing import Callable

import numpy as np
import torch

from ..data.graph_batch import GraphBatch
from . import capture as capture_mod
from .sde_utils import VPSDE, Noise, _broadcast_t, get_score_fn, with_t

_CORRECTORS = {}
_PREDICTORS = {}

#: keys derived from positions, never carried from one step to the next
GEOMETRY_KEYS = ("edge_vector", "edge_length")


def register_predictor(cls=None, *, name=None):
    def _register(cls):
        local_name = cls.__name__ if name is None else name
        if local_name in _PREDICTORS:
            raise ValueError(
                f"Already registered model with name: {local_name}")
        _PREDICTORS[local_name] = cls
        return cls

    return _register if cls is None else _register(cls)


def register_corrector(cls=None, *, name=None):
    def _register(cls):
        local_name = cls.__name__ if name is None else name
        if local_name in _CORRECTORS:
            raise ValueError(
                f"Already registered model with name: {local_name}")
        _CORRECTORS[local_name] = cls
        return cls

    return _register if cls is None else _register(cls)


def get_predictor(name):
    return _PREDICTORS[name]


def get_corrector(name):
    return _CORRECTORS[name]


class Predictor(abc.ABC):
    def __init__(self, sde, score_fn):
        self.sde = sde
        self.rsde = sde.reverse(score_fn)
        self.score_fn = score_fn

    @abc.abstractmethod
    def update_fn(self, batch, noise):
        ...


class Corrector(abc.ABC):
    def __init__(self, sde, score_fn, snr, n_steps):
        self.sde = sde
        self.score_fn = score_fn
        self.snr = snr
        self.n_steps = n_steps

    @abc.abstractmethod
    def update_fn(self, batch, noise):
        ...


@register_predictor(name="euler_maruyama")
class EulerMaruyamaPredictor(Predictor):
    def update_fn(self, batch, noise):
        return self.rsde.sde(batch, noise)


@register_predictor(name="none")
class NonePredictor(Predictor):
    def __init__(self, sde, score_fn):
        pass

    def update_fn(self, batch, noise):
        return batch


@register_corrector(name="langevin")
class LangevinCorrector(Corrector):
    """SNR-scaled Langevin MCMC on every diffusion key."""

    def __init__(self, sde, score_fn, snr, n_steps):
        super().__init__(sde, score_fn, snr, n_steps)
        if not isinstance(sde, VPSDE):
            raise NotImplementedError(
                f"SDE class {type(sde).__name__} not yet supported.")
        self._alphas = {}   # device -> the alphas table there

    def update_fn(self, batch, noise):
        sde = self.sde
        t = batch["t"]
        if t.device not in self._alphas:
            self._alphas[t.device] = torch.as_tensor(
                sde.alphas, dtype=torch.float32, device=t.device)
        timestep = (t.reshape(-1)[:1] * (sde.N - 1) / sde.T).long()
        alpha = self._alphas[t.device].index_select(0, timestep).reshape(())
        mask = batch["_node_mask"]
        n_real = mask.sum().clamp(min=1.0)
        for _ in range(self.n_steps):
            scores = self.score_fn(batch)
            updates = {}
            for k in sde.irreps:
                x = batch[k]
                grad = scores[f"score_{k}"]
                z = noise.normal(x.shape)
                grad_norm = (torch.linalg.vector_norm(
                    grad, dim=-1, keepdim=True) * mask).sum() / n_real
                noise_norm = (torch.linalg.vector_norm(
                    z, dim=-1, keepdim=True) * mask).sum() / n_real
                step_size = (self.snr * noise_norm
                             / grad_norm.clamp(min=1e-12)) ** 2 * 2 * alpha
                x_mean = x + step_size * grad
                updates[k] = x_mean + torch.sqrt(step_size * 2) * z
            batch = batch.replace(**updates)
        return batch


@register_corrector(name="none")
class NoneCorrector(Corrector):
    def __init__(self, sde, score_fn, snr, n_steps):
        pass

    def update_fn(self, batch, noise):
        return batch


def _start(sde: VPSDE, batch: GraphBatch, noise):
    """The sampler's batch at t = 1: no edge geometry, the prior drawn."""
    data = {k: v for k, v in batch.data.items() if k not in GEOMETRY_KEYS}
    batch = GraphBatch(data, dict(batch.attrs), batch.n_graphs,
                       batch.node_capacity, batch.edge_capacity,
                       batch.dropped)
    g = batch["_graph_mask"].shape[0]
    batch = with_t(batch, torch.ones((g, 1),
                                     device=batch["_graph_mask"].device))
    return sde.prior_sampling(batch, noise)


def _noise_for(batch, noise):
    return Noise(batch["_node_mask"].device) if noise is None else noise


def _timesteps(sde: VPSDE, eps: float, n: int, device) -> torch.Tensor:
    """The loop's times, float32 on ``device``: ``n`` from ``sde.T`` down
    to ``eps``."""
    return torch.as_tensor(np.linspace(sde.T, eps, n).astype(np.float32),
                           device=device)


def _write_back(batch: GraphBatch, new: GraphBatch, keys) -> None:
    """The iteration's new ``keys`` and ``t`` into ``batch``'s tensors."""
    for k in (*keys, "t"):
        batch[k].copy_(new[k])


def _run_loop(name, iterate, batch, n, capture, model, noise):
    """``iterate(batch, i)`` ``n`` times from step counter 0, compiled
    (``capture``) or eager; returns the last batch."""
    i = torch.zeros(1, dtype=torch.int64, device=batch["_node_mask"].device)
    if capture_mod.enabled(capture, i.device, (noise, model)):
        iterate = capture_mod.Step(
            name, iterate,
            generators=lambda: capture_mod.generators(noise, model))
    for _ in range(n):
        batch, i = iterate(batch, i)
    return batch


def get_pc_sampler(sde: VPSDE, predictor, corrector, inverse_scaler, snr,
                   n_steps=1, continuous=False, eps=1e-3,
                   capture=None) -> Callable:
    """``pc_sampler(model, batch, noise=None, steps=None) -> (batch,
    nfe)``: ``sde.N`` steps from t = 1 to ``eps``, each a corrector then a
    predictor update; ``nfe`` counts the score evaluations.  ``steps``
    stops after the first ``steps`` of them (a check of the early steps,
    before the reverse process amplifies rounding).  ``capture``: one
    iteration as a CUDA graph, replayed for each step
    (``run.capture.enabled``); ``False`` is eager."""

    def pc_sampler(model, batch, noise=None, steps=None):
        noise = _noise_for(batch, noise)
        score_fn = get_score_fn(sde, model, train=False)
        predictor_obj = (NonePredictor if predictor is None else predictor)(
            sde, score_fn)
        corrector_obj = (NoneCorrector if corrector is None else corrector)(
            sde, score_fn, snr, n_steps)
        n = len(range(sde.N)[:steps])
        with torch.no_grad():
            batch = _start(sde, batch, noise)
            times = _timesteps(sde, eps, sde.N, batch["t"].device)
            ones = torch.ones_like(batch["t"])

            def iterate(b, i):
                new = with_t(b, ones * times.index_select(0, i))
                new = corrector_obj.update_fn(new, noise)
                new = predictor_obj.update_fn(new, noise)
                _write_back(b, new, sde.irreps)
                i.add_(1)
                return b, i

            batch = _run_loop("pc_sampler", iterate, batch, n, capture,
                              model, noise)
        return batch, n * (n_steps + 1)

    return pc_sampler


def get_ode_sampler(sde: VPSDE, inverse_scaler, denoise: bool = True,
                    eps: float = 1e-3, n_steps: int = None,
                    capture=None) -> Callable:
    """Probability-flow ODE sampler (deterministic reverse dynamics):
    ``dx = [f(x, t) - g(t)^2 score(x, t) / 2] dt``, integrated with Heun's
    method over ``n_steps`` (by default ``sde.N``) times;
    ``ode_sampler(model, batch, noise=None) -> (batch, nfe)``.
    ``capture``: one Heun step as a CUDA graph, replayed for each step
    (``run.capture.enabled``); ``False`` is eager."""

    def ode_sampler(model, batch, noise=None):
        noise = _noise_for(batch, noise)
        n = n_steps or sde.N
        score_fn = get_score_fn(sde, model, train=False)
        dt = float(np.float32(-(sde.T - eps) / (n - 1)))

        def drift(b):
            scores = score_fn(b)
            beta_t = sde.beta_0 + _broadcast_t(b, b["t"]) * (
                sde.beta_1 - sde.beta_0)
            return {k: -0.5 * beta_t * b[k]
                    - 0.5 * beta_t * scores[f"score_{k}"]
                    for k in sde.irreps}

        with torch.no_grad():
            batch = _start(sde, batch, noise)
            times = _timesteps(sde, eps, n, batch["t"].device)
            ones = torch.ones_like(batch["t"])

            def iterate(b, i):
                t = times.index_select(0, i)
                cur = with_t(b, ones * t)
                d1 = drift(cur)
                # Heun: the drift again at the Euler-predicted point
                pred = with_t(
                    cur.replace(**{k: cur[k] + dt * d1[k]
                                   for k in sde.irreps}),
                    ones * (t + dt))
                d2 = drift(pred)
                _write_back(b, cur.replace(**{
                    k: cur[k] + 0.5 * dt * (d1[k] + d2[k])
                    for k in sde.irreps}), sde.irreps)
                i.add_(1)
                return b, i

            batch = _run_loop("ode_sampler", iterate, batch, n - 1, capture,
                              model, noise)
        return batch, 2 * (n - 1)

    return ode_sampler


def get_sampling_fn(config, sde, inverse_scaler, eps,
                    capture=None) -> Callable:
    """The sampler that ``config["sampling"]`` (``models/sde_config.py``)
    names: ``sampling_fn(model, batch, noise=None) -> (host Batch, nfe)``,
    the host batch trimmed of padding and passed through
    ``inverse_scaler`` when one is given; ``capture`` as the samplers'."""
    sampling = config["sampling"]
    method = sampling["method"].lower()
    if method == "ode":
        sampler = get_ode_sampler(sde=sde, inverse_scaler=inverse_scaler,
                                  denoise=sampling["noise_removal"], eps=eps,
                                  capture=capture)
    elif method == "pc":
        sampler = get_pc_sampler(
            sde=sde,
            predictor=get_predictor(sampling["predictor"].lower()),
            corrector=get_corrector(sampling["corrector"].lower()),
            inverse_scaler=inverse_scaler, snr=sampling["snr"],
            n_steps=sampling["n_steps_each"],
            continuous=config["training"]["continuous"], eps=eps,
            capture=capture)
    else:
        raise ValueError(f"Sampler name {sampling['method']} unknown.")

    def sampling_fn(model, batch, noise=None):
        out, nfe = sampler(model, batch, noise)
        host = out.to_batch()
        if inverse_scaler is not None:
            host = inverse_scaler(host)
        return host, nfe

    return sampling_fn
