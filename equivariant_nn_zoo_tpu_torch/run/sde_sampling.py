"""Predictor-corrector and probability-flow ODE sampling for the VP-SDE.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/run/sde_sampling.py``:
predictor and corrector registries, the Euler-Maruyama predictor, the
Langevin corrector (SNR-scaled step), the ``none`` variants, the PC loop,
the Heun-integrated probability-flow ODE and ``get_sampling_fn``.

The reverse loop is eager, one score evaluation (a model forward) at a
time, under ``torch.no_grad()`` (a ``GradientOutput`` head still takes its
position gradient).  Its timesteps are host floats; what depends on them on
the device (``t``, the corrector's ``alphas[timestep]``) is computed there,
so the loop reads nothing back from the device.  The noise source
(``sde_utils.Noise``) is drawn in a fixed order: the prior, then per step
the corrector's normals (one per key and corrector step), then the
predictor's (one per key).

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
        timestep = (t.reshape(-1)[0] * (sde.N - 1) / sde.T).long()
        alpha = self._alphas[t.device][timestep]
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


def get_pc_sampler(sde: VPSDE, predictor, corrector, inverse_scaler, snr,
                   n_steps=1, continuous=False, eps=1e-3) -> Callable:
    """``pc_sampler(model, batch, noise=None, steps=None) -> (batch,
    nfe)``: ``sde.N`` steps from t = 1 to ``eps``, each a corrector then a
    predictor update; ``nfe`` counts the score evaluations.  ``steps``
    stops after the first ``steps`` of them (a check of the early steps,
    before the reverse process amplifies rounding)."""

    def pc_sampler(model, batch, noise=None, steps=None):
        noise = _noise_for(batch, noise)
        score_fn = get_score_fn(sde, model, train=False)
        predictor_obj = (NonePredictor if predictor is None else predictor)(
            sde, score_fn)
        corrector_obj = (NoneCorrector if corrector is None else corrector)(
            sde, score_fn, snr, n_steps)
        with torch.no_grad():
            batch = _start(sde, batch, noise)
            ones = torch.ones_like(batch["t"])
            timesteps = np.linspace(sde.T, eps, sde.N).astype(np.float32)
            for t in timesteps[:steps]:
                batch = with_t(batch, ones * float(t))
                batch = corrector_obj.update_fn(batch, noise)
                batch = predictor_obj.update_fn(batch, noise)
        return batch, len(timesteps[:steps]) * (n_steps + 1)

    return pc_sampler


def get_ode_sampler(sde: VPSDE, inverse_scaler, denoise: bool = True,
                    eps: float = 1e-3, n_steps: int = None) -> Callable:
    """Probability-flow ODE sampler (deterministic reverse dynamics):
    ``dx = [f(x, t) - g(t)^2 score(x, t) / 2] dt``, integrated with Heun's
    method over ``n_steps`` (by default ``sde.N``) times;
    ``ode_sampler(model, batch, noise=None) -> (batch, nfe)``."""

    def ode_sampler(model, batch, noise=None):
        noise = _noise_for(batch, noise)
        n = n_steps or sde.N
        score_fn = get_score_fn(sde, model, train=False)
        timesteps = np.linspace(sde.T, eps, n).astype(np.float32)
        dt = np.float32(-(sde.T - eps) / (n - 1))

        def drift(b):
            scores = score_fn(b)
            beta_t = sde.beta_0 + _broadcast_t(b, b["t"]) * (
                sde.beta_1 - sde.beta_0)
            return {k: -0.5 * beta_t * b[k]
                    - 0.5 * beta_t * scores[f"score_{k}"]
                    for k in sde.irreps}

        with torch.no_grad():
            batch = _start(sde, batch, noise)
            ones = torch.ones_like(batch["t"])
            for t in timesteps[:-1]:
                b = with_t(batch, ones * float(t))
                d1 = drift(b)
                # Heun: the drift again at the Euler-predicted point
                b_pred = with_t(
                    b.replace(**{k: b[k] + float(dt) * d1[k]
                                 for k in sde.irreps}),
                    ones * float(t + dt))
                d2 = drift(b_pred)
                batch = b.replace(**{
                    k: b[k] + 0.5 * float(dt) * (d1[k] + d2[k])
                    for k in sde.irreps})
        return batch, 2 * (n - 1)

    return ode_sampler


def get_sampling_fn(config, sde, inverse_scaler, eps) -> Callable:
    """The sampler that ``config["sampling"]`` (``models/sde_config.py``)
    names: ``sampling_fn(model, batch, noise=None) -> (host Batch, nfe)``,
    the host batch trimmed of padding and passed through
    ``inverse_scaler`` when one is given."""
    sampling = config["sampling"]
    method = sampling["method"].lower()
    if method == "ode":
        sampler = get_ode_sampler(sde=sde, inverse_scaler=inverse_scaler,
                                  denoise=sampling["noise_removal"], eps=eps)
    elif method == "pc":
        sampler = get_pc_sampler(
            sde=sde,
            predictor=get_predictor(sampling["predictor"].lower()),
            corrector=get_corrector(sampling["corrector"].lower()),
            inverse_scaler=inverse_scaler, snr=sampling["snr"],
            n_steps=sampling["n_steps_each"],
            continuous=config["training"]["continuous"], eps=eps)
    else:
        raise ValueError(f"Sampler name {sampling['method']} unknown.")

    def sampling_fn(model, batch, noise=None):
        out, nfe = sampler(model, batch, noise)
        host = out.to_batch()
        if inverse_scaler is not None:
            host = inverse_scaler(host)
        return host, nfe

    return sampling_fn
