"""Equivariant nonlinearities: activation registry, ``normalize2mom``, Gate.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/ops/gate.py`` (the parts the
``config_energy`` forward runs).  ``normalize2mom`` computes the same
Gauss-Hermite second moment on the float32 activation, so the rescaling
constants agree with the JAX package to float32 rounding.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .irreps import Irreps


def shifted_softplus(x):
    return F.softplus(x) - math.log(2.0)


def tanhlu(x):
    return torch.tanh(x) * torch.abs(x)


activations: Dict[str, Callable] = {
    "abs": torch.abs,
    "tanh": torch.tanh,
    "ssp": shifted_softplus,
    "silu": F.silu,
    "tanhlu": tanhlu,
}


def resolve_activation(act) -> Callable:
    return activations[act] if isinstance(act, str) else act


def second_moment(fn) -> float:
    """E_{x~N(0,1)}[fn(x)^2] via 128-point Gauss-Hermite quadrature."""
    x, w = np.polynomial.hermite_e.hermegauss(128)
    y = fn(torch.tensor(x, dtype=torch.float32)).numpy()
    return float((w * y * y).sum() / w.sum())


class ScaledActivation:
    """``fn(x) * cst``; a class rather than a lambda so ``cst`` is visible
    (the CUDA conv kernel takes it as an argument)."""

    def __init__(self, fn, cst: float):
        self.fn = fn
        self.cst = cst

    def __call__(self, x):
        return self.fn(x) * self.cst


def normalize2mom(fn) -> Callable:
    """Rescale an activation to unit second moment under N(0,1) input —
    the variance-preserving trick e3nn applies inside Gate / Activation /
    FullyConnectedNet."""
    fn = resolve_activation(fn)
    cst = second_moment(fn) ** -0.5
    if abs(cst - 1.0) < 1e-4:
        return fn
    return ScaledActivation(fn, cst)


class Gate:
    """Gated nonlinearity: ``irreps_in = scalars + gates + gated``.

    Scalars get their own activation; gates are activated scalars that
    multiply the gated (l>0) irreps channel-wise.  Output irreps are
    ``scalars + gated`` (gates are consumed).
    """

    def __init__(self, irreps_scalars, act_scalars, irreps_gates, act_gates,
                 irreps_gated):
        self.irreps_scalars = Irreps(irreps_scalars)
        self.irreps_gates = Irreps(irreps_gates)
        self.irreps_gated = Irreps(irreps_gated)
        self.act_scalars = [normalize2mom(a) for a in act_scalars]
        self.act_gates = [normalize2mom(a) for a in act_gates]
        assert self.irreps_gates.num_irreps == sum(
            mi.mul for mi in self.irreps_gated
        ), "need one gate per gated channel"
        for mi in self.irreps_scalars + self.irreps_gates:
            assert mi.ir.l == 0, "scalars/gates must be l=0"
        self.irreps_in = (self.irreps_scalars + self.irreps_gates
                          + self.irreps_gated)
        self.irreps_out = self.irreps_scalars + self.irreps_gated

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ds = self.irreps_scalars.dim
        dg = self.irreps_gates.dim
        lead = x.shape[:-1]
        outs: List[torch.Tensor] = []
        ofs = 0
        for mi, act in zip(self.irreps_scalars, self.act_scalars):
            outs.append(act(x[..., ofs: ofs + mi.dim]))
            ofs += mi.dim
        gofs = ds
        ofs = ds + dg
        for mi_g, act, mi in zip(self.irreps_gates, self.act_gates,
                                 self.irreps_gated):
            gate = act(x[..., gofs: gofs + mi_g.dim])
            chunk = x[..., ofs: ofs + mi.dim].reshape(
                lead + (mi.mul, mi.ir.dim))
            outs.append((chunk * gate[..., None]).reshape(lead + (mi.dim,)))
            gofs += mi_g.dim
            ofs += mi.dim
        return torch.cat(outs, dim=-1)
