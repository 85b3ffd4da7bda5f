"""Embedding layers: one-hot species, trainable Bessel radial basis with a
polynomial cutoff, spherical-harmonic edge encoding.

PyTorch counterparts of the ``config_energy`` layers of
``equivariant_nn_zoo_tpu/nn/embedding.py``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.irreps import Irreps
from ..ops.spherical_harmonics import SphericalHarmonics
from ..utils.params import ParamModule
from .module import Module


def poly_cutoff(x: torch.Tensor, factor: float, p: float = 6.0):
    """DimeNet polynomial envelope."""
    x = x * factor
    out = 1.0
    out = out - ((p + 1.0) * (p + 2.0) / 2.0) * torch.pow(x, p)
    out = out + p * (p + 2.0) * torch.pow(x, p + 1.0)
    out = out - (p * (p + 1.0) / 2.0) * torch.pow(x, p + 2.0)
    return out * (x < 1.0)


class BesselBasis(ParamModule):
    """Radial Bessel basis ``prefactor * sin(w_n x / c) / x`` with trainable
    frequencies ``bessel_weights`` (initialised to ``n pi``)."""

    def __init__(self, r_max, r_min=0, num_basis=8, trainable=True,
                 one_over_r=True):
        super().__init__()
        self.trainable = trainable
        self.r_max = float(r_max)
        self.r_min = float(r_min)
        self.prefactor = 2.0 / (self.r_max - self.r_min)
        self.one_over_r = one_over_r
        freqs = (np.linspace(1.0, num_basis, num_basis) * math.pi).astype(
            np.float32)
        if trainable:
            self.declare("bessel_weights", (num_basis,), freqs)
        else:
            self.register_buffer("bessel_weights", torch.tensor(freqs),
                                 persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.prefactor * torch.sin(
            self.bessel_weights * x[..., None] / (self.r_max - self.r_min))
        if self.one_over_r:
            # padded edges carry epsilon-clamped lengths, so this stays finite
            out = out / x[..., None]
        return out


class OneHotEncoding(Module):
    """Integer species -> one-hot scalars."""

    def __init__(self, num_types: int, irreps_out, irreps_in="0x0e"):
        super().__init__()
        self.num_types = num_types
        self.init_irreps(input=irreps_in, one_hot=irreps_out,
                         output_keys="one_hot")

    def forward(self, data: Dict, attrs: Dict):
        types = data["input"].reshape(-1).long()
        one_hot = F.one_hot(types, self.num_types).to(torch.float32)
        return ({"one_hot": one_hot},
                {"one_hot": (attrs["input"][0], self.irreps_out["one_hot"])})


class RadialBasisEncoding(Module):
    """Bessel basis times polynomial cutoff of a positive scalar."""

    def __init__(self, r_max, trainable, irreps_out, r_min=0,
                 polynomial_degree=6, irreps_in="1x0e", one_over_r=True):
        super().__init__()
        self.init_irreps(input=irreps_in, radial_embedding=irreps_out,
                         output_keys=["radial_embedding"])
        num_basis = Irreps(self.irreps_out["radial_embedding"])[0].mul
        self.basis = BesselBasis(r_max, r_min, num_basis, trainable,
                                 one_over_r=one_over_r)
        assert polynomial_degree >= 2.0
        self.p = float(polynomial_degree)
        self.factor = 1.0 / float(r_max)

    def forward(self, data: Dict, attrs: Dict):
        x = data["input"]
        x1 = x[..., 0] if x.dim() == 2 else x
        embedded = self.basis(x1) * poly_cutoff(x1, self.factor,
                                                self.p)[:, None]
        embedded = embedded.reshape(x.shape[0], -1)
        return ({"radial_embedding": embedded},
                {"radial_embedding": (attrs["input"][0],
                                      self.irreps_out["radial_embedding"])})


class SphericalEncoding(Module):
    """Spherical-harmonic projection of (edge) vectors, e3nn's
    ("component", normalize=True) convention."""

    def __init__(self, irreps_out, edge_sh_normalization="component",
                 edge_sh_normalize=True, irreps_in="1x1o"):
        super().__init__()
        self.init_irreps(vectors=irreps_in, spherical_harmonics=irreps_out,
                         output_keys=["spherical_harmonics"])
        self.mul = Irreps(self.irreps_in["vectors"])[0].mul
        ls = []
        for mi in Irreps(self.irreps_out["spherical_harmonics"]):
            assert mi.mul == self.mul
            ls.append(mi.ir.l)
        self.sh = SphericalHarmonics(ls, normalize=edge_sh_normalize,
                                     normalization=edge_sh_normalization)

    def forward(self, data: Dict, attrs: Dict):
        vectors = data["vectors"]
        cat = vectors.shape[0]
        sh = self.sh(vectors.reshape(cat, self.mul, 3)).reshape(cat, -1)
        return ({"spherical_harmonics": sh},
                {"spherical_harmonics": (
                    "edge", self.irreps_out["spherical_harmonics"])})
