"""Real spherical harmonics, evaluated as small dense contractions.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/ops/spherical_harmonics.py``:
the same coefficient tables (built in numpy from the same Clebsch-Gordan
recursion), so the harmonics are equivariant under the same Wigner matrices
as every other op of the port.

Normalizations (matching e3nn's options):
- "component": |Y_l(x)| = sqrt(2l+1) on the unit sphere (the default).
- "norm":      |Y_l(x)| = 1.
- "integral":  component / sqrt(4 pi).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .irreps import Irreps
from .wigner import wigner_3j

_PROBE = np.array([0.2, -0.5, 0.8437]) / np.linalg.norm([0.2, -0.5, 0.8437])


@lru_cache(maxsize=None)
def _sh_coeff(l: int) -> np.ndarray:
    """Coefficient tensor of shape (3,)*l + (2l+1,), component-normalized."""
    if l == 0:
        return np.ones((1,))
    if l == 1:
        return np.sqrt(3.0) * np.eye(3)
    prev = _sh_coeff(l - 1)
    a = np.tensordot(prev, wigner_3j(l - 1, 1, l), axes=[[-1], [0]])
    return a * np.sqrt(2 * l + 1) / np.linalg.norm(_contract(a, l))


def _contract(a: np.ndarray, l: int) -> np.ndarray:
    y = a
    for _ in range(l):
        y = np.tensordot(_PROBE, y, axes=[[0], [0]])
    return y


@lru_cache(maxsize=None)
def _recursion_coeff(l: int) -> np.ndarray:
    """Tensor R with Y_l = R · (Y_{l-1} ⊗ x̂), component normalization."""
    c = wigner_3j(l - 1, 1, l)
    y_prev = _contract(_sh_coeff(l - 1), l - 1)
    y = np.einsum("i,j,ijk->k", y_prev, _PROBE, c)
    return c * np.sqrt(2 * l + 1) / np.linalg.norm(y)


def _degrees(ls):
    if isinstance(ls, int):
        return [ls]
    if isinstance(ls, (str, Irreps)):
        return [mi.ir.l for mi in Irreps(ls) for _ in range(mi.mul)]
    return list(ls)


class SphericalHarmonics(torch.nn.Module):
    """Evaluate real spherical harmonics of degrees ``ls`` at ``[..., 3]``
    points; returns ``[..., sum(2l+1)]``.

    ``normalize`` rescales the input vectors first (safe at x = 0: returns 0
    for l >= 1, so padded zero edges give inert features).
    """

    def __init__(self, ls, normalize: bool = True,
                 normalization: str = "component", eps: float = 1e-12):
        super().__init__()
        self.ls = _degrees(ls)
        self.normalize = normalize
        self.normalization = normalization
        self.eps = eps
        self.max_l = max(self.ls)
        self.register_buffer(
            "a1", torch.tensor(_sh_coeff(1), dtype=torch.float32),
            persistent=False,
        )
        for l in range(2, self.max_l + 1):
            self.register_buffer(
                f"r{l}",
                torch.tensor(_recursion_coeff(l), dtype=torch.float32),
                persistent=False,
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.normalize:
            n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)
                           + self.eps * self.eps)
            x = x / n
        ys = {0: torch.ones(x.shape[:-1] + (1,), dtype=x.dtype,
                            device=x.device)}
        for l in range(1, self.max_l + 1):
            if l == 1:
                ys[1] = x @ self.a1.to(x.dtype)
            else:
                c = getattr(self, f"r{l}").to(x.dtype)
                ys[l] = torch.einsum("...i,...j,ijk->...k", ys[l - 1], x, c)
        outs = []
        for l in self.ls:
            scale = 1.0
            if self.normalization == "norm":
                scale = 1.0 / np.sqrt(2 * l + 1)
            elif self.normalization == "integral":
                scale = 1.0 / np.sqrt(4 * np.pi)
            outs.append(ys[l] * scale if scale != 1.0 else ys[l])
        return torch.cat(outs, dim=-1)


def spherical_harmonics(ls, x: torch.Tensor, normalize: bool = True,
                        normalization: str = "component",
                        eps: float = 1e-12) -> torch.Tensor:
    """Functional form of :class:`SphericalHarmonics`."""
    sh = SphericalHarmonics(ls, normalize, normalization, eps).to(x.device)
    return sh(x)
