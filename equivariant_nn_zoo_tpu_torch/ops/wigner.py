"""SO(3)/O(3) representation tables: generators, Wigner D, Clebsch-Gordan.

Replaces e3nn's ``o3.wigner_3j`` / ``D_from_matrix`` machinery (used by the
reference at e3_layers/nn/output.py:170-172 and for equivariance testing at
e3_layers/run/trainer.py:334-356).  All of this is *host-side numpy* computed
once per (l1, l2, l3) and cached; the resulting constant tables become
module buffers.  Carried over from the JAX package unchanged (numpy only).

Construction is self-consistent by design:

- ``l=1`` real generators are the cross-product matrices, so the Wigner
  matrix of a rotation R on ``l=1`` is R itself (positions are irreps).
- ``l != 1`` real generators come from the complex su(2) generators
  conjugated into the real spherical-harmonic basis.
- Clebsch-Gordan tensors are computed as the (unique) null space of the
  infinitesimal-invariance constraint built from those same generators, so
  equivariance holds exactly for every op derived from these tables.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


# ---------------------------------------------------------------------------
# complex su(2) generators and the real/complex basis change
# ---------------------------------------------------------------------------


def su2_generators(l: int) -> np.ndarray:
    """Return (Jx, Jy, Jz) for spin ``l`` in the |l, m> basis, m = -l..l."""
    m = np.arange(-l, l + 1)
    # raising operator <m+1|J+|m> = sqrt(l(l+1) - m(m+1))
    raising = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    c = np.sqrt(l * (l + 1) - m[:-1] * (m[:-1] + 1))
    raising[np.arange(1, 2 * l + 1), np.arange(0, 2 * l)] = c
    lowering = raising.conj().T
    jx = 0.5 * (raising + lowering)
    jy = -0.5j * (raising - lowering)
    jz = np.diag(m.astype(np.complex128))
    return np.stack([jx, jy, jz])


def change_basis_real_from_complex(l: int) -> np.ndarray:
    """Unitary U with Y_real = U @ Y_complex (Condon-Shortley phases)."""
    d = 2 * l + 1
    q = np.zeros((d, d), dtype=np.complex128)
    for m in range(-l, 0):
        q[l + m, l + abs(m)] = 1 / np.sqrt(2) * 1j
        q[l + m, l - abs(m)] = -1j / np.sqrt(2) * (-1) ** m
    q[l, l] = 1
    for m in range(1, l + 1):
        q[l + m, l + abs(m)] = 1 / np.sqrt(2) * (-1) ** m
        q[l + m, l - abs(m)] = 1 / np.sqrt(2)
    return q


@lru_cache(maxsize=None)
def so3_generators(l: int) -> np.ndarray:
    """Real antisymmetric generators (Gx, Gy, Gz) of SO(3) acting on the
    real degree-l space, with [Ga, Gb] = eps_abc Gc and, for l=1, the
    cross-product matrices (basis order x, y, z)."""
    if l == 1:
        g = np.zeros((3, 3, 3))
        eps = np.zeros((3, 3, 3))
        eps[0, 1, 2] = eps[1, 2, 0] = eps[2, 0, 1] = 1
        eps[0, 2, 1] = eps[2, 1, 0] = eps[1, 0, 2] = -1
        for a in range(3):
            g[a] = -eps[a]
        return g
    j = su2_generators(l)
    u = change_basis_real_from_complex(l)
    g = np.einsum("ij,ajk,kl->ail", u, -1j * j, u.conj().T)
    assert np.abs(g.imag).max() < 1e-9, f"generators not real for l={l}"
    g = g.real
    # sanity: antisymmetric + commutation relations
    assert np.abs(g + np.swapaxes(g, -1, -2)).max() < 1e-9
    comm = g[0] @ g[1] - g[1] @ g[0]
    assert np.abs(comm - g[2]).max() < 1e-8, f"bad commutator for l={l}"
    return g


# ---------------------------------------------------------------------------
# Wigner D matrices
# ---------------------------------------------------------------------------


def _expm(a: np.ndarray) -> np.ndarray:
    """Matrix exponential via scaling-and-squaring with Taylor series
    (avoids a scipy dependency; matrices here are tiny)."""
    n = 0
    norm = np.linalg.norm(a, ord=np.inf)
    while norm > 0.5:
        a = a / 2.0
        norm /= 2.0
        n += 1
    out = np.eye(a.shape[0])
    term = np.eye(a.shape[0])
    for k in range(1, 20):
        term = term @ a / k
        out = out + term
    for _ in range(n):
        out = out @ out
    return out


def matrix_to_axis_angle(r: np.ndarray):
    """Rotation matrix (det +1) -> (axis[3], angle)."""
    tr = np.trace(r)
    cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    angle = float(np.arccos(cos))
    if angle < 1e-7:
        return np.array([0.0, 0.0, 1.0]), 0.0
    if np.pi - angle < 1e-5:
        # near pi: axis from the symmetric part
        b = (r + np.eye(3)) / 2.0
        axis = np.sqrt(np.clip(np.diag(b), 0.0, None))
        k = int(np.argmax(axis))
        axis = b[:, k] / max(axis[k], 1e-12)
        axis = axis / np.linalg.norm(axis)
        return axis, angle
    axis = np.array(
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]
    ) / (2.0 * np.sin(angle))
    return axis, angle


@lru_cache(maxsize=None)
def _wigner_d_cached(l: int, key: tuple) -> np.ndarray:
    r = np.array(key).reshape(3, 3)
    axis, angle = matrix_to_axis_angle(r)
    g = so3_generators(l)
    return _expm(angle * np.einsum("a,aij->ij", axis, g))


def wigner_d(l: int, r: np.ndarray) -> np.ndarray:
    """Wigner matrix of the proper rotation ``r`` on the real degree-l space."""
    r = np.asarray(r, dtype=np.float64)
    return _wigner_d_cached(l, tuple(np.round(r, 12).reshape(-1)))


def irrep_d(l: int, p: int, m: np.ndarray) -> np.ndarray:
    """Wigner matrix of an arbitrary O(3) element (det ±1) on irrep (l, p)."""
    m = np.asarray(m, dtype=np.float64)
    det = np.linalg.det(m)
    if det < 0:
        return p * wigner_d(l, -m)
    return wigner_d(l, m)


def irreps_d(irreps, m: np.ndarray) -> np.ndarray:
    """Block-diagonal Wigner matrix for a full Irreps on an O(3) element.

    Reference parity: ``e3nn.o3.Irreps.D_from_matrix`` as used by
    e3_layers/run/trainer.py:345 and e3_layers/utils/utils.py:63-66.
    """
    from .irreps import Irreps

    irreps = Irreps(irreps)
    blocks = []
    for mi in irreps:
        d = irrep_d(mi.ir.l, mi.ir.p, m)
        for _ in range(mi.mul):
            blocks.append(d)
    out = np.zeros((irreps.dim, irreps.dim))
    i = 0
    for b in blocks:
        n = b.shape[0]
        out[i : i + n, i : i + n] = b
        i += n
    return out


def rand_matrix(rng=None) -> np.ndarray:
    """Uniform random rotation matrix (host-side; for tests/equivariance)."""
    rng = np.random.default_rng() if rng is None else rng
    q = rng.normal(size=4)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


# ---------------------------------------------------------------------------
# Clebsch-Gordan coefficients
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real Wigner-3j tensor C[i, j, k] with unit Frobenius norm.

    The unique (up to sign) rotation-invariant tensor in l1 x l2 x l3,
    found as the null space of the infinitesimal-invariance constraint.
    Deterministic sign: the largest-magnitude entry is positive.

    Reference parity: ``e3nn.o3.wigner_3j`` (e3_layers/nn/output.py:170-172).
    """
    if not abs(l1 - l2) <= l3 <= l1 + l2:
        return np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    g1, g2, g3 = so3_generators(l1), so3_generators(l2), so3_generators(l3)
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    n = d1 * d2 * d3
    eye1, eye2, eye3 = np.eye(d1), np.eye(d2), np.eye(d3)
    rows = []
    for a in range(3):
        m = (
            np.einsum("ix,jy,kz->ijkxyz", g1[a], eye2, eye3)
            + np.einsum("ix,jy,kz->ijkxyz", eye1, g2[a], eye3)
            + np.einsum("ix,jy,kz->ijkxyz", eye1, eye2, g3[a])
        )
        rows.append(m.reshape(n, n))
    m = np.concatenate(rows, axis=0)
    # null space via the symmetric normal matrix — more robust than SVD for
    # the larger high-l constraint systems (and mathematically identical)
    w, v = np.linalg.eigh(m.T @ m)
    k = int((w < 1e-9).sum())
    assert k == 1, f"CG null space dim {k} != 1 for ({l1},{l2},{l3})"
    c = v[:, 0].reshape(d1, d2, d3)
    # deterministic sign fix
    flat = c.reshape(-1)
    idx = int(np.argmax(np.abs(flat)))
    if flat[idx] < 0:
        c = -c
    c = c / np.linalg.norm(c)
    return c


@lru_cache(maxsize=None)
def cg_component(l1: int, l2: int, l3: int) -> np.ndarray:
    """CG tensor scaled so unit-component-variance inputs give
    unit-component-variance outputs: wigner_3j * sqrt(2*l3 + 1)."""
    return wigner_3j(l1, l2, l3) * np.sqrt(2 * l3 + 1)
