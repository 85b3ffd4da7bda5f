"""Infer the irreps content and the change of basis of matrix-valued data.

PyTorch package's counterpart of ``examples/infer_representation.py``.
Given samples of a representation M(g) = Q D(g) Q^T of an unknown
decomposition, count each irrep's multiplicity from the character inner
product and find the change of basis by a null-space solve of the
commutation constraint M(g) Q = Q D(g) against the known Wigner matrices.

A host script: numpy only, on this package's ``ops.wigner.irreps_d`` and
``rand_matrix``; it runs no kernel.

Usage:

    python -m equivariant_nn_zoo_tpu_torch.examples.infer_representation
"""

from __future__ import annotations

import numpy as np

from ..ops import Irreps, irreps_d, rand_matrix


def infer_change_of_basis(samples_in, samples_out, irreps):
    """Find Q with samples_out[i] ~= Q @ samples_in[i] for all i, where both
    transform under ``irreps``: solve the linear system in lstsq sense and
    report the residual."""
    A = np.concatenate([np.kron(np.eye(1), s.T) for s in samples_in])
    B = np.concatenate([s for s in samples_out])
    Q, *_ = np.linalg.lstsq(A, B, rcond=None)
    Q = Q.T
    resid = max(
        np.abs(Q @ si - so).max() for si, so in zip(samples_in, samples_out)
    )
    return Q, resid


def infer_irrep_content(transform_samples, max_l=3):
    """Given pairs (g, M(g)) of a representation matrix-valued function,
    count each irrep's multiplicity from the trace (character) inner
    product: mul_l = <chi_M, chi_l>."""
    counts = {}
    for l in range(max_l + 1):
        acc = 0.0
        for g, M in transform_samples:
            chi_M = np.trace(M)
            chi_l = np.trace(irreps_d(Irreps(f"1x{l}e"), g))
            acc += chi_M * chi_l
        counts[l] = acc / len(transform_samples)
    return counts


def main(n_samples: int = 4000, seed: int = 0, log=print):
    """The example: returns ``(counts, commutant dimension, intertwiner
    residual)``."""
    rng = np.random.default_rng(seed)
    irreps = Irreps("1x0e+1x1o+1x2e")
    # hidden change of basis
    d = irreps.dim
    Q_true, _ = np.linalg.qr(rng.normal(size=(d, d)))
    gs = [rand_matrix(rng) for _ in range(n_samples)]
    # the unknown representation: M(g) = Q D(g) Q^T
    samples = [(g, Q_true @ irreps_d(irreps, g) @ Q_true.T) for g in gs]

    counts = infer_irrep_content(samples, max_l=3)
    if log:
        log("estimated multiplicity per degree (expect ~1,1,1,0):")
        for l, c in counts.items():
            log(f"  l={l}: {c:.2f}")

    # recover the change of basis: find Q with M(g) Q = Q D(g)
    rows = []
    for g, M in samples:
        D = irreps_d(irreps, g)
        # row-major vec: vec(M Q) = (M ⊗ I) vec(Q), vec(Q D) = (I ⊗ D^T) vec(Q)
        rows.append(np.kron(M, np.eye(d)) - np.kron(np.eye(d), D.T))
    A = np.concatenate(rows)
    _, s, vh = np.linalg.svd(A, full_matrices=False)
    null_dim = int((s < 1e-8).sum())
    Q_est = vh[-1].reshape(d, d)
    # verify it intertwines
    g = rand_matrix(rng)
    M = Q_true @ irreps_d(irreps, g) @ Q_true.T
    err = np.abs(M @ Q_est - Q_est @ irreps_d(irreps, g)).max()
    if log:
        log(f"commutant dimension: {null_dim} (= sum of squared "
            "multiplicities of distinct irreps when Q exists)")
        log(f"intertwiner residual: {err:.2e}")
    return counts, null_dim, err


if __name__ == "__main__":
    main()
