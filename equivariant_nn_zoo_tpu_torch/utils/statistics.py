"""Per-species statistics solver (Gaussian-process regression with
auto-escalating jitter) and batched bincount.

A numpy-only copy of ``equivariant_nn_zoo_tpu/utils/statistics.py``.

Reference parity: e3_layers/utils/statistics.py (C16 in SURVEY.md §2).  The
reference wraps sklearn's GaussianProcessRegressor with a NormalizedDotProduct
kernel and retries with growing ``alpha``; here the same normalized-dot-product
GP posterior is solved directly with numpy (it is a ridge solve in feature
space), keeping the retry-on-ill-conditioning loop.
"""

from __future__ import annotations

import logging

import numpy as np


def bincount(input: np.ndarray, batch: np.ndarray = None, minlength: int = 0):
    """Per-graph bincount of integer labels.

    Reference parity: statistics.py:184-209. Returns [n_graphs, minlength].
    """
    input = np.asarray(input).reshape(-1)
    if batch is None:
        return np.bincount(input, minlength=minlength)[None]
    batch = np.asarray(batch).reshape(-1)
    minlength = max(minlength, int(input.max()) + 1)
    n_graphs = int(batch.max()) + 1
    flat = batch * minlength + input
    out = np.bincount(flat, minlength=n_graphs * minlength)
    return out.reshape(n_graphs, minlength)


def normalized_gp(X: np.ndarray, y: np.ndarray, alpha: float):
    """GP regression with the NormalizedDotProduct kernel
    k(x, x') = x·x' / diag_norm — reduces to a scaled ridge regression.

    Returns (mean [n_features, y_dim], std scalar).
    """
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    if y.ndim == 1:
        y = y[:, None]
    feature_rms = np.sqrt(np.mean(X**2, axis=0))
    feature_rms = np.nan_to_num(feature_rms, nan=1.0)
    feature_rms[feature_rms == 0] = 1.0
    y_mean = float(np.sum(y) / np.sum(X))
    Xn = X  # kernel normalization folds into the solve below
    A = Xn.T @ Xn + alpha * np.diag(feature_rms**2) * len(Xn)
    rhs = Xn.T @ (y - (X.sum(axis=1, keepdims=True)) * y_mean)
    mean = np.linalg.solve(A, rhs)
    mean = mean + y_mean
    resid = y - X @ mean
    std = float(np.sqrt(np.mean(resid**2)))
    return mean, std


def solver(X, y, alpha: float = 0.001, max_iteration: int = 20, stride: int = 1):
    """Per-species shift regression: y_graph ~ X(counts per species) @ shifts.

    Retries with escalating jitter on ill-conditioned solves.
    Reference parity: statistics.py:9-106.
    """
    X = np.asarray(X, np.float64)[::stride]
    y = np.asarray(y, np.float64)[::stride]
    for i in range(max_iteration):
        try:
            mean, std = normalized_gp(X, y, alpha)
            if np.all(np.isfinite(mean)) and np.isfinite(std):
                return (
                    np.asarray(mean, np.float32),
                    np.asarray(std, np.float32),
                )
            raise np.linalg.LinAlgError("non-finite solve")
        except np.linalg.LinAlgError:
            logging.info(f"GP solve failed with alpha={alpha}; retrying")
            alpha = alpha * 2 if alpha > 0 else 1e-5
    raise RuntimeError("GP solver failed to converge; data may be degenerate")
