"""Hamiltonian-matrix prediction for H2O (ORCA convention), as a plain dict.

Counterpart of ``equivariant_nn_zoo_tpu/models/config_hamiltonian.py``: the
same model (n_dim 64, l_max 4, r_max 4.0, 5 layers, edge SH
1x0e+1x1o+1x2e+1x3o, 8x0e radial basis, 8x0e node attributes, 9 species,
the pairwise head with ``3x0e+2x1o+1x2e`` blocks on both sides), the
e3nn-to-ORCA basis transform, ``contractBasis`` and the same training,
early-stopping and data settings.
"""

from functools import lru_cache, partial

import numpy as np
import torch

from ..data.compute_edge import computeEdgeIndex
from ..utils.utils import default_type_names
from .layer_configs import addMatrixOutput, featureModel


def _direct_sum(*blocks):
    n = sum(b.shape[0] for b in blocks)
    out = np.zeros((n, n), dtype=np.float32)
    i = 0
    for b in blocks:
        k = b.shape[0]
        out[i: i + k, i: i + k] = b
        i += k
    return out


def orca_transform_matrix():
    """Change of basis from the package's real-irrep convention to ORCA's
    orbital ordering for the H2O basis (3s2p1d on O, 2s1p on each H); the
    l = 1 components are (x, y, z) here."""
    S = np.ones((1, 1), np.float32)
    # ORCA p order (pz, px, py) from (x, y, z)
    P = np.array([[0, 0, 1.0], [1, 0, 0], [0, 1, 0]], np.float32)
    # ORCA d order from the real l = 2 components (m = -2..2)
    D = np.array(
        [
            [0, 1, 0, 0, 0.0],
            [0, 0, 0, 0, 1],
            [-0.5, 0, 0, -((3 / 4) ** 0.5), 0],
            [0, 0, 1, 0, 0],
            [((3 / 4) ** 0.5), 0, 0, -0.5, 0],
        ],
        np.float32,
    )
    return _direct_sum(S, S, S, P, P, D, S, S, P, S, S, P)


@lru_cache(maxsize=None)
def _orca_matrix(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``orca_transform_matrix`` on ``device``, made once: a copy from the
    host in every forward could not be captured into a CUDA graph."""
    return torch.as_tensor(orca_transform_matrix(), dtype=dtype,
                           device=device)


def transform(result: torch.Tensor) -> torch.Tensor:
    """The hamiltonian from the internal irrep basis to ORCA's."""
    M = _orca_matrix(result.device, result.dtype)
    return M.T @ result @ M


def contractBasis(data, attrs):
    """Fill the molecular hamiltonian ``[graphs, 576]`` from the atom and
    atom-pair blocks, removing the padding basis.  H2O-specific: on the
    padded batch the first ``3 * G`` node rows and ``6 * G`` edge rows are
    the atoms and pairs in graph order, pair (i, j) at row
    ``{(0,1): 0, (0,2): 1, (1,0): 2, (1,2): 3, (2,0): 4, (2,1): 5}`` (edges
    sorted by source, then destination; the block's left side is the edge's
    destination).  Padded graphs give rows that the graph mask removes."""
    g = data["_graph_mask"].shape[0]
    diagonal = data["hamiltonian_diagonal"]
    off = data["hamiltonian_off"]
    orbitals = [(0, 0, 3), (0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 1, 1),
                (2, 0, 2), (2, 1, 1)]
    dic = {(0, 1): 0, (0, 2): 1, (1, 0): 2, (1, 2): 3, (2, 0): 4, (2, 1): 5}
    full = [3, 2, 1]  # padded basis multiplicities per degree
    rows = []
    for i, degree_i, mul_i in orbitals:
        p_l = "e" if degree_i % 2 == 0 else "o"
        dim_l = mul_i * (2 * degree_i + 1)
        full_dim_l = full[degree_i] * (2 * degree_i + 1)
        row = []
        for j, degree_j, mul_j in orbitals:
            p_r = "e" if degree_j % 2 == 0 else "o"
            dim_r = mul_j * (2 * degree_j + 1)
            full_dim_r = full[degree_j] * (2 * degree_j + 1)
            key = (f"{full[degree_i]}x{degree_i}{p_l}*"
                   f"{full[degree_j]}x{degree_j}{p_r}")
            if i == j:
                H = diagonal[key][: 3 * g].reshape(g, 3, full_dim_l,
                                                   full_dim_r)
                H = H[:, i, :dim_l, :dim_r]
            else:
                H = off[key][: 6 * g].reshape(g, 6, full_dim_l, full_dim_r)
                H = H[:, dic[(i, j)], :dim_l, :dim_r]
            row.append(H)
        rows.append(torch.cat(row, dim=2))
    result = torch.cat(rows, dim=1)
    assert result.shape[1:] == (24, 24)
    result = (result + result.transpose(1, 2)) / 2
    result = transform(result).reshape(g, -1)
    attrs = dict(attrs)
    attrs["hamiltonian"] = ("graph", 576)
    return {"hamiltonian": result}, attrs


def get_config():
    num_types = 9
    r_max = 4.0
    model = dict(n_dim=64, l_max=4, r_max=r_max, num_layers=5,
                 node_attrs="8x0e")
    layer_configs = addMatrixOutput(featureModel(
        n_dim=model["n_dim"], l_max=model["l_max"],
        edge_spherical="1x0e+1x1o+1x2e+1x3o", node_attrs=model["node_attrs"],
        edge_radial="8x0e", num_types=num_types,
        num_layers=model["num_layers"], r_max=r_max,
    ), "3x0e+2x1o+1x2e", "3x0e+2x1o+1x2e")
    layer_configs["layers"].append(("hamiltonian", contractBasis))
    model.update(layer_configs)
    data = dict(
        n_train=500, n_val=500, train_val_split="random", shuffle=True,
        path="h2o.hdf5", type_names=default_type_names(num_types),
        preprocess=[partial(computeEdgeIndex, r_max=r_max)],
        cache_preprocessed=True, num_workers=4,
    )
    return dict(
        model_config=model, data_config=data, batch_size=16,
        epoch_subdivision=1, learning_rate=1e-2, use_ema=True,
        ema_decay=0.99, ema_use_num_updates=True,
        metric_key="validation_loss", max_epochs=int(1e6),
        early_stopping_patiences={"validation_loss": 20},
        early_stopping_lower_bounds={"LR": 1e-6},
        loss_coeffs={"hamiltonian": [1e5, "MSELoss"]},
        metrics_components={"hamiltonian": ["mae"]},
        optimizer_name="Adam", lr_scheduler_name="ReduceLROnPlateau",
        lr_scheduler_patience=8, lr_scheduler_factor=0.8,
    )
