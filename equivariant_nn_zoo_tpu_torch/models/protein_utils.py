"""Protein preprocessing helpers shared by the protein diffusion configs:
masked-to-indexed residue compaction, the spatial crop to at most
``max_nodes`` residues (a binary search over the radius around a random
residue), and the host form of the sparse-edge criteria (the device form
is ``data.compute_edge.chain_criteria_device``).

A numpy-only copy of ``equivariant_nn_zoo_tpu/models/protein_utils.py`` on
the port's ``Batch``.
"""

from __future__ import annotations

import numpy as np

from ..data.batch import Batch


def masked2indexed(batch, atoms=("N", "CA", "C", "O")):
    """Drop masked residues, keep original indices under ``id``.

    Reference parity: config_diffusion_CA.py:11-24.
    """
    data = {}
    n = int(np.asarray(batch["_n_nodes"]).reshape(-1)[0])
    idx = np.arange(n)
    mask = np.asarray(batch["mask"]).reshape(-1).astype(bool)
    data["id"] = idx[mask].reshape(-1, 1)
    data["_n_nodes"] = np.array([[int(mask.sum())]], np.int64)
    data["species"] = np.asarray(batch["species"])[mask]
    data["chain_id"] = np.asarray(batch["chain_id"])[mask]
    attrs = {"id": ("node", "1x0e")}
    for atom in atoms:
        if atom in batch.keys():
            data[atom] = np.asarray(batch[atom])[mask]
    attrs.update(batch.attrs)
    return Batch(attrs, **data)


def crop(data, attrs, max_nodes, keep_atoms=("CA",), rng=None):
    """Spatial crop to <= max_nodes via binary-search radius around a random
    center.  Reference parity: config_diffusion_CA.py:26-56.
    """
    rng = np.random.default_rng() if rng is None else rng
    drop = [a for a in ["N", "C", "O"] if a not in keep_atoms]
    for key in drop:
        data.pop(key, None)
        attrs.pop(key, None)
    n = int(np.asarray(data["_n_nodes"]).reshape(-1)[0])
    if n <= max_nodes:
        return data, attrs
    x = int(rng.integers(n))
    ca = np.asarray(data["CA"]).reshape(-1, 3)
    distance = np.linalg.norm(ca - ca[x], axis=-1)

    def binary_search(r_min, r_max):
        if r_max - r_min < 0.5:
            return r_min
        mid = (r_min + r_max) / 2
        cnt = int((distance < mid).sum())
        if cnt > max_nodes:
            return binary_search(r_min, mid)
        if cnt < max_nodes:
            return binary_search(mid, r_max)
        return mid

    r = binary_search(20, 70)
    mask = distance < r
    data["_n_nodes"] = np.array([[int(mask.sum())]], np.int64)
    for key in ["id", "species", "chain_id"] + list(keep_atoms):
        if key in data:
            data[key] = np.asarray(data[key])[mask]
    return data, attrs


def criteria(data, edge_index, window: int = 5, p_random: float = 0.02,
             rng=None):
    """Host-side sparse-edge criteria: same-chain sequence neighbors plus
    stochastic long-range.  Reference parity: config_diffusion_CA.py:58-64.
    """
    rng = np.random.default_rng() if rng is None else rng
    chain = np.asarray(data["chain_id"]).reshape(-1)
    mask = chain[edge_index[0]] == chain[edge_index[1]]
    mask = np.logical_and(mask, np.abs(edge_index[0] - edge_index[1]) < window)
    mask = np.logical_or(mask, rng.random(edge_index.shape[1]) < p_random)
    return mask
