"""Edge construction.

- ``computeEdgeIndex`` — host-side numpy radius graph, carried over from
  ``equivariant_nn_zoo_tpu/data/compute_edge.py:51-124`` unchanged.
- ``computeEdgeVector`` — the model layer (a plain callable in the layer
  list) that gathers displacement vectors and lengths in PyTorch.  The
  length has a tiny epsilon so padded zero edges give finite values.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def computeEdgeVector(data: Dict, attrs: Dict, key: str = "pos",
                      with_lengths: bool = True):
    attrs = dict(attrs)
    attrs["edge_vector"] = ("edge", "1x1o")
    attrs["edge_length"] = ("edge", "1x0e")
    data = dict(data)
    if "edge_vector" not in data:
        pos = data[key]
        edge_index = data["edge_index"]
        data["edge_vector"] = pos[edge_index[1]] - pos[edge_index[0]]
    if with_lengths and "edge_length" not in data:
        vec = data["edge_vector"]
        data["edge_length"] = torch.sqrt(
            torch.sum(vec * vec, dim=-1, keepdim=True) + 1e-12)
    return data, attrs


def computeEdgeIndex(data, attrs, r_max: float = None, key: str = "pos",
                     criteria=None):
    """Host-side radius graph (per graph, O(N^2) mask), merging pre-existing
    bonded edges and custom criteria; remaps old edge features to the new
    edge list with zero padding for new edges.

    Operates on dicts of numpy arrays (a Data's tensors).  Returns only the
    new ``edge_index`` (plus ``_n_edges``), with edge features updated
    in-place in ``data``.
    """
    pos = np.asarray(data[key], dtype=np.float64).reshape(-1, 3)
    if "_n_nodes" in data:
        n_nodes_arr = np.asarray(data["_n_nodes"]).reshape(-1).astype(np.int64)
    else:  # a single graph
        n_nodes_arr = np.array([pos.shape[0]], dtype=np.int64)

    # per-graph fully connected candidate edges
    edge_index_lst = []
    cnt = 0
    for n_nodes in n_nodes_arr:
        n = int(n_nodes)
        idx = np.arange(cnt, cnt + n)
        src = np.repeat(idx, n)
        dst = np.tile(idx, n)
        edge_index_lst.append(np.stack([src, dst]))
        cnt += n
    edge_index = np.concatenate(edge_index_lst, axis=1)

    dist = np.linalg.norm(pos[edge_index[0]] - pos[edge_index[1]], axis=-1)
    mask = dist < r_max
    if criteria is not None:
        mask = np.logical_or(mask, np.asarray(criteria(data, edge_index)))
    mask = np.logical_and(mask, edge_index[0] != edge_index[1])

    old_edge_index = data.get("edge_index")

    def edge_positions(old, new):
        """Index of each old edge (2,K) inside new (2,M)."""
        new_keys = new[0] * (new.max() + 1) + new[1]
        old_keys = old[0] * (new.max() + 1) + old[1]
        order = np.argsort(new_keys, kind="stable")
        pos_in_sorted = np.searchsorted(new_keys[order], old_keys)
        return order[pos_in_sorted]

    if old_edge_index is not None:
        old_edge_index = np.asarray(old_edge_index, dtype=np.int64)
        mask[edge_positions(old_edge_index, edge_index)] = True

    new_edge_index = edge_index[:, mask]

    if old_edge_index is not None and old_edge_index.shape[1] > 0:
        edge_map = edge_positions(old_edge_index, new_edge_index)
        for k in list(attrs.keys()):
            if attrs[k][0] == "edge" and k in data:
                tmp = np.asarray(data[k])
                new = np.zeros((new_edge_index.shape[1], tmp.shape[1]),
                               tmp.dtype)
                new[edge_map] = tmp
                data[k] = new

    if "_node_segment" in data:
        n_graphs = len(n_nodes_arr)
        seg = np.asarray(data["_node_segment"]).reshape(-1)
        n_edges = np.bincount(
            seg[new_edge_index[0]], minlength=n_graphs
        ).reshape(-1, 1)
    else:
        n_edges = np.full((len(n_nodes_arr), 1), new_edge_index.shape[1],
                          dtype=np.int64)

    attrs["_n_edges"] = ("graph", "1x0e")
    data["_n_edges"] = n_edges

    out = {"edge_index": new_edge_index.astype(np.int64)}
    return out, attrs
