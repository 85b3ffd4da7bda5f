"""Edge construction.

- ``computeEdgeIndex`` — host-side numpy radius graph, carried over from
  ``equivariant_nn_zoo_tpu/data/compute_edge.py:51-124`` unchanged.
- ``computeEdgeVector`` — the model layer (a plain callable in the layer
  list) that gathers displacement vectors and lengths in PyTorch.  The
  length has a tiny epsilon so padded zero edges give finite values.
- ``computeEdgeIndexDevice`` — the model layer that rebuilds the radius
  graph from the current positions on the batch's device, into the static
  ``[2, edge_capacity]`` buffer of the incoming ``edge_index``
  (``radius_graph_fixed``), with optional extra edges
  (``chain_criteria_device``: a protein's sequence neighbours plus
  random long-range pairs).  It reads nothing back to the host, so the
  samplers of the protein configs rebuild the graph in every score
  evaluation without waiting on the device.
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


class EdgeRandom:
    """The uniform draws of the in-model edge criteria where the batch
    carries none (``_edge_rand``): one ``torch.Generator`` per device,
    seeded with ``seed``, made at its first draw there."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.generators = {}

    def uniform(self, shape, device) -> torch.Tensor:
        device = torch.device(device)
        gen = self.generators.get(device)
        if gen is None:
            gen = torch.Generator(device).manual_seed(self.seed)
            self.generators[device] = gen
        return torch.rand(tuple(shape), generator=gen, device=device)


def computeEdgeIndexDevice(data, attrs, r_max: float = None,
                           key: str = "pos", criteria=None,
                           rand: EdgeRandom = None):
    """The radius graph of ``data[key]`` as a model layer: ``edge_index``
    ``[2, E]`` (E, the capacity, is the incoming ``edge_index``'s),
    ``_edge_mask``, ``_edge_segment``, ``_n_edges`` and ``_edge_overflow``
    (the edges dropped past the capacity, per graph; 0 when it holds).

    ``criteria(data, rand) -> [N, N] bool`` adds edges; ``rand`` is the
    batch's ``_edge_rand`` ``[N, N]`` when it carries one, else a draw of
    ``rand`` (an ``EdgeRandom``) on the positions' device.  Counterpart of
    the JAX function, whose draw comes from ``_edge_rng`` or a key folded
    with ``t`` (``compute_edge.py:127-184``)."""
    pos = data[key]
    n = pos.shape[0]
    g = data["_graph_mask"].shape[0]
    capacity = data["edge_index"].shape[-1]
    extra = None
    if criteria is not None:
        u = data.get("_edge_rand")
        if u is None:
            if rand is None:
                raise ValueError("edge criteria need the batch's _edge_rand "
                                 "or a source of draws (rand)")
            u = rand.uniform((n, n), pos.device)
        extra = criteria(data, u)
    edge_index, edge_mask, edge_segment, n_candidates = radius_graph_fixed(
        pos, data["_node_segment"], data["_node_mask"], capacity, r_max,
        n - 1, extra_mask=extra)
    n_edges = torch.zeros(g + 1, dtype=torch.int64, device=pos.device)
    n_edges = n_edges.index_add(0, edge_segment,
                                edge_mask[:, 0].to(torch.int64))[:g, None]
    overflow = (n_candidates - capacity).clamp(min=0)
    attrs = dict(attrs)
    attrs["_n_edges"] = ("graph", "1x0e")
    attrs["_edge_overflow"] = ("graph", "1x0e")
    return {"edge_index": edge_index, "_edge_mask": edge_mask,
            "_edge_segment": edge_segment, "_n_edges": n_edges,
            "_edge_overflow": overflow.expand(g, 1).clone()}, attrs


def chain_criteria_device(data, rand: torch.Tensor, window: int = 5,
                          p_random: float = 0.02) -> torch.Tensor:
    """A protein's extra edges ``[N, N]``: pairs of one chain less than
    ``window`` residues apart (by ``id`` when the batch has it, else by
    node index), or with ``rand < p_random``."""
    chain = data["chain_id"].reshape(-1)
    idv = data["id"].reshape(-1) if "id" in data else torch.arange(
        chain.shape[0], device=chain.device)
    same_chain = chain[:, None] == chain[None, :]
    near = torch.abs(idv[:, None] - idv[None, :]) < window
    return (same_chain & near) | (rand < p_random)


def radius_graph_fixed(pos, node_segment, node_mask, edge_capacity: int,
                       r_max: float, dummy_node: int, extra_mask=None):
    """All pairs (i, j) of one graph, both live, i != j, with
    ``|pos_j - pos_i|^2 < r_max^2`` or ``extra_mask[i, j]``, packed in pair
    order (source-major) into ``edge_capacity`` slots; the pairs past the
    capacity are dropped, and the free slots point at ``dummy_node``.
    Returns ``(edge_index [2, E] int64, edge_mask [E, 1] float32,
    edge_segment [E], n_candidates)``, the last a 0-dim tensor; nothing is
    read back to the host (the pair order by a running count over the
    flattened mask, searched for each slot: the JAX function's stable-sort
    order)."""
    n = pos.shape[0]
    diff = pos[None, :, :] - pos[:, None, :]
    sq = diff * diff
    dist2 = sq[..., 0] + sq[..., 1] + sq[..., 2]   # one order on every device
    same_graph = node_segment[:, None] == node_segment[None, :]
    live = node_mask[:, 0] > 0
    allowed = same_graph & live[:, None] & live[None, :] & ~torch.eye(
        n, dtype=torch.bool, device=pos.device)
    mask = allowed & (dist2 < r_max * r_max)
    if extra_mask is not None:
        mask = mask | (extra_mask & allowed)
    flat = mask.reshape(-1)
    # slot s takes the first pair with s + 1 pairs up to it, or none
    count = torch.cumsum(flat, 0)
    take = torch.searchsorted(count, torch.arange(
        1, edge_capacity + 1, device=pos.device))
    ok = take < n * n
    src = torch.where(ok, take // n, dummy_node)
    dst = torch.where(ok, take % n, dummy_node)
    edge_mask = ok.to(torch.float32)[:, None]
    return (torch.stack([src, dst]), edge_mask, node_segment[src],
            flat.sum())
