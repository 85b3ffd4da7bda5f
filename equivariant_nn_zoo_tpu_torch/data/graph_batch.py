"""GraphBatch — a batch of graphs padded to static capacities, as tensors.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/data/graph_batch.py`` with
its padded layout only (no tile-aligned ``edge_tile`` layout, no wire
format):

- nodes:  ``[node_capacity, d]`` with the LAST slot reserved as a dummy node;
- edges:  ``[edge_capacity, ...]``; padded edges point src = dst = dummy
  node, so gathers read inert values and scatters land in the dummy row;
- graphs: ``[n_graphs, d]`` plus a ``_graph_mask`` (a batch may carry fewer
  real graphs);
- ``_node_segment`` / ``_edge_segment`` map into ``n_graphs + 1`` segments,
  the last being the padding segment (dropped after each segment sum);
- masks are float ``[*, 1]``.

The numpy packing is the JAX package's; floats become float32 tensors and
integers int64 tensors (PyTorch's index type) on the requested device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .batch import Batch


class GraphBatch:
    __slots__ = ("data", "attrs", "n_graphs", "node_capacity",
                 "edge_capacity", "dropped")

    def __init__(self, data, attrs, n_graphs, node_capacity, edge_capacity,
                 dropped: int = 0):
        self.data: Dict[str, torch.Tensor] = data
        self.attrs: Dict[str, Tuple[str, str]] = attrs
        self.n_graphs = n_graphs
        self.node_capacity = node_capacity
        self.edge_capacity = edge_capacity
        # graphs that did not fit the capacities when this batch was padded
        self.dropped = dropped

    def __getitem__(self, key):
        return self.data[key]

    def __contains__(self, key):
        return key in self.data

    def keys(self):
        return self.data.keys()

    def replace(self, **updates) -> "GraphBatch":
        data = dict(self.data)
        data.update(updates)
        return GraphBatch(data, dict(self.attrs), self.n_graphs,
                          self.node_capacity, self.edge_capacity,
                          self.dropped)

    def _map(self, fn) -> "GraphBatch":
        def move(v):
            # a head may leave a dict of tensors (the hamiltonian blocks)
            if isinstance(v, dict):
                return {k: move(t) for k, t in v.items()}
            return fn(v)

        return GraphBatch({k: move(v) for k, v in self.data.items()},
                          dict(self.attrs), self.n_graphs,
                          self.node_capacity, self.edge_capacity,
                          self.dropped)

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        """Every tensor on ``device``; with ``non_blocking`` a copy from
        pinned host memory runs asynchronously on the current stream."""
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "GraphBatch":
        """Every host tensor in page-locked memory (needs CUDA)."""
        return self._map(lambda t: t.pin_memory())

    @classmethod
    def from_batch(cls, batch: Batch, node_capacity: int, edge_capacity: int,
                   n_graphs: int = None, device="cuda") -> "GraphBatch":
        """Pad a host Batch to static capacities.

        Graphs that don't fit the capacities are dropped from the tail and
        the count is recorded in ``.dropped``.
        """
        batch.computeCumsums()
        g_total = batch.n_graphs
        n_graphs = g_total if n_graphs is None else n_graphs

        n_nodes = batch.data["_n_nodes"][:, 0].astype(np.int64)
        has_edges = "_n_edges" in batch.data
        n_edges = (batch.data["_n_edges"][:, 0].astype(np.int64)
                   if has_edges else np.zeros(g_total, np.int64))
        # how many graphs fit (one node slot reserved for the dummy node)
        g_keep = 0
        nodes_used = edges_used = 0
        for i in range(min(g_total, n_graphs)):
            if (nodes_used + n_nodes[i] <= node_capacity - 1
                    and edges_used + n_edges[i] <= edge_capacity):
                nodes_used += int(n_nodes[i])
                edges_used += int(n_edges[i])
                g_keep += 1
            else:
                break
        dropped = min(g_total, n_graphs) - g_keep

        N, E, G = node_capacity, edge_capacity, n_graphs
        dummy = N - 1
        data: Dict[str, np.ndarray] = {}
        node_seg = np.full((N,), G, dtype=np.int64)
        node_seg[:nodes_used] = batch.nodeSegment()[:nodes_used]
        data["_node_segment"] = node_seg
        edge_seg = np.full((E,), G, dtype=np.int64)
        if has_edges:
            edge_seg[:edges_used] = batch.edgeSegment()[:edges_used]
        data["_edge_segment"] = edge_seg
        for key, rows, used in (("_node_mask", N, nodes_used),
                                ("_edge_mask", E, edges_used),
                                ("_graph_mask", G, g_keep)):
            mask = np.zeros((rows, 1), np.float32)
            mask[:used] = 1.0
            data[key] = mask

        def pad_to(a, rows):
            out = np.zeros((rows,) + a.shape[1:], dtype=a.dtype)
            out[: min(len(a), rows)] = a[: min(len(a), rows)]
            return out

        if "edge_index" not in batch.data:
            # no host-side edges: empty buffers at capacity, for a model
            # layer that builds the edges on the device
            # (computeEdgeIndexDevice) to fill
            data["edge_index"] = np.full((2, E), dummy, dtype=np.int64)
            data["_n_edges"] = np.zeros((G, 1), np.int64)

        for key, value in batch.data.items():
            if key in ("_node_segment", "_edge_segment"):
                continue
            if key == "edge_index":
                ei = np.full((2, E), dummy, dtype=np.int64)
                ei[:, :edges_used] = value[:, :edges_used]
                data[key] = ei
                continue
            per = batch.attrs.get(key, ("graph",))[0]
            if np.issubdtype(value.dtype, np.floating):
                value = value.astype(np.float32)
            elif np.issubdtype(value.dtype, np.integer):
                value = value.astype(np.int64)
            if per == "node":
                data[key] = pad_to(value[:nodes_used], N)
            elif per == "edge":
                data[key] = pad_to(value[:edges_used], E)
            else:  # graph
                data[key] = pad_to(value[:g_keep], G)

        tensors = {k: torch.as_tensor(v).to(device) for k, v in data.items()}
        return cls(tensors, dict(batch.attrs), G, N, E, dropped=dropped)

    def to_batch(self) -> Batch:
        """Trim padding and return a host-side numpy Batch.  Entries that
        are not tensors (a head's dict of blocks) are left out."""
        data = {k: v.detach().cpu().numpy() for k, v in self.data.items()
                if isinstance(v, torch.Tensor)}
        g = int(data["_graph_mask"][:, 0].sum())
        n_sel = data["_node_mask"][:, 0] > 0
        e_sel = data["_edge_mask"][:, 0] > 0
        out = {}
        for key, value in data.items():
            if key.startswith("_") and key not in ("_n_nodes", "_n_edges"):
                continue
            if key == "edge_index":
                out[key] = value[:, e_sel]
                continue
            per = self.attrs.get(key, ("graph",))[0]
            if per == "node":
                out[key] = value[n_sel]
            elif per == "edge":
                out[key] = value[e_sel]
            else:
                # a copy: on the CPU ``numpy()`` shares the tensor's memory,
                # which a captured step's next replay would overwrite
                out[key] = value[:g].copy()
        return Batch(dict(self.attrs), **out)
