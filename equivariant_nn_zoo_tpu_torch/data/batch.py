"""Host-side Batch: many graphs concatenated as one disconnected graph.

Reference parity: e3_layers/data/batch.py (C2 in SURVEY.md §2) — cumsum
bookkeeping, edge_index offsetting, per-graph extraction, segment vectors.
This stays numpy-on-host; ``GraphBatch.from_batch`` produces the padded
device-side view.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Dict, List

import numpy as np

from .data import Data
from ..ops.irreps import irreps_dim


class Batch(Data):
    def __init__(self, attrs=None, **tensors):
        super().__init__(attrs, **tensors)
        if "_n_nodes" in self.data:
            self.nodeSegment()
        if "_n_edges" in self.data:
            self.edgeSegment()

    def computeCumsums(self):
        if "_n_nodes" in self.data and not hasattr(self, "node_cumsum"):
            self.n_graphs = self.data["_n_nodes"].shape[0]
            self.node_cumsum = np.zeros((self.n_graphs + 1,), dtype=np.int64)
            self.node_cumsum[1:] = np.cumsum(self.data["_n_nodes"][:, 0])
            self.n_nodes = int(self.node_cumsum[-1])
        if "_n_edges" in self.data and not hasattr(self, "edge_cumsum"):
            self.n_graphs = self.data["_n_edges"].shape[0]
            self.edge_cumsum = np.zeros((self.n_graphs + 1,), dtype=np.int64)
            self.edge_cumsum[1:] = np.cumsum(self.data["_n_edges"][:, 0])
            self.n_edges = int(self.edge_cumsum[-1])

    @classmethod
    def from_data_list(cls, lst: List, attrs=None) -> "Batch":
        """Concatenate Data/dicts; offsets edge_index by node counts.

        Reference parity: batch.py:38-111.
        """
        attrs = dict(attrs) if attrs else {}
        if lst and isinstance(lst[0], Data):
            for item in lst:
                attrs.update(item.attrs)
        attrs["_n_nodes"] = ("graph", "1x0e")
        attrs["_n_edges"] = ("graph", "1x0e")

        node_key = None
        for key in lst[0].keys():
            if key in attrs and attrs[key][0] == "node":
                node_key = key

        items = [it.data if isinstance(it, Data) else dict(it) for it in lst]
        for item in items:
            if "_n_nodes" not in item:
                assert node_key is not None, "Unable to infer the amount of nodes."
                item["_n_nodes"] = np.full(
                    (1, 1), np.asarray(item[node_key]).shape[0], dtype=np.int64
                )
            else:
                item["_n_nodes"] = np.asarray(item["_n_nodes"]).reshape(-1, 1)
            if "_n_edges" not in item and "edge_index" in item:
                item["_n_edges"] = np.full(
                    (1, 1), np.asarray(item["edge_index"]).shape[-1], dtype=np.int64
                )
            elif "_n_edges" in item:
                item["_n_edges"] = np.asarray(item["_n_edges"]).reshape(-1, 1)

        data: Dict[str, np.ndarray] = {}
        data["_n_nodes"] = np.concatenate([it["_n_nodes"] for it in items])
        if "_n_edges" in items[0]:
            data["_n_edges"] = np.concatenate([it["_n_edges"] for it in items])

        for key in items[0].keys():
            if key in data:
                continue
            if key == "edge_index":
                to_cat = []
                graph_cnt = node_cnt = 0
                for item in items:
                    to_cat.append(np.asarray(item[key], dtype=np.int64) + node_cnt)
                    n_graphs = item["_n_nodes"].shape[0]
                    node_cnt += int(
                        data["_n_nodes"][graph_cnt : graph_cnt + n_graphs].sum()
                    )
                    graph_cnt += n_graphs
                data[key] = np.concatenate(to_cat, axis=-1)
            else:
                arrs = [np.asarray(item[key]) for item in items]
                if key in attrs:
                    dim = irreps_dim(attrs[key][1])
                    arrs = [a.reshape(-1, dim) for a in arrs]
                tmp = np.concatenate(arrs, axis=0)
                if np.issubdtype(tmp.dtype, np.integer):
                    tmp = tmp.astype(np.int64)
                elif np.issubdtype(tmp.dtype, np.floating):
                    tmp = tmp.astype(np.float32)
                data[key] = tmp
        return cls(attrs, **data)

    def get(self, idx: int) -> Data:
        """Extract one graph (edge_index rebased). Reference: batch.py:113-131."""
        self.computeCumsums()
        dic = {}
        for key, value in self.data.items():
            if key == "edge_index":
                start, end = self.edge_cumsum[idx], self.edge_cumsum[idx + 1]
                dic[key] = value[:, start:end] - self.node_cumsum[idx]
            if key not in self.attrs:
                continue
            per = self.attrs[key][0]
            if per == "graph":
                start, end = idx, idx + 1
            elif per == "node":
                start, end = self.node_cumsum[idx], self.node_cumsum[idx + 1]
            elif per == "edge":
                start, end = self.edge_cumsum[idx], self.edge_cumsum[idx + 1]
            else:
                continue
            dic[key] = value[start:end]
        return Data(self.attrs, **dic)

    def index_select(self, idx) -> "Batch":
        """Reference parity: batch.py:133-162."""
        if isinstance(idx, slice):
            idx = list(range(self.num_graphs)[idx])
        elif isinstance(idx, np.ndarray):
            if idx.dtype == bool:
                idx = np.nonzero(idx.flatten())[0].tolist()
            else:
                idx = idx.flatten().tolist()
        elif isinstance(idx, Sequence) and not isinstance(idx, str):
            idx = list(idx)
        else:
            try:  # torch tensors
                idx = np.asarray(idx).flatten().tolist()
            except Exception:
                raise IndexError(f"invalid index type {type(idx).__name__}")
        lst = [self.get(int(i)) for i in idx]
        attrs = self.get(int(idx[0])).attrs
        return Batch.from_data_list(lst, attrs)

    @property
    def num_graphs(self):
        self.computeCumsums()
        return self.n_graphs

    def nodeSegment(self) -> np.ndarray:
        self.computeCumsums()
        seg = np.repeat(
            np.arange(self.n_graphs), self.data["_n_nodes"][:, 0].astype(np.int64)
        )
        self.data["_node_segment"] = seg
        return seg

    def edgeSegment(self) -> np.ndarray:
        self.computeCumsums()
        seg = np.repeat(
            np.arange(self.n_graphs), self.data["_n_edges"][:, 0].astype(np.int64)
        )
        self.data["_edge_segment"] = seg
        return seg

    def __getitem__(self, idx):
        if isinstance(idx, str):
            return self.data[idx]
        if isinstance(idx, (int, np.integer)):
            return self.get(int(idx))
        return self.index_select(idx)

    def __setitem__(self, key, item):
        if isinstance(key, int):
            raise NotImplementedError("cannot set an item of a Batch by index")
        super().__setitem__(key, item)
        # invalidate cumsums if counts changed
        if key in ("_n_nodes", "_n_edges"):
            for attr in ("node_cumsum", "edge_cumsum"):
                if hasattr(self, attr):
                    delattr(self, attr)

    def update(self, other):
        other = other.items() if hasattr(other, "items") else other
        for key, value in other:
            self[key] = value

    def __len__(self):
        self.computeCumsums()
        return self.n_graphs
