"""Batch inference: run a model over padded batches and keep real graphs.

PyTorch counterpart of the evaluation loop of the repository's
``inference.py`` (its HDF5/absl command line is not ported yet).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

from .data.batch import Batch
from .data.graph_batch import GraphBatch


def evaluate(model: torch.nn.Module, batches: Iterable[GraphBatch],
             output_keys: Sequence[str] = ()) -> Batch:
    """Forward every batch under ``torch.no_grad()`` and return one host
    ``Batch`` of the real graphs (``_graph_mask``), with the requested
    outputs (all public annotated keys when ``output_keys`` is empty);
    node outputs such as ``forces`` keep the real nodes.  Not
    ``inference_mode``: a force head differentiates the energy inside the
    forward, and tensors made in inference mode cannot enter autograd."""
    results = []
    keys = list(output_keys)
    with torch.no_grad():
        for gb in batches:
            out = model(gb)
            if not keys:
                keys = [k for k in out.keys()
                        if k in out.attrs and not k.startswith("_")]
            # copy to the host only what is returned; to_batch() drops the
            # padded nodes, edges and graphs (real graphs are a prefix)
            wanted = set(keys) | {"_n_nodes", "_node_mask", "_edge_mask",
                                  "_graph_mask"}
            host = GraphBatch(
                {k: v for k, v in out.data.items() if k in wanted},
                out.attrs, out.n_graphs, out.node_capacity,
                out.edge_capacity).to_batch()
            keep = {k: host[k] for k in keys if k in host.keys()}
            keep["_n_nodes"] = host["_n_nodes"]
            attrs = {k: host.attrs[k] for k in keep if k in host.attrs}
            results.append(Batch(attrs, **keep))
    return Batch.from_data_list(results)
