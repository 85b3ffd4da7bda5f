"""SequentialGraphNetwork — the key-matched DAG executor.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/nn/sequential.py``: runs an
ordered list of (name, layer-or-callable); each layer reads the running data
dict through its input key map and writes its outputs back through its
output key map, so the dict merge induces an arbitrary DAG.  Layers are
registered as child modules under their config names, which makes the
parameter names the JAX pytree's paths.
"""

from __future__ import annotations

from typing import List

from ..data.graph_batch import GraphBatch
from ..utils.utils import build
from .module import Module


class SequentialGraphNetwork(Module):
    def __init__(self, **config):
        super().__init__()
        self.layers: List = []
        for key, value in config["layers"]:
            if isinstance(value, Module):
                module = value
            elif isinstance(value, dict):
                module = build(value)
            elif callable(value):
                self.layers.append((key, value))
                continue
            else:
                raise TypeError(f"invalid config node for layer {key!r}")
            self.add_module(key, module)
            self.layers.append((key, module))

    def forward(self, data, attrs=None):
        """Takes a GraphBatch (returns a GraphBatch) or a (data, attrs)
        pair of dicts (returns the updated pair)."""
        is_batch = isinstance(data, GraphBatch)
        if is_batch:
            batch = data
            data, attrs = dict(batch.data), dict(batch.attrs)
        else:
            data, attrs = dict(data), dict(attrs)
        for key, module in self.layers:
            if isinstance(module, Module):
                _data, _attrs = module(module.inputKeyMap(data),
                                       module.inputKeyMap(attrs))
                _data = module.outputKeyMap(_data)
                _attrs = module.outputKeyMap(_attrs)
            else:
                _data, _attrs = module(data, attrs)
            data.update(_data)
            attrs.update(_attrs)
        if is_batch:
            return GraphBatch(data, attrs, batch.n_graphs,
                              batch.node_capacity, batch.edge_capacity)
        return data, attrs
