"""Output heads: ``Pooling`` and the force head ``GradientOutput``.
PyTorch counterpart of ``equivariant_nn_zoo_tpu/nn/output.py``."""

from __future__ import annotations

from typing import Dict

import torch

from ..data.graph_batch import GraphBatch
from ..ops.irreps import Irreps
from ..ops.segment import segment_mean, segment_sum
from ..utils.utils import build
from .module import Module


class GradientOutput(Module):
    """``sign * d(sum y)/dx`` of a wrapped network — the force head.

    The wrapped net is the child ``func`` (parameter names
    ``func.<layer>...``, the JAX pytree's).  ``x`` is replaced by a leaf
    that requires a gradient (the caller's tensor is left alone), ``func``
    runs under ``torch.enable_grad()`` and the gradient is taken with
    ``create_graph`` when the caller's grad mode is on, so a training loss
    on it differentiates twice; with grad mode off (serving, validation)
    the outputs come back detached.
    """

    def __init__(self, func, x, y, gradients, sign: float = 1.0, **kwargs):
        super().__init__()
        sign = float(sign)
        assert sign in (1.0, -1.0)
        self.sign = sign
        self.init_irreps(x=x, y=y, gradients=gradients,
                         output_keys=["gradients"])
        assert Irreps(self.irreps_in["y"]).lmax == 0
        if isinstance(func, dict):
            func = build(func, **kwargs)
        self.func = func
        # custom (data-side) key names for x and y
        inv = {v: k for k, v in self.input_key_mapping.items()}
        self.x_key = inv.get("x", "x")
        self.y_key = inv.get("y", "y")

    def forward(self, data, attrs: Dict = None):
        is_batch = isinstance(data, GraphBatch)
        if is_batch:
            batch = data
            data, attrs = dict(batch.data), dict(batch.attrs)
        else:
            data, attrs = dict(data), dict(attrs)
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            x = data[self.x_key].detach().requires_grad_(True)
            out_data, out_attrs = self.func(dict(data, **{self.x_key: x}),
                                            attrs)
            (grad,) = torch.autograd.grad(out_data[self.y_key].sum(), x,
                                          create_graph=create_graph)
        out_data = dict(out_data)
        out_data[self.x_key] = data[self.x_key]
        if not create_graph:
            out_data = {k: v.detach() for k, v in out_data.items()}
        is_per = attrs[self.x_key][0] if self.x_key in attrs else "node"
        merged = dict(data)
        merged.update(out_data)
        merged_attrs = dict(attrs)
        merged_attrs.update(out_attrs)
        merged.update(self.outputKeyMap({"gradients": self.sign * grad}))
        merged_attrs.update(self.outputKeyMap(
            {"gradients": (is_per, self.irreps_out["gradients"])}))
        if is_batch:
            return GraphBatch(merged, merged_attrs, batch.n_graphs,
                              batch.node_capacity, batch.edge_capacity)
        return merged, merged_attrs


class Pooling(Module):
    """Node -> graph pooling (sum or mean) over ``n_graphs + 1`` segments;
    the trailing padding segment is dropped."""

    def __init__(self, irreps_in, irreps_out, reduce):
        super().__init__()
        self.init_irreps(input=irreps_in, output=irreps_out,
                         output_keys=["output"])
        assert reduce in ("sum", "mean")
        self.reduce = reduce

    def forward(self, data: Dict, attrs: Dict):
        seg = data["_node_segment"]
        n_graphs = data["_graph_mask"].shape[0]
        fn = segment_sum if self.reduce == "sum" else segment_mean
        out = fn(data["input"], seg, n_graphs + 1)[:-1]
        return {"output": out}, {"output": ("graph",
                                            self.irreps_out["output"])}
