"""Output heads; ``Pooling`` is the one ``config_energy`` uses.  PyTorch
counterpart of ``equivariant_nn_zoo_tpu/nn/output.py``."""

from __future__ import annotations

from typing import Dict

from ..ops.segment import segment_mean, segment_sum
from .module import Module


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
