"""Pointwise equivariant layers: ``PointwiseLinear`` and the
``TensorProductExpansion`` the convolution is built from.

PyTorch counterparts of the ``config_energy`` parts of
``equivariant_nn_zoo_tpu/nn/pointwise.py``.
"""

from __future__ import annotations

from typing import Dict

from ..ops.irreps import Irreps
from ..ops.tensor_product import Linear, TensorProduct
from .module import Module


class PointwiseLinear(Module):
    """Irreps-aware linear with biases on scalar outputs."""

    def __init__(self, irreps_in, irreps_out, biases=True, **kwargs):
        super().__init__()
        self.init_irreps(input=irreps_in, output=irreps_out,
                         output_keys=["output"])
        self.linear = Linear(self.irreps_in["input"],
                             self.irreps_out["output"], biases=biases)

    def forward(self, data: Dict, attrs: Dict):
        return ({"output": self.linear(data["input"])},
                {"output": (attrs["input"][0], self.irreps_out["output"])})


class TensorProductExpansion(Module):
    """uvu/uvw tensor product into every reachable intermediate irrep
    (``tp``), then an equivariant linear mix into the output (``linear``).

    The two are kept separate so the convolution can run the mix after the
    edge sum (they commute).  Only construction is needed on the
    ``config_energy`` path: the convolution's kernels consume the structure.
    """

    def __init__(self, left, right, output, instruction="uvu",
                 internal_weight=True, **kwargs):
        super().__init__()
        self.init_irreps(left=left, right=right, output=output,
                         output_keys=["output"])
        irreps_left = Irreps(self.irreps_in["left"])
        irreps_right = Irreps(self.irreps_in["right"])
        irreps_out = Irreps(self.irreps_out["output"])

        irreps_mid = []
        instructions = []
        for i, mi_l in enumerate(irreps_left):
            for j, mi_r in enumerate(irreps_right):
                for ir_out in mi_l.ir * mi_r.ir:
                    if ir_out in irreps_out:
                        k = len(irreps_mid)
                        irreps_mid.append((mi_l.mul, ir_out))
                        instructions.append((i, j, k, instruction, True))
        sorted_mid = Irreps(irreps_mid).sort()
        instructions = [
            (i1, i2, sorted_mid.p[k], mode, train)
            for i1, i2, k, mode, train in instructions
        ]
        self.irreps_mid = sorted_mid.irreps
        self.internal_weight = internal_weight
        self.tp = TensorProduct(
            irreps_left, irreps_right, self.irreps_mid, instructions,
            shared_weights=internal_weight,
            internal_weights=internal_weight,
        )
        self.linear = Linear(self.irreps_mid.simplify(), irreps_out,
                             biases=False)
