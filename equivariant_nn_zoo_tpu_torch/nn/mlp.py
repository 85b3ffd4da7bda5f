"""Scalar MLP with normalized parameterization (e3nn's
``FullyConnectedNet``); PyTorch counterpart of
``equivariant_nn_zoo_tpu/nn/mlp.py``.  It is the convolution's radial
network: inside the K1/K2 kernels on the energy path, and in plain PyTorch
(differentiable to any order) on the force path."""

from __future__ import annotations

from typing import List

import torch

from ..ops.gate import normalize2mom
from ..utils.params import ParamModule


class FullyConnectedNet(ParamModule):
    """Bias-free MLP.  Weights ``w{i}`` are stored N(0,1) and divided by
    ``sqrt(fan_in)`` at apply time; the activation (normalized to unit
    second moment) runs between layers, not after the last."""

    def __init__(self, dims: List[int], activation="ssp"):
        super().__init__()
        assert len(dims) >= 2
        self.dims = list(dims)
        self.act = normalize2mom(activation)
        for i in range(len(dims) - 1):
            self.declare(f"w{i}", (dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.dims) - 1
        for i in range(n):
            x = x @ (getattr(self, f"w{i}") / float(self.dims[i]) ** 0.5)
            if i < n - 1:
                x = self.act(x)
        return x
