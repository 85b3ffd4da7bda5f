"""Per-atom-type affine rescaling of scalar outputs; PyTorch counterpart of
``equivariant_nn_zoo_tpu/nn/scaling.py`` (scale first, then shift; either
trainable or a fixed constant)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .module import Module


class PerTypeScaleShift(Module):
    def __init__(self, num_types: int, shifts: Optional[List[float]],
                 scales: Optional[List[float]],
                 scales_trainable: bool = False,
                 shifts_trainable: bool = False, irreps_in="1x0e",
                 irreps_out="1x0e", species="1x0e"):
        super().__init__()
        self.num_types = num_types
        self.init_irreps(input=irreps_in, output=irreps_out, species=species,
                         output_keys=["output"])

        def expand(v):
            v = np.asarray(v, dtype=np.float32).reshape(-1)
            if v.size == 1:
                v = np.full((num_types,), float(v[0]), np.float32)
            assert v.shape == (num_types,), f"invalid shape {v.shape}"
            return v

        self.has_shifts = shifts is not None
        self.has_scales = scales is not None
        for name, values, trainable in (("shifts", shifts, shifts_trainable),
                                        ("scales", scales, scales_trainable)):
            if values is None:
                continue
            if trainable:
                self.declare(name, (num_types,), expand(values))
            else:
                self.register_buffer(name, torch.tensor(expand(values)),
                                     persistent=False)

    def forward(self, data: Dict, attrs: Dict):
        species = data["species"].reshape(-1).long()
        x = data["input"]
        if self.has_scales:
            x = self.scales[species][:, None] * x
        if self.has_shifts:
            x = self.shifts[species][:, None] + x
            # padded node slots must stay zero so graph pooling is exact
            if "_node_mask" in data and attrs["input"][0] == "node":
                x = x * data["_node_mask"]
        return {"output": x}, {"output": (attrs["input"][0],
                                          self.irreps_out["output"])}
