"""Irreps-aware tensor products and linear maps.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/ops/tensor_product.py``:
the same instruction lists, e3nn-style path weights
(``sqrt(d_out / fan_total)``, component irrep normalization) and
``Linear`` ``alphas`` (``1/sqrt(fan_in)``), and the same parameter names
and shapes (``weight``; ``w{ii}_{io}``, ``b{io}``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..utils.params import ParamModule
from .irreps import Irrep, Irreps
from .wigner import wigner_3j


class Instruction(NamedTuple):
    i_in1: int
    i_in2: int
    i_out: int
    mode: str  # "uvw" | "uvu"
    has_weight: bool
    path_weight: float = 1.0


def _normalize_instructions(irreps_in1: Irreps, irreps_in2: Irreps,
                            irreps_out: Irreps,
                            instructions: List[Tuple]) -> List[Instruction]:
    """Attach e3nn-style path weights: sqrt(d_out / fan_total_per_output)."""
    raw = [Instruction(*ins[:5]) for ins in instructions]

    def fan(ins: Instruction) -> float:
        mul1 = irreps_in1[ins.i_in1].mul
        mul2 = irreps_in2[ins.i_in2].mul
        if ins.mode == "uvw":
            return mul1 * mul2
        if ins.mode == "uvu":
            return mul2
        raise ValueError(f"unsupported mode {ins.mode}")

    fan_total: Dict[int, float] = {}
    for ins in raw:
        fan_total[ins.i_out] = fan_total.get(ins.i_out, 0.0) + fan(ins)
    return [
        ins._replace(path_weight=(irreps_out[ins.i_out].ir.dim
                                  / fan_total[ins.i_out]) ** 0.5)
        for ins in raw
    ]


class TensorProduct(ParamModule):
    """Instruction-list tensor product over irreps (modes uvw, uvu).

    The weight layout is one flat vector; with ``internal_weights=False``
    the caller passes per-element weights ``[..., weight_numel]`` (the
    convolution's per-edge radial weights).
    """

    def __init__(self, irreps_in1, irreps_in2, irreps_out,
                 instructions: List[Tuple], shared_weights: bool = True,
                 internal_weights=None):
        super().__init__()
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        self.irreps_out = Irreps(irreps_out)
        self.instructions = _normalize_instructions(
            self.irreps_in1, self.irreps_in2, self.irreps_out, instructions
        )
        self.shared_weights = shared_weights
        self.internal_weights = (
            shared_weights if internal_weights is None else internal_weights
        )
        for idx, ins in enumerate(self.instructions):
            ir1 = self.irreps_in1[ins.i_in1].ir
            ir2 = self.irreps_in2[ins.i_in2].ir
            ir3 = self.irreps_out[ins.i_out].ir
            assert ir3 in ir1 * ir2, f"forbidden path {ir1}*{ir2}->{ir3}"
            if ins.mode == "uvu":
                assert (self.irreps_out[ins.i_out].mul
                        == self.irreps_in1[ins.i_in1].mul), \
                    "uvu requires mul_out == mul_in1"
            cg = wigner_3j(ir1.l, ir2.l, ir3.l) * ins.path_weight
            self.register_buffer(
                f"cg{idx}", torch.tensor(cg, dtype=torch.float32),
                persistent=False,
            )
        self.weight_numel = sum(
            int(np.prod(self._weight_shape(ins)))
            for ins in self.instructions if ins.has_weight
        )
        if self.internal_weights and self.weight_numel:
            self.declare("weight", (self.weight_numel,))

    def _weight_shape(self, ins: Instruction) -> Tuple[int, ...]:
        mul1 = self.irreps_in1[ins.i_in1].mul
        mul2 = self.irreps_in2[ins.i_in2].mul
        if ins.mode == "uvw":
            return (mul1, mul2, self.irreps_out[ins.i_out].mul)
        return (mul1, mul2)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                weight: torch.Tensor = None) -> torch.Tensor:
        """x1 [..., dim1], x2 [..., dim2] -> [..., dim_out]."""
        if self.internal_weights:
            weight = self.weight
        slices1 = self.irreps_in1.slices()
        slices2 = self.irreps_in2.slices()
        lead = torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1])
        chunks: Dict[int, torch.Tensor] = {}
        w_ofs = 0
        for idx, ins in enumerate(self.instructions):
            mi1 = self.irreps_in1[ins.i_in1]
            mi2 = self.irreps_in2[ins.i_in2]
            mi3 = self.irreps_out[ins.i_out]
            a = x1[..., slices1[ins.i_in1]].reshape(
                x1.shape[:-1] + (mi1.mul, mi1.ir.dim))
            b = x2[..., slices2[ins.i_in2]].reshape(
                x2.shape[:-1] + (mi2.mul, mi2.ir.dim))
            c = getattr(self, f"cg{idx}").to(x1.dtype)
            if ins.has_weight:
                shape = self._weight_shape(ins)
                n = int(np.prod(shape))
                if weight.dim() == 1:
                    w = weight[w_ofs: w_ofs + n].reshape(shape)
                else:
                    w = weight[..., w_ofs: w_ofs + n].reshape(
                        weight.shape[:-1] + shape)
                w_ofs += n
                batched = "..." if w.dim() > len(shape) else ""
                if ins.mode == "uvw":
                    chunk = torch.einsum(
                        f"...ui,...vj,ijk,{batched}uvw->...wk", a, b, c, w)
                else:
                    chunk = torch.einsum(
                        f"...ui,...vj,ijk,{batched}uv->...uk", a, b, c, w)
            else:
                if ins.mode == "uvw":
                    raise ValueError("uvw requires weights")
                chunk = torch.einsum("...ui,...vj,ijk->...uk", a, b, c)
            chunk = chunk.reshape(chunk.shape[:-2] + (mi3.dim,))
            chunks[ins.i_out] = chunks[ins.i_out] + chunk \
                if ins.i_out in chunks else chunk
        outs = [
            chunks[i].expand(lead + (mi.dim,)) if i in chunks
            else x1.new_zeros(lead + (mi.dim,))
            for i, mi in enumerate(self.irreps_out)
        ]
        return torch.cat(outs, dim=-1)


def fully_connected_tp(irreps_in1, irreps_in2, irreps_out) -> TensorProduct:
    """All-paths uvw tensor product with internal weights (e3nn's
    ``FullyConnectedTensorProduct``; the convolution's self-connection)."""
    irreps_in1, irreps_in2, irreps_out = (
        Irreps(irreps_in1), Irreps(irreps_in2), Irreps(irreps_out))
    instructions = []
    for i1, mi1 in enumerate(irreps_in1):
        for i2, mi2 in enumerate(irreps_in2):
            for io, mio in enumerate(irreps_out):
                if mio.ir in mi1.ir * mi2.ir:
                    instructions.append((i1, i2, io, "uvw", True))
    return TensorProduct(irreps_in1, irreps_in2, irreps_out, instructions,
                         shared_weights=True)


class Linear(ParamModule):
    """Equivariant linear map: mixes multiplicities within equal irreps,
    with optional biases on scalar (0e) outputs.  Weights are stored N(0,1)
    and scaled by ``alphas[io] = 1/sqrt(fan_in)`` at apply time."""

    def __init__(self, irreps_in, irreps_out, biases: bool = False):
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        self.irreps_out = Irreps(irreps_out)
        self.paths: List[Tuple[int, int]] = []
        for io, mio in enumerate(self.irreps_out):
            for ii, mii in enumerate(self.irreps_in):
                if mii.ir == mio.ir:
                    self.paths.append((ii, io))
        fan: Dict[int, int] = {}
        for ii, io in self.paths:
            fan[io] = fan.get(io, 0) + self.irreps_in[ii].mul
        self.alphas = {io: (1.0 / fan[io]) ** 0.5 for io in fan}
        self.biases = biases
        self.bias_slots = (
            [io for io, mio in enumerate(self.irreps_out)
             if mio.ir == Irrep("0e")] if biases else []
        )
        in_slices = self.irreps_in.slices()
        # widest input column any path reads: configs may declare irreps_in
        # wider than the producer's narrowed output as long as every slot
        # with a live path is present
        self._max_read = max(
            (in_slices[ii].stop for ii, _ in self.paths), default=0)
        for ii, io in self.paths:
            self.declare(f"w{ii}_{io}",
                         (self.irreps_in[ii].mul, self.irreps_out[io].mul))
        for io in self.bias_slots:
            self.declare(f"b{io}", (self.irreps_out[io].mul,), "zeros")

    def weight(self, ii: int, io: int) -> torch.Tensor:
        """Path weight ``w{ii}_{io}`` with its ``alpha`` applied."""
        return getattr(self, f"w{ii}_{io}") * self.alphas[io]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] < self._max_read:
            raise ValueError(
                f"Linear on {self.irreps_in} reads input cols up to "
                f"{self._max_read}, got input with {x.shape[-1]} cols"
            )
        lead = x.shape[:-1]
        slices_in = self.irreps_in.slices()
        chunks: Dict[int, torch.Tensor] = {}
        for ii, io in self.paths:
            mii = self.irreps_in[ii]
            a = x[..., slices_in[ii]].reshape(lead + (mii.mul, mii.ir.dim))
            chunk = torch.einsum("...ui,uw->...wi", a, self.weight(ii, io))
            chunks[io] = chunks[io] + chunk if io in chunks else chunk
        outs = []
        for io, mio in enumerate(self.irreps_out):
            chunk = chunks.get(io)
            if chunk is None:
                chunk = x.new_zeros(lead + (mio.mul, mio.ir.dim))
            if io in self.bias_slots:
                chunk = chunk + getattr(self, f"b{io}")[:, None]
            outs.append(chunk.reshape(lead + (mio.dim,)))
        return torch.cat(outs, dim=-1)
