"""Pointwise equivariant layers: ``PointwiseLinear``,
``LayerNormalization``, ``Concat``, ``Split``, the
``TensorProductExpansion`` the convolution and the hamiltonian head are
built from, and ``ResBlock``.

PyTorch counterparts of ``equivariant_nn_zoo_tpu/nn/pointwise.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.gate import NormActivation, resolve_activation
from ..ops.irreps import Irreps
from ..ops.tensor_product import Linear, TensorProduct
from ..ops.wigner import wigner_3j
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


class LayerNormalization(Module):
    """Per-irrep RMS normalisation with a learned scale: each irrep slot
    (one ``mul x ir`` entry) of each row is divided by
    ``sqrt(|x_slot|^2 / mul + 1e-6)`` and multiplied by its own ``std``."""

    def __init__(self, irreps_in, irreps_out, **kwargs):
        super().__init__()
        self.init_irreps(input=irreps_in, output=irreps_out,
                         output_keys=["output"])
        irreps = Irreps(self.irreps_in["input"])
        if irreps != Irreps(self.irreps_out["output"]):
            raise ValueError("LayerNormalization keeps its irreps")
        # consecutive slots of equal (mul, dim) are normalised as one
        # [rows, slots, mul * dim] view: (first slot, slots, mul, dim, col)
        runs, col = [], 0
        for i, mi in enumerate(irreps):
            if runs and runs[-1][2:4] == [mi.mul, mi.ir.dim]:
                runs[-1][1] += 1
            else:
                runs.append([i, 1, mi.mul, mi.ir.dim, col])
            col += mi.dim
        self.runs = [tuple(r) for r in runs]
        self.declare("std", (len(irreps),), "ones")

    def forward(self, data: Dict, attrs: Dict):
        x = data["input"]
        outs = []
        for i0, slots, mul, dim, c0 in self.runs:
            tmp = x[:, c0: c0 + slots * mul * dim].reshape(
                x.shape[0], slots, mul * dim)
            norm = torch.sqrt(torch.sum(tmp * tmp, dim=-1, keepdim=True)
                              / mul + 1e-6)
            out = tmp / norm * self.std[i0: i0 + slots][None, :, None]
            outs.append(out.reshape(x.shape[0], -1))
        return ({"output": torch.cat(outs, dim=-1)},
                {"output": (attrs["input"][0], self.irreps_out["output"])})


class Concat(Module):
    """Concatenate several features (in the order of the keyword
    arguments) and mix them with a biased ``Linear``; the output is per
    whatever the first input is per."""

    def __init__(self, irreps_out, **irreps_in):
        super().__init__()
        self.init_irreps(**irreps_in, output=irreps_out,
                         output_keys=["output"])
        cat = Irreps(None)
        for value in self.irreps_in.values():
            cat = cat + Irreps(value)
        self.linear = Linear(cat, self.irreps_out["output"], biases=True)

    def forward(self, data: Dict, attrs: Dict):
        keys = list(self.irreps_in)
        out = self.linear(torch.cat([data[k] for k in keys], dim=1))
        return ({"output": out},
                {"output": (attrs[keys[0]][0], self.irreps_out["output"])})


class Split(Module):
    """A biased ``Linear`` into the concatenation of the outputs (in the
    order of the keyword arguments), then cut into them along the feature
    axis; each output is per whatever the input is per."""

    def __init__(self, irreps_in, **irreps_out):
        super().__init__()
        self.init_irreps(input=irreps_in, **irreps_out,
                         output_keys=list(irreps_out))
        cat = Irreps(None)
        self.out_dims = {}
        for key, value in self.irreps_out.items():
            cat = cat + Irreps(value)
            self.out_dims[key] = Irreps(value).dim
        self.linear = Linear(self.irreps_in["input"], cat, biases=True)

    def forward(self, data: Dict, attrs: Dict):
        parts = torch.split(self.linear(data["input"]),
                            list(self.out_dims.values()), dim=-1)
        per = attrs["input"][0]
        return (dict(zip(self.out_dims, parts)),
                {key: (per, value) for key, value in self.irreps_out.items()})


class TensorProductExpansion(Module):
    """uvu/uvw tensor product into every reachable intermediate irrep
    (``tp``), then an equivariant linear mix into the output (``linear``).

    The two are kept separate so the convolution can run the mix after the
    edge sum (they commute); the convolution's kernels consume the
    structure only.  ``expand`` is the forward: with internal weights and
    more than four all-uvu paths it takes the mid-fused lowering, which
    mixes each path's chunk right after its CG contraction and never builds
    the full mid tensor (the plain version of the pairwise kernel,
    ``ops/cuda/pairwise_tp.py``).
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
        self._fuse_plan = self._build_fuse_plan()

    def _build_fuse_plan(self):
        """Plan of the mid-fused lowering, or None when it does not apply.
        When the mix is a slot bijection (simplified mid irreps and output
        irreps both unique, no bias) the row block of the mix ``Linear``
        that each TP path feeds is known statically.  Per (i1, i2) pair:
        ``(instruction, weight offset, row rank in the simplified block,
        linear input slot, linear output slot or None)``."""
        tp, lin = self.tp, self.linear
        if not self.internal_weight:
            return None
        if len(tp.instructions) <= 4 or not all(
                ins.mode == "uvu" and ins.has_weight
                for ins in tp.instructions):
            return None
        simplified = self.irreps_mid.simplify()
        if len({mi.ir for mi in simplified}) != len(simplified):
            return None
        if len({mo.ir for mo in lin.irreps_out}) != len(lin.irreps_out):
            return None
        if lin.bias_slots:
            return None
        ii_of_ir = {mi.ir: i for i, mi in enumerate(simplified)}
        io_of_ir = {mo.ir: i for i, mo in enumerate(lin.irreps_out)}
        rank, counter = {}, {}
        for slot, mi in enumerate(tp.irreps_out):
            rank[slot] = counter.get(mi.ir, 0)
            counter[mi.ir] = rank[slot] + mi.mul
        groups: Dict = {}
        ofs = 0
        for ins in tp.instructions:
            ir3 = tp.irreps_out[ins.i_out].ir
            groups.setdefault((ins.i_in1, ins.i_in2), []).append(
                (ins, ofs, rank[ins.i_out], ii_of_ir[ir3],
                 io_of_ir.get(ir3)))
            ofs += int(np.prod(tp._weight_shape(ins)))
        return groups

    def _expand_fused(self, left, right):
        tp, lin = self.tp, self.linear
        weight = tp.weight
        slices1, slices2 = tp.irreps_in1.slices(), tp.irreps_in2.slices()
        mix_bins: Dict[int, list] = {}   # io -> [(chunk, mix rows, mul1)]
        for (i1, i2), items in self._fuse_plan.items():
            live = [it for it in items if it[4] is not None]
            if not live:
                continue  # the mix reads no mid irrep of this pair
            mi1, mi2 = tp.irreps_in1[i1], tp.irreps_in2[i2]
            mul1, d1, mul2, d2 = mi1.mul, mi1.ir.dim, mi2.mul, mi2.ir.dim
            a = left[..., slices1[i1]].reshape(left.shape[:-1] + (mul1, d1))
            b = right[..., slices2[i2]].reshape(
                right.shape[:-1] + (mul2, d2))
            W = torch.stack([weight[o: o + mul1 * mul2].reshape(mul1, mul2)
                             for _, o, _, _, _ in live])      # [L, u, v]
            bw = torch.einsum("...vj,Luv->...Luj", b, W)
            dims3 = [tp.irreps_out[ins.i_out].ir.dim for ins, *_ in live]
            C = np.zeros((len(live), d1, d2, max(dims3)), np.float32)
            for p, (ins, *_) in enumerate(live):
                l3 = tp.irreps_out[ins.i_out].ir.l
                C[p, :, :, : 2 * l3 + 1] = (
                    wigner_3j(mi1.ir.l, mi2.ir.l, l3) * ins.path_weight)
            chunk = torch.einsum(
                "...ui,...Luj,LijK->...LuK", a, bw,
                torch.as_tensor(C, dtype=left.dtype, device=left.device))
            for p, (ins, _, rk, ii, io) in enumerate(live):
                rows = lin.weight(ii, io)[rk: rk + mul1]
                mix_bins.setdefault(io, []).append(
                    (chunk[..., p, :, : dims3[p]], rows, mul1))
        out_chunks: Dict[int, torch.Tensor] = {}
        for io, entries in mix_bins.items():
            if len(entries) > 1 and len({u for *_, u in entries}) == 1:
                ch = torch.stack([c for c, _, _ in entries], dim=-3)
                ws = torch.stack([w for _, w, _ in entries])   # [P, u, w]
                out_chunks[io] = torch.einsum("...Puk,Puw->...wk", ch, ws)
            else:  # mixed path multiplicities: accumulate per path
                out_chunks[io] = sum(
                    torch.einsum("...uk,uw->...wk", c, w)
                    for c, w, _ in entries)
        lead = torch.broadcast_shapes(left.shape[:-1], right.shape[:-1])
        outs = []
        for io, mo in enumerate(lin.irreps_out):
            if io in out_chunks:
                ch = out_chunks[io]
                outs.append(ch.reshape(ch.shape[:-2] + (mo.dim,)).expand(
                    lead + (mo.dim,)))
            else:
                outs.append(left.new_zeros(lead + (mo.dim,)))
        return torch.cat(outs, dim=-1)

    def expand(self, left, right, weight=None):
        """``tp`` (with external per-element weights when given) then the
        linear mix."""
        if weight is None and self._fuse_plan is not None:
            return self._expand_fused(left, right)
        return self.linear(self.tp(left, right, weight))

    def forward(self, data: Dict, attrs: Dict):
        out = self.expand(data["left"], data["right"], data.get("weight"))
        return ({"output": out},
                {"output": (attrs["left"][0], self.irreps_out["output"])})


class ResBlock(Module):
    """Equivariant residual block: ``x + linear_1(norm_act(x))``, then
    ``linear_2`` when the output irreps differ.  ``block`` applies it to a
    tensor."""

    def __init__(self, irreps_in, irreps_out, activation="silu", biases=True,
                 **kwargs):
        super().__init__()
        self.init_irreps(input=irreps_in, output=irreps_out,
                         output_keys=["output"])
        ir_in = Irreps(self.irreps_in["input"])
        ir_out = Irreps(self.irreps_out["output"])
        self.same = ir_in == ir_out
        self.linear_1 = Linear(ir_in, ir_in, biases=biases)
        if not self.same:
            self.linear_2 = Linear(ir_in, ir_out, biases=biases)
        self.act = NormActivation(ir_in, resolve_activation(activation))

    def block(self, x: torch.Tensor) -> torch.Tensor:
        out = x + self.linear_1(self.act(x))
        if not self.same:
            out = self.linear_2(out)
        return out

    def forward(self, data: Dict, attrs: Dict):
        return ({"output": self.block(data["input"])},
                {"output": (attrs["input"][0], self.irreps_out["output"])})
