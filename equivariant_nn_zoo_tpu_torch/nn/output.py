"""Output heads: ``Pooling``, the force head ``GradientOutput`` and the
hamiltonian head (``Pairwise``, ``TensorProductContraction``).
PyTorch counterpart of ``equivariant_nn_zoo_tpu/nn/output.py``."""

from __future__ import annotations

from typing import Dict

import torch

from ..data.graph_batch import GraphBatch
from ..ops.cuda.pairwise_tp import PairwiseTP
from ..ops.irreps import Irreps, tp_path_exists
from ..ops.segment import segment_mean, segment_sum
from ..ops.wigner import wigner_3j
from ..utils.utils import build
from .message_passing import FactorizedConvolution
from .module import Module
from .pointwise import PointwiseLinear, ResBlock, TensorProductExpansion


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


class Pairwise(Module):
    """Pairwise features from node features:
    ``f_ii = res(f_i) + tp(f_i, f_i)`` per node and
    ``f_ij = res(f_i) + tp(f_i, conv_j(Ylm))`` per edge, ``i`` the edge's
    destination.  With ``conv="auto"`` the neighbor features come from a
    per-edge ``FactorizedConvolution`` (K6), else from a plain gather.  The
    two expansions run through one ``PairwiseTP`` (K5), which takes the
    kernel for CUDA tensors and ``expand`` on the CPU."""

    def __init__(self, node_features, edge_radial, edge_spherical, diagonal,
                 off_diagonal, invariant_layers=2, invariant_neurons=16,
                 conv=None):
        super().__init__()
        self.init_irreps(
            node_features=node_features, edge_radial=edge_radial,
            edge_spherical=edge_spherical, diagonal=diagonal,
            off_diagonal=off_diagonal,
            output_keys=["diagonal", "off_diagonal"])
        irreps_in = self.irreps_in["node_features"]
        if conv == "auto":
            # the conv reads our (already mapped) data dict
            inv = {v: k for k, v in self.input_key_mapping.items()}
            self.conv = FactorizedConvolution(
                input_features=(irreps_in, "node_features"),
                output_features=irreps_in, node_attrs=None,
                edge_radial=(self.irreps_in["edge_radial"],
                             inv.get("edge_radial", "edge_radial")),
                edge_spherical=(self.irreps_in["edge_spherical"],
                                inv.get("edge_spherical", "edge_spherical")),
                invariant_layers=2, invariant_neurons=32,
                avg_num_neighbors=1, use_sc=False, reduce=False)
        else:
            self.conv = None
        irreps_out = self.irreps_out["diagonal"]
        self.tp = TensorProductExpansion(irreps_in, irreps_in, irreps_out,
                                         "uvu")
        self.res_center = ResBlock(irreps_in, irreps_in)
        self.res_pair = ResBlock(irreps_out, irreps_out)
        self.res_res = ResBlock(irreps_in, irreps_out)
        self.tp_off = TensorProductExpansion(irreps_in, irreps_in,
                                             irreps_out, "uvu")
        self.res_center_off = ResBlock(irreps_in, irreps_in)
        self.res_pair_off = ResBlock(irreps_out, irreps_out)
        self.res_res_off = ResBlock(irreps_in, irreps_out)
        # tp and tp_off have one structure: one table set serves both
        self.pairwise_tp = PairwiseTP(self.tp)

    def forward(self, data: Dict, attrs: Dict):
        node_features = data["node_features"]
        src, dst = data["edge_index"][0], data["edge_index"][1]
        if self.conv is None:
            neighbor = node_features[src]
        else:
            conv_in = self.conv.inputKeyMap(data)
            conv_attrs = self.conv.inputKeyMap(attrs)
            conv_in["input_features"] = node_features
            neighbor = self.conv(conv_in, conv_attrs)[0]["output_features"]
        center = node_features[dst]
        off = self.pairwise_tp(self.tp_off, self.res_center_off.block(center),
                               neighbor)
        off = self.res_res_off.block(center) + self.res_pair_off.block(off)

        diag = self.pairwise_tp(self.tp, self.res_center.block(node_features),
                                node_features)
        diag = self.res_res.block(node_features) + self.res_pair.block(diag)
        return ({"diagonal": diag, "off_diagonal": off},
                {"diagonal": ("node", self.irreps_out["diagonal"]),
                 "off_diagonal": ("edge", self.irreps_out["off_diagonal"])})


class TensorProductContraction(Module):
    """Compose irreducible features into tensor-product matrix blocks
    (``tp_l (x) tp_r``), e.g. Hamiltonian sub-blocks per atom or atom pair.
    A linear map brings the input to the irreps the blocks need; each
    block then takes its irreps from the TAIL of what is left of its
    (degree, parity) allocation.  The output is a dict of blocks
    ``"{mul_l}x{l_l}{p_l}*{mul_r}x{l_r}{p_r}" -> [rows, mul_l, 2 l_l + 1,
    mul_r, 2 l_r + 1]`` under the key of ``tp_l``."""

    def __init__(self, irreps_in, tp_l, tp_r):
        super().__init__()
        self.init_irreps(irreducible=irreps_in, tp_l=tp_l, tp_r=tp_r,
                         output_keys=["tp_l", "tp_r"])
        self.irreps_mul = {}
        for mi_l in Irreps(self.irreps_out["tp_l"]):
            for mi_r in Irreps(self.irreps_out["tp_r"]):
                parity = "e" if mi_l.ir.p * mi_r.ir.p == 1 else "o"
                for degree in range(abs(mi_l.ir.l - mi_r.ir.l),
                                    mi_l.ir.l + mi_r.ir.l + 1):
                    key = f"{degree}{parity}"
                    self.irreps_mul[key] = (self.irreps_mul.get(key, 0)
                                            + mi_l.mul * mi_r.mul)
        self.irreps = Irreps(
            "+".join(f"{v}x{k}" for k, v in self.irreps_mul.items()))
        self.linear = PointwiseLinear(irreps_in, self.irreps)
        # the slice of the linear's output and the wigner_3j table of every
        # (block, irrep) pair, in the order the tail bookkeeping visits them
        left = dict(self.irreps_mul)
        slices = self.irreps.slices()
        self.blocks = []     # (key, mul_l, mul_r, [(start, stop, d, buffer)])
        for mi_l in Irreps(self.irreps_out["tp_l"]):
            for mi_r in Irreps(self.irreps_out["tp_r"]):
                mul = mi_l.mul * mi_r.mul
                parts = []
                for i, mi in enumerate(self.irreps):
                    if not tp_path_exists(repr(mi_l.ir), repr(mi_r.ir),
                                          repr(mi.ir)):
                        continue
                    key = repr(mi.ir)
                    stop = slices[i].start + left[key] * mi.ir.dim
                    name = f"cg{len(self.blocks)}_{len(parts)}"
                    self.register_buffer(name, torch.tensor(
                        wigner_3j(mi_l.ir.l, mi_r.ir.l, mi.ir.l),
                        dtype=torch.float32), persistent=False)
                    parts.append((stop - mul * mi.ir.dim, stop, mi.ir.dim,
                                  name))
                    left[key] -= mul
                self.blocks.append(
                    (f"{mi_l.mul}x{mi_l.ir}*{mi_r.mul}x{mi_r.ir}",
                     mi_l.mul, mi_r.mul, parts))
        assert all(v == 0 for v in left.values()), f"unconsumed irreps {left}"

    def forward(self, data: Dict, attrs: Dict):
        x = self.linear.linear(data["irreducible"])
        tp = {}
        for key, mul_l, mul_r, parts in self.blocks:
            tp[key] = sum(
                torch.einsum("bmni,lri->bmlnr",
                             x[:, start:stop].reshape(-1, mul_l, mul_r, d),
                             getattr(self, name))
                for start, stop, d, name in parts)
        return {"tp_l": tp}, {}
