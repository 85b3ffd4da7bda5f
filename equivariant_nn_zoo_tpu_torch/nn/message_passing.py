"""NequIP-style factorized convolution + gated message-passing block.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/nn/message_passing.py`` for
the trunks of ``config_energy``, ``config_energy_force`` and
``config_hamiltonian`` (no resnet, no layer norm) and the hamiltonian
head's per-edge conv.  Per layer, on the first-order path:

    sc  = SpeciesScalarFCTP(x, node_attrs, species)      K3
    x   = linear_1(x)
    out = FullConv(MLP(edge_radial * edge_mask), x, sh)   K1 (MLP, gather,
          / sqrt(avg_num_neighbors) + sc                      TP, scatter, mix)

and with ``grad_order >= 2`` (the layer sits under a ``GradientOutput``
whose training loss differentiates twice through it):

    sc  = FusedScalarFCTP(x, node_attrs)                 plain PyTorch
    x   = linear_1(x)
    w   = MLP(edge_radial * edge_mask)                   plain PyTorch
    out = FullConvExt(x, sh, w) / sqrt(avg_num_neighbors) + sc   K4f/K4b/K4g

and with ``reduce=False`` (the hamiltonian head's neighbor conv: per-edge
output, no self-connection, no node attributes, no neighbor-count
normalisation):

    x   = linear_1(x)
    w   = MLP(edge_radial * edge_mask)                   plain PyTorch
    out[e] = UVUConv(x, sh, w)                           K6 (backward K6b:
                                                         dx, dsh, dw, dwsel)

The species-table kernel is first-order only, and on the last two paths the
MLP stays outside the kernels so that autograd differentiates it (to any
order on the force path; the per-edge conv's backward hands it ``dw``), as
in the JAX package (``message_passing.py:194-195, 224-241, 274-290``).  The
mix runs after the edge sum (a shared bias-free linear commutes with it).
Each wrapper takes its kernel for CUDA tensors and its plain PyTorch version for
CPU tensors, so the layer has one code path per order.  Padded-edge
messages vanish because ``edge_radial`` is masked and the radial MLP has no
bias.
"""

from __future__ import annotations

from typing import Dict

from ..ops.cuda.full_conv import FullConv
from ..ops.cuda.full_conv_ext import FullConvExt
from ..ops.cuda.species_sc import SpeciesScalarFCTP
from ..ops.cuda.uvu_conv import UVUConv
from ..ops.fused_tp import FusedScalarFCTP
from ..ops.gate import Gate, activations
from ..ops.irreps import Irreps, tp_path_exists
from ..ops.tensor_product import Linear, fully_connected_tp
from ..utils.utils import build
from .mlp import FullyConnectedNet
from .module import Module
from .pointwise import TensorProductExpansion


class FactorizedConvolution(Module):
    def __init__(self, input_features, output_features, node_attrs,
                 edge_radial, edge_spherical, invariant_layers=1,
                 invariant_neurons=8, avg_num_neighbors=None, use_sc=True,
                 sc_species_types: int = None, grad_order: int = 1,
                 reduce: bool = True):
        super().__init__()
        self.grad_order = int(grad_order)
        self.reduce = bool(reduce)
        self.init_irreps(
            input_features=input_features, output_features=output_features,
            node_attrs=node_attrs, edge_radial=edge_radial,
            edge_spherical=edge_spherical, output_keys=["output_features"],
        )
        self.avg_num_neighbors = avg_num_neighbors
        self.use_sc = use_sc and ("node_attrs" in self.irreps_in)
        feature_irreps_in = Irreps(self.irreps_in["input_features"])
        feature_irreps_out = Irreps(self.irreps_out["output_features"])

        self.linear_1 = Linear(feature_irreps_in, feature_irreps_in)
        self.tp = TensorProductExpansion(
            feature_irreps_in,
            (Irreps(self.irreps_in["edge_spherical"]), "edge_spherical"),
            (feature_irreps_out, "edge_features"),
            "uvu", internal_weight=False,
        )
        self.fc = FullyConnectedNet(
            [Irreps(self.irreps_in["edge_radial"]).num_irreps]
            + invariant_layers * [invariant_neurons]
            + [self.tp.tp.weight_numel],
            activations["ssp"],
        )
        if not self.reduce:
            if self.use_sc or self.grad_order >= 2:
                raise NotImplementedError(
                    "the per-edge conv (reduce=False) is first-order and "
                    "has no self-connection")
            self.full_conv = UVUConv(self.tp)
        elif self.grad_order >= 2:
            self.full_conv = FullConvExt(self.tp)
        else:
            self.full_conv = FullConv(self.tp, self.fc)
        if self.use_sc:
            if self.grad_order < 2 and not sc_species_types:
                raise ValueError(
                    "the port's self-connection needs species-pure node "
                    "attributes (sc_species_types)")
            self.sc = fully_connected_tp(
                feature_irreps_in, Irreps(self.irreps_in["node_attrs"]),
                feature_irreps_out,
            )
            if self.grad_order >= 2:
                self.fused_sc = FusedScalarFCTP(self.sc)
            else:
                self.species_sc = SpeciesScalarFCTP(self.sc,
                                                    sc_species_types)

    def forward(self, data: Dict, attrs: Dict):
        edge_radial = data["edge_radial"]
        if "_edge_mask" in data:
            edge_radial = edge_radial * data["_edge_mask"]
        x = data["input_features"]
        edge_index = data["edge_index"]
        num_nodes = x.shape[0]
        if self.use_sc and self.grad_order >= 2:
            sc = self.fused_sc(x, data["node_attrs"])
        elif self.use_sc:
            sc = self.species_sc(self.sc, x, data["node_attrs"],
                                 data["species"])
        x = self.linear_1(x)
        if not self.reduce:
            out = self.full_conv(self.tp.linear, x, data["edge_spherical"],
                                 self.fc(edge_radial), edge_index[0])
            return ({"output_features": out},
                    {"output_features": (attrs["input_features"][0],
                                         self.irreps_out["output_features"])})
        pre = (1.0 / self.avg_num_neighbors ** 0.5
               if self.avg_num_neighbors is not None else None)
        if self.grad_order >= 2:
            out = self.full_conv(self.tp.linear, x, data["edge_spherical"],
                                 self.fc(edge_radial), edge_index[0],
                                 edge_index[1], num_nodes, pre_scale=pre)
        else:
            out = self.full_conv(self.fc, self.tp.linear, x, edge_radial,
                                 data["edge_spherical"], edge_index[0],
                                 edge_index[1], num_nodes, pre_scale=pre)
        if self.use_sc:
            out = out + sc
        return ({"output_features": out},
                {"output_features": (attrs["input_features"][0],
                                     self.irreps_out["output_features"])})


class MessagePassing(Module):
    """Convolution + gate nonlinearity, with the ``tp_path_exists``
    narrowing of scalar and gated irreps."""

    def __init__(self, input_features, output_features, node_attrs,
                 edge_radial, edge_spherical, convolution,
                 resnet: bool = False, nonlinearity_type: str = "gate",
                 nonlinearity_scalars: Dict = {"e": "ssp", "o": "tanh"},
                 nonlinearity_gates: Dict = {"e": "ssp", "o": "abs"},
                 normalize=False):
        super().__init__()
        self.init_irreps(
            input_features=input_features, output_features=output_features,
            node_attrs=node_attrs, edge_radial=edge_radial,
            edge_spherical=edge_spherical, output_keys=["output_features"],
        )
        if nonlinearity_type != "gate" or normalize:
            raise NotImplementedError(
                "the port's MessagePassing supports the gate nonlinearity "
                "without layer norm")
        act_scalars = {1: nonlinearity_scalars["e"],
                       -1: nonlinearity_scalars["o"]}
        act_gates = {1: nonlinearity_gates["e"], -1: nonlinearity_gates["o"]}
        edge_attr_irreps = Irreps(self.irreps_in["edge_spherical"])
        irreps_prev = Irreps(self.irreps_in["input_features"])
        hidden = Irreps(self.irreps_out["output_features"])

        def reachable(mi):
            return tp_path_exists(irreps_prev, edge_attr_irreps, mi.ir)

        irreps_scalars = Irreps([(mi.mul, mi.ir) for mi in hidden
                                 if mi.ir.l == 0 and reachable(mi)])
        irreps_gated = Irreps([(mi.mul, mi.ir) for mi in hidden
                               if mi.ir.l > 0 and reachable(mi)])
        irreps_layer_out = (irreps_scalars + irreps_gated).simplify()
        irreps_gates = Irreps([(mi.mul, "0e") for mi in irreps_gated])
        self.equivariant_nonlin = Gate(
            irreps_scalars=irreps_scalars,
            act_scalars=[act_scalars[mi.ir.p] for mi in irreps_scalars],
            irreps_gates=irreps_gates,
            act_gates=[act_gates[mi.ir.p] for mi in irreps_gates],
            irreps_gated=irreps_gated,
        )
        self.resnet = bool(resnet) and irreps_layer_out == irreps_prev
        self.conv = build(
            convolution,
            input_features=input_features,
            output_features=self.equivariant_nonlin.irreps_in.simplify(),
            node_attrs=node_attrs,
            edge_radial=edge_radial,
            edge_spherical=edge_spherical,
        )

    def forward(self, data: Dict, attrs: Dict):
        conv_out, _ = self.conv(data, attrs)
        output = self.equivariant_nonlin(conv_out["output_features"])
        if self.resnet:
            output = data["input_features"] + output
        return ({"output_features": output},
                {"output_features": (attrs["input_features"][0],
                                     self.irreps_out["output_features"])})
