"""NequIP-style factorized convolution + gated message-passing block.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/nn/message_passing.py`` for
the trunks of ``config_energy``, ``config_energy_force``,
``config_hamiltonian``, ``config_diffusion`` and ``config_dipole``, the
protein configs' trunk (with a layer norm after each layer) and the
hamiltonian head's per-edge conv.  Per layer, on the first-order
path:

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
                                                         dx, dsh, dw, dwsel,
                                                         dx on the trunk's
                                                         edge order)

The species-table kernel is first-order only, and it needs species-pure
node attributes (``sc_species_types``): a layer built without them (the
diffusion configs, whose ``node_attrs`` carry each graph's time encoding)
takes the per-node ``FusedScalarFCTP`` at every order, as the JAX class
does when it has no tables.  On the last two paths the
MLP stays outside the kernels so that autograd differentiates it (to any
order on the force path; the per-edge conv's backward hands it ``dw``), as
in the JAX package (``message_passing.py:194-195, 224-241, 274-290``).  The
mix runs after the edge sum (a shared bias-free linear commutes with it).
Each wrapper takes its kernel for CUDA tensors and its plain PyTorch version for
CPU tensors, so the layer has one code path per order.  Padded-edge
messages vanish because ``edge_radial`` is masked and the radial MLP has no
bias.

``compute_dtype="bfloat16"`` (the JAX layer's constructor argument,
``message_passing.py:54``) runs the node-summed paths as the TPU route
does at bfloat16: K1/K2 and K3/K3b, or on the second-order path the K4
family and the per-node self-connection, in their bfloat16 variants (the
radial MLP rounding as the JAX ``apply_T`` does, its output rounded), the
conv's bfloat16 output and the self-connection rounded to bfloat16 added
in bfloat16 (the TPU conv folds the self-connection into its output
blocks, ``ops/pallas/fused_conv.py:2533``), and a layer after a
``MessagePassing`` reading that layer's output rounded to bfloat16 (the
TPU route's kernel-layout table, ``message_passing.py:615-645``).  The
routes whose kernels have no bfloat16 variant yet refuse it at build:
``reduce=False`` (K6) and the first-order per-node self-connection.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.compute_dtype import compute_dtype_of
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
from .pointwise import LayerNormalization, TensorProductExpansion


# the data key under which a bfloat16 conv reads its input rounded to
# bfloat16 (the JAX package's ``input_features__kl``)
ROUNDED_INPUT = "input_features__kl"


class FactorizedConvolution(Module):
    def __init__(self, input_features, output_features, node_attrs,
                 edge_radial, edge_spherical, invariant_layers=1,
                 invariant_neurons=8, avg_num_neighbors=None, use_sc=True,
                 sc_species_types: int = None, grad_order: int = 1,
                 reduce: bool = True, compute_dtype: str = "float32"):
        super().__init__()
        self.grad_order = int(grad_order)
        self.reduce = bool(reduce)
        self.compute_dtype = compute_dtype_of(compute_dtype)
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
            activations["ssp"], compute_dtype=compute_dtype,
        )
        if self.bf16:
            refused = ("reduce=False (K6): ROADMAP.md queue 1 item 3.2"
                       if not self.reduce else
                       "a first-order per-node self-connection "
                       "(FusedScalarFCTP, K2's sh cotangent): ROADMAP.md "
                       "queue 1 item 3.3"
                       if self.use_sc and not sc_species_types
                       and self.grad_order < 2 else None)
            if refused:
                raise NotImplementedError(
                    f"compute_dtype='bfloat16' is not ported for {refused} "
                    f"yet")
        if not self.reduce:
            if self.use_sc or self.grad_order >= 2:
                raise NotImplementedError(
                    "the per-edge conv (reduce=False) is first-order and "
                    "has no self-connection")
            self.full_conv = UVUConv(self.tp)
        elif self.grad_order >= 2:
            self.full_conv = FullConvExt(self.tp, compute_dtype)
        else:
            self.full_conv = FullConv(self.tp, self.fc, compute_dtype)
        self.species_sc = self.fused_sc = None
        if self.use_sc:
            self.sc = fully_connected_tp(
                feature_irreps_in, Irreps(self.irreps_in["node_attrs"]),
                feature_irreps_out,
            )
            if self.grad_order < 2 and sc_species_types:
                self.species_sc = SpeciesScalarFCTP(self.sc,
                                                    sc_species_types,
                                                    compute_dtype)
            else:
                self.fused_sc = FusedScalarFCTP(self.sc, compute_dtype)

    def self_connection(self, x, data: Dict):
        """The self-connection of features ``x``: on the species tables
        (K3) where the layer has them, else per node."""
        if self.species_sc is not None:
            return self.species_sc(self.sc, x, data["node_attrs"],
                                   data["species"])
        return self.fused_sc(x, data["node_attrs"])

    @property
    def bf16(self) -> bool:
        return self.compute_dtype == torch.bfloat16

    @property
    def takes_rounded_input(self) -> bool:
        """Whether a bfloat16 predecessor hands this layer its output
        rounded (the TPU route's kernel-layout table): the node-summed
        conv over one multiplicity, of either order."""
        return (self.bf16 and self.reduce
                and len({mi.mul for mi in Irreps(
                    self.irreps_in["input_features"])}) == 1)

    @property
    def folds_sc(self) -> bool:
        """Whether the self-connection is added into the conv's output
        blocks, before the output is formatted (the TPU route does it on
        the species tables, and per node on the second-order path,
        ``message_passing.py:274-290``): then the conv's output blocks are
        the whole layer's, and feed the next layer's table."""
        return (not self.use_sc or self.species_sc is not None
                or self.grad_order >= 2)

    def forward(self, data: Dict, attrs: Dict):
        edge_radial = data["edge_radial"]
        if "_edge_mask" in data:
            edge_radial = edge_radial * data["_edge_mask"]
        # at bfloat16, the bfloat16 table of the previous layer's output,
        # where it made one, feeds the self-connection and linear_1
        x_in = data["input_features"]
        x = data.get(ROUNDED_INPUT, x_in)
        edge_index = data["edge_index"]
        num_nodes = x.shape[0]
        if self.use_sc:
            sc = self.self_connection(x, data)
        x = self.linear_1(x.to(x_in.dtype))
        if not self.reduce:
            out = self.full_conv(self.tp.linear, x, data["edge_spherical"],
                                 self.fc(edge_radial), edge_index[0],
                                 edge_index[1])
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
            # a bfloat16 conv's output and self-connection add in bfloat16
            # (the per-node self-connection's float32 output rounded, as
            # fused_conv.py:2533 rounds the folded blocks)
            out = out + sc.to(out.dtype)
        out = out.to(x_in.dtype)
        return ({"output_features": out},
                {"output_features": (attrs["input_features"][0],
                                     self.irreps_out["output_features"])})


class MessagePassing(Module):
    """Convolution + gate nonlinearity, with the ``tp_path_exists``
    narrowing of scalar and gated irreps; then, in this order, the residual
    (``resnet``, where the irreps allow it) and the layer norm
    (``normalize``)."""

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
        if nonlinearity_type != "gate":
            raise NotImplementedError(
                "the port's MessagePassing supports the gate nonlinearity")
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
        self.normalize = bool(normalize)
        if self.normalize:
            out = self.irreps_out["output_features"]
            self.norm = LayerNormalization(out, out)
        # a bfloat16 conv hands the next layer its output rounded to
        # bfloat16, under the output key + "__kl", as the TPU route's
        # kernel-layout table (message_passing.py:615-645): not after a
        # residual or a layer norm, and over one multiplicity
        conv = self.conv
        self._kl_in_key = next(
            (k for k, v in self.input_key_mapping.items()
             if v == "input_features"), "input_features") + "__kl"
        self._kl_out_key = None
        if (isinstance(conv, FactorizedConvolution)
                and conv.takes_rounded_input and not self.resnet
                and not self.normalize and conv.folds_sc
                and len({mi.mul for mi in self.equivariant_nonlin.irreps_out})
                == 1):
            self._kl_out_key = self.output_key_mapping.get(
                "output_features", "output_features") + "__kl"

    def forward(self, data: Dict, attrs: Dict):
        if (self._kl_in_key in data
                and getattr(self.conv, "takes_rounded_input", False)):
            data = dict(data)
            data[ROUNDED_INPUT] = data[self._kl_in_key]
        conv_out, _ = self.conv(data, attrs)
        output = self.equivariant_nonlin(conv_out["output_features"])
        if self.resnet:
            output = data["input_features"] + output
        if self.normalize:
            normed, _ = self.norm(
                {"input": output},
                {"input": (attrs["input_features"][0],
                           self.irreps_out["output_features"])})
            output = normed["output"]
        ret = {"output_features": output}
        out_attrs = {"output_features": (attrs["input_features"][0],
                                         self.irreps_out["output_features"])}
        if self._kl_out_key is not None:
            ret[self._kl_out_key] = output.to(torch.bfloat16)
            out_attrs[self._kl_out_key] = (attrs["input_features"][0],
                                           str(output.shape[-1]))
        return ret, out_attrs
