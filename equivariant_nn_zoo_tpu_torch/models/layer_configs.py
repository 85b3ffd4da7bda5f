"""Functions that assemble the layer configs of the ``config_energy``,
``config_energy_force``, ``config_hamiltonian`` and ``config_diffusion``
models, as plain dicts.

PyTorch counterparts of ``featureModel``, ``embedCategorial``,
``addEnergyOutput``, ``addForceOutput`` and ``addMatrixOutput`` in
``equivariant_nn_zoo_tpu/models/layer_configs.py``:
the same layer names, irreps, key wiring and hyperparameters, naming the
port's classes.
"""

from __future__ import annotations

import inspect
from copy import deepcopy

from ..data import computeEdgeVector
from ..nn import (
    FactorizedConvolution,
    GradientOutput,
    MessagePassing,
    OneHotEncoding,
    Pairwise,
    PerTypeScaleShift,
    PointwiseLinear,
    Pooling,
    RadialBasisEncoding,
    SequentialGraphNetwork,
    SphericalEncoding,
    TensorProductContraction,
)
from ..ops.irreps import Irreps, tp_path_exists


def featureModel(n_dim, l_max, edge_radial, num_types, num_layers, r_max,
                 node_attrs, edge_spherical=None, avg_num_neighbors=10,
                 normalize=False, species_pure_attrs=True):
    """The NequIP-style trunk with per-layer irreps narrowing.

    ``species_pure_attrs``: ``node_attrs`` stays the species embedding of
    ``embedCategorial``, so the self-connections may use per-species
    tables (K3).  A config that rewrites ``node_attrs`` afterwards (the
    diffusion configs mix in each graph's time encoding) passes False, and
    its self-connections stay per node."""
    node_features = "+".join(
        [f"{n_dim}x{n}e+{n_dim}x{n}o" for n in range(l_max + 1)])
    if edge_spherical is None:
        edge_spherical = "+".join(
            [f"1x{n}e" if n % 2 == 0 else f"1x{n}o"
             for n in range(l_max + 1)])
    config = dict(
        n_dim=n_dim, l_max=l_max, edge_radial=edge_radial,
        num_types=num_types, num_layers=num_layers, r_max=r_max,
        module=SequentialGraphNetwork, node_features=node_features,
        edge_spherical=edge_spherical, node_attrs=node_attrs,
    )

    layers = {}
    layers["edge_vector"] = computeEdgeVector
    layers.update(embedCategorial(num_types, ("1x0e", "species"),
                                  (node_attrs, "node_attrs")))
    layers["node_features"] = {
        "module": PointwiseLinear,
        "irreps_in": (f"{num_types}x0e", "onehot"),
        "irreps_out": (f"{n_dim}x0e", "node_features"),
    }
    layers["spharm_edges"] = {
        "module": SphericalEncoding,
        "irreps_out": (edge_spherical, "edge_spherical"),
        "irreps_in": ("1x1o", "edge_vector"),
    }
    layers["radial_basis"] = {
        "module": RadialBasisEncoding,
        "r_max": r_max,
        "trainable": True,
        "polynomial_degree": 6,
        "irreps_in": ("1x0e", "edge_length"),
        "irreps_out": (edge_radial, "edge_radial"),
    }
    irreps = {
        "node_attrs": node_attrs,
        "input_features": [node_features, "node_features"],
        "edge_radial": edge_radial,
        "edge_spherical": edge_spherical,
        "output_features": [node_features, "node_features"],
    }
    conv = {
        "module": FactorizedConvolution,
        "avg_num_neighbors": avg_num_neighbors,
        "use_sc": True,
        "invariant_layers": 3,
        "invariant_neurons": n_dim,
    }
    if species_pure_attrs:
        conv["sc_species_types"] = num_types
    mp = {
        "module": MessagePassing,
        "resnet": False,
        "convolution": conv,
        "nonlinearity_type": "gate",
        "nonlinearity_scalars": {"e": "silu", "o": "tanhlu"},
        "nonlinearity_gates": {"e": "silu", "o": "tanhlu"},
        "normalize": normalize,
        **irreps,
    }
    cur = Irreps(f"{n_dim}x0e")
    full = Irreps(node_features)
    for layer_i in range(num_layers):
        layer = deepcopy(mp)
        layer["input_features"][0] = repr(cur)
        cur = Irreps([(mi.mul, mi.ir) for mi in full
                      if tp_path_exists(cur, edge_spherical, mi.ir)])
        layer["output_features"][0] = repr(cur)
        layers[f"layer{layer_i}"] = layer

    config["layers"] = list(layers.items())
    return config


def embedCategorial(num_types, irreps_in, irreps_out):
    layers = {}
    layers["onehot"] = {
        "module": OneHotEncoding,
        "num_types": num_types,
        "irreps_out": (f"{num_types}x0e", "onehot"),
        "irreps_in": irreps_in,
    }
    layers["embedding"] = {
        "module": PointwiseLinear,
        "irreps_in": (f"{num_types}x0e", "onehot"),
        "irreps_out": irreps_out,
    }
    return layers


def addEnergyOutput(config, shifts=None, output_key="total_energy"):
    layers = {}
    layers["output_linear"] = {
        "module": PointwiseLinear,
        "irreps_in": (config["node_features"], "node_features"),
        "irreps_out": ("1x0e", "energy"),
    }
    if shifts is not None:
        layers["rescale"] = {
            "module": PerTypeScaleShift,
            "num_types": config["num_types"],
            "shifts": shifts,
            "scales": None,
            "irreps_in": ("1x0e", "energy"),
            "irreps_out": ("1x0e", "energy"),
            "species": ("1x0e", "atom_types"),
        }
    layers["reduce"] = {
        "module": Pooling,
        "reduce": "sum",
        "irreps_in": ("1x0e", "energy"),
        "irreps_out": ("1x0e", output_key),
    }
    config["layers"] = config["layers"] + list(layers.items())
    return config


def addForceOutput(config, gradients="forces", y="energy", sign=-1.0):
    """Wrap the whole network in a ``GradientOutput`` head (forces =
    ``sign * d(sum y)/d pos``).  Training then differentiates twice through
    every convolution, so each is built with ``grad_order=2``."""
    config = dict(config)
    layers = config.pop("layers")
    for _name, layer in layers:
        if isinstance(layer, dict) and isinstance(layer.get("convolution"),
                                                  dict):
            layer["convolution"]["grad_order"] = 2
    config["func"] = {"module": config.pop("module"), "layers": layers}
    config.update(module=GradientOutput, x=("1x1o", "pos"), y=("1x0e", y),
                  gradients=("1x1o", gradients), sign=sign)
    return config


def withComputeDtype(config, compute_dtype="float32"):
    """A copy of a model config whose layers take ``compute_dtype``
    (``"float32"`` or ``"bfloat16"``): every layer node whose class names
    the argument (``FactorizedConvolution``, ``Pairwise``), down through
    the convolution node of each message-passing layer and the layers of
    a wrapped network (``addForceOutput``'s ``func``), gets the key.  The
    JAX package reads the same choice from ``E3_COMPUTE_DTYPE`` when its
    layers are built."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        node = dict(node)
        if "module" in node and "compute_dtype" in inspect.signature(
                node["module"]).parameters:
            node["compute_dtype"] = compute_dtype
        for key in ("convolution", "func"):
            if isinstance(node.get(key), dict):
                node[key] = walk(node[key])
        if "layers" in node:
            node["layers"] = [(name, walk(layer))
                              for name, layer in node["layers"]]
        return node

    return walk(config)


def addMatrixOutput(config, tp_l, tp_r):
    """Pairwise features, then tensor-product matrix blocks per atom
    (``hamiltonian_diagonal``) and per atom pair (``hamiltonian_off``): the
    Hamiltonian head."""
    features = config["node_features"]
    layers = {}
    layers["pairwise"] = {
        "module": Pairwise,
        "node_features": features,
        "edge_radial": config["edge_radial"],
        "edge_spherical": config["edge_spherical"],
        "diagonal": features,
        "off_diagonal": features,
        "conv": "auto",
    }
    for name, source, key in (
            ("irreps2tp_diagonal", "diagonal", "hamiltonian_diagonal"),
            ("irreps2tp_off", "off_diagonal", "hamiltonian_off")):
        layers[name] = {
            "module": TensorProductContraction,
            "irreps_in": (features, source),
            "tp_l": (tp_l, key),
            "tp_r": (tp_r, key),
        }
    config["layers"] = config["layers"] + list(layers.items())
    return config
