"""VP-SDE score model over a protein's C-alpha positions, as a plain dict.

Counterpart of ``equivariant_nn_zoo_tpu/models/config_diffusion_CA.py``:
the same model and training settings.  Each batch is compacted to its
resolved residues (``masked2indexed``) and cropped to at most 384 of them
around a random residue (``crop``); the model's first layer rebuilds the
radius graph from the current positions on the device (``edge_index``:
8 A over the position scale, plus each residue's sequence neighbours and
2 % random pairs, into a static buffer of 262,144 edges), so every score
evaluation of a sampler sees its own edges.  Then a chain-aware
relative-position encoding of each edge (``relative_position``, 32 Bessel
functions under a symmetric cutoff at 150 residues) mixed into the radial
embedding (``concat1``), the graph's time encoding mixed into the node
attributes (``graph2node``, ``concat2``), an 8-layer trunk (n_dim 64,
l_max 2, edge SH 1x0e+1x1o+1x2e, 32-wide radial inputs, 100 neighbours on
average, a layer norm after each layer) and a direct ``1x1o`` score head
per diffusion key.

As in ``config_diffusion``, the node attributes carry the time, so the
trunk is built with ``species_pure_attrs=False``: its self-connections are
per node, never the per-species tables of K3.  The draws of the random
pairs come from the batch's ``_edge_rand`` ``[N, N]`` when it carries one,
else from a generator of the edge layer seeded with ``edge_seed``
(``data.compute_edge.EdgeRandom``).  ``data_config["path"]`` is set by the
caller (the protein files are not in the repository).
"""

from functools import partial

from ..data.compute_edge import (
    EdgeRandom,
    chain_criteria_device,
    computeEdgeIndexDevice,
    computeEdgeVector,
)
from ..nn import (
    Broadcast,
    Concat,
    PointwiseLinear,
    RadialBasisEncoding,
    RelativePositionEncoding,
    symmetric_cutoff,
)
from ..utils.saveload import saveProtein
from ..utils.utils import getScaler, insertAfter, replace
from .layer_configs import featureModel
from .protein_utils import crop, masked2indexed

STD = 25.83   # the position scale (A)
# the model settings of both protein configs (``edge_seed`` seeds the edge
# layer's generator)
MODEL = dict(n_dim=64, l_max=2, r_max=5.0, num_layers=8,
             edge_radial="32x0e", node_attrs="32x0e", edge_seed=0)


def protein_config(spec, diffusion_keys, scaler, inverse_scaler,
                   keep_atoms=("CA",), backbone=False):
    """The protein diffusion config: ``diffusion_keys`` {key: 3} with a
    ``score_<key>`` head each, in key order as the JAX config holds them;
    ``backbone`` mixes the C, N and O vectors into the node features after
    ``layer3`` (``concat3``)."""
    spec = spec or ""
    diffusion_keys = dict(sorted(diffusion_keys.items()))
    model = dict(MODEL)
    num_types = 21
    data = dict(
        n_train=0.9, n_val=0.1, std=STD, scaler=scaler,
        inverse_scaler=inverse_scaler, train_val_split="random",
        shuffle=True,
        path=None,  # the protein HDF5 files, set by the caller
        preprocess=[masked2indexed,
                    partial(crop, max_nodes=384, keep_atoms=keep_atoms)],
        key_map={},
        # static buffer of the in-model edges: ~(100 radius neighbours +
        # 2 % random long-range pairs) per node at 384 nodes a protein
        edge_capacity=262144,
    )
    n_dim, radial = model["n_dim"], model["edge_radial"]
    features = "+".join(f"{n_dim}x{n}e+{n_dim}x{n}o"
                        for n in range(model["l_max"] + 1))
    trunk = featureModel(
        n_dim=n_dim, l_max=model["l_max"],
        edge_spherical="1x0e+1x1o+1x2e", node_attrs=model["node_attrs"],
        edge_radial=radial, num_types=num_types,
        num_layers=model["num_layers"], r_max=model["r_max"],
        avg_num_neighbors=100, normalize=True, species_pure_attrs=False,
    )
    layers = replace(trunk["layers"], "edge_vector",
                     ("edge_vector", partial(computeEdgeVector, key="CA")))
    layers = [("relative_position", {
        "module": RelativePositionEncoding,
        "segment": ("1x0e", "chain_id"),
        "id": ("1x0e", "id"),
        "irreps_out": (radial, "rel_pos_embed"),
        "radial_encoding": {
            "module": RadialBasisEncoding,
            "r_max": 150,
            "cutoff": symmetric_cutoff,
            "trainable": True,
            "one_over_r": False,
        },
    })] + layers
    layers = insertAfter(layers, "radial_basis", ("concat1", {
        "module": Concat,
        "rel_pos": (radial, "rel_pos_embed"),
        "edge_radial": (radial, "edge_radial"),
        "irreps_out": (radial, "edge_radial"),
    }))
    layers = insertAfter(layers, "embedding", ("time_encoding", {
        "module": RadialBasisEncoding,
        "r_max": 1.0,
        "trainable": True,
        "irreps_in": ("1x0e", "t"),
        "one_over_r": False,
        "irreps_out": (f"{n_dim}x0e", "time_encoding"),
    }))
    layers = insertAfter(layers, "time_encoding", ("graph2node", {
        "module": Broadcast,
        "irreps_in": (f"{n_dim}x0e", "time_encoding"),
        "irreps_out": (f"{n_dim}x0e", "time_encoding"),
        "to": "node",
    }))
    layers = insertAfter(layers, "graph2node", ("concat2", {
        "module": Concat,
        "node_attrs": (model["node_attrs"], "node_attrs"),
        "time_encoding": (f"{n_dim}x0e", "time_encoding"),
        "irreps_out": (model["node_attrs"], "node_attrs"),
    }))
    if backbone:
        # the backbone vectors (relative to CA and C after the scalers)
        # mixed into the node features mid-stack
        layers = insertAfter(layers, "layer3", ("concat3", {
            "module": Concat,
            "node_features": (trunk["node_features"], "node_features"),
            "C": ("1x1o", "C"),
            "N": ("1x1o", "N"),
            "O": ("1x1o", "O"),
            "irreps_out": (trunk["node_features"], "node_features"),
        }))
    for key in diffusion_keys:
        layers.append((f"score_{key}", {
            "module": PointwiseLinear,
            "irreps_in": (features, "node_features"),
            "irreps_out": ("1x1o", f"score_{key}"),
        }))
    layers = [("edge_index", partial(
        computeEdgeIndexDevice, r_max=8.0 / STD, key="CA",
        criteria=chain_criteria_device,
        rand=EdgeRandom(model["edge_seed"])))] + layers
    trunk["layers"] = layers
    model.update(trunk)
    return dict(
        model_config=model, data_config=data, batch_size=4,
        learning_rate=1e-2, grad_acc=4, use_ema=True, ema_decay=0.99,
        config_spec=spec, ema_use_num_updates=True, optimizer_name="Adam",
        lr_scheduler_name="ReduceLROnPlateau", lr_scheduler_patience=1,
        lr_scheduler_factor=0.8, grad_clid_norm=1.0, saveMol=saveProtein,
        diffusion_keys=dict(diffusion_keys),
    )


def get_config(spec=None):
    return protein_config(
        spec, {"CA": 3},
        getScaler([("CA", ("shift", "mean")), ("CA", ("scale", 1 / STD))]),
        getScaler([("CA", ("scale", STD))]))
