"""VP-SDE score model for small-molecule conformers (QM9), as a plain dict.

Counterpart of ``equivariant_nn_zoo_tpu/models/config_diffusion.py``: the
same model (n_dim 32, l_max 2, 4 layers, edge SH 1x0e+1x1o+1x2e, 8x0e
Bessel radial basis, 16x0e node attributes, 18 species, r_max 8.0 over the
position scale 1.4) with the bond type's one-hot mixed into the radial
embedding (``concat1``) and the trainable encoding of the graph's time
``t`` broadcast to the nodes and mixed into the node attributes
(``concat2``), and the same training settings.  Spec ``""`` predicts the
score with a direct ``1x1o`` head (``score_pos``); spec ``"nll"`` predicts
an energy (``nll``) whose negative position gradient is ``score_pos``
(``GradientOutput``, so every convolution is built with ``grad_order=2``).
``run/sde_utils.get_score_fn`` turns the output into the score
(``-out / std - x``).

The node attributes then depend on ``t`` and are no longer a species
embedding, so the trunk is built with ``species_pure_attrs=False``: its
self-connections stay per node, never on the per-species tables of K3.
``saveMol`` writes a sampled molecule as a ``.gro`` file
(``utils/saveload.py``); the diffusion loop of ``train.py`` calls it for
its snapshot samples.  In spec ``"nll"`` a loss on the energy's position
gradient gives the energy's output bias no gradient: it keeps a zero
gradient, which data parallelism averages as any other
(``parallel/data_parallel.py``).
"""

from functools import partial

from ..data.compute_edge import computeEdgeIndex
from ..nn import (
    Broadcast,
    Concat,
    OneHotEncoding,
    PointwiseLinear,
    RadialBasisEncoding,
)
from ..utils.saveload import saveMol
from ..utils.utils import default_type_names, insertAfter
from .layer_configs import addEnergyOutput, addForceOutput, featureModel


def get_config(spec=None):
    spec = spec or ""
    num_types = 18
    model = dict(n_dim=32, l_max=2, num_layers=4, edge_radial="8x0e",
                 node_attrs="16x0e", r_max=8.0)
    data = dict(
        n_train=120000, n_val=10831, std=1.4, r_max=model["r_max"] / 1.4,
        train_val_split="random", shuffle=True,
        path=None,  # the QM9 edge HDF5 file, set by the caller
        type_names=default_type_names(num_types),
        key_map={"Z": "species", "R": "pos", "U": "total_energy",
                 "edge_attr": "bond_type"},
        preprocess=[partial(computeEdgeIndex, r_max=9999)],
    )
    if "profiling" in spec:
        data.update(n_train=2048, n_val=256)

    n_dim = model["n_dim"]
    features = "+".join(f"{n_dim}x{n}e+{n_dim}x{n}o"
                        for n in range(model["l_max"] + 1))
    trunk = featureModel(
        n_dim=n_dim, l_max=model["l_max"],
        edge_spherical="1x0e+1x1o+1x2e", node_attrs=model["node_attrs"],
        edge_radial=model["edge_radial"], num_types=num_types,
        num_layers=model["num_layers"], r_max=data["r_max"],
        species_pure_attrs=False,
    )
    layers = trunk["layers"]
    layers = insertAfter(layers, "radial_basis", ("bond_onehot", {
        "module": OneHotEncoding,
        "num_types": 4,
        "irreps_in": ("1x0e", "bond_type"),
        "irreps_out": ("4x0e", "bond_type_onehot"),
    }))
    layers = insertAfter(layers, "bond_onehot", ("concat1", {
        "module": Concat,
        "bondtype": ("4x0e", "bond_type_onehot"),
        "edge_radial": (model["edge_radial"], "edge_radial"),
        "irreps_out": (model["edge_radial"], "edge_radial"),
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
    trunk["layers"] = layers

    if "nll" in spec:
        trunk = addForceOutput(addEnergyOutput(trunk, shifts=None,
                                               output_key="nll"),
                               y="nll", gradients="score_pos")
    else:  # the score directly
        trunk["layers"].append(("score_output", {
            "module": PointwiseLinear,
            "irreps_in": (features, "node_features"),
            "irreps_out": ("1x1o", "score_pos"),
        }))
    model.update(trunk)
    return dict(
        model_config=model, data_config=data, batch_size=128,
        learning_rate=1e-2, use_ema=True, ema_decay=0.99,
        ema_use_num_updates=True, config_spec=spec,
        optimizer_name="Adam", lr_scheduler_name="ReduceLROnPlateau",
        lr_scheduler_patience=1, lr_scheduler_factor=0.8,
        grad_clid_norm=1.0, grad_acc=1, saveMol=saveMol,
        diffusion_keys={"pos": 3},
    )
