"""Dipole / atomic multipole regression config, as a plain dict.

Counterpart of ``equivariant_nn_zoo_tpu/models/config_dipole.py``: the
feature trunk (n_dim 32, l_max 2, r_max 5.0, 5 layers, edge SH
1x0e+1x1o+1x2e, 8x0e Bessel radial basis, 16x0e node attributes, 18
species; species-pure attributes, so every self-connection takes the
per-species tables) and one ``PointwiseLinear`` from the node features to
a per-node ``1x1o`` ``dipole`` (no pooling); the same training, early
stopping and data settings.  ``spec`` containing ``"profiling"`` cuts the
split to 2048 / 256 molecules, as the JAX config does.
"""

from functools import partial

from ..data.compute_edge import computeEdgeIndex
from ..nn import PointwiseLinear
from ..utils.utils import default_type_names
from .layer_configs import featureModel


def get_config(spec=None):
    num_types = 18
    r_max = 5.0
    model = dict(n_dim=32, l_max=2, r_max=r_max, num_layers=5,
                 node_attrs="16x0e")
    features = "+".join(f"{model['n_dim']}x{n}e+{model['n_dim']}x{n}o"
                        for n in range(model["l_max"] + 1))
    layer_configs = featureModel(
        n_dim=model["n_dim"], l_max=model["l_max"],
        edge_spherical="1x0e+1x1o+1x2e", node_attrs=model["node_attrs"],
        edge_radial="8x0e", num_types=num_types,
        num_layers=model["num_layers"], r_max=r_max,
    )
    layer_configs["layers"].append(("dipole_output", {
        "module": PointwiseLinear,
        "irreps_in": (features, "node_features"),
        "irreps_out": ("1x1o", "dipole"),
    }))
    model.update(layer_configs)
    data = dict(
        n_train=811113, n_val=202778, train_val_split="random", shuffle=True,
        path="multipole.hdf5", type_names=default_type_names(num_types),
        preprocess=[partial(computeEdgeIndex, r_max=r_max)],
        cache_preprocessed=True, num_workers=4,
    )
    if spec and "profiling" in spec:
        data.update(n_train=2048, n_val=256)
    return dict(
        model_config=model, data_config=data, batch_size=256,
        epoch_subdivision=1, learning_rate=1e-2, use_ema=True,
        ema_decay=0.99, ema_use_num_updates=True,
        metric_key="validation_loss", max_epochs=int(1e6),
        early_stopping_patiences={"validation_loss": 20},
        early_stopping_lower_bounds={"LR": 1e-6},
        loss_coeffs={"dipole": [1e3, "MSELoss"]},
        metrics_components={"dipole": ["mae"]},
        optimizer_name="Adam", lr_scheduler_name="ReduceLROnPlateau",
        lr_scheduler_patience=2, lr_scheduler_factor=0.8,
    )
