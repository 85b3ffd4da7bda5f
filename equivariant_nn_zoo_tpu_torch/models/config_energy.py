"""QM9 total-energy regression config, as a plain dict.

Counterpart of ``equivariant_nn_zoo_tpu/models/config_energy.py``: the same
model (n_dim 64, l_max 3, r_max 4.0, 5 layers, edge SH 1x0e+1x1o+1x2e,
8x0e Bessel radial basis, 20x0e node attributes, 10 species) and per-species
energy shifts.  The training fields are kept for the trainer of a later
slice.
"""

from functools import partial

from ..data.compute_edge import computeEdgeIndex
from ..utils.utils import default_type_names
from .layer_configs import addEnergyOutput, featureModel

# per-species energy shifts (dataset statistics
# 'total_energy-per-atom_types-mean_std'); reference config_energy.py:65-76
SHIFTS = [-620.4502, -16.4435, -620.4502, -620.4502, -620.4502, -620.4502,
          -1036.0271, -1489.8005, -2046.9702, -2717.4263]


def get_config():
    num_types = 10
    r_max = 4.0
    model = dict(n_dim=64, l_max=3, r_max=r_max, num_layers=5,
                 node_attrs="20x0e")
    model.update(addEnergyOutput(featureModel(
        n_dim=model["n_dim"], l_max=model["l_max"],
        edge_spherical="1x0e+1x1o+1x2e", node_attrs=model["node_attrs"],
        edge_radial="8x0e", num_types=num_types,
        num_layers=model["num_layers"], r_max=r_max, normalize=False,
    ), SHIFTS))
    data = dict(
        n_train=120000, n_val=10831, train_val_split="random", shuffle=True,
        path=None,  # the QM9 HDF5 file, set by the caller
        type_names=default_type_names(num_types),
        key_map={"Z": "species", "R": "pos", "U0": "total_energy"},
        preprocess=[partial(computeEdgeIndex, r_max=r_max)],
    )
    return dict(
        model_config=model, data_config=data, batch_size=128,
        learning_rate=1e-2, use_ema=True, ema_decay=0.99,
        ema_use_num_updates=True, metric_key="validation_loss",
        loss_coeffs={"total_energy": [1e3, "MSELoss"]},
        metrics_components={"total_energy": ["mae"]},
        optimizer_name="Adam", lr_scheduler_name="ReduceLROnPlateau",
        lr_scheduler_patience=1, lr_scheduler_factor=0.8,
    )
