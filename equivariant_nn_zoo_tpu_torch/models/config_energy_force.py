"""Joint energy and force regression on protein fragments, as a plain dict.

Counterpart of ``equivariant_nn_zoo_tpu/models/config_energy_force.py``: the
same model (n_dim 64, l_max 2, r_max 5.0, 5 layers, edge SH
1x0e+1x1o+1x2e, 8x0e Bessel radial basis, 16x0e node attributes, 20
species, per-species energy shifts) wrapped in ``GradientOutput`` (forces =
-dE/dpos), and the same training settings.  Early stopping
(``early_stopping_patiences``, ``early_stopping_lower_bounds``), the epoch
subdivision and the epoch limit belong to the trainer loop, which is not
ported yet, so those fields are left out.
"""

from functools import partial

from ..data.compute_edge import computeEdgeIndex
from ..utils.utils import default_type_names
from .layer_configs import addEnergyOutput, addForceOutput, featureModel

# per-species energy shifts (dataset statistics
# 'energy-per-atom_types-mean_std'); reference config_energy_force.py:81-85
SHIFTS = [-3.7204, -2.2483, -3.7204, -3.7204, -3.7204, -3.7204, -7.6108,
          -4.0182, -5.2651, -3.7204, -3.7204, -3.7204, -3.7204, -3.7204,
          -3.7204, -3.7204, -3.2213, -3.7204, -3.7204, -3.7204]


def get_config():
    num_types = 20
    r_max = 5.0
    model = dict(n_dim=64, l_max=2, r_max=r_max, num_layers=5,
                 node_attrs="16x0e")
    model.update(addForceOutput(addEnergyOutput(featureModel(
        n_dim=model["n_dim"], l_max=model["l_max"],
        edge_spherical="1x0e+1x1o+1x2e", node_attrs=model["node_attrs"],
        edge_radial="8x0e", num_types=num_types,
        num_layers=model["num_layers"], r_max=r_max,
    ), SHIFTS, output_key="energy")))
    data = dict(
        n_train=2560000, n_val=171180, train_val_split="random",
        shuffle=True,
        path=None,  # the protein E and F HDF5 file, set by the caller
        type_names=default_type_names(num_types),
        preprocess=[partial(computeEdgeIndex, r_max=r_max)],
    )
    return dict(
        model_config=model, data_config=data, batch_size=64,
        learning_rate=1e-2, use_ema=True, ema_decay=0.99,
        ema_use_num_updates=True, metric_key="training_loss",
        loss_coeffs={"energy": [1e3, "MSELoss"],
                     "forces": [3e4, "MSELoss"]},
        metrics_components={"energy": ["mae"], "forces": ["mae"]},
        optimizer_name="Adam", lr_scheduler_name="ReduceLROnPlateau",
        lr_scheduler_patience=1, lr_scheduler_factor=1.0,
    )
