"""The three pinned learning curves of ``tests/test_golden_curve.py`` (energy,
energy + forces, the hamiltonian head) run by the port's trainer end to end
(HDF5 file -> ``CondensedDataset`` -> ``set_dataset`` -> ``epoch_step``)
on the same tiny files, seeds and settings, from the JAX trainer's initial
parameters (``model.init(PRNGKey(0))``), under the JAX tests' own bounds
(imported, not copied) and descent checks: the first check that the port
learns.
"""

import os
import sys
from functools import partial

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(__file__))

from equivariant_nn_zoo_tpu.models import layer_configs as jlc  # noqa: E402
from equivariant_nn_zoo_tpu.utils import build as jbuild  # noqa: E402
from equivariant_nn_zoo_tpu_torch.data import (  # noqa: E402
    CondensedDataset,
    computeEdgeIndex,
)
from equivariant_nn_zoo_tpu_torch.models import get_config  # noqa: E402
from equivariant_nn_zoo_tpu_torch.models import (  # noqa: E402
    layer_configs as tlc,
)
from equivariant_nn_zoo_tpu_torch.models.config_hamiltonian import (  # noqa
    contractBasis,
)
from equivariant_nn_zoo_tpu_torch.run import Trainer  # noqa: E402
from equivariant_nn_zoo_tpu_torch.utils import (  # noqa: E402
    build,
    default_type_names,
    load_jax_params,
)
from test_golden_curve import (  # noqa: E402,F401  (fixtures and bounds)
    FORCE_TOL,
    GOLDEN_FORCE_MAE,
    GOLDEN_HAM_MAE,
    GOLDEN_MAE,
    HAM_TOL,
    TOL,
    _ham_model_config,
    ham_file,
    qm9_force_file,
)
from test_torch_edge_order import torch_threads_per_worker  # noqa: E402
from test_torch_trainer import make_trainer, qm9_file  # noqa: E402,F401

torch_threads_per_worker()

FORCE_SHIFTS = [0.0, -16.4, 0, 0, 0, 0, -1036.0, -1489.0, -2047.0, 0]
SETTINGS = dict(metric_key="validation_loss", learning_rate=5e-3,
                optimizer_name="Adam", lr_scheduler_name="ReduceLROnPlateau",
                lr_scheduler_factor=0.8, use_ema=True, ema_decay=0.99,
                batch_size=8, early_stopping_patiences={"validation_loss": 50},
                log_period=1000)


def _curve(trainer, key, epochs):
    trainer.init_metrics()
    maes = []
    for _ in range(epochs):
        trainer.epoch_step()
        maes.append(float(trainer.mae_dict[key]))
    print(f"port {key} curve:", [round(m, 5) for m in maes])
    assert np.isfinite(maes).all()
    return maes


def _port_model(jax_config, port_config):
    params = jbuild(jax_config).init(jax.random.PRNGKey(0))
    return load_jax_params(build(port_config), jax.device_get(params))


def test_learning_curve_golden(qm9_file, tmp_path):  # noqa: F811
    maes = _curve(make_trainer(qm9_file, tmp_path / "wd", max_epochs=5),
                  "validation_total_energy_mae", 5)
    for i, (got, ref) in enumerate(zip(maes, GOLDEN_MAE)):
        assert got < ref * TOL, (i, got, ref, maes)
    assert maes[-1] < maes[0] * 0.55, maes


def test_force_learning_curve_golden(qm9_force_file, tmp_path):  # noqa: F811
    args = dict(n_dim=8, l_max=1, edge_spherical="1x0e+1x1o",
                node_attrs="4x0e", edge_radial="4x0e", num_types=10,
                num_layers=1, r_max=4.0)
    model = _port_model(
        jlc.addForceOutput(jlc.addEnergyOutput(
            jlc.featureModel(**args), shifts=FORCE_SHIFTS,
            output_key="energy")),
        tlc.addForceOutput(tlc.addEnergyOutput(
            tlc.featureModel(**args), shifts=FORCE_SHIFTS,
            output_key="energy")))
    cfg = get_config("config_energy")
    key_map = {"Z": ("species", "atom_types"), "R": "pos", "U0": "energy",
               "F": "forces"}
    tr = Trainer(
        model, workdir=str(tmp_path / "wdf"), seed=0,
        data_config=dict(cfg["data_config"], n_train=64, n_val=16,
                         key_map=key_map),
        loss_coeffs={"energy": [1.0, "MSELoss"],
                     "forces": [10.0, "MSELoss"]},
        metrics_components={"energy": ["mae"], "forces": ["mae"]},
        lr_scheduler_patience=1, max_epochs=6, **SETTINGS)
    tr.set_dataset(CondensedDataset(
        path=qm9_force_file, key_map=key_map,
        preprocess=[partial(computeEdgeIndex, r_max=4.0)],
        type_names=cfg["data_config"]["type_names"]))
    maes = _curve(tr, "validation_forces_mae", 6)
    for i, (got, ref) in enumerate(zip(maes, GOLDEN_FORCE_MAE)):
        assert got < ref * FORCE_TOL, (i, got, ref, maes)
    assert maes[-1] < maes[0] * 0.9, maes


def test_hamiltonian_learning_curve_golden(ham_file, tmp_path):  # noqa: F811
    mc = tlc.addMatrixOutput(tlc.featureModel(
        n_dim=16, l_max=4, edge_spherical="1x0e+1x1o+1x2e+1x3o",
        node_attrs="4x0e", edge_radial="4x0e", num_types=9, num_layers=3,
        r_max=4.0), "3x0e+2x1o+1x2e", "3x0e+2x1o+1x2e")
    mc["layers"].append(("hamiltonian", contractBasis))
    model = _port_model(_ham_model_config(), mc)
    key_map = {"Z": ("species", "atom_types"), "R": "pos"}
    tr = Trainer(
        model, workdir=str(tmp_path / "wdh"), seed=0,
        data_config={"n_train": 32, "n_val": 16,
                     "train_val_split": "random", "shuffle": True,
                     "key_map": key_map},
        loss_coeffs={"hamiltonian": [1e5, "MSELoss"]},
        metrics_components={"hamiltonian": ["mae"]},
        lr_scheduler_patience=2, max_epochs=5, **SETTINGS)
    tr.set_dataset(CondensedDataset(
        path=ham_file, key_map=key_map,
        preprocess=[partial(computeEdgeIndex, r_max=4.0)],
        type_names=default_type_names(9)))
    maes = _curve(tr, "validation_hamiltonian_mae", 5)
    for i, (got, ref) in enumerate(zip(maes, GOLDEN_HAM_MAE)):
        assert got < ref * HAM_TOL, (i, got, ref, maes)
    assert maes[-1] < maes[0] * 0.5, maes
