"""Model-level parity of the port's force path (``addForceOutput``,
``GradientOutput``, the ``grad_order=2`` convolution) with the JAX package
(CPU, f32), at a small size: n_dim 8, l_max 2, 2 layers, 6 molecules with
N(0, 1) energy and force labels, padded to 8 graphs.

- energies and forces against the JAX default CPU path (rel-linf 1e-5);
- one training step's gradient of every parameter, loss
  ``1e3 MSE(energy) + 3e4 MSE(forces)``, against ``jax.value_and_grad``
  (jitted once for the file; rel-linf 1e-4 of each tensor's max, and
  structural zeros equal);
- the card path's Functions, routed to the plain contracts, against plain
  autograd on the whole model, and the launches per step: layer 0's input
  does not depend on positions, so its second backward takes the pairing
  rule, and every later layer takes K4g;
- physics: forces equivariant under a rotation, a finite difference on one
  coordinate, the padded node's forces exactly 0 and every second-order
  gradient finite with padded edges present;
- ``run.Trainer`` on ``config_energy_force``'s settings and ``evaluate``.
"""

import jax
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu.data import Batch as JBatch
from equivariant_nn_zoo_tpu.data import Data as JData
from equivariant_nn_zoo_tpu.data import GraphBatch as JGraphBatch
from equivariant_nn_zoo_tpu.models import layer_configs as jlc
from equivariant_nn_zoo_tpu.run import loss as jloss
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu_torch.data import (
    Batch,
    Data,
    GraphBatch,
    computeEdgeIndex,
)
from equivariant_nn_zoo_tpu_torch.inference import evaluate
from equivariant_nn_zoo_tpu_torch.models import get_config
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.ops import rand_matrix
from equivariant_nn_zoo_tpu_torch.run import Loss, Trainer
from equivariant_nn_zoo_tpu_torch.utils import (
    build,
    load_jax_params,
    params_from_jax,
)
from test_torch_force import route_to_plain

SHIFTS = [-0.5, -1.0, 0.0, 0.5, 1.0, 1.5, -2.0, -3.0, 2.5, 0.25]
MODEL_KW = dict(n_dim=8, l_max=2, node_attrs="4x0e", edge_radial="4x0e",
                num_types=10, num_layers=2, r_max=3.0)
ATTRS = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
         "atom_types": ("node", "1x0e"), "energy": ("graph", "1x0e"),
         "forces": ("node", "1x1o"), "_n_edges": ("graph", "1x0e")}
LOSS = {"energy": [1e3, "MSELoss"], "forces": [3e4, "MSELoss"]}
N_GRAPHS = 8  # 6 molecules: two padded graphs


def _molecules(seed=0, n_mol=6):
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(5, 12))
        d = {"pos": rng.normal(size=(n, 3)) * 1.2,
             "species": rng.choice([1, 6, 7, 8], size=(n, 1)),
             "energy": rng.normal(size=(1, 1)),
             "forces": rng.normal(size=(n, 3))}
        d["atom_types"] = d["species"]
        out, _ = computeEdgeIndex(d, dict(ATTRS), r_max=3.0)
        d.update(out)
        mols.append(d)
    return mols


def _port_batch(mols, n_graphs=N_GRAPHS):
    host = Batch.from_data_list([Data(dict(ATTRS), **m) for m in mols])
    gb = GraphBatch.from_batch(host, 96, 768, n_graphs, "cpu")
    assert gb.dropped == 0
    return gb


def _config(lc):
    return lc.addForceOutput(lc.addEnergyOutput(lc.featureModel(**MODEL_KW),
                                                SHIFTS, output_key="energy"))


def _port_model(params):
    return load_jax_params(build(_config(tlc)), params)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def reference():
    """JAX parameters, outputs, and the loss and gradients of one step on
    the default CPU path (jitted: computed once for the file)."""
    jmodel = jbuild(_config(jlc))
    params = jmodel.init(jax.random.PRNGKey(0))
    mols = _molecules()
    host = JBatch.from_data_list([JData(dict(ATTRS), **m) for m in mols])
    jgb = JGraphBatch.from_batch(host, 96, 768, N_GRAPHS)
    loss = jloss.Loss(LOSS)

    def f(p):
        out = jmodel.apply(p, jgb)
        return loss(out.data, jgb.data)[0], (out["energy"], out["forces"])

    (value, (energy, forces)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(params)
    return dict(params=params, mols=mols, loss=float(value),
                energy=np.asarray(energy), forces=np.asarray(forces),
                grads=params_from_jax(jax.device_get(grads)))


@pytest.fixture(scope="module")
def model(reference):
    return _port_model(reference["params"])


def _step(model, gb):
    model.zero_grad()
    out = model(gb)
    loss, _ = Loss(LOSS)(out.data, gb.data)
    loss.backward()
    return out, loss.item(), {n: p.grad.clone() for n, p in
                              model.named_parameters()}


def test_energy_and_forces_match_jax(reference, model):
    with torch.no_grad():
        out = model(_port_batch(reference["mols"]))
    assert out["forces"].shape == reference["forces"].shape
    assert not out["forces"].requires_grad
    for key in ("energy", "forces"):
        got = out[key].numpy()
        assert np.isfinite(got).all(), key
        assert _rel(got, reference[key]) <= 1e-5, (key, _rel(
            got, reference[key]))


def test_step_gradients_match_jax(reference, model):
    _, loss, grads = _step(model, _port_batch(reference["mols"]))
    assert _rel(loss, reference["loss"]) <= 1e-5
    assert set(grads) == set(reference["grads"])
    for name, want in reference["grads"].items():
        got, want = grads[name].numpy(), want.numpy()
        if not np.abs(want).any():
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        assert _rel(got, want) <= 1e-4, (name, _rel(got, want))


def test_functions_match_plain_autograd(reference, model, monkeypatch):
    """Every parameter's gradient through ``FullConvExtFunction`` and
    ``FullConvExtBwdFunction`` (launches routed to the plain contracts of
    K4f, K4b and K4g) equals plain autograd's; per step each layer runs
    K4f once and K4b twice (the forces, then the energy term's backward),
    layer 0 takes the pairing rule (two K4b and two K4f calls, for the dsh
    and dw cotangents) and the other layers K4g."""
    gb = _port_batch(reference["mols"])
    want_out, want_loss, want = _step(model, gb)
    calls = route_to_plain(monkeypatch)
    got_out, got_loss, got = _step(model, gb)
    layers = MODEL_KW["num_layers"]
    assert calls == {"fwd": layers + 2, "bwd": 2 * layers + 2,
                     "grad2": layers - 1}
    assert _rel(got_loss, want_loss) <= 1e-6
    assert _rel(got_out["forces"].detach(), want_out["forces"].detach()) \
        <= 1e-6
    for name in want:
        assert _rel(got[name].numpy(), want[name].numpy()) <= 1e-5, name


def test_forces_equivariant_and_finite_difference(model):
    gb = _port_batch(_molecules(seed=1))
    with torch.no_grad():
        out = model(gb)
    f = out["forces"]
    R = torch.tensor(rand_matrix(np.random.default_rng(2)),
                     dtype=torch.float32)
    with torch.no_grad():
        f_rot = model(gb.replace(pos=gb["pos"] @ R.T))["forces"]
    assert _rel(f_rot, f @ R.T) <= 1e-4
    # central difference on one coordinate (float32: eps 1e-2 keeps the
    # rounding of the ~1e1 energy sum near 1e-4 of the force)
    eps = 1e-2
    energies = []
    for sign in (1, -1):
        pos = gb["pos"].clone()
        pos[0, 0] += sign * eps
        with torch.no_grad():
            energies.append(float(model(gb.replace(pos=pos))["energy"].sum()))
    fd = -(energies[0] - energies[1]) / (2 * eps)
    assert abs(fd - float(f[0, 0])) <= 1e-2 * max(abs(fd), 1.0), (
        fd, float(f[0, 0]))


def test_padding_gives_zero_forces_and_finite_second_order(model):
    gb = _port_batch(_molecules(seed=3))
    n_real = int(gb["_node_mask"].sum())
    e_real = int(gb["_edge_mask"].sum())
    assert e_real < gb.edge_capacity  # padded edges present
    out, loss, grads = _step(model, gb)
    assert torch.equal(out["forces"][n_real:],
                       torch.zeros_like(out["forces"][n_real:]))
    assert np.isfinite(loss)
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name


def test_trainer_and_evaluate_on_config_energy_force_settings(reference):
    """Two training steps and a validation with ``config_energy_force``'s
    own settings (Adam lr 1e-2, EMA 0.99 with num_updates, the two-term
    loss, the plateau scheduler on the training loss): finite losses and
    metrics, validation forces under ``no_grad``; then ``evaluate``
    returns the real graphs' energies and the real nodes' forces."""
    cfg = get_config("config_energy_force")
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    trainer = Trainer(_port_model(reference["params"]), **settings)
    train = [_port_batch(_molecules(seed)) for seed in (10, 11)]
    val = [_port_batch(_molecules(12))]
    trainer.epoch_step(train, val)
    assert trainer.ema_num_updates == 2
    for key in ("training_loss", "validation_loss",
                "validation_forces_mae", "validation_energy_mae"):
        assert np.isfinite(trainer.mae_dict[key]), key
    mols = _molecules(seed=13)
    res = evaluate(trainer.ema_model, [_port_batch(mols[:4], 5),
                                       _port_batch(mols[4:])],
                   ["energy", "forces"])
    assert len(res) == len(mols)
    n_nodes = sum(len(m["pos"]) for m in mols)
    assert res["forces"].shape == (n_nodes, 3)
    assert res["energy"].shape == (len(mols), 1)
    assert np.isfinite(res["forces"]).all()
