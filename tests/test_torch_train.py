"""Parity of the port's ``config_energy`` training step with the JAX package
(CPU, f32), at the small size of ``tests/test_torch_model.py``: n_dim 8,
l_max 2, 3 layers, 6 molecules with ``total_energy`` labels.

- the loss ``Loss({"total_energy": [1e3, "MSELoss"]})`` and the metrics,
  with padded graphs contributing nothing (rel 1e-5);
- every parameter's gradient against ``jax.value_and_grad`` of
  ``model.apply`` + ``Loss`` on the JAX default CPU path, computed once for
  the file (rel-linf 1e-4 of each tensor's max|grad|: float32, different
  summation orders through three layers);
- Adam + EMA fed the same gradients as ``optax.adam`` and
  ``make_ema_update`` for 3 steps (atol 1e-6; shared gradients keep Adam's
  g / (|g| + eps) from amplifying float32 noise on tiny gradients);
- the learning-rate schedulers on a fixed metric sequence;
- the card path's autograd Functions, with their launches routed to the
  plain contract functions, against plain autograd on the whole model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from equivariant_nn_zoo_tpu.data import Batch as JBatch
from equivariant_nn_zoo_tpu.data import Data as JData
from equivariant_nn_zoo_tpu.data import GraphBatch as JGraphBatch
from equivariant_nn_zoo_tpu.models import layer_configs as jlc
from equivariant_nn_zoo_tpu.run import loss as jloss
from equivariant_nn_zoo_tpu.run import lr_scheduler as jsched
from equivariant_nn_zoo_tpu.run import metrics as jmetrics
from equivariant_nn_zoo_tpu.run.trainer import make_ema_update
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu_torch.data import (
    Batch,
    Data,
    GraphBatch,
    computeEdgeIndex,
)
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as species_sc_mod
from equivariant_nn_zoo_tpu_torch.run import Loss, Metrics, Trainer
from equivariant_nn_zoo_tpu_torch.run import lr_scheduler as tsched
from equivariant_nn_zoo_tpu_torch.utils import (
    build,
    load_jax_params,
    params_from_jax,
)

SHIFTS = [-0.5, -1.0, 0.0, 0.5, 1.0, 1.5, -2.0, -3.0, 2.5, 0.25]
MODEL_KW = dict(n_dim=8, l_max=2, node_attrs="4x0e", edge_radial="4x0e",
                num_types=10, num_layers=3, r_max=3.0)
ATTRS = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
         "atom_types": ("node", "1x0e"), "total_energy": ("graph", "1x0e"),
         "_n_edges": ("graph", "1x0e")}
LOSS = {"total_energy": [1e3, "MSELoss"]}
N_GRAPHS = 8  # 6 molecules: two padded graphs


def _molecules(seed=0, n_mol=6):
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(5, 12))
        d = {"pos": rng.normal(size=(n, 3)) * 1.2,
             "species": rng.choice([1, 6, 7, 8], size=(n, 1)),
             "total_energy": rng.normal(size=(1, 1)) + 0.5 * n}
        d["atom_types"] = d["species"]
        out, _ = computeEdgeIndex(d, dict(ATTRS), r_max=3.0)
        d.update(out)
        mols.append(d)
    return mols


def _port_batch(mols):
    host = Batch.from_data_list([Data(dict(ATTRS), **m) for m in mols])
    gb = GraphBatch.from_batch(host, 128, 1024, N_GRAPHS, "cpu")
    assert gb.dropped == 0
    return gb


def _port_model(params):
    model = build(tlc.addEnergyOutput(tlc.featureModel(**MODEL_KW), SHIFTS))
    return load_jax_params(model, params)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def reference():
    """JAX parameters, and the loss and gradients of one step on the
    default CPU path (jitted: computed once for the file)."""
    jmodel = jbuild(jlc.addEnergyOutput(jlc.featureModel(**MODEL_KW),
                                        SHIFTS))
    params = jmodel.init(jax.random.PRNGKey(0))
    mols = _molecules()
    host = JBatch.from_data_list([JData(dict(ATTRS), **m) for m in mols])
    jgb = JGraphBatch.from_batch(host, 128, 1024, N_GRAPHS)
    loss = jloss.Loss(LOSS)

    def f(p):
        out = jmodel.apply(p, jgb)
        return loss(out.data, jgb.data)[0]

    value, grads = jax.jit(jax.value_and_grad(f))(params)
    return dict(params=params, mols=mols, loss=float(value),
                grads=params_from_jax(jax.device_get(grads)))


def _port_step_grads(model, gb):
    model.zero_grad()
    out = model(gb)
    loss, _ = Loss(LOSS)(out.data, gb.data)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in
                         model.named_parameters()}


# -------------------------------------------------------------- loss, metrics

def _pred_ref(seed):
    """Graph-level predictions and labels with padded rows holding junk."""
    rng = np.random.default_rng(seed)
    G, g = 10, 7
    mask = np.zeros((G, 1), np.float32)
    mask[:g] = 1
    pred = rng.normal(size=(G, 1)).astype(np.float32)
    ref = rng.normal(size=(G, 1)).astype(np.float32)
    pred[g:] = 1e6
    species = rng.integers(0, 5, size=(G, 1))
    return (dict(total_energy=pred, atom_types=species),
            dict(total_energy=ref, _graph_mask=mask,
                 _n_nodes=rng.integers(3, 9, size=(G, 1)).astype(np.float32)))


@pytest.mark.parametrize("coeffs", [LOSS, {"total_energy": [2.0, "L1Loss"]},
                                    {"total_energy": "PerAtomMSELoss"}])
def test_loss_matches_jax(coeffs):
    pred, ref = _pred_ref(0)
    want, want_c = jloss.Loss(coeffs)(
        {k: jnp.asarray(v) for k, v in pred.items()},
        {k: jnp.asarray(v) for k, v in ref.items()})
    got, got_c = Loss(coeffs)({k: torch.tensor(v) for k, v in pred.items()},
                              {k: torch.tensor(v) for k, v in ref.items()})
    assert _rel(float(got), float(want)) <= 1e-5
    assert _rel(float(got_c["total_energy"]),
                float(want_c["total_energy"])) <= 1e-5


@pytest.mark.parametrize("component", [
    ("total_energy", "mae"), ("total_energy", "rmse"),
    ("total_energy", "mae", {"PerSpecies": True}),
    ("total_energy", "rmse", {"PerAtom": True}),
])
def test_metrics_match_jax(component):
    jm, tm = jmetrics.Metrics([component]), Metrics([component])
    for seed in (1, 2):
        pred, ref = _pred_ref(seed)
        jm({k: jnp.asarray(v) for k, v in pred.items()},
           {k: jnp.asarray(v) for k, v in ref.items()})
        tm({k: torch.tensor(v) for k, v in pred.items()},
           {k: torch.tensor(v) for k, v in ref.items()})
    want, _ = jm.flatten_metrics(jm.current_result())
    got, _ = tm.flatten_metrics(tm.current_result())
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k


# ------------------------------------------------------------------ gradients

def test_step_gradients_match_jax(reference):
    model = _port_model(reference["params"])
    loss, grads = _port_step_grads(model, _port_batch(reference["mols"]))
    assert _rel(loss, reference["loss"]) <= 1e-5
    assert set(grads) == set(reference["grads"])
    for name, want in reference["grads"].items():
        assert _rel(grads[name].numpy(), want.numpy()) <= 1e-4, name


def test_functions_match_plain_autograd(reference, monkeypatch):
    """Every parameter's gradient through ``FullConvFunction`` and
    ``SpeciesScalarFCTPFunction`` (launches routed to the plain contracts
    of K1/K2 and K3/K3b) equals plain autograd's."""
    model = _port_model(reference["params"])
    gb = _port_batch(reference["mols"])
    want_loss, want = _port_step_grads(model, gb)
    for cls, mod in ((full_conv_mod.FullConv, full_conv_mod),
                     (species_sc_mod.SpeciesScalarFCTP, species_sc_mod)):
        monkeypatch.setattr(cls, "forward", cls.launch)
    monkeypatch.setattr(full_conv_mod, "launch_forward",
                        lambda conv, *a, order=None: conv.plain_forward(*a))
    monkeypatch.setattr(full_conv_mod, "launch_backward",
                        lambda conv, *a, order=None: conv.plain_backward(*a))
    monkeypatch.setattr(species_sc_mod, "launch_forward",
                        lambda sc, *a: sc.table_product(*a))
    monkeypatch.setattr(species_sc_mod, "launch_backward",
                        lambda sc, *a: sc.plain_backward(*a))
    got_loss, got = _port_step_grads(model, gb)
    assert _rel(got_loss, want_loss) <= 1e-6
    for name in want:
        assert _rel(got[name].numpy(), want[name].numpy()) <= 1e-5, name


# -------------------------------------------------------- optimizer and EMA

def _jax_copy(model):
    """The parameters as JAX arrays that share no memory with the model
    (``jnp.asarray`` of a CPU numpy view may alias it, and the optimizer
    updates in place)."""
    return {n: jnp.asarray(p.detach().numpy().copy())
            for n, p in model.named_parameters()}


def test_adam_and_ema_match_optax(reference):
    model = _port_model(reference["params"])
    trainer = Trainer(model, LOSS, learning_rate=1e-2, use_ema=True,
                      ema_decay=0.99, ema_use_num_updates=True)
    names = [n for n, _ in model.named_parameters()]
    params = _jax_copy(model)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    ema = {"params": jax.tree_util.tree_map(jnp.copy, params),
           "num_updates": jnp.zeros((), jnp.int32)}
    ema_update = make_ema_update(0.99, True)
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = {n: (rng.normal(size=params[n].shape)
                     * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
                 for n in names}
        for n, p in model.named_parameters():
            p.grad = torch.tensor(grads[n])
        trainer.apply_gradients()
        updates, opt_state = opt.update(
            {n: jnp.asarray(g) for n, g in grads.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = ema_update(ema, params)
    ema_params = dict(trainer.ema_model.named_parameters())
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[n], rtol=0,
                                   atol=1e-6, err_msg=n)
        np.testing.assert_allclose(ema_params[n].numpy(),
                                   ema["params"][n], rtol=0, atol=1e-6,
                                   err_msg=n)
        assert ema_params[n].data_ptr() != p.data_ptr()
    assert trainer.ema_num_updates == int(ema["num_updates"]) == 3


def test_clip_by_global_norm_matches_optax():
    model = torch.nn.Linear(4, 3)
    trainer = Trainer(model, LOSS, max_gradient_norm=0.5)
    params = _jax_copy(model)
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2))
    opt_state = opt.init(params)
    rng = np.random.default_rng(4)
    for scale in (10.0, 0.01):  # clipped, then not
        grads = {n: (scale * rng.normal(size=params[n].shape)).astype(
            np.float32) for n in params}
        for n, p in model.named_parameters():
            p.grad = torch.tensor(grads[n])
        trainer.apply_gradients()
        updates, opt_state = opt.update(
            {n: jnp.asarray(g) for n, g in grads.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[n], rtol=0,
                                   atol=1e-6, err_msg=n)


# ------------------------------------------------------------- schedulers

@pytest.mark.parametrize("name,kwargs", [
    ("ReduceLROnPlateau", dict(factor=0.8, patience=1)),
    ("CosineAnnealingWarmRestarts", dict(T_0=3, T_mult=2)),
])
def test_scheduler_matches_jax(name, kwargs):
    metrics = [5.0, 4.0, 4.0, 4.1, 3.0, 3.0, 3.0, 3.0, 2.99999, 1.0, 1.0]
    want = getattr(jsched, name)(lr=1e-2, **kwargs)
    got = getattr(tsched, name)(lr=1e-2, **kwargs)
    for m in metrics:
        assert got.step(m) == want.step(m)
    assert got.state_dict() == want.state_dict()


# ---------------------------------------------------------------- trainer

def test_trainer_epochs_on_config_energy_hyperparameters(reference):
    """Two epochs with ``config_energy``'s own training settings: finite
    losses, the plateau scheduler stepped on the validation loss, one EMA
    update per training step, validation on the EMA copy."""
    from equivariant_nn_zoo_tpu_torch.models import get_config

    cfg = get_config("config_energy")
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    model = _port_model(reference["params"])
    trainer = Trainer(model, **settings)
    train = [_port_batch(_molecules(seed)) for seed in (10, 11)]
    val = [_port_batch(_molecules(12))]
    for _ in range(2):
        trainer.epoch_step(train, val)
    assert trainer.iepoch == 2 and trainer.ema_num_updates == 4
    for key in ("training_loss", "validation_loss",
                "validation_total_energy_mae"):
        assert np.isfinite(trainer.mae_dict[key]), key
    assert trainer.lr_sched.best is not None
    assert trainer.current_lr == trainer.optimizer.param_groups[0]["lr"]
    live = dict(model.named_parameters())
    assert any(not torch.equal(p, live[n]) for n, p in
               trainer.ema_model.named_parameters())
