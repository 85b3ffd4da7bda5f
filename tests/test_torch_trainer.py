"""The port's supervised training path end to end (CPU): HDF5 dataset ->
``Trainer.set_dataset`` -> ``train`` -> checkpoints -> ``from_file``,
mirroring ``tests/test_train.py`` on its tiny QM9-like file, from the JAX
trainer's initial parameters:

- the loss decreases; ``best.pt``, ``last.pt``, ``trainer.pt`` and
  ``log.txt`` are written; parameter and gradient histograms;
- ``grad_acc`` 2 over two micro-batches equals one batch of both (params
  and EMA), and a lone micro-batch moves nothing;
- resume: the state comes back, a run resumed after two epochs ends bit
  for bit where an uninterrupted one does, and a run that stopped properly
  is not resumed (unless ``max_epochs`` is raised past its end);
- early stopping ends ``train`` (a plateau, the ``LR`` lower bound);
- the equivariance harness (rotated copies pass; mixed-size batches are
  skipped loudly), dataset statistics, profiling output;
- the port's ``Trainer`` against the JAX package's ``Trainer`` on one
  ``config_dipole``-shaped HDF5 file (narrow width), the same split and
  JAX's initial parameters: every training step's loss over one epoch of
  two subdivisions at 1e-4, and the parameters and EMA after it at 1e-4.
"""

import functools
import logging
import os
from functools import partial

import h5py
import jax
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu.data.compute_edge import (
    computeEdgeIndex as jcomputeEdgeIndex,
)
from equivariant_nn_zoo_tpu.data.dataset import (
    CondensedDataset as JCondensedDataset,
)
from equivariant_nn_zoo_tpu.models import layer_configs as jlc
from equivariant_nn_zoo_tpu.nn import PointwiseLinear as JPointwiseLinear
from equivariant_nn_zoo_tpu.run import Trainer as JTrainer
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu_torch.data import (
    Batch,
    CondensedDataset,
    GraphBatch,
    computeEdgeIndex,
)
from equivariant_nn_zoo_tpu_torch.models import get_config
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.nn import PointwiseLinear
from equivariant_nn_zoo_tpu_torch.ops.wigner import irreps_d
from equivariant_nn_zoo_tpu_torch.run import Trainer
from equivariant_nn_zoo_tpu_torch.utils import (
    build,
    finish_all_writes,
    init_parameters,
    load_jax_params,
    params_from_jax,
)
from test_torch_dipole import NARROW, dipole_config
from test_torch_edge_order import torch_threads_per_worker
from test_train import qm9_file  # noqa: F401  (the JAX tests' fixture)

torch_threads_per_worker()

SHIFTS = [0.0, -16.4, 0, 0, 0, 0, -1036.0, -1489.0, -2047.0, 0]
KEY_MAP = {"Z": ("species", "atom_types"), "R": "pos", "U0": "total_energy"}


@functools.lru_cache(maxsize=None)
def jax_initial_params(kind, **kw):
    """The JAX trainer's initial parameters (``model.init(PRNGKey(0))``,
    seed 0) of one test model, and its port config."""
    if kind == "energy":
        args = dict(l_max=1, edge_spherical="1x0e+1x1o", node_attrs="4x0e",
                    edge_radial="4x0e", num_types=10, r_max=4.0, **kw)
        jmc = jlc.addEnergyOutput(jlc.featureModel(**args), shifts=SHIFTS)
        mc = tlc.addEnergyOutput(tlc.featureModel(**args), shifts=SHIFTS)
    else:
        args = dict(l_max=2, edge_spherical="1x0e+1x1o+1x2e",
                    node_attrs="16x0e", edge_radial="8x0e", num_types=18,
                    r_max=5.0, **kw)
        jmc = dipole_config(jlc, JPointwiseLinear, **args)
        mc = dipole_config(tlc, PointwiseLinear, **args)
    params = jax.device_get(jbuild(jmc).init(jax.random.PRNGKey(0)))
    return params, mc


def make_trainer(qm9_file, workdir, num_layers=1, n_dim=8,  # noqa: F811
                 max_epochs=2, **extra):
    """``tests/test_train.py``'s ``make_trainer`` for the port: the same
    model, settings, dataset and seed, the model on JAX's initial
    parameters."""
    cfg = get_config("config_energy")
    extra.setdefault("early_stopping_patiences", {"validation_loss": 50})
    params, mc = jax_initial_params("energy", n_dim=n_dim,
                                    num_layers=num_layers)
    model = load_jax_params(build(mc), params)
    ds = CondensedDataset(
        path=qm9_file, key_map=KEY_MAP,
        preprocess=[partial(computeEdgeIndex, r_max=4.0)],
        type_names=cfg["data_config"]["type_names"])
    tr = Trainer(
        model=model, workdir=str(workdir), seed=0,
        data_config=dict(cfg["data_config"], n_train=64, n_val=16,
                         key_map=KEY_MAP),
        loss_coeffs={"total_energy": [1.0, "MSELoss"]},
        metrics_components={"total_energy": ["mae"]},
        metric_key="validation_loss", learning_rate=5e-3,
        optimizer_name="Adam", lr_scheduler_name="ReduceLROnPlateau",
        lr_scheduler_patience=1, lr_scheduler_factor=0.8, use_ema=True,
        ema_decay=0.99, max_epochs=max_epochs, batch_size=8,
        log_period=1000, **extra)
    tr.set_dataset(ds)
    return tr


def _state(tr):
    """Parameters, EMA parameters and optimizer moments, as numpy."""
    out = {f"p.{n}": p.detach().numpy().copy()
           for n, p in tr.model.named_parameters()}
    out.update({f"e.{n}": p.detach().numpy().copy()
                for n, p in tr.ema_model.named_parameters()})
    for i, st in tr.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"o.{i}.{k}"] = np.asarray(v).copy()
    return out


def test_train_loss_decreases(qm9_file, tmp_path):  # noqa: F811
    tr = make_trainer(qm9_file, tmp_path / "wd", max_epochs=3)
    tr.train()
    assert tr.stop_arg == "max epochs" and tr.iepoch == 3
    losses = tr.mae_dict
    assert np.isfinite(losses["validation_loss"])
    assert losses["validation_loss"] < 1e4
    for path in (tr.best_model_path, tr.last_model_path,
                 tr.trainer_save_path):
        assert os.path.exists(path), path
    log = open(tmp_path / "wd" / "log.txt").read()
    assert "! Stop training: max epochs" in log
    best = Trainer.load_model_from_training_session(str(tmp_path / "wd"))
    assert set(params_from_jax(best)) == {n for n, _ in
                                          tr.model.named_parameters()}


def test_watch_histograms(qm9_file, tmp_path):  # noqa: F811
    tr = make_trainer(qm9_file, tmp_path / "wd_watch", max_epochs=1,
                      watch_freq=2)
    tr.train()
    stats = tr.watch_dict
    p_hists = [k for k in stats if k.startswith("parameters/")
               and not k.endswith("_norm")]
    g_hists = [k for k in stats if k.startswith("gradients/")
               and not k.endswith("_norm")]
    assert p_hists and len(p_hists) == len(g_hists)
    counts, edges = stats[g_hists[0]]
    assert counts.sum() > 0 and len(edges) == len(counts) + 1
    assert all(np.isfinite(v) for k, v in stats.items()
               if k.endswith("_norm"))
    assert any(v > 0 for k, v in stats.items()
               if k.startswith("gradients/") and k.endswith("_norm"))


def test_grad_acc_matches_large_batch(qm9_file, tmp_path):  # noqa: F811
    tr_a = make_trainer(qm9_file, tmp_path / "wa", grad_acc=2)
    tr_b = make_trainer(qm9_file, tmp_path / "wb")
    ds = CondensedDataset(path=qm9_file, key_map=KEY_MAP,
                          preprocess=[partial(computeEdgeIndex, r_max=4.0)])
    items = [ds[i] for i in range(16)]

    def pad(group, n_cap, e_cap, g):
        return GraphBatch.from_batch(Batch.from_data_list(group), n_cap,
                                     e_cap, g, "cpu")

    micro1, micro2 = pad(items[:8], 256, 2048, 8), pad(items[8:], 256, 2048,
                                                       8)
    combined = pad(items, 512, 4096, 16)
    assert micro1.dropped == micro2.dropped == combined.dropped == 0
    tr_a.batch_step(micro1)
    assert tr_a.ema_num_updates == 0
    tr_a.batch_step(micro2)
    tr_b.batch_step(combined)
    assert tr_a.ema_num_updates == tr_b.ema_num_updates == 1
    a, b = _state(tr_a), _state(tr_b)
    for key in a:
        if not key.startswith("o."):
            np.testing.assert_allclose(a[key], b[key], rtol=2e-5, atol=2e-6,
                                       err_msg=key)
    before = _state(tr_a)
    tr_a.batch_step(micro1)
    after = _state(tr_a)
    for key in before:
        if not key.startswith("o."):
            assert np.array_equal(before[key], after[key]), key


def test_resume_restores_state(qm9_file, tmp_path):  # noqa: F811
    tr = make_trainer(qm9_file, tmp_path / "wd1", max_epochs=10)
    tr.init_metrics()
    tr.epoch_step()
    tr.save()
    finish_all_writes()
    tr2 = Trainer.from_file(tr.trainer_save_path,
                            model=build(jax_initial_params(
                                "energy", n_dim=8, num_layers=1)[1]))
    assert tr2.iepoch == tr.iepoch == 1
    assert tr2.best_metrics == pytest.approx(tr.best_metrics)
    assert tr2.current_lr == pytest.approx(tr.current_lr)
    assert tr2.optimizer.param_groups[0]["lr"] == tr2.current_lr
    a, b = _state(tr), _state(tr2)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert tr2.ema_num_updates == tr.ema_num_updates
    np.testing.assert_array_equal(tr2.train_idcs, tr.train_idcs)


def test_resume_is_bit_for_bit(qm9_file, tmp_path):  # noqa: F811
    """Three epochs in one run, and two epochs, a stop, ``from_file`` with
    ``max_epochs`` raised to 3 and the third epoch: the same parameters,
    EMA, optimizer moments, learning rate and early-stopping state."""
    whole = make_trainer(qm9_file, tmp_path / "whole", max_epochs=3)
    whole.train()
    first = make_trainer(qm9_file, tmp_path / "first", max_epochs=2)
    first.train()
    with pytest.raises(RuntimeError, match="properly stopped"):
        Trainer.from_file(first.trainer_save_path,
                          model=build(jax_initial_params(
                              "energy", n_dim=8, num_layers=1)[1]))
    resumed = Trainer.from_file(
        first.trainer_save_path, max_epochs=3,
        model=build(jax_initial_params("energy", n_dim=8,
                                       num_layers=1)[1]))
    ds = CondensedDataset(path=qm9_file, key_map=KEY_MAP,
                          preprocess=[partial(computeEdgeIndex, r_max=4.0)],
                          type_names=whole.dataset_train.type_names)
    resumed.set_dataset(ds)
    resumed.train()
    assert resumed.iepoch == whole.iepoch == 3
    assert resumed.stop_arg == "max epochs"
    a, b = _state(whole), _state(resumed)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert resumed.current_lr == whole.current_lr
    assert resumed.early_stopping_conds.state_dict() == \
        whole.early_stopping_conds.state_dict()
    assert resumed.mae_dict["validation_loss"] == \
        whole.mae_dict["validation_loss"]


def test_refuse_resume_after_stop(qm9_file, tmp_path):  # noqa: F811
    tr = make_trainer(qm9_file, tmp_path / "wd2", max_epochs=1)
    tr.train()
    assert tr.stop_arg == "max epochs"
    with pytest.raises(RuntimeError, match="properly stopped"):
        Trainer.from_file(tr.trainer_save_path, model=tr.model)


@pytest.mark.parametrize("kwargs,reason", [
    (dict(early_stopping_lower_bounds={"LR": 1.0}), "LR is smaller"),
    (dict(early_stopping_patiences={"validation_loss": 1},
          early_stopping_delta={"validation_loss": 1e9}), "has not reduced"),
])
def test_early_stopping_ends_training(qm9_file, tmp_path,  # noqa: F811
                                      kwargs, reason):
    tr = make_trainer(qm9_file, tmp_path / "wd_es", max_epochs=10, **kwargs)
    tr.train()
    assert reason in tr.stop_arg
    assert tr.iepoch == (1 if "LR" in reason else 2)


def test_equivariance_test_harness(qm9_file, tmp_path, caplog):  # noqa: F811
    ds = CondensedDataset(path=qm9_file, key_map=KEY_MAP,
                          preprocess=[partial(computeEdgeIndex, r_max=4.0)])
    ds.equivarianceTest(4)
    assert len(ds) == 4 and "_rotation_matrix" in ds.data
    s0, s1 = ds.get(0), ds.get(1)
    np.testing.assert_array_equal(s0["species"], s1["species"])
    d0 = np.linalg.norm(s0["pos"][:, None] - s0["pos"][None], axis=-1)
    d1 = np.linalg.norm(s1["pos"][:, None] - s1["pos"][None], axis=-1)
    np.testing.assert_allclose(d0, d1, atol=1e-4)
    # the harness on rotated copies: the invariant energy is too small to
    # test, positions and a covariant graph vector pass, a vector that does
    # not turn with its copy fails; the JAX harness says the same
    tr = make_trainer(qm9_file, tmp_path / "wd_rot", equivariance_test=True)
    gb = GraphBatch.from_batch(Batch.from_data_list([ds[i] for i in
                                                     range(4)]),
                               64, 512, 4, "cpu")
    mats = gb["_rotation_matrix"].numpy().reshape(-1, 3, 3)
    v = np.random.default_rng(0).normal(size=(1, 3))
    vectors = {"mu": np.concatenate([v @ irreps_d("1x1o", m).T
                                     for m in mats]),
               "nu": np.concatenate([v @ irreps_d("1x1o", m)
                                     for m in mats])}
    for key in vectors:
        gb.attrs[key] = ("graph", "1x1o")
    gb.attrs["dipole"] = ("node", "1x1o")
    with caplog.at_level(logging.INFO):
        tr.batch_step(gb, validation=True)
    messages = [r.message for r in caplog.records]
    assert "total_energy too small to perform equivariance test" in messages
    assert "equivariance test succeeded for pos" in messages
    verdicts = []
    for harness, values in (
            (tr.equivarianceTest, {k: torch.tensor(v, dtype=torch.float32)
                                   for k, v in vectors.items()}),
            (partial(JTrainer.equivarianceTest, tr), vectors)):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            harness(values, gb)
        verdicts.append([r.message for r in caplog.records])
    assert verdicts[0][0] == "equivariance test succeeded for mu"
    assert verdicts[0][1].startswith("equivariance test failed for nu")
    assert verdicts[0] == verdicts[1]
    # and a dipole model's per-node dipoles on the rotated copies (the
    # head's weights scaled up: at this init its dipoles are ~1e-5, under
    # the harness's absolute floor of 1e-3)
    model = build(dipole_config(tlc, PointwiseLinear, **NARROW))
    init_parameters(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.dipole_output.parameters():
            p.mul_(1e4)
        out = model(gb)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        tr.equivarianceTest({"dipole": out["dipole"]},
                            gb.replace(dipole=out["dipole"]))
    assert [r.message for r in caplog.records] == [
        "equivariance test succeeded for dipole"]


def test_equivariance_test_skips_mixed_size_batch(qm9_file, tmp_path,  # noqa
                                                  caplog):
    tr = make_trainer(qm9_file, tmp_path / "wd_eq")
    batch = next(iter(tr.dl_train))
    g = int(batch["_graph_mask"].sum())
    counts = np.bincount(batch["_node_segment"].numpy(), minlength=g)[:g]
    assert len(set(counts.tolist())) > 1, "fixture should have mixed sizes"
    batch.data["_rotation_matrix"] = torch.eye(3).reshape(1, 9).repeat(
        batch["pos"].shape[0], 1)
    with caplog.at_level(logging.INFO):
        tr.equivarianceTest({"pos": batch["pos"]}, batch)
    assert any("skipped" in r.message for r in caplog.records)


def test_statistics(qm9_file):  # noqa: F811
    ds = CondensedDataset(path=qm9_file, key_map=KEY_MAP,
                          type_names=[str(i) for i in range(10)])
    (uniq, counts), = ds.statistics(["atom_types-count"])
    assert set(uniq.tolist()) <= {1, 6, 7, 8}
    (rms,), = ds.statistics(["pos-rms"])
    assert rms > 0
    shifts, _ = ds.statistics(["total_energy-per-atom_types-mean_std"])[0]
    shifts = np.asarray(shifts).reshape(-1)
    assert abs(shifts[6] - (-1036.0)) < 60
    assert abs(shifts[1] - (-16.4)) < 60


def test_profiling_writes_tables(qm9_file, tmp_path):  # noqa: F811
    tr = make_trainer(qm9_file, tmp_path / "wd_prof", max_epochs=1,
                      profiling=True)
    tr.train()
    text = open(tmp_path / "wd_prof" / "profiling.txt").read()
    assert text.startswith("# host time of the training batches")
    assert "# family" in text and "aten::" in text
    assert os.path.getsize(tmp_path / "wd_prof" / "profile" /
                           "trace.json") > 0


# ------------------------------------------------ against the JAX trainer

DIPOLE_ATTRS = {"R": ("node", "1x1o"), "Z": ("node", "1x0e"),
                "dipole": ("node", "1x1o"), "_n_nodes": ("graph", "1x0e")}


@pytest.fixture(scope="module")
def dipole_file(tmp_path_factory):
    """48 dipole molecules (``bench.py``'s shapes, fewer atoms), N(0, 1)
    per-node dipoles."""
    rng = np.random.default_rng(11)
    path = tmp_path_factory.mktemp("data") / "dipole_tiny.hdf5"
    R, Z, D, N = [], [], [], []
    for _ in range(48):
        n = int(rng.integers(4, 10))
        R.append(rng.normal(size=(n, 3)) * 1.4)
        Z.append(rng.integers(0, 18, size=(n, 1)))
        D.append(rng.normal(size=(n, 3)))
        N.append([n])
    with h5py.File(path, "w") as f:
        f["R"] = np.concatenate(R).astype(np.float32)
        f["Z"] = np.concatenate(Z).astype(np.int64)
        f["dipole"] = np.concatenate(D).astype(np.float32)
        f["_n_nodes"] = np.asarray(N, np.int64)
        for key, value in DIPOLE_ATTRS.items():
            f.attrs[key] = value
    return str(path)


def test_trainer_matches_jax_trainer(dipole_file, tmp_path):
    """One epoch in two subdivisions (``config_dipole``'s settings at a
    narrow width, batch 8): the same split and batches, every step's loss
    at 1e-4, the subdivisions' logged losses and learning rates, then the
    parameters and the EMA at 1e-4."""
    key_map = {"Z": ("species", "atom_types"), "R": "pos"}
    cfg = get_config("config_dipole")
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    settings.update(max_epochs=1, epoch_subdivision=2, log_period=1000,
                    learning_rate=5e-3)
    data_config = {"n_train": 32, "n_val": 16, "train_val_split": "random",
                   "shuffle": True, "key_map": key_map, "num_workers": 2}
    jparams, mc = jax_initial_params("dipole", n_dim=8, num_layers=2)
    jargs = dict(l_max=2, edge_spherical="1x0e+1x1o+1x2e",
                 node_attrs="16x0e", edge_radial="8x0e", num_types=18,
                 r_max=5.0, n_dim=8, num_layers=2)
    jtr = JTrainer(model=jbuild(dipole_config(jlc, JPointwiseLinear,
                                              **jargs)),
                   workdir=str(tmp_path / "jax"), seed=0,
                   data_config=data_config, batch_size=8, **settings)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(jax.device_get(jtr.params))):
        np.testing.assert_array_equal(a, b)
    jtr.set_dataset(JCondensedDataset(
        path=dipole_file, key_map=key_map,
        preprocess=[partial(jcomputeEdgeIndex, r_max=5.0)]))
    tr = Trainer(load_jax_params(build(mc), jparams),
                 workdir=str(tmp_path / "port"), seed=0,
                 data_config=data_config, batch_size=8, **settings)
    tr.set_dataset(CondensedDataset(
        path=dipole_file, key_map=key_map,
        preprocess=[partial(computeEdgeIndex, r_max=5.0)]))
    np.testing.assert_array_equal(tr.train_idcs, jtr.train_idcs)

    def record(trainer, seen):
        step = trainer.batch_step

        def wrapped(data, validation=False):
            step(data, validation=validation)
            if not validation:
                seen.append(float(trainer.batch_losses["loss"]))
        trainer.batch_step = wrapped

    logs = {}
    for name, trainer in (("jax", jtr), ("port", tr)):
        seen = logs.setdefault(name, [])
        record(trainer, seen)
        divisions = []
        end = trainer.end_of_epoch_log

        def logged(end=end, trainer=trainer, divisions=divisions):
            end()
            divisions.append((trainer.mae_dict["training_loss"],
                              trainer.mae_dict["validation_loss"]))
        trainer.end_of_epoch_log = logged
        trainer.train()
        logs[name + "_divisions"] = divisions
        logs[name + "_lr"] = trainer.current_lr
    assert len(logs["port"]) == len(logs["jax"]) == 4
    for got, want in zip(logs["port"], logs["jax"]):
        assert abs(got - want) <= 1e-4 * abs(want), (logs["port"],
                                                      logs["jax"])
    assert len(logs["port_divisions"]) == 2
    for got, want in zip(logs["port_divisions"], logs["jax_divisions"]):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert logs["port_lr"] == logs["jax_lr"]
    want = params_from_jax(jax.device_get(jtr.params))
    want_ema = params_from_jax(jax.device_get(jtr.ema["params"]))
    ema = dict(tr.ema_model.named_parameters())
    for name, p in tr.model.named_parameters():
        for got, ref in ((p, want[name]), (ema[name], want_ema[name])):
            err = (got.detach() - ref).abs().max().item()
            assert err <= 1e-4 * max(ref.abs().max().item(), 1e-2), name
    assert tr.ema_num_updates == int(jtr.ema["num_updates"]) == 4
