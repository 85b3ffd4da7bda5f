"""The port's command lines and their pieces against the JAX package's
(CPU, f32; narrow models, as ``tests/test_train.py`` narrows them):

- every config's key set (top level, ``data_config``, ``model_config``)
  is the JAX config's for the same name and spec, up to the differences
  by design listed in ``BY_DESIGN``; ``config_diffusion`` carries
  ``saveMol``, which writes JAX's ``.gro`` file;
- ``_dp_ranks`` keeps ``_make_dp_mesh``'s guards;
- the regression trainer on a tiny HDF5 leaves ``best.pt``, ``trainer.pt``
  and ``stdout.txt``, and ``--resume_from`` continues at the next epoch;
  ``--dp 2`` (two spawned gloo ranks, each loading half of every global
  batch) trains like one rank on the whole batch (1e-5);
- the ``Trainer`` that the CLI builds for ``config_energy`` has the
  settings of the one JAX's ``train_regression`` builds;
- the diffusion loop on ``config_diffusion_CA`` (``tests/test_train.py``'s
  protein file, the model narrowed) writes its checkpoints, which restore
  the state; with snapshot sampling ``config_diffusion`` writes ``.gro``
  files; on ``config_diffusion`` with JAX's keys replayed, its losses and
  last checkpoint equal the JAX loop's (1e-4), its plateau rate logged
  and, as there, never applied;
- JAX's CLI trains a narrow model for one epoch; both inference CLIs
  evaluate its ``best.pt`` on the same HDF5, and the port's dump equals
  JAX's (rel-linf 1e-5);
- ``TrainerWandB`` logs what JAX's logs, through a stub ``wandb``; without
  ``--wandb`` nothing imports ``wandb``;
- ``countParameters``, ``register_config`` and the ``configs`` alias; the
  CLIs default to the card and import without JAX, absl, h5py or wandb.
"""

import importlib
import importlib.abc
import os
import subprocess
import sys
import types
from functools import partial
from types import SimpleNamespace

import h5py
import jax
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu import configs as jconfigs
from equivariant_nn_zoo_tpu.data import Batch as JBatch
from equivariant_nn_zoo_tpu.models import get_config as jget_config
from equivariant_nn_zoo_tpu.models import layer_configs as jlc
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu.utils import countParameters as jcount
from equivariant_nn_zoo_tpu.utils import saveload as jsaveload
from equivariant_nn_zoo_tpu_torch import configs, inference, train
from equivariant_nn_zoo_tpu_torch.data import Batch
from equivariant_nn_zoo_tpu_torch.models import (
    build_model,
    get_config,
    register_config,
)
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.run import sde_utils
from equivariant_nn_zoo_tpu_torch.utils import (
    build,
    countParameters,
    load_file,
    load_jax_params,
    saveMol,
)
from test_torch_edge_order import torch_threads_per_worker
from test_train import qm9_file  # noqa: F401  (the JAX tests' fixture)

torch_threads_per_worker()

# the module (``models`` exports its ``get_config`` under the same name)
tca = importlib.import_module(
    "equivariant_nn_zoo_tpu_torch.models.config_diffusion_CA")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY_MAP = {"Z": ("species", "atom_types"), "R": "pos", "U0": "total_energy"}
NARROW = dict(n_dim=4, l_max=1, edge_spherical="1x0e+1x1o",
              node_attrs="4x0e", edge_radial="4x0e", num_types=10,
              num_layers=1, r_max=4.0)
TOL = 1e-5

# (section, key): why the port's config differs from JAX's there
BY_DESIGN = {
    ("model_config", "jit"): "the JAX configs ask for the compiled step; "
                             "the port runs eagerly (ROADMAP queue 1 item 2)",
    ("model_config", "edge_seed"): "the protein edge layer's random pairs "
                                   "come from a generator seeded with it, "
                                   "not from a key folded with t",
    ("model_config", "compute_dtype"): "the port's layers take the compute "
                                       "dtype from the model config; JAX's "
                                       "read E3_COMPUTE_DTYPE from the "
                                       "environment",
}
SPECS = [("config_energy", None), ("config_energy_force", None),
         ("config_dipole", None), ("config_dipole", "profiling"),
         ("config_hamiltonian", None), ("config_diffusion", ""),
         ("config_diffusion", "nll"), ("config_diffusion_CA", None),
         ("config_diffusion_backbone", None)]


def _keys(cfg, jcfg):
    """(section, key) of each side: the top level, ``data_config`` and
    ``model_config``."""
    got, want = set(), set()
    for section in ("top", "data_config", "model_config"):
        mine = cfg if section == "top" else cfg[section]
        theirs = jcfg if section == "top" else jcfg[section]
        got |= {(section, k) for k in mine}
        want |= {(section, k) for k in theirs}
    return got, want


@pytest.mark.parametrize("name,spec", SPECS)
def test_config_keys_match_jax(name, spec):
    cfg, jcfg = get_config(name, spec), jget_config(name, spec)
    got, want = _keys(cfg, jcfg)
    assert (got ^ want) <= set(BY_DESIGN), sorted(got ^ want)


def test_config_diffusion_saves_molecules_as_jax_does(tmp_path):
    """The port's ``config_diffusion`` carries ``saveMol`` (both specs),
    and it writes the file JAX's ``saveMol`` writes."""
    for spec in ("", "nll"):
        assert get_config("config_diffusion", spec)["saveMol"] is saveMol
    rng = np.random.default_rng(0)
    items = [{"pos": rng.normal(size=(n, 3)).astype(np.float32),
              "species": rng.integers(0, 18, size=(n, 1)), "_n_nodes": n}
             for n in (5, 7)]
    attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
             "_n_nodes": ("graph", "1x0e")}
    port = saveMol(Batch.from_data_list(items, attrs), idx=1,
                   workdir=str(tmp_path), filename="port")
    want = jsaveload.saveMol(JBatch.from_data_list(items, attrs), idx=1,
                             workdir=str(tmp_path), filename="jax")
    assert open(port).read() == open(want).read()
    assert open(port).read().splitlines()[1] == "7"


def test_dp_ranks_keeps_the_mesh_guards():
    """``tests/test_train.py::test_make_dp_mesh_guards`` for ``_dp_ranks``,
    and the same answer as ``_make_dp_mesh`` over the 8 virtual devices."""
    import train as jtrain

    with pytest.raises(ValueError, match="not divisible"):
        train._dp_ranks(7, 4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        jtrain._make_dp_mesh(7, SimpleNamespace(dp=4))
    for batch, dp in ((7, 0), (8, 1), (8, 4), (8, 0), (8, 2)):
        mesh = jtrain._make_dp_mesh(batch, SimpleNamespace(dp=dp))
        want = 1 if mesh is None else mesh.devices.size
        assert train._dp_ranks(batch, dp, len(jax.local_devices())) == want
    assert train._dp_ranks(128, 0, 1) == 1


def tiny_config(path, max_epochs=2, batch_size=8, n_train=32, n_val=16):
    """``config_energy`` narrowed as ``tests/test_train.py`` narrows it,
    on ``path``."""
    cfg = get_config("config_energy")
    cfg["model_config"] = tlc.addEnergyOutput(tlc.featureModel(**NARROW),
                                              shifts=[0.0] * 10)
    cfg.update(batch_size=batch_size, max_epochs=max_epochs)
    cfg["data_config"] = dict(cfg["data_config"], path=path, n_train=n_train,
                              n_val=n_val, key_map=KEY_MAP, num_workers=0)
    return cfg


def _tiny_cli(spec=None):
    """The registered CLI test config: ``tiny_config`` on the file and with
    the settings in the environment (spawned ranks see them too)."""
    return tiny_config(os.environ["E3_CLI_DATA"],
                       max_epochs=int(os.environ["E3_CLI_EPOCHS"]),
                       batch_size=int(os.environ["E3_CLI_BATCH"]))


def _cli(monkeypatch, path, epochs=2, batch=8):
    monkeypatch.setenv("E3_CLI_DATA", path)
    monkeypatch.setenv("E3_CLI_EPOCHS", str(epochs))
    monkeypatch.setenv("E3_CLI_BATCH", str(batch))
    register_config("config_tiny_cli", _tiny_cli)


def test_regression_cli_writes_and_resumes(qm9_file, tmp_path,  # noqa: F811
                                           monkeypatch):
    _cli(monkeypatch, qm9_file)
    argv = ["--config", "config_tiny_cli", "--device", "cpu", "--workdir",
            str(tmp_path), "--name", "r", "--log_period", "1000"]
    first = train.run(argv)
    wd = tmp_path / "default_project" / "r"
    assert {"best.pt", "trainer.pt", "stdout.txt", "log.txt"} <= \
        set(os.listdir(wd))
    assert first.iepoch == 2 and first.stop_arg == "max epochs"
    assert "! Stop training: max epochs" in (wd / "stdout.txt").read_text()
    saved = load_file(str(wd / "trainer.pt"), enforced_format="pickle")
    assert saved["progress"]["iepoch"] == 2
    # --resume_from with max_epochs raised continues at epoch 3
    monkeypatch.setenv("E3_CLI_EPOCHS", "3")
    resumed = train.run(argv + ["--resume_from", str(wd / "trainer.pt")])
    assert resumed.iepoch == 3
    assert "! Restarting training" in (wd / "log.txt").read_text()
    np.testing.assert_array_equal(resumed.train_idcs, first.train_idcs)


def test_dp_two_ranks_train_like_one(qm9_file, tmp_path,  # noqa: F811
                                     monkeypatch):
    """``--dp 2`` spawns two gloo ranks, each loading its half of every
    global batch of 8 (the same shuffle on both): the global batches of
    one rank, so the same parameters (1e-5)."""
    _cli(monkeypatch, qm9_file)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the spawned ranks'
    outs = {}
    for dp in ("1", "2"):
        train.run(["--config", "config_tiny_cli", "--device", "cpu",
                   "--workdir", str(tmp_path), "--name", dp, "--dp", dp,
                   "--log_period", "1000"])
        outs[dp] = load_file(str(tmp_path / "default_project" / dp /
                                 "trainer.pt"), enforced_format="pickle")
    assert outs["2"]["progress"]["iepoch"] == 2
    flat = {dp: dict(_flat(o["model_params"])) for dp, o in outs.items()}
    for k, want in flat["1"].items():
        np.testing.assert_allclose(flat["2"][k], want, rtol=TOL, atol=1e-6,
                                   err_msg=k)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def test_cli_trainer_settings_match_jax(qm9_file, tmp_path,  # noqa: F811
                                        monkeypatch):
    """The ``Trainer`` of the port's ``train_regression`` and of JAX's, on
    ``config_energy`` (narrowed, on the tiny file), before any step."""
    import train as jtrain
    from equivariant_nn_zoo_tpu.run import trainer as jtrainer_mod

    monkeypatch.setattr(jtrainer_mod.Trainer, "train", lambda self: None)
    jcfg = jget_config("config_energy")
    jcfg.batch_size = 8
    jcfg.data_config.path = qm9_file
    jcfg.data_config.n_train = 32
    jcfg.data_config.n_val = 16
    jcfg.data_config.key_map = KEY_MAP
    jcfg.model_config = jlc.addEnergyOutput(jlc.featureModel(**NARROW),
                                            shifts=[0.0] * 10)
    want = jtrain.train_regression(jcfg, SimpleNamespace(
        wandb=False, workdir=str(tmp_path / "jax"), seed=0,
        equivariance_test=False, profiling=False, log_period=100,
        save_period=2000, resume_from=None, dp=1))
    cfg = tiny_config(qm9_file)
    cfg["max_epochs"] = get_config("config_energy")["max_epochs"]
    args = train.parse_args(["--config", "config_energy", "--device", "cpu",
                             "--workdir", str(tmp_path / "port")])
    got = train.build_regression_trainer(cfg, args)
    for key in ("learning_rate", "batch_size", "max_epochs", "metric_key",
                "use_ema", "ema_decay", "ema_use_num_updates",
                "optimizer_name", "lr_scheduler_name", "grad_acc",
                "epoch_subdivision", "log_period", "save_period", "seed"):
        assert getattr(got, key) == getattr(want, key), key
    assert _plain(got.loss_coeffs) == _plain(want.loss_coeffs)
    np.testing.assert_array_equal(got.train_idcs, want.train_idcs)
    np.testing.assert_array_equal(got.val_idcs, want.val_idcs)
    for dl, jdl in ((got.dl_train, want.dl_train), (got.dl_val, want.dl_val)):
        assert (dl.node_capacity, dl.edge_capacity, len(dl)) == \
            (jdl.node_capacity, jdl.edge_capacity, len(jdl))
    assert got.lr_sched.patience == want.lr_sched.patience
    assert got.lr_sched.factor == want.lr_sched.factor
    es, jes = got.early_stopping_conds, want.early_stopping_conds
    assert {k: w.patience for k, w in es._watches.items()} == \
        {k: w.patience for k, w in jes._watches.items()}
    assert [(c.key, c.threshold, c.side) for c in es._checks] == \
        [(c.key, c.threshold, c.side) for c in jes._checks]
    assert os.path.exists(tmp_path / "port" / "trainer.pt")


def _plain(value):
    if hasattr(value, "to_dict"):
        value = value.to_dict()
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


def _protein_file(tmp_path):
    """``tests/test_train.py::test_train_cli_diffusion_driver``'s file."""
    rng = np.random.default_rng(7)
    items = []
    for _ in range(8):
        n = int(rng.integers(24, 40))
        t = np.cumsum(rng.normal(size=(n, 3)) * 2.0, axis=0)
        items.append({"species": rng.integers(0, 20, size=(n, 1)),
                      "chain_id": (np.arange(n) // 24).reshape(-1, 1),
                      "mask": np.ones((n, 1), np.int64), "_n_nodes": n,
                      "CA": t.astype(np.float32)})
    attrs = {"species": ("node", "1x0e"), "chain_id": ("node", "1x0e"),
             "mask": ("node", "1x0e"), "_n_nodes": ("graph", "1x0e"),
             "CA": ("node", "1x1o")}
    path = tmp_path / "pdb_0.hdf5"
    Batch.from_data_list(items, attrs).dumpHDF5(str(path))
    return str(path)


def _sde_file(tmp_path, n_iters=4, snapshot=False, num_scales=10):
    path = tmp_path / "sde_tiny.py"
    path.write_text(
        "from equivariant_nn_zoo_tpu_torch.models.sde_config import "
        "get_config as g\n"
        "def get_config():\n"
        "    c = g()\n"
        f"    c['training']['n_iters'] = {n_iters}\n"
        f"    c['training']['snapshot_sampling'] = {snapshot}\n"
        f"    c['model']['num_scales'] = {num_scales}\n"
        "    return c\n")
    return str(path)


def _diffusion_args(tmp_path, sde_config, workdir, **kw):
    return SimpleNamespace(**dict(
        dict(sde_config=sde_config, workdir=str(workdir), seed=0,
             resume_from=None, wandb=False, log_period=2, eval_period=2,
             save_period=4, device="cpu"), **kw))


def test_diffusion_loop_on_the_protein_config(tmp_path, monkeypatch):
    """``tests/test_train.py::test_train_cli_diffusion_driver`` for the
    port (the model narrowed to n_dim 8, 2 layers): ``checkpoints/4.pth``
    and the meta checkpoint, a JAX-named parameter tree, finite losses;
    the checkpoint restores the state bit for bit."""
    monkeypatch.setitem(tca.MODEL, "n_dim", 8)
    monkeypatch.setitem(tca.MODEL, "num_layers", 2)
    cfg = get_config("config_diffusion_CA")
    cfg["batch_size"] = 2
    cfg["data_config"] = dict(cfg["data_config"],
                              path=[_protein_file(tmp_path)], n_train=0.7,
                              n_val=0.3, edge_capacity=2048)
    args = _diffusion_args(tmp_path, _sde_file(tmp_path), tmp_path / "dwd")
    state = train.train_diffusion(cfg, args)
    assert state["step"] == 5
    assert os.path.exists(tmp_path / "dwd" / "checkpoints" / "4.pth")
    tree = load_file(str(tmp_path / "dwd" / "checkpoints-meta" /
                         "checkpoint.pth"), enforced_format="pickle")
    assert {"params", "opt_state", "ema", "step"} <= set(tree)
    assert all(np.isfinite(v) for entry in state["log"]
               for k, v in entry.items() if k not in ("step", "seconds"))
    # the tree restores into a fresh model, optimizer and state
    model = build_model(cfg["model_config"], "cpu",
                        torch.Generator().manual_seed(5))
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-2)
    fresh = sde_utils.init_sde_state(model, sde_utils.Noise("cpu", 9))
    sde_utils.load_sde_state_dict(tree, fresh, model, optimizer)
    again = sde_utils.sde_state_dict(fresh, model, optimizer)
    assert again["step"] == tree["step"] == 5
    for k, v in _flat(tree["params"]):
        assert np.array_equal(dict(_flat(again["params"]))[k], v), k
    for k, v in _flat(tree["ema"]["params"]):
        assert np.array_equal(dict(_flat(again["ema"]["params"]))[k], v), k
    assert np.array_equal(again["noise"], tree["noise"])


def _diffusion_mols(n_mol, seed):
    """``tests/test_torch_sde.py``'s fully-connected molecules as one host
    batch's data and attrs (an in-memory dataset)."""
    from equivariant_nn_zoo_tpu_torch.data import Data
    from test_torch_sde import ATTRS, molecules

    host = Batch.from_data_list([Data(dict(ATTRS), **m)
                                 for m in molecules(seed=seed, n_mol=n_mol)])
    return host.data, host.attrs


def test_diffusion_loop_snapshot_writes_molecules(tmp_path):
    """``config_diffusion`` ``""`` with snapshot sampling (10 scales): the
    ground truth and the step's sample as ``.gro`` files of the first
    molecule's atom count, beside the checkpoints."""
    cfg = get_config("config_diffusion")
    data, attrs = _diffusion_mols(12, seed=3)
    cfg["batch_size"] = 4
    cfg["data_config"] = dict(cfg["data_config"], path=None, data=data,
                              attrs=attrs, preprocess=[], n_train=8,
                              n_val=4)
    args = _diffusion_args(tmp_path, _sde_file(tmp_path, n_iters=2,
                                               snapshot=True),
                           tmp_path / "swd", save_period=2)
    state = train.train_diffusion(cfg, args)
    assert state["step"] == 3
    wd = tmp_path / "swd"
    assert os.path.exists(wd / "checkpoints" / "2.pth")
    for name in ("ground_truth.gro", "2.gro"):
        lines = (wd / name).read_text().splitlines()
        assert len(lines) == 2 + int(lines[1])
    assert os.path.isdir(wd / "samples" / "iter_2")


class JaxKeys:
    """The noise of JAX's diffusion loop from its state key ``seed``, drawn
    in the port's order: each loss splits the key (``step_fn``), takes t
    from the first subkey (``uniform``) and the position noise from the
    second (``normal``), as ``tests/test_torch_sde.py``'s schedule."""

    def __init__(self, device, seed):
        self.rng, self.kp = jax.random.PRNGKey(seed), None

    def uniform(self, shape):
        self.rng, sub = jax.random.split(self.rng)
        _, kt, self.kp = jax.random.split(sub, 3)
        return torch.tensor(np.asarray(jax.random.uniform(kt, shape)))

    def normal(self, shape):
        _, sub = jax.random.split(self.kp)
        return torch.tensor(np.asarray(
            jax.random.normal(sub, shape, jax.numpy.float32)))


def test_diffusion_loop_matches_jax_loop(tmp_path, monkeypatch, caplog):
    """Both diffusion loops on ``config_diffusion`` ``""`` from JAX's
    initial parameters, on the same 12 in-memory molecules, JAX's key
    schedule replayed into the port: five steps with an evaluation after
    each and the plateau scheduler (patience 0) stepped on every save.
    The training losses (logged each step) and the evaluation losses
    agree at rtol 1e-4, and the last checkpoint's parameters at 1e-4 of
    each tensor's largest value.  The scheduler's rate falls during the
    run, and neither loop gives it to its optimizer."""
    import logging

    import train as jtrain

    data, attrs = _diffusion_mols(12, seed=3)
    caps = dict(path=None, data=data, attrs=attrs, preprocess=[],
                n_train=8, n_val=4, node_capacity=40, edge_capacity=240)
    jcfg = jget_config("config_diffusion", "")
    jcfg.batch_size = 4
    jcfg.lr_scheduler_patience = 0
    for k, v in caps.items():
        jcfg.data_config[k] = v
    cfg = get_config("config_diffusion", "")
    cfg.update(batch_size=4, lr_scheduler_patience=0)
    cfg["data_config"] = dict(cfg["data_config"], **caps)
    params = jax.device_get(jbuild(jcfg.model_config).init(
        jax.random.PRNGKey(0)))
    build_port = train.build_model
    monkeypatch.setattr(train, "build_model", lambda mc, dev, gen:
                        load_jax_params(build_port(mc, dev, gen), params))
    monkeypatch.setattr(sde_utils, "Noise", JaxKeys)
    jsde = tmp_path / "jsde.py"
    jsde.write_text(
        "from equivariant_nn_zoo_tpu.models.sde_config import get_config "
        "as g\n"
        "def get_config():\n"
        "    c = g()\n"
        "    c.training.n_iters = 4\n"
        "    c.training.snapshot_sampling = False\n"
        "    c.model.num_scales = 10\n"
        "    return c\n")
    flags = dict(seed=0, resume_from=None, wandb=False, log_period=1,
                 eval_period=1, save_period=1)
    with caplog.at_level(logging.INFO):
        jtrain.train_diffusion(jcfg, SimpleNamespace(
            sde_config=str(jsde), workdir=str(tmp_path / "jax"), **flags))
    jsaveload.finish_all_writes()
    logged = {"training_loss": [], "eval_loss": []}
    for r in caplog.records:
        for key in logged:
            if r.getMessage().startswith("step: ") and key in r.getMessage():
                logged[key].append(float(r.getMessage().split()[-1]))
    state = train.train_diffusion(cfg, SimpleNamespace(
        sde_config=_sde_file(tmp_path), workdir=str(tmp_path / "port"),
        device="cpu", **flags))
    train_log = [e["total"] for e in state["log"] if "total" in e]
    eval_log = [e for e in state["log"] if "total_val" in e]
    assert len(train_log) == len(logged["training_loss"]) == 4
    assert len(eval_log) == len(logged["eval_loss"]) == 4
    np.testing.assert_allclose(train_log, logged["training_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose([e["total_val"] for e in eval_log],
                               logged["eval_loss"], rtol=1e-4)
    assert min(e["lr"] for e in eval_log) < cfg["learning_rate"]
    want = jsaveload.restore_checkpoint(
        str(tmp_path / "jax" / "checkpoints" / "4.pth"))
    got = load_file(str(tmp_path / "port" / "checkpoints" / "4.pth"),
                    enforced_format="pickle")
    assert int(got["step"]) == int(want["step"]) == 5
    for tree in ("params", "ema"):
        w = dict(_flat(jax.device_get(want[tree]) if tree == "params"
                       else jax.device_get(want["ema"]["params"])))
        g = dict(_flat(got["params"] if tree == "params"
                       else got["ema"]["params"]))
        assert g.keys() == w.keys()
        for k, v in w.items():
            v = np.asarray(v)
            err = np.abs(g[k] - v).max() / max(np.abs(v).max(), 1e-30)
            assert err <= 1e-4, (tree, k, err)


JAX_INFERENCE = r'''
import os, sys

sys.path.insert(0, {repo!r})
from absl import app, flags

import inference
from equivariant_nn_zoo_tpu.models import get_config, register_config
from equivariant_nn_zoo_tpu.models.layer_configs import (
    addEnergyOutput, featureModel,
)


def tiny(spec=None):
    cfg = get_config("config_energy")
    cfg.batch_size = 8
    cfg.model_config = addEnergyOutput(featureModel(**{narrow!r}),
                                       shifts=[0.0] * 10)
    cfg.data_config.path = os.environ["E3_CLI_DATA"]
    cfg.data_config.key_map = {key_map!r}
    return cfg


register_config("config_tiny_inf", tiny)

def main(argv):
    # app.run exits non-zero on evaluate's return value (the merged batch)
    inference.evaluate(argv)


if __name__ == "__main__":
    flags.mark_flags_as_required(["config"])
    app.run(main)
'''


def test_inference_cli_reproduces_jax_cli(qm9_file, tmp_path,  # noqa: F811
                                          monkeypatch):
    """JAX's train CLI trains the narrow model for one epoch; JAX's and
    the port's inference CLIs evaluate its ``best.pt`` over the 96
    molecules (batches of 7: the last one padded) and dump the energies:
    equal within rel-linf 1e-5, the same graphs in the same order."""
    import train as jtrain

    jcfg = jget_config("config_energy")
    jcfg.batch_size = 8
    jcfg.max_epochs = 1
    jcfg.data_config.path = qm9_file
    jcfg.data_config.n_train = 32
    jcfg.data_config.n_val = 16
    jcfg.data_config.key_map = KEY_MAP
    jcfg.model_config = jlc.addEnergyOutput(jlc.featureModel(**NARROW),
                                            shifts=[0.0] * 10)
    wd = tmp_path / "jax_wd"
    jtrain.train_regression(jcfg, SimpleNamespace(
        wandb=False, workdir=str(wd), seed=0, equivariance_test=False,
        profiling=False, log_period=100, save_period=2000,
        resume_from=None, dp=1))
    best = str(wd / "best.pt")

    runner = tmp_path / "jax_inference.py"
    runner.write_text(JAX_INFERENCE.format(repo=REPO, narrow=NARROW,
                                           key_map=KEY_MAP))
    jax_out = str(tmp_path / "jax.hdf5")
    env = dict(os.environ, E3_CLI_DATA=qm9_file, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(runner), "--config", "config_tiny_inf",
         "--model_path", best, "--output_path", jax_out, "--batch_size", "7",
         "--output_keys", "total_energy"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]

    monkeypatch.setenv("E3_CLI_DATA", qm9_file)
    register_config("config_tiny_inf", lambda spec=None: tiny_config(
        os.environ["E3_CLI_DATA"]))
    port_out = str(tmp_path / "port.hdf5")
    merged = inference.main([
        "--config", "config_tiny_inf", "--device", "cpu", "--model_path",
        best, "--output_path", port_out, "--batch_size", "7",
        "--output_keys", "total_energy"])
    assert len(merged) == 96
    with h5py.File(port_out, "r") as f, h5py.File(jax_out, "r") as g:
        assert set(f.keys()) == set(g.keys()) == {"total_energy",
                                                  "_n_nodes"}
        np.testing.assert_array_equal(f["_n_nodes"][()], g["_n_nodes"][()])
        got, want = f["total_energy"][()], g["total_energy"][()]
        assert got.shape == want.shape == (96, 1)
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()
        np.testing.assert_array_equal(got, merged["total_energy"])


class _StubWandB(types.ModuleType):
    """A ``wandb`` with an open run that records what is logged."""

    def __init__(self):
        super().__init__("wandb")
        self.run = object()
        self.logged = []

    def log(self, d):
        self.logged.append(dict(d))

    class Histogram:
        def __init__(self, np_histogram):
            self.np_histogram = np_histogram


def test_trainer_wandb_logs_what_jax_logs(qm9_file, tmp_path,  # noqa: F811
                                          monkeypatch):
    """The port's and JAX's ``TrainerWandB`` (narrow model from JAX's
    initial parameters, one epoch, ``watch_freq`` 2) against the stub: the
    number of weights, the epoch's ``mae_dict`` (values at 1e-4), and the
    histograms and norms of the parameters and gradients, every second
    step (the norms at 1e-4)."""
    from equivariant_nn_zoo_tpu.data.compute_edge import (
        computeEdgeIndex as jcomputeEdgeIndex,
    )
    from equivariant_nn_zoo_tpu.data.dataset import (
        CondensedDataset as JCondensedDataset,
    )
    from equivariant_nn_zoo_tpu.run.trainer import (
        TrainerWandB as JTrainerWandB,
    )
    from equivariant_nn_zoo_tpu_torch.data import (
        CondensedDataset,
        computeEdgeIndex,
    )
    from equivariant_nn_zoo_tpu_torch.run import TrainerWandB

    settings = dict(
        seed=0, data_config=dict(n_train=32, n_val=16, shuffle=False,
                                 train_val_split="sequential"),
        loss_coeffs={"total_energy": [1.0, "MSELoss"]},
        metrics_components={"total_energy": ["mae"]}, learning_rate=1e-2,
        optimizer_name="Adam", lr_scheduler_name="none", max_epochs=1,
        batch_size=8, log_period=1000, watch_freq=2)
    shifts = [0.0, -16.4, 0, 0, 0, 0, -1036.0, -1489.0, -2047.0, 0]
    jmodel = jbuild(jlc.addEnergyOutput(jlc.featureModel(**NARROW),
                                        shifts=shifts))
    # the JAX trainer's initial parameters (seed 0) in the port's model
    model = load_jax_params(
        build(tlc.addEnergyOutput(tlc.featureModel(**NARROW),
                                  shifts=shifts)),
        jax.device_get(jmodel.init(jax.random.PRNGKey(0))))
    logs = {}
    for side in ("jax", "port"):
        stub = _StubWandB()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        if side == "jax":
            ds = JCondensedDataset(
                path=qm9_file, key_map=KEY_MAP,
                preprocess=[partial(jcomputeEdgeIndex, r_max=4.0)])
            tr = JTrainerWandB(model=jmodel, workdir=str(tmp_path / side),
                               **settings)
        else:
            ds = CondensedDataset(
                path=qm9_file, key_map=KEY_MAP,
                preprocess=[partial(computeEdgeIndex, r_max=4.0)])
            tr = TrainerWandB(model, workdir=str(tmp_path / side),
                              **settings)
        tr.set_dataset(ds)
        tr.train()
        logs[side] = stub.logged
    port, want = logs["port"], logs["jax"]
    assert len(port) == len(want)
    for got, exp in zip(port, want):
        assert set(got) == set(exp)
        for k, v in exp.items():
            if isinstance(v, _StubWandB.Histogram):
                assert isinstance(got[k], _StubWandB.Histogram), k
            elif k != "wall":   # the same steps from the same parameters
                np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    assert port[0] == want[0] == {"num_weights": countParameters(model)}
    n_hist = [sum(isinstance(v, _StubWandB.Histogram) for v in d.values())
              for d in port]
    assert sorted(set(n_hist)) == [0, 2 * len(list(model.parameters()))]


class _Recorder(importlib.abc.MetaPathFinder):
    def __init__(self):
        self.names = []

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "wandb":
            self.names.append(name)
        return None


def test_cli_without_wandb_never_imports_it(qm9_file, tmp_path,  # noqa: F811
                                            monkeypatch):
    _cli(monkeypatch, qm9_file, epochs=1)
    recorder = _Recorder()
    monkeypatch.delitem(sys.modules, "wandb", raising=False)
    monkeypatch.setattr(sys, "meta_path", [recorder] + sys.meta_path)
    train.run(["--config", "config_tiny_cli", "--device", "cpu",
               "--workdir", str(tmp_path), "--name", "w"])
    assert recorder.names == []
    assert "wandb" not in sys.modules


def test_count_parameters_matches_jax():
    """On JAX's parameter trees (narrow, then full width by shape alone)
    and on the port's modules holding them."""
    jmodel = jbuild(jlc.addEnergyOutput(jlc.featureModel(**NARROW),
                                        shifts=[0.0] * 10))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    model = load_jax_params(build(tlc.addEnergyOutput(
        tlc.featureModel(**NARROW), shifts=[0.0] * 10)), params)
    assert countParameters(params) == jcount(params) == \
        countParameters(model)
    for name, spec, want in (("config_energy", None, 6127077),
                             ("config_diffusion", "", 694096)):
        shapes = jax.eval_shape(jbuild(jget_config(name, spec).model_config)
                                .init, jax.random.PRNGKey(0))
        model = build(get_config(name, spec)["model_config"])
        assert countParameters(model) == jcount(shapes) == want


def test_register_config_and_the_configs_alias():
    def mine(spec=None):
        return {"spec": spec}

    register_config("config_test_registered", mine)
    assert get_config("config_test_registered") == {"spec": None}
    assert configs.get_config("config_test_registered", "x") == {"spec": "x"}
    names = {n for n in dir(jconfigs) if not n.startswith("_")}
    assert names == {n for n in dir(configs) if not n.startswith("_")}
    assert configs.register_config is register_config
    with pytest.raises(KeyError):
        get_config("config_not_there")


def test_clis_default_to_the_card(tmp_path):
    """Both CLIs aim at the card unless asked for the CPU; without a card
    they raise instead of running on the CPU."""
    assert train.parse_args(["--config", "config_energy"]).device == "cuda"
    assert inference.parse_args(["--config", "config_energy"]).device == \
        "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        train.run(["--config", "config_energy", "--workdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        inference.main(["--config", "config_energy"])


def test_port_entry_points_import_without_jax():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'h5py', 'absl', 'wandb', "
            "'ml_collections', 'optax', 'equivariant_nn_zoo_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import equivariant_nn_zoo_tpu_torch.train\n"
            "import equivariant_nn_zoo_tpu_torch.inference\n"
            "import equivariant_nn_zoo_tpu_torch.parallel\n"
            "import equivariant_nn_zoo_tpu_torch.configs\n"
            "print('IMPORTED')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORTED" in proc.stdout


def test_data_iters_refuse_a_split_without_a_batch(tmp_path):
    """A split smaller than one batch made ``getDataIters``'s endless
    iterator spin forever without yielding (the diffusion loop's first
    ``next`` never returned); it raises instead."""
    from equivariant_nn_zoo_tpu_torch.data import getDataIters

    data, attrs = _diffusion_mols(6, seed=1)
    cfg = {"batch_size": 4, "data_config": dict(
        path=None, data=data, attrs=attrs, n_train=4, n_val=2,
        train_val_split="sequential")}
    with pytest.raises(ValueError, match="validation split"):
        getDataIters(cfg)
    cfg["data_config"].update(n_train=3, n_val=3)
    with pytest.raises(ValueError, match="training split"):
        getDataIters(cfg)
    cfg["data_config"].update(n_train=4, n_val=1)
    cfg["batch_size"] = 2
    with pytest.raises(ValueError, match="validation split"):
        getDataIters(cfg)
    cfg["data_config"].update(n_train=4, n_val=2)
    train_iter, val_iter = getDataIters(cfg)
    assert next(train_iter).n_graphs == next(val_iter).n_graphs == 2
