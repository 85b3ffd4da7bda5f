"""The port's run components (CPU), mirroring ``tests/test_run_components.py``
and held to the JAX package's:

- early stopping (patience, delta, cumulative delta, lower and upper
  bounds, its state) on one metric sequence, decision for decision;
- save / load of pickle, yaml, json and npz files, atomic write groups,
  ``save_checkpoint`` / ``restore_checkpoint``, and the molecule writers
  (the same bytes as the JAX writers);
- the GP solver and the batched bincount;
- the optimizers besides Adam (AdamW, SGD with and without momentum and
  Nesterov, RMSprop in its variants), each after a clip to a global norm
  and with a learning-rate change, step by step against optax at 1e-5;
- the training, early-stopping and data settings of every config the port
  has, against the JAX configs' (early stopping used to be dropped);
- no module of the port, nor ``chip_smoke.py``, imports JAX, optax or the
  JAX package, and ``h5py`` only inside functions.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from equivariant_nn_zoo_tpu.data import Batch as JBatch
from equivariant_nn_zoo_tpu.models import get_config as jget_config
from equivariant_nn_zoo_tpu.run import EarlyStopping as JEarlyStopping
from equivariant_nn_zoo_tpu.utils import saveload as jsaveload
from equivariant_nn_zoo_tpu.utils.statistics import bincount as jbincount
from equivariant_nn_zoo_tpu.utils.statistics import solver as jsolver
from equivariant_nn_zoo_tpu_torch.data import Batch
from equivariant_nn_zoo_tpu_torch.models import get_config
from equivariant_nn_zoo_tpu_torch.run import EarlyStopping, Trainer
from equivariant_nn_zoo_tpu_torch.utils.saveload import (
    atomic_write_group,
    finish_all_writes,
    load_file,
    restore_checkpoint,
    save_checkpoint,
    save_file,
    saveMol,
    saveProtein,
)
from equivariant_nn_zoo_tpu_torch.utils.statistics import bincount, solver
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = [5.0, 4.0, 4.2, 4.1, 3.0, 3.05, 3.2, 2.99, 3.5, 3.6, 3.7, 3.8]


# ------------------------------------------------------------ early stopping

@pytest.mark.parametrize("kwargs", [
    dict(patiences={"loss": 2}),
    dict(patiences={"loss": 2}, delta={"loss": 0.05}),
    dict(patiences={"loss": 3}, delta={"loss": 0.05}, cumulative_delta=True),
    dict(lower_bounds={"loss": 3.1}),
    dict(upper_bounds={"loss": 3.65}, patiences={"loss": 5}),
])
def test_early_stopping_matches_jax(kwargs):
    got, want = EarlyStopping(**kwargs), JEarlyStopping(**kwargs)
    for value in METRICS:
        a, b = got({"loss": value}), want({"loss": value})
        assert a == b, value
        assert got.state_dict() == want.state_dict()
    restored = EarlyStopping(**kwargs)
    restored.load_state_dict(got.state_dict())
    assert restored.state_dict() == got.state_dict()


def test_early_stopping_patience_and_bounds():
    es = EarlyStopping(patiences={"loss": 2})
    assert es({"loss": 1.0})[0] is False
    assert es({"loss": 1.1})[0] is False
    assert es({"loss": 1.2})[0]
    es = EarlyStopping(lower_bounds={"LR": 1e-6})
    assert es({"LR": 1e-5})[0] is False
    assert es({"LR": 1e-7})[0] is True
    with pytest.raises(ValueError, match="patience for"):
        EarlyStopping(delta={"loss": 0.1})


# ------------------------------------------------------------- save / load

def test_save_load_roundtrip(tmp_path):
    item = {"a": torch.arange(3), "b": {"c": 1.5, "d": np.ones(2)}}
    p = save_file(item, str(tmp_path / "x.pkl"), enforced_format="pickle")
    finish_all_writes()
    back = load_file(p)
    assert isinstance(back["a"], np.ndarray)
    np.testing.assert_array_equal(back["a"], [0, 1, 2])
    assert back["b"]["c"] == 1.5
    for name, value in (("y.yaml", {"k": [1, 2]}), ("z.json", {"k": [1, 2]})):
        p = save_file(value, str(tmp_path / name))
        finish_all_writes()
        assert load_file(p) == value
    p = save_file({"w": np.arange(4.0)}, str(tmp_path / "w.npz"))
    finish_all_writes()
    np.testing.assert_array_equal(load_file(p)["w"], np.arange(4.0))
    with pytest.raises(NotImplementedError):
        save_file({}, str(tmp_path / "x.unknown"))


def test_write_group_publishes_together(tmp_path):
    with atomic_write_group():
        a = save_file({"a": 1}, str(tmp_path / "a.pt"), blocking=False)
        b = save_file({"b": 2}, str(tmp_path / "b.pt"), blocking=False)
        assert not os.path.exists(a) and not os.path.exists(b)
    finish_all_writes()
    assert load_file(a) == {"a": 1} and load_file(b) == {"b": 2}
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tmp")]


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ckpt.pth")
    state = {"step": 3, "params": {"w": torch.ones(2)}}
    assert restore_checkpoint(path, state) is state
    save_checkpoint(path, state, blocking=True)
    back = restore_checkpoint(path)
    assert back["step"] == 3
    np.testing.assert_array_equal(back["params"]["w"], [1.0, 1.0])


def test_molecule_writers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
             "_n_nodes": ("graph", "1x0e")}
    data = dict(pos=rng.normal(size=(3, 3)), species=np.array([[8], [1], [1]]),
                _n_nodes=np.array([[3]]))
    got = saveMol(Batch(attrs, **data), workdir=str(tmp_path), filename="p")
    want = jsaveload.saveMol(JBatch(attrs, **data), workdir=str(tmp_path),
                             filename="j")
    assert got.endswith(".gro")
    assert open(got).read() == open(want).read()
    assert open(got).read().splitlines()[1] == "3"

    attrs = {"CA": ("node", "1x1o"), "species": ("node", "1x0e"),
             "chain_id": ("node", "1x0e"), "_n_nodes": ("graph", "1x0e")}
    data = dict(CA=rng.normal(size=(4, 3)),
                species=np.array([[0], [1], [2], [3]]),
                chain_id=np.zeros((4, 1), np.int64), _n_nodes=np.array([[4]]))
    got = saveProtein(Batch(attrs, **data), str(tmp_path), filename="p")
    want = jsaveload.saveProtein(JBatch(attrs, **data), str(tmp_path),
                                 filename="j")
    content = open(got).read()
    assert content == open(want).read()
    assert "ATOM" in content and content.strip().endswith("END")


# ------------------------------------------------------------- statistics

def test_gp_solver_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.integers(0, 5, size=(200, 4)).astype(np.float64)
    true = np.array([[-10.0], [5.0], [2.0], [-3.0]])
    y = X @ true + rng.normal(scale=0.01, size=(200, 1))
    mean, std = solver(X, y)
    np.testing.assert_allclose(mean, true, atol=0.5)
    jmean, jstd = jsolver(X, y)
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(std, jstd)


def test_bincount_per_graph():
    types = np.array([0, 1, 1, 2, 0])
    batch = np.array([0, 0, 1, 1, 1])
    out = bincount(types, batch, minlength=3)
    np.testing.assert_array_equal(out, [[1, 1, 0], [1, 1, 1]])
    np.testing.assert_array_equal(out, jbincount(types, batch, minlength=3))
    np.testing.assert_array_equal(bincount(types, minlength=4),
                                  jbincount(types, minlength=4))


# -------------------------------------------------------------- optimizers

OPTIMIZER_CASES = [
    ("AdamW", {}, optax.adamw, {}),
    ("AdamW", {"optimizer_weight_decay": 0.1, "optimizer_b1": 0.8},
     optax.adamw, {"weight_decay": 0.1, "b1": 0.8}),
    ("SGD", {}, optax.sgd, {}),
    ("SGD", {"optimizer_momentum": 0.9}, optax.sgd, {"momentum": 0.9}),
    ("SGD", {"optimizer_momentum": 0.9, "optimizer_nesterov": True},
     optax.sgd, {"momentum": 0.9, "nesterov": True}),
    ("RMSprop", {}, optax.rmsprop, {}),
    ("RMSprop", {"optimizer_momentum": 0.5, "optimizer_nesterov": True},
     optax.rmsprop, {"momentum": 0.5, "nesterov": True}),
    ("RMSprop", {"optimizer_centered": True, "optimizer_decay": 0.8},
     optax.rmsprop, {"centered": True, "decay": 0.8}),
    ("RMSprop", {"optimizer_eps_in_sqrt": False,
                 "optimizer_bias_correction": True,
                 "optimizer_initial_scale": 0.1},
     optax.rmsprop, {"eps_in_sqrt": False, "bias_correction": True,
                     "initial_scale": 0.1}),
]


@pytest.mark.parametrize("name,kwargs,opt_fn,opt_kwargs", OPTIMIZER_CASES)
def test_optimizer_matches_optax(name, kwargs, opt_fn, opt_kwargs):
    """Five steps through ``Trainer.apply_gradients`` (clip to a global
    norm of 0.5 first, the rate halved after the third step through
    ``_set_lr``) against ``optax.chain(clip_by_global_norm,
    inject_hyperparams(optimizer))`` fed the same gradients."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Linear(4, 3))
    trainer = Trainer(model, {"y": 1.0}, optimizer_name=name,
                      learning_rate=1e-2, max_gradient_norm=0.5, **kwargs)
    params = {n: jnp.asarray(p.detach().numpy().copy())
              for n, p in model.named_parameters()}
    opt = optax.chain(optax.clip_by_global_norm(0.5),
                      optax.inject_hyperparams(opt_fn)(
                          learning_rate=1e-2, **opt_kwargs))
    state = opt.init(params)
    rng = np.random.default_rng(1)
    for step in range(5):
        if step == 3:
            trainer._set_lr(5e-3)
            state[1].hyperparams["learning_rate"] = jnp.asarray(
                5e-3, jnp.float32)
        scale = 10.0 if step % 2 == 0 else 0.01   # clipped, then not
        grads = {n: (scale * rng.normal(size=params[n].shape)).astype(
            np.float32) for n in params}
        for n, p in model.named_parameters():
            p.grad = torch.tensor(grads[n])
        trainer.apply_gradients()
        updates, state = opt.update(
            {n: jnp.asarray(g) for n, g in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for n, p in model.named_parameters():
            want = np.asarray(params[n])
            err = np.abs(p.detach().numpy() - want).max()
            assert err <= 1e-5 * max(np.abs(want).max(), 1.0), (step, n, err)


def test_unknown_optimizer_and_options_raise():
    model = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="optimizer_name"):
        Trainer(model, {"y": 1.0}, optimizer_name="Adagrad")
    with pytest.raises(TypeError):
        Trainer(model, {"y": 1.0}, optimizer_name="SGD",
                optimizer_betas=(0.9, 0.9))


# ------------------------------------------------------------------ configs

TRAINING_KEYS = (
    "batch_size", "epoch_subdivision", "learning_rate", "use_ema",
    "ema_decay", "ema_use_num_updates", "metric_key", "max_epochs",
    "early_stopping_patiences", "early_stopping_lower_bounds", "loss_coeffs",
    "metrics_components", "optimizer_name", "lr_scheduler_name",
    "lr_scheduler_patience", "lr_scheduler_factor")
DATA_KEYS = ("n_train", "n_val", "train_val_split", "shuffle", "type_names",
             "cache_preprocessed", "num_workers")


def _plain(value):
    if hasattr(value, "to_dict"):
        value = value.to_dict()
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


@pytest.mark.parametrize("name", ["config_energy", "config_energy_force",
                                  "config_dipole", "config_hamiltonian"])
def test_config_settings_match_jax(name):
    """Every training, early-stopping and data setting of the regression
    configs is the JAX config's (``early_stopping_*``, ``max_epochs`` and
    ``epoch_subdivision`` were dropped from the port's configs before the
    trainer loop existed)."""
    got, want = get_config(name), jget_config(name)
    for key in TRAINING_KEYS:
        assert _plain(got[key]) == _plain(want[key]), key
    for key in DATA_KEYS:
        assert _plain(got["data_config"][key]) == _plain(
            want.data_config[key]), key
    pre, = got["data_config"]["preprocess"]
    jpre, = want.data_config.preprocess
    assert pre.func.__name__ == jpre.func.__name__
    assert pre.keywords == jpre.keywords
    assert pre.func.__module__.startswith("equivariant_nn_zoo_tpu_torch.")


# ---------------------------------------------------------------- imports

def _module_imports(path):
    """(top-level imports, imports inside functions) of a source file."""
    tree = ast.parse(open(path).read())
    top, inner = set(), set()

    def visit(node, nested):
        for child in ast.iter_child_nodes(node):
            here = nested or isinstance(child, (ast.FunctionDef,
                                                ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                names = [child.module]
            else:
                names = []
            (inner if nested else top).update(n.split(".")[0] for n in names)
            visit(child, here)

    visit(tree, False)
    return top, inner


def test_port_imports_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(
            REPO, "equivariant_nn_zoo_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    for path in files:
        top, inner = _module_imports(path)
        banned = (top | inner) & {"jax", "jaxlib", "optax", "flax",
                                  "equivariant_nn_zoo_tpu", "ml_collections"}
        assert not banned, (path, banned)
        assert "h5py" not in top, path
