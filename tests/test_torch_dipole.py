"""Parity of the port's ``config_dipole`` with the JAX package (CPU, f32):

- full width (n_dim 32, l_max 2, 5 layers, 18 species): the layer list and
  the parameter tree are the JAX config's, and every self-connection takes
  the per-species tables (K3) over 18 species;
- at a narrow width (n_dim 8, 2 layers, the config's irreps otherwise) on
  JAX-initialised parameters: the per-node ``dipole`` at rel-linf 1e-5 and
  one step's loss and gradients (``1e3 * MSE``) at 1e-4 against the JAX
  default CPU path, with K1/K2/K3/K3b routed to their plain contracts and
  their launches counted;
- the node-level loss and metrics: padded nodes, whatever their labels,
  change neither;
- K3's and K3b's blocking (the numpy walk of
  ``tests/test_torch_species_order.py``) at the card batch's shapes: 18
  species, 4,069 rows, dtables chunked as the card chunks them;
- ``best.pt`` crosses packages both ways with equal outputs;
- two different loader batches give two edge orders and two species
  orders (the kernels' caches hold the last tensors, so a new batch
  cannot alias an old one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu.data import Batch as JBatch
from equivariant_nn_zoo_tpu.data import Data as JData
from equivariant_nn_zoo_tpu.data import GraphBatch as JGraphBatch
from equivariant_nn_zoo_tpu.data import computeEdgeIndex as jcomputeEdgeIndex
from equivariant_nn_zoo_tpu.models import get_config as jget_config
from equivariant_nn_zoo_tpu.models import layer_configs as jlc
from equivariant_nn_zoo_tpu.nn import PointwiseLinear as JPointwiseLinear
from equivariant_nn_zoo_tpu.run import loss as jloss
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu.utils import saveload as jsaveload
from equivariant_nn_zoo_tpu_torch.data import (
    Batch,
    CondensedDataset,
    Data,
    GraphBatch,
    computeEdgeIndex,
)
from equivariant_nn_zoo_tpu_torch.models import get_config
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.nn import PointwiseLinear
from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order, species_order
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as species_sc_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda.species_sc import (
    TILE,
    grad_blocks,
    grad_chunk_rows,
)
from equivariant_nn_zoo_tpu_torch.run import Loss, Metrics, Trainer
from equivariant_nn_zoo_tpu_torch.utils import (
    build,
    load_jax_params,
    params_from_jax,
)
import test_torch_species_order as walk
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

NARROW = dict(n_dim=8, l_max=2, edge_spherical="1x0e+1x1o+1x2e",
              node_attrs="16x0e", edge_radial="8x0e", num_types=18,
              num_layers=2, r_max=5.0)
ATTRS = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
         "atom_types": ("node", "1x0e"), "dipole": ("node", "1x1o")}
LOSS = {"dipole": [1e3, "MSELoss"]}
N_GRAPHS, N_CAP, E_CAP = 8, 96, 1024   # 6 molecules: two padded graphs


def dipole_config(lc, linear, **kw):
    """``config_dipole``'s model at the widths ``kw``, from one package's
    ``featureModel`` and ``PointwiseLinear``.  The head reads the trunk's
    last irreps: at full width they are the config's ``features``; a trunk
    of fewer than 3 layers has no ``0o`` yet, and a head declared on the
    full string would read its ``1o`` slot from the wrong columns."""
    mc = lc.featureModel(**kw)
    features = mc["layers"][-1][1]["output_features"][0]
    mc["layers"].append(("dipole_output", {
        "module": linear, "irreps_in": (features, "node_features"),
        "irreps_out": ("1x1o", "dipole")}))
    return mc


def molecules(seed=0, n_mol=6):
    """Dipole molecules as ``bench.py`` makes them, smaller: 5-11 atoms of
    18 species, positions N(0, 1.4^2), N(0, 1) per-node dipoles."""
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(5, 12))
        d = {"pos": rng.normal(size=(n, 3)) * 1.4,
             "species": rng.integers(0, 18, size=(n, 1)),
             "dipole": rng.normal(size=(n, 3)).astype(np.float32)}
        d["atom_types"] = d["species"]
        mols.append(d)
    return mols


def port_batch(mols, n_cap=N_CAP):
    items = []
    for m in mols:
        m = dict(m)
        out, attrs = computeEdgeIndex(m, dict(ATTRS), r_max=5.0)
        m.update(out)
        items.append(Data(attrs, **m))
    gb = GraphBatch.from_batch(Batch.from_data_list(items), n_cap, E_CAP,
                               N_GRAPHS, "cpu")
    assert gb.dropped == 0
    return gb


def jax_batch(mols):
    items = []
    for m in mols:
        m = dict(m)
        out, attrs = jcomputeEdgeIndex(m, dict(ATTRS), r_max=5.0)
        m.update(out)
        items.append(JData(attrs, **m))
    return JGraphBatch.from_batch(JBatch.from_data_list(items), N_CAP, E_CAP,
                                  N_GRAPHS)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def reference():
    """The narrow JAX model, its parameters, and a jitted function giving
    the loss, the dipoles and every gradient on the default CPU path (one
    compile for the file: later calls take other parameters of the same
    shapes)."""
    jmodel = jbuild(dipole_config(jlc, JPointwiseLinear, **NARROW))
    params = jmodel.init(jax.random.PRNGKey(0))
    mols = molecules()
    jgb = jax_batch(mols)
    loss = jloss.Loss(LOSS)

    def f(p):
        out = jmodel.apply(p, jgb)
        return loss(out.data, jgb.data)[0], out["dipole"]

    step = jax.jit(jax.value_and_grad(f, has_aux=True))
    (value, dipole), grads = step(params)
    return dict(step=step, params=params, mols=mols, loss=float(value),
                dipole=np.asarray(dipole),
                grads=params_from_jax(jax.device_get(grads)))


def narrow_model(params):
    return load_jax_params(build(dipole_config(tlc, PointwiseLinear,
                                               **NARROW)), params)


def route(monkeypatch, seen=None):
    """K1/K2 and K3/K3b down their card path (the autograd Functions) with
    each launch replaced by its plain contract; count the launches and,
    given ``seen``, record each forward launch's arguments and order."""
    calls = {"K1": 0, "K2": 0, "K3": 0, "K3b": 0}

    def counting(key, attr):
        def launch(mod, *args, order=None):
            calls[key] += 1
            if seen is not None:
                seen.setdefault(key, []).append((args, order))
            return getattr(mod, attr)(*args)
        return launch

    for mod, cls, fwd, bwd in (
            (full_conv_mod, full_conv_mod.FullConv,
             counting("K1", "plain_forward"),
             counting("K2", "plain_backward")),
            (species_sc_mod, species_sc_mod.SpeciesScalarFCTP,
             counting("K3", "table_product"),
             counting("K3b", "plain_backward"))):
        monkeypatch.setattr(cls, "forward", cls.launch)
        monkeypatch.setattr(mod, "launch_forward", fwd)
        monkeypatch.setattr(mod, "launch_backward", bwd)
    return calls


@pytest.fixture(scope="module")
def full_width():
    return build(get_config("config_dipole")["model_config"])


def test_full_width_config_matches_jax(full_width):
    cfg, jcfg = get_config("config_dipole"), jget_config("config_dipole")
    mc = cfg["model_config"]
    assert (mc["n_dim"], mc["l_max"], mc["num_layers"], mc["num_types"]) == \
        (32, 2, 5, 18)
    assert [n for n, _ in mc["layers"]] == \
        [n for n, _ in jcfg.model_config.layers]
    model = full_width
    shapes = jax.eval_shape(jbuild(jcfg.model_config).init,
                            jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(path, simple=True, separator="."):
            tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes)[0]}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want
    tables = [m for m in model.modules()
              if isinstance(m, species_sc_mod.SpeciesScalarFCTP)]
    assert len(tables) == 5 and all(t.num_types == 18 for t in tables)
    assert mc["layers"][-1] == ("dipole_output", {
        "module": PointwiseLinear,
        "irreps_in": ("32x0e+32x0o+32x1e+32x1o+32x2e+32x2o",
                      "node_features"),
        "irreps_out": ("1x1o", "dipole")})


def test_species_table_walk_at_dipole_shapes(full_width):
    """The blocking of K3 and K3b (``csrc/species_sc.cu``, walked in numpy
    by ``tests/test_torch_species_order.py``) at the dipole hot layer's
    shapes on the card: 18 species (two absent), 4,069 node rows with an
    out-of-range dummy, dtables chunked for 2 x 132 blocks (an H100 SXM's
    multiprocessors, as ``launch_backward`` sizes it), in float64 against
    the plain contracts; the workspace fits its 32-bit index."""
    sc = full_width.layer3.conv.species_sc
    types, N = sc.num_types, 4069
    rng = np.random.default_rng(4)
    species = rng.integers(0, types - 2, size=N)
    species[-1] = types
    x, g = rng.normal(size=(N, sc.in_dim)), rng.normal(
        size=(N, sc.irreps_out.dim))
    tables = rng.normal(size=(types, sc.table_width))
    perm, ptr = walk._order(species, types)
    valid = species < types
    vt = [torch.tensor(a[valid]) for a in (x, species, g)]
    want_out = sc.table_product(vt[0], vt[1], torch.tensor(tables)).numpy()
    want_dx, want_dA = (t.numpy() for t in sc.plain_backward(
        vt[0], vt[1], torch.tensor(tables), vt[2]))
    out = walk._walk_product(sc, x, perm, ptr, tables, bwd=False)
    dx = walk._walk_product(sc, g, perm, ptr, tables, bwd=True)
    rows = grad_chunk_rows(N, sc.grad_entries, 2 * 132)
    assert grad_blocks(N, types, sc.grad_entries, rows) * TILE < 2 ** 31
    dA = walk._walk_dtables(sc, x, g, perm, ptr, rows)
    assert rel(out[valid], want_out) <= 1e-12
    assert rel(dx[valid], want_dx) <= 1e-12
    assert rel(dA, want_dA) <= 1e-12
    assert not out[~valid].any() and not dx[~valid].any()
    assert not dA[types - 2:].any()


def test_dipoles_match_jax(reference):
    model = narrow_model(reference["params"])
    with torch.no_grad():
        got = model(port_batch(reference["mols"]))["dipole"].numpy()
    assert got.shape == reference["dipole"].shape == (N_CAP, 3)
    assert rel(got, reference["dipole"]) <= 1e-5


def test_step_gradients_match_jax_through_the_card_path(reference,
                                                        monkeypatch):
    model = narrow_model(reference["params"])
    calls = route(monkeypatch)
    gb = port_batch(reference["mols"])
    out = model(gb)
    loss, _ = Loss(LOSS)(out.data, gb.data)
    loss.backward()
    n = NARROW["num_layers"]
    assert calls == {"K1": n, "K2": n, "K3": n, "K3b": n}
    assert rel(loss.item(), reference["loss"]) <= 1e-5
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(reference["grads"])
    for name, want in reference["grads"].items():
        assert rel(grads[name].numpy(), want.numpy()) <= 1e-4, name


def test_padded_nodes_stay_out_of_loss_and_metrics(reference):
    """Two paddings of one batch, the padded nodes' labels junk in the
    second: the node-level loss and the ``dipole`` mae are the same, and
    equal the masked mean over the real nodes."""
    model = narrow_model(reference["params"])
    mols = reference["mols"]
    values = []
    for n_cap in (N_CAP, 200):
        gb = port_batch(mols, n_cap)
        real = int(gb["_node_mask"].sum())
        if n_cap != N_CAP:
            gb.data["dipole"][real:] = 1e6
        with torch.no_grad():
            out = model(gb)
        loss, contrib = Loss(LOSS)(out.data, gb.data)
        metrics = Metrics({"dipole": ["mae"]})
        metrics(out.data, gb.data)
        mae = metrics.flatten_metrics(metrics.current_result())[0]
        err = (out["dipole"][:real] - gb["dipole"][:real]).numpy()
        values.append((loss.item(), mae["dipole_mae"]))
        assert rel(contrib["dipole"].item(), (err ** 2).mean()) <= 1e-6
        assert rel(mae["dipole_mae"], np.abs(err).mean()) <= 1e-6
    assert rel(values[1], values[0]) <= 1e-6


def test_best_pt_crosses_packages(reference, tmp_path):
    """A JAX ``best.pt`` loads into the port (``Trainer.from_file`` of a bare
    parameter pickle), and the port's ``best.pt`` into the JAX model: each
    side's dipoles equal the other's at 1e-5."""
    step, mols = reference["step"], reference["mols"]
    jparams = jbuild(dipole_config(jlc, JPointwiseLinear, **NARROW)).init(
        jax.random.PRNGKey(7))
    jax_path = str(tmp_path / "jax_best.pt")
    jsaveload.save_file(jparams, jax_path, enforced_format="pickle")
    jsaveload.finish_all_writes()
    trainer = Trainer.from_file(
        jax_path, model=build(dipole_config(tlc, PointwiseLinear, **NARROW)),
        loss_coeffs=LOSS, use_ema=True, workdir=str(tmp_path / "wd"))
    with torch.no_grad():
        got = trainer.ema_model(port_batch(mols))["dipole"].numpy()
    want = np.asarray(step(jparams)[0][1])
    assert rel(got, want) <= 1e-5

    model = narrow_model(reference["params"])
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.9)
        mine = model(port_batch(mols))["dipole"].numpy()
    port = Trainer(model, LOSS, workdir=str(tmp_path / "wd2"))
    port.save_ema_model(port.best_model_path)
    from equivariant_nn_zoo_tpu_torch.utils import finish_all_writes

    finish_all_writes()
    tree = jsaveload.load_file(port.best_model_path)
    theirs = np.asarray(step(jax.tree_util.tree_map(jnp.asarray, tree))[0][1])
    assert rel(theirs, mine) <= 1e-5


def test_loader_batches_get_their_own_orders(reference, monkeypatch):
    """``Trainer.train`` over a loader: every forward builds one edge order
    and one species order for its batch (no stale cache hit across
    batches), and each K1 / K3 launch walks the order of its own batch."""
    seen = {}
    calls = route(monkeypatch, seen)
    items = []
    for m in molecules(seed=3, n_mol=12):
        items.append(m)
    host = Batch.from_data_list(
        [Data({k: ATTRS[k] for k in ("pos", "species", "dipole")},
              **{k: m[k] for k in ("pos", "species", "dipole")})
         for m in items])
    cfg = get_config("config_dipole")
    ds = CondensedDataset(data=host.data, attrs=host.attrs,
                          key_map={"species": ("species", "atom_types")},
                          preprocess=cfg["data_config"]["preprocess"],
                          type_names=cfg["data_config"]["type_names"])
    trainer = Trainer(narrow_model(reference["params"]), LOSS,
                      data_config=dict(cfg["data_config"], n_train=8,
                                       n_val=4, num_workers=0),
                      batch_size=4, max_epochs=1, use_ema=True)
    trainer.set_dataset(ds)
    e0, s0 = edge_order.builds, species_order.builds
    trainer.train()
    forwards = 3            # two training batches, one validation batch
    n = NARROW["num_layers"]
    assert calls["K1"] == calls["K3"] == n * forwards
    assert calls["K2"] == calls["K3b"] == n * 2
    assert edge_order.builds - e0 == forwards
    assert species_order.builds - s0 == forwards
    orders = []
    for args, order in seen["K1"]:
        want = edge_order.build(args[3], args[4], args[8])
        assert all(torch.equal(a, b) for a, b in zip(order, want))
        orders.append(order)
    assert orders[0] is orders[n - 1] and orders[n] is not orders[0]
    assert not torch.equal(orders[0].dst_perm, orders[n].dst_perm)
    for args, order in seen["K3"]:
        want = species_order.build(args[1], 18)
        assert all(torch.equal(a, b) for a, b in zip(order, want))
