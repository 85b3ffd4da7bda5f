"""The port's ``config_hamiltonian`` slice against the JAX package (CPU,
float32), at a small size that keeps l_max 4: n_dim 4, 3 layers (the fewest
that reach every irrep of the head's input), 3 synthetic H2O molecules in a
batch padded to 4 graphs.  Parameters come from the JAX ``init`` through
``load_jax_params``; inputs from a numpy seed.  Tolerance: rel-linf 1e-5
(float32, different summation orders).

- ``hamiltonian`` and every ``hamiltonian_diagonal`` / ``hamiltonian_off``
  block against the JAX default CPU path, and ``hamiltonian`` once more
  against JAX with the TPU pairwise kernel forced on in interpret mode
  (``E3_PALLAS_PAIRWISE=force``); the JAX forwards are jitted (eager takes
  a minute at this size);
- the port's card path for the head (K5 and K6 launches routed to their
  plain contracts) gives the same matrices, with 2 K5 and 1 K6 launches per
  forward;
- training: every parameter's one-step gradient of the config's loss
  (1e5 * MSE on ``hamiltonian``, N(0, 1) labels) against ``jax.grad`` on
  the default CPU path and once more with the TPU pairwise kernel's
  backward passes in interpret mode, at rel-linf 1e-4 (2e-4 against the
  interpret-mode kernels); the routed card path (every kernel's launches
  replaced by its plain contract) gives the plain path's gradients with
  3 K1, 3 K2, 3 K3, 3 K3b, 1 K6, 1 K6b, 2 K5 and 2 K5-backward launches per
  step; one ``Trainer`` step with the config's settings (Adam 1e-2, EMA
  0.99 with num_updates) against optax on the same gradients;
- symmetry, covariance under a random rotation (as
  ``tests/test_hamiltonian.py``), padded graphs change nothing, ``evaluate``
  returns the real graphs only;
- ``Pairwise``, ``ResBlock``, ``NormActivation`` and
  ``TensorProductContraction`` each against their JAX counterpart.
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
from equivariant_nn_zoo_tpu.models.config_hamiltonian import \
    contractBasis as j_contract_basis
from equivariant_nn_zoo_tpu.nn.output import Pairwise as JPairwise
from equivariant_nn_zoo_tpu.nn.output import \
    TensorProductContraction as JContraction
from equivariant_nn_zoo_tpu.nn.pointwise import ResBlock as JResBlock
from equivariant_nn_zoo_tpu.ops.gate import NormActivation as JNormActivation
from equivariant_nn_zoo_tpu.run import loss as jloss
from equivariant_nn_zoo_tpu.run.trainer import make_ema_update
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
from equivariant_nn_zoo_tpu_torch.models.config_hamiltonian import (
    contractBasis,
    orca_transform_matrix,
)
from equivariant_nn_zoo_tpu_torch.nn.output import (
    Pairwise,
    TensorProductContraction,
)
from equivariant_nn_zoo_tpu_torch.nn.pointwise import ResBlock
from equivariant_nn_zoo_tpu_torch.ops import Irreps, irreps_d, rand_matrix
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as pairwise_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as species_sc_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
from equivariant_nn_zoo_tpu_torch.ops.cuda import uvu_conv as uvu_mod
from equivariant_nn_zoo_tpu_torch.ops.gate import NormActivation
from equivariant_nn_zoo_tpu_torch.run import Loss, Trainer
from equivariant_nn_zoo_tpu_torch.utils import build, load_jax_params
from equivariant_nn_zoo_tpu_torch.utils.params import params_from_jax
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

TOL = 1e-5
GRAD_TOL = 1e-4        # gradients: longer sums, other orders
INTERPRET_TOL = 2e-4   # against the interpret-mode kernels' own VJPs
LOSS = {"hamiltonian": [1e5, "MSELoss"]}
MODEL_KW = dict(n_dim=4, l_max=4, edge_spherical="1x0e+1x1o+1x2e+1x3o",
                node_attrs="8x0e", edge_radial="8x0e", num_types=9,
                num_layers=3, r_max=4.0)
BASIS = "3x0e+2x1o+1x2e"
ATTRS = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
         "atom_types": ("node", "1x0e")}
N_MOL = 3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _molecules(seed=0, n_mol=N_MOL):
    """Synthetic H2O: the equilibrium geometry plus N(0, 0.03^2) noise,
    with its radius-graph edges (all six ordered pairs at r_max 4)."""
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        pos = np.array([[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]])
        d = {"pos": pos + rng.normal(scale=0.03, size=(3, 3)),
             "species": np.array([[8], [1], [1]])}
        d["atom_types"] = d["species"]
        out, _ = computeEdgeIndex(d, dict(ATTRS), r_max=4.0)
        d.update(out)
        mols.append(d)
    return mols


def _labelled(mols, seed=7):
    """The molecules with N(0, 1) ``hamiltonian`` targets."""
    rng = np.random.default_rng(seed)
    return [dict(m, hamiltonian=rng.normal(size=(1, 576)).astype(np.float32))
            for m in mols]


def _attrs(mol=()):
    attrs = dict(ATTRS, _n_edges=("graph", "1x0e"))
    if "hamiltonian" in mol:
        attrs["hamiltonian"] = ("graph", 576)
    return attrs


def _port_batch(mols, N=16, E=32, G=4):
    host = Batch.from_data_list([Data(_attrs(m), **m) for m in mols])
    gb = GraphBatch.from_batch(host, N, E, G, "cpu")
    assert gb.dropped == 0
    return gb


def _jax_config():
    cfg = jlc.addMatrixOutput(jlc.featureModel(**MODEL_KW), BASIS, BASIS)
    cfg.layers.append(("hamiltonian", j_contract_basis))
    return cfg


def _port_config():
    cfg = tlc.addMatrixOutput(tlc.featureModel(**MODEL_KW), BASIS, BASIS)
    cfg["layers"].append(("hamiltonian", contractBasis))
    return cfg


def _jax_forward(jmodel, params, mols):
    host = JBatch.from_data_list([JData(_attrs(), **m) for m in mols])
    gb = JGraphBatch.from_batch(host, 16, 32, 4)
    keys = ("hamiltonian", "hamiltonian_diagonal", "hamiltonian_off")
    fn = jax.jit(lambda p, b: {k: jmodel.apply(p, b)[k] for k in keys})
    return jax.tree_util.tree_map(np.asarray, fn(params, gb))


@pytest.fixture(scope="module")
def slice_():
    """The JAX model, its parameters, the port on those parameters, the
    molecules, and the JAX default CPU path's outputs."""
    jmodel = jbuild(_jax_config())
    params = jmodel.init(jax.random.PRNGKey(0))
    model = build(_port_config())
    load_jax_params(model, params)
    model.eval()
    mols = _molecules()
    return model, params, mols, _jax_forward(jmodel, params, mols)


def _port_forward(model, gb):
    with torch.no_grad():
        return model(gb)


@pytest.fixture
def routed(monkeypatch):
    """Send every kernel wrapper of the model down its card path with each
    launch replaced by its plain contract.  The returned dict counts the
    forward launches of the head's kernels (K5, K6); its ``more`` attribute
    counts the trunk's forwards and every backward kernel."""

    class Calls(dict):
        pass

    calls = Calls(K5=0, K6=0)
    more = calls.more = {"K1": 0, "K2": 0, "K3": 0, "K3b": 0, "K6b": 0,
                         "K5 backward": 0}

    def counting(table, key, attr):
        def launch(mod, *args, order=None):   # K1-K3b and K6b take an order
            table[key] += 1
            return getattr(mod, attr)(*args)
        return launch

    routes = (
        (pairwise_mod, pairwise_mod.PairwiseTP,
         counting(calls, "K5", "plain_forward"),
         counting(more, "K5 backward", "plain_backward")),
        (uvu_mod, uvu_mod.UVUConv, counting(calls, "K6", "plain_forward"),
         counting(more, "K6b", "plain_backward")),
        (full_conv_mod, full_conv_mod.FullConv,
         counting(more, "K1", "plain_forward"),
         counting(more, "K2", "plain_backward")),
        (species_sc_mod, species_sc_mod.SpeciesScalarFCTP,
         counting(more, "K3", "table_product"),
         counting(more, "K3b", "plain_backward")),
    )
    for mod, cls, fwd, bwd in routes:
        monkeypatch.setattr(cls, "forward", cls.launch)
        monkeypatch.setattr(mod, "launch_forward", fwd)
        monkeypatch.setattr(mod, "launch_backward", bwd)
    return calls


def test_hamiltonian_matches_jax(slice_):
    model, _, mols, ref = slice_
    out = _port_forward(model, _port_batch(mols))
    got = out["hamiltonian"].numpy()
    assert got.shape == ref["hamiltonian"].shape == (4, 576)
    assert np.isfinite(got).all()
    assert _rel(got[:N_MOL], ref["hamiltonian"][:N_MOL]) < TOL


@pytest.mark.parametrize("key,rows", [("hamiltonian_diagonal", 3 * N_MOL),
                                      ("hamiltonian_off", 6 * N_MOL)])
def test_blocks_match_jax(slice_, key, rows):
    model, _, mols, ref = slice_
    out = _port_forward(model, _port_batch(mols))
    assert set(out[key]) == set(ref[key]) and len(ref[key]) == 9
    for name, want in ref[key].items():
        got = out[key][name].numpy()
        assert got.shape == want.shape, name
        assert _rel(got[:rows], want[:rows]) < TOL, name


def test_hamiltonian_matches_jax_with_the_pairwise_kernel(slice_,
                                                          monkeypatch):
    """JAX with ``PallasPairwiseTP`` forced on (interpret mode, tile 16,
    float32) gives the port's matrices too."""
    model, params, mols, _ = slice_
    monkeypatch.setenv("E3_PALLAS_PAIRWISE", "force")
    monkeypatch.setenv("E3_COMPUTE_DTYPE", "float32")
    jmodel = jbuild(_jax_config())
    head = dict(jmodel.layers)["pairwise"]
    assert head._pairwise_kernel is not None
    ref = _jax_forward(jmodel, params, mols)["hamiltonian"]
    got = _port_forward(model, _port_batch(mols))["hamiltonian"].numpy()
    assert _rel(got[:N_MOL], ref[:N_MOL]) < TOL


def test_card_path_of_the_head_matches(slice_, routed):
    model, _, mols, ref = slice_
    got = _port_forward(model, _port_batch(mols))["hamiltonian"].numpy()
    assert routed == {"K5": 2, "K6": 1}
    assert _rel(got[:N_MOL], ref["hamiltonian"][:N_MOL]) < TOL


# ------------------------------------------------------------------ training

def _jax_step(jmodel, params, mols):
    """Loss and every parameter's gradient of one step on the JAX model
    (jitted), the gradients as a flat ``state_dict``."""
    host = JBatch.from_data_list([JData(_attrs(m), **m) for m in mols])
    jgb = JGraphBatch.from_batch(host, 16, 32, 4)
    loss = jloss.Loss(LOSS)

    def f(p):
        return loss(jmodel.apply(p, jgb).data, jgb.data)[0]

    value, grads = jax.jit(jax.value_and_grad(f))(params)
    return float(value), params_from_jax(jax.device_get(grads))


def _port_step(model, gb):
    model.zero_grad()
    loss, _ = Loss(LOSS)(model(gb).data, gb.data)
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def train_ref(slice_):
    """Labelled molecules, and the JAX default CPU path's loss and
    gradients of one step on them."""
    _, params, mols, _ = slice_
    mols = _labelled(mols)
    return (mols, *_jax_step(jbuild(_jax_config()), params, mols))


def _assert_gradients(got, want, tol):
    """Each tensor at rel-linf ``tol`` of its own max.  A gradient that is
    zero by symmetry comes out as rounding noise (1e-17 beside 1e-2 here):
    such a tensor, under 1e-12 of the largest gradient, is held to be as
    small in the port."""
    assert set(got) == set(want)
    floor = 1e-12 * max(float(w.abs().max()) for w in want.values())
    assert floor > 0
    for name, w in want.items():
        if float(w.abs().max()) < floor:
            assert float(got[name].abs().max()) < floor, name
        else:
            assert _rel(got[name].numpy(), w.numpy()) < tol, name


def test_step_gradients_match_jax(slice_, train_ref):
    """Every parameter of the slice (the l = 4 trunk, ``pairwise.*``,
    ``irreps2tp*.linear.*``) gets JAX's gradient: the name mapping of
    ``load_jax_params`` and the port's backward hold together."""
    model, _, _, _ = slice_
    mols, want_loss, want = train_ref
    loss, got = _port_step(model, _port_batch(mols))
    assert _rel(loss, want_loss) < TOL
    assert any(n.startswith("pairwise.tp_off.") for n in want)
    assert any(n.startswith("irreps2tp_off.linear.") for n in want)
    _assert_gradients(got, want, GRAD_TOL)


def test_step_gradients_match_jax_with_the_pairwise_kernel(
        slice_, train_ref, monkeypatch):
    """JAX with ``PallasPairwiseTP`` forced on differentiates through its
    three backward kernels (interpret mode, float32)."""
    model, params, _, _ = slice_
    mols, _, _ = train_ref
    monkeypatch.setenv("E3_PALLAS_PAIRWISE", "force")
    monkeypatch.setenv("E3_COMPUTE_DTYPE", "float32")
    jmodel = jbuild(_jax_config())
    assert dict(jmodel.layers)["pairwise"]._pairwise_kernel is not None
    want_loss, want = _jax_step(jmodel, params, mols)
    loss, got = _port_step(model, _port_batch(mols))
    assert _rel(loss, want_loss) < TOL
    _assert_gradients(got, want, INTERPRET_TOL)


@pytest.fixture(scope="module")
def plain_step(slice_, train_ref):
    """The port's loss and gradients of one step on its plain CPU path
    (module-scoped: computed before any test routes the wrappers)."""
    return _port_step(slice_[0], _port_batch(train_ref[0]))


def test_card_path_trains(slice_, train_ref, plain_step, routed):
    """The routed card path (autograd Functions over the plain contracts)
    gives the plain path's loss and gradients, with one K6b and two
    K5-backward launches per step beside the trunk's, and one edge order
    per step: the head's K6b walks the one the trunk's layers built."""
    want_loss, want = plain_step
    builds = edge_order.builds
    loss, got = _port_step(slice_[0], _port_batch(train_ref[0]))
    assert edge_order.builds == builds + 1
    assert routed == {"K5": 2, "K6": 1}
    assert routed.more == {"K1": 3, "K2": 3, "K3": 3, "K3b": 3, "K6b": 1,
                           "K5 backward": 2}
    assert _rel(loss, want_loss) < 1e-6
    _assert_gradients(got, want, TOL)


def test_trainer_step_matches_optax(slice_, train_ref):
    """One ``Trainer.batch_step`` with the config's settings on the
    ``hamiltonian`` key: the loss is JAX's, and the parameters and their
    EMA move as ``optax.adam(1e-2)`` and the JAX package's EMA move them on
    the same gradients; the ``hamiltonian`` mae is accumulated."""
    _, params, _, _ = slice_
    mols, want_loss, _ = train_ref
    model = load_jax_params(build(_port_config()), params)
    trainer = Trainer(
        model, LOSS, metrics_components={"hamiltonian": ["mae"]},
        learning_rate=1e-2, use_ema=True, ema_decay=0.99,
        ema_use_num_updates=True, optimizer_name="Adam",
        lr_scheduler_name="ReduceLROnPlateau", lr_scheduler_patience=8,
        lr_scheduler_factor=0.8)
    before = {n: jnp.asarray(p.detach().numpy().copy())
              for n, p in model.named_parameters()}
    gb = _port_batch(mols)
    trainer.batch_step(gb)
    assert _rel(float(trainer.batch_losses["loss"]), want_loss) < TOL
    grads = {n: jnp.asarray(p.grad.numpy().copy())
             for n, p in model.named_parameters()}
    opt = optax.adam(1e-2)
    updates, _ = opt.update(grads, opt.init(before), before)
    after = optax.apply_updates(before, updates)
    ema = make_ema_update(0.99, True)(
        {"params": before, "num_updates": jnp.zeros((), jnp.int32)}, after)
    ema_params = dict(trainer.ema_model.named_parameters())
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[n], rtol=0,
                                   atol=1e-6, err_msg=n)
        np.testing.assert_allclose(ema_params[n].numpy(), ema["params"][n],
                                   rtol=0, atol=1e-6, err_msg=n)
    trainer.batch_step(gb, validation=True)
    flat, _ = trainer.metrics.flatten_metrics(
        trainer.metrics.current_result())
    assert set(flat) == {"hamiltonian_mae"}
    assert np.isfinite(flat["hamiltonian_mae"]) and flat["hamiltonian_mae"] > 0


def test_hamiltonian_symmetric(slice_):
    model, _, mols, _ = slice_
    H = _port_forward(model, _port_batch(mols))["hamiltonian"].numpy()
    H = H[:N_MOL].reshape(N_MOL, 24, 24)
    assert np.abs(H - H.transpose(0, 2, 1)).max() <= 1e-5 * np.abs(H).max()


def test_hamiltonian_covariance(slice_):
    """H(R x) = D(R) H(x) D(R)^T in the ORCA-mapped basis."""
    model, _, mols, _ = slice_
    gb = _port_batch(mols)
    H = _port_forward(model, gb)["hamiltonian"].numpy()[:N_MOL]
    R = rand_matrix(np.random.default_rng(11))
    rotated = gb.replace(pos=gb["pos"] @ torch.tensor(R.T,
                                                      dtype=torch.float32))
    H_rot = _port_forward(model, rotated)["hamiltonian"].numpy()[:N_MOL]
    # O(3s 2p 1d) + H(2s 1p) + H(2s 1p) in the internal convention
    D_int = irreps_d(Irreps("3x0e+2x1o+1x2e+2x0e+1x1o+2x0e+1x1o"), R)
    M = orca_transform_matrix()
    D = M.T @ D_int @ M
    scale = np.abs(H).max()
    assert scale > 1e-6, "degenerate test"
    for h, h_rot in zip(H, H_rot):
        want = D @ h.reshape(24, 24) @ D.T
        assert np.abs(h_rot.reshape(24, 24) - want).max() / scale < 2e-3


def test_padding_changes_nothing(slice_):
    """Other capacities, another number of padded graphs and moved padded
    nodes leave the real graphs' matrices unchanged; padded rows stay
    finite."""
    model, _, mols, _ = slice_
    gb = _port_batch(mols)
    H = _port_forward(model, gb)["hamiltonian"].numpy()
    assert np.isfinite(H).all()
    pos = gb["pos"].clone()
    pos[3 * N_MOL:] += 50.0
    moved = _port_forward(model, gb.replace(pos=pos))["hamiltonian"].numpy()
    np.testing.assert_array_equal(moved[:N_MOL], H[:N_MOL])
    big = _port_forward(model, _port_batch(mols, N=24, E=48, G=6))
    np.testing.assert_allclose(big["hamiltonian"].numpy()[:N_MOL], H[:N_MOL],
                               rtol=1e-5, atol=1e-6)


def test_evaluate_returns_real_graphs_only(slice_):
    model, _, mols, _ = slice_
    more = _molecules(seed=1, n_mol=2)
    batches = [_port_batch(mols), _port_batch(more, G=3)]
    res = evaluate(model, batches, ["hamiltonian"])
    assert len(res) == N_MOL + 2
    assert res["hamiltonian"].shape == (N_MOL + 2, 576)
    want = np.concatenate([
        _port_forward(model, batches[0])["hamiltonian"].numpy()[:N_MOL],
        _port_forward(model, batches[1])["hamiltonian"].numpy()[:2]])
    np.testing.assert_allclose(res["hamiltonian"], want, rtol=1e-6)
    # without named keys the graph-level matrix is the public output
    assert "hamiltonian" in evaluate(model, batches[:1]).keys()


def test_config_registered_with_the_full_width_model():
    cfg = get_config("config_hamiltonian")
    mc = cfg["model_config"]
    assert (mc["n_dim"], mc["l_max"], mc["num_layers"]) == (64, 4, 5)
    assert cfg["batch_size"] == 16
    names = [k for k, _ in mc["layers"]]
    assert names[-4:] == ["pairwise", "irreps2tp_diagonal", "irreps2tp_off",
                          "hamiltonian"]
    M = orca_transform_matrix()
    np.testing.assert_allclose(M.T @ M, np.eye(24), atol=1e-6)


# ------------------------------------------------------------------ modules

SPEC = "4x0e+4x1o+4x2e"


def test_norm_activation_matches_jax():
    irreps = "4x0e+4x0o+3x1o+2x2e"
    x = np.random.default_rng(2).normal(
        size=(7, Irreps(irreps).dim)).astype(np.float32)
    x[0] = 0.0   # the epsilon keeps a zero row finite
    ref = JNormActivation(irreps, "silu")(jnp.asarray(x))
    got = NormActivation(irreps, "silu")(torch.tensor(x)).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize("irreps_out", [SPEC, "4x0e+2x1o"],
                         ids=["same", "narrower"])
def test_res_block_matches_jax(irreps_out):
    jblock = JResBlock(SPEC, irreps_out)
    params = jblock.init(jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(    # biases start at zero: move them
        lambda p: p + 0.1 * jnp.arange(p.size, dtype=p.dtype).reshape(
            p.shape), params)
    block = ResBlock(SPEC, irreps_out)
    load_jax_params(block, params)
    x = np.random.default_rng(3).normal(size=(6, 36)).astype(np.float32)
    ref = jblock.block(params, jnp.asarray(x))
    with torch.no_grad():
        got = block.block(torch.tensor(x))
        via_forward, attrs = block({"input": torch.tensor(x)},
                                   {"input": ("node", SPEC)})
    assert _rel(got.numpy(), ref) < TOL
    assert torch.equal(via_forward["output"], got)
    assert attrs["output"] == ("node", irreps_out)


def test_contraction_matches_jax():
    """Blocks of mixed degree and parity, filled from the tail of each
    (degree, parity) allocation."""
    jmod = JContraction(SPEC + "+4x1e", "2x0e+1x1o", "1x0e+2x1o")
    params = jmod.init(jax.random.PRNGKey(2))
    mod = TensorProductContraction(SPEC + "+4x1e", "2x0e+1x1o", "1x0e+2x1o")
    load_jax_params(mod, params)
    x = np.random.default_rng(4).normal(size=(5, 48)).astype(np.float32)
    attrs = {"irreducible": ("node", SPEC + "+4x1e")}
    ref, _ = jmod.apply(params, {"irreducible": jnp.asarray(x)}, attrs)
    with torch.no_grad():
        got, _ = mod({"irreducible": torch.tensor(x)}, attrs)
    assert set(got["tp_l"]) == set(ref["tp_l"]) == {
        "2x0e*1x0e", "2x0e*2x1o", "1x1o*1x0e", "1x1o*2x1o"}
    for key, want in ref["tp_l"].items():
        assert got["tp_l"][key].shape == want.shape, key
        assert _rel(got["tp_l"][key].numpy(), want) < TOL, key


@pytest.mark.parametrize("conv", [None, "auto"], ids=["gather", "conv"])
def test_pairwise_matches_jax(conv):
    kw = dict(node_features=SPEC, edge_radial="4x0e",
              edge_spherical="1x0e+1x1o+1x2e", diagonal=SPEC,
              off_diagonal=SPEC, conv=conv)
    jhead = JPairwise(**kw)
    params = jhead.init(jax.random.PRNGKey(3))
    head = Pairwise(**kw)
    load_jax_params(head, params)
    rng = np.random.default_rng(5)
    N, E = 12, 30
    ei = rng.integers(0, N, size=(2, E))
    data = {"node_features": rng.normal(size=(N, 36)).astype(np.float32),
            "edge_radial": rng.normal(size=(E, 4)).astype(np.float32),
            "edge_spherical": rng.normal(size=(E, 9)).astype(np.float32)}
    attrs = {"node_features": ("node", SPEC), "edge_index": ("edge", "1x0e")}
    ref, _ = jhead.apply(
        params, dict({k: jnp.asarray(v) for k, v in data.items()},
                     edge_index=jnp.asarray(ei, jnp.int32)), dict(attrs))
    with torch.no_grad():
        got, got_attrs = head(
            dict({k: torch.tensor(v) for k, v in data.items()},
                 edge_index=torch.tensor(ei)), dict(attrs))
    assert got_attrs["diagonal"][0] == "node"
    assert got_attrs["off_diagonal"][0] == "edge"
    for key in ("diagonal", "off_diagonal"):
        assert _rel(got[key].numpy(), ref[key]) < TOL, key
