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
- symmetry, covariance under a random rotation (as
  ``tests/test_hamiltonian.py``), padded graphs change nothing, ``evaluate``
  returns the real graphs only;
- ``Pairwise``, ``ResBlock``, ``NormActivation`` and
  ``TensorProductContraction`` each against their JAX counterpart.
"""

import jax
import jax.numpy as jnp
import numpy as np
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
from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as pairwise_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda import uvu_conv as uvu_mod
from equivariant_nn_zoo_tpu_torch.ops.gate import NormActivation
from equivariant_nn_zoo_tpu_torch.utils import build, load_jax_params

TOL = 1e-5
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


def _attrs():
    return dict(ATTRS, _n_edges=("graph", "1x0e"))


def _port_batch(mols, N=16, E=32, G=4):
    host = Batch.from_data_list([Data(_attrs(), **m) for m in mols])
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
    """Send the head's two kernels down their card path with each launch
    replaced by its plain contract; count the launches."""
    calls = {"K5": 0, "K6": 0}

    def k5(tpk, *args):
        calls["K5"] += 1
        return tpk.plain_forward(*args)

    def k6(conv, *args):
        calls["K6"] += 1
        return conv.plain_forward(*args)

    monkeypatch.setattr(pairwise_mod.PairwiseTP, "forward",
                        pairwise_mod.PairwiseTP.launch)
    monkeypatch.setattr(pairwise_mod, "launch_forward", k5)
    monkeypatch.setattr(uvu_mod.UVUConv, "forward", uvu_mod.UVUConv.launch)
    monkeypatch.setattr(uvu_mod, "launch_forward", k6)
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


def test_card_path_refuses_a_training_forward(slice_, routed):
    model, _, mols, _ = slice_
    with pytest.raises(NotImplementedError, match="no backward"):
        model(_port_batch(mols))
    assert routed == {"K5": 0, "K6": 0}


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
