"""Parity of the port's examples (``equivariant_nn_zoo_tpu_torch/examples``)
with the repository's JAX examples (``examples/``), on the CPU:

- the calculator on a narrow energy model (n_dim 8, l_max 2, 2 layers)
  and its force-head twin, on shared parameters: energy rel 1e-5, forces
  rel 1e-4 of max|F|; through the card path's Functions (launches routed
  to the plain contracts): K2 takes the sh cotangent once a layer and an
  evaluation, and the forces equal the plain path's;
- ``run_md`` in both packages from one seed, 20 steps at 0.05 fs:
  positions and energies at 1e-4, and the port's NVE drift under 0.2;
- the constrained SDE on full-width ``config_diffusion``: its first 10
  steps on JAX's own draws replayed, positions at 1e-4;
- ``infer_representation``'s counts, commutant dimension and residual;
- ``convert_datasets``: the files of both packages equal key for key, and
  the statistics equal;
- ``nn.PolynomialCutoff`` and ``nn.Lambda``.

JAX's potentials and the SDE step are jitted once per module-scoped
fixture.
"""

import os
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu.models import get_config as jget_config
from equivariant_nn_zoo_tpu.models import layer_configs as jlc
from equivariant_nn_zoo_tpu.nn import Lambda as JLambda
from equivariant_nn_zoo_tpu.nn import PolynomialCutoff as JCutoff
from equivariant_nn_zoo_tpu.run import sde_utils as jsde
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu_torch.examples import calculator as tcalc
from equivariant_nn_zoo_tpu_torch.examples import constrained_sde as tsde
from equivariant_nn_zoo_tpu_torch.examples import convert_datasets as tconv
from equivariant_nn_zoo_tpu_torch.examples import infer_representation as tinf
from equivariant_nn_zoo_tpu_torch.examples import md_dynamics as tmd
from equivariant_nn_zoo_tpu_torch.models import get_config
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.nn import Lambda, PolynomialCutoff
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as species_sc_mod
from equivariant_nn_zoo_tpu_torch.run.sde_utils import VPSDE
from equivariant_nn_zoo_tpu_torch.utils import build, load_jax_params
from test_torch_edge_order import torch_threads_per_worker
from test_torch_sde import Replay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from examples import calculator as jcalc  # noqa: E402
from examples import convert_datasets as jconv  # noqa: E402
from examples import infer_representation as jinf  # noqa: E402
from examples import md_dynamics as jmd  # noqa: E402

torch_threads_per_worker()

# __graft_entry__.py's _tiny_model
TINY = dict(n_dim=8, l_max=2, edge_spherical="1x0e+1x1o+1x2e",
            node_attrs="4x0e", edge_radial="4x0e", num_types=10,
            num_layers=2, r_max=4.0)
N_CAP, E_CAP = 32, 512


def _config(lc, force):
    cfg = lc.addEnergyOutput(lc.featureModel(**TINY), shifts=[0.0] * 10,
                             output_key="energy" if force else
                             "total_energy")
    return lc.addForceOutput(cfg) if force else cfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _molecule(seed=0, n=8):
    rng = np.random.default_rng(seed)
    Z = rng.choice([1, 6, 8], size=n, p=[0.5, 0.3, 0.2])
    return Z, rng.normal(size=(n, 3)) * 2.0


@pytest.fixture(scope="module", params=[False, True],
                ids=["energy", "force_head"])
def calculators(request):
    """The JAX calculator and the port's on the same parameters; the force
    model is unwrapped to its energy network, as ``from_config`` does."""
    force = request.param
    jmodel = jbuild(_config(jlc, force))
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = load_jax_params(build(_config(tlc, force)), params)
    if force:
        jmodel, params, tmodel = jmodel.func, params["func"], tmodel.func
    want = jcalc.E3Calculator(jmodel, params, 4.0, edge_capacity=E_CAP,
                              node_capacity=N_CAP)
    got = tcalc.E3Calculator(tmodel, 4.0, edge_capacity=E_CAP,
                             node_capacity=N_CAP, device="cpu")
    return want, got


def test_calculator_matches_jax(calculators):
    want, got = calculators
    Z, pos = _molecule()
    e_want, f_want = want.compute(Z, pos)
    e_got, f_got = got.compute(Z, pos)
    assert f_got.shape == (len(Z), 3)
    assert abs(e_got - e_want) <= 1e-5 * abs(e_want)
    assert _rel(f_got, f_want) <= 1e-4, _rel(f_got, f_want)
    assert not any(p.requires_grad for p in got.model.parameters())


def _route_k1_k2_k3(monkeypatch, calls):
    """The card path's Functions with every K1/K2/K3/K3b launch routed to
    its plain contract, counted (K2's dsh keyword recorded)."""
    def counted(key, plain):
        def launch(mod, *args, order=None, **kw):
            calls[key] += 1
            if kw.get("dsh"):
                calls["K2 dsh"] += 1
            return getattr(mod, plain)(*args, **kw)
        return launch

    for mod, cls, fwd, bwd in (
            (full_conv_mod, full_conv_mod.FullConv,
             counted("K1", "plain_forward"), counted("K2", "plain_backward")),
            (species_sc_mod, species_sc_mod.SpeciesScalarFCTP,
             counted("K3", "table_product"),
             counted("K3b", "plain_backward"))):
        monkeypatch.setattr(cls, "forward", cls.launch)
        monkeypatch.setattr(mod, "launch_forward", fwd)
        monkeypatch.setattr(mod, "launch_backward", bwd)


def test_calculator_forces_through_k2_dsh(monkeypatch):
    """On a first-order model the forces go through ``FullConvFunction``:
    each layer's K2 runs once an evaluation with the sh cotangent, and the
    forces equal the plain path's."""
    model = load_jax_params(build(_config(tlc, False)), jbuild(
        _config(jlc, False)).init(jax.random.PRNGKey(0)))
    calc = tcalc.E3Calculator(model, 4.0, edge_capacity=E_CAP,
                              node_capacity=N_CAP, device="cpu")
    Z, pos = _molecule(seed=1)
    e_want, f_want = calc.compute(Z, pos)
    calls = {"K1": 0, "K2": 0, "K2 dsh": 0, "K3": 0, "K3b": 0}
    _route_k1_k2_k3(monkeypatch, calls)
    e_got, f_got = calc.compute(Z, pos)
    layers = TINY["num_layers"]
    # layer 0's input features do not depend on positions: no K3b there
    assert calls == {"K1": layers, "K2": layers, "K2 dsh": layers,
                     "K3": layers, "K3b": layers - 1}
    assert abs(e_got - e_want) <= 1e-6 * abs(e_want)
    assert _rel(f_got, f_want) <= 1e-5


def test_calculator_refuses_pairs_past_the_capacity():
    model = build(_config(tlc, False))
    calc = tcalc.E3Calculator(model, 4.0, edge_capacity=8,
                              node_capacity=N_CAP, device="cpu")
    with pytest.raises(RuntimeError, match="edge capacity"):
        calc.compute(*_molecule())


@pytest.fixture(scope="module")
def md_runs():
    """20 steps of velocity Verlet at 0.05 fs in both packages, from one
    seed and one set of parameters."""
    cfg = _config(jlc, False)
    jmodel = jbuild(cfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = load_jax_params(build(_config(tlc, False)), params)
    Z, pos = _molecule()
    kw = dict(dt_fs=0.05, n_steps=20, T=100.0, seed=0, steps_per_block=10,
              log=None)
    want = jmd.run_md(jcalc.E3Calculator(jmodel, params, 4.0, E_CAP, N_CAP),
                      Z, pos, **kw)
    got = tmd.run_md(tcalc.E3Calculator(tmodel, 4.0, E_CAP, N_CAP, "cpu"),
                     Z, pos, **kw)
    return want, got


def test_md_trajectory_matches_jax(md_runs):
    (pos_want, e_want), (pos_got, e_got) = md_runs
    assert pos_got.shape == pos_want.shape and e_got.shape == e_want.shape
    assert _rel(pos_got, pos_want) <= 1e-4
    np.testing.assert_allclose(e_got, e_want, rtol=1e-4, atol=1e-6)


def test_md_conserves_energy(md_runs):
    _, (_, e_traj) = md_runs
    assert np.isfinite(e_traj).all()
    assert tmd.drift_ratio(e_traj) < 0.2


def _jax_constrained(steps):
    """The JAX example's loop (``examples/constrained_sde.py``) for its
    first ``steps`` steps: parameters, JAX's draws in the order the port's
    noise source hands them out, and the positions."""
    from equivariant_nn_zoo_tpu.data import (
        Batch,
        Data,
        GraphBatch,
        computeEdgeIndex,
    )

    rng = np.random.default_rng(0)
    cfg = jget_config("config_diffusion")
    model = jbuild(cfg.model_config)
    params = model.init(jax.random.PRNGKey(0))
    sde = jsde.VPSDE(dict(cfg.diffusion_keys), N=100)
    n = 8
    d = {"pos": rng.normal(size=(n, 3)),
         "species": rng.integers(1, 9, size=(n, 1)),
         "total_energy": np.zeros((1, 1))}
    attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
             "total_energy": ("graph", "1x0e")}
    out, attrs = computeEdgeIndex(d, attrs, r_max=9999)
    d.update(out)
    d["bond_type"] = rng.integers(0, 4, size=(d["edge_index"].shape[1], 1))
    attrs["bond_type"] = ("edge", "1x0e")
    gb = GraphBatch.from_batch(Batch.from_data_list([Data(attrs, **d)]), 16,
                               128, 1)
    gb = gb.replace(t=jnp.ones((1, 1)))
    gb.attrs["t"] = ("graph", "1x0e")

    def project(pos):
        v = pos[1] - pos[0]
        dist = jnp.linalg.norm(v) + 1e-9
        corr = (dist - tsde.TARGET_DIST) * v / dist / 2
        return pos.at[0].add(tsde.RELAX_STRENGTH * corr).at[1].add(
            -tsde.RELAX_STRENGTH * corr)

    prior_key = jax.random.PRNGKey(1)
    batch = sde.prior_sampling(gb, prior_key)
    draws = [("normal", np.asarray(batch["pos"]))]
    rsde = sde.reverse(jsde.get_score_fn(sde, model, params))

    @jax.jit
    def step(batch, t, key):
        g = batch["_graph_mask"].shape[0]
        batch = batch.replace(t=jnp.ones((g, 1), jnp.float32) * t)
        batch = rsde.sde(batch, key)
        return batch.replace(pos=project(batch["pos"]))

    key = jax.random.PRNGKey(2)
    for t in np.linspace(sde.T, 1e-3, sde.N)[:steps]:
        key, sub = jax.random.split(key)
        _, z_key = jax.random.split(sub)       # VPSDE.sde's one key
        draws.append(("normal", np.asarray(jax.random.normal(
            z_key, (16, 3), jnp.float32))))
        data = {k: batch[k] for k in batch.data
                if k not in ("edge_vector", "edge_length")}
        batch = GraphBatch(data, dict(batch.attrs), batch.n_graphs,
                           batch.node_capacity, batch.edge_capacity)
        batch = step(batch, float(t), sub)
    return params, draws, np.asarray(batch["pos"])


def test_constrained_sde_matches_jax():
    steps = 10
    params, draws, want = _jax_constrained(steps)
    cfg = get_config("config_diffusion")
    model = load_jax_params(build(cfg["model_config"]), params).eval()
    sde = VPSDE(dict(cfg["diffusion_keys"]), N=100)
    noise = Replay(draws)
    got = tsde.sample(model, sde, tsde.system("cpu"), noise, steps=steps)
    assert noise.done
    got = got["pos"].numpy()
    assert np.isfinite(got).all()
    assert _rel(got, want) <= 1e-4, _rel(got, want)


def _jax_infer(n_samples, seed=0):
    """``examples/infer_representation.py``'s main, returning its
    figures."""
    from equivariant_nn_zoo_tpu.ops import Irreps, irreps_d, rand_matrix

    rng = np.random.default_rng(seed)
    irreps = Irreps("1x0e+1x1o+1x2e")
    d = irreps.dim
    Q_true, _ = np.linalg.qr(rng.normal(size=(d, d)))
    gs = [rand_matrix(rng) for _ in range(n_samples)]
    samples = [(g, Q_true @ irreps_d(irreps, g) @ Q_true.T) for g in gs]
    counts = jinf.infer_irrep_content(samples, max_l=3)
    A = np.concatenate([np.kron(M, np.eye(d)) - np.kron(
        np.eye(d), irreps_d(irreps, g).T) for g, M in samples])
    _, s, vh = np.linalg.svd(A, full_matrices=False)
    Q_est = vh[-1].reshape(d, d)
    g = rand_matrix(rng)
    M = Q_true @ irreps_d(irreps, g) @ Q_true.T
    err = np.abs(M @ Q_est - Q_est @ irreps_d(irreps, g)).max()
    return counts, int((s < 1e-8).sum()), err


def test_infer_representation_matches_jax():
    counts, null_dim, err = tinf.main(n_samples=300, log=None)
    want_counts, want_null, want_err = _jax_infer(300)
    assert set(counts) == set(want_counts)
    for l in counts:
        assert abs(counts[l] - want_counts[l]) <= 1e-12
    assert [round(counts[l]) for l in range(4)] == [1, 1, 1, 0]
    assert null_dim == want_null
    assert abs(err - want_err) <= 1e-12 and err < 1e-8
    # the change of basis by least squares, on the same samples
    rng = np.random.default_rng(3)
    ins = [rng.normal(size=(9, 9)) for _ in range(4)]
    Q = rng.normal(size=(9, 9))
    outs = [Q @ a for a in ins]
    got = tinf.infer_change_of_basis(ins, outs, "1x0e+1x1o+1x2e")
    want = jinf.infer_change_of_basis(ins, outs, "1x0e+1x1o+1x2e")
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)
    assert abs(got[1] - want[1]) <= 1e-12


def _h5(path):
    with h5py.File(path, "r") as f:
        return ({k: np.asarray(f[k]) for k in f.keys()},
                {k: tuple(np.asarray(v).tolist()) for k, v in f.attrs.items()})


def _same_files(a, b):
    (da, aa), (db, ab) = _h5(a), _h5(b)
    assert sorted(da) == sorted(db) and aa == ab
    for k in da:
        assert da[k].dtype == db[k].dtype, k
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def test_convert_datasets_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    n_mol, width = 6, 9
    Z = np.zeros((n_mol, width), np.int64)
    for i in range(n_mol):
        n = int(rng.integers(3, width + 1))
        Z[i, :n] = rng.choice([1, 6, 7, 8, 9], size=n)
    npz = tmp_path / "qm9.npz"
    np.savez(npz, R=rng.normal(size=(n_mol, width, 3)), Z=Z,
             U0=rng.normal(size=n_mol) - 400.0)
    for mod, name in ((jconv, "jax.hdf5"), (tconv, "port.hdf5")):
        mod.convert_qm9(str(npz), str(tmp_path / name))
    _same_files(tmp_path / "jax.hdf5", tmp_path / "port.hdf5")

    padded = tmp_path / "padded.hdf5"
    with h5py.File(padded, "w") as f:
        f["Z"] = Z[:, :, None]
        f["R"] = rng.normal(size=(n_mol, width, 3)).astype(np.float32)
        f["E"] = rng.normal(size=(n_mol, 1)).astype(np.float32)
        f.attrs["Z"] = ("node", "1x0e")
        f.attrs["R"] = ("node", "1x1o")
        f.attrs["E"] = ("graph", "1x0e")
    for mod, name in ((jconv, "jax_c.hdf5"), (tconv, "port_c.hdf5")):
        mod.convert_padded_hdf5(str(padded), str(tmp_path / name))
    _same_files(tmp_path / "jax_c.hdf5", tmp_path / "port_c.hdf5")

    fields = ["U0-per-Z-mean_std", "R-mean_std"]
    want = jconv.statistics(str(tmp_path / "jax.hdf5"), fields)
    got = tconv.statistics(str(tmp_path / "port.hdf5"), fields)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cutoff", ["poly", "symmetric"])
def test_polynomial_cutoff_matches_jax(cutoff):
    x = np.linspace(0.0, 5.0, 101).astype(np.float32)
    want = JCutoff(4.0, p=6, cutoff=cutoff)(jnp.asarray(x))
    got = PolynomialCutoff(4.0, p=6, cutoff=cutoff)(torch.tensor(x))
    # values in [0, 1]; near r_max the degree-8 polynomial cancels to
    # ~1e-6 in float32, where the two frameworks' pow differ in the last
    # bits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    with pytest.raises(AssertionError):
        PolynomialCutoff(4.0, p=1)


def test_lambda_matches_jax():
    def fn(data, attrs):
        return ({"y": data["x"] * 2.0 + 1.0},
                {"y": (attrs["x"][0], attrs["x"][1])})

    x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    attrs = {"x": ("node", "1x1o")}
    want = JLambda(fn).apply({}, {"x": jnp.asarray(x)}, attrs)
    got = Lambda(fn)({"x": torch.tensor(x)}, attrs)
    np.testing.assert_allclose(got[0]["y"].numpy(), np.asarray(want[0]["y"]))
    assert got[1] == want[1]
    assert list(Lambda(fn).parameters()) == []
