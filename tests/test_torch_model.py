"""Model-level parity of the PyTorch port's ``config_energy`` forward with
the JAX package (CPU, f32), at a small size: n_dim 8, l_max 2, 3 layers.

Per-graph ``total_energy`` of the port (plain padded batch; on the CPU the
kernel wrappers take their plain versions) must match the JAX default CPU
path on the same padded batch, and the JAX Pallas path (E3_PALLAS=force,
interpret-mode kernels) on a tile-aligned batch of the same molecules —
graph energies do not depend on node order.  Tolerance: rel-linf 1e-5 of
the largest energy (float32, different summation orders).
"""

import jax
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu.data import Batch as JBatch
from equivariant_nn_zoo_tpu.data import Data as JData
from equivariant_nn_zoo_tpu.data import GraphBatch as JGraphBatch
from equivariant_nn_zoo_tpu.models import layer_configs as jlc
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu_torch.data import (
    Batch,
    Data,
    GraphBatch,
    computeEdgeIndex,
)
from equivariant_nn_zoo_tpu_torch.inference import evaluate
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.ops import rand_matrix
from equivariant_nn_zoo_tpu_torch.utils import build, load_jax_params
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

TOL = 1e-5
SHIFTS = [-0.5, -1.0, 0.0, 0.5, 1.0, 1.5, -2.0, -3.0, 2.5, 0.25]
MODEL_KW = dict(n_dim=8, l_max=2, node_attrs="4x0e", edge_radial="4x0e",
                num_types=10, num_layers=3, r_max=3.0)
ATTRS = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
         "atom_types": ("node", "1x0e")}


def _molecules(seed=0, n_mol=6):
    """numpy molecules, each with its radius-graph edges."""
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(5, 12))
        d = {"pos": rng.normal(size=(n, 3)) * 1.2,
             "species": rng.choice([1, 6, 7, 8], size=(n, 1))}
        d["atom_types"] = d["species"]
        out, _ = computeEdgeIndex(d, dict(ATTRS), r_max=3.0)
        d.update(out)
        mols.append(d)
    return mols


def _attrs():
    return dict(ATTRS, _n_edges=("graph", "1x0e"))


def _port_batch(mols, N=128, E=1024):
    host = Batch.from_data_list([Data(_attrs(), **m) for m in mols])
    gb = GraphBatch.from_batch(host, N, E, len(mols), "cpu")
    assert gb.dropped == 0
    return gb


def _jax_batch(mols, tiled):
    host = JBatch.from_data_list([JData(_attrs(), **m) for m in mols])
    if tiled:
        gb = JGraphBatch.from_batch(host, 256, 1024, len(mols),
                                    edge_tile=128, window=128)
    else:
        gb = JGraphBatch.from_batch(host, 128, 1024, len(mols))
    assert gb.dropped == 0
    return gb


@pytest.fixture(scope="module")
def port_and_params():
    mc = jlc.addEnergyOutput(jlc.featureModel(**MODEL_KW), SHIFTS)
    params = jbuild(mc).init(jax.random.PRNGKey(0))
    model = build(tlc.addEnergyOutput(tlc.featureModel(**MODEL_KW), SHIFTS))
    load_jax_params(model, params)
    return model, params


def _port_energy(model, gb):
    with torch.inference_mode():
        return model(gb)["total_energy"].numpy()[:, 0]


@pytest.mark.parametrize("jax_path", ["default", "pallas_force"])
def test_energy_matches_jax(port_and_params, monkeypatch, jax_path):
    model, params = port_and_params
    mols = _molecules()
    if jax_path == "pallas_force":
        monkeypatch.setenv("E3_PALLAS", "force")
    jmodel = jbuild(jlc.addEnergyOutput(jlc.featureModel(**MODEL_KW), SHIFTS))
    jgb = _jax_batch(mols, tiled=jax_path == "pallas_force")
    ref = np.asarray(jmodel.apply(params, jgb)["total_energy"])[:, 0]
    got = _port_energy(model, _port_batch(mols))
    assert np.isfinite(got).all()
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel <= TOL, (rel, got, ref)


def test_rotation_invariance(port_and_params):
    model, _ = port_and_params
    gb = _port_batch(_molecules(seed=1))
    R = torch.tensor(rand_matrix(np.random.default_rng(2)),
                     dtype=torch.float32)
    e = _port_energy(model, gb)
    e_rot = _port_energy(model, gb.replace(pos=gb["pos"] @ R.T))
    assert np.abs(e - e_rot).max() <= 1e-5 * max(np.abs(e).max(), 1.0)


def test_padding_independence(port_and_params):
    """Moving padded nodes, or padding to other capacities, leaves the
    graph energies unchanged."""
    model, _ = port_and_params
    mols = _molecules(seed=3)
    gb = _port_batch(mols)
    e = _port_energy(model, gb)
    pos = gb["pos"].clone()
    n_real = int(gb["_node_mask"].sum())
    pos[n_real:] += 50.0
    np.testing.assert_array_equal(_port_energy(model, gb.replace(pos=pos)),
                                  e)
    e_big = _port_energy(model, _port_batch(mols, N=256, E=2048))
    np.testing.assert_allclose(e_big, e, rtol=1e-5, atol=1e-5)


def test_evaluate_keeps_real_graphs(port_and_params):
    """``inference.evaluate`` returns the real graphs of every batch, in
    order, with the forward's energies."""
    model, _ = port_and_params
    mols = _molecules(seed=4)
    batches = [GraphBatch.from_batch(
        Batch.from_data_list([Data(_attrs(), **m) for m in mols[:3]]),
        128, 1024, 5, "cpu")]
    batches.append(_port_batch(mols[3:]))
    res = evaluate(model, batches, ["total_energy"])
    assert len(res) == len(mols)
    want = np.concatenate([_port_energy(model, batches[0])[:3],
                           _port_energy(model, batches[1])])
    np.testing.assert_allclose(res["total_energy"][:, 0], want, rtol=1e-6)
