"""The port's ``CondensedDataset`` and ``DataLoader`` (CPU), mirroring
``tests/test_data.py`` and held to the JAX package's on the same files:

- loading a file, a directory, ``dir:regex`` and a list of paths;
  ``key_map``; file sharding; capacity estimates;
- the loader: iteration and its state, overflow deferral, the epoch carry,
  the thread-pool preprocess, ``drop_last``;
- the port's loader against the JAX package's on one HDF5 file and seed:
  every tensor of every batch equal over two epochs, with deferral and the
  carry (the JAX loader lays out padded batches off the TPU, as the port
  always does);
- the dataset's preprocess cache, ``index_select``, ``equivarianceTest``
  and ``statistics`` against the JAX dataset's.
"""

from functools import partial

import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu.data.compute_edge import (
    computeEdgeIndex as jcomputeEdgeIndex,
)
from equivariant_nn_zoo_tpu.data.dataloader import DataLoader as JDataLoader
from equivariant_nn_zoo_tpu.data.dataset import (
    CondensedDataset as JCondensedDataset,
)
from equivariant_nn_zoo_tpu_torch.data import (
    Batch,
    CondensedDataset,
    DataLoader,
    computeEdgeIndex,
    estimate_capacities,
    shard_paths,
)
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

RNG = np.random.default_rng(9)


def write_file(path, n_mols=8, tag=0.0, rng=RNG):
    items = []
    for _ in range(n_mols):
        n = int(rng.integers(3, 7))
        items.append({
            "pos": rng.normal(size=(n, 3)).astype(np.float32) + tag,
            "species": rng.integers(1, 5, size=(n, 1)),
            "y": np.asarray([[tag]], np.float32),
            "_n_nodes": n,
        })
    attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
             "y": ("graph", "1x0e"), "_n_nodes": ("graph", "1x0e")}
    Batch.from_data_list(items, attrs).dumpHDF5(str(path))


def test_load_single_file(tmp_path):
    write_file(tmp_path / "a.hdf5")
    ds = CondensedDataset(path=str(tmp_path / "a.hdf5"))
    assert len(ds) == 8
    assert ds.attrs["pos"] == ("node", "1x1o")


def test_load_directory_and_regex(tmp_path):
    write_file(tmp_path / "a.hdf5", tag=1.0)
    write_file(tmp_path / "b.hdf5", tag=2.0)
    write_file(tmp_path / "skip.other.hdf5", tag=3.0)
    ds = CondensedDataset(path=str(tmp_path))
    assert len(ds) == 24
    ds2 = CondensedDataset(path=f"{tmp_path}:.*[ab]\\.hdf5")
    assert len(ds2) == 16


def test_load_list_of_paths(tmp_path):
    write_file(tmp_path / "a.hdf5", tag=1.0)
    write_file(tmp_path / "b.hdf5", tag=2.0)
    ds = CondensedDataset(
        path=[str(tmp_path / "a.hdf5"), str(tmp_path / "b.hdf5")])
    assert len(ds) == 16


def test_key_map_one_to_many(tmp_path):
    write_file(tmp_path / "a.hdf5")
    ds = CondensedDataset(path=str(tmp_path / "a.hdf5"),
                          key_map={"species": ("Z", "atom_types")})
    assert "Z" in ds.data and "atom_types" in ds.data
    assert "species" not in ds.data


def test_shard_paths():
    paths = [f"f{i}" for i in range(8)]
    shards = [shard_paths(paths, r, 4) for r in range(4)]
    assert all(len(s) == 2 for s in shards)
    assert sorted(sum(shards, [])) == sorted(paths)
    assert shard_paths(paths, 1, 3) == paths
    assert shard_paths("single.hdf5", 0, 4) == "single.hdf5"


def test_estimate_capacities_covers_max(tmp_path):
    write_file(tmp_path / "a.hdf5")
    ds = CondensedDataset(path=str(tmp_path / "a.hdf5"))
    node_cap, edge_cap = estimate_capacities(ds, batch_size=4)
    assert node_cap > int(np.asarray(ds["_n_nodes"]).max())
    assert node_cap % 128 == 0


def test_loader_iterates_and_state(tmp_path):
    write_file(tmp_path / "a.hdf5", n_mols=12)
    ds = CondensedDataset(path=str(tmp_path / "a.hdf5"))
    dl = DataLoader(ds, batch_size=4, shuffle=True, seed=3, prefetch=0)
    batches = list(dl)
    assert len(batches) == 3
    assert all(b.n_graphs == 4 for b in batches)
    assert all(v.device.type == "cpu" for b in batches
               for v in b.data.values())
    state = dl.state_dict()
    dl2 = DataLoader(ds, batch_size=4, shuffle=True, seed=99, prefetch=0)
    dl2.load_state_dict(state)
    assert torch.equal(next(iter(dl))["pos"], next(iter(dl2))["pos"])


def _tight_loader(path, cls=DataLoader, dataset=CondensedDataset, **kw):
    ds = dataset(path=str(path))
    sizes = [int(n) for n in np.asarray(ds["_n_nodes"]).reshape(-1)]
    # capacity fits ~3 of 4 graphs per batch -> every batch defers some
    tight = int(np.ceil(np.mean(sizes) * 3)) + 1
    return cls(ds, batch_size=4, node_capacity=tight, edge_capacity=512,
               prefetch=0, **kw)


def test_loader_defers_overflow(tmp_path):
    write_file(tmp_path / "a.hdf5", n_mols=16)
    dl = _tight_loader(tmp_path / "a.hdf5", shuffle=False)
    seen = sum(float(b["_graph_mask"].sum()) for b in dl)
    assert dl.dropped_graphs == 0
    assert seen + len(dl._carry) == 16
    assert seen > 8


def test_loader_epoch_carry_never_drops(tmp_path):
    write_file(tmp_path / "a.hdf5", n_mols=16)
    dl = _tight_loader(tmp_path / "a.hdf5", shuffle=False)
    k = 3
    seen = sum(float(b["_graph_mask"].sum()) for _ in range(k) for b in dl)
    assert dl.dropped_graphs == 0
    assert seen + len(dl._carry) == k * 16
    assert len(dl._carry) < 16


def test_loader_workers_match_serial(tmp_path):
    write_file(tmp_path / "a.hdf5", n_mols=12)
    kw = dict(path=str(tmp_path / "a.hdf5"),
              preprocess=[partial(computeEdgeIndex, r_max=2.5)])
    serial = DataLoader(CondensedDataset(**kw), batch_size=4, shuffle=True,
                        seed=7, prefetch=0)
    par = DataLoader(CondensedDataset(**kw), batch_size=4, shuffle=True,
                     seed=7, prefetch=2, num_workers=2)
    a, b = list(serial), list(par)
    par.close()
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        for k in x.data:
            assert torch.equal(x[k], y[k]), k


def test_loader_drop_last_false(tmp_path):
    write_file(tmp_path / "a.hdf5", n_mols=10)
    ds = CondensedDataset(path=str(tmp_path / "a.hdf5"))
    batches = list(DataLoader(ds, batch_size=4, drop_last=False, prefetch=0))
    assert len(batches) == 3
    assert float(batches[-1]["_graph_mask"].sum()) == 2


def _assert_same_batch(port, jax_batch):
    assert set(port.data) == set(jax_batch.data)
    assert (port.n_graphs, port.node_capacity, port.edge_capacity) == (
        jax_batch.n_graphs, jax_batch.node_capacity, jax_batch.edge_capacity)
    assert port.dropped == jax_batch.dropped
    for key, value in jax_batch.data.items():
        want = np.asarray(value)
        got = port[key].numpy()
        assert got.shape == want.shape, key
        assert got.dtype.kind == want.dtype.kind, key
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_matches_jax_over_two_epochs(tmp_path, workers):
    """One HDF5 file, one seed, radius-graph preprocess, capacities that
    overflow: the port's loader yields the JAX loader's batches, tensor for
    tensor, over two shuffled epochs (deferred graphs and the carry into
    the second epoch included)."""
    write_file(tmp_path / "a.hdf5", n_mols=22, rng=np.random.default_rng(4))
    kw = dict(batch_size=4, shuffle=True, seed=5, node_capacity=14,
              edge_capacity=64, prefetch=2, num_workers=workers)
    port = DataLoader(CondensedDataset(
        path=str(tmp_path / "a.hdf5"),
        preprocess=[partial(computeEdgeIndex, r_max=2.0)]), **kw)
    jax_dl = JDataLoader(JCondensedDataset(
        path=str(tmp_path / "a.hdf5"),
        preprocess=[partial(jcomputeEdgeIndex, r_max=2.0)]), **kw)
    assert jax_dl.edge_tile is None
    deferred = 0
    for _ in range(2):
        got, want = list(port), list(jax_dl)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            _assert_same_batch(a, b)
            deferred += 4 - int(a["_graph_mask"].sum())
        assert len(port._carry) == len(jax_dl._carry)
        assert port.dropped_graphs == jax_dl.dropped_graphs
    assert deferred > 0
    assert port.state_dict()["rng"] == jax_dl.state_dict()["rng"]
    port.close()
    jax_dl.close()


def _double_positions(data):
    """A preprocess of arity 1 (takes the ``Data``)."""
    data["pos"] = data["pos"] * 2
    return data


def test_preprocess_cache_and_index_select(tmp_path):
    write_file(tmp_path / "a.hdf5", n_mols=6)
    raw = CondensedDataset(path=str(tmp_path / "a.hdf5"))[2]
    ds = CondensedDataset(path=str(tmp_path / "a.hdf5"),
                          preprocess=[_double_positions,
                                      partial(computeEdgeIndex, r_max=5.0)],
                          cache_preprocessed=True)
    first = ds[2]
    assert ds[2] is first and "edge_index" in first.data
    np.testing.assert_array_equal(first["pos"], 2 * raw["pos"])
    sub = ds.index_select([4, 2])
    assert len(sub) == 2 and sub.cache_preprocessed
    np.testing.assert_array_equal(sub[1]["pos"], first["pos"])
    np.testing.assert_array_equal(sub[1]["edge_index"], first["edge_index"])


def test_equivariance_dataset_matches_jax(tmp_path):
    write_file(tmp_path / "a.hdf5", n_mols=4)
    port = CondensedDataset(path=str(tmp_path / "a.hdf5"))
    jax_ds = JCondensedDataset(path=str(tmp_path / "a.hdf5"))
    port.equivarianceTest(4, idx=1)
    jax_ds.equivarianceTest(4, idx=1)
    assert len(port) == 4
    for key, value in jax_ds.data.items():
        np.testing.assert_allclose(port.data[key], value, rtol=0, atol=1e-6,
                                   err_msg=key)
    d0 = np.linalg.norm(port.get(0)["pos"][:, None] - port.get(0)["pos"],
                        axis=-1)
    d1 = np.linalg.norm(port.get(1)["pos"][:, None] - port.get(1)["pos"],
                        axis=-1)
    np.testing.assert_allclose(d0, d1, atol=1e-4)


def test_statistics_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    items = []
    for _ in range(40):
        n = int(rng.integers(3, 9))
        z = rng.choice([1, 6, 7, 8], size=(n, 1))
        items.append({"pos": rng.normal(size=(n, 3)).astype(np.float32),
                      "species": z, "_n_nodes": n,
                      "q": rng.normal(size=(n, 1)).astype(np.float32),
                      "e": np.asarray([[float(z.sum()) + rng.normal()]],
                                      np.float32)})
    attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
             "q": ("node", "1x0e"), "e": ("graph", "1x0e"),
             "_n_nodes": ("graph", "1x0e")}
    Batch.from_data_list(items, attrs).dumpHDF5(str(tmp_path / "s.hdf5"))
    fields = ["species-count", "pos-rms", "e-mean_std", "e-per-node-mean_std",
              "e-per-node-rms", "e-per-species-mean_std",
              "q-per-species-mean_std", "q-per-species-rms"]
    names = [str(i) for i in range(10)]
    got = CondensedDataset(path=str(tmp_path / "s.hdf5"),
                           type_names=names).statistics(fields)
    want = JCondensedDataset(path=str(tmp_path / "s.hdf5"),
                             type_names=names).statistics(fields)
    for field, a, b in zip(fields, got, want):
        assert len(a) == len(b), field
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6,
                                       err_msg=field)
    shifts = np.asarray(got[5][0]).reshape(-1)
    np.testing.assert_allclose(shifts[[1, 6, 7, 8]], [1, 6, 7, 8], atol=0.5)


def test_data_iters_match_jax(tmp_path):
    """``getDataIters``: the split, capacities and per-process seed of the
    JAX function, and iterators that restart at each epoch's end."""
    from types import SimpleNamespace

    from equivariant_nn_zoo_tpu.data.dataloader import (
        getDataIters as jgetDataIters,
    )
    from equivariant_nn_zoo_tpu_torch.data import getDataIters

    write_file(tmp_path / "a.hdf5", n_mols=14, rng=np.random.default_rng(6))
    data_config = {"path": [str(tmp_path / "a.hdf5")], "n_train": 8,
                   "n_val": 4, "train_val_split": "random",
                   "preprocess": [partial(computeEdgeIndex, r_max=2.0)]}
    train, val = getDataIters({"data_config": data_config, "batch_size": 4},
                              seed=3)
    jtrain, jval = jgetDataIters(SimpleNamespace(
        data_config=dict(data_config,
                         preprocess=[partial(jcomputeEdgeIndex, r_max=2.0)]),
        batch_size=4), seed=3)
    for _ in range(5):                     # past the two-batch epoch's end
        _assert_same_batch(next(train), next(jtrain))
    _assert_same_batch(next(val), next(jval))
