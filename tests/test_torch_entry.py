"""Parity of the port's entry points
(``equivariant_nn_zoo_tpu_torch/entry.py``) with ``__graft_entry__.py``, on
the CPU:

- ``entry()``: the full-width ``config_energy`` forward on the same padded
  batch (the same draws), on JAX's parameters: total energies at rel 1e-5;
- ``dryrun_multichip(2)`` over two gloo ranks: the DDP step equals one
  process's step on the mean of the shard losses (its own assert), and
  its shards are the JAX dryrun's molecules.
"""

import os
import sys

import jax
import numpy as np
import torch

from equivariant_nn_zoo_tpu_torch import entry as tentry
from equivariant_nn_zoo_tpu_torch.utils import load_jax_params
from test_torch_edge_order import torch_threads_per_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import __graft_entry__ as jentry  # noqa: E402

torch_threads_per_worker()


def test_entry_matches_jax():
    jfn, (params, jbatch) = jentry.entry()
    fn, (model, batch) = tentry.entry("cpu")
    assert (batch.node_capacity, batch.edge_capacity, batch.n_graphs) == (
        192, 1024, 8)
    for key in ("pos", "species", "edge_index", "_node_mask"):
        np.testing.assert_array_equal(batch[key].numpy(),
                                      np.asarray(jbatch[key]), err_msg=key)
    load_jax_params(model, params)
    with torch.no_grad():
        got = fn(model, batch).numpy()
    want = np.asarray(jax.jit(jfn)(params, jbatch))
    assert got.shape == want.shape == (8, 1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_tiny_batch_matches_jax():
    """The dryrun's shards: the JAX dryrun's molecules, draw for draw."""
    want = jentry._tiny_batch(np.random.default_rng(0))
    got = tentry.tiny_batch(np.random.default_rng(0), device="cpu")
    for key in ("pos", "species", "total_energy", "edge_index",
                "_edge_mask", "_node_segment"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-7, err_msg=key)


def test_dryrun_multichip_two_ranks():
    loss = tentry.dryrun_multichip(2, device="cpu")
    assert np.isfinite(loss)
