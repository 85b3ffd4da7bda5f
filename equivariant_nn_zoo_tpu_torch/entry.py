"""The port's entry points: counterparts of ``__graft_entry__.py``.

- ``entry(device="cuda") -> (fn, example_args)``: the forward of the
  flagship model (``config_energy`` at full width, seeded weights) on a
  small padded batch, ``fn(*example_args)`` its graphs' total energies.
- ``dryrun_multichip(n, device="cuda")``: one full-width ``config_energy``
  training step, data parallel over ``n`` ranks (``parallel``: one process
  per rank, the gradients averaged over the ranks; gloo on the CPU and
  when ranks share a card, NCCL with one rank per card), held to one process's step on the mean of the shard
  losses, as the JAX dryrun holds its mesh step to a single-device step.

Usage: ``python -m equivariant_nn_zoo_tpu_torch.entry [--device cuda]
[--ranks 2]`` runs both.
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from . import parallel
from .examples.calculator import card_or_cpu

ENERGY_LOSS = {"total_energy": [1.0, "MSELoss"]}
LR = 1e-3


def tiny_batch(rng, n_graphs=4, node_cap=64, edge_cap=256, r_max=4.0,
               device="cuda"):
    """``n_graphs`` random molecules of 4 to 7 atoms (Z from {1, 6, 7, 8}),
    with N(0, 1) energies, padded to the capacities: the JAX dryrun's
    ``_tiny_batch``, draw for draw."""
    from .data import Batch, Data, GraphBatch, computeEdgeIndex

    mols = []
    for _ in range(n_graphs):
        n = int(rng.integers(4, 8))
        d = {
            "pos": rng.normal(size=(n, 3)) * 1.2,
            "species": rng.choice([1, 6, 7, 8], size=(n, 1)),
            "total_energy": rng.normal(size=(1, 1)),
        }
        d["atom_types"] = d["species"]
        attrs = {
            "pos": ("node", "1x1o"),
            "species": ("node", "1x0e"),
            "atom_types": ("node", "1x0e"),
            "total_energy": ("graph", "1x0e"),
        }
        out, attrs = computeEdgeIndex(d, attrs, r_max=r_max)
        d.update(out)
        mols.append(Data(attrs, **d))
    host = Batch.from_data_list(mols)
    return GraphBatch.from_batch(host, node_cap, edge_cap, n_graphs, device)


def entry(device="cuda"):
    """``(fn, (model, batch))``: the full-width ``config_energy`` model with
    the seeded initial weights and 8 graphs padded to 192 nodes and 1024
    edges; ``fn(model, batch)`` is their total energies [8, 1]."""
    from .models import build_model, get_config

    device = card_or_cpu(device)
    cfg = get_config("config_energy")
    model = build_model(cfg["model_config"], device).eval()
    rng = np.random.default_rng(0)
    batch = tiny_batch(rng, n_graphs=8, node_cap=192, edge_cap=1024,
                       r_max=cfg["model_config"]["r_max"], device=device)

    def fn(model, batch):
        return model(batch)["total_energy"]

    return fn, (model, batch)


def _dryrun_rank(rank, n, port, device, result):
    """One rank of ``dryrun_multichip``; rank 0 also takes the reference
    step and puts the loss into ``result``."""
    from .models import build_model, get_config
    from .run import Loss
    from .run.sde_utils import adam

    if device == "cpu":
        torch.set_num_threads(1)
    dev = parallel.init_distributed(n, rank, master_port=port, device=device,
                                    is_master=False)
    try:
        cfg = get_config("config_energy")
        model = build_model(cfg["model_config"], dev)
        reference = copy.deepcopy(model)
        r_max = cfg["model_config"]["r_max"]
        rng = np.random.default_rng(0)
        shards = [tiny_batch(rng, r_max=r_max, device=dev) for _ in range(n)]
        loss_fn = Loss(ENERGY_LOSS)

        def shard_loss(m, gb):
            return loss_fn(m(gb).data, gb.data)[0]

        grads = parallel.GradReducer(model.parameters())
        optimizer = adam(model, LR)
        loss = shard_loss(model, shards[rank])
        loss.backward()
        grads.reduce()
        optimizer.step()
        loss = float(parallel.all_reduce_mean({"loss": loss.detach()})[
            "loss"])
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss}")
        if rank != 0:
            return
        # one process's step on the mean of the shard losses
        ref_loss = torch.stack([shard_loss(reference, gb)
                                for gb in shards]).mean()
        ref_loss.backward()
        adam(reference, LR).step()
        np.testing.assert_allclose(loss, float(ref_loss.detach()), rtol=1e-5,
                                   atol=1e-6)
        for (name, a), b in zip(model.named_parameters(),
                                reference.parameters()):
            np.testing.assert_allclose(
                a.detach().cpu().numpy(), b.detach().cpu().numpy(),
                rtol=1e-4, atol=1e-5, err_msg=name)
        result.put(loss)
    finally:
        parallel.shutdown()


def dryrun_multichip(n_devices: int, device="cuda") -> float:
    """One full-width ``config_energy`` data-parallel step over
    ``n_devices`` ranks (spawned processes; on the card the ranks share the
    cards as ``parallel.init_distributed`` maps them), each on its own tiny
    batch,
    then the parity check against one process's step on the mean of the
    shard losses (loss rtol 1e-5; parameters rtol 1e-4, atol 1e-5).
    Returns the mean loss."""
    device = card_or_cpu(device)
    store = parallel.host_store()   # the ranks' rendezvous, until they end
    result = torch.multiprocessing.get_context("spawn").SimpleQueue()
    torch.multiprocessing.spawn(
        _dryrun_rank, nprocs=n_devices, join=True,
        args=(n_devices, store.port, device.type, result))
    loss = result.get()
    print(f"dryrun_multichip({n_devices}): OK, loss={loss:.4f}, parity OK "
          "(flagship config_energy DP step == single-process step)")
    return loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, args.device)
    fn, example_args = entry(args.device)
    with torch.no_grad():
        out = fn(*example_args)
    print("entry forward OK:", tuple(out.shape))


if __name__ == "__main__":
    main()
