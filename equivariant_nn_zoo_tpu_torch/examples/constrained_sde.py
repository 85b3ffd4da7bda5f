"""Constrained diffusion by a relax loop: reverse-diffusion steps of the
VP-SDE alternate with projection steps that relax the sample toward a
constraint manifold (here a fixed distance between atoms 0 and 1).

PyTorch counterpart of ``examples/constrained_sde.py``: ``config_diffusion``
with the seeded initial weights, ``VPSDE(N=100)``, its ``reverse`` on the
model's score, and one projection after each Euler-Maruyama step.  Every
draw comes from one explicit noise source (``run.sde_utils.Noise``: the
prior, then one normal per step), never from a hidden generator, so a test
can replay another package's draws.  On a CUDA device one step (the time,
the reverse step, the projection) is compiled, as JAX jits its step: a
CUDA graph replayed for each step with the step's time copied in and the
noise source's generator registered with it (``run.capture``;
``capture=False`` is eager, and so is a source whose draws a replay cannot
renew).

Usage (on the card; ``--device cpu`` runs the plain versions):

    python -m equivariant_nn_zoo_tpu_torch.examples.constrained_sde \\
        [--device cuda] [--seed 2]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data import Batch, Data, GraphBatch, computeEdgeIndex
from ..run import capture as capture_mod
from ..run.sde_utils import VPSDE, Noise, get_score_fn, with_t
from .calculator import card_or_cpu

TARGET_DIST = 1.1      # constrain atoms 0-1 to this distance
RELAX_STRENGTH = 0.3


def system(device="cuda", seed: int = 0, n: int = 8) -> GraphBatch:
    """The example's molecule: ``n`` atoms, fully connected, random species
    and bond types, one graph padded to 16 nodes and 128 edges, at t = 1."""
    rng = np.random.default_rng(seed)
    d = {
        "pos": rng.normal(size=(n, 3)),
        "species": rng.integers(1, 9, size=(n, 1)),
        "total_energy": np.zeros((1, 1)),
    }
    attrs = {
        "pos": ("node", "1x1o"), "species": ("node", "1x0e"),
        "total_energy": ("graph", "1x0e"),
    }
    out, attrs = computeEdgeIndex(d, attrs, r_max=9999)
    d.update(out)
    d["bond_type"] = rng.integers(0, 4, size=(d["edge_index"].shape[1], 1))
    attrs["bond_type"] = ("edge", "1x0e")
    gb = GraphBatch.from_batch(Batch.from_data_list([Data(attrs, **d)]), 16,
                               128, 1, device)
    return with_t(gb, torch.ones((1, 1), device=gb["pos"].device))


def project(pos: torch.Tensor, target: float = TARGET_DIST,
            strength: float = RELAX_STRENGTH) -> torch.Tensor:
    """One relax step toward |pos_0 - pos_1| = target."""
    v = pos[1] - pos[0]
    dist = torch.linalg.norm(v) + 1e-9
    corr = (dist - target) * v / dist / 2
    pos = pos.clone()
    pos[0] = pos[0] + strength * corr
    pos[1] = pos[1] - strength * corr
    return pos


def sample(model: torch.nn.Module, sde: VPSDE, gb: GraphBatch, noise,
           steps: int = None, target: float = TARGET_DIST,
           strength: float = RELAX_STRENGTH, capture=None) -> GraphBatch:
    """Reverse-diffuse from the prior over the schedule ``linspace(T, 1e-3,
    N)`` (its first ``steps`` steps, all without), projecting after each
    step; ``noise`` hands out the prior, then one normal per step.
    Returns the batch with the sample's positions.  ``capture``: one step
    as a CUDA graph (``run.capture.enabled``); ``False`` is eager."""
    batch = sde.prior_sampling(gb, noise)
    batch = GraphBatch({k: v for k, v in batch.data.items()
                        if k not in ("edge_vector", "edge_length", "t")},
                       dict(batch.attrs), batch.n_graphs,
                       batch.node_capacity, batch.edge_capacity)
    rsde = sde.reverse(get_score_fn(sde, model))
    dev = batch["pos"].device
    times = torch.as_tensor(np.linspace(sde.T, 1e-3, sde.N)[:steps].astype(
        np.float32), device=dev)
    ones = torch.ones((batch["_graph_mask"].shape[0], 1), device=dev)

    def step(b, t):
        new = rsde.sde(with_t(b, ones * t), noise)
        b["pos"].copy_(project(new["pos"], target, strength))
        return b

    if capture_mod.enabled(capture, dev, (noise, model)):
        step = capture_mod.Step(
            "constrained_sde", step,
            generators=lambda: capture_mod.generators(noise, model))
    with torch.no_grad():
        for k in range(len(times)):
            batch = step(batch, times[k: k + 1])
    return batch


def main(argv=None):
    """Sample the example's molecule at full width; print and return the
    final constrained distance and whether the real atoms are finite."""
    from ..models import build_model, get_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args(argv)
    device = card_or_cpu(args.device)
    cfg = get_config("config_diffusion")
    model = build_model(cfg["model_config"], device).eval()
    sde = VPSDE(dict(cfg["diffusion_keys"]), N=100)
    n = 8
    batch = sample(model, sde, system(device, n=n), Noise(device, args.seed))
    pos = batch["pos"].cpu().numpy()
    final = float(np.linalg.norm(pos[0] - pos[1]))
    finite = bool(np.isfinite(pos[:n]).all())
    print(f"constrained distance after sampling: {final:.3f} "
          f"(target {TARGET_DIST})")
    print("finite:", finite)
    return final, finite


if __name__ == "__main__":
    main()
