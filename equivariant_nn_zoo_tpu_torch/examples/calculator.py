"""MD force provider: a trained (or seeded) energy model as a calculator
with an ASE-style interface.

PyTorch counterpart of ``examples/calculator.py``.  One call of
``potential`` builds the radius graph of the padded system on the device
(``data.radius_graph_fixed``), runs the model's energy and takes the
forces as ``-autograd.grad(E, pos)``.  On a first-order model
(``config_energy``) that backward runs K2 with the sh cotangent and K3b in
every layer; a force model (``config_energy_force``) is unwrapped to its
energy network, whose ``grad_order=2`` layers run K4f and K4b.  The
parameters are frozen: only the positions are differentiated.  On a CUDA
device ``potential`` is compiled, as JAX jits its potential: a CUDA graph
per node capacity (``run.capture``; ``capture=False`` is eager).  Nothing
in it reads the host: it returns the graph's pair count beside the energy
and forces, and ``compute`` holds it to the edge capacity after the call
(``check_pairs``), so no pair is dropped unseen.

Usage (on the card; ``--device cpu`` runs the plain versions):

    python -m equivariant_nn_zoo_tpu_torch.examples.calculator \\
        [--config config_energy] [--model_path best.pt] [--device cuda]

prints the energy of a random 12-atom molecule and checks one force
component against a central finite difference.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..data.compute_edge import radius_graph_fixed
from ..run import capture as capture_mod

ATTRS = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
         "atom_types": ("node", "1x0e")}


def card_or_cpu(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda, but torch.cuda.is_available() is "
                           "false; pass device='cpu' to run on the CPU")
    return device


class E3Calculator:
    """ASE-style calculator backed by a model of this package.

    Example:
        calc = E3Calculator.from_config("config_energy")
        e, f = calc.compute(species_Z, positions)
    """

    implemented_properties = ["energy", "forces"]

    def __init__(self, model: torch.nn.Module, r_max: float,
                 edge_capacity: int = 4096, node_capacity: int = 256,
                 device="cuda", capture: Optional[bool] = None):
        """``capture``: ``potential`` as a CUDA graph per node capacity
        (``run.capture.enabled``: by default on a CUDA device); ``False``
        is eager."""
        self.device = card_or_cpu(device)
        self.model = model.to(self.device).eval()
        for p in self.model.parameters():
            p.requires_grad_(False)
        self.r_max = float(r_max)
        self.node_capacity = int(node_capacity)
        self.edge_capacity = int(edge_capacity)
        self._potential = self.energy_forces
        if capture_mod.enabled(capture, self.device, (self.model,)):
            self._potential = capture_mod.Step(
                "calculator", self.energy_forces)

    @classmethod
    def from_config(cls, config_name: str, model: torch.nn.Module = None,
                    model_path: Optional[str] = None, device="cuda",
                    kernels: bool = True, **kwargs) -> "E3Calculator":
        """The calculator of a named config: ``model``, or the config's
        model with the seeded initial weights (``models.build_model``, with
        ``kernels``: ``False`` runs every kernel's plain version on the
        card too) and, from ``model_path``, the weights of a checkpoint of
        this package (the train CLI's ``best.pt``, as the inference CLI
        loads it).  A force model is unwrapped to its energy network: the
        calculator differentiates itself.  ``kwargs`` go to the
        constructor (capacities, ``capture``)."""
        from ..inference import model_params
        from ..models import build_model, get_config
        from ..utils import load_file, load_jax_params

        device = card_or_cpu(device)
        cfg = get_config(config_name)
        if model is None:
            model = build_model(cfg["model_config"], device, kernels=kernels)
        if model_path:
            tree = model_params(load_file(model_path,
                                          enforced_format="pickle"))
            target = model
            if hasattr(model, "func") and "func" not in tree:
                target = model.func
            load_jax_params(target, tree)
        if hasattr(model, "func"):
            model = model.func
        return cls(model, r_max=float(cfg["model_config"]["r_max"]),
                   device=device, **kwargs)

    def padded(self, species, positions):
        """The padded single-graph tensors of ``n`` atoms on the device:
        ``(pos [N, 3], species [N, 1], node_mask [N, 1], node_segment
        [N])``, N the node capacity; the last slot is the dummy node."""
        n, N = len(species), self.node_capacity
        if n >= N:
            raise ValueError(f"{n} atoms need a node capacity above {n}, "
                             f"got {N}")
        pos = np.zeros((N, 3), np.float32)
        pos[:n] = positions
        spec = np.zeros((N, 1), np.int64)
        spec[:n, 0] = species
        node_mask = np.zeros((N, 1), np.float32)
        node_mask[:n] = 1.0
        node_segment = np.full((N,), 1, np.int64)
        node_segment[:n] = 0
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (pos, spec, node_mask, node_segment))

    def check_pairs(self, n_pairs) -> None:
        """Raise when ``n_pairs`` (a pair count from ``potential``, or the
        largest of several) exceeds the edge capacity: the radius graph
        kept only the first pairs (a host read)."""
        if int(n_pairs) > self.edge_capacity:
            raise RuntimeError(
                f"{int(n_pairs)} pairs within r_max {self.r_max} exceed the "
                f"edge capacity {self.edge_capacity}")

    def graph(self, pos, species, node_mask, node_segment) -> dict:
        """The model's input data of the padded system: the radius graph
        built on the device and the masks.  Raises when the graph has more
        pairs than the edge capacity: no pair is dropped."""
        data, n_pairs = self._graph(pos, species, node_mask, node_segment)
        self.check_pairs(n_pairs)
        return data

    def _graph(self, pos, species, node_mask, node_segment):
        """``graph``'s data and the pair count (a device int), unchecked."""
        edge_index, edge_mask, edge_segment, n_pairs = radius_graph_fixed(
            pos, node_segment, node_mask, self.edge_capacity, self.r_max,
            pos.shape[0] - 1)
        return {
            "pos": pos,
            "species": species,
            "atom_types": species,
            "edge_index": edge_index,
            "_edge_mask": edge_mask,
            "_edge_segment": edge_segment,
            "_node_mask": node_mask,
            "_node_segment": node_segment,
            "_graph_mask": torch.ones((1, 1), device=pos.device),
            "_n_nodes": node_mask.sum().to(torch.int64).reshape(1, 1),
        }, n_pairs

    def energy_forces(self, pos, species, node_mask, node_segment):
        """``(energy, forces [N, 3], n_pairs)`` of the padded system,
        eagerly: a 0-dim energy, the forces and the radius graph's pair
        count (a device int that the caller holds to the edge capacity,
        ``check_pairs``), all on the device."""
        data, n_pairs = self._graph(pos, species, node_mask, node_segment)
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            out, _ = self.model({**data, "pos": p}, dict(ATTRS))
            key = "total_energy" if "total_energy" in out else "energy"
            energy = out[key].sum()
            (grad,) = torch.autograd.grad(energy, p)
        return energy.detach(), -grad, n_pairs

    def potential(self, pos, species, node_mask, node_segment):
        """``energy_forces``, compiled where ``capture`` allows: a replay
        overwrites what the last call returned, so read it before the next
        call."""
        return self._potential(pos, species, node_mask, node_segment)

    def compute(self, species, positions):
        """species [n], positions [n, 3] -> (energy float, forces [n, 3]).
        Raises when the graph has more pairs than the edge capacity."""
        n = len(species)
        e, f, n_pairs = self.potential(*self.padded(species, positions))
        self.check_pairs(n_pairs)
        return float(e), f[:n].cpu().numpy()

    # ASE Calculator protocol ------------------------------------------------

    def calculate(self, atoms=None, properties=("energy",),
                  system_changes=()):
        e, f = self.compute(atoms.get_atomic_numbers(), atoms.get_positions())
        self.results = {"energy": e, "forces": f}


def finite_difference_check(calc: E3Calculator, seed: int = 0,
                            eps: float = 1e-2, log=print):
    """The example's molecule (12 atoms, Z from {1, 6, 7, 8}): its energy
    and forces, and force[0, 0] against a central difference of the
    energy.  Returns ``(energy, forces, finite difference)``."""
    rng = np.random.default_rng(seed)
    Z = rng.choice([1, 6, 7, 8], size=12)
    pos = rng.normal(size=(12, 3)) * 1.5
    e, f = calc.compute(Z, pos)
    energies = []
    for sign in (1, -1):
        moved = pos.copy()
        moved[0, 0] += sign * eps
        energies.append(calc.compute(Z, moved)[0])
    fd = -(energies[0] - energies[1]) / (2 * eps)
    if log:
        log(f"energy: {e}")
        log(f"forces shape: {f.shape} finite: {np.isfinite(f).all()}")
        log(f"force[0,0]={f[0, 0]:.4f} vs finite-diff {fd:.4f}")
    return e, f, fd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="config_energy")
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    calc = E3Calculator.from_config(args.config, model_path=args.model_path,
                                    device=args.device, node_capacity=64,
                                    edge_capacity=1024)
    finite_difference_check(calc)


if __name__ == "__main__":
    main()
