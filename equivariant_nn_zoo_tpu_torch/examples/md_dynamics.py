"""Velocity-Verlet NVE dynamics with an energy model as the force provider
(``examples/calculator.py``'s ``E3Calculator``).

PyTorch counterpart of ``examples/md_dynamics.py``, with the same units,
masses, Maxwell-Boltzmann draw (numpy, from ``seed``: both packages start
from the same velocities) and kick-drift-kick step with one force
evaluation per step (the radius graph, the model's energy and its position
gradient on the card).  The JAX script jits a block of steps under
``lax.fori_loop``; here a block of ``steps_per_block`` steps is one
compiled step on a CUDA device (``run.capture``: a CUDA graph replayed
once a block; ``capture=False`` is eager).  Positions, velocities, forces,
the energy and the largest pair count of the block live in buffers on the
device that each block updates in place; the host reads the energies and
holds the pair count to the edge capacity once a block.

Usage (on the card; ``--device cpu`` runs the plain versions):

    python -m equivariant_nn_zoo_tpu_torch.examples.md_dynamics \\
        [--config config_energy] [--model_path best.pt] [--steps 300] \\
        [--dt_fs 0.2] [--T 300] [--device cuda]

NVE conservation: with a smooth potential and a small dt the drift of the
total energy over the run is a small fraction of the kinetic-energy scale;
the script prints the drift ratio and exits 1 if it exceeds 20 %.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..run import capture as capture_mod
from .calculator import E3Calculator

# eV/(amu.Angstrom) -> Angstrom/fs^2 (ASE units convention)
EV_AMU_A = 0.009648533
# Boltzmann constant in eV/K
KB_EV = 8.617333262e-5

MASSES = {1: 1.008, 6: 12.011, 7: 14.007, 8: 15.999}


def maxwell_boltzmann(rng, masses, T):
    """Velocities [n, 3] in Angstrom/fs at temperature T (Kelvin)."""
    # sigma_v = sqrt(kB T / m); kB T in eV, m in amu -> v in A/fs via the
    # same unit factor as the acceleration
    sigma = np.sqrt(KB_EV * T * EV_AMU_A / masses)[:, None]
    v = rng.normal(size=(len(masses), 3)) * sigma
    return v - v.mean(axis=0, keepdims=True)  # zero net momentum


def run_md(calc: E3Calculator, species, pos0, dt_fs=0.2, n_steps=300,
           T=300.0, seed=0, steps_per_block=10, log=print, capture=None):
    """Velocity-Verlet NVE; returns (positions [n, 3], the (potential,
    kinetic) energies [n_blocks + 1, 2] at the start and after each block
    of ``steps_per_block`` steps).  Raises after a block whose radius graph
    had more pairs than the calculator's edge capacity.  ``capture``: each
    block as a CUDA graph (``run.capture.enabled``: by default on a CUDA
    device); ``False`` is eager."""
    rng = np.random.default_rng(seed)
    masses = np.array([MASSES[int(z)] for z in species])
    n = len(species)
    pos, spec, node_mask, node_segment = calc.padded(species, pos0)
    N, dev = calc.node_capacity, calc.device

    def pad(x, fill=0.0):
        out = np.full((N,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(dev)

    vel = pad(maxwell_boltzmann(rng, masses, T))
    m = pad(masses[:, None], fill=1.0)                 # [N, 1]
    dt = torch.tensor(dt_fs, dtype=torch.float32, device=dev)

    def force(p):
        e, f, n_pairs = calc.energy_forces(p, spec, node_mask, node_segment)
        return e, f * node_mask, n_pairs

    def kinetic(v):
        return float(0.5 * torch.sum(m * v * v) / EV_AMU_A)

    def block(pos, vel, f, e, most):
        """``steps_per_block`` steps, the state updated in place."""
        for _ in range(steps_per_block):
            # kick-drift-kick with a single force evaluation per step
            v_half = vel + 0.5 * dt * (f / m) * EV_AMU_A
            new_pos = pos + dt * v_half * node_mask
            e_new, f_new, n_pairs = force(new_pos)
            vel.copy_((v_half + 0.5 * dt * (f_new / m) * EV_AMU_A)
                      * node_mask)
            pos.copy_(new_pos)
            f.copy_(f_new)
            e.copy_(e_new)
            torch.maximum(most, n_pairs, out=most)
        return pos, vel, f, e, most

    e, f, most = force(pos)
    e, most = e.clone(), most.clone()
    calc.check_pairs(most)
    if capture_mod.enabled(capture, dev, (calc.model,)):
        block = capture_mod.Step("md_block", block)
    e_traj = [(float(e), kinetic(vel))]
    n_blocks = max(1, n_steps // steps_per_block)
    for b in range(n_blocks):
        pos, vel, f, e, most = block(pos, vel, f, e, most)
        calc.check_pairs(most)
        e_traj.append((float(e), kinetic(vel)))
        if log and (b % max(1, n_blocks // 10) == 0):
            log(f"block {b:4d}: E_pot={e_traj[-1][0]:+.4f} eV  "
                f"KE={e_traj[-1][1]:.4f} eV  "
                f"E_tot={sum(e_traj[-1]):+.4f} eV")
    return pos[:n].cpu().numpy(), np.asarray(e_traj)


def drift_ratio(e_traj) -> float:
    """|E_tot(end) - E_tot(start)| over the mean kinetic energy."""
    e_tot = e_traj.sum(axis=1)
    ke_scale = max(float(np.abs(e_traj[:, 1]).mean()), 1e-6)
    return abs(e_tot[-1] - e_tot[0]) / ke_scale


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="config_energy")
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dt_fs", type=float, default=0.2)
    ap.add_argument("--T", type=float, default=300.0)
    ap.add_argument("--n_atoms", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    calc = E3Calculator.from_config(
        args.config, model_path=args.model_path, device=args.device,
        node_capacity=64, edge_capacity=1024,
    )
    rng = np.random.default_rng(0)
    Z = rng.choice([1, 6, 8], size=args.n_atoms, p=[0.5, 0.3, 0.2])
    # loose random cluster, pre-relaxed spacing so forces start moderate
    pos = rng.normal(size=(args.n_atoms, 3)) * 2.0

    _, e_traj = run_md(calc, Z, pos, dt_fs=args.dt_fs, n_steps=args.steps,
                       T=args.T)
    ratio = drift_ratio(e_traj)
    e_tot = e_traj.sum(axis=1)
    print(f"total-energy drift over {args.steps} steps: "
          f"{abs(e_tot[-1] - e_tot[0]):.5f} eV ({ratio:.1%} of mean KE)")
    ok = ratio < 0.2
    print("NVE conservation:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
