#!/usr/bin/env python3
"""List the parameters that one training step of each config leaves
without a gradient (DDP must be told to look for such parameters, or it
raises at the next step).

    python3 tools/torch_unused_params.py [--device cpu] [config ...]

Builds each config's full-width model from seed 0 (on the card unless
``--device cpu``), makes a small batch of ``chip_smoke.py``'s synthetic
molecules or proteins with N(0, 1) targets for the loss's keys, takes the
loss of the config's training step (the regression configs' ``Loss`` on
``loss_coeffs``; the diffusion configs' score-matching loss on a VP-SDE
over their ``diffusion_keys``, after the config's scaler) and its
``backward``, and prints one JSON line: for each config (and spec) the
parameters whose ``.grad`` is None and those whose gradient is all zeros.
Without arguments it runs all seven configs, ``config_diffusion`` in both
specs.
"""

import json
import os
import sys

import numpy as np

RUNS = [("config_energy", None), ("config_energy_force", None),
        ("config_dipole", None), ("config_hamiltonian", None),
        ("config_diffusion", ""), ("config_diffusion", "nll"),
        ("config_diffusion_CA", None), ("config_diffusion_backbone", None)]


def batch_for(name, cfg, dev):
    """A small padded batch for ``name`` on ``dev``, its targets N(0, 1)."""
    import torch

    import chip_smoke as cs
    from equivariant_nn_zoo_tpu_torch.data import Batch, GraphBatch

    rng = np.random.default_rng(0)
    if name in ("config_diffusion_CA", "config_diffusion_backbone"):
        gb = cs.protein_batch(cfg, cs.synthetic_proteins(
            1, rng, sizes=(60, 80)), 0, 129, 4096, 1)
        return cfg["data_config"]["scaler"](gb.to(dev))
    mols = {"config_energy": lambda: cs.synthetic_qm9(4, rng, labels=True),
            "config_energy_force": lambda: cs.synthetic_fragments(4, rng),
            "config_dipole": lambda: cs.synthetic_dipole_mols(4, rng),
            "config_hamiltonian": lambda: cs.synthetic_h2o(4, rng,
                                                           labels=True),
            "config_diffusion": lambda: cs.synthetic_diffusion_mols(4, rng),
            }[name]()
    host = Batch.from_data_list(mols)
    gb = GraphBatch.from_batch(host, int(host["_n_nodes"].sum()) + 1,
                               int(host["_n_edges"].sum()), len(mols), dev)
    gen = torch.Generator().manual_seed(1)
    for key in cfg.get("loss_coeffs") or {}:
        gb = gb.replace(**{key: torch.randn(
            tuple(gb[key].shape), generator=gen).to(dev)})
    return gb


def step_loss(name, cfg, model, gb, dev):
    from equivariant_nn_zoo_tpu_torch.run import Loss
    from equivariant_nn_zoo_tpu_torch.run.sde_utils import (
        VPSDE,
        Noise,
        get_sde_loss_fn,
    )

    if "diffusion_keys" in cfg:
        sde = VPSDE(cfg["diffusion_keys"])
        loss_fn = get_sde_loss_fn(sde, True, reduce_mean=True)
        return loss_fn(model, gb, Noise(dev, 0))[0]
    out = model(gb)
    return Loss(cfg["loss_coeffs"])(out.data, gb.data)[0]


def main():
    sys.path.insert(0, os.getcwd())
    import torch

    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config

    args = sys.argv[1:]
    dev = torch.device("cuda")
    if args[:2] == ["--device", "cpu"]:
        dev, args = torch.device("cpu"), args[2:]
    runs = [r for r in RUNS if not args or r[0] in args]
    report = {}
    for name, spec in runs:
        cfg = get_config(name, spec)
        model = build_model(cfg["model_config"], dev,
                            torch.Generator().manual_seed(0))
        gb = batch_for(name, cfg, dev)
        step_loss(name, cfg, model, gb, dev).backward()
        named = list(model.named_parameters())
        tag = name if spec is None else f"{name} {spec!r}"
        report[tag] = dict(
            parameters=len(named),
            no_grad=[n for n, p in named if p.grad is None],
            zero_grad=[n for n, p in named
                       if p.grad is not None and not p.grad.any()])
        print(f"{tag}: {len(named)} parameters, no gradient "
              f"{report[tag]['no_grad']}, zero gradient "
              f"{report[tag]['zero_grad']}", flush=True)
        del model, gb
    print(json.dumps(report))


if __name__ == "__main__":
    main()
