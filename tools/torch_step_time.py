#!/usr/bin/env python3
"""Time training steps of the PyTorch/CUDA port on the card, alone.

    python3 tools/torch_step_time.py [config_energy_force] [rounds]

Builds the full-width model of the config from seed 0, makes 4 training
batches of the config's batch size from ``chip_smoke.py``'s synthetic
molecules, takes one warm-up pass and then ``rounds`` (default 5) timed
passes through ``run.Trainer.batch_step``, and prints the ms per step of
each pass (host clock around ``torch.cuda.synchronize()``) with the card's
name and power limit.  It imports the port and ``chip_smoke.py`` from the
current directory, so two checkouts are compared by running it from each in
turn inside one call on one card (a step that is bound by the host varies
by tens of percent between calls).
"""

import os
import subprocess
import sys
import time

import numpy as np

DATA = {"config_energy_force": ("synthetic_fragments", {}),
        "config_energy": ("synthetic_qm9", {"labels": True}),
        "config_hamiltonian": ("synthetic_h2o", {"labels": True})}


def main():
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.run import Trainer

    name = sys.argv[1] if len(sys.argv) > 1 else "config_energy_force"
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    if not torch.cuda.is_available():
        sys.exit("torch_step_time: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(name)
    size = cfg["batch_size"]
    maker, kwargs = DATA[name]
    mols = getattr(chip_smoke, maker)(4 * size, np.random.default_rng(11),
                                      **kwargs)
    train = chip_smoke.make_batches(mols, dev, size)
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    trainer = Trainer(build_model(cfg["model_config"], dev,
                                  torch.Generator().manual_seed(0)),
                      **settings)
    for gb in train:
        trainer.batch_step(gb)
    ms = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for gb in train:
            trainer.batch_step(gb)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / len(train))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"{name} step in {os.getcwd()}: "
          + " ".join(f"{t:.3f}" for t in ms)
          + f" ms per {size}-graph batch, median {np.median(ms):.3f} "
          f"({smi.stdout.strip()})")


if __name__ == "__main__":
    main()
