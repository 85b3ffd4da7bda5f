#!/usr/bin/env python3
"""The train CLI as one rank per card: ``chip_smoke.py``'s phase 29 with as
many ranks as the machine has cards.

    python3 tools/torch_cli_ranks.py [ranks]

Builds the kernels, then starts ``ranks`` processes (by default one per
card) of ``chip_smoke.py``'s rank runner: each runs
``equivariant_nn_zoo_tpu_torch.train.run`` with ``--world_size`` on
full-width ``config_energy`` over its own in-memory synthetic molecules (4
training and 1 validation batches of 128, 2 epochs), so each rank drives
``cuda:<rank>`` and the gradients go over NCCL when every rank has a card
of its own.  It fails unless every rank exits 0 with the same parameters
and EMA, the group took NCCL where it should, only rank 0 wrote
checkpoints, and every rank launched K1, K2, K3 and K3b at least
``num_layers x steps`` times; it prints each rank's ms per step of its
second epoch, with the cards' names and power limits.  Run it from the
repository's root.
"""

import json
import os
import subprocess
import sys
import time


def main():
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from equivariant_nn_zoo_tpu_torch.models import get_config
    from equivariant_nn_zoo_tpu_torch.ops.cuda.build import build

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    cards = torch.cuda.device_count()
    ranks = int(sys.argv[1]) if len(sys.argv) > 1 else cards
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    t0 = time.perf_counter()
    lib, _ = build()
    print(f"build: {os.path.relpath(lib)} in {time.perf_counter() - t0:.1f} s")
    n_layers = get_config("config_energy")["model_config"]["num_layers"]
    t0 = time.perf_counter()
    res = cs.run_cli_ranks("train", ranks)
    print(f"{ranks} ranks on {cards} cards in "
          f"{time.perf_counter() - t0:.1f} s (start-up included)")
    for r, rec in enumerate(res):
        print(f"rank {r}: backend {rec['backend']}, {rec['iepoch']} epochs, "
              f"{rec['steps']} steps, launches {rec['launches']}, "
              f"{rec['ms_per_step']:.3f} ms per {cs.CLI_BATCH}-graph step "
              f"in epoch 2, files {rec['files']}")
        for name in ("full_conv", "full_conv_bwd", "species_sc",
                     "species_sc_bwd"):
            if rec["launches"].get(name, 0) < n_layers * rec["steps"]:
                cs.fail(f"rank {r}: {name} launched "
                        f"{rec['launches'].get(name, 0)} times")
    want = "nccl" if ranks <= cards else "gloo"
    if any(rec["backend"] != want for rec in res):
        cs.fail(f"the group took {[rec['backend'] for rec in res]}, not "
                f"{want}")
    if len({(rec["digest"], rec["ema_digest"]) for rec in res}) != 1:
        cs.fail("the ranks' parameters differ")
    if not {"best.pt", "trainer.pt"} <= set(res[0]["files"]) or any(
            {"best.pt", "trainer.pt"} & set(rec["files"]) for rec in res[1:]):
        cs.fail("checkpoints written by a rank other than 0, or not by 0")
    for root, _, names in os.walk(cs.CLI_DIR):   # ~120 MB of checkpoints
        for name in names:
            if name.endswith(".pt"):
                os.remove(os.path.join(root, name))
    print(json.dumps({"ranks": ranks, "cards": cards, "backend": want,
                      "ms_per_step": [rec["ms_per_step"] for rec in res]}))


if __name__ == "__main__":
    main()
