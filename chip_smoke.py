#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. device  — requires CUDA; prints the card's name and power limit;
2. build   — compiles the kernels from ``csrc/`` and prints ``ptxas`` lines;
3. K1      — the whole-convolution kernel against its plain PyTorch version
             on the card, at ``config_energy``'s hot-layer shapes (layer3 of
             a 128-graph synthetic QM9-like batch);
4. K3      — the species self-connection kernel, likewise;
5. K2      — the convolution's backward kernel against the plain backward
             (autograd of the plain forward) on K1's saved scratch and a
             seeded cotangent: dx, d edge_radial, dW (MLP) and dwsel;
6. K3b     — the self-connection's backward kernel (dx, dtables), likewise;
7. slice   — full-width ``config_energy`` (random weights from a seeded
             generator) serves 4 batches of 128 graphs through
             ``inference.evaluate``; the K1/K3 launch counters must rise
             by at least one per layer and batch, energies must be finite,
             and a 32-graph cut of the first batch must match the CPU plain
             path;
8. train   — a ``run.Trainer`` with ``config_energy``'s own training
             settings (Adam lr 1e-2, EMA 0.99 with num_updates, loss
             1e3 * MSE, ReduceLROnPlateau 0.8 / 1) runs 2 epochs over 4
             training batches and 1 validation batch of 128 graphs labelled
             ``sum of per-species shifts + N(0, 1)``; losses must be finite
             and each of K1, K2, K3 and K3b must launch at least
             ``num_layers x steps`` times; then ms per step and graphs/s;
9. train parity — one step's gradient of every parameter on a 32-graph
             cut, card against the CPU plain path, from the same seeded
             weights (labels N(0, 1), so the float32 residual is
             well-conditioned).

TF32 is off, so the plain versions compute in float32; the kernels sum with
atomics in a varying order, hence rel-linf 1e-4 of max|plain| (per tensor).
The second-to-last line is the kernels' JSON, the last the device JSON.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

TOL = 1e-4
N_BATCHES, BATCH = 4, 128
HOT_LAYER = "layer3"


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def synthetic_qm9(n_mol, rng, labels=False):
    """QM9-like molecules: 8-23 atoms of H/C/N/O, ~1.4 A blobs, r_max 4;
    with ``labels``, a ``total_energy`` of the per-species shifts plus
    N(0, 1)."""
    from equivariant_nn_zoo_tpu_torch.data import Data, computeEdgeIndex
    from equivariant_nn_zoo_tpu_torch.models.config_energy import SHIFTS

    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(8, 24))
        d = {"pos": rng.normal(size=(n, 3)) * 1.4,
             "species": rng.choice([1, 6, 7, 8], size=(n, 1))}
        d["atom_types"] = d["species"]
        attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
                 "atom_types": ("node", "1x0e")}
        if labels:
            d["total_energy"] = np.asarray(
                [[sum(SHIFTS[int(t)] for t in d["species"][:, 0])
                  + rng.normal()]])
            attrs["total_energy"] = ("graph", "1x0e")
        out, attrs = computeEdgeIndex(d, attrs, r_max=4.0)
        d.update(out)
        mols.append(Data(attrs, **d))
    return mols


def make_batches(mols, device):
    from equivariant_nn_zoo_tpu_torch.data import Batch, GraphBatch

    hosts = [Batch.from_data_list(mols[i * BATCH:(i + 1) * BATCH])
             for i in range(len(mols) // BATCH)]
    node_cap = max(int(h["_n_nodes"].sum()) for h in hosts) + 1
    edge_cap = max(int(h["_n_edges"].sum()) for h in hosts)
    out = [GraphBatch.from_batch(h, node_cap, edge_cap, BATCH, device)
           for h in hosts]
    if any(gb.dropped for gb in out):
        fail("a batch dropped graphs")
    return out


def cuda_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, kernel, plain):
    """Run kernel and plain once, check, time both; return the record."""
    import torch

    with torch.inference_mode():
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"{name}: non-finite kernel output")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        rel = err / max(scale, 1e-30)
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain)
    print(f"{name}: max_abs_err={err:.3e} rel={rel:.3e} (max|plain|="
          f"{scale:.3e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if rel > TOL:
        fail(f"{name}: kernel disagrees with plain (rel {rel:.3e} > {TOL})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def compare_grads(name, kernel, plain, names):
    """As ``compare`` for a kernel with several outputs (a backward): each
    output is held against its plain version at rel-linf TOL of its own
    max|plain|; the record keeps the largest absolute error."""
    import torch

    with torch.no_grad():
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        errs = []
        for what, a, b in zip(names, got, want):
            if not torch.isfinite(a).all():
                fail(f"{name}: non-finite {what}")
            err = float((a - b).abs().max())
            rel = err / max(float(b.abs().max()), 1e-30)
            errs.append(err)
            print(f"{name} {what}: max_abs_err={err:.3e} rel={rel:.3e}")
            if rel > TOL:
                fail(f"{name}: {what} disagrees with plain (rel {rel:.3e} "
                     f"> {TOL})")
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain)
    print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)


def step_gradients(model, gb, loss_fn):
    """Loss and every parameter's gradient (on the host) of one step."""
    model.zero_grad()
    out = model(gb)
    loss, _ = loss_fn(out.data, gb.data)
    loss.backward()
    return loss.item(), {n: p.grad.detach().cpu()
                         for n, p in model.named_parameters()}


def main():
    import torch

    # -------------------------------------------------------------- device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from equivariant_nn_zoo_tpu_torch.inference import evaluate
    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.ops.cuda import (
        FullConv,
        SpeciesScalarFCTP,
    )
    from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as conv_ops
    from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as sc_ops
    from equivariant_nn_zoo_tpu_torch.ops.cuda.build import build
    from equivariant_nn_zoo_tpu_torch.run import Loss, Trainer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # --------------------------------------------------------------- build
    t0 = time.perf_counter()
    lib, log = build()
    print(f"build: {os.path.relpath(lib)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())

    # ------------------------------------------------ data, model, hot layer
    mols = synthetic_qm9(N_BATCHES * BATCH, np.random.default_rng(0))
    batches = make_batches(mols, dev)
    mc = get_config("config_energy")["model_config"]
    model = build_model(mc, dev, torch.Generator().manual_seed(0))
    model.eval()
    conv = getattr(model, HOT_LAYER).conv
    seen = {}
    hook = conv.register_forward_pre_hook(
        lambda mod, args: seen.update(data=args[0]))
    with torch.no_grad():  # the backward phases differentiate these inputs
        model(batches[0])
    hook.remove()
    data = seen["data"]
    gb0 = batches[0]
    print(f"hot layer {HOT_LAYER}: N={gb0.node_capacity} "
          f"E={gb0.edge_capacity} in={conv.full_conv.fused.irreps_in} "
          f"K={conv.full_conv.fused.K_dim} paths={conv.full_conv.n_paths} "
          f"out_dim={conv.full_conv.out_dim}")

    # ------------------------------------------------------------------ K1
    with torch.inference_mode():
        x1 = conv.linear_1(data["input_features"])
        er = data["edge_radial"] * data["_edge_mask"]
    k1_args = (conv.fc, conv.tp.linear, x1, er, data["edge_spherical"],
               data["edge_index"][0], data["edge_index"][1], x1.shape[0],
               1.0 / conv.avg_num_neighbors ** 0.5)
    k1 = compare("K1 full_conv", lambda: conv.full_conv.launch(*k1_args),
                 lambda: conv.full_conv.plain(*k1_args))

    # ------------------------------------------------------------------ K3
    k3_args = (conv.sc, data["input_features"], data["node_attrs"],
               data["species"])
    k3 = compare("K3 species_sc", lambda: conv.species_sc.launch(*k3_args),
                 lambda: conv.species_sc.plain(*k3_args))

    # ------------------------------------------------------------------ K2
    fconv = conv.full_conv
    flat = [t.detach() for t in fconv.flat_weights(conv.fc, conv.tp.linear,
                                                   k1_args[-1])]
    with torch.no_grad():  # K1's inputs again, as tensors autograd takes
        x1g = conv.linear_1(data["input_features"])
        erg = data["edge_radial"] * data["_edge_mask"]
        _, scratch = conv_ops.launch_forward(
            fconv, x1g, erg, *k1_args[4:7], *flat, x1g.shape[0])
    gout = torch.randn(x1g.shape[0], fconv.out_dim,
                       generator=torch.Generator().manual_seed(1)).to(dev)
    k2_args = (x1g, erg, *k1_args[4:7], *flat, x1g.shape[0], scratch, gout)
    k2 = compare_grads(
        "K2 full_conv_bwd",
        lambda: conv_ops.launch_backward(fconv, *k2_args),
        lambda: fconv.plain_backward(*k2_args),
        ("dx", "d edge_radial", "dw_hidden", "dw_out", "dwsel"))
    del scratch, k2_args

    # ----------------------------------------------------------------- K3b
    ssc = conv.species_sc
    spec = data["species"].reshape(-1)
    with torch.no_grad():
        tables = ssc.tables(conv.sc, data["node_attrs"], spec)
    g3 = torch.randn(spec.shape[0], ssc.irreps_out.dim,
                     generator=torch.Generator().manual_seed(2)).to(dev)
    k3b_args = (data["input_features"], spec, tables, g3)
    k3b = compare_grads(
        "K3b species_sc_bwd",
        lambda: sc_ops.launch_backward(ssc, *k3b_args),
        lambda: ssc.plain_backward(*k3b_args), ("dx", "dtables"))

    # --------------------------------------------------------------- slice
    evaluate(model, batches[:1], ["total_energy"])  # warm-up
    torch.cuda.synchronize()
    FullConv.launches = 0
    SpeciesScalarFCTP.launches = 0
    t0 = time.perf_counter()
    res = evaluate(model, batches, ["total_energy"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"full_conv": FullConv.launches,
                "species_sc": SpeciesScalarFCTP.launches}
    n_layers = mc["num_layers"]
    print(f"slice: {len(res)} graphs in {dt:.4f} s through evaluate "
          f"({len(res) / dt:.1f} graphs/s); launches {launches}")
    if len(res) != N_BATCHES * BATCH:
        fail(f"evaluate returned {len(res)} graphs")
    if not np.isfinite(res["total_energy"]).all():
        fail("non-finite energies")
    for name, n in launches.items():
        if n < n_layers * N_BATCHES:
            fail(f"{name} launched {n} times, want >= "
                 f"{n_layers * N_BATCHES}")

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for gb in batches:
            model(gb)
        torch.cuda.synchronize()
        fwd = time.perf_counter() - t0
    print(f"slice forward: {N_BATCHES * BATCH / fwd:.1f} graphs/s "
          f"({1e3 * fwd / N_BATCHES:.3f} ms per {BATCH}-graph batch, "
          f"host clock around synchronize)")

    # ---------------------------------------------- CPU plain-path recompute
    from equivariant_nn_zoo_tpu_torch.data import Batch, GraphBatch

    cut = 32
    host = Batch.from_data_list(mols[:cut])
    small = GraphBatch.from_batch(host, int(host["_n_nodes"].sum()) + 1,
                                  int(host["_n_edges"].sum()), cut)
    cpu_model = build_model(mc, "cpu", torch.Generator().manual_seed(0))

    def node_energy(m, gb):
        seen = {}
        h = m.output_linear.register_forward_hook(
            lambda mod, args, out: seen.update(e=out[0]["output"]))
        with torch.inference_mode():
            total = m(gb)["total_energy"]
        h.remove()
        mask = gb["_node_mask"][:, 0] > 0
        return total.cpu(), seen["e"][mask].cpu()

    tot_gpu, node_gpu = node_energy(model, small.to(dev))
    tot_cpu, node_cpu = node_energy(cpu_model, small)
    if not torch.allclose(tot_gpu[:, 0],
                          torch.as_tensor(res["total_energy"][:cut, 0]),
                          rtol=TOL, atol=0):
        fail("the 32-graph cut disagrees with the batched run")
    for what, a, b in (("total_energy", tot_gpu, tot_cpu),
                       ("node energies before shift", node_gpu, node_cpu)):
        rel = float((a - b).abs().max() / b.abs().max())
        print(f"card vs CPU plain path, {what} ({cut} graphs): rel {rel:.3e}")
        if rel > TOL:
            fail(f"{what}: card and CPU plain path disagree (rel {rel:.3e})")

    # --------------------------------------------------------------- train
    cfg = get_config("config_energy")
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    labelled = synthetic_qm9(5 * BATCH, np.random.default_rng(1),
                             labels=True)
    train_batches = make_batches(labelled, dev)
    train, val = train_batches[:4], train_batches[4:]
    trainer = Trainer(build_model(mc, dev, torch.Generator().manual_seed(0)),
                      **settings)
    n_epochs = 2
    torch.cuda.synchronize()
    FullConv.launches = FullConv.backward_launches = 0
    SpeciesScalarFCTP.launches = SpeciesScalarFCTP.backward_launches = 0
    t0 = time.perf_counter()
    for epoch in range(n_epochs):
        trainer.epoch_step(train, val)
        md = trainer.mae_dict
        print(f"train epoch {epoch}: training_loss {md['training_loss']} "
              f"validation_loss {md['validation_loss']} "
              f"validation_total_energy_mae "
              f"{md['validation_total_energy_mae']} LR {trainer.current_lr}")
        for key in ("training_loss", "validation_loss"):
            if not np.isfinite(md[key]):
                fail(f"train: non-finite {key} in epoch {epoch}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    train_launches = {
        "full_conv": FullConv.launches,
        "full_conv_bwd": FullConv.backward_launches,
        "species_sc": SpeciesScalarFCTP.launches,
        "species_sc_bwd": SpeciesScalarFCTP.backward_launches}
    steps = n_epochs * len(train)
    print(f"train: {n_epochs} epochs of {len(train)} steps + {len(val)} "
          f"validation batch in {dt:.4f} s; launches {train_launches}")
    for name, n in train_launches.items():
        if n < n_layers * steps:
            fail(f"train: {name} launched {n} times, want >= "
                 f"{n_layers * steps}")

    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for gb in train:
            trainer.batch_step(gb)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / (reps * len(train))
    print(f"train step: {step_ms:.3f} ms per {BATCH}-graph batch, "
          f"{1e3 * BATCH / step_ms:.1f} graphs/s (host clock around "
          f"synchronize, {reps * len(train)} steps)")
    if not np.isfinite(trainer.batch_losses["loss"].item()):
        fail("train: non-finite loss in the timed steps")
    del trainer, train_batches, train, val

    # --------------------------------------------------------- train parity
    # labels N(0, 1) here: with the shifted labels the float32 residual
    # (a ~1e4 total energy minus a ~1e4 label) keeps only ~3 digits, so
    # the loss and its gradient differ at ~1e-3 between any two summation
    # orders; against ~1e4 residuals the comparison holds the kernels.
    host = Batch.from_data_list(labelled[:cut])
    small = GraphBatch.from_batch(host, int(host["_n_nodes"].sum()) + 1,
                                  int(host["_n_edges"].sum()), cut)
    small = small.replace(total_energy=torch.randn(
        cut, 1, generator=torch.Generator().manual_seed(3)))
    loss_fn = Loss(settings["loss_coeffs"])
    card_loss, card = step_gradients(
        build_model(mc, dev, torch.Generator().manual_seed(0)),
        small.to(dev), loss_fn)
    cpu_loss, plain = step_gradients(cpu_model, small, loss_fn)
    worst = max((float((card[n] - plain[n]).abs().max()
                       / max(float(plain[n].abs().max()), 1e-30)), n)
                for n in plain)
    print(f"train parity ({cut} graphs): loss card {card_loss} CPU "
          f"{cpu_loss}; worst gradient rel {worst[0]:.3e} ({worst[1]}) over "
          f"{len(plain)} tensors")
    if abs(card_loss - cpu_loss) > TOL * abs(cpu_loss):
        fail("train parity: the loss differs")
    if any(not torch.isfinite(card[n]).all() for n in card):
        fail("train parity: non-finite gradients on the card")
    if worst[0] > TOL:
        fail(f"train parity: {worst[1]} gradient rel {worst[0]:.3e} > {TOL}")

    src = "equivariant_nn_zoo_tpu_torch/csrc"
    pallas = "equivariant_nn_zoo_tpu/ops/pallas"
    kernels = [
        dict(name="full_conv", route="cuda", source=f"{src}/full_conv.cu",
             replaces=f"{pallas}/fused_conv.py:926",
             launches=launches["full_conv"], **k1),
        dict(name="species_sc", route="cuda", source=f"{src}/species_sc.cu",
             replaces=f"{pallas}/sc.py:181",
             launches=launches["species_sc"], **k3),
        dict(name="full_conv_bwd", route="cuda",
             source=f"{src}/full_conv_bwd.cu",
             replaces=f"{pallas}/fused_conv.py:1051",
             launches=train_launches["full_conv_bwd"], **k2),
        dict(name="species_sc_bwd", route="cuda",
             source=f"{src}/species_sc.cu",
             replaces=f"{pallas}/sc.py:208",
             launches=train_launches["species_sc_bwd"], **k3b),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
