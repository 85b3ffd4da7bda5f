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
             well-conditioned);
10. K4f, K4b, K4g — the force path's external-weight conv core, its VJP
             and its one-pass second-order backward against their plain
             versions, at ``config_energy_force``'s hot-layer shapes (layer3
             of a 64-graph synthetic protein-fragment batch) with seeded
             cotangents;
11. force serve — full-width ``config_energy_force`` (seeded weights)
             serves 4 batches of 64 graphs through ``inference.evaluate``
             (energies and forces); K4f and K4b must launch at least once
             per layer and batch, and a 16-graph cut must match the CPU
             plain path;
12. force train — a ``run.Trainer`` with ``config_energy_force``'s own
             settings (Adam lr 1e-2, EMA 0.99 with num_updates, loss
             1e3 * MSE(energy) + 3e4 * MSE(forces), ReduceLROnPlateau 1.0 /
             1 on the training loss) runs 2 epochs over 4 training batches
             and 1 validation batch of 64 graphs with N(0, 1) energy and
             force labels; K4f, K4b and K4g must each launch at least once
             per step; then ms per step and graphs/s over 12 steps;
13. force train parity — one step's gradient of every parameter on a
             16-graph cut, card against the CPU plain path.

Phase 12 also traces 4 force training steps with ``torch.profiler`` and
writes their kernel-time table to ``chiprun_out/force_step_profile.txt``.

TF32 is off, so the plain versions compute in float32; the kernels sum with
atomics in a varying order, hence rel-linf 1e-4 of max|plain| (per tensor).
Each kernel's bound is the larger of its operations over 67 TFLOP/s (f32
outside the tensor cores) and its bytes (each input read once, each output
written once) over 3.35 TB/s, the H100 SXM's published peaks.  The
second-to-last line is the kernels' JSON, the last the device JSON.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

TOL = 1e-4
N_BATCHES, BATCH = 4, 128
FORCE_BATCH, FORCE_CUT = 64, 16
HOT_LAYER = "layer3"
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM: f32 CUDA cores, HBM3


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


def synthetic_fragments(n_mol, rng):
    """Protein-fragment-like molecules: 8-23 atoms of 20 species, positions
    N(0, 1.6^2), r_max 5, with N(0, 1) ``energy`` and ``forces`` labels."""
    from equivariant_nn_zoo_tpu_torch.data import Data, computeEdgeIndex

    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(8, 24))
        d = {"pos": rng.normal(size=(n, 3)) * 1.6,
             "species": rng.integers(0, 20, size=(n, 1)),
             "energy": rng.normal(size=(1, 1)),
             "forces": rng.normal(size=(n, 3))}
        d["atom_types"] = d["species"]
        attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
                 "atom_types": ("node", "1x0e"), "energy": ("graph", "1x0e"),
                 "forces": ("node", "1x1o")}
        out, attrs = computeEdgeIndex(d, attrs, r_max=5.0)
        d.update(out)
        mols.append(Data(attrs, **d))
    return mols


def make_batches(mols, device, size=BATCH):
    from equivariant_nn_zoo_tpu_torch.data import Batch, GraphBatch

    hosts = [Batch.from_data_list(mols[i * size:(i + 1) * size])
             for i in range(len(mols) // size)]
    node_cap = max(int(h["_n_nodes"].sum()) for h in hosts) + 1
    edge_cap = max(int(h["_n_edges"].sum()) for h in hosts)
    out = [GraphBatch.from_batch(h, node_cap, edge_cap, size, device)
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


def cut_batch(mols, cut):
    """The first ``cut`` molecules as one host-side (CPU) padded batch."""
    from equivariant_nn_zoo_tpu_torch.data import Batch, GraphBatch

    host = Batch.from_data_list(mols[:cut])
    return GraphBatch.from_batch(host, int(host["_n_nodes"].sum()) + 1,
                                 int(host["_n_edges"].sum()), cut, "cpu")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops, n_bytes):
    """The least time the card could take: operations over the f32 peak or
    bytes over the memory rate, whichever is larger."""
    t_ops, t_mem = flops / PEAK_FLOPS, n_bytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_mem),
                bound_by="operations" if t_ops >= t_mem else "bytes")


def conv_counts(tables, N, E):
    """Operation counts of the conv kernels' pieces at these shapes (one
    multiply-add = 2): the per-edge CG contraction (one multiply-add per
    channel and wigner_3j non-zero, c * sh hoisted), one pass over the
    E x K * mul scratch rows, and the node-stage mix products."""
    pr = tables.prob_rows.astype(np.int64)
    return dict(cg=2 * E * tables.fused.mul * tables.nz_idx.numel(),
                rows=E * tables.KM,
                mix=2 * N * int((pr[:, 1] * pr[:, 3]).sum()))


def kernel_record(name, source, replaces, launches, measured, flops,
                  n_bytes):
    b = bound(flops, n_bytes)
    print(f"{name}: {flops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.3f} MB, bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']}, kernel "
          f"{measured['ms']:.4f} ms ({b['bound_ms'] / measured['ms']:.3f} "
          f"of the bound)")
    return dict(name=name, route="cuda",
                source=f"equivariant_nn_zoo_tpu_torch/csrc/{source}",
                replaces=f"equivariant_nn_zoo_tpu/ops/pallas/{replaces}",
                launches=launches, max_abs_err=measured["max_abs_err"],
                ms=measured["ms"], plain_ms=measured["plain_ms"],
                library_ms=None, **b)


def step_gradients(model, gb, loss_fn):
    """Loss and every parameter's gradient (on the host) of one step."""
    model.zero_grad()
    out = model(gb)
    loss, _ = loss_fn(out.data, gb.data)
    loss.backward()
    return loss.item(), {n: p.grad.detach().cpu()
                         for n, p in model.named_parameters()}


def ext_launches():
    from equivariant_nn_zoo_tpu_torch.ops.cuda.full_conv_ext import FullConvExt

    return {"full_conv_ext_fwd": FullConvExt.launches_fwd,
            "full_conv_ext_bwd": FullConvExt.launches_bwd,
            "full_conv_ext_grad2": FullConvExt.launches_grad2}


def reset_ext_launches():
    from equivariant_nn_zoo_tpu_torch.ops.cuda.full_conv_ext import FullConvExt

    FullConvExt.launches_fwd = FullConvExt.launches_bwd = 0
    FullConvExt.launches_grad2 = 0


def worst_rel(got, want):
    """The largest max|a - b| / max|b| over the keys of ``want``."""
    return max((float((got[k] - want[k]).abs().max())
                / max(float(want[k].abs().max()), 1e-30), k) for k in want)


def profile_force_step(trainer, train):
    """``torch.profiler`` over one pass of training steps: kernel time by
    name, written to ``chiprun_out/force_step_profile.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for gb in train[:2]:
        trainer.batch_step(gb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for gb in train:
            trainer.batch_step(gb)
        torch.cuda.synchronize()
    span = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    lines = [f"{len(train)} steps: kernel time {total:.3f} ms "
             f"({total / len(train):.3f} ms per step) over a {1e3 * span:.3f}"
             f" ms span, busy share {total / (1e3 * span):.4f}"]
    lines += [f"{ms:10.3f} ms {100 * ms / max(total, 1e-30):6.2f} % "
              f"{n:6d} x {name}" for ms, n, name in rows]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "force_step_profile.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")
    print("profile: " + "\n  ".join(lines[:16]))


def force_phases(dev):
    """Phases 10-13 of the module docstring (the ``config_energy_force``
    path); returns the K4 kernels' records."""
    import torch

    from equivariant_nn_zoo_tpu_torch.inference import evaluate
    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv_ext as ext
    from equivariant_nn_zoo_tpu_torch.run import Loss, Trainer

    cfg = get_config("config_energy_force")
    mc = cfg["model_config"]
    n_layers = mc["num_layers"]
    mols = synthetic_fragments(N_BATCHES * FORCE_BATCH,
                               np.random.default_rng(10))
    batches = make_batches(mols, dev, FORCE_BATCH)
    model = build_model(mc, dev, torch.Generator().manual_seed(0))
    model.eval()

    # --------------------------------------------------- K4f, K4b, K4g
    conv = getattr(model.func, HOT_LAYER).conv
    seen = {}
    hook = conv.register_forward_pre_hook(
        lambda mod, args: seen.update(data=args[0]))
    with torch.no_grad():
        model(batches[0])
    hook.remove()
    data = {k: v.detach() for k, v in seen["data"].items()}
    fc = conv.full_conv
    with torch.no_grad():
        x = conv.linear_1(data["input_features"])
        w = conv.fc(data["edge_radial"] * data["_edge_mask"])
        wsel = fc.flat_wsel(conv.tp.linear, conv.avg_num_neighbors ** -0.5)
    sh = data["edge_spherical"]
    src, dst = data["edge_index"][0], data["edge_index"][1]
    N, E = x.shape[0], sh.shape[0]
    gen = torch.Generator().manual_seed(4)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    cx, csh, cw = rnd(*x.shape), rnd(*sh.shape), rnd(*w.shape)
    gout = rnd(N, fc.out_dim)
    print(f"force hot layer {HOT_LAYER}: N={N} E={E} "
          f"in={fc.fused.irreps_in} K={fc.fused.K_dim} paths={fc.n_paths} "
          f"P*mul={fc.fused.weight_numel} out_dim={fc.out_dim}")
    fa = (x, sh, w, wsel, src, dst, N)
    ga = (x, cx, sh, csh, w, cw, wsel, src, dst, N, gout)
    k4f = compare_grads(
        "K4f full_conv_ext_fwd", lambda: (ext.launch_forward(fc, *fa),),
        lambda: (fc.plain_forward(*fa),), ("out",))
    k4b = compare_grads(
        "K4b full_conv_ext_bwd", lambda: ext.launch_backward(fc, *fa, gout),
        lambda: fc.plain_backward(*fa, gout), ("dx", "dsh", "dw", "dwsel"))
    k4g = compare_grads(
        "K4g full_conv_ext_grad2", lambda: ext.launch_grad2(fc, *ga),
        lambda: fc.plain_grad2(*ga), ("c_x", "c_s", "c_w", "c_m", "c_g"))
    cc = conv_counts(fc, N, E)
    ops, edges = nbytes(x, sh, w, wsel), nbytes(src, dst)
    out_bytes = N * fc.out_dim * 4
    costs = {
        "K4f": (cc["cg"] + 2 * cc["rows"] + cc["mix"],
                ops + edges + out_bytes),
        "K4b": (3 * cc["cg"] + 4 * cc["rows"] + 2 * cc["mix"],
                2 * ops + edges + out_bytes),
        "K4g": (7 * cc["cg"] + 6 * cc["rows"] + 3 * cc["mix"],
                2 * ops + nbytes(cx, csh, cw) + edges + 2 * out_bytes),
    }
    del data, x, w, sh, cx, csh, cw, gout, fa, ga

    # ------------------------------------------------------- force serve
    keys = ["energy", "forces"]
    evaluate(model, batches[:1], keys)  # warm-up
    torch.cuda.synchronize()
    reset_ext_launches()
    t0 = time.perf_counter()
    res = evaluate(model, batches, keys)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    serve_launches = ext_launches()
    n_real = sum(int(gb["_node_mask"].sum()) for gb in batches)
    print(f"force serve: {len(res)} graphs ({n_real} atoms) in {dt:.4f} s "
          f"through evaluate ({len(res) / dt:.1f} graphs/s); launches "
          f"{serve_launches}")
    if len(res) != N_BATCHES * FORCE_BATCH:
        fail(f"force serve: evaluate returned {len(res)} graphs")
    if res["forces"].shape != (n_real, 3):
        fail(f"force serve: forces of shape {res['forces'].shape}")
    for key in keys:
        if not np.isfinite(res[key]).all():
            fail(f"force serve: non-finite {key}")
    for name in ("full_conv_ext_fwd", "full_conv_ext_bwd"):
        if serve_launches[name] < n_layers * N_BATCHES:
            fail(f"force serve: {name} launched {serve_launches[name]} "
                 f"times, want >= {n_layers * N_BATCHES}")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for gb in batches:
            model(gb)
        torch.cuda.synchronize()
        fwd = time.perf_counter() - t0
    print(f"force serve forward: {N_BATCHES * FORCE_BATCH / fwd:.1f} graphs/s"
          f" ({1e3 * fwd / N_BATCHES:.3f} ms per {FORCE_BATCH}-graph batch, "
          f"energies and forces, host clock around synchronize)")

    small = cut_batch(mols, FORCE_CUT)
    cpu_model = build_model(mc, "cpu", torch.Generator().manual_seed(0))
    with torch.no_grad():
        card_out = model(small.to(dev))
        cpu_out = cpu_model(small)
    got = {k: card_out[k].cpu() for k in keys}
    if not torch.allclose(got["energy"][:, 0],
                          torch.as_tensor(res["energy"][:FORCE_CUT, 0]),
                          rtol=TOL, atol=0):
        fail(f"the {FORCE_CUT}-graph cut disagrees with the batched run")
    for key in keys:
        rel = worst_rel(got, {key: cpu_out[key]})[0]
        print(f"force serve, card vs CPU plain path, {key} ({FORCE_CUT} "
              f"graphs): rel {rel:.3e}")
        if rel > TOL:
            fail(f"force serve: {key} of card and CPU plain path disagree "
                 f"(rel {rel:.3e})")
    del model, batches, res

    # ------------------------------------------------------- force train
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    labelled = synthetic_fragments(5 * FORCE_BATCH, np.random.default_rng(11))
    train_batches = make_batches(labelled, dev, FORCE_BATCH)
    train, val = train_batches[:4], train_batches[4:]
    trainer = Trainer(build_model(mc, dev, torch.Generator().manual_seed(0)),
                      **settings)
    n_epochs = 2
    torch.cuda.synchronize()
    reset_ext_launches()
    t0 = time.perf_counter()
    for epoch in range(n_epochs):
        trainer.epoch_step(train, val)
        md = trainer.mae_dict
        print(f"force train epoch {epoch}: training_loss "
              f"{md['training_loss']} validation_loss {md['validation_loss']}"
              f" validation_energy_mae {md['validation_energy_mae']} "
              f"validation_forces_mae {md['validation_forces_mae']} "
              f"LR {trainer.current_lr}")
        for key in ("training_loss", "validation_loss"):
            if not np.isfinite(md[key]):
                fail(f"force train: non-finite {key} in epoch {epoch}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    train_launches = ext_launches()
    steps = n_epochs * len(train)
    print(f"force train: {n_epochs} epochs of {len(train)} steps + "
          f"{len(val)} validation batch in {dt:.4f} s; launches "
          f"{train_launches}")
    for name, n in train_launches.items():
        if n < steps:
            fail(f"force train: {name} launched {n} times in {steps} steps")
    reset_ext_launches()
    trainer.batch_step(train[0])
    per_step = ext_launches()
    reset_ext_launches()
    trainer.batch_step(val[0], validation=True)
    per_val = ext_launches()
    print(f"force train launches per step (all {n_layers} layers): "
          f"{per_step}; per layer and step: "
          f"{ {k: v / n_layers for k, v in per_step.items()} }; per "
          f"validation batch: {per_val}")

    reps = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        for gb in train:
            trainer.batch_step(gb)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / (reps * len(train))
    print(f"force train step: {step_ms:.3f} ms per {FORCE_BATCH}-graph "
          f"batch, {1e3 * FORCE_BATCH / step_ms:.1f} graphs/s (host clock "
          f"around synchronize, {reps * len(train)} steps); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    if not np.isfinite(trainer.batch_losses["loss"].item()):
        fail("force train: non-finite loss in the timed steps")
    profile_force_step(trainer, train)
    del trainer, train_batches, train, val

    # ------------------------------------------------ force train parity
    small = cut_batch(labelled, FORCE_CUT)
    loss_fn = Loss(settings["loss_coeffs"])
    card_loss, card = step_gradients(
        build_model(mc, dev, torch.Generator().manual_seed(0)),
        small.to(dev), loss_fn)
    cpu_loss, plain = step_gradients(cpu_model, small, loss_fn)
    worst = worst_rel(card, plain)
    print(f"force train parity ({FORCE_CUT} graphs): loss card {card_loss} "
          f"CPU {cpu_loss}; worst gradient rel {worst[0]:.3e} ({worst[1]}) "
          f"over {len(plain)} tensors")
    if abs(card_loss - cpu_loss) > TOL * abs(cpu_loss):
        fail("force train parity: the loss differs")
    if any(not torch.isfinite(card[n]).all() for n in card):
        fail("force train parity: non-finite gradients on the card")
    if worst[0] > TOL:
        fail(f"force train parity: {worst[1]} gradient rel {worst[0]:.3e} "
             f"> {TOL}")

    return [
        kernel_record("full_conv_ext_fwd", "full_conv_ext.cu",
                      "fused_conv.py:1348",
                      train_launches["full_conv_ext_fwd"], k4f,
                      *costs["K4f"]),
        kernel_record("full_conv_ext_bwd", "full_conv_ext.cu",
                      "fused_conv.py:1432",
                      train_launches["full_conv_ext_bwd"], k4b,
                      *costs["K4b"]),
        kernel_record("full_conv_ext_grad2", "full_conv_ext.cu",
                      "fused_conv.py:1618",
                      train_launches["full_conv_ext_grad2"], k4g,
                      *costs["K4g"]),
    ]


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

    # operations and bytes of each call at these shapes
    N0, E0 = x1.shape[0], er.shape[0]
    cc = conv_counts(fconv, N0, E0)
    dims = fconv.fc_dims
    mlp = 2 * E0 * sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    items = ssc.bwd_item_table.cpu().numpy().reshape(-1, 6).astype(np.int64)
    sc_flops = 2 * N0 * int((items[:, 1] * items[:, 4] * items[:, 5]).sum())
    out_bytes = N0 * fconv.out_dim * 4
    costs = {
        "K1": (mlp + cc["cg"] + 2 * cc["rows"] + cc["mix"],
               nbytes(x1, er, *k1_args[4:7], *flat) + out_bytes),
        "K3": (sc_flops, nbytes(*k3_args[1:], conv.sc.weight)
               + N0 * ssc.irreps_out.dim * 4),
        "K2": (3 * mlp + 2 * cc["cg"] + 2 * cc["rows"] + 2 * cc["mix"],
               2 * nbytes(x1, er, *flat) + nbytes(*k1_args[4:7])
               + N0 * fconv.KM * 4 + out_bytes),
        "K3b": (2 * sc_flops, 2 * nbytes(data["input_features"], tables)
                + nbytes(spec, g3)),
    }

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
    cut = 32
    small = cut_batch(mols, cut)
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
    small = cut_batch(labelled, cut).replace(total_energy=torch.randn(
        cut, 1, generator=torch.Generator().manual_seed(3)))
    loss_fn = Loss(settings["loss_coeffs"])
    card_loss, card = step_gradients(
        build_model(mc, dev, torch.Generator().manual_seed(0)),
        small.to(dev), loss_fn)
    cpu_loss, plain = step_gradients(cpu_model, small, loss_fn)
    worst = worst_rel(card, plain)
    print(f"train parity ({cut} graphs): loss card {card_loss} CPU "
          f"{cpu_loss}; worst gradient rel {worst[0]:.3e} ({worst[1]}) over "
          f"{len(plain)} tensors")
    if abs(card_loss - cpu_loss) > TOL * abs(cpu_loss):
        fail("train parity: the loss differs")
    if any(not torch.isfinite(card[n]).all() for n in card):
        fail("train parity: non-finite gradients on the card")
    if worst[0] > TOL:
        fail(f"train parity: {worst[1]} gradient rel {worst[0]:.3e} > {TOL}")

    del cpu_model, model, batches
    force_records = force_phases(dev)

    kernels = [
        kernel_record("full_conv", "full_conv.cu", "fused_conv.py:926",
                      launches["full_conv"], k1, *costs["K1"]),
        kernel_record("species_sc", "species_sc.cu", "sc.py:181",
                      launches["species_sc"], k3, *costs["K3"]),
        kernel_record("full_conv_bwd", "full_conv_bwd.cu",
                      "fused_conv.py:1051", train_launches["full_conv_bwd"],
                      k2, *costs["K2"]),
        kernel_record("species_sc_bwd", "species_sc.cu", "sc.py:208",
                      train_launches["species_sc_bwd"], k3b, *costs["K3b"]),
        *force_records,
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
