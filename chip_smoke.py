#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --conv-times     # K1 and K2 alone, see conv_times
    python3 chip_smoke.py --walk-ablation  # their walks' parts, see there
    python3 chip_smoke.py --mix-times      # the mix GEMM's product sets,
                                           # see mix_times

Phases, in order; any failure exits non-zero before the last line:

1. device  — requires CUDA; prints the card's name and power limit;
2. build   — compiles the kernels from ``csrc/`` and prints ``ptxas`` lines;
3. K1      — the whole-convolution kernel against its plain PyTorch version
             on the card, at ``config_energy``'s hot-layer shapes (layer3 of
             a 128-graph synthetic QM9-like batch);
4. K3      — the species self-connection kernel, likewise;
5. K2      — the convolution's backward kernel against the plain backward
             (autograd of the plain forward) on K1's saved scratch and a
             seeded cotangent: dx, d edge_radial, dW (MLP) and dwsel; K1
             and K2 walk one edge order, built once as on the main path;
6. K3b     — the self-connection's backward kernel (dx, dtables), likewise;
   row_mix — the mix GEMM of ``csrc/row_mix.cuh`` on its own at the same
             layer: K1's forward mix on K1's scratch, and K2's node-stage
             products (dS, dwsel) on that scratch and the cotangent,
             against their plain version (``row_mix.run_plan``), with
             ``torch.matmul`` on contiguous copies of each problem's
             operands as the library's time; dwsel must repeat bit for bit;
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
             ``num_layers x steps`` times, and the mix GEMM (forward mix
             and backward products, counted by the kernel library) at
             least once; then ms per step and graphs/s and a
             ``torch.profiler`` table of 4 steps;
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
             16-graph cut, card against the CPU plain path;
14. K5, K6  — the hamiltonian head's pairwise expansion and per-edge conv
             against their plain versions at the full-width head's shapes
             (a 512-molecule synthetic H2O batch: ``tp_off`` on the 3072
             edges, ``tp`` on the 1537 node rows): each kernel on its own
             contract (K5: left, weighted right, mix matrices; K6: x, sh,
             radial weights, mix matrices) and each wrapper against the
             plain forward (``expand``, ``FusedUVUConv(reduce=False)``);
             then K3 against plain at the trunk's hot layer, whose irreps
             reach l = 4;
15. hamiltonian serve — full-width ``config_hamiltonian`` (seeded weights,
             ``build_model`` with no device argument) serves 4 batches of
             16 and 4 batches of 512 molecules through
             ``inference.evaluate``; one forward must launch K1 and K3 once
             per layer, K6 once and K5 twice; the matrices must be finite
             and symmetric to 1e-5, and a 16-molecule cut must match the
             CPU plain path;
16. K6b, K5m, K5a, K5b, K1, K2 and K3b at l = 4 — the hamiltonian
             path's backward kernels (and K1) against their plain versions
             (autograd of the plain forwards) with seeded cotangents, per
             output, at the shapes of the 512-molecule batch (K6b and
             ``tp_off`` on 3072 edges, ``tp`` on 1537 node rows, the
             trunk's hot layer) and of the config's batch of 16 (96 edges,
             49 node rows); the
             pairwise backward is one entry, so each of its three kernels
             (dwsel, d left, dbw) is also launched, checked and timed
             alone;
17. hamiltonian train — a ``run.Trainer`` with ``config_hamiltonian``'s
             own settings (loss 1e5 * MSE on ``hamiltonian``, Adam lr 1e-2,
             EMA 0.99 with num_updates, ReduceLROnPlateau patience 8 factor
             0.8, batch 16) runs 2 epochs over 4 training batches and 1
             validation batch of synthetic H2O with seeded N(0, 1) targets
             ``[G, 576]``; one step must launch exactly 5 K1, 5 K2, 5 K3,
             5 K3b, 1 K6, 1 K6b, 2 K5 and 2 K5 backward entries; then 12
             timed steps at batch 16 and at batch 128 (ms per step,
             graphs/s, peak memory, device busy share); the loss on a fixed
             batch must be finite and lower after the steps;
18. hamiltonian train parity — one step's gradient of every parameter on
             a 16-molecule cut, card against the CPU plain path.

Phase 8 traces 4 energy training steps with ``torch.profiler`` and writes
their kernel-time table to ``chiprun_out/energy_step_profile.txt``; phase
12 does the same for 4 force training steps
(``chiprun_out/force_step_profile.txt``);
phase 15 does the same for 4 serving forwards at each batch size
(``chiprun_out/hamiltonian_serve_profile_{16,512}.txt``) and phase 17 for 4
training steps at each batch size
(``chiprun_out/hamiltonian_step_profile{,_128}.txt``).

TF32 is off, so the plain versions compute in float32; the kernels sum in
another order (the mix GEMM in 3xTF32 on the tensor cores), some with
atomics in a varying order, hence rel-linf 1e-4 of max|plain| (per
tensor).
Each kernel's bound is the larger of its operations over 67 TFLOP/s (f32
outside the tensor cores) and its bytes (each input read once, each output
written once) over 3.35 TB/s, the H100 SXM's published peaks; for the mix
GEMM, its three TF32 products per product over 495 TFLOP/s (the float32
bound beside it as ``bound_f32_ms``).  The second-to-last line is the
kernels' JSON, the last the device JSON.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

TOL = 1e-4
N_BATCHES, BATCH = 4, 128
FORCE_BATCH, FORCE_CUT = 64, 16
H2O_BATCHES, H2O_CUT = (16, 512), 16   # the config's batch, a serving batch
H2O_TRAIN_BATCHES = (16, 128)          # the config's batch, a larger one
HOT_LAYER = "layer3"
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM: f32 CUDA cores, HBM3
PEAK_TF32 = 495e12                       # H100 SXM: TF32 tensor cores, dense


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


def synthetic_h2o(n_mol, rng, labels=False):
    """Water molecules: the equilibrium geometry plus N(0, 0.03^2) noise,
    r_max 4 (all six ordered pairs are edges); with ``labels``, an N(0, 1)
    ``hamiltonian`` target of 576 entries per molecule."""
    from equivariant_nn_zoo_tpu_torch.data import Data, computeEdgeIndex

    base = np.array([[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]])
    mols = []
    for _ in range(n_mol):
        d = {"pos": base + rng.normal(scale=0.03, size=(3, 3)),
             "species": np.array([[8], [1], [1]])}
        d["atom_types"] = d["species"]
        attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
                 "atom_types": ("node", "1x0e")}
        if labels:
            d["hamiltonian"] = rng.normal(size=(1, 576)).astype(np.float32)
            attrs["hamiltonian"] = ("graph", 576)
        out, attrs = computeEdgeIndex(d, attrs, r_max=4.0)
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


def trunk_costs(conv, x1, er, edges, flat, x_in, attrs, tables, spec, g3):
    """Operations and bytes of K1, K3, K2 and K3b at one layer's shapes:
    ``x1`` the conv's input, ``er`` the masked radial basis, ``edges`` (sh,
    src, dst), ``flat`` the kernels' flat weights, ``x_in`` / ``attrs`` /
    ``tables`` / ``spec`` / ``g3`` the self-connection's operands."""
    fconv, ssc = conv.full_conv, conv.species_sc
    N0, E0 = x1.shape[0], er.shape[0]
    cc = conv_counts(fconv, N0, E0)
    dims = fconv.fc_dims
    mlp = 2 * E0 * sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    items = ssc.bwd_item_table.cpu().numpy().reshape(-1, 6).astype(np.int64)
    sc_flops = 2 * N0 * int((items[:, 1] * items[:, 4] * items[:, 5]).sum())
    out_bytes = N0 * fconv.out_dim * 4
    return {
        "K1": (mlp + cc["cg"] + 2 * cc["rows"] + cc["mix"],
               nbytes(x1, er, *edges, *flat) + out_bytes),
        "K3": (sc_flops, nbytes(x_in, attrs, spec, conv.sc.weight)
               + N0 * ssc.irreps_out.dim * 4),
        "K2": (3 * mlp + 2 * cc["cg"] + 2 * cc["rows"] + 2 * cc["mix"],
               2 * nbytes(x1, er, *flat) + nbytes(*edges)
               + N0 * fconv.KM * 4 + out_bytes),
        "K3b": (2 * sc_flops, 2 * nbytes(x_in, tables) + nbytes(spec, g3)),
    }


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


def mix_bound(flops, n_bytes):
    """Bounds of products computed in 3xTF32: three TF32 products per
    product over the tensor cores' rate, or bytes; the float32 bound
    (CUDA cores) beside it."""
    t3, t32, tb = 3 * flops / PEAK_TF32, flops / PEAK_FLOPS, \
        n_bytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t3, tb),
                bound_by="operations" if t3 >= tb else "bytes",
                bound_f32_ms=1e3 * max(t32, tb))


def mix_flops(prob_rows, rows):
    """Operations of one mix product over ``rows`` rows (one multiply-add
    = 2)."""
    pr = np.asarray(prob_rows, np.int64)
    return 2 * rows * int((pr[:, 1] * pr[:, 3]).sum())


def mix_operands(prob_rows, S, wsel, gout):
    """Contiguous copies of every mix problem's operands: (S block
    [rows, kdim], wsel_q [kdim, wo], gout columns [rows, wo]), the
    library's inputs; a None operand stays None."""
    ops = []
    for a_col, kdim, b_off, wo, c_off, cs in np.asarray(prob_rows).tolist():
        ops.append((
            None if S is None else S[:, a_col: a_col + kdim].contiguous(),
            wsel[b_off: b_off + kdim * wo].reshape(kdim, wo).contiguous(),
            None if gout is None
            else gout[:, c_off: c_off + cs * wo: cs].contiguous()))
    return ops


def library_forward(ops):
    import torch

    return [torch.matmul(s, w) for s, w, _ in ops]


def library_backward(ops):
    """dS and dwsel of every problem, one torch.matmul each."""
    import torch

    return [(torch.matmul(g, w.T), torch.matmul(s.T, g)) for s, w, g in ops]


def row_mix_phase(fconv, scratch, wsel, gout):
    """The mix GEMM alone at one conv layer: K1's forward mix of its
    scratch and K2's node-stage products (dS, dwsel) against the plain
    version, with the library's time and the bounds; returns the two
    records."""
    import torch

    from equivariant_nn_zoo_tpu_torch.ops.cuda import row_mix as rm

    pr, KM, od = fconv.prob_rows, fconv.KM, fconv.out_dim
    N, wl = scratch.shape[0], fconv.wsel_len

    def products():
        return (rm.launch_backward(rm.ROWS, pr, KM, gout, wsel=wsel),
                rm.launch_backward(rm.WEIGHTS, pr, KM, gout, S=scratch,
                                   wsel_len=wl))

    fwd = compare(
        "row_mix forward mix (K1's mix)",
        lambda: rm.launch_forward(scratch, wsel, pr, od),
        lambda: rm.run_plan(rm.FORWARD, pr, N, KM, od, S=scratch, wsel=wsel))
    bwd = compare_grads(
        "row_mix backward products (K2's dS, dwsel)", products,
        lambda: (rm.run_plan(rm.ROWS, pr, N, KM, od, wsel=wsel, gout=gout),
                 rm.run_plan(rm.WEIGHTS, pr, N, KM, od, S=scratch, gout=gout,
                             wsel_len=wl)), ("dS", "dwsel"))
    with torch.no_grad():
        a, b = products(), products()
        torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        fail("row_mix: dS or dwsel differ between two launches")
    ops = mix_operands(pr, scratch, wsel, gout)
    fwd["library_ms"] = cuda_ms(lambda: library_forward(ops))
    bwd["library_ms"] = cuda_ms(lambda: library_backward(ops))
    del ops
    flops = mix_flops(pr, N)
    fwd.update(mix_bound(flops, nbytes(scratch, wsel) + N * od * 4))
    bwd.update(mix_bound(2 * flops, nbytes(scratch, wsel, gout)
                         + N * KM * 4 + wl * 4))
    for name, rec in (("forward mix", fwd), ("backward products", bwd)):
        print(f"row_mix {name}: kernel {rec['ms']:.4f} ms, torch.matmul "
              f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"by {rec['bound_by']} (float32 {rec['bound_f32_ms']:.4f})")
    return fwd, bwd


def mix_record(name, replaces, launches, rec):
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "bound_f32_ms")
    return dict(name=name, route="cuda",
                source="equivariant_nn_zoo_tpu_torch/csrc/row_mix.cuh",
                replaces=f"equivariant_nn_zoo_tpu/ops/pallas/{replaces}",
                launches=launches, **{k: rec[k] for k in keys})


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


def worst_gradient_rel(got, want):
    """``worst_rel`` for gradients: a tensor that is zero by symmetry comes
    out as rounding noise on both sides, so one under 1e-12 of the largest
    gradient is held to be as small in ``got`` and left out of the ratio."""
    floor = 1e-12 * max(float(w.abs().max()) for w in want.values())
    live = {}
    for k, w in want.items():
        if float(w.abs().max()) >= floor:
            live[k] = w
        elif float(got[k].abs().max()) >= floor:
            fail(f"{k}: gradient {float(got[k].abs().max()):.3e} where the "
                 f"plain path has noise under {floor:.3e}")
    return worst_rel(got, live), len(want) - len(live)


# kernel families of a profile, first match wins: (label, regex on the name)
PROFILE_FAMILIES = (
    ("K2 edge walk (k2_walk_kernel)", "k2_walk_kernel"),
    ("K4 edge sweeps", "ext_edge_kernel"),
    ("forward mix (rowmix::gemm_kernel<true, false>)",
     r"gemm_kernel<true, false>|mix_rows_kernel"),
    ("backward's tiled products (rowmix::gemm_kernel, its split sum and "
     "gout's copy)", r"rowmix::"),
    ("Adam (profiler range)", r"Optimizer\.step"),
    ("K1 edge walk (k1_walk_kernel)", "k1_walk_kernel"),
    ("K1/K2 radial hidden layers, piece sums, dx sums",
     "mlp_hidden_kernel|walk_piece_sum_kernel|k2_dx_kernel"),
    ("K5 sweeps (cg, da, dbw)", "pairwise_"),
    ("K6 and K6b sweeps", "uvu_"),
    ("K3 and K3b", "species_sc"),
    ("sorts and index backward", "RadixSort|indexing_backward|cub::"),
    ("cuBLAS and CUTLASS products", "cublas|cutlass|gemm|gemv|splitK"),
    ("other PyTorch kernels, copies, memsets", "."),
)


def profile_kernels(what, run, n_items, filename):
    """``torch.profiler`` over ``run()`` (``n_items`` steps or batches):
    kernel time by name, written to ``chiprun_out/<filename>``; returns the
    kernel time per item in ms (the span itself is stretched by the
    profiler, so a busy share is taken against an unprofiled run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
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
    lines = [f"{n_items} {what}: kernel time {total:.3f} ms "
             f"({total / n_items:.3f} ms each, "
             f"{sum(r[1] for r in rows) / n_items:.0f} launches each) over a "
             f"{1e3 * span:.3f} ms profiled span"]
    families = {}
    for ms, n, name in rows:
        label = next(lab for lab, pat in PROFILE_FAMILIES
                     if re.search(pat, name))
        fam = families.setdefault(label, [0.0, 0])
        fam[0] += ms
        fam[1] += n
    lines += [f"  family {label}: {ms / n_items:.3f} ms each "
              f"({100 * ms / max(total, 1e-30):.2f} %), "
              f"{n / n_items:.1f} launches each"
              for label, (ms, n) in sorted(families.items(),
                                           key=lambda kv: -kv[1][0])]
    lines += [f"{ms:10.3f} ms {100 * ms / max(total, 1e-30):6.2f} % "
              f"{n:6d} x {name}" for ms, n, name in rows]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", filename), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("profile: " + "\n  ".join(lines[:24]))
    return total / n_items


def profile_force_step(trainer, train):
    """Trace one pass of training steps after two warm-up steps."""
    for gb in train[:2]:
        trainer.batch_step(gb)
    profile_kernels("force training steps",
                    lambda: [trainer.batch_step(gb) for gb in train],
                    len(train), "force_step_profile.txt")


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


def head_counters():
    """(class, attribute) of every launch counter on the hamiltonian path,
    by the kernel's C entry."""
    from equivariant_nn_zoo_tpu_torch.ops.cuda import (
        FullConv,
        PairwiseTP,
        SpeciesScalarFCTP,
        UVUConv,
    )

    return {"full_conv": (FullConv, "launches"),
            "full_conv_bwd": (FullConv, "backward_launches"),
            "species_sc": (SpeciesScalarFCTP, "launches"),
            "species_sc_bwd": (SpeciesScalarFCTP, "backward_launches"),
            "uvu_conv": (UVUConv, "launches"),
            "uvu_conv_bwd": (UVUConv, "backward_launches"),
            "pairwise_tp": (PairwiseTP, "launches"),
            "pairwise_tp_bwd": (PairwiseTP, "backward_launches")}


def head_launches():
    return {k: getattr(cls, attr) for k, (cls, attr) in
            head_counters().items()}


def reset_head_launches():
    for cls, attr in head_counters().values():
        setattr(cls, attr, 0)


def capture_head_inputs(model, gb):
    """One forward of ``gb`` with hooks: the arguments of the two K5 calls
    (``tp_off``, then ``tp``), of K6, and the data dict that reaches the
    trunk's hot layer."""
    import torch

    head = model.pairwise
    seen = {"K5": [], "K6": [], "trunk": []}
    hooks = [
        head.pairwise_tp.register_forward_pre_hook(
            lambda mod, args: seen["K5"].append(args)),
        head.conv.full_conv.register_forward_pre_hook(
            lambda mod, args: seen["K6"].append(args)),
        getattr(model, HOT_LAYER).conv.register_forward_pre_hook(
            lambda mod, args: seen["trunk"].append(args[0]))]
    with torch.no_grad():
        model(gb)
    for h in hooks:
        h.remove()
    return seen


def backward_checks(model, seen, dev, alone):
    """Phase 16 at one batch's shapes: K6b, the pairwise backward (both
    calls), K1 and K2 / K3b at the l = 4 hot layer against their plain
    versions, per output (K2 on the forward's edge order).  With ``alone``
    each of K5m, K5a and K5b is also launched, checked and timed by itself
    on ``tp_off``'s inputs.  Returns
    measured records and (flops, bytes) costs by kernel."""
    import torch

    from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
    from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as conv_ops
    from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as k5_ops
    from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as sc_ops
    from equivariant_nn_zoo_tpu_torch.ops.cuda import uvu_conv as k6_ops

    head = model.pairwise
    tpk, uvu = head.pairwise_tp, head.conv.full_conv
    conv = getattr(model, HOT_LAYER).conv
    gen = torch.Generator().manual_seed(5)
    rec, cost = {}, {}

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    # ----------------------------------------------------------------- K6b
    linear, x, sh, w, src = seen["K6"][0]
    E = sh.shape[0]
    with torch.no_grad():
        wsel6 = uvu.flat_wsel(linear)
        _, scratch = k6_ops.launch_forward(uvu, x, sh, w, wsel6, src)
    args6 = (x, sh, w, wsel6, src, scratch, rnd(E, uvu.out_dim))
    rec["K6b"] = compare_grads(
        f"K6b uvu_conv_bwd (E={E})",
        lambda: k6_ops.launch_backward(uvu, *args6),
        lambda: uvu.plain_backward(*args6), ("dx", "dsh", "dw", "dwsel"))
    cc = conv_counts(uvu, E, E)
    cost["K6b"] = (3 * cc["cg"] + 2 * cc["rows"] + 2 * cc["mix"],
                   2 * nbytes(x, sh, w, wsel6) + nbytes(src, scratch, args6[-1]))
    del args6, scratch

    # ------------------------------------------------- K5m, K5a, K5b (one entry)
    pr = tpk.prob_rows.astype(np.int64)
    mix = 2 * int((pr[:, 1] * pr[:, 3]).sum())       # per element
    cg = 2 * tpk.mul * tpk.nz_count                   # per element
    names5 = ("d left", "dbw", "dwsel")
    for which, (tpe, left, right) in zip(("tp_off", "tp"), seen["K5"]):
        M = left.shape[0]
        with torch.no_grad():
            bw = tpk.weighted_right(tpe.tp.weight, right)
            wsel5 = tpk.flat_wsel(tpe.linear)
        args5 = (left, bw, wsel5, rnd(M, tpk.out_dim))
        whole = compare_grads(
            f"K5 backward, one entry ({which}, M={M}: K5m + K5a + K5b)",
            lambda: k5_ops.launch_backward(tpk, *args5),
            lambda: tpk.plain_backward(*args5), names5)
        if which == "tp_off":
            rec["K5 backward"] = whole
            if alone:
                for key, i in (("K5a", 0), ("K5b", 1), ("K5m", 2)):
                    wanted = tuple(j == i for j in range(3))
                    rec[key] = compare_grads(
                        f"{key} alone ({which}, M={M})",
                        lambda: (k5_ops.launch_backward(
                            tpk, *args5, wanted)[i],),
                        lambda: (tpk.plain_backward(*args5, wanted)[i],),
                        names5[i: i + 1])
            io = nbytes(args5[-1])
            cost["K5m"] = (M * (cg + mix), nbytes(left, bw) + io
                           + nbytes(wsel5))
            cost["K5a"] = (M * (mix + 3 * cg // 2), nbytes(bw, wsel5) + io
                           + nbytes(left))
            cost["K5b"] = (M * (mix + 3 * cg // 2), nbytes(left, wsel5) + io
                           + nbytes(bw))
        del bw, args5

    # ------------------------------------------- K2, K3b at the l = 4 layer
    data = seen["trunk"][0]
    fconv, ssc = conv.full_conv, conv.species_sc
    pre = 1.0 / conv.avg_num_neighbors ** 0.5
    edges = (data["edge_spherical"], data["edge_index"][0],
             data["edge_index"][1])
    with torch.no_grad():
        flat = fconv.flat_weights(conv.fc, conv.tp.linear, pre)
        x1 = conv.linear_1(data["input_features"])
        er = data["edge_radial"] * data["_edge_mask"]
        N = x1.shape[0]
        _, scratch = conv_ops.launch_forward(fconv, x1, er, *edges, *flat, N)
        spec = data["species"].reshape(-1)
        tables = ssc.tables(conv.sc, data["node_attrs"], spec)
    k1_args = (conv.fc, conv.tp.linear, x1, er, *edges, N, pre)
    rec["K1"] = compare(f"K1 full_conv at l = 4 (N={N}, E={er.shape[0]})",
                        lambda: fconv.launch(*k1_args),
                        lambda: fconv.plain(*k1_args))
    order = edge_order.shared(edges[1], edges[2], N)
    k2_args = (x1, er, *edges, *flat, N, scratch, rnd(N, fconv.out_dim))
    rec["K2"] = compare_grads(
        f"K2 full_conv_bwd at l = 4 (N={N}, E={er.shape[0]})",
        lambda: conv_ops.launch_backward(fconv, *k2_args, order=order),
        lambda: fconv.plain_backward(*k2_args),
        ("dx", "d edge_radial", "dw_hidden", "dw_out", "dwsel"))
    g3 = rnd(N, ssc.irreps_out.dim)
    k3b_args = (data["input_features"], spec, tables, g3)
    rec["K3b"] = compare_grads(
        f"K3b species_sc_bwd at l = 4 (N={N})",
        lambda: sc_ops.launch_backward(ssc, *k3b_args),
        lambda: ssc.plain_backward(*k3b_args), ("dx", "dtables"))
    cost.update({k: v for k, v in trunk_costs(
        conv, x1, er, edges, flat, data["input_features"],
        data["node_attrs"], tables, spec, g3).items()
        if k in ("K1", "K2", "K3b")})
    return rec, cost


def hamiltonian_phases(dev):
    """Phases 14-18 of the module docstring (the ``config_hamiltonian``
    path, served and trained); returns the records of K5, K6 and their
    backward kernels, and what K1, K3, K2 and K3b did on this path (their
    times at the l = 4 hot layer, their launches)."""
    import torch

    from equivariant_nn_zoo_tpu_torch.inference import evaluate
    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as k5_ops
    from equivariant_nn_zoo_tpu_torch.ops.cuda import uvu_conv as k6_ops

    cfg = get_config("config_hamiltonian")
    mc = cfg["model_config"]
    n_layers = mc["num_layers"]
    # no device argument: the entry point builds on the card by default
    model = build_model(mc, generator=torch.Generator().manual_seed(0))
    model.eval()
    if next(model.parameters()).device.type != "cuda":
        fail("build_model without a device did not build on the card")
    n_params = sum(p.numel() for p in model.parameters())
    mols = synthetic_h2o(N_BATCHES * max(H2O_BATCHES),
                         np.random.default_rng(20))
    batches = {size: make_batches(mols[:N_BATCHES * size], dev, size)
               for size in H2O_BATCHES}
    big = batches[max(H2O_BATCHES)][0]

    # ------------------------------------- the kernels' inputs in one forward
    head = model.pairwise
    conv = getattr(model, HOT_LAYER).conv
    seen = capture_head_inputs(model, big)
    tpk, uvu = head.pairwise_tp, head.conv.full_conv
    print(f"hamiltonian: {n_params} parameters; head K5 paths={tpk.n_paths} "
          f"R={tpk.R} K={tpk.KM // tpk.mul} nz={tpk.nz_count} "
          f"wsel={tpk.wsel_len}; K6 paths={uvu.n_paths} "
          f"K={uvu.fused.K_dim} nz={uvu.nz_idx.numel()} "
          f"P*mul={uvu.fused.weight_numel}; batch of {big.n_graphs}: "
          f"N={big.node_capacity} E={big.edge_capacity}")

    # ------------------------------------------------------------------ K6
    linear, x, sh, w, src = seen["K6"][0]
    E = sh.shape[0]
    with torch.no_grad():
        wsel6 = uvu.flat_wsel(linear)
    k6 = compare("K6 uvu_conv",
                 lambda: k6_ops.launch_forward(uvu, x, sh, w, wsel6, src)[0],
                 lambda: uvu.fused(linear, x, src, None, sh, w, x.shape[0],
                                   reduce=False))
    cc = conv_counts(uvu, E, E)
    k6_cost = (cc["cg"] + cc["rows"] + cc["mix"],
               nbytes(x, sh, w, wsel6, src) + E * uvu.out_dim * 4)

    # ------------------------------------------------------------------ K5
    # tp_off runs on the edges (the record's shapes), tp on the node rows
    k5 = k5_cost = None
    for which, (tpe, left, right) in zip(("tp_off", "tp"), seen["K5"]):
        M = left.shape[0]
        with torch.no_grad():
            bw = tpk.weighted_right(tpe.tp.weight, right)
            wsel5 = tpk.flat_wsel(tpe.linear)
        rec = compare(
            f"K5 pairwise_tp ({which}, M={M}; kernel on left, bw, wsel)",
            lambda: k5_ops.launch_forward(tpk, left, bw, wsel5),
            lambda: tpk.plain_forward(left, bw, wsel5))
        del bw
        whole = compare(
            f"K5 wrapper ({which}, M={M}; stage 1 in PyTorch + kernel "
            f"against expand)",
            lambda: tpk.launch(tpe, left, right),
            lambda: tpe.expand(left, right))
        rec.update(wrapper_ms=whole["ms"], expand_ms=whole["plain_ms"])
        if k5 is None:
            pr = tpk.prob_rows.astype(np.int64)
            k5 = rec
            k5_cost = (2 * M * tpk.mul * tpk.nz_count
                       + 2 * M * int((pr[:, 1] * pr[:, 3]).sum()),
                       nbytes(left, wsel5) + M * tpk.R * tpk.mul * 4
                       + M * tpk.out_dim * 4)

    # ----------------------------------------------- K3 at the l = 4 layer
    data = seen["trunk"][0]
    with torch.inference_mode():
        x1 = conv.linear_1(data["input_features"])
        er = data["edge_radial"] * data["_edge_mask"]
    fc = conv.full_conv
    print(f"hamiltonian hot layer {HOT_LAYER}: in={fc.fused.irreps_in} "
          f"max_d1={fc.max_d1} J={fc.fused.J_dim} K={fc.fused.K_dim} "
          f"paths={fc.n_paths} P*mul={fc.fused.weight_numel} "
          f"MLP={fc.fc_dims} out_dim={fc.out_dim}")
    k3_args = (conv.sc, data["input_features"], data["node_attrs"],
               data["species"])
    k3 = compare("K3 species_sc at l = 4",
                 lambda: conv.species_sc.launch(*k3_args),
                 lambda: conv.species_sc.plain(*k3_args))
    del data, x1, er, k3_args, x, sh, w, left, right

    # --------------------------- the backward kernels, at both batches' shapes
    bwd, bwd_cost = backward_checks(model, seen, dev, alone=True)
    del seen
    bwd_small, _ = backward_checks(
        model, capture_head_inputs(model, batches[H2O_BATCHES[0]][0]), dev,
        alone=False)

    # ------------------------------------------------------------- serving
    with torch.no_grad():
        model(batches[H2O_BATCHES[0]][0])  # warm-up
        torch.cuda.synchronize()
        reset_head_launches()
        model(big)
        torch.cuda.synchronize()
    want = {"full_conv": n_layers, "species_sc": n_layers, "uvu_conv": 1,
            "pairwise_tp": 2}
    per_forward = {k: v for k, v in head_launches().items() if k in want}
    print(f"hamiltonian launches per forward: {per_forward}")
    if per_forward != want:
        fail(f"hamiltonian: one forward launched {per_forward}, want {want}")

    def forward_ms(size):
        """ms per forward over 3 passes of the batches of this size."""
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                for gb in batches[size]:
                    model(gb)
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (3 * N_BATCHES)

    serve_launches = {}
    results = {}
    for size in H2O_BATCHES:
        evaluate(model, batches[size][:1], ["hamiltonian"])  # warm-up
        torch.cuda.synchronize()
        reset_head_launches()
        t0 = time.perf_counter()
        res = evaluate(model, batches[size], ["hamiltonian"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        serve_launches[size] = {k: v for k, v in head_launches().items()
                                if k in want}
        print(f"hamiltonian serve, batch {size}: {len(res)} graphs in "
              f"{dt:.4f} s through evaluate ({len(res) / dt:.1f} graphs/s); "
              f"launches {serve_launches[size]}")
        if len(res) != N_BATCHES * size:
            fail(f"hamiltonian serve: evaluate returned {len(res)} graphs")
        H = res["hamiltonian"]
        if H.shape != (N_BATCHES * size, 576) or not np.isfinite(H).all():
            fail(f"hamiltonian serve: output of shape {H.shape}, or not "
                 f"finite")
        H = H.reshape(-1, 24, 24)
        asym = float(np.abs(H - H.transpose(0, 2, 1)).max()
                     / np.abs(H).max())
        print(f"hamiltonian serve, batch {size}: max|H|={np.abs(H).max():.3e}"
              f" asymmetry rel {asym:.3e}")
        if asym > 1e-5:
            fail(f"hamiltonian serve: the matrices are not symmetric "
                 f"(rel {asym:.3e})")
        for name, n in want.items():
            if serve_launches[size][name] != n * N_BATCHES:
                fail(f"hamiltonian serve: {name} launched "
                     f"{serve_launches[size][name]} times, want "
                     f"{n * N_BATCHES}")
        results[size] = res["hamiltonian"]
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = forward_ms(size)
        with torch.no_grad():
            kernel_ms = profile_kernels(
                f"hamiltonian forwards of {size} graphs",
                lambda: [model(gb) for gb in batches[size]], N_BATCHES,
                f"hamiltonian_serve_profile_{size}.txt")
        print(f"hamiltonian serve forward, batch {size}: "
              f"{1e3 * size / fwd_ms:.1f} graphs/s ({fwd_ms:.3f} ms per "
              f"batch, host clock around synchronize, 12 forwards); "
              f"{kernel_ms:.3f} ms of kernels per batch under the profiler:"
              f" device busy share {kernel_ms / fwd_ms:.4f}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    again = forward_ms(H2O_BATCHES[0])
    print(f"hamiltonian serve forward, batch {H2O_BATCHES[0]}, once more "
          f"after the larger batch: {1e3 * H2O_BATCHES[0] / again:.1f} "
          f"graphs/s ({again:.3f} ms per batch)")

    # ---------------------------------------------- CPU plain-path recompute
    small = cut_batch(mols, H2O_CUT)
    cpu_model = build_model(mc, "cpu", torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model(small.to(dev))["hamiltonian"].cpu()
        ref = cpu_model(small)["hamiltonian"]
    first = torch.as_tensor(results[H2O_BATCHES[0]][:H2O_CUT])
    if float((got - first).abs().max()) > TOL * float(first.abs().max()):
        fail(f"the {H2O_CUT}-graph cut disagrees with the batched run")
    rel = worst_rel({"hamiltonian": got}, {"hamiltonian": ref})[0]
    print(f"hamiltonian serve, card vs CPU plain path ({H2O_CUT} graphs): "
          f"rel {rel:.3e}")
    if rel > TOL:
        fail(f"hamiltonian: card and CPU plain path disagree (rel {rel:.3e})")

    del model, batches, results
    train_launches = hamiltonian_train(dev, cfg, cpu_model, n_layers)

    total = {k: sum(serve_launches[s][k] for s in H2O_BATCHES) for k in want}
    # the pairwise backward is one C entry: its three kernels share a count
    entries = (
        ("uvu_conv_bwd", "uvu_conv.cu", "fused_conv.py:278", "uvu_conv_bwd",
         "K6b", "rowmix::gemm_kernel + uvu_bwd_edge_kernel"),
        ("pairwise_tp_bwd_dwsel", "pairwise_tp.cu", "pairwise.py:504",
         "pairwise_tp_bwd", "K5m",
         "pairwise_cg_kernel + rowmix::gemm_kernel (S^T gout)"),
        ("pairwise_tp_bwd_da", "pairwise_tp.cu", "pairwise.py:556",
         "pairwise_tp_bwd", "K5a",
         "rowmix::gemm_kernel (dS) + pairwise_da_kernel"),
        ("pairwise_tp_bwd_dbw", "pairwise_tp.cu", "pairwise.py:591",
         "pairwise_tp_bwd", "K5b",
         "rowmix::gemm_kernel (dS) + pairwise_dbw_kernel"),
    )
    records = [
        dict(kernel_record("uvu_conv", "uvu_conv.cu", "fused_conv.py:233",
                           total["uvu_conv"], k6, *k6_cost),
             train_launches=train_launches["uvu_conv"]),
        dict(kernel_record("pairwise_tp", "pairwise_tp.cu", "pairwise.py:410",
                           total["pairwise_tp"], k5, *k5_cost),
             wrapper_ms=k5["wrapper_ms"], expand_ms=k5["expand_ms"],
             train_launches=train_launches["pairwise_tp"]),
    ]
    for name, source, replaces, counter, key, kernels in entries:
        extra = dict(kernels=kernels)
        if key == "K6b":
            extra["batch16_ms"] = bwd_small[key]["ms"]
        else:
            extra.update(entry_ms=bwd["K5 backward"]["ms"],
                         entry_plain_ms=bwd["K5 backward"]["plain_ms"],
                         batch16_entry_ms=bwd_small["K5 backward"]["ms"])
        records.append(dict(kernel_record(
            name, source, replaces, train_launches[counter], bwd[key],
            *bwd_cost[key]), **extra))
    trunk = {
        "full_conv": dict(bwd["K1"], launches=total["full_conv"],
                          train_launches=train_launches["full_conv"],
                          batch16_ms=bwd_small["K1"]["ms"],
                          **bound(*bwd_cost["K1"])),
        "species_sc": dict(k3, launches=total["species_sc"],
                           train_launches=train_launches["species_sc"]),
        "full_conv_bwd": dict(
            bwd["K2"], launches=train_launches["full_conv_bwd"],
            batch16_ms=bwd_small["K2"]["ms"], **bound(*bwd_cost["K2"])),
        "species_sc_bwd": dict(
            bwd["K3b"], launches=train_launches["species_sc_bwd"],
            batch16_ms=bwd_small["K3b"]["ms"], **bound(*bwd_cost["K3b"])),
    }
    return records, trunk


def hamiltonian_train(dev, cfg, cpu_model, n_layers):
    """Phases 17-18 of the module docstring; returns the launches counted
    over the two training epochs (every counter set to 0 just before
    them)."""
    import torch

    from equivariant_nn_zoo_tpu_torch.models import build_model
    from equivariant_nn_zoo_tpu_torch.run import Loss, Trainer

    mc = cfg["model_config"]
    small_size, big_size = H2O_TRAIN_BATCHES
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    if cfg["batch_size"] != small_size:
        fail(f"the config's batch is {cfg['batch_size']}, not {small_size}")
    labelled = synthetic_h2o(5 * small_size + N_BATCHES * big_size,
                             np.random.default_rng(21), labels=True)
    small = make_batches(labelled[:5 * small_size], dev, small_size)
    train, val = small[:4], small[4:]
    trainer = Trainer(build_model(mc, generator=torch.Generator().manual_seed(
        0)), **settings)
    loss_fn = Loss(settings["loss_coeffs"])

    def fixed_loss():
        with torch.no_grad():
            out = trainer.model(train[0])
            return loss_fn(out.data, train[0].data)[0].item()

    loss_before = fixed_loss()
    n_epochs = 2
    torch.cuda.synchronize()
    reset_head_launches()
    t0 = time.perf_counter()
    for epoch in range(n_epochs):
        trainer.epoch_step(train, val)
        md = trainer.mae_dict
        print(f"hamiltonian train epoch {epoch}: training_loss "
              f"{md['training_loss']} validation_loss "
              f"{md['validation_loss']} validation_hamiltonian_mae "
              f"{md['validation_hamiltonian_mae']} LR {trainer.current_lr}")
        for key in ("training_loss", "validation_loss"):
            if not np.isfinite(md[key]):
                fail(f"hamiltonian train: non-finite {key} in epoch {epoch}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    train_launches = head_launches()
    print(f"hamiltonian train: {n_epochs} epochs of {len(train)} steps + "
          f"{len(val)} validation batch in {dt:.4f} s; launches "
          f"{train_launches}")
    for name, n in train_launches.items():
        if n < 1:
            fail(f"hamiltonian train: {name} was never launched")

    want = {"full_conv": n_layers, "full_conv_bwd": n_layers,
            "species_sc": n_layers, "species_sc_bwd": n_layers,
            "uvu_conv": 1, "uvu_conv_bwd": 1, "pairwise_tp": 2,
            "pairwise_tp_bwd": 2}
    reset_head_launches()
    trainer.batch_step(train[0])
    torch.cuda.synchronize()
    per_step = head_launches()
    print(f"hamiltonian train launches per step: {per_step}")
    if per_step != want:
        fail(f"hamiltonian train: one step launched {per_step}, want {want}")

    big = make_batches(labelled[5 * small_size:], dev, big_size)
    reps = 3
    for size, group, tag in ((small_size, train, ""),
                             (big_size, big, f"_{big_size}")):
        trainer.batch_step(group[0])  # warm-up at this size
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(reps):
            for gb in group:
                trainer.batch_step(gb)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / (reps * len(group))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not np.isfinite(trainer.batch_losses["loss"].item()):
            fail(f"hamiltonian train: non-finite loss at batch {size}")
        kernel_ms = profile_kernels(
            f"hamiltonian training steps of {size} graphs",
            lambda: [trainer.batch_step(gb) for gb in group], len(group),
            f"hamiltonian_step_profile{tag}.txt")
        print(f"hamiltonian train step, batch {size}: {step_ms:.3f} ms per "
              f"step, {1e3 * size / step_ms:.1f} graphs/s (host clock around "
              f"synchronize, {reps * len(group)} steps; N="
              f"{group[0].node_capacity} E={group[0].edge_capacity}); "
              f"{kernel_ms:.3f} ms of kernels per step under the profiler: "
              f"device busy share {kernel_ms / step_ms:.4f}; peak device "
              f"memory {peak:.3f} GiB")
        if size == small_size:
            loss_after = fixed_loss()
            print(f"hamiltonian train: loss on the first training batch "
                  f"{loss_before} before, {loss_after} after "
                  f"{trainer.ema_num_updates} steps")
            if not (np.isfinite(loss_after) and loss_after < loss_before):
                fail("hamiltonian train: the loss on a fixed batch did not "
                     "fall")
    del trainer, small, big, train, val

    # ------------------------------------------- hamiltonian train parity
    cut = cut_batch(labelled, H2O_CUT)
    card_loss, card = step_gradients(
        build_model(mc, dev, torch.Generator().manual_seed(0)), cut.to(dev),
        loss_fn)
    cpu_loss, plain = step_gradients(cpu_model, cut, loss_fn)
    worst, n_noise = worst_gradient_rel(card, plain)
    print(f"hamiltonian train parity ({H2O_CUT} graphs): loss card "
          f"{card_loss} CPU {cpu_loss}; worst gradient rel {worst[0]:.3e} "
          f"({worst[1]}) over {len(plain) - n_noise} tensors, {n_noise} more "
          f"are zero by symmetry on both sides")
    if abs(card_loss - cpu_loss) > TOL * abs(cpu_loss):
        fail("hamiltonian train parity: the loss differs")
    if any(not torch.isfinite(card[n]).all() for n in card):
        fail("hamiltonian train parity: non-finite gradients on the card")
    if worst[0] > TOL:
        fail(f"hamiltonian train parity: {worst[1]} gradient rel "
             f"{worst[0]:.3e} > {TOL}")
    return train_launches


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
    from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
    from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as conv_ops
    from equivariant_nn_zoo_tpu_torch.ops.cuda import row_mix as rm_ops
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
    order = edge_order.shared(*k1_args[5:8])
    k2_args = (x1g, erg, *k1_args[4:7], *flat, x1g.shape[0], scratch, gout)
    k2 = compare_grads(
        "K2 full_conv_bwd",
        lambda: conv_ops.launch_backward(fconv, *k2_args, order=order),
        lambda: fconv.plain_backward(*k2_args),
        ("dx", "d edge_radial", "dw_hidden", "dw_out", "dwsel"))
    mix_fwd, mix_bwd = row_mix_phase(fconv, scratch, flat[2], gout)
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

    costs = trunk_costs(conv, x1, er, k1_args[4:7], flat,
                        data["input_features"], data["node_attrs"], tables,
                        spec, g3)

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
    rm_ops.reset_launches()
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
    mix_launches = rm_ops.launches()
    print(f"train: the mix GEMM launched {mix_launches}")
    if min(mix_launches.values()) < 1:
        fail(f"train: the mix GEMM was not launched ({mix_launches})")

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
    kernel_ms = profile_kernels(
        "energy training steps",
        lambda: [trainer.batch_step(gb) for gb in train], len(train),
        "energy_step_profile.txt")
    print(f"train step: {kernel_ms:.3f} ms of kernels per step under the "
          f"profiler: device busy share {kernel_ms / step_ms:.4f}")
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
    head_records, l4 = hamiltonian_phases(dev)

    # K1, K3, K2 and K3b also carry what they did on the hamiltonian path
    # (l = 4)
    kernels = [
        dict(kernel_record("full_conv", "full_conv.cu", "fused_conv.py:926",
                           launches["full_conv"], k1, *costs["K1"]),
             hamiltonian=l4["full_conv"]),
        dict(kernel_record("species_sc", "species_sc.cu", "sc.py:181",
                           launches["species_sc"], k3, *costs["K3"]),
             hamiltonian=l4["species_sc"]),
        dict(kernel_record("full_conv_bwd", "full_conv_bwd.cu",
                           "fused_conv.py:1051",
                           train_launches["full_conv_bwd"], k2,
                           *costs["K2"]),
             hamiltonian=l4["full_conv_bwd"]),
        dict(kernel_record("species_sc_bwd", "species_sc.cu", "sc.py:208",
                           train_launches["species_sc_bwd"], k3b,
                           *costs["K3b"]),
             hamiltonian=l4["species_sc_bwd"]),
        *force_records,
        *head_records,
        mix_record("row_mix_forward", "fused_conv.py:926",
                   mix_launches["forward"], mix_fwd),
        mix_record("row_mix_products", "pairwise.py:504",
                   mix_launches["backward"], mix_bwd),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def kernel_split(fn, n=6):
    """Device ms per call of each kernel that ``fn`` launches, by name
    (``torch.profiler`` over ``n`` calls after a warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            key = e.key.removeprefix("void ").replace(
                "(anonymous namespace)::", "")
            name = re.match(r"[\w:]*", key).group(0).split("::")[-1] or key
            split[name] = split.get(name, 0.0) + us / 1e3 / n
    return {k: round(v, 4) for k, v in
            sorted(split.items(), key=lambda kv: -kv[1])}


def conv_times():
    """``python3 chip_smoke.py --conv-times``: K1 and K2 of the package in
    the current directory (run it from two checkouts in turn to compare them
    on one card), ms per call with CUDA events at ``config_energy``'s hot
    layer (the first 128-graph batch of phase 7) and at the l = 4 hot layer
    of a 512- and a 16-molecule batch (phases 14-16), each C entry through
    ``launch_forward`` / ``launch_backward``, with each kernel's device ms
    per call (``kernel_split``); one JSON line.  K2 gets the forward's edge
    order where the package has one."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    import equivariant_nn_zoo_tpu_torch as pkg
    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as conv_ops

    try:
        from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
    except ImportError:
        edge_order = None
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    energy = synthetic_qm9(N_BATCHES * BATCH, np.random.default_rng(0))
    water = synthetic_h2o(N_BATCHES * max(H2O_BATCHES),
                          np.random.default_rng(20))
    cases = (("energy", "config_energy", energy, BATCH),
             ("l4_3072", "config_hamiltonian", water, max(H2O_BATCHES)),
             ("l4_96", "config_hamiltonian", water, min(H2O_BATCHES)))
    times, models = {}, {}
    for key, name, mols, size in cases:
        if name not in models:
            models[name] = build_model(get_config(name)["model_config"], dev,
                                       torch.Generator().manual_seed(0))
        model = models[name]
        gb = make_batches(mols[:N_BATCHES * size], dev, size)[0]
        conv = getattr(model, HOT_LAYER).conv
        fconv, seen = conv.full_conv, {}
        hook = conv.register_forward_pre_hook(
            lambda mod, args: seen.update(data=args[0]))
        with torch.no_grad():
            model(gb)
            hook.remove()
            data = seen["data"]
            x1 = conv.linear_1(data["input_features"])
            er = data["edge_radial"] * data["_edge_mask"]
            pre = 1.0 / conv.avg_num_neighbors ** 0.5
            edges = (data["edge_spherical"], data["edge_index"][0],
                     data["edge_index"][1])
            N = x1.shape[0]
            flat = [t.detach() for t in fconv.flat_weights(
                conv.fc, conv.tp.linear, pre)]
            kw = {} if edge_order is None else {
                "order": edge_order.shared(edges[1], edges[2], N)}
            _, scratch = conv_ops.launch_forward(fconv, x1, er, *edges, *flat,
                                                 N, **kw)
            gout = torch.randn(N, fconv.out_dim, generator=torch.Generator(
            ).manual_seed(1)).to(dev)

            def k1():
                return conv_ops.launch_forward(fconv, x1, er, *edges, *flat,
                                               N, **kw)

            def k2():
                return conv_ops.launch_backward(fconv, x1, er, *edges, *flat,
                                                N, scratch, gout, **kw)

            rec = {"K1_ms": cuda_ms(k1), "K2_ms": cuda_ms(k2), "N": N,
                   "E": int(er.shape[0]), "K1_kernels": kernel_split(k1),
                   "K2_kernels": kernel_split(k2)}
        times[key] = rec
        print(f"{key}: N={N} E={rec['E']} K1 {rec['K1_ms']:.4f} ms "
              f"{rec['K1_kernels']}, K2 {rec['K2_ms']:.4f} ms "
              f"{rec['K2_kernels']}")
    print(json.dumps({"package": os.path.dirname(pkg.__file__),
                      "card": torch.cuda.get_device_name(0),
                      "conv_times": times}))


# the kernels of the mix GEMM's family in kernel_split's names: the
# redesigned GEMM, its split reduction and gout's component-major copy,
# and the earlier tiled kernels (a parent checkout's)
MIX_KERNELS = ("gemm_kernel", "reduce_kernel", "deinterleave_kernel",
               "tile_gemm_kernel", "mix_rows_kernel")


def mix_set(name, fn, library, flops, n_bytes):
    """One product set of ``--mix-times``: the C entry's ms (CUDA events),
    each kernel's device ms, the mix GEMM family's and the memsets' share,
    torch.matmul's ms on the products' operands, and the bounds."""
    split = kernel_split(fn)
    rec = dict(ms=cuda_ms(fn), kernels=split,
               products_ms=round(sum(v for k, v in split.items()
                                     if k in MIX_KERNELS), 4),
               memset_ms=round(sum(v for k, v in split.items()
                                   if "emset" in k), 4),
               library_ms=cuda_ms(library), gflop=flops / 1e9,
               mbytes=n_bytes / 1e6, **mix_bound(flops, n_bytes))
    print(f"{name}: entry {rec['ms']:.4f} ms, products {rec['products_ms']} "
          f"ms, memsets {rec['memset_ms']} ms, torch.matmul "
          f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by "
          f"{rec['bound_by']} (float32 {rec['bound_f32_ms']:.4f}); {split}",
          flush=True)
    return rec


def mix_times():
    """``python3 chip_smoke.py --mix-times``: the product sets of the mix
    GEMM (``csrc/row_mix.cuh``) in the package of the current directory
    (run it from two checkouts in turn to compare them on one card), each
    through its C entry at full width, ms per call with CUDA events and
    each kernel's device ms (``kernel_split``):

    - K2 at ``config_energy``'s hot layer (its node-stage products and its
      radial-MLP stage);
    - the K5 backward entry and the K5 forward (with its mix) on the
      ``tp_off`` call of a 512-molecule ``config_hamiltonian`` batch
      (M = 3072), and K6b on its 3072 edges;
    - the energy training step's kernel ms (``torch.profiler``, 2 passes
      of 4 steps) and host ms.

    Beside each product set, ``library_ms``: one ``torch.matmul`` per
    product (TF32 off) on contiguous copies of operands of the same shapes
    (the copies are made before the timing), and the bounds of the
    products alone (``mix_bound``).  One JSON line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    import equivariant_nn_zoo_tpu_torch as pkg
    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as conv_ops
    from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as k5_ops
    from equivariant_nn_zoo_tpu_torch.ops.cuda import uvu_conv as k6_ops
    from equivariant_nn_zoo_tpu_torch.run import Trainer

    try:
        from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
    except ImportError:
        edge_order = None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g)

    sets = {}
    # ------------------------------------------- K2 at the energy hot layer
    mc = get_config("config_energy")["model_config"]
    model = build_model(mc, dev, torch.Generator().manual_seed(0))
    gb = make_batches(synthetic_qm9(BATCH, np.random.default_rng(0)), dev)[0]
    conv = getattr(model, HOT_LAYER).conv
    fconv, seen = conv.full_conv, {}
    hook = conv.register_forward_pre_hook(
        lambda mod, args: seen.update(data=args[0]))
    with torch.no_grad():
        model(gb)
        hook.remove()
        data = seen["data"]
        x1 = conv.linear_1(data["input_features"])
        er = data["edge_radial"] * data["_edge_mask"]
        edges = (data["edge_spherical"], data["edge_index"][0],
                 data["edge_index"][1])
        N, E = x1.shape[0], er.shape[0]
        flat = [t.detach() for t in fconv.flat_weights(
            conv.fc, conv.tp.linear, 1.0 / conv.avg_num_neighbors ** 0.5)]
        kw = {} if edge_order is None else {
            "order": edge_order.shared(edges[1], edges[2], N)}
        _, scratch = conv_ops.launch_forward(fconv, x1, er, *edges, *flat, N,
                                             **kw)
        gout = rnd(N, fconv.out_dim)
        dims = fconv.fc_dims
        R, H, PC = dims[0], dims[1], dims[-1]
        # the radial-MLP stage's operands: per layer (a_in^T, dz) and
        # (dz, W_i^T), the last layer (h^T, dw) and (dw, W_out^T)
        pairs = [(rnd(H, E), rnd(E, PC)), (rnd(E, PC), flat[1].T.contiguous())]
        ofs, mlp_flops = 0, 2 * 2 * E * H * PC
        mlp_bytes = 4 * (2 * E * H + E * PC + 2 * H * PC)
        for i in range(len(dims) - 2):
            fan = R if i == 0 else H
            W = flat[0][ofs: ofs + fan * H].reshape(fan, H)
            pairs += [(rnd(fan, E), rnd(E, H)), (rnd(E, H), W.T.contiguous())]
            ofs += fan * H
            mlp_flops += 2 * 2 * E * fan * H
            mlp_bytes += 4 * (2 * E * fan + E * H + 2 * fan * H)
        ops = mix_operands(fconv.prob_rows, scratch, flat[2], gout)

        def library():
            library_backward(ops)
            return [torch.matmul(a, b) for a, b in pairs]

        sets["K2_energy"] = mix_set(
            f"K2 energy {HOT_LAYER} (N={N}, E={E})",
            lambda: conv_ops.launch_backward(fconv, x1, er, *edges, *flat, N,
                                             scratch, gout, **kw),
            library, 2 * mix_flops(fconv.prob_rows, N) + mlp_flops,
            nbytes(scratch, gout, flat[2]) + N * fconv.KM * 4
            + fconv.wsel_len * 4 + mlp_bytes)
        sets["K2_energy"].update(N=N, E=E)
        del ops, pairs, scratch

    # --------------------------------------- the hamiltonian head at 3072
    hmodel = build_model(get_config("config_hamiltonian")["model_config"],
                         dev, torch.Generator().manual_seed(0))
    hmodel.eval()
    size = max(H2O_BATCHES)
    big = make_batches(synthetic_h2o(size, np.random.default_rng(20)), dev,
                       size)[0]
    seen = capture_head_inputs(hmodel, big)
    head = hmodel.pairwise
    tpk, uvu = head.pairwise_tp, head.conv.full_conv
    with torch.no_grad():
        tpe, left, right = seen["K5"][0]
        M = left.shape[0]
        bw = tpk.weighted_right(tpe.tp.weight, right)
        wsel5 = tpk.flat_wsel(tpe.linear)
        g5 = rnd(M, tpk.out_dim)
        S5 = rnd(M, tpk.KM)
        ops = mix_operands(tpk.prob_rows, S5, wsel5, g5)
        f5 = mix_flops(tpk.prob_rows, M)
        sets["K5_backward"] = mix_set(
            f"K5 backward entry (M={M})",
            lambda: k5_ops.launch_backward(tpk, left, bw, wsel5, g5),
            lambda: library_backward(ops), 2 * f5,
            nbytes(S5, g5, wsel5) + M * tpk.KM * 4 + tpk.wsel_len * 4)
        sets["K5_forward"] = mix_set(
            f"K5 forward with its mix (M={M})",
            lambda: k5_ops.launch_forward(tpk, left, bw, wsel5),
            lambda: library_forward(ops), f5,
            nbytes(S5, wsel5) + M * tpk.out_dim * 4)
        del ops, S5, bw
        linear, x, sh, w, src = seen["K6"][0]
        E6 = sh.shape[0]
        wsel6 = uvu.flat_wsel(linear)
        _, scratch6 = k6_ops.launch_forward(uvu, x, sh, w, wsel6, src)
        g6 = rnd(E6, uvu.out_dim)
        ops = mix_operands(uvu.prob_rows, scratch6, wsel6, g6)
        sets["K6b"] = mix_set(
            f"K6b (E={E6})",
            lambda: k6_ops.launch_backward(uvu, x, sh, w, wsel6, src,
                                           scratch6, g6),
            lambda: library_backward(ops), 2 * mix_flops(uvu.prob_rows, E6),
            nbytes(scratch6, g6, wsel6) + E6 * uvu.KM * 4 + uvu.wsel_len * 4)
        del ops, scratch6, seen
    del hmodel

    # ------------------------------------------------- the energy step
    cfg = get_config("config_energy")
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    train = make_batches(synthetic_qm9(4 * BATCH, np.random.default_rng(11),
                                       labels=True), dev)
    trainer = Trainer(build_model(mc, dev, torch.Generator().manual_seed(0)),
                      **settings)

    def steps():
        for b in train:
            trainer.batch_step(b)

    steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        steps()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / (3 * len(train))
    split = kernel_split(steps, n=2)
    sets["energy_step"] = dict(
        host_ms=host_ms, kernel_ms=sum(split.values()) / len(train),
        products_ms=sum(v for k, v in split.items() if k in MIX_KERNELS)
        / len(train))
    print(f"energy step: host {host_ms:.3f} ms, kernels "
          f"{sets['energy_step']['kernel_ms']:.3f} ms, mix GEMM family "
          f"{sets['energy_step']['products_ms']:.3f} ms per step", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"package": os.path.dirname(pkg.__file__),
                      "card": smi.stdout.strip(), "mix_times": sets}))


# the walk ablation: each part of both walk kernels as the (pattern,
# replacement) that leaves it out of their sources, and the variants timed,
# as (label, parts left out); a variant computes wrong results and is only
# timed
WALK_PARTS = {
    "radial weights": (r"\n *radial_weights\(st, [^;]*;", ""),
    "CG matrices": (r"\n *cg_matrices<kRows>\(st, [^;]*;", ""),
    "per-edge products": (r"for \(int q = 0; q < nq; \+\+q\)",
                          "for (int q = 0; q < 0; ++q)"),
}
WALK_ABLATIONS = (
    ("without the radial weights", ["radial weights"]),
    ("without the CG matrices", ["CG matrices"]),
    ("without the per-edge products", ["per-edge products"]),
    ("staging only", list(WALK_PARTS)),
)


def walk_ablation():
    """``python3 chip_smoke.py --walk-ablation``: where the time of the walk
    kernels (K1, K2; ``csrc/edge_walk.cuh``) goes, without a profiler that
    reads the card's counters: copies of the package in
    ``build/walk_ablation/`` (gitignored) each leave out parts of both
    walks (``WALK_ABLATIONS``), and ``--conv-times`` times each copy after
    the package itself.  A part costs about the time that its absence
    saves."""
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(root, "equivariant_nn_zoo_tpu_torch")
    runs = [("package as it is", root)]
    for i, (label, parts) in enumerate(WALK_ABLATIONS):
        dest = os.path.join(root, "build", "walk_ablation", str(i))
        shutil.rmtree(dest, ignore_errors=True)
        shutil.copytree(pkg, os.path.join(dest, os.path.basename(pkg)),
                        ignore=shutil.ignore_patterns("__pycache__"))
        for src in ("full_conv.cu", "full_conv_bwd.cu"):
            path = os.path.join(dest, os.path.basename(pkg), "csrc", src)
            with open(path) as f:
                text = f.read()
            for part in parts:
                text, n = re.subn(*WALK_PARTS[part], text)
                if n != 1:
                    fail(f"walk ablation: '{part}' matched {n} times in {src}")
            with open(path, "w") as f:
                f.write(text)
        runs.append((label, dest))
    for label, cwd in runs:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--conv-times"], cwd=cwd, capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            fail(f"walk ablation, {label}:\n{res.stdout}{res.stderr}")
        for line in res.stdout.splitlines()[:-1]:
            print(f"{label}: {line}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--conv-times"]:
        sys.path.insert(0, os.getcwd())
        conv_times()
    elif sys.argv[1:] == ["--mix-times"]:
        sys.path.insert(0, os.getcwd())
        mix_times()
    elif sys.argv[1:] == ["--walk-ablation"]:
        walk_ablation()
    else:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        main()
