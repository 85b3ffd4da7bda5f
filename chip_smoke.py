#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --conv-times     # K1 and K2 alone, see conv_times
    python3 chip_smoke.py --walk-ablation [source.cu ...]
                                           # the walks', K3/K3b's and the
                                           # K5 kernels' parts, see
                                           # walk_ablation
    python3 chip_smoke.py --mix-times      # the mix GEMM's product sets,
                                           # see mix_times
    python3 chip_smoke.py --sc-times       # K3 and K3b alone and the
                                           # energy step, see sc_times
    python3 chip_smoke.py --sc-calls       # K3 and K3b alone
    python3 chip_smoke.py --ext-times      # K4f, K4b, K4g alone and the
                                           # force step, see ext_times
    python3 chip_smoke.py --ext-calls      # K4f, K4b, K4g alone
    python3 chip_smoke.py --pw-times       # the K5 forward and backward
                                           # entries alone, hamiltonian
                                           # serving and the step, see
                                           # pw_times
    python3 chip_smoke.py --pw-calls       # the two K5 entries alone
    python3 chip_smoke.py --uvu-times      # the K6 and K6b entries alone,
                                           # hamiltonian serving and the
                                           # step, see uvu_times
    python3 chip_smoke.py --uvu-calls      # the two K6 entries alone
    python3 chip_smoke.py --diffusion      # phases 19-21 alone
    python3 chip_smoke.py --dipole         # phases 22-25 alone
    python3 chip_smoke.py --protein        # phases 26-28 alone

Phases, in order; any failure exits non-zero before the last line:

1. device  — requires CUDA; prints the card's name and power limit;
2. build   — compiles the kernels from ``csrc/`` and prints ``ptxas`` lines;
3. K1      — the whole-convolution kernel against its plain PyTorch version
             on the card, at ``config_energy``'s hot-layer shapes (layer3 of
             a 128-graph synthetic QM9-like batch);
4. K3      — the species self-connection kernel, likewise, on the species
             order; its output must repeat bit for bit over two launches;
5. K2      — the convolution's backward kernel against the plain backward
             (autograd of the plain forward) on K1's saved scratch and a
             seeded cotangent: dx, d edge_radial, dW (MLP) and dwsel; K1
             and K2 walk one edge order, built once as on the main path;
6. K3b     — the self-connection's backward kernel (dx, dtables), likewise,
             on the same order; dx and dtables must repeat bit for bit;
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
             (on K4f's saved scratch, as the main path calls it, and with
             the scratch recomputed, as the pairing rule calls it) and its
             one-pass second-order backward against their plain versions,
             at ``config_energy_force``'s hot-layer shapes (layer3 of a
             64-graph synthetic protein-fragment batch) with seeded
             cotangents, on one edge order; every output of each must
             repeat bit for bit over two launches;
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
             K5's and K6's outputs must repeat bit for bit over two
             launches; then
             K3 against plain at the trunk's hot layer, whose irreps
             reach l = 4, and repeated bit for bit;
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
             49 node rows; there K5 and K6 too, repeated bit for bit); K6b
             walks the edges' source-major order; the
             pairwise backward is one entry, so each of its three kernels
             (dwsel, d left, dbw) is also launched, checked and timed
             alone at 3072; the four outputs of K6b, the pairwise
             backward's three and K3b's dx and dtables must repeat bit for
             bit;
17. hamiltonian train — a ``run.Trainer`` with ``config_hamiltonian``'s
             own settings (loss 1e5 * MSE on ``hamiltonian``, Adam lr 1e-2,
             EMA 0.99 with num_updates, ReduceLROnPlateau patience 8 factor
             0.8, batch 16) runs 2 epochs over 4 training batches and 1
             validation batch of synthetic H2O with seeded N(0, 1) targets
             ``[G, 576]``; one step must launch exactly 5 K1, 5 K2, 5 K3,
             5 K3b, 1 K6, 1 K6b, 2 K5 and 2 K5 backward entries; then 12
             timed steps at batch 16 and at batch 128 (ms per step,
             graphs/s, peak memory, device busy share); the loss on a fixed
             batch must be finite and lower after the steps; then K6 and
             K6b against their plain versions at batch 128's 768 edges,
             repeated bit for bit;
18. hamiltonian train parity — one step's gradient of every parameter on
             a 16-molecule cut, card against the CPU plain path;
19. diffusion serve — full-width ``config_diffusion`` (seeded weights,
             ``build_model`` with no device argument), spec ``""`` (a
             direct score head), then ``"nll"`` (the score is the position
             gradient of an energy): K1 and K2 (``""``), or K4f, K4b and
             K4g (``"nll"``), against their plain versions at the hot
             layer (``layer2``) of a batch of 128 synthetic
             fully-connected molecules (as ``bench.py`` makes them; about
             1,730 atoms and 23,000 edges) at t = 0.5, each K4 output
             repeated bit for bit; then ``run.sde_sampling``'s PC sampler
             (``get_sampling_fn`` on ``models/sde_config.py``'s settings:
             Euler-Maruyama, Langevin snr 0.16, one corrector step, VP-SDE
             beta 0.1-20, N = 1000) samples that batch: every counter set
             to 0 just before and read just after; K1 (``""``), K4f and K4b
             (``"nll"``) must launch at least once per layer and score
             evaluation (2 x N evaluations), K3 and K3b never; the
             positions must be finite; seconds per batch, molecules/s, ms
             and launches per evaluation and the device busy share (a
             profile of 5 sampler steps); on a 16-molecule cut, with the
             same replayed noise, the first 10 sampler steps must match the
             CPU plain path;
20. diffusion train — ``run.sde_utils.get_step_fn`` with the config's
             settings (Adam lr 1e-2, clip 1.0, grad_acc 1, EMA 0.9999 with
             num_updates, ``reduce_mean``) on 4 batches of 128: one step
             must launch K1 and K2 once per layer (``""``), K4f and K4b at
             least once per layer and K4g once per layer but the first
             (``"nll"``: layer 0's input features do not depend on the
             positions, so its second backward takes the pairing rule), K3
             and K3b never; then 12 timed steps (ms per step, graphs/s,
             peak memory, busy share), finite losses, and one evaluation
             step with the EMA model;
21. diffusion train parity — one step's gradient of every parameter on a
             16-molecule cut, card against the CPU plain path, on the same
             replayed t and z, for both specs;
22. dipole kernels — K1, K3, K2 and K3b against their plain versions at
             the hot layer (``layer3``) of full-width ``config_dipole``
             (n_dim 32, l_max 2, 5 layers, 18 species tables) on the first
             of 4 batches of 256 synthetic molecules (as ``bench.py`` makes
             them: 8-23 atoms, N(0, 1.4^2) positions, r_max 5; about 4,000
             atoms and 50,000 edges), per output; K3's and K3b's outputs
             repeated bit for bit;
23. dipole serve — ``build_model`` with no device argument serves the 4
             batches through ``inference.evaluate``: exactly one K1 and one
             K3 launch per layer and batch, finite per-atom dipoles, and a
             32-molecule cut against the CPU plain path;
24. dipole train — the trainer path end to end: an in-memory
             ``CondensedDataset`` of 1,280 molecules with the config's
             preprocess (the radius graph) and settings, ``Trainer`` with a
             workdir (``chiprun_out/dipole_wd``), ``set_dataset`` (1,024
             training and 256 validation molecules, the loader's pinned host
             batches copied on a side stream) and ``train()`` for 2 epochs:
             K1, K2, K3 and K3b each at least ``num_layers x steps``
             launches, finite losses, ``best.pt``, ``last.pt`` and
             ``trainer.pt`` written; ``Trainer.from_file`` refuses the
             stopped run, and with ``max_epochs`` 3 restores parameters,
             EMA and Adam's state bit for bit and trains the third epoch;
             ms per step through the trainer path (loader included) beside
             12 steps on batches already on the card, the busy share, peak
             memory and a profile; ``grad_acc`` 2 applies every second
             step;
25. dipole train parity — one step's gradient of every parameter on a
             32-molecule cut (N(0, 1) dipoles), card against the CPU plain
             path;
26. protein kernels — K1 and K2 at the hot layer (``layer3``) of
             full-width ``config_diffusion_CA`` (n_dim 64, l_max 2, 30
             paths, 32-wide radial inputs, 3 hidden layers of 64) on a
             batch of 4 synthetic globular proteins of 420-559 residues
             through the config's preprocess (``masked2indexed``, ``crop``
             to 384), N = 1,537, at t = 0.5 on the edges the model builds
             in its buffer of 262,144: each against its plain version per
             output and repeated bit for bit, with ms, the bound and its
             share, and the live and padded edges;
27. protein sampling — ``config_diffusion_CA``, then
             ``config_diffusion_backbone`` (seeded weights, ``build_model``
             with no device argument, full width and depth) sample that
             batch, scaled by the config's scaler, by the PC sampler
             (``sde_config``'s predictor and corrector, snr 0.16) at N =
             50 (cut from 1,000): every counter set to 0 just before and
             read just after, exactly 8 K1 per score evaluation and no
             other kernel; the edge overflow of every evaluation is 0 (kept
             on the card, read after the loop); finite positions of every
             diffusion key, inverse-scaled and written by ``saveProtein``
             to ``chiprun_out/sample_<config>.pdb``; ms and launches per
             evaluation, kernel ms by family, busy, peak memory; on a cut
             (1 protein of at most 128 residues, 8,192 edges), on replayed
             noise and edge draws, the first 10 sampler steps match the CPU
             plain path;
28. protein train — ``run.sde_utils.get_step_fn`` with each config's own
             settings (Adam lr 1e-2, grad_acc 4, clip 1.0, EMA 0.99 with
             num_updates) on the batch: one micro-step launches exactly 8
             K1 and 8 K2, Adam steps on every 4th, 12 timed micro-steps
             (ms per micro-step and per applied step, peak memory, busy);
             one micro-step's loss and gradients on the cut (the same t, z
             and ``_edge_rand`` on both sides), card against the CPU plain
             path.

Phase 8 traces 4 energy training steps with ``torch.profiler`` and writes
their kernel-time table to ``chiprun_out/energy_step_profile.txt``; phase
12 does the same for 4 force training steps
(``chiprun_out/force_step_profile.txt``);
phase 15 does the same for 4 serving forwards at each batch size
(``chiprun_out/hamiltonian_serve_profile_{16,512}.txt``) and phase 17 for 4
training steps at each batch size
(``chiprun_out/hamiltonian_step_profile{,_128}.txt``); phase 19 traces 5
sampler steps of each spec
(``chiprun_out/diffusion_serve_profile{,_nll}.txt``) and phase 20 4
training steps of each (``chiprun_out/diffusion_step_profile{,_nll}.txt``);
phase 24 traces 4 dipole training steps
(``chiprun_out/dipole_step_profile.txt``).

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


def digest(out):
    """A short hash of the bytes of a tensor or of a tuple of them (None
    skipped): two checkouts' outputs on the same inputs compare by it."""
    import hashlib

    h = hashlib.sha1()
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if t is not None:
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def repeats(name, fn):
    """Fail unless every output of ``fn`` (a tensor or a tuple of them)
    repeats bit for bit over two launches."""
    import torch

    with torch.no_grad():
        a, b = fn(), fn()
        torch.cuda.synchronize()
    a, b = ((a,), (b,)) if isinstance(a, torch.Tensor) else (a, b)
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        fail(f"{name}: outputs differ between two launches")
    print(f"{name}: every output repeats bit for bit")


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


def conv_costs(conv, x1, er, edges, flat):
    """Operations and bytes of K1 and K2 at one layer's shapes: ``x1`` the
    conv's input, ``er`` the masked radial basis, ``edges`` (sh, src,
    dst), ``flat`` the kernels' flat weights."""
    fconv = conv.full_conv
    N0, E0 = x1.shape[0], er.shape[0]
    cc = conv_counts(fconv, N0, E0)
    dims = fconv.fc_dims
    mlp = 2 * E0 * sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    out_bytes = N0 * fconv.out_dim * 4
    return {
        "K1": (mlp + cc["cg"] + 2 * cc["rows"] + cc["mix"],
               nbytes(x1, er, *edges, *flat) + out_bytes),
        "K2": (3 * mlp + 2 * cc["cg"] + 2 * cc["rows"] + 2 * cc["mix"],
               2 * nbytes(x1, er, *flat) + nbytes(*edges)
               + N0 * fconv.KM * 4 + out_bytes),
    }


def trunk_costs(conv, x1, er, edges, flat, x_in, attrs, tables, spec, g3):
    """``conv_costs`` and the self-connection's (K3, K3b): ``x_in`` /
    ``attrs`` / ``tables`` / ``spec`` / ``g3`` are its operands."""
    return {**conv_costs(conv, x1, er, edges, flat),
            **sc_costs(conv, x_in, attrs, tables, spec, g3)}


def sc_costs(conv, x_in, attrs, tables, spec, g3):
    """Operations and bytes of K3 (with its tables' operands: attrs and the
    weight) and K3b (x, tables and g read; dx and dtables written) at one
    layer's shapes."""
    ssc, N0 = conv.species_sc, x_in.shape[0]
    items = ssc.bwd_item_table.cpu().numpy().reshape(-1, 6).astype(np.int64)
    sc_flops = 2 * N0 * int((items[:, 1] * items[:, 4] * items[:, 5]).sum())
    return {
        "K3": (sc_flops, nbytes(x_in, attrs, spec, conv.sc.weight)
               + N0 * ssc.irreps_out.dim * 4),
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


def fused_bound(cg_flops, mix_flops_, n_bytes):
    """Bounds of the fused K5 and K5m: the CG sweep's operations on the
    f32 CUDA cores, the mix's three TF32 products per product on the
    tensor cores (they may overlap: the larger), or bytes; the float32
    bound of every operation on the CUDA cores beside it, as the other
    kernels' records count."""
    t_ops = max(cg_flops / PEAK_FLOPS, 3 * mix_flops_ / PEAK_TF32)
    t_mem = n_bytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_mem),
                bound_by="operations" if t_ops >= t_mem else "bytes",
                bound_f32_ms=1e3 * max((cg_flops + mix_flops_) / PEAK_FLOPS,
                                       t_mem))


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
    ("K4 walks (ext_dst_walk_kernel, ext_src_walk_kernel, "
     "ext_chunk_sum_kernel)", "ext_"),
    ("K5 and K5m fused (pairwise_fwd_kernel, pairwise_dws_kernel, "
     "pairwise_chunk_sum_kernel)", r"pairwise_(fwd|dws|chunk_sum)_kernel"),
    ("a parent's K5 CG sweep (pairwise_cg_kernel; its mix and dwsel are "
     "in the GEMM families)", "pairwise_cg_kernel"),
    ("forward mix (rowmix::gemm_kernel<true, false>: K1's; a parent's K6 "
     "mix too)", r"gemm_kernel<true, false>|mix_rows_kernel"),
    ("backward's tiled products (rowmix::gemm_kernel, its split sum and "
     "gout's copy: K2's, the K5 backward's dS; a parent's K6b dS and dwsel "
     "too)", r"rowmix::"),
    ("Adam (profiler range)", r"Optimizer\.step"),
    ("K1 edge walk (k1_walk_kernel)", "k1_walk_kernel"),
    ("the walks' radial hidden layers (K1/K2), piece sums, dx sums",
     "mlp_hidden_kernel|walk_piece_sum_kernel|walk_dx_kernel"),
    ("K5 adjoint sweep (pairwise_adj_kernel, pairwise_da_sum_kernel)",
     "pairwise_"),
    ("K6 and K6b (uvu_fwd_kernel, uvu_dws_kernel, uvu_adj_kernel, their "
     "ordered sums; a parent's sweeps)", "uvu_"),
    ("K3 and K3b", r"species_sc|table_product_kernel|table_grad"),
    ("sorts and index backward", "RadixSort|indexing_backward|cub::"),
    ("cuBLAS and CUTLASS products", "cublas|cutlass|gemm|gemv|splitK"),
    ("other PyTorch kernels, copies, memsets", "."),
)


def kernel_rows(run):
    """``torch.profiler`` over ``run()``: ``(rows, families, span)``, the
    kernels' (ms, launches, name) from the most time down, the same summed
    by ``PROFILE_FAMILIES`` label as {label: [ms, launches]}, and the
    profiled span in s."""
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
    families = {}
    for ms, n, name in rows:
        label = next(lab for lab, pat in PROFILE_FAMILIES
                     if re.search(pat, name))
        fam = families.setdefault(label, [0.0, 0])
        fam[0] += ms
        fam[1] += n
    return rows, families, span


def families(run, n):
    """``torch.profiler`` over ``run()`` (``n`` steps or batches): kernel
    ms and launches per item, and ms per item by ``PROFILE_FAMILIES``
    label."""
    rows, fams, _ = kernel_rows(run)
    return (round(sum(r[0] for r in rows) / n, 4),
            round(sum(r[1] for r in rows) / n, 1),
            {k: round(v[0] / n, 4) for k, v in sorted(
                fams.items(), key=lambda kv: -kv[1][0])})


def profile_kernels(what, run, n_items, filename):
    """``torch.profiler`` over ``run()`` (``n_items`` steps or batches):
    kernel time by name, written to ``<filename>`` in the output directory
    (see below); returns the kernel time per item in ms (the span itself
    is stretched by the profiler, so a busy share is taken against an
    unprofiled run)."""
    rows, families, span = kernel_rows(run)
    total = sum(r[0] for r in rows)
    lines = [f"{n_items} {what}: kernel time {total:.3f} ms "
             f"({total / n_items:.3f} ms each, "
             f"{sum(r[1] for r in rows) / n_items:.0f} launches each) over a "
             f"{1e3 * span:.3f} ms profiled span"]
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


def force_hot_layer(model, gb, dev, layer=HOT_LAYER):
    """The K4 kernels' operands at ``layer`` of ``model`` (a force head) on
    ``gb``, and seeded cotangents: ``(fc, (x, sh, w, wsel, src, dst, N, cx,
    csh, cw, gout))``."""
    import torch

    conv = getattr(model.func, layer).conv
    seen = {}
    hook = conv.register_forward_pre_hook(
        lambda mod, args: seen.update(data=args[0]))
    with torch.no_grad():
        model(gb)
    hook.remove()
    data = {k: v.detach() for k, v in seen["data"].items()}
    fc = conv.full_conv
    with torch.no_grad():
        x = conv.linear_1(data["input_features"])
        w = conv.fc(data["edge_radial"] * data["_edge_mask"])
        wsel = fc.flat_wsel(conv.tp.linear, conv.avg_num_neighbors ** -0.5)
    sh = data["edge_spherical"]
    src, dst = data["edge_index"][0], data["edge_index"][1]
    N = x.shape[0]
    gen = torch.Generator().manual_seed(4)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    cx, csh, cw = rnd(*x.shape), rnd(*sh.shape), rnd(*w.shape)
    gout = rnd(N, fc.out_dim)
    print(f"force hot layer {layer}: N={N} E={sh.shape[0]} "
          f"in={fc.fused.irreps_in} K={fc.fused.K_dim} paths={fc.n_paths} "
          f"P*mul={fc.fused.weight_numel} out_dim={fc.out_dim}")
    return fc, (x, sh, w, wsel, src, dst, N, cx, csh, cw, gout)


def ext_checks(fc, ops, tag):
    """K4f, K4b (on K4f's saved scratch and recomputed) and K4g against
    their plain versions on ``ops`` (``force_hot_layer``'s), on one edge
    order, each repeated bit for bit; ``tag`` names the path in the
    printed lines.  Returns the four records and their costs."""
    import torch

    from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
    from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv_ext as ext

    x, sh, w, wsel, src, dst, N, cx, csh, cw, gout = ops
    E = sh.shape[0]
    fa = (x, sh, w, wsel, src, dst, N)
    ga = (x, cx, sh, csh, w, cw, wsel, src, dst, N, gout)
    # one edge order for all calls, as one forward builds it for its layers
    order = edge_order.shared(src, dst, N)
    with torch.no_grad():
        saved = ext.launch_forward(fc, *fa, order=order)[1]
    calls = {
        "K4f": lambda: ext.launch_forward(fc, *fa, order=order),
        "K4b": lambda: ext.launch_backward(fc, *fa, gout, order=order,
                                           scratch=saved),
        "K4b recomputed": lambda: ext.launch_backward(fc, *fa, gout,
                                                      order=order),
        "K4g": lambda: ext.launch_grad2(fc, *ga, order=order),
    }
    k4f = compare_grads(
        f"K4f full_conv_ext_fwd{tag}", lambda: calls["K4f"]()[:1],
        lambda: (fc.plain_forward(*fa),), ("out",))
    k4b = compare_grads(
        f"K4b full_conv_ext_bwd{tag}, on K4f's saved scratch",
        calls["K4b"], lambda: fc.plain_backward(*fa, gout),
        ("dx", "dsh", "dw", "dwsel"))
    k4b_re = compare_grads(
        f"K4b full_conv_ext_bwd{tag}, scratch recomputed",
        calls["K4b recomputed"], lambda: fc.plain_backward(*fa, gout),
        ("dx", "dsh", "dw", "dwsel"))
    k4g = compare_grads(
        f"K4g full_conv_ext_grad2{tag}", calls["K4g"],
        lambda: fc.plain_grad2(*ga), ("c_x", "c_s", "c_w", "c_m", "c_g"))
    # the walks sum in a fixed order and store each node once: every
    # output repeats bit for bit
    with torch.no_grad():
        for name, fn in calls.items():
            a, b = fn(), fn()
            torch.cuda.synchronize()
            if not all(torch.equal(u, v) for u, v in zip(a, b)):
                fail(f"{name}{tag}: outputs differ between two launches")
    print(f"K4f, K4b (both branches), K4g{tag}: every output repeats bit "
          f"for bit")
    cc = conv_counts(fc, N, E)
    ops, edges = nbytes(x, sh, w, wsel), nbytes(src, dst)
    out_bytes = N * fc.out_dim * 4
    costs = {
        "K4f": (cc["cg"] + 2 * cc["rows"] + cc["mix"],
                ops + edges + out_bytes),
        # the main path's K4b reads K4f's scratch instead of recomputing it
        "K4b": (2 * cc["cg"] + 2 * cc["rows"] + 2 * cc["mix"],
                2 * ops + edges + out_bytes + nbytes(saved)),
        "K4b recomputed": (3 * cc["cg"] + 4 * cc["rows"] + 2 * cc["mix"],
                           2 * ops + edges + out_bytes),
        "K4g": (7 * cc["cg"] + 6 * cc["rows"] + 3 * cc["mix"],
                2 * ops + nbytes(cx, csh, cw) + edges + 2 * out_bytes),
    }
    return k4f, k4b, k4b_re, k4g, costs


def force_phases(dev):
    """Phases 10-13 of the module docstring (the ``config_energy_force``
    path); returns the K4 kernels' records."""
    import torch

    from equivariant_nn_zoo_tpu_torch.inference import evaluate
    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
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
    k4f, k4b, k4b_re, k4g, costs = ext_checks(
        *force_hot_layer(model, batches[0], dev), "")

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
        dict(kernel_record("full_conv_ext_bwd", "full_conv_ext.cu",
                           "fused_conv.py:1432",
                           train_launches["full_conv_ext_bwd"], k4b,
                           *costs["K4b"]),
             recomputed=dict(k4b_re, **bound(*costs["K4b recomputed"]))),
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


def uvu_args(uvu, call):
    """K6's contract arguments ``(x, sh, w, wsel, src)`` from one forward's
    captured call of the head's conv, its mix ``Linear``, and the edges'
    destinations (a parent checkout's call has none: the sources stand in,
    which gives an order by source)."""
    import torch

    linear, x, sh, w, src, *rest = call
    with torch.no_grad():
        wsel = uvu.flat_wsel(linear)
    return (x, sh, w, wsel, src), linear, rest[0] if rest else src


def uvu_costs(uvu, args, gout):
    """``(cg flops, mix flops, bytes)`` of K6 and of K6b at these inputs:
    K6 makes S once (a multiply-add per non-zero and channel, w once per
    row) and mixes it; K6b makes S again for dwsel and sweeps the
    non-zeros twice more (dx; dw and dsh), with two mix products (dwsel,
    dS); each input read once, each output written once."""
    x, sh, w, wsel, src = args
    E = sh.shape[0]
    cc = conv_counts(uvu, E, E)
    return ((cc["cg"] + cc["rows"], cc["mix"],
             nbytes(*args) + E * uvu.out_dim * 4),
            (3 * cc["cg"] + 2 * cc["rows"], 2 * cc["mix"],
             2 * nbytes(x, sh, w, wsel) + nbytes(src, gout)))


def uvu_checks(uvu, call, dev, seed, tag, forward=True):
    """K6 (when ``forward``) and K6b on one forward's captured call of the
    head's conv against their plain versions (K6 against
    ``FusedUVUConv(reduce=False)``, K6b per output against autograd of the
    plain forward, on the edges' source-major order and a seeded
    cotangent), each repeated bit for bit; returns their records and
    costs."""
    import torch

    from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
    from equivariant_nn_zoo_tpu_torch.ops.cuda import uvu_conv as k6_ops

    args, linear, dst = uvu_args(uvu, call)
    x, sh, w, wsel, src = args
    E, N = sh.shape[0], x.shape[0]
    rec = {}
    if forward:
        rec["K6"] = compare(
            f"K6 uvu_conv ({tag}, E={E})",
            lambda: k6_ops.launch_forward(uvu, *args),
            lambda: uvu.fused(linear, x, src, None, sh, w, N, reduce=False))
        repeats(f"K6 uvu_conv ({tag}, E={E})",
                lambda: k6_ops.launch_forward(uvu, *args))
    gout = torch.randn(E, uvu.out_dim, generator=torch.Generator(
    ).manual_seed(seed)).to(dev)
    order = edge_order.build(src, dst, N)

    def backward():
        return k6_ops.launch_backward(uvu, *args, gout, order=order)

    rec["K6b"] = compare_grads(f"K6b uvu_conv_bwd ({tag}, E={E})", backward,
                               lambda: uvu.plain_backward(*args, gout),
                               ("dx", "dsh", "dw", "dwsel"))
    repeats(f"K6b uvu_conv_bwd ({tag}, E={E})", backward)
    return rec, uvu_costs(uvu, args, gout)


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
    from equivariant_nn_zoo_tpu_torch.ops.cuda import species_order
    from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as sc_ops

    head = model.pairwise
    tpk, uvu = head.pairwise_tp, head.conv.full_conv
    conv = getattr(model, HOT_LAYER).conv
    gen = torch.Generator().manual_seed(5)
    rec, cost = {}, {}

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    # ------------------------------------------- K6b (and K6 at batch 16)
    k6, (_, cost["K6b"]) = uvu_checks(
        uvu, seen["K6"][0], dev, 6, "phase 16", forward=not alone)
    rec.update(k6)

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
        if not alone:   # K5 at this batch's shapes (phase 14 has 3072)
            compare(f"K5 pairwise_tp ({which}, M={M})",
                    lambda: k5_ops.launch_forward(tpk, left, bw, wsel5),
                    lambda: tpk.plain_forward(left, bw, wsel5))
            repeats(f"K5 pairwise_tp ({which}, M={M})",
                    lambda: k5_ops.launch_forward(tpk, left, bw, wsel5))
        args5 = (left, bw, wsel5, rnd(M, tpk.out_dim))
        whole = compare_grads(
            f"K5 backward, one entry ({which}, M={M}: K5m + K5a + K5b)",
            lambda: k5_ops.launch_backward(tpk, *args5),
            lambda: tpk.plain_backward(*args5), names5)
        repeats(f"K5 backward ({which}, M={M})",
                lambda: k5_ops.launch_backward(tpk, *args5))
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
            cost["K5m"] = (M * cg, M * mix, nbytes(left, bw) + io
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
    sorder = species_order.shared(spec, ssc.num_types)
    rec["K3b"] = compare_grads(
        f"K3b species_sc_bwd at l = 4 (N={N})",
        lambda: sc_ops.launch_backward(ssc, *k3b_args, order=sorder),
        lambda: ssc.plain_backward(*k3b_args), ("dx", "dtables"))
    repeats(f"K3b species_sc_bwd at l = 4 (N={N})",
            lambda: sc_ops.launch_backward(ssc, *k3b_args, order=sorder))
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
    args6, linear, _ = uvu_args(uvu, seen["K6"][0])
    k6 = compare(f"K6 uvu_conv (E={args6[1].shape[0]})",
                 lambda: k6_ops.launch_forward(uvu, *args6),
                 lambda: uvu.plain_forward(*args6))
    repeats("K6 uvu_conv", lambda: k6_ops.launch_forward(uvu, *args6))
    k6_cost = uvu_costs(uvu, args6, args6[1])[0]
    del args6

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
        repeats(f"K5 pairwise_tp ({which}, M={M})",
                lambda: k5_ops.launch_forward(tpk, left, bw, wsel5))
        del bw
        whole = compare(
            f"K5 wrapper ({which}, M={M}; stage 1 in PyTorch + kernel "
            f"against expand)",
            lambda: tpk.launch(tpe, left, right),
            lambda: tpe.expand(left, right))
        rec.update(wrapper_ms=whole["ms"], expand_ms=whole["plain_ms"])
        if k5 is None:
            k5 = rec
            k5_cost = (2 * M * tpk.mul * tpk.nz_count,
                       mix_flops(tpk.prob_rows, M),
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
    repeats("K3 species_sc at l = 4",
            lambda: conv.species_sc.launch(*k3_args))
    del data, x1, er, k3_args, left, right

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
    train_launches, mid = hamiltonian_train(dev, cfg, cpu_model, n_layers)

    total = {k: sum(serve_launches[s][k] for s in H2O_BATCHES) for k in want}
    # the pairwise backward is one C entry: its three kernels share a count
    entries = (
        ("uvu_conv_bwd", "uvu_conv.cu", "fused_conv.py:278", "uvu_conv_bwd",
         "K6b", "uvu_dws_kernel (S again in shared memory, S^T gout on the "
         "tensor cores) + uvu_adj_kernel (dS on the tensor cores, the "
         "non-zeros' two orders) + uvu_chunk_sum_kernel + "
         "uvu_dx_sum_kernel"),
        ("pairwise_tp_bwd_dwsel", "pairwise_tp.cu", "pairwise.py:504",
         "pairwise_tp_bwd", "K5m",
         "pairwise_dws_kernel (CG tiles in shared memory, S^T gout on the "
         "tensor cores) + pairwise_chunk_sum_kernel"),
        ("pairwise_tp_bwd_da", "pairwise_tp.cu", "pairwise.py:556",
         "pairwise_tp_bwd", "K5a",
         "rowmix::gemm_kernel (dS) + pairwise_adj_kernel<true, false> + "
         "pairwise_da_sum_kernel"),
        ("pairwise_tp_bwd_dbw", "pairwise_tp.cu", "pairwise.py:591",
         "pairwise_tp_bwd", "K5b",
         "rowmix::gemm_kernel (dS) + pairwise_adj_kernel<false, true>"),
    )
    records = [
        dict(kernel_record("uvu_conv", "uvu_conv.cu", "fused_conv.py:233",
                           total["uvu_conv"], k6, k6_cost[0] + k6_cost[1],
                           k6_cost[2]),
             **fused_bound(*k6_cost),
             kernels="uvu_fwd_kernel (CG tiles in shared memory, mixed "
                     "there on the tensor cores)",
             batch16_ms=bwd_small["K6"]["ms"], batch128_ms=mid["K6"]["ms"],
             train_launches=train_launches["uvu_conv"]),
        dict(kernel_record("pairwise_tp", "pairwise_tp.cu", "pairwise.py:410",
                           total["pairwise_tp"], k5,
                           k5_cost[0] + k5_cost[1], k5_cost[2]),
             **fused_bound(*k5_cost),
             kernels="pairwise_fwd_kernel (CG tiles in shared memory, mixed "
                     "there on the tensor cores)",
             wrapper_ms=k5["wrapper_ms"], expand_ms=k5["expand_ms"],
             train_launches=train_launches["pairwise_tp"]),
    ]
    for name, source, replaces, counter, key, kernels in entries:
        extra = dict(kernels=kernels)
        cost = bwd_cost[key]
        if key in ("K5m", "K6b"):
            extra.update(fused_bound(*cost))
            cost = (cost[0] + cost[1], cost[2])
        if key == "K6b":
            extra.update(batch16_ms=bwd_small[key]["ms"],
                         batch128_ms=mid[key]["ms"])
        else:
            extra.update(entry_ms=bwd["K5 backward"]["ms"],
                         entry_plain_ms=bwd["K5 backward"]["plain_ms"],
                         batch16_entry_ms=bwd_small["K5 backward"]["ms"])
        records.append(dict(kernel_record(
            name, source, replaces, train_launches[counter], bwd[key],
            *cost), **extra))
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
    them), and the records of K6 and K6b at the larger batch's edges."""
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
    # K6 and K6b at the larger batch's edges
    mid, _ = uvu_checks(trainer.model.pairwise.conv.full_conv,
                        capture_head_inputs(trainer.model, big[0])["K6"][0],
                        dev, 7, f"batch {big_size}")
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
    return train_launches, mid


DIFF_BATCH, DIFF_CUT = 128, 16    # the config's batch, a cut for parity
DIFF_PARITY_STEPS = 10            # sampler steps held to the CPU
DIFF_HOT_LAYER = "layer2"
DIFF_TRAIN_STEPS = 12
SAMPLING_EPS = 1e-3


def synthetic_diffusion_mols(n_mol, rng, num_types=18):
    """Molecules for the score model as ``bench.py`` makes them: 8-19
    atoms of 18 species, positions N(0, 0.5^2) (normalized), every ordered
    pair an edge (r_max 9999, the config's preprocessing), a bond type in
    0-3 per edge."""
    from equivariant_nn_zoo_tpu_torch.data import Data, computeEdgeIndex

    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(8, 20))
        d = {"pos": (rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
             "species": rng.integers(0, num_types, size=(n, 1))}
        d["atom_types"] = d["species"]
        attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
                 "atom_types": ("node", "1x0e")}
        out, attrs = computeEdgeIndex(d, attrs, r_max=9999.0)
        d.update(out)
        ne = int(np.asarray(d["edge_index"]).shape[-1])
        d["bond_type"] = rng.integers(0, 4, size=(ne, 1))
        attrs["bond_type"] = ("edge", "1x0e")
        mols.append(Data(attrs, **d))
    return mols


class Replay:
    """A noise source (``run.sde_utils.Noise``'s interface) that hands out
    given host tensors in order, each moved to ``device``: the same draws
    on the card and on the CPU."""

    def __init__(self, draws, device):
        self.draws, self.device = list(draws), device

    def normal(self, shape):
        a = self.draws.pop(0)
        if tuple(a.shape) != tuple(shape):
            fail(f"replayed draw of shape {tuple(a.shape)}, want {shape}")
        return a.to(self.device)

    uniform = normal


def seeded_draws(seed, shapes, uniform_first=False):
    """Host draws for ``Replay``: N(0, 1) of each shape (the first U(0, 1)
    with ``uniform_first``), from a CPU generator seeded with ``seed``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return [torch.rand(s, generator=gen) if uniform_first and i == 0
            else torch.randn(s, generator=gen) for i, s in enumerate(shapes)]


def k1_k2_checks(model, gb, dev):
    """K1 and K2 against their plain versions at the hot layer of the
    score model on ``gb`` (``main``'s phases 3 and 5 on these operands),
    with their costs."""
    import torch

    from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
    from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as conv_ops

    conv = getattr(model, DIFF_HOT_LAYER).conv
    seen = {}
    hook = conv.register_forward_pre_hook(
        lambda mod, args: seen.update(data=args[0]))
    with torch.no_grad():
        model(gb)
    hook.remove()
    data = {k: v.detach() for k, v in seen["data"].items()}
    fconv = conv.full_conv
    print(f"diffusion hot layer {DIFF_HOT_LAYER}: N={gb.node_capacity} "
          f"E={gb.edge_capacity} in={fconv.fused.irreps_in} "
          f"K={fconv.fused.K_dim} paths={fconv.n_paths} "
          f"out_dim={fconv.out_dim}")
    with torch.no_grad():
        x1 = conv.linear_1(data["input_features"])
        er = data["edge_radial"] * data["_edge_mask"]
    edges = (data["edge_spherical"], data["edge_index"][0],
             data["edge_index"][1])
    pre = 1.0 / conv.avg_num_neighbors ** 0.5
    k1_args = (conv.fc, conv.tp.linear, x1, er, *edges, x1.shape[0], pre)
    k1 = compare("K1 full_conv (diffusion)",
                 lambda: fconv.launch(*k1_args),
                 lambda: fconv.plain(*k1_args))
    flat = [t.detach() for t in fconv.flat_weights(conv.fc, conv.tp.linear,
                                                   pre)]
    with torch.no_grad():
        _, scratch = conv_ops.launch_forward(fconv, x1, er, *edges, *flat,
                                             x1.shape[0])
    gout = torch.randn(x1.shape[0], fconv.out_dim,
                       generator=torch.Generator().manual_seed(31)).to(dev)
    order = edge_order.shared(*edges[1:], x1.shape[0])
    k2_args = (x1, er, *edges, *flat, x1.shape[0], scratch, gout)
    k2 = compare_grads(
        "K2 full_conv_bwd (diffusion)",
        lambda: conv_ops.launch_backward(fconv, *k2_args, order=order),
        lambda: fconv.plain_backward(*k2_args),
        ("dx", "d edge_radial", "dw_hidden", "dw_out", "dwsel"))
    return k1, k2, conv_costs(conv, x1, er, edges, flat)


def conv_launches():
    from equivariant_nn_zoo_tpu_torch.ops.cuda import (
        FullConv,
        SpeciesScalarFCTP,
    )

    return {"full_conv": FullConv.launches,
            "full_conv_bwd": FullConv.backward_launches,
            "species_sc": SpeciesScalarFCTP.launches,
            "species_sc_bwd": SpeciesScalarFCTP.backward_launches,
            **ext_launches()}


def reset_conv_launches():
    from equivariant_nn_zoo_tpu_torch.ops.cuda import (
        FullConv,
        SpeciesScalarFCTP,
    )

    FullConv.launches = FullConv.backward_launches = 0
    SpeciesScalarFCTP.launches = SpeciesScalarFCTP.backward_launches = 0
    reset_ext_launches()


def diffusion_serve(dev, spec, mols, sde, sde_cfg):
    """Phase 19 for one spec: the kernels at the hot layer against plain,
    one batch sampled by the PC sampler at the config's N (every counter
    set to 0 just before, read just after), the first steps of a cut
    against the CPU plain path, and a profile.  Returns the model and what
    the phase measured."""
    import torch

    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.run.sde_sampling import (
        get_corrector,
        get_pc_sampler,
        get_predictor,
        get_sampling_fn,
    )
    from equivariant_nn_zoo_tpu_torch.run.sde_utils import Noise, with_t

    mc = get_config("config_diffusion", spec)["model_config"]
    tag = f"diffusion {spec or 'score'}"
    n_layers = mc["num_layers"]
    # no device argument: the entry point builds on the card by default
    model = build_model(mc, generator=torch.Generator().manual_seed(0))
    model.eval()
    if next(model.parameters()).device.type != "cuda":
        fail("build_model without a device did not build on the card")
    gb = make_batches(mols, dev, DIFF_BATCH)[0]
    n_real = int(gb["_node_mask"].sum())
    print(f"{tag}: {sum(p.numel() for p in model.parameters())} parameters;"
          f" a batch of {DIFF_BATCH} molecules: {n_real} atoms, "
          f"{int(gb['_edge_mask'].sum())} edges, N={gb.node_capacity} "
          f"E={gb.edge_capacity}")

    if any(getattr(m, "species_sc", None) is not None
           for m in model.modules()):
        fail(f"{tag}: a self-connection took the species tables")
    gb_t = with_t(gb, torch.full((DIFF_BATCH, 1), 0.5, device=dev))
    if spec:
        checks = ext_checks(*force_hot_layer(model, gb_t, dev,
                                             DIFF_HOT_LAYER), f" ({tag})")
    else:
        checks = k1_k2_checks(model, gb_t, dev)

    sampling = dict(sde_cfg["sampling"])
    sampler = get_sampling_fn(sde_cfg, sde, None, SAMPLING_EPS)
    pc = get_pc_sampler(
        sde, get_predictor(sampling["predictor"]),
        get_corrector(sampling["corrector"]), None, sampling["snr"],
        sampling["n_steps_each"], eps=SAMPLING_EPS)
    pc(model, gb, Noise(dev, 1), steps=2)     # warm-up
    torch.cuda.synchronize()
    reset_conv_launches()
    t0 = time.perf_counter()
    host, nfe = sampler(model, gb, Noise(dev, 2))
    dt = time.perf_counter() - t0
    launches = conv_launches()
    per_eval = {k: v / nfe for k, v in launches.items() if v}
    print(f"{tag} serve: {DIFF_BATCH} molecules sampled by the PC sampler "
          f"(N={sde.N}, {nfe} score evaluations) in {dt:.3f} s: "
          f"{DIFF_BATCH / dt:.3f} molecules/s, {1e3 * dt / nfe:.4f} ms per "
          f"evaluation (host clock, to the host batch); launches "
          f"{launches}, per evaluation {per_eval}")
    if nfe != 2 * sde.N:
        fail(f"{tag}: {nfe} score evaluations, want {2 * sde.N}")
    if host["pos"].shape != (n_real, 3) or not np.isfinite(
            host["pos"]).all():
        fail(f"{tag}: sampled positions not finite or of shape "
             f"{host['pos'].shape}")
    want = ("full_conv_ext_fwd", "full_conv_ext_bwd") if spec else \
        ("full_conv",)
    for name in want:
        if launches[name] < n_layers * nfe:
            fail(f"{tag}: {name} launched {launches[name]} times in {nfe} "
                 f"evaluations, want >= {n_layers * nfe}")
    if launches["species_sc"] or launches["species_sc_bwd"]:
        fail(f"{tag}: the species-table kernels launched ({launches})")

    n_prof = 5    # sampler steps: two score evaluations each
    kernel_ms = profile_kernels(
        f"{tag} score evaluations",
        lambda: pc(model, gb, Noise(dev, 3), steps=n_prof), 2 * n_prof,
        f"diffusion_serve_profile{'_' + spec if spec else ''}.txt")
    eval_ms = 1e3 * dt / nfe
    print(f"{tag} serve: {kernel_ms:.4f} ms of kernels per score "
          f"evaluation under the profiler: device busy share "
          f"{kernel_ms / eval_ms:.4f}")

    # the first sampler steps of a cut, card against the CPU plain path
    small = cut_batch(mols, DIFF_CUT)
    n_draws = 1 + DIFF_PARITY_STEPS * (sampling["n_steps_each"] + 1)
    draws = seeded_draws(40, [(small.node_capacity, 3)] * n_draws)
    cpu_model = build_model(mc, "cpu", torch.Generator().manual_seed(0))
    card = pc(model, small.to(dev), Replay(draws, dev),
              steps=DIFF_PARITY_STEPS)[0]["pos"].cpu()
    plain = pc(cpu_model, small, Replay(draws, "cpu"),
               steps=DIFF_PARITY_STEPS)[0]["pos"]
    rel = float((card - plain).abs().max() / plain.abs().max())
    print(f"{tag} serve, card vs CPU plain path, positions after "
          f"{DIFF_PARITY_STEPS} sampler steps ({DIFF_CUT} molecules): rel "
          f"{rel:.3e}")
    if not torch.isfinite(card).all() or rel > TOL:
        fail(f"{tag}: card and CPU plain path disagree after "
             f"{DIFF_PARITY_STEPS} steps (rel {rel:.3e})")
    return model, cpu_model, dict(
        launches=launches, nfe=nfe, s_per_batch=dt,
        molecules_per_s=DIFF_BATCH / dt, ms_per_evaluation=eval_ms,
        kernel_ms_per_evaluation=kernel_ms, busy=kernel_ms / eval_ms,
        checks=checks)


def diffusion_train(dev, spec, model, cpu_model, sde, sde_cfg):
    """Phases 20 and 21 for one spec: ``get_step_fn`` with the config's
    settings over batches of 128 (launches per step, 12 timed steps, peak
    memory, a profile), then one step's gradients on a cut, card against
    the CPU plain path, on the same t and z."""
    import torch

    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.run.sde_utils import (
        Noise,
        adam,
        get_sde_loss_fn,
        get_step_fn,
        init_sde_state,
    )

    cfg = get_config("config_diffusion", spec)
    tag = f"diffusion {spec or 'score'}"
    n_layers = cfg["model_config"]["num_layers"]
    train = make_batches(synthetic_diffusion_mols(
        4 * DIFF_BATCH, np.random.default_rng(22)), dev, DIFF_BATCH)
    model.train()
    optimizer = adam(model, cfg["learning_rate"])
    state = init_sde_state(model, Noise(dev, 4))
    kw = dict(reduce_mean=sde_cfg["training"]["reduce_mean"],
              continuous=sde_cfg["training"]["continuous"],
              likelihood_weighting=sde_cfg["training"][
                  "likelihood_weighting"],
              grad_clid_norm=cfg["grad_clid_norm"], grad_acc=cfg["grad_acc"],
              ema_decay=sde_cfg["model"]["ema_rate"],
              ema_use_num_updates=cfg["ema_use_num_updates"])
    step = get_step_fn(sde, True, model=model, optimizer=optimizer, **kw)
    for gb in train[:2]:                         # warm-up
        state, loss, _ = step(state, gb)
    torch.cuda.synchronize()
    reset_conv_launches()
    state, loss, _ = step(state, train[2])
    per_step = {k: v for k, v in conv_launches().items() if v}
    print(f"{tag} train launches per step (all {n_layers} layers): "
          f"{per_step}")
    want = {"full_conv_ext_fwd": n_layers, "full_conv_ext_bwd": n_layers,
            "full_conv_ext_grad2": n_layers - 1} if spec else \
        {"full_conv": n_layers, "full_conv_bwd": n_layers}
    for name, n in want.items():
        if per_step.get(name, 0) < n:
            fail(f"{tag} train: {name} launched {per_step.get(name, 0)} "
                 f"times in a step, want >= {n}")
    if "species_sc" in per_step or "species_sc_bwd" in per_step:
        fail(f"{tag} train: the species-table kernels launched")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_conv_launches()
    losses = []
    t0 = time.perf_counter()
    for i in range(DIFF_TRAIN_STEPS):
        state, loss, _ = step(state, train[i % len(train)])
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / DIFF_TRAIN_STEPS
    train_launches = conv_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(losses).cpu()
    print(f"{tag} train step: {step_ms:.3f} ms per {DIFF_BATCH}-graph "
          f"batch, {1e3 * DIFF_BATCH / step_ms:.1f} graphs/s (host clock "
          f"around synchronize, {DIFF_TRAIN_STEPS} steps); peak device "
          f"memory {peak:.3f} GiB; losses {losses.tolist()}")
    if not torch.isfinite(losses).all():
        fail(f"{tag} train: non-finite loss")
    kernel_ms = profile_kernels(
        f"{tag} training steps", lambda: [step(state, gb) for gb in train],
        len(train), f"diffusion_step_profile{'_' + spec if spec else ''}.txt")
    print(f"{tag} train step: {kernel_ms:.3f} ms of kernels per step under "
          f"the profiler: device busy share {kernel_ms / step_ms:.4f}")
    _, eval_loss, _ = get_step_fn(sde, False)(state, train[0])
    if not np.isfinite(eval_loss.item()):
        fail(f"{tag} eval: non-finite loss of the EMA model")

    # --------------------------------------------------- train parity
    small = cut_batch(synthetic_diffusion_mols(
        DIFF_CUT, np.random.default_rng(23)), DIFF_CUT)
    draws = seeded_draws(41, [(DIFF_CUT, 1), (small.node_capacity, 3)],
                         uniform_first=True)
    loss_fn = get_sde_loss_fn(sde, True, reduce_mean=kw["reduce_mean"])

    def gradients(m, d):
        m.zero_grad(set_to_none=True)
        value, _ = loss_fn(m, small.to(d), Replay(draws, d))
        value.backward()
        return value.item(), {
            n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
            for n, p in m.named_parameters()}

    card_loss, card = gradients(build_model(
        cfg["model_config"], generator=torch.Generator().manual_seed(0)),
        dev)
    cpu_loss, plain = gradients(cpu_model, "cpu")
    worst, n_small = worst_gradient_rel(card, plain)
    print(f"{tag} train parity ({DIFF_CUT} molecules): loss card "
          f"{card_loss} CPU {cpu_loss}; worst gradient rel {worst[0]:.3e} "
          f"({worst[1]}) over {len(plain) - n_small} tensors ({n_small} "
          f"zero by symmetry)")
    if abs(card_loss - cpu_loss) > TOL * abs(cpu_loss):
        fail(f"{tag} train parity: the loss differs")
    if any(not torch.isfinite(g).all() for g in card.values()):
        fail(f"{tag} train parity: non-finite gradients on the card")
    if worst[0] > TOL:
        fail(f"{tag} train parity: {worst[1]} gradient rel {worst[0]:.3e} "
             f"> {TOL}")
    return dict(launches=train_launches, per_step=per_step,
                step_ms=step_ms, graphs_per_s=1e3 * DIFF_BATCH / step_ms,
                peak_gib=peak, kernel_ms=kernel_ms, busy=kernel_ms / step_ms)


def diffusion_phases(dev):
    """Phases 19-21 of the module docstring (``config_diffusion``, both
    specs, served by the PC sampler and trained by ``get_step_fn``);
    returns what K1, K2 and the K4 family did on this path, by kernel
    record name."""
    from equivariant_nn_zoo_tpu_torch.models.sde_config import (
        get_config as sde_get_config,
    )
    from equivariant_nn_zoo_tpu_torch.run.sde_utils import VPSDE

    sde_cfg = sde_get_config()
    sde = VPSDE({"pos": 3}, beta_min=sde_cfg["model"]["beta_min"],
                beta_max=sde_cfg["model"]["beta_max"],
                N=sde_cfg["model"]["num_scales"])
    mols = synthetic_diffusion_mols(DIFF_BATCH, np.random.default_rng(21))
    out = {}
    for spec in ("", "nll"):
        model, cpu_model, serve = diffusion_serve(dev, spec, mols, sde,
                                                  sde_cfg)
        train = diffusion_train(dev, spec, model, cpu_model, sde, sde_cfg)
        del model, cpu_model
        if spec:
            k4f, k4b, _, k4g, costs = serve["checks"]
            names = (("full_conv_ext_fwd", k4f, "K4f"),
                     ("full_conv_ext_bwd", k4b, "K4b"),
                     ("full_conv_ext_grad2", k4g, "K4g"))
        else:
            k1, k2, costs = serve["checks"]
            names = (("full_conv", k1, "K1"), ("full_conv_bwd", k2, "K2"))
        for name, rec, key in names:
            out[name] = dict(
                spec=spec, launches=serve["launches"][name],
                per_evaluation=serve["launches"][name] / serve["nfe"],
                train_launches=train["launches"][name],
                per_step=train["per_step"].get(name, 0), **rec,
                **bound(*costs[key]))
    return out


DIPOLE_BATCH, DIPOLE_CUT = 256, 32   # the config's batch, a cut for parity
DIPOLE_SERVE_BATCHES = 4
DIPOLE_MOLS, DIPOLE_N_TRAIN, DIPOLE_N_VAL = 1280, 1024, 256
DIPOLE_HOT_LAYER = "layer3"
DIPOLE_WORKDIR = os.path.join("chiprun_out", "dipole_wd")
DIPOLE_TIMED_STEPS = 12


def synthetic_dipole_mols(n_mol, rng, r_max=5.0, num_types=18, edges=True):
    """Molecules for ``config_dipole`` as ``bench.py`` makes them: 8-23
    atoms of 18 species, positions N(0, 1.4^2), N(0, 1) per-node ``dipole``
    targets; with ``edges``, the radius graph at ``r_max`` (without, the
    dataset's preprocess makes it)."""
    from equivariant_nn_zoo_tpu_torch.data import Data, computeEdgeIndex

    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(8, 24))
        d = {"pos": rng.normal(size=(n, 3)) * 1.4,
             "species": rng.integers(0, num_types, size=(n, 1)),
             "dipole": rng.normal(size=(n, 3)).astype(np.float32)}
        d["atom_types"] = d["species"]
        attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
                 "atom_types": ("node", "1x0e"), "dipole": ("node", "1x1o")}
        if edges:
            out, attrs = computeEdgeIndex(d, attrs, r_max=r_max)
            d.update(out)
        mols.append(Data(attrs, **d))
    return mols


def trunk_checks(model, gb, dev, layer, tag, mix=False):
    """Phases 3-6 at ``layer`` of ``model`` on ``gb``: K1, K3, K2 and K3b
    against their plain versions (one edge order and one species order as
    on the main path; seeded cotangents), K3's and K3b's outputs repeated
    bit for bit; with ``mix``, the mix GEMM alone on K1's scratch and K2's
    cotangent (``row_mix_phase``).  Returns the four records by key, their
    costs, and the GEMM's two records (or None)."""
    import torch

    from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
    from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as conv_ops
    from equivariant_nn_zoo_tpu_torch.ops.cuda import species_order
    from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as sc_ops

    conv = getattr(model, layer).conv
    seen = {}
    hook = conv.register_forward_pre_hook(
        lambda mod, args: seen.update(data=args[0]))
    with torch.no_grad():
        model(gb)
    hook.remove()
    data = {k: v.detach() for k, v in seen["data"].items()}
    fconv, ssc = conv.full_conv, conv.species_sc
    print(f"{tag} hot layer {layer}: N={gb.node_capacity} "
          f"E={gb.edge_capacity} in={fconv.fused.irreps_in} "
          f"K={fconv.fused.K_dim} paths={fconv.n_paths} "
          f"out_dim={fconv.out_dim} species={ssc.num_types}")
    with torch.no_grad():
        x1 = conv.linear_1(data["input_features"])
        er = data["edge_radial"] * data["_edge_mask"]
    edges = (data["edge_spherical"], data["edge_index"][0],
             data["edge_index"][1])
    pre = 1.0 / conv.avg_num_neighbors ** 0.5
    k1_args = (conv.fc, conv.tp.linear, x1, er, *edges, x1.shape[0], pre)
    rec = {"K1": compare(f"K1 full_conv ({tag})",
                         lambda: fconv.launch(*k1_args),
                         lambda: fconv.plain(*k1_args))}
    x_in, attrs = data["input_features"], data["node_attrs"]
    k3_args = (conv.sc, x_in, attrs, data["species"])
    rec["K3"] = compare(f"K3 species_sc ({tag})",
                        lambda: ssc.launch(*k3_args),
                        lambda: ssc.plain(*k3_args))
    spec = data["species"].reshape(-1)
    sorder = species_order.shared(spec, ssc.num_types)
    with torch.no_grad():
        tables = ssc.tables(conv.sc, attrs, spec)
    repeats(f"K3 species_sc ({tag})", lambda: sc_ops.launch_forward(
        ssc, x_in, spec, tables, order=sorder))

    flat = [t.detach() for t in fconv.flat_weights(conv.fc, conv.tp.linear,
                                                   pre)]
    with torch.no_grad():
        _, scratch = conv_ops.launch_forward(fconv, x1, er, *edges, *flat,
                                             x1.shape[0])
    gout = torch.randn(x1.shape[0], fconv.out_dim,
                       generator=torch.Generator().manual_seed(1)).to(dev)
    order = edge_order.shared(*edges[1:], x1.shape[0])
    k2_args = (x1, er, *edges, *flat, x1.shape[0], scratch, gout)
    rec["K2"] = compare_grads(
        f"K2 full_conv_bwd ({tag})",
        lambda: conv_ops.launch_backward(fconv, *k2_args, order=order),
        lambda: fconv.plain_backward(*k2_args),
        ("dx", "d edge_radial", "dw_hidden", "dw_out", "dwsel"))
    mixes = row_mix_phase(fconv, scratch, flat[2], gout) if mix else None
    del scratch, k2_args
    g3 = torch.randn(spec.shape[0], ssc.irreps_out.dim,
                     generator=torch.Generator().manual_seed(2)).to(dev)
    k3b_args = (x_in, spec, tables, g3)
    rec["K3b"] = compare_grads(
        f"K3b species_sc_bwd ({tag})",
        lambda: sc_ops.launch_backward(ssc, *k3b_args, order=sorder),
        lambda: ssc.plain_backward(*k3b_args), ("dx", "dtables"))
    repeats(f"K3b species_sc_bwd ({tag})",
            lambda: sc_ops.launch_backward(ssc, *k3b_args, order=sorder))
    return rec, trunk_costs(conv, x1, er, edges, flat, x_in, attrs, tables,
                            spec, g3), mixes


def dipole_serve(dev, cfg, mols):
    """Phases 22 and 23: the trunk kernels at the dipole hot layer, then
    serving through ``inference.evaluate`` (every counter set to 0 just
    before, read just after) and a cut against the CPU plain path."""
    import torch

    from equivariant_nn_zoo_tpu_torch.inference import evaluate
    from equivariant_nn_zoo_tpu_torch.models import build_model

    mc = cfg["model_config"]
    n_layers = mc["num_layers"]
    # no device argument: the entry point builds on the card by default
    model = build_model(mc, generator=torch.Generator().manual_seed(0))
    model.eval()
    if next(model.parameters()).device.type != "cuda":
        fail("build_model without a device did not build on the card")
    batches = make_batches(mols, dev, DIPOLE_BATCH)
    gb0 = batches[0]
    print(f"dipole: {sum(p.numel() for p in model.parameters())} parameters; "
          f"a batch of {DIPOLE_BATCH} molecules: "
          f"{int(gb0['_node_mask'].sum())} atoms, "
          f"{int(gb0['_edge_mask'].sum())} edges, N={gb0.node_capacity} "
          f"E={gb0.edge_capacity}")
    checks = trunk_checks(model, gb0, dev, DIPOLE_HOT_LAYER, "dipole")

    evaluate(model, batches[:1], ["dipole"])  # warm-up
    torch.cuda.synchronize()
    reset_conv_launches()
    t0 = time.perf_counter()
    res = evaluate(model, batches, ["dipole"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in conv_launches().items() if v}
    n_atoms = sum(int(gb["_node_mask"].sum()) for gb in batches)
    print(f"dipole serve: {len(res)} molecules in {dt:.4f} s through "
          f"evaluate ({len(res) / dt:.1f} molecules/s, "
          f"{1e3 * dt / len(batches):.3f} ms per {DIPOLE_BATCH}-molecule "
          f"batch, host clock to the host batch); launches {launches}")
    want = {"full_conv": n_layers * len(batches),
            "species_sc": n_layers * len(batches)}
    if launches != want:
        fail(f"dipole serve: launches {launches}, want {want}")
    if len(res) != len(batches) * DIPOLE_BATCH or \
            res["dipole"].shape != (n_atoms, 3) or \
            not np.isfinite(res["dipole"]).all():
        fail(f"dipole serve: {len(res)} molecules, dipoles of shape "
             f"{res['dipole'].shape}, want {n_atoms} finite rows")

    small = cut_batch(mols, DIPOLE_CUT)
    cpu_model = build_model(mc, "cpu", torch.Generator().manual_seed(0))
    with torch.no_grad():
        card = model(small.to(dev))["dipole"].cpu()
        plain = cpu_model(small)["dipole"]
    real = int(small["_node_mask"].sum())
    rel = float((card - plain).abs().max() / plain.abs().max())
    print(f"dipole serve, card vs CPU plain path ({DIPOLE_CUT} molecules): "
          f"rel {rel:.3e}")
    if rel > TOL or not torch.allclose(
            card[:real], torch.as_tensor(res["dipole"][:real]), rtol=TOL,
            atol=TOL * float(plain.abs().max())):
        fail(f"dipole serve: the cut disagrees with the CPU plain path or "
             f"the batched run (rel {rel:.3e})")
    return cpu_model, checks, dict(launches=launches, s=dt,
                                   molecules_per_s=len(res) / dt)


def dipole_dataset(cfg, mols):
    """An in-memory ``CondensedDataset`` of ``mols`` (no edges: the config's
    preprocess makes them) with the config's data settings."""
    from equivariant_nn_zoo_tpu_torch.data import Batch, CondensedDataset

    host = Batch.from_data_list(mols)
    dc = cfg["data_config"]
    return CondensedDataset(
        data=host.data, attrs=host.attrs, type_names=dc["type_names"],
        preprocess=dc["preprocess"],
        cache_preprocessed=dc["cache_preprocessed"])


def trainer_state(trainer):
    """Parameters, EMA and optimizer state as host tensors, by name."""
    import torch

    out = {f"param {n}": p.detach().cpu().clone()
           for n, p in trainer.model.named_parameters()}
    out.update({f"ema {n}": p.detach().cpu().clone()
                for n, p in trainer.ema_model.named_parameters()})
    for i, st in trainer.optimizer.state_dict()["state"].items():
        out.update({f"adam {i} {k}": torch.as_tensor(v).detach().cpu().clone()
                    for k, v in st.items()})
    return out


def dipole_train(dev, cfg, cpu_model):
    """Phases 24 and 25: the trainer path end to end (dataset, loader,
    prefetch stream, checkpoints, resume, grad_acc), its timing beside
    steps on batches already on the card, then one step's gradients on a
    cut, card against the CPU plain path."""
    import shutil

    import torch

    from equivariant_nn_zoo_tpu_torch.models import build_model
    from equivariant_nn_zoo_tpu_torch.run import Loss, Trainer

    mc = cfg["model_config"]
    n_layers = mc["num_layers"]
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    data_config = dict(cfg["data_config"], n_train=DIPOLE_N_TRAIN,
                       n_val=DIPOLE_N_VAL)
    mols = synthetic_dipole_mols(DIPOLE_MOLS, np.random.default_rng(31),
                                 edges=False)
    dataset = dipole_dataset(cfg, mols)
    shutil.rmtree(DIPOLE_WORKDIR, ignore_errors=True)

    def new_trainer(seed, **kw):
        return Trainer(build_model(
            mc, generator=torch.Generator().manual_seed(seed)),
            data_config=data_config, workdir=DIPOLE_WORKDIR,
            batch_size=DIPOLE_BATCH, **{**settings, **kw})

    first = new_trainer(0, max_epochs=2)
    first.set_dataset(dataset)
    steps = 2 * len(first.dl_train)
    torch.cuda.synchronize()
    reset_conv_launches()
    t0 = time.perf_counter()
    first.train()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in conv_launches().items() if v}
    md = first.mae_dict
    print(f"dipole train: 2 epochs of {len(first.dl_train)} steps + "
          f"{len(first.dl_val)} validation batch through the loader in "
          f"{dt:.3f} s (the first epoch preprocesses every molecule); "
          f"training_loss {md['training_loss']} validation_loss "
          f"{md['validation_loss']} validation_dipole_mae "
          f"{md['validation_dipole_mae']}; stop: {first.stop_arg}; "
          f"launches {launches}")
    for name in ("full_conv", "full_conv_bwd", "species_sc",
                 "species_sc_bwd"):
        if launches.get(name, 0) < n_layers * steps:
            fail(f"dipole train: {name} launched {launches.get(name, 0)} "
                 f"times in {steps} steps, want >= {n_layers * steps}")
    for key in ("training_loss", "validation_loss"):
        if not np.isfinite(md[key]):
            fail(f"dipole train: non-finite {key}")
    for path in (first.best_model_path, first.last_model_path,
                 first.trainer_save_path):
        if not os.path.exists(path):
            fail(f"dipole train: {path} was not written")
    try:
        Trainer.from_file(first.trainer_save_path, model=build_model(
            mc, generator=torch.Generator().manual_seed(1)))
        fail("dipole train: a run that stopped properly was resumed")
    except RuntimeError as e:
        if "properly stopped" not in str(e):
            raise

    resumed = Trainer.from_file(
        first.trainer_save_path, max_epochs=3,
        model=build_model(mc, generator=torch.Generator().manual_seed(1)))
    want, got = trainer_state(first), trainer_state(resumed)
    if set(want) != set(got):
        fail(f"dipole resume: restored {sorted(set(got) ^ set(want))[:4]}")
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    if differ:
        fail(f"dipole resume: not bit for bit ({differ[:4]})")
    print(f"dipole resume: {len(want)} tensors (parameters, EMA, Adam "
          f"moments and steps) restored bit for bit at epoch "
          f"{resumed.iepoch}")
    resumed.set_dataset(dataset)
    resumed.train()
    if resumed.iepoch != 3 or resumed.stop_arg != "max epochs":
        fail(f"dipole resume: stopped at epoch {resumed.iepoch} with "
             f"{resumed.stop_arg!r}")

    # the trainer path (loader, pinned copies on the side stream, steps)
    # against steps on batches already on the card
    passes = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(passes):
        for gb in resumed._device_prefetch(iter(resumed.dl_train)):
            resumed.batch_step(gb)
    torch.cuda.synchronize()
    n_path = passes * len(resumed.dl_train)
    path_ms = 1e3 * (time.perf_counter() - t0) / n_path
    on_card = [gb.to(dev) for gb in resumed.dl_train]
    resumed.batch_step(on_card[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(DIPOLE_TIMED_STEPS):
        resumed.batch_step(on_card[i % len(on_card)])
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / DIPOLE_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not np.isfinite(resumed.batch_losses["loss"].item()):
        fail("dipole train: non-finite loss in the timed steps")
    kernel_ms = profile_kernels(
        "dipole training steps",
        lambda: [resumed.batch_step(gb) for gb in on_card], len(on_card),
        "dipole_step_profile.txt")
    print(f"dipole train step: trainer path {path_ms:.3f} ms per step "
          f"({1e3 * DIPOLE_BATCH / path_ms:.1f} graphs/s, loader and copies "
          f"included, {n_path} steps), on-card batches {step_ms:.3f} ms "
          f"({1e3 * DIPOLE_BATCH / step_ms:.1f} graphs/s, "
          f"{DIPOLE_TIMED_STEPS} steps); {kernel_ms:.3f} ms of kernels per "
          f"step under the profiler: busy share {kernel_ms / step_ms:.4f} "
          f"on-card, {kernel_ms / path_ms:.4f} on the trainer path; host "
          f"pipeline {path_ms - step_ms:.3f} ms per step; peak device "
          f"memory {peak:.3f} GiB")

    accum = new_trainer(0, grad_acc=2)
    first_param = next(accum.model.parameters())
    updates = []
    for i, gb in enumerate(on_card):
        before = first_param.detach().clone()
        accum.batch_step(gb)
        moved = not torch.equal(before, first_param)
        updates.append((accum.ema_num_updates, moved))
    print(f"dipole grad_acc 2: (EMA updates, parameters moved) after each "
          f"of {len(on_card)} steps: {updates}")
    if updates != [((i + 1) // 2, i % 2 == 1) for i in range(len(on_card))]:
        fail("dipole grad_acc 2 did not apply every second step")
    del first, resumed, accum, on_card
    for name in ("best.pt", "last.pt", "trainer.pt"):   # keep log.txt only
        os.remove(os.path.join(DIPOLE_WORKDIR, name))

    # ------------------------------------------------ dipole train parity
    small = cut_batch(synthetic_dipole_mols(
        DIPOLE_CUT, np.random.default_rng(32)), DIPOLE_CUT)
    loss_fn = Loss(settings["loss_coeffs"])
    card_loss, card = step_gradients(
        build_model(mc, dev, torch.Generator().manual_seed(0)),
        small.to(dev), loss_fn)
    cpu_loss, plain = step_gradients(cpu_model, small, loss_fn)
    worst, n_small = worst_gradient_rel(card, plain)
    print(f"dipole train parity ({DIPOLE_CUT} molecules, N(0, 1) dipoles): "
          f"loss card {card_loss} CPU {cpu_loss}; worst gradient rel "
          f"{worst[0]:.3e} ({worst[1]}) over {len(plain) - n_small} tensors "
          f"({n_small} zero by symmetry)")
    if abs(card_loss - cpu_loss) > TOL * abs(cpu_loss):
        fail("dipole train parity: the loss differs")
    if any(not torch.isfinite(g).all() for g in card.values()):
        fail("dipole train parity: non-finite gradients on the card")
    if worst[0] > TOL:
        fail(f"dipole train parity: {worst[1]} gradient rel {worst[0]:.3e} "
             f"> {TOL}")
    return dict(launches=launches, steps=steps, path_ms=path_ms,
                step_ms=step_ms, kernel_ms=kernel_ms, peak_gib=peak)


def dipole_phases(dev):
    """Phases 22-25 of the module docstring (``config_dipole`` at full
    width); returns what K1, K3, K2 and K3b did on this path, by kernel
    record name."""
    from equivariant_nn_zoo_tpu_torch.models import get_config

    cfg = get_config("config_dipole")
    if cfg["batch_size"] != DIPOLE_BATCH:
        fail(f"the config's batch is {cfg['batch_size']}, not "
             f"{DIPOLE_BATCH}")
    mols = synthetic_dipole_mols(DIPOLE_SERVE_BATCHES * DIPOLE_BATCH,
                                 np.random.default_rng(30))
    cpu_model, (checks, costs, _), serve = dipole_serve(dev, cfg, mols)
    train = dipole_train(dev, cfg, cpu_model)
    out = {}
    for name, key, launches in (
            ("full_conv", "K1", serve["launches"]["full_conv"]),
            ("species_sc", "K3", serve["launches"]["species_sc"]),
            ("full_conv_bwd", "K2", train["launches"]["full_conv_bwd"]),
            ("species_sc_bwd", "K3b", train["launches"]["species_sc_bwd"])):
        rec = dict(checks[key], **bound(*costs[key]))
        rec["share"] = rec["bound_ms"] / rec["ms"]
        out[name] = dict(launches=launches, layer=DIPOLE_HOT_LAYER, **rec)
    out["path"] = dict(serve_molecules_per_s=serve["molecules_per_s"],
                       **{k: v for k, v in train.items() if k != "launches"})
    return out


PROT_BATCH, PROT_RESIDUES = 4, 384     # the configs' batch and crop
PROT_HOT_LAYER = "layer3"
PROT_SAMPLE_STEPS = 50                 # the sampler's N, cut from 1000
PROT_PROFILE_STEPS = 3
PROT_PARITY_STEPS = 10                 # sampler steps held to the CPU
PROT_CUT_RESIDUES, PROT_CUT_EDGES = 128, 2048   # the CPU cut: 1 protein
PROT_TRAIN_WARMUP, PROT_TRAIN_STEPS = 4, 12     # micro-steps
PROTEIN_CONFIGS = ("config_diffusion_CA", "config_diffusion_backbone")


def synthetic_proteins(n_prot, rng, sizes=(420, 560)):
    """Globular protein-like chains: CA steps of 3.8 A, each in a random
    direction that keeps the residue inside the sphere of a globular
    protein of the chain's length (160 A^3 a residue) and at least 3 A from
    the chain's earlier residues (the most distant of 32 tries when none
    does); C, N and O at 1.5, 1.5 and 2.4 A from their CA in random
    directions; 20 residue types; the first chain of two where the
    length is even; 5 % of the residues unresolved (``mask`` 0)."""
    from equivariant_nn_zoo_tpu_torch.data import Data

    out = []
    for _ in range(n_prot):
        n = int(rng.integers(*sizes))
        radius = (3 * 160.0 * n / (4 * np.pi)) ** (1 / 3)
        ca = np.zeros((n, 3))
        for i in range(1, n):
            step = rng.normal(size=(32, 3))
            step *= 3.8 / np.linalg.norm(step, axis=1, keepdims=True)
            cand = ca[i - 1] + step
            inside = np.linalg.norm(cand, axis=1) < radius
            gap = np.linalg.norm(cand[:, None] - ca[None, :i - 1], axis=-1)
            gap = gap.min(axis=1) if i > 1 else np.full(32, 9.0)
            score = np.where(inside, gap, gap - 100.0)
            ok = np.flatnonzero(inside & (gap >= 3.0))
            ca[i] = cand[ok[0] if len(ok) else int(score.argmax())]
        d = {"CA": ca.astype(np.float32),
             "species": rng.integers(0, 20, size=(n, 1)),
             "chain_id": ((np.arange(n) >= n // 2) & (n % 2 == 0))
             .astype(np.int64).reshape(-1, 1),
             "mask": (rng.random((n, 1)) >= 0.05).astype(np.int64),
             "_n_nodes": np.array([[n]])}
        for atom, dist in (("C", 1.5), ("N", 1.5), ("O", 2.4)):
            off = rng.normal(size=(n, 3))
            off *= dist / np.linalg.norm(off, axis=1, keepdims=True)
            d[atom] = (ca + off).astype(np.float32)
        attrs = {"species": ("node", "1x0e"), "chain_id": ("node", "1x0e"),
                 "mask": ("node", "1x0e"), "_n_nodes": ("graph", "1x0e")}
        for atom in ("CA", "C", "N", "O"):
            attrs[atom] = ("node", "1x1o")
        out.append(Data(attrs, **d))
    return out


def protein_batch(cfg, prots, seed, n_cap, e_cap, batch):
    """The proteins through the config's preprocess (``masked2indexed``,
    then ``crop`` with a generator seeded ``seed``) in an in-memory
    ``CondensedDataset``, and the first batch of ``batch`` of them from a
    ``DataLoader`` at the given capacities (a host batch)."""
    from functools import partial

    from equivariant_nn_zoo_tpu_torch.data import (
        Batch,
        CondensedDataset,
        DataLoader,
    )

    masked2indexed, crop = cfg["data_config"]["preprocess"]
    crop = partial(crop.func, **crop.keywords,
                   rng=np.random.default_rng(seed))
    host = Batch.from_data_list(prots)
    ds = CondensedDataset(data=host.data, attrs=host.attrs,
                          preprocess=[masked2indexed, crop])
    loader = DataLoader(ds, batch_size=batch, node_capacity=n_cap,
                        edge_capacity=e_cap)
    gb = next(iter(loader))
    if gb.dropped or int(gb["_graph_mask"].sum()) != batch:
        fail(f"a protein batch of {batch} holds "
             f"{int(gb['_graph_mask'].sum())} proteins")
    return gb


class HostRand:
    """The edge layer's uniform draws from a CPU generator seeded ``seed``,
    moved to the asking device; each draw is kept (``draws``) to be
    replayed on the CPU."""

    def __init__(self, seed):
        import torch

        self.generator = torch.Generator().manual_seed(seed)
        self.draws = []

    def uniform(self, shape, device):
        import torch

        self.draws.append(torch.rand(tuple(shape), generator=self.generator))
        return self.draws[-1].to(device)


def float64_plain(model):
    """A function ``run(fn, batch)`` that calls ``fn`` on a float64 copy of
    a CPU model and the batch's floats in float64 (the default dtype
    float64 meanwhile): the plain path's reference for two float32 runs."""
    import copy

    import torch

    m64 = copy.deepcopy(model).double()

    def run(fn, batch):
        torch.set_default_dtype(torch.float64)
        try:
            return fn(m64, batch._map(
                lambda v: v.double() if v.is_floating_point() else v))
        finally:
            torch.set_default_dtype(torch.float32)

    return run


def edge_layer(model):
    """The ``edge_index`` layer of a protein model (a ``partial`` of
    ``computeEdgeIndexDevice``): its ``keywords["rand"]`` is the draws'
    source."""
    return dict(model.layers)["edge_index"]


def protein_hot_layer(name, model, gb, dev):
    """Phase 26: K1 and K2 at the hot layer of a protein model on ``gb``
    (the data's own positions at t = 0.5), each against its plain version
    and repeated bit for bit, with the live and padded edges."""
    import torch

    from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
    from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as conv_ops

    conv = getattr(model, PROT_HOT_LAYER).conv
    seen = {}
    hook = conv.register_forward_pre_hook(
        lambda mod, args: seen.update(data=args[0]))
    with torch.no_grad():
        out = model(gb)
    hook.remove()
    data = {k: v.detach() for k, v in seen["data"].items()}
    fconv = conv.full_conv
    E = data["edge_index"].shape[1]
    live = int(data["_edge_mask"].sum())
    overflow = int(out["_edge_overflow"].max())
    print(f"protein hot layer {PROT_HOT_LAYER} ({name}): N="
          f"{gb.node_capacity} E={E} R={fconv.fc_dims[0]} MLP "
          f"{fconv.fc_dims} in={fconv.fused.irreps_in} "
          f"paths={fconv.n_paths} out_dim={fconv.out_dim}; live edges "
          f"{live} of {E} ({live / int(gb['_node_mask'].sum()):.1f} per "
          f"residue), the walk spends {E - live} ({(E - live) / E:.4f}) on "
          f"padded edges; overflow {overflow}")
    if overflow:
        fail(f"{name}: the edge buffer overflowed by {overflow}")
    with torch.no_grad():
        x1 = conv.linear_1(data["input_features"])
        er = data["edge_radial"] * data["_edge_mask"]
    edges = (data["edge_spherical"], data["edge_index"][0],
             data["edge_index"][1])
    pre = 1.0 / conv.avg_num_neighbors ** 0.5
    k1_args = (conv.fc, conv.tp.linear, x1, er, *edges, x1.shape[0], pre)
    k1 = compare("K1 full_conv (protein)", lambda: fconv.launch(*k1_args),
                 lambda: fconv.plain(*k1_args))
    flat = [t.detach() for t in fconv.flat_weights(conv.fc, conv.tp.linear,
                                                   pre)]
    order = edge_order.shared(*edges[1:], x1.shape[0])
    repeats("K1 full_conv (protein)", lambda: conv_ops.launch_forward(
        fconv, x1, er, *edges, *flat, x1.shape[0], order=order))
    with torch.no_grad():
        _, scratch = conv_ops.launch_forward(fconv, x1, er, *edges, *flat,
                                             x1.shape[0], order=order)
    gout = torch.randn(x1.shape[0], fconv.out_dim,
                       generator=torch.Generator().manual_seed(51)).to(dev)
    k2_args = (x1, er, *edges, *flat, x1.shape[0], scratch, gout)
    k2 = compare_grads(
        "K2 full_conv_bwd (protein)",
        lambda: conv_ops.launch_backward(fconv, *k2_args, order=order),
        lambda: fconv.plain_backward(*k2_args),
        ("dx", "d edge_radial", "dw_hidden", "dw_out", "dwsel"))
    repeats("K2 full_conv_bwd (protein)", lambda: conv_ops.launch_backward(
        fconv, *k2_args, order=order))
    # the bound counts the work this data needs: the live edges (packed
    # first); a padded edge adds nothing to any output.  The bound of all
    # the slots the kernels walk is printed beside it.
    costs = conv_costs(conv, x1, er[:live], tuple(t[:live] for t in edges),
                       flat)
    slots = conv_costs(conv, x1, er, edges, flat)
    for key, rec in (("K1", k1), ("K2", k2)):
        rec.update(bound(*costs[key]))
        rec["share"] = rec["bound_ms"] / rec["ms"]
        rec["bound_ms_all_slots"] = bound(*slots[key])["bound_ms"]
        print(f"{key} (protein): {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by "
              f"{rec['bound_by']} over the {live} live edges, share "
              f"{rec['share']:.4f}; over all {E} slots "
              f"{rec['bound_ms_all_slots']:.4f} ms, share "
              f"{rec['bound_ms_all_slots'] / rec['ms']:.4f}")
    del scratch, k2_args
    return dict(K1=k1, K2=k2, E=E, live_edges=live, padded_edges=E - live,
                layer=PROT_HOT_LAYER)


def protein_sample(dev, name, cfg, model, gb, sde_cfg):
    """Phase 27 for one config: PC sampling of ``gb`` (scaled) at N =
    PROT_SAMPLE_STEPS, every counter set to 0 just before and read just
    after (exactly 8 K1 per score evaluation, no other kernel), the edge
    overflow of every evaluation (kept on the card, read after the loop),
    the inverse-scaled sample written as a .pdb; a profile; then the first
    steps of a 1-protein cut against the CPU plain path on replayed noise
    and edge draws."""
    import torch

    from equivariant_nn_zoo_tpu_torch.models import build_model
    from equivariant_nn_zoo_tpu_torch.run.sde_sampling import (
        get_corrector,
        get_pc_sampler,
        get_predictor,
        get_sampling_fn,
    )
    from equivariant_nn_zoo_tpu_torch.run.sde_utils import VPSDE, Noise
    from equivariant_nn_zoo_tpu_torch.utils.saveload import saveProtein

    dc, mc = cfg["data_config"], cfg["model_config"]
    n_layers = mc["num_layers"]
    sampling = dict(sde_cfg["sampling"])
    sde = VPSDE(cfg["diffusion_keys"], beta_min=sde_cfg["model"]["beta_min"],
                beta_max=sde_cfg["model"]["beta_max"], N=PROT_SAMPLE_STEPS)
    pc = get_pc_sampler(
        sde, get_predictor(sampling["predictor"]),
        get_corrector(sampling["corrector"]), None, sampling["snr"],
        sampling["n_steps_each"], eps=SAMPLING_EPS)
    sampler = get_sampling_fn(sde_cfg, sde, dc["inverse_scaler"],
                              SAMPLING_EPS)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)

    def watch(mod, args, out):
        torch.maximum(overflow, out["_edge_overflow"].max(), out=overflow)

    hook = model.register_forward_hook(watch)
    pc(model, gb, Noise(dev, 1), steps=1)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_conv_launches()
    reset_head_launches()
    t0 = time.perf_counter()
    host, nfe = sampler(model, gb, Noise(dev, 2))
    dt = time.perf_counter() - t0
    launches = {**conv_launches(), **head_launches()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hook.remove()
    overflow = int(overflow)
    n_real = int(gb["_node_mask"].sum())
    print(f"{name} sample: {PROT_BATCH} proteins ({n_real} residues) by the "
          f"PC sampler (N={sde.N}, {nfe} score evaluations) in {dt:.3f} s, "
          f"{1e3 * dt / nfe:.3f} ms per evaluation (host clock, to the host "
          f"batch); peak device memory {peak:.3f} GiB; the largest edge "
          f"overflow {overflow}; launches {launches}")
    want = {k: 0 for k in launches}
    want["full_conv"] = n_layers * nfe
    if launches != want:
        fail(f"{name} sample: launches {launches}, want {want}")
    if nfe != 2 * sde.N or overflow:
        fail(f"{name} sample: {nfe} evaluations, overflow {overflow}")
    for key in cfg["diffusion_keys"]:
        if host[key].shape != (n_real, 3) or not np.isfinite(
                host[key]).all():
            fail(f"{name} sample: {key} not finite or of shape "
                 f"{host[key].shape}")
    pdb = saveProtein(host, "chiprun_out", filename=f"sample_{name}")
    with open(pdb) as f:
        if not f.read().rstrip().endswith("END"):
            fail(f"{name} sample: {pdb} does not end in END")
    kernel_ms, n_kernels, fams = families(
        lambda: pc(model, gb, Noise(dev, 3), steps=PROT_PROFILE_STEPS),
        2 * PROT_PROFILE_STEPS)
    eval_ms = 1e3 * dt / nfe
    print(f"{name} sample: {kernel_ms:.4f} ms of kernels in {n_kernels} "
          f"launches per score evaluation under the profiler, busy "
          f"{kernel_ms / eval_ms:.4f}; by family {fams}")

    # the first sampler steps of a 1-protein cut on the card; every score
    # evaluation's input batch and edge draws again through the CPU plain
    # path.  (A whole trajectory is not compared: on these random weights
    # the sampler multiplies any difference 20-30 times a step, and float32
    # rounding alone parts the two after 3 steps.)
    small = protein_batch(cfg, synthetic_proteins(
        1, np.random.default_rng(61), sizes=(110, 121)), 62,
        PROT_CUT_RESIDUES + 1, PROT_CUT_EDGES, 1)
    small = dc["scaler"](small)
    n_draws = len(sde.irreps) * (
        1 + PROT_PARITY_STEPS * (sampling["n_steps_each"] + 1))
    draws = seeded_draws(63, [(small.node_capacity, 3)] * n_draws)
    cpu_model = build_model(mc, "cpu", torch.Generator().manual_seed(0))
    keys = [f"score_{k}" for k in sde.irreps]
    seen = []
    hook = model.register_forward_hook(lambda mod, args, out: seen.append(
        (args[0].to("cpu"), {k: out[k].cpu() for k in keys + [
            "edge_index", "_edge_overflow"]})))
    own, rand = edge_layer(model).keywords["rand"], HostRand(64)
    edge_layer(model).keywords["rand"] = rand
    pc(model, small.to(dev), Replay(draws, dev), steps=PROT_PARITY_STEPS)
    edge_layer(model).keywords["rand"] = own
    hook.remove()
    run64 = float64_plain(cpu_model)
    # the card passes where it is within TOL of the float64 result or no
    # further from it than the CPU's float32 run: in 8 normalised layers
    # float32 rounding alone can part from float64 by more than TOL
    worst = {w: (-1.0, "") for w in ("card-f64", "card-f32", "f32-f64")}
    n_edges, beyond = [], 0.0
    with torch.no_grad():
        for (batch, card), u in zip(seen, rand.draws):
            batch = batch.replace(_edge_rand=u)
            plain = cpu_model(batch)
            ref = run64(lambda m, b: m(b), batch)
            if not (torch.equal(plain["edge_index"], card["edge_index"])
                    and torch.equal(ref["edge_index"], card["edge_index"])) \
                    or int(card["_edge_overflow"].max()):
                fail(f"{name} sample: the card's edges differ from the "
                     f"CPU's on the same positions, or overflow")
            n_edges.append(int(plain["_n_edges"].sum()))
            for k in keys:
                errs = {w: worst_rel({k: a[k].double()}, {k: b[k].double()})
                        for w, a, b in (("card-f64", card, ref),
                                        ("card-f32", card, plain),
                                        ("f32-f64", plain, ref))}
                beyond = max(beyond, errs["card-f64"][0] / max(
                    TOL, errs["f32-f64"][0]))
                worst = {w: max(worst[w], errs[w]) for w in worst}
    rel = worst["card-f64"]
    print(f"{name} sample, card vs CPU plain path on each of the "
          f"{len(seen)} score evaluations of the first {PROT_PARITY_STEPS} "
          f"steps (1 protein, {int(small['_node_mask'].sum())} residues, "
          f"{min(n_edges)}-{max(n_edges)} live edges of {PROT_CUT_EDGES}, "
          f"the same edges on all three): worst rel card vs float64 "
          f"{rel[0]:.3e} ({rel[1]}), card vs float32 "
          f"{worst['card-f32'][0]:.3e}, float32 vs float64 "
          f"{worst['f32-f64'][0]:.3e}; the card's error over the larger "
          f"of {TOL} and the float32 run's, at most {beyond:.3f}")
    if len(seen) != 2 * PROT_PARITY_STEPS or beyond > 1.0:
        fail(f"{name} sample: the card is {rel[0]:.3e} from the float64 "
             f"plain path, beyond both {TOL} and the CPU's float32 run "
             f"(over {len(seen)} evaluations)")
    return cpu_model, dict(
        nfe=nfe, launches=launches["full_conv"], s_per_batch=dt,
        ms_per_evaluation=eval_ms, kernel_ms_per_evaluation=kernel_ms,
        launches_per_evaluation={k: v / nfe for k, v in launches.items()
                                 if v},
        kernels_per_evaluation=n_kernels, families=fams,
        busy=kernel_ms / eval_ms, peak_gib=peak, parity_rel=rel[0],
        parity_rel_f32=worst["card-f32"][0], f32_rel=worst["f32-f64"][0],
        s_per_1000_steps=1e3 * dt / sde.N)


def protein_train(dev, name, cfg, model, cpu_model, gb, sde_cfg):
    """Phase 28 for one config: ``get_step_fn`` with the config's own
    settings (Adam lr 1e-2, grad_acc 4, clip 1.0, EMA 0.99 with
    num_updates): 8 K1 and 8 K2 in a micro-step, an update on every 4th,
    12 timed micro-steps, peak memory, a profile; then one micro-step's
    loss and gradients on the cut, card against the CPU plain path, on
    the same t, z and edge draws."""
    import torch

    from equivariant_nn_zoo_tpu_torch.run.sde_utils import (
        VPSDE,
        Noise,
        adam,
        get_sde_loss_fn,
        get_step_fn,
        init_sde_state,
    )

    n_layers = cfg["model_config"]["num_layers"]
    grad_acc = cfg["grad_acc"]
    sde = VPSDE(cfg["diffusion_keys"], beta_min=sde_cfg["model"]["beta_min"],
                beta_max=sde_cfg["model"]["beta_max"],
                N=sde_cfg["model"]["num_scales"])
    model.train()
    optimizer = adam(model, cfg["learning_rate"])
    state = init_sde_state(model, Noise(dev, 5))
    reduce_mean = sde_cfg["training"]["reduce_mean"]
    step = get_step_fn(
        sde, True, model=model, optimizer=optimizer, reduce_mean=reduce_mean,
        continuous=sde_cfg["training"]["continuous"],
        likelihood_weighting=sde_cfg["training"]["likelihood_weighting"],
        grad_clid_norm=cfg["grad_clid_norm"], grad_acc=grad_acc,
        ema_decay=cfg["ema_decay"],
        ema_use_num_updates=cfg["ema_use_num_updates"])
    for _ in range(PROT_TRAIN_WARMUP - 1):
        state, loss, _ = step(state, gb)
    torch.cuda.synchronize()
    reset_conv_launches()
    reset_head_launches()
    state, loss, _ = step(state, gb)
    per_step = {k: v for k, v in {**conv_launches(),
                                  **head_launches()}.items() if v}
    print(f"{name} train launches in one micro-step: {per_step}")
    if per_step != {"full_conv": n_layers, "full_conv_bwd": n_layers}:
        fail(f"{name} train: launches {per_step}, want {n_layers} K1 and "
             f"{n_layers} K2")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_conv_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(PROT_TRAIN_STEPS):
        state, loss, _ = step(state, gb)
        losses.append(loss)
    torch.cuda.synchronize()
    micro_ms = 1e3 * (time.perf_counter() - t0) / PROT_TRAIN_STEPS
    timed = conv_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(losses).cpu()
    applied = {int(optimizer.state[p]["step"]) for p in model.parameters()}
    print(f"{name} train: {micro_ms:.3f} ms per micro-step of "
          f"{PROT_BATCH} proteins, {grad_acc * micro_ms:.3f} ms per applied "
          f"step (grad_acc {grad_acc}; host clock around synchronize, "
          f"{PROT_TRAIN_STEPS} micro-steps); peak device memory "
          f"{peak:.3f} GiB; Adam steps {applied}; losses {losses.tolist()}")
    n_micro = PROT_TRAIN_WARMUP + PROT_TRAIN_STEPS
    if applied != {n_micro // grad_acc}:
        fail(f"{name} train: Adam stepped {applied} times in {n_micro} "
             f"micro-steps, want {n_micro // grad_acc}")
    if not torch.isfinite(losses).all():
        fail(f"{name} train: non-finite loss")
    kernel_ms, n_kernels, fams = families(
        lambda: [step(state, gb) for _ in range(grad_acc)], grad_acc)
    print(f"{name} train: {kernel_ms:.3f} ms of kernels in {n_kernels} "
          f"launches per micro-step under the profiler, busy "
          f"{kernel_ms / micro_ms:.4f}; by family {fams}")

    # one micro-step's loss and gradients on the cut, card against CPU
    small = protein_batch(cfg, synthetic_proteins(
        1, np.random.default_rng(65), sizes=(110, 121)), 66,
        PROT_CUT_RESIDUES + 1, PROT_CUT_EDGES, 1)
    small = cfg["data_config"]["scaler"](small)
    n = small.node_capacity
    small = small.replace(_edge_rand=torch.rand(
        n, n, generator=torch.Generator().manual_seed(67)))
    draws = seeded_draws(68, [(1, 1)] + [(n, 3)] * len(sde.irreps),
                         uniform_first=True)
    loss_fn = get_sde_loss_fn(sde, True, reduce_mean=reduce_mean)

    def gradients(m, d, batch=small):
        m.zero_grad(set_to_none=True)
        value, _ = loss_fn(m, batch.to(d), Replay(draws, d))
        value.backward()
        return value.item(), {
            k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
            for k, p in m.named_parameters()}

    from equivariant_nn_zoo_tpu_torch.models import build_model

    card_loss, card = gradients(build_model(
        cfg["model_config"], generator=torch.Generator().manual_seed(0)),
        dev)
    cpu_loss, plain = gradients(cpu_model, "cpu")
    run64 = float64_plain(cpu_model)
    ref_loss, ref = run64(lambda m, b: gradients(m, "cpu", b), small)
    worst, n_small = worst_gradient_rel(card, ref)
    f32, _ = worst_gradient_rel(plain, ref)
    vs32, _ = worst_gradient_rel(card, plain)
    # as in phase 27: within TOL of float64, or no further from it than
    # the CPU's float32 run, tensor by tensor
    floor = 1e-12 * max(float(g.abs().max()) for g in ref.values())
    beyond = max((worst_rel({k: card[k]}, {k: ref[k]})[0] / max(
        TOL, worst_rel({k: plain[k]}, {k: ref[k]})[0]), k)
        for k in ref if float(ref[k].abs().max()) >= floor)
    print(f"{name} train parity (1 protein): loss card {card_loss} CPU "
          f"float32 {cpu_loss} float64 {ref_loss}; worst gradient rel, card "
          f"vs float64 {worst[0]:.3e} ({worst[1]}), card vs float32 "
          f"{vs32[0]:.3e} ({vs32[1]}), float32 vs float64 {f32[0]:.3e} "
          f"({f32[1]}), over {len(ref) - n_small} tensors ({n_small} zero "
          f"by symmetry); the card's error over the larger of {TOL} and "
          f"the float32 run's, at most {beyond[0]:.3f} ({beyond[1]})")
    if abs(card_loss - ref_loss) > max(TOL * abs(ref_loss),
                                       abs(cpu_loss - ref_loss)):
        fail(f"{name} train parity: the loss differs")
    if any(not torch.isfinite(g).all() for g in card.values()):
        fail(f"{name} train parity: non-finite gradients on the card")
    if beyond[0] > 1.0:
        fail(f"{name} train parity: {beyond[1]} gradient {beyond[0]:.3f} "
             f"times the larger of {TOL} and the float32 run's error")
    return dict(launches={k: timed[k] for k in per_step},
                micro_step_ms=micro_ms, applied_step_ms=grad_acc * micro_ms,
                kernel_ms_per_micro_step=kernel_ms,
                kernels_per_micro_step=n_kernels, families=fams,
                busy=kernel_ms / micro_ms, peak_gib=peak, per_step=per_step,
                parity_rel=worst[0], parity_rel_f32=vs32[0],
                f32_rel=f32[0])


def protein_phases(dev):
    """Phases 26-28 of the module docstring (``config_diffusion_CA``, then
    ``config_diffusion_backbone``, at full width and depth on synthetic
    proteins); returns what K1 and K2 did on this path, by kernel record
    name, and the path's figures by config."""
    import torch

    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.models.sde_config import (
        get_config as sde_get_config,
    )
    from equivariant_nn_zoo_tpu_torch.run.sde_utils import with_t

    sde_cfg = sde_get_config()
    prots = synthetic_proteins(PROT_BATCH, np.random.default_rng(60))
    out, path = {}, {}
    for name in PROTEIN_CONFIGS:
        cfg = get_config(name)
        if cfg["batch_size"] != PROT_BATCH:
            fail(f"{name}: batch {cfg['batch_size']}, not {PROT_BATCH}")
        mc = cfg["model_config"]
        # no device argument: the entry point builds on the card by default
        model = build_model(mc, generator=torch.Generator().manual_seed(0))
        model.eval()
        if next(model.parameters()).device.type != "cuda":
            fail("build_model without a device did not build on the card")
        gb = protein_batch(cfg, prots, 60, PROT_BATCH * PROT_RESIDUES + 1,
                           cfg["data_config"]["edge_capacity"], PROT_BATCH)
        gb = cfg["data_config"]["scaler"](gb.to(dev))
        print(f"{name}: {sum(p.numel() for p in model.parameters())} "
              f"parameters; {PROT_BATCH} proteins, "
              f"{int(gb['_node_mask'].sum())} residues, N={gb.node_capacity}"
              f" E={gb.edge_capacity}")
        if any(getattr(m, "species_sc", None) is not None
               for m in model.modules()):
            fail(f"{name}: a self-connection took the species tables")
        hot = None
        if name == PROTEIN_CONFIGS[0]:
            hot = protein_hot_layer(name, model, with_t(gb, torch.full(
                (PROT_BATCH, 1), 0.5, device=dev)), dev)
        cpu_model, sample = protein_sample(dev, name, cfg, model, gb,
                                           sde_cfg)
        train = protein_train(dev, name, cfg, model, cpu_model, gb, sde_cfg)
        path[name] = dict(sample=sample, train=train)
        if hot is not None:
            where = dict(config=name, layer=hot["layer"], E=hot["E"],
                         live_edges=hot["live_edges"],
                         padded_edges=hot["padded_edges"])
            out["full_conv"] = dict(
                hot["K1"], launches=sample["launches"],
                per_evaluation=sample["launches"] / sample["nfe"], **where)
            out["full_conv_bwd"] = dict(
                hot["K2"], launches=train["launches"]["full_conv_bwd"],
                per_micro_step=train["per_step"]["full_conv_bwd"], **where)
        del model, cpu_model
        torch.cuda.empty_cache()
    out["path"] = path
    return out


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
    from equivariant_nn_zoo_tpu_torch.ops.cuda import row_mix as rm_ops
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
    # ------------------------------------- K1, K3, K2, K3b and the mix GEMM
    checks, costs, (mix_fwd, mix_bwd) = trunk_checks(
        model, batches[0], dev, HOT_LAYER, "energy", mix=True)
    k1, k3, k2, k3b = (checks[k] for k in ("K1", "K3", "K2", "K3b"))

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
    diffusion = diffusion_phases(dev)
    dipole = dipole_phases(dev)
    protein = protein_phases(dev)

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
        mix_record("row_mix_products", "fused_conv.py:1051",
                   mix_launches["backward"], mix_bwd),
    ]
    # K1, K2 and the K4 family also carry what they did on the diffusion
    # path (spec "" for K1 and K2, "nll" for the K4 family)
    for record in kernels:
        if record["name"] in diffusion:
            record["diffusion"] = diffusion[record["name"]]
    # K1, K3, K2 and K3b also carry what they did on the dipole path
    for record in kernels:
        if record["name"] in dipole:
            record["dipole"] = dipole[record["name"]]
    # K1 and K2 also carry what they did on the protein path
    for record in kernels:
        if record["name"] in protein:
            record["protein"] = protein[record["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def diffusion_only():
    """``python3 chip_smoke.py --diffusion``: the build, then phases 19-21
    alone; the diffusion records as one JSON line."""
    import torch

    from equivariant_nn_zoo_tpu_torch.ops.cuda.build import build

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib, _ = build()
    print(f"build: {os.path.relpath(lib)} in "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"diffusion": diffusion_phases(torch.device("cuda"))}))


def dipole_only():
    """``python3 chip_smoke.py --dipole``: the build, then phases 22-25
    alone; the dipole records as one JSON line."""
    import torch

    from equivariant_nn_zoo_tpu_torch.ops.cuda.build import build

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib, _ = build()
    print(f"build: {os.path.relpath(lib)} in "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"dipole": dipole_phases(torch.device("cuda"))}))


def protein_only():
    """``python3 chip_smoke.py --protein``: the build, then phases 26-28
    alone; the protein records as one JSON line."""
    import torch

    from equivariant_nn_zoo_tpu_torch.ops.cuda.build import build

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    t0 = time.perf_counter()
    lib, _ = build()
    print(f"build: {os.path.relpath(lib)} in "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"protein": protein_phases(torch.device("cuda"))}))


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
    layer (the first 128-graph batch of phase 7), at the l = 4 hot layer
    of a 512- and a 16-molecule batch (phases 14-16) and at the diffusion
    and dipole hot layers (phases 19 and 22), each C entry through
    ``launch_forward`` / ``launch_backward``, with each kernel's device ms
    per call (``kernel_split``) and a digest of each entry's outputs (two
    checkouts whose kernels compute alike print the same); one JSON line.
    K2 gets the forward's edge order where the package has one."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    import equivariant_nn_zoo_tpu_torch as pkg
    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as conv_ops
    from equivariant_nn_zoo_tpu_torch.run.sde_utils import with_t

    try:
        from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
    except ImportError:
        edge_order = None
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    energy = synthetic_qm9(N_BATCHES * BATCH, np.random.default_rng(0))
    water = synthetic_h2o(N_BATCHES * max(H2O_BATCHES),
                          np.random.default_rng(20))
    cases = (("energy", "config_energy", energy, BATCH, HOT_LAYER),
             ("l4_3072", "config_hamiltonian", water, max(H2O_BATCHES),
              HOT_LAYER),
             ("l4_96", "config_hamiltonian", water, min(H2O_BATCHES),
              HOT_LAYER),
             ("diffusion", "config_diffusion", synthetic_diffusion_mols(
                 DIFF_BATCH, np.random.default_rng(21)), DIFF_BATCH,
              DIFF_HOT_LAYER),
             ("dipole", "config_dipole", synthetic_dipole_mols(
                 DIPOLE_BATCH, np.random.default_rng(30)), DIPOLE_BATCH,
              DIPOLE_HOT_LAYER))
    times, models = {}, {}
    for key, name, mols, size, layer in cases:
        if name not in models:
            models[name] = build_model(get_config(name)["model_config"], dev,
                                       torch.Generator().manual_seed(0))
        model = models[name]
        gb = make_batches(mols[:N_BATCHES * size], dev, size)[0]
        if name == "config_diffusion":
            gb = with_t(gb, torch.full((size, 1), 0.5, device=dev))
        conv = getattr(model, layer).conv
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
                   "K2_kernels": kernel_split(k2), "K1_digest": digest(k1()),
                   "K2_digest": digest(k2())}
        times[key] = rec
        print(f"{key}: N={N} E={rec['E']} K1 {rec['K1_ms']:.4f} ms "
              f"{rec['K1_kernels']} digest {rec['K1_digest']}, K2 "
              f"{rec['K2_ms']:.4f} ms {rec['K2_kernels']} digest "
              f"{rec['K2_digest']}")
    print(json.dumps({"package": os.path.dirname(pkg.__file__),
                      "card": torch.cuda.get_device_name(0),
                      "conv_times": times}))


def ext_times(calls_only=False):
    """``python3 chip_smoke.py --ext-times``: the force path's three C
    entries (K4f, K4b, K4g) of the package in the current directory (run it
    from two checkouts in turn to compare them on one card), at
    ``config_energy_force``'s hot layer (phase 10's shapes and seeds), ms
    per call with CUDA events and each kernel's device ms
    (``kernel_split``); K4b both on K4f's saved scratch and with the
    scratch recomputed where the package has both (an older one only
    recomputes).  Then the force training step (``run.Trainer`` with the
    config's settings on phase 12's batches: host ms per step around
    ``synchronize`` over 12 steps, peak memory, and kernel ms per step by
    family over 4 profiled steps) and force serving (energies and forces of
    phase 11's 4 batches: host ms per batch, kernel ms per batch by
    family).  One JSON line.  ``--ext-calls`` times the three entries
    alone (``calls_only``)."""
    import inspect

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    import equivariant_nn_zoo_tpu_torch as pkg
    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv_ext as ext
    from equivariant_nn_zoo_tpu_torch.run import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("config_energy_force")
    mc = cfg["model_config"]
    batches = make_batches(synthetic_fragments(
        N_BATCHES * FORCE_BATCH, np.random.default_rng(10)), dev, FORCE_BATCH)
    model = build_model(mc, dev, torch.Generator().manual_seed(0))
    model.eval()
    fc, (x, sh, w, wsel, src, dst, N, cx, csh, cw, gout) = force_hot_layer(
        model, batches[0], dev)
    fa = (x, sh, w, wsel, src, dst, N)
    ga = (x, cx, sh, csh, w, cw, wsel, src, dst, N, gout)
    walks = "order" in inspect.signature(ext.launch_backward).parameters
    rec = {"N": N, "E": int(sh.shape[0]), "walks": walks}
    with torch.no_grad():
        entries = {}
        if walks:
            from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order

            kw = {"order": edge_order.shared(src, dst, N)}
            saved = ext.launch_forward(fc, *fa, **kw)[1]
            entries["K4f"] = lambda: ext.launch_forward(fc, *fa, **kw)
            entries["K4b"] = lambda: ext.launch_backward(
                fc, *fa, gout, scratch=saved, **kw)
            entries["K4b_recomputed"] = lambda: ext.launch_backward(
                fc, *fa, gout, **kw)
            entries["K4g"] = lambda: ext.launch_grad2(fc, *ga, **kw)
        else:
            entries["K4f"] = lambda: ext.launch_forward(fc, *fa)
            entries["K4b_recomputed"] = lambda: ext.launch_backward(
                fc, *fa, gout)
            entries["K4g"] = lambda: ext.launch_grad2(fc, *ga)
        for name, fn in entries.items():
            rec[name] = {"ms": cuda_ms(fn), "kernels": kernel_split(fn)}
            print(f"{name}: {rec[name]['ms']:.4f} ms {rec[name]['kernels']}",
                  flush=True)
    del entries, fa, ga, x, sh, w, cx, csh, cw, gout
    if walks:
        del saved, kw
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if calls_only:
        print(json.dumps({"package": os.path.dirname(pkg.__file__),
                          "card": smi.stdout.strip(), "ext_times": rec}))
        return

    # ------------------------------------------------------- force serve
    def serve():
        with torch.no_grad():
            for gb in batches:
                model(gb)

    serve()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        serve()
    torch.cuda.synchronize()
    host = 1e3 * (time.perf_counter() - t0) / (3 * len(batches))
    kms, launches, fams = families(serve, len(batches))
    rec["serve"] = {"host_ms": host, "kernel_ms": kms, "launches": launches,
                    "families": fams}
    print(f"force serve: {host:.3f} ms per {FORCE_BATCH}-graph batch (host),"
          f" {kms} ms of kernels in {launches} launches; {fams}", flush=True)

    # ------------------------------------------------------- force train
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    train = make_batches(synthetic_fragments(
        5 * FORCE_BATCH, np.random.default_rng(11)), dev, FORCE_BATCH)[:4]
    trainer = Trainer(build_model(mc, dev, torch.Generator().manual_seed(0)),
                      **settings)
    for gb in train[:2]:
        trainer.batch_step(gb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        for gb in train:
            trainer.batch_step(gb)
    torch.cuda.synchronize()
    host = 1e3 * (time.perf_counter() - t0) / (3 * len(train))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kms, launches, fams = families(
        lambda: [trainer.batch_step(gb) for gb in train], len(train))
    rec["step"] = {"host_ms": host, "kernel_ms": kms, "launches": launches,
                   "peak_gib": peak, "families": fams}
    print(f"force step: {host:.3f} ms (host), {kms} ms of kernels in "
          f"{launches} launches, peak {peak:.3f} GiB; {fams}", flush=True)
    print(json.dumps({"package": os.path.dirname(pkg.__file__),
                      "card": smi.stdout.strip(), "ext_times": rec}))


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


def sc_library(ssc, x, spec, tables, g):
    """The library set of K3 and K3b: one ``torch.matmul`` per (species
    present, item) on contiguous species-sorted copies, made here and not
    timed (K3: X_t [n_t d, mul1] @ A_t; K3b: G_t @ A_t^T and X_t^T @ G_t).
    Returns the two lists of operand pairs."""
    fwd, bwd = [], []
    for out_off, d, mo, it0, it1 in ssc.outs:
        for x_off, mul1, a_off in ssc.items[it0:it1]:
            for t in range(ssc.num_types):
                nodes = (spec == t).nonzero().reshape(-1)
                if nodes.numel() == 0:
                    continue
                X = x[nodes, x_off: x_off + mul1 * d].reshape(-1, mul1, d) \
                    .transpose(1, 2).reshape(-1, mul1).contiguous()
                G = g[nodes, out_off: out_off + mo * d].reshape(-1, mo, d) \
                    .transpose(1, 2).reshape(-1, mo).contiguous()
                A = tables[t, a_off: a_off + mul1 * mo].reshape(mul1, mo) \
                    .contiguous()
                fwd.append((X, A))
                bwd += [(G, A.t().contiguous()), (X.t().contiguous(), G)]
    return fwd, bwd


def sc_times(calls_only=False):
    """``python3 chip_smoke.py --sc-times``: K3 and K3b of the package in
    the current directory (run it from two checkouts in turn to compare them
    on one card), each C entry through ``launch_forward`` /
    ``launch_backward`` on fixed tables (on the species order where the
    package has one), at ``config_energy``'s hot layer (phases 4 and 6:
    the first 128-graph batch, the cotangent's seed) and at the l = 4 hot
    layer of a 512-molecule ``config_hamiltonian`` batch (phases 14 and
    16): ms per call with CUDA events (and of the wrapper's whole
    forward, ``launch``), each kernel's device ms
    (``kernel_split``), the library set's ms (``sc_library``: a set of
    ``torch.matmul`` calls, not one call) and the bounds (``sc_costs``);
    then the energy training step (``energy_step_times``).  One JSON
    line.  With ``calls_only`` (``--sc-calls``) the C entries alone, with
    their kernels' device ms."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    import equivariant_nn_zoo_tpu_torch as pkg
    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as sc_ops

    try:
        from equivariant_nn_zoo_tpu_torch.ops.cuda import species_order
    except ImportError:
        species_order = None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    size = max(H2O_BATCHES)
    cases = (("energy", "config_energy",
              synthetic_qm9(BATCH, np.random.default_rng(0)), BATCH),
             (f"l4_{size}", "config_hamiltonian",
              synthetic_h2o(size, np.random.default_rng(20)), size))
    times = {}
    for key, name, mols, n_mol in cases:
        model = build_model(get_config(name)["model_config"], dev,
                            torch.Generator().manual_seed(0))
        model.eval()
        gb = make_batches(mols, dev, n_mol)[0]
        conv, seen = getattr(model, HOT_LAYER).conv, {}
        ssc = conv.species_sc
        hook = conv.register_forward_pre_hook(
            lambda mod, args: seen.update(data=args[0]))
        with torch.no_grad():
            model(gb)
            hook.remove()
            data = seen["data"]
            x, spec = data["input_features"], data["species"].reshape(-1)
            tables = ssc.tables(conv.sc, data["node_attrs"], spec) \
                .contiguous()
            N = x.shape[0]
            g = torch.randn(N, ssc.irreps_out.dim, generator=torch.Generator(
            ).manual_seed(2)).to(dev)
            kw = {} if species_order is None else {
                "order": species_order.shared(spec, ssc.num_types)}

            def k3():
                return sc_ops.launch_forward(ssc, x, spec, tables, **kw)

            def k3b():
                return sc_ops.launch_backward(ssc, x, spec, tables, g, **kw)

            rec = {"N": N, "species_present": int(spec.unique().numel()),
                   "K3_ms": cuda_ms(k3), "K3b_ms": cuda_ms(k3b),
                   "K3_kernels": kernel_split(k3),
                   "K3b_kernels": kernel_split(k3b),
                   # the wrapper's whole forward: the tables, the order
                   # where the package has one, K3; host-bound
                   "K3_launch_ms": cuda_ms(lambda: ssc.launch(
                       conv.sc, x, data["node_attrs"], data["species"]))}
            if calls_only:
                print(f"{key}: N={N} K3 {rec['K3_ms']:.4f} ms "
                      f"{rec['K3_kernels']} (launch "
                      f"{rec['K3_launch_ms']:.4f}); K3b "
                      f"{rec['K3b_ms']:.4f} ms {rec['K3b_kernels']}",
                      flush=True)
                times[key] = rec
                del model, seen, data
                continue
            lib_f, lib_b = sc_library(ssc, x, spec, tables, g)
            rec.update(library_K3_ms=cuda_ms(
                lambda: [torch.matmul(a, b) for a, b in lib_f]),
                library_K3b_ms=cuda_ms(
                lambda: [torch.matmul(a, b) for a, b in lib_b]),
                library_calls=[len(lib_f), len(lib_b)])
            costs = sc_costs(conv, x, data["node_attrs"], tables, spec, g)
        for k in ("K3", "K3b"):
            b = bound(*costs[k])
            rec[f"{k}_bound_ms"], rec[f"{k}_bound_by"] = b["bound_ms"], \
                b["bound_by"]
        times[key] = rec
        print(f"{key}: N={N} K3 {rec['K3_ms']:.4f} ms {rec['K3_kernels']} "
              f"(library set {rec['library_K3_ms']:.4f}, bound "
              f"{rec['K3_bound_ms']:.4f}); K3b {rec['K3b_ms']:.4f} ms "
              f"{rec['K3b_kernels']} (library set "
              f"{rec['library_K3b_ms']:.4f}, bound "
              f"{rec['K3b_bound_ms']:.4f})", flush=True)
        del model, lib_f, lib_b, seen, data
    if not calls_only:
        times["energy_step"] = energy_step_times(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"package": os.path.dirname(pkg.__file__),
                      "card": smi.stdout.strip(), "sc_times": times}))


def energy_step_times(dev):
    """The ``config_energy`` training step of the package in the current
    directory at batch 128 (4 labelled batches): host ms per step over 3
    passes after a warm-up pass, and kernel ms per step in all, of the mix
    GEMM family and by kernel (``kernel_split`` over 2 passes)."""
    import torch

    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.run import Trainer

    cfg = get_config("config_energy")
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    train = make_batches(synthetic_qm9(4 * BATCH, np.random.default_rng(11),
                                       labels=True), dev)
    trainer = Trainer(build_model(cfg["model_config"], dev,
                                  torch.Generator().manual_seed(0)),
                      **settings)

    def steps():
        for b in train:
            trainer.batch_step(b)

    steps()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        steps()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / (3 * len(train))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split = kernel_split(steps, n=2)
    rec = dict(
        host_ms=host_ms, peak_gib=peak,
        kernel_ms=sum(split.values()) / len(train),
        products_ms=sum(v for k, v in split.items() if k in MIX_KERNELS)
        / len(train),
        kernels={k: round(v / len(train), 4) for k, v in split.items()})
    print(f"energy step: host {host_ms:.3f} ms, kernels "
          f"{rec['kernel_ms']:.3f} ms, mix GEMM family "
          f"{rec['products_ms']:.3f} ms per step, peak {peak:.3f} GiB",
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
      (M = 3072) (K6 and K6b make their products in their own fused
      kernels: ``--uvu-times``);
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
    tpk = hmodel.pairwise.pairwise_tp
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
        del ops, S5, bw, seen
    del hmodel

    # ------------------------------------------------- the energy step
    sets["energy_step"] = energy_step_times(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"package": os.path.dirname(pkg.__file__),
                      "card": smi.stdout.strip(), "mix_times": sets}))


# the K5 backward entry's CUDA-core sweeps in kernel_split's names: the
# adjoint sweep and its ordered d left sums, and a parent checkout's two
# sweeps
PW_SWEEPS = ("pairwise_adj_kernel", "pairwise_da_sum_kernel",
             "pairwise_da_kernel", "pairwise_dbw_kernel")
PW_PARTS = {7: (True, True, True), 1: (False, False, True),
            2: (True, False, False), 4: (False, True, False)}


def pw_serve_and_step(dev, cfg, mols, rec):
    """--pw-times' end-to-end part: hamiltonian serving at batch 16 and
    512 (host ms per forward over 3 passes of 4 batches, kernel ms by
    profile family over 4, peak memory), then the training step at batch
    16 and 128 (host ms per step over 12 steps, kernel ms by family over
    4, peak memory), into ``rec``."""
    import torch

    from equivariant_nn_zoo_tpu_torch.models import build_model
    from equivariant_nn_zoo_tpu_torch.run import Trainer

    model = build_model(cfg["model_config"], dev,
                        torch.Generator().manual_seed(0))
    model.eval()
    for size in H2O_BATCHES:
        batches = make_batches(mols[:N_BATCHES * size], dev, size)

        def forwards():
            for gb in batches:
                model(gb)

        with torch.no_grad():
            forwards()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(3):
                forwards()
            torch.cuda.synchronize()
            host = 1e3 * (time.perf_counter() - t0) / (3 * len(batches))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            kms, launches, fams = families(forwards, len(batches))
        rec[f"serve_{size}"] = dict(host_ms=host, kernel_ms=kms,
                                    launches=launches, peak_gib=peak,
                                    families=fams)
        print(f"hamiltonian serve, batch {size}: {host:.3f} ms (host), "
              f"{kms} ms of kernels in {launches} launches, peak "
              f"{peak:.3f} GiB; {fams}", flush=True)
        del batches
    del model
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    labelled = synthetic_h2o(5 * H2O_TRAIN_BATCHES[0] + N_BATCHES
                             * H2O_TRAIN_BATCHES[1],
                             np.random.default_rng(21), labels=True)
    trainer = Trainer(build_model(cfg["model_config"], dev,
                                  torch.Generator().manual_seed(0)),
                      **settings)
    small = make_batches(labelled[:5 * H2O_TRAIN_BATCHES[0]], dev,
                         H2O_TRAIN_BATCHES[0])[:4]
    big = make_batches(labelled[5 * H2O_TRAIN_BATCHES[0]:], dev,
                       H2O_TRAIN_BATCHES[1])
    for size, group in zip(H2O_TRAIN_BATCHES, (small, big)):
        def steps():
            for gb in group:
                trainer.batch_step(gb)

        steps()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            steps()
        torch.cuda.synchronize()
        host = 1e3 * (time.perf_counter() - t0) / (3 * len(group))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kms, launches, fams = families(steps, len(group))
        rec[f"step_{size}"] = dict(host_ms=host, kernel_ms=kms,
                                   launches=launches, peak_gib=peak,
                                   families=fams)
        print(f"hamiltonian step, batch {size}: {host:.3f} ms (host), "
              f"{kms} ms of kernels in {launches} launches, peak "
              f"{peak:.3f} GiB; {fams}", flush=True)


def pw_times(calls_only=False):
    """``python3 chip_smoke.py --pw-times``: the K5 forward entry
    (``pairwise_tp_fwd``) and backward entry (``pairwise_tp_bwd``: K5m,
    K5a, K5b) of the package in the current directory (run it from two
    checkouts in turn to compare them on one card) at the full-width
    hamiltonian head, on the inputs that one forward of a 512- and of a
    16-molecule batch gives them (phases 15-16: ``tp_off`` on the edges,
    ``tp`` on the node rows, M = 3072, 1537, 96 and 49; seeded
    cotangents): the forward, and the backward for parts 7 (every
    cotangent), 1 (dwsel, K5m), 2 (d left) and 4 (dbw): ms per call with
    CUDA events, each kernel's device ms (``kernel_split``), the forward's
    and K5m's bounds (``fused_bound``), and the adjoint sweep's byte bound
    (dS and, for d left, bw read once, for dbw a read once; dbw and d left
    written once) and its share of the sweeps' device ms, and a digest of
    each call's outputs (two checkouts whose kernels agree bit for bit give
    the same).  Then hamiltonian serving at batch 16 and 512 and the
    training step at batch 16 and 128 (``pw_serve_and_step``).  One JSON
    line.  ``--pw-calls``: the entries alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    import equivariant_nn_zoo_tpu_torch as pkg
    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as k5_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("config_hamiltonian")
    model = build_model(cfg["model_config"], dev,
                        torch.Generator().manual_seed(0))
    model.eval()
    tpk = model.pairwise.pairwise_tp
    cg = 2 * tpk.mul * tpk.nz_count            # per element
    mix = mix_flops(tpk.prob_rows, 1)          # per element
    mols = synthetic_h2o(N_BATCHES * max(H2O_BATCHES),
                         np.random.default_rng(20))
    gen = torch.Generator().manual_seed(5)
    rec = {}
    for size in sorted(H2O_BATCHES, reverse=True):
        gb = make_batches(mols[:N_BATCHES * size], dev, size)[0]
        for which, (tpe, left, right) in zip(
                ("tp_off", "tp"), capture_head_inputs(model, gb)["K5"]):
            M = left.shape[0]
            with torch.no_grad():
                bw = tpk.weighted_right(tpe.tp.weight, right)
                wsel = tpk.flat_wsel(tpe.linear)
                gout = torch.randn(M, tpk.out_dim, generator=gen).to(dev)

                def forward():
                    return k5_ops.launch_forward(tpk, left, bw, wsel)

                split = kernel_split(forward)
                b = fused_bound(M * cg, M * mix, nbytes(left, bw, wsel)
                                + M * tpk.out_dim * 4)
                key = f"{which}_{M}_forward"
                rec[key] = dict(M=M, ms=cuda_ms(forward), kernels=split,
                                digest=digest(forward()), **b)
                print(f"K5 forward {key}: entry {rec[key]['ms']:.4f} ms "
                      f"(bound {b['bound_ms']:.4f} by {b['bound_by']}, "
                      f"float32 {b['bound_f32_ms']:.4f}); {split}",
                      flush=True)
                for parts, wanted in PW_PARTS.items():
                    def entry():
                        return k5_ops.launch_backward(tpk, left, bw, wsel,
                                                      gout, wanted)

                    split = kernel_split(entry)
                    sweep = round(sum(v for k, v in split.items()
                                      if k in PW_SWEEPS), 4)
                    n_bytes = M * tpk.KM * 4 + (
                        nbytes(bw, left) if wanted[0] else 0) + (
                        nbytes(left, bw) if wanted[1] else 0)
                    b = bound(3 * 2 * tpk.mul * tpk.nz_count * M
                              * (wanted[0] + wanted[1]), n_bytes)
                    key = f"{which}_{M}_parts{parts}"
                    rec[key] = dict(M=M, parts=parts, ms=cuda_ms(entry),
                                    kernels=split, digest=digest(entry()))
                    if wanted[0] or wanted[1]:
                        rec[key].update(
                            sweep_ms=sweep, sweep_bound_ms=b["bound_ms"],
                            sweep_bound_by=b["bound_by"],
                            sweep_share=b["bound_ms"] / max(sweep, 1e-9))
                    else:
                        rec[key]["k5m_bound"] = fused_bound(
                            M * cg, M * mix, nbytes(left, bw, gout, wsel))
                    print(f"K5 backward {key}: entry {rec[key]['ms']:.4f} "
                          f"ms, sweeps {sweep} ms (bound "
                          f"{b['bound_ms']:.4f} by {b['bound_by']}); "
                          f"{split}", flush=True)
            del bw, gout
    del model
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if not calls_only:
        pw_serve_and_step(dev, cfg, mols, rec)
    print(json.dumps({"package": os.path.dirname(pkg.__file__),
                      "card": smi.stdout.strip(), "pw_times": rec}))


def uvu_times(calls_only=False):
    """``python3 chip_smoke.py --uvu-times``: the K6 entry
    (``uvu_conv_fwd``) and the K6b entry (``uvu_conv_bwd``) of the package
    in the current directory (run it from two checkouts in turn to compare
    them on one card; a parent checkout's entries take and return the
    forward's scratch) at the full-width hamiltonian head, on the inputs
    that one forward of a 512-, a 128- and a 16-molecule batch gives the
    head's conv (E = 3072, 768, 96; a seeded cotangent, the edges'
    source-major order): ms per call with CUDA events, each kernel's device
    ms (``kernel_split``), the bounds (``fused_bound``: the tensor cores
    counted, and every operation on the float32 CUDA cores) and the share
    of each, and each entry at every cut that its plan chooses from.  Then
    hamiltonian serving at batch 16 and 512 and the training step at
    batch 16 and 128 (``pw_serve_and_step``).  One JSON line.
    ``--uvu-calls``: the entries alone."""
    import inspect

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    import equivariant_nn_zoo_tpu_torch as pkg
    from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
    from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
    from equivariant_nn_zoo_tpu_torch.ops.cuda import uvu_conv as k6_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("config_hamiltonian")
    model = build_model(cfg["model_config"], dev,
                        torch.Generator().manual_seed(0))
    model.eval()
    uvu = model.pairwise.conv.full_conv
    saves = "scratch" in inspect.signature(k6_ops.launch_backward).parameters
    mols = synthetic_h2o(max(H2O_BATCHES), np.random.default_rng(20))
    gen = torch.Generator().manual_seed(5)
    rec = {}
    for size in (max(H2O_BATCHES), H2O_TRAIN_BATCHES[1], H2O_BATCHES[0]):
        gb = make_batches(mols[:size], dev, size)[0]
        args, _, dst = uvu_args(uvu, capture_head_inputs(model, gb)["K6"][0])
        x, sh, w, wsel, src = args
        E = sh.shape[0]
        with torch.no_grad():
            gout = torch.randn(E, uvu.out_dim, generator=gen).to(dev)
            if saves:    # a parent checkout: the backward reads the scratch
                scratch = k6_ops.launch_forward(uvu, *args)[1]

                def backward():
                    return k6_ops.launch_backward(uvu, *args, scratch, gout)
            else:
                order = edge_order.build(src, dst, x.shape[0])

                def backward():
                    return k6_ops.launch_backward(uvu, *args, gout,
                                                  order=order)

            def forward():
                return k6_ops.launch_forward(uvu, *args)

            costs = uvu_costs(uvu, args, gout)
            for what, fn, cost in (("K6", forward, costs[0]),
                                   ("K6b", backward, costs[1])):
                split = kernel_split(fn)
                ms = cuda_ms(fn)
                b = fused_bound(*cost)
                key = f"{what}_{E}"
                rec[key] = dict(E=E, ms=ms, device_ms=round(sum(
                    split.values()), 4), kernels=split, **b,
                    share=b["bound_ms"] / ms,
                    share_f32=b["bound_f32_ms"] / ms)
                print(f"{what} at E={E}: entry {ms:.4f} ms (bound "
                      f"{b['bound_ms']:.4f} by {b['bound_by']}, share "
                      f"{rec[key]['share']:.3f}; float32 "
                      f"{b['bound_f32_ms']:.4f}, share "
                      f"{rec[key]['share_f32']:.3f}); {split}", flush=True)
            # each cut that the plans choose from (K6: the components,
            # K6b: the sweep's paths), where the package has them
            cuts = (("K6", forward, "forward_plan",
                     len(getattr(uvu, "fwd_tables", ((),) * 3)[2])),
                    ("K6b", backward, "adjoint_plan",
                     len(getattr(getattr(uvu, "adj_tables", None), "cuts",
                                 ()))))
            for what, fn, plan, n_cuts in cuts:
                chosen = getattr(k6_ops, plan, None)
                for k in range(n_cuts if chosen else 0):
                    setattr(k6_ops, plan, lambda *a, k=k: k)
                    try:
                        ms = cuda_ms(fn)
                    finally:
                        setattr(k6_ops, plan, chosen)
                    rec[f"{what}_{E}_cut{k}"] = ms
                    print(f"{what} at E={E}, cut {k}: {ms:.4f} ms",
                          flush=True)
        del args, gout, x, sh, w, wsel, src, dst
        if saves:
            del scratch
    del model
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if not calls_only:
        pw_serve_and_step(dev, cfg, synthetic_h2o(
            N_BATCHES * max(H2O_BATCHES), np.random.default_rng(20)), rec)
    print(json.dumps({"package": os.path.dirname(pkg.__file__),
                      "card": smi.stdout.strip(), "uvu_times": rec}))


# the walk ablation: each part of the walk kernels as, per source, the
# (pattern, replacement, matches) edits that leave it out, and the
# variants timed, as (label, parts left out); a variant computes wrong
# results and is only timed.  K1 and K2 (full_conv.cu, full_conv_bwd.cu)
# are timed by --conv-times, the K4 walks (full_conv_ext.cu) by --ext-calls.
WALK_CG = (r"\n *(if \(kTwo\)\n *)?cg_matrices<kRows>\(st, [^;]*;", "")
WALK_EDGES = (r"for \(int q = 0; q < nq; \+\+q\)",
              "for (int q = 0; q < 0; ++q)")
WALK_PARTS = {
    "radial weights": {
        src: [(r"\n *radial_weights\(st, [^;]*;", "", 1)]
        for src in ("full_conv.cu", "full_conv_bwd.cu")},
    "CG matrices": {"full_conv.cu": [(*WALK_CG, 1)],
                    "full_conv_bwd.cu": [(*WALK_CG, 1)],
                    "full_conv_ext.cu": [(*WALK_CG, 4)]},
    "per-edge products": {"full_conv.cu": [(*WALK_EDGES, 1)],
                          "full_conv_bwd.cu": [(*WALK_EDGES, 1)],
                          "full_conv_ext.cu": [(*WALK_EDGES, 2)]},
    "dsh lane sums": {"full_conv_ext.cu": [
        (r"if \(dv > 4\) \{", "if (false) {", 1),
        (r"\} else if \(dv > 1\) \{", "} else if (false) {", 1),
        (r"sum = lane_sums<1>\(r1, lanes, lane\);", "sum = r1[0];", 1)]},
    # the species-table kernels K3 / K3b (species_sc.cu, --sc-calls)
    "table products": {"species_sc.cu": [
        (r"for \(int k = 0; k < kc; k \+= 4\)",
         "for (int k = 0; k < 0; k += 4)", 1),
        (r"for \(int r = 0; r < rows; \+\+r\)",
         "for (int r = 0; r < 0; ++r)", 1)]},
    "staging copies": {"species_sc.cu": [
        (r"\bcp_async4\(", "if (false) cp_async4(", 2)]},
    # the adjoint sweep of the K5 backward (pairwise_tp.cu, --pw-calls)
    "adjoint staging copies": {"pairwise_tp.cu": [
        (r"\bbulk_copy\(d", "if (false) bulk_copy(d", 2),
        (r"mbar_expect_tx\(bar, \(uint32_t\)",
         "mbar_expect_tx(bar, 0 * (uint32_t)", 1),
        (r"\bcp_async4\(dst \+ m1", "if (false) cp_async4(dst + m1", 1)]},
    "adjoint non-zero sweeps": {"pairwise_tp.cu": [
        (r"- z_base; z < z1; \+\+z\)", "- z_base; z < 0; ++z)", 2)]},
    # the fused K5 and K5m (pairwise_tp.cu, --pw-calls) and K6 and K6b's
    # dwsel (uvu_conv.cu, --uvu-calls): their staging copies of the rows
    # (cg_tile.cuh's, shared by both files; K6b's adjoint sweep stages its
    # rows by them too), and their CG non-zero loops (the S tiles)
    "fused staging copies": {"cg_tile.cuh": [
        (r"cp_async16\(dst\(l\) \+ c,", "if (false) cp_async16(dst(l) + c,",
         1)]},
    "fused non-zero loops": {
        src: [(r"for \(; z < z1; \+\+z\)", "for (; z < 0; ++z)", 1)]
        for src in ("pairwise_tp.cu", "uvu_conv.cu")},
    # K6b's adjoint sweep (uvu_conv.cu, --uvu-calls): its non-zero sweeps
    # (dx; dw and dsh) and its dS products on the tensor cores
    "K6b non-zero sweeps": {"uvu_conv.cu": [
        (r"- z_base; z < z1; \+\+z\)", "- z_base; z < 0; ++z)", 2)]},
    "K6b dS products": {"uvu_conv.cu": [
        (r"for \(int kk = 0; kk < wo; kk \+= 8\)",
         "for (int kk = 0; kk < 0; kk += 8)", 1)]},
}
WALK_ABLATIONS = (
    ("without the radial weights", ["radial weights"]),
    ("without the CG matrices", ["CG matrices"]),
    ("without the per-edge products", ["per-edge products"]),
    ("without the dsh lane sums", ["dsh lane sums"]),
    ("staging only", ["radial weights", "CG matrices", "per-edge products"]),
    ("without the table products", ["table products"]),
    ("without the staging copies", ["staging copies"]),
    ("without both", ["table products", "staging copies"]),
    ("without the adjoint staging copies", ["adjoint staging copies"]),
    ("without the adjoint non-zero sweeps", ["adjoint non-zero sweeps"]),
    ("without both adjoint parts", ["adjoint staging copies",
                                    "adjoint non-zero sweeps"]),
    ("without the fused staging copies", ["fused staging copies"]),
    ("without the fused non-zero loops", ["fused non-zero loops"]),
    ("without both fused parts", ["fused staging copies",
                                  "fused non-zero loops"]),
    ("without K6b's non-zero sweeps", ["K6b non-zero sweeps"]),
    ("without K6b's dS products", ["K6b dS products"]),
    ("without both K6b parts", ["K6b non-zero sweeps", "K6b dS products"]),
)


def walk_ablation(sources=()):
    """``python3 chip_smoke.py --walk-ablation [source.cu ...]``: where the
    time of the walk kernels (K1, K2 and the K4 family;
    ``csrc/edge_walk.cuh``), of the species-table kernels (K3, K3b;
    ``csrc/species_sc.cu``), of the K5 kernels (the fused K5 and K5m,
    the backward's adjoint sweep; ``csrc/pairwise_tp.cu``) and of K6 and
    K6b (``csrc/uvu_conv.cu``) goes, without a profiler that reads the
    card's counters: copies of the package in ``build/walk_ablation/``
    (gitignored) each leave out parts of the kernels
    (``WALK_ABLATIONS``), and ``--conv-times`` (K1, K2), ``--ext-calls``
    (K4f, K4b, K4g), ``--sc-calls`` (K3, K3b), ``--pw-calls`` (the two K5
    entries) and ``--uvu-calls`` (the two K6 entries) time each copy that
    the edits touch, after the package itself; with sources named, only
    the variants that edit them (``cg_tile.cuh`` goes with either of
    ``pairwise_tp.cu`` and ``uvu_conv.cu``, and its variant is timed for
    the sources named).  A part costs about the time that its absence
    saves."""
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(root, "equivariant_nn_zoo_tpu_torch")
    every = {"full_conv.cu", "full_conv_ext.cu", "species_sc.cu",
             "pairwise_tp.cu", "uvu_conv.cu"}
    fused = {"pairwise_tp.cu", "uvu_conv.cu"}
    named = set(sources) or every
    wanted = named | ({"cg_tile.cuh"} if named & fused else set())
    runs = [("package as it is", root, named)]
    for i, (label, parts) in enumerate(WALK_ABLATIONS):
        if not any(set(WALK_PARTS[p]) & wanted for p in parts):
            continue
        dest = os.path.join(root, "build", "walk_ablation", str(i))
        shutil.rmtree(dest, ignore_errors=True)
        shutil.copytree(pkg, os.path.join(dest, os.path.basename(pkg)),
                        ignore=shutil.ignore_patterns("__pycache__"))
        touched = set()
        for part in parts:
            for src, edits in WALK_PARTS[part].items():
                path = os.path.join(dest, os.path.basename(pkg), "csrc", src)
                with open(path) as f:
                    text = f.read()
                for pattern, repl, want in edits:
                    text, n = re.subn(pattern, repl, text)
                    if n != want:
                        fail(f"walk ablation: '{part}' matched {n} times in "
                             f"{src}, want {want}")
                with open(path, "w") as f:
                    f.write(text)
                touched.add(src)
        if "cg_tile.cuh" in touched:     # times the fused kernels named
            touched |= named & fused
        runs.append((label, dest, touched))
    for label, cwd, touched in runs:
        modes = (["--conv-times"] if touched & {"full_conv.cu",
                                                "full_conv_bwd.cu"} else []) \
            + (["--ext-calls"] if "full_conv_ext.cu" in touched else []) \
            + (["--sc-calls"] if "species_sc.cu" in touched else []) \
            + (["--pw-calls"] if "pairwise_tp.cu" in touched else []) \
            + (["--uvu-calls"] if "uvu_conv.cu" in touched else [])
        for mode in modes:
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  mode], cwd=cwd, capture_output=True,
                                 text=True, timeout=600)
            if res.returncode != 0:
                fail(f"walk ablation, {label}:\n{res.stdout}{res.stderr}")
            for line in res.stdout.splitlines()[:-1]:
                print(f"{label}: {line}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--conv-times"]:
        sys.path.insert(0, os.getcwd())
        conv_times()
    elif sys.argv[1:] == ["--mix-times"]:
        sys.path.insert(0, os.getcwd())
        mix_times()
    elif sys.argv[1:] in (["--sc-times"], ["--sc-calls"]):
        sys.path.insert(0, os.getcwd())
        sc_times(calls_only=sys.argv[1] == "--sc-calls")
    elif sys.argv[1:] in (["--ext-times"], ["--ext-calls"]):
        sys.path.insert(0, os.getcwd())
        ext_times(calls_only=sys.argv[1] == "--ext-calls")
    elif sys.argv[1:] in (["--pw-times"], ["--pw-calls"]):
        sys.path.insert(0, os.getcwd())
        pw_times(calls_only=sys.argv[1] == "--pw-calls")
    elif sys.argv[1:] in (["--uvu-times"], ["--uvu-calls"]):
        sys.path.insert(0, os.getcwd())
        uvu_times(calls_only=sys.argv[1] == "--uvu-calls")
    elif sys.argv[1:] == ["--diffusion"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        diffusion_only()
    elif sys.argv[1:] == ["--dipole"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        dipole_only()
    elif sys.argv[1:] == ["--protein"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        protein_only()
    elif sys.argv[1:2] == ["--walk-ablation"]:
        walk_ablation(sys.argv[2:])
    else:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        main()
