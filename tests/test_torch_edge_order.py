"""The node-major edge orders of the conv kernels K1 and K2
(``ops/cuda/edge_order.py``) and the walk that reads them
(``csrc/edge_walk.cuh``), on the CPU in plain PyTorch and numpy:

- the orders and their row pointers reproduce ``segment_sum`` exactly, by
  destination and by source, on shuffled edges with padded edges at the
  dummy node, endpoints outside ``[0, N)``, nodes without edges and a hub;
- the work items (``item_walk``, written out here as the kernels run it)
  walk every kept edge once and write every node once, directly or in
  pieces that the piece sum adds up;
- the walk tables of ``ConvTables``, walked item by item and chunk by chunk
  as K1 and K2 walk them, reproduce the plain contracts' scratch, dx and
  dW_out (rel-linf 1e-5: float32 sums in another order);
- one forward of a narrow 3-layer ``config_energy``, with the launches
  routed to the plain contracts, builds the orders once, not once per
  layer, and the backward receives them.

``torch_threads_per_worker`` lives here (this file imports no JAX, so the
card's test file can import it too); every ``tests/test_torch_*.py`` calls
it at import.
"""

import os

import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu_torch.data import Batch, Data, GraphBatch
from equivariant_nn_zoo_tpu_torch.data import computeEdgeIndex
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.nn.message_passing import \
    FactorizedConvolution
from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.ops.gate import shifted_softplus
from equivariant_nn_zoo_tpu_torch.ops.segment import segment_sum
from equivariant_nn_zoo_tpu_torch.utils import build, init_parameters


def torch_threads_per_worker():
    """Give torch's intra-op threads, and the BLAS that numpy loaded, this
    process's share of the cores: ``os.cpu_count() // workers``,
    ``workers`` from pytest-xdist's ``PYTEST_XDIST_WORKER_COUNT`` (1
    without it).  The walk emulations issue thousands of tiny ops; with
    every worker's threads on every core, each op waits on the other
    workers' spinning threads (numpy's OpenBLAS threads spin too, so
    bounding torch alone is not enough).  JAX's threads are left alone."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(threads)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:      # no BLAS pool to bound where it is missing
        return
    threadpool_limits(limits=threads, user_api="blas")


torch_threads_per_worker()

TOL = 1e-5
F = full_conv_mod.WALK_FIELDS


def _graph(kind, seed=0):
    """(src, dst, N) of one test graph, edges shuffled."""
    rng = np.random.default_rng(seed)
    N = 61
    src = rng.integers(0, N - 1, 300)
    dst = rng.integers(0, N - 1, 300)
    if kind == "padded":     # 2,000 padded edges at the dummy node N - 1
        src = np.concatenate([src, np.full(2000, N - 1)])
        dst = np.concatenate([dst, np.full(2000, N - 1)])
    elif kind == "hub":      # one node with 700 incoming and outgoing edges
        src = np.concatenate([src, np.full(700, 7), rng.integers(0, N, 700)])
        dst = np.concatenate([dst, rng.integers(0, N, 700), np.full(700, 7)])
    elif kind == "out_of_range":
        src[::17] = N + 3
        dst[::23] = -1
    elif kind == "sparse":   # most nodes without edges
        src, dst = src[:20] // 4, dst[:20] // 4
    perm = rng.permutation(len(src))
    return (torch.as_tensor(src[perm]), torch.as_tensor(dst[perm]), N)


KINDS = ["padded", "hub", "out_of_range", "sparse"]


@pytest.mark.parametrize("kind", KINDS)
def test_orders_reproduce_segment_sum(kind):
    src, dst, N = _graph(kind)
    order = edge_order.build(src, dst, N)
    valid = (src >= 0) & (src < N) & (dst >= 0) & (dst < N)
    vals = torch.as_tensor(
        np.random.default_rng(1).integers(-999, 999, (len(src), 3)))
    for key, perm, ptr in ((dst, order.dst_perm, order.dst_ptr),
                           (src, order.src_perm, order.src_ptr)):
        assert perm.dtype == ptr.dtype == torch.int32
        assert sorted(perm.tolist()) == list(range(len(src)))
        ptr, perm = ptr.long(), perm.long()
        assert ptr[0] == 0 and ptr[N] == int(valid.sum())
        assert (ptr[1:] >= ptr[:-1]).all()
        assert not valid[perm[ptr[N]:]].any()
        got = torch.zeros(N, 3, dtype=vals.dtype)
        for n in range(N):
            run = perm[ptr[n]: ptr[n + 1]]
            assert (key[run] == n).all()
            assert (run[1:] > run[:-1]).all()      # stable: edge order kept
            got[n] = vals[run].sum(0)
        want = segment_sum(vals[valid], key[valid], N)
        assert torch.equal(got, want)


def item_walk(ptr, N, t, T, cap):
    """``walk::item_walk`` of ``csrc/edge_walk.cuh``: (e_lo, e_hi, first,
    end, head) of work item t."""
    s, f = t * cap, t * cap + cap
    n_lo = min(N, int(np.searchsorted(ptr, s, "left")))
    n_hi = N if t == T - 1 else min(N, int(np.searchsorted(ptr, f, "left")))
    if n_hi > n_lo and ptr[n_hi] - ptr[n_hi - 1] > cap:
        n_hi -= 1
    e_lo, e_hi, first, head = ptr[n_lo], ptr[n_hi], n_lo, -1
    if n_lo > 0:
        h = n_lo - 1
        a, b = ptr[h], ptr[h + 1]
        if a < s < b and b - a > cap:
            head, first = h, h
            e_lo = a if a >= s - cap else s
            if n_hi == n_lo:
                e_hi = min(b, f)
    return int(e_lo), int(e_hi), first, n_hi, head


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cap", [2, 5, 64])
def test_work_items_walk_every_edge_and_node_once(kind, cap):
    src, dst, N = _graph(kind)
    ptr = edge_order.build(src, dst, N).dst_ptr.numpy().astype(np.int64)
    E = len(src)
    T = max(1, -(-E // cap))
    walked = np.zeros(E, int)
    written = np.zeros(N, int)
    pieces = {}
    for t in range(T):
        e_lo, e_hi, first, end, head = item_walk(ptr, N, t, T, cap)
        assert e_hi - e_lo <= 4 * cap
        walked[e_lo:e_hi] += 1
        for n in range(first, end):
            # the walk's runs, as the kernel cuts them by the key
            lo, hi = max(ptr[n], e_lo), min(ptr[n + 1], e_hi)
            if n == head:
                pieces.setdefault(n, []).append((t, lo, hi))
            else:
                assert (lo, hi) == (ptr[n], ptr[n + 1])
                written[n] += 1
    assert (walked[:ptr[N]] == 1).all() and (walked[ptr[N]:] == 0).all()
    for n, runs in pieces.items():
        a, b = ptr[n], ptr[n + 1]
        assert b - a > cap
        ts = [t for t, _, _ in runs]
        assert ts == list(range(a // cap + 1, (b - 1) // cap + 1))
        assert runs[0][1] == a and runs[-1][2] == b
        assert all(r[2] == q[1] for r, q in zip(runs, runs[1:]))
        written[n] += 1   # by the piece sum
    assert (written == 1).all()
    long_nodes = np.nonzero(np.diff(ptr) > cap)[0]
    assert sorted(pieces) == long_nodes.tolist()


def _narrow_conv():
    feats = "+".join(f"4x{l}{p}" for l in range(3) for p in "eo")
    conv = FactorizedConvolution(
        input_features=feats,
        output_features="4x0e+4x0o+12x0e+4x1e+4x1o+4x2e+4x2o",
        node_attrs="4x0e", edge_radial="8x0e",
        edge_spherical="1x0e+1x1o+1x2e", invariant_layers=2,
        invariant_neurons=8, avg_num_neighbors=5.0, sc_species_types=5)
    init_parameters(conv, torch.Generator().manual_seed(1))
    return conv


def _walk(fc, order_perm, order_ptr, key, other, E, N, body, flush, width,
          chunks=None):
    """Every (item, chunk, path) of a walk kernel: ``body(p, e, node_acc)``
    per walked edge, ``flush(p, n, acc, row)`` per node; returns the
    direct rows [N, width] and the piece-summed long rows over them.
    ``chunks``: the walk's chunk table (K1's and K2's when None)."""
    tab = fc.walk_table.numpy().reshape(-1, F).astype(np.int64)
    cap, T = full_conv_mod.walk_items(E, fc.n_chunks)
    ptr = order_ptr.numpy().astype(np.int64)
    perm = order_perm.numpy().astype(np.int64)
    rows = np.full((N, width), np.nan)
    pieces = np.full((T, width), np.nan)
    heads = []
    for t in range(T):
        e_lo, e_hi, first, end, head = item_walk(ptr, N, t, T, cap)
        for c0, cn in (fc.walk_chunks if chunks is None
                       else chunks).numpy().reshape(-1, 2):
            for p in tab[c0: c0 + cn]:
                acc, cur = None, first
                for pos in range(e_lo, e_hi):
                    e = perm[pos]
                    while cur < key[e]:
                        flush(p, acc, rows if cur != head else pieces,
                              cur if cur != head else t)
                        acc, cur = None, cur + 1
                    acc = body(p, e, acc)
                while cur < end:
                    flush(p, acc, rows if cur != head else pieces,
                          cur if cur != head else t)
                    acc, cur = None, cur + 1
        if head >= 0 and t == ptr[head] // cap + 1:
            heads.append((head, t, (ptr[head + 1] - 1) // cap))
    for head, t, last in heads:       # walk::walk_piece_sum_kernel
        rows[head] = pieces[t: last + 1].sum(0)
    return rows


def test_walk_tables_reproduce_the_plain_contracts():
    conv = _narrow_conv()
    fc = conv.full_conv
    mul = fc.fused.mul
    src, dst, _ = _graph("hub", seed=3)
    N, E = 61, len(src)
    src, dst = src[:400].clone(), dst[:400].clone()   # keep the hub's runs
    src[::31] = N + 1                                 # and drop a few
    E = len(src)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(N, fc.fused.irreps_in.dim, generator=g)
    sh = torch.randn(E, fc.fused.J_dim, generator=g)
    er = torch.randn(E, 8, generator=g)
    flat = [t.detach() for t in fc.flat_weights(conv.fc, conv.tp.linear, 0.3)]
    w_hidden, w_out, wsel = flat
    # the plain contracts on the kept edges: the walk drops the others
    k = (src < N).nonzero()[:, 0]
    kept_args = (x, er[k], sh[k], src[k], dst[k], *flat, N)
    out, scratch = fc.plain_forward(*kept_args)
    gout = torch.randn(N, fc.out_dim, generator=g)
    dx, _, _, dw_out, _ = fc.plain_backward(*kept_args, scratch, gout)
    # the last hidden layer, as walk::mlp_hidden_kernel stores it
    h, ofs, H = er, 0, fc.fc_dims[1]
    for i in range(len(fc.fc_dims) - 2):
        fan = h.shape[1]
        h = shifted_softplus(
            h @ w_hidden[ofs: ofs + fan * H].reshape(fan, H)) * fc.act_cst
        ofs += fan * H
    h, w_out = h.double().numpy(), w_out.double().numpy()
    xs, shs = x.double().numpy(), sh.double().numpy()
    srcs, dsts = src.numpy(), dst.numpy()
    order = edge_order.build(src, dst, N)

    cells = fc.walk_cells.numpy()
    c, m2s = fc.walk_nz.numpy()[:, 0], fc.walk_nz.numpy()[:, 1].view(np.int32)

    def cg_matrix(p, e):
        """M[m3, m1] = sum_m2 C sh[e, j0 + m2] over the path's cells."""
        x_off, d1, j0, d3 = p[:4]
        M = np.zeros((d3, d1))
        for m3 in range(d3):
            for m1 in range(d1):
                k = p[8] + m3 * d1 + m1
                z = slice(cells[k], cells[k + 1])
                M[m3, m1] = (c[z] * shs[e, j0 + m2s[z]]).sum()
        return M

    # K1: destination-major, node sums per output component
    def k1_body(p, e, acc):
        x_off, d1 = p[:2]
        w = h[e] @ w_out[:, p[6]: p[6] + mul]
        xe = xs[srcs[e], x_off: x_off + d1 * mul].reshape(mul, d1)
        msg = w * (cg_matrix(p, e) @ xe.T)                # [d3, mul]
        return msg if acc is None else acc + msg

    def k1_flush(p, acc, rows, r):
        for m3 in range(p[3]):
            col = (p[4] + m3 * p[5]) * mul
            rows[r, col: col + mul] = 0 if acc is None else acc[m3]

    got = _walk(fc, order.dst_perm, order.dst_ptr, dsts, srcs, E, N,
                k1_body, k1_flush, fc.KM)
    assert not np.isnan(got).any()
    assert np.abs(got - scratch.numpy()).max() <= TOL * np.abs(
        scratch.numpy()).max()

    # K2: source-major, per-path dx rows, dw, then dx by left irrep
    dS = np.zeros((N, fc.KM))
    g64 = gout.double().numpy()
    for a_col, kdim, b_off, wo, c_off, c_stride in fc.prob_rows:
        wq = wsel[b_off: b_off + kdim * wo].double().numpy().reshape(kdim, wo)
        dS[:, a_col: a_col + kdim] += g64[:, c_off + c_stride * np.arange(
            wo)] @ wq.T
    dw = np.full((E, fc.fc_dims[-1]), np.nan)

    def k2_body(p, e, acc):
        x_off, d1, j0, d3, row_base, row_stride, wcol = p[:7]
        w = h[e] @ w_out[:, wcol: wcol + mul]
        xe = xs[srcs[e], x_off: x_off + d1 * mul].reshape(mul, d1)
        gm = np.stack([dS[dsts[e], (row_base + m3 * row_stride) * mul:][:mul]
                       for m3 in range(d3)])                # [d3, mul]
        t = cg_matrix(p, e).T @ gm                          # [d1, mul]
        dw[e, wcol: wcol + mul] = (xe.T * t).sum(0)
        return w * t if acc is None else acc + w * t

    def k2_flush(p, acc, rows, r):
        rows[r, p[7]: p[7] + p[1] * mul] = 0 if acc is None else \
            acc.reshape(-1)

    dxp = _walk(fc, order.src_perm, order.src_ptr, srcs, dsts, E, N,
                k2_body, k2_flush, fc.KMd)
    dx_walk = np.zeros_like(xs)
    for x_off, d1, dcol, n_paths in fc.walk_irreps.numpy().reshape(-1, 4):
        width = d1 * mul
        s = sum(dxp[:, dcol + k * width: dcol + (k + 1) * width]
                for k in range(n_paths))
        dx_walk[:, x_off: x_off + width] = s.reshape(N, d1, mul).transpose(
            0, 2, 1).reshape(N, width)
    assert fc.dx_covered
    assert np.abs(dx_walk - dx.numpy()).max() <= TOL * np.abs(
        dx.numpy()).max()
    kept = ~np.isnan(dw[:, 0])
    assert kept.sum() == int(((srcs < N) & (dsts < N)).sum())
    dw_out_walk = h[kept].T @ dw[kept]
    assert np.abs(dw_out_walk - dw_out.numpy()).max() <= TOL * np.abs(
        dw_out.numpy()).max()


SHIFTS = [-0.5, -1.0, 0.0, 0.5, 1.0, 1.5, -2.0, -3.0, 2.5, 0.25]
ATTRS = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
         "atom_types": ("node", "1x0e"), "total_energy": ("graph", "1x0e")}


def _energy_batch():
    rng = np.random.default_rng(0)
    mols = []
    for _ in range(5):
        n = int(rng.integers(5, 12))
        d = {"pos": rng.normal(size=(n, 3)) * 1.2,
             "species": rng.choice([1, 6, 7, 8], size=(n, 1)),
             "total_energy": rng.normal(size=(1, 1))}
        d["atom_types"] = d["species"]
        attrs = dict(ATTRS)
        out, attrs = computeEdgeIndex(d, attrs, r_max=3.0)
        d.update(out)
        mols.append(Data(attrs, **d))
    return GraphBatch.from_batch(Batch.from_data_list(mols), 64, 512, 6,
                                 "cpu")


def test_one_forward_builds_the_orders_once(monkeypatch):
    model = build(tlc.addEnergyOutput(tlc.featureModel(
        n_dim=8, l_max=2, node_attrs="4x0e", edge_radial="4x0e",
        num_types=10, num_layers=3, r_max=3.0), SHIFTS))
    init_parameters(model, torch.Generator().manual_seed(0))
    seen = {"fwd": [], "bwd": []}

    def launch(plain, what):
        def run(conv, *args, order=None):
            seen[what].append(order)
            return getattr(conv, plain)(*args)
        return run

    monkeypatch.setattr(full_conv_mod.FullConv, "forward",
                        full_conv_mod.FullConv.launch)
    monkeypatch.setattr(full_conv_mod, "launch_forward",
                        launch("plain_forward", "fwd"))
    monkeypatch.setattr(full_conv_mod, "launch_backward",
                        launch("plain_backward", "bwd"))
    gb = _energy_batch()
    builds = edge_order.builds
    model(gb)["total_energy"].sum().backward()
    assert edge_order.builds == builds + 1
    assert len(seen["fwd"]) == len(seen["bwd"]) == 3
    first = seen["fwd"][0]
    ei = gb["edge_index"]
    assert torch.equal(first.dst_perm,
                       edge_order.build(ei[0], ei[1], 64).dst_perm)
    for order in seen["fwd"] + seen["bwd"]:
        assert all(a.data_ptr() == b.data_ptr() and torch.equal(a, b)
                   for a, b in zip(order, first))
