"""The adjoint sweep of the pairwise expansion's backward (K5a ``d left``
and K5b ``dbw`` of ``ops/cuda/pairwise_tp.py``, ``pairwise_adj_kernel`` in
``csrc/pairwise_tp.cu``) on the CPU:

- its host tables (``AdjointTables``) at the full-width hamiltonian head's
  structure (64 channels of l <= 4, both parities, as ``Pairwise`` builds
  its expansion): each path's non-zeros once in each order and sorted, the
  runs, the chunks (consecutive paths of one left irrep, within the
  balance cap), one owner for every bw row and every d left column, and
  the tile choice;
- ``walk``, a plain PyTorch emulation of the kernel's units (the same
  chunks, orders, runs and partial-sum order), against ``plain_backward``
  at rel-linf 1e-12 (float64 inputs cast from seeded float32 draws: only
  the summation orders differ) on the specs of
  ``tests/test_torch_pairwise.py`` and at full width, and through the
  ``routed`` fixture of that file (the backward launches sent to ``walk``)
  against the gradients of JAX ``expand`` at its tolerance, for every
  combination of gradients asked for.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pairwise import (  # noqa: F401  (routed is a fixture)
    GRAD_TOL,
    IDS,
    SPECS,
    _cos_loss_np,
    make,
    routed,
)

from equivariant_nn_zoo_tpu_torch.nn.pointwise import TensorProductExpansion
from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as pairwise_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda.full_conv import MAX_D, mix_rows
from equivariant_nn_zoo_tpu_torch.ops.cuda.pairwise_tp import (
    ADJ_ROW,
    ADJ_TARGET_CHUNKS,
    PairwiseTP,
    adjoint_plan,
    balanced_cuts,
)
from equivariant_nn_zoo_tpu_torch.utils import init_parameters
from equivariant_nn_zoo_tpu_torch.utils.params import params_from_jax
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

WALK_TOL = 1e-12
RUNS = (7, 7 + MAX_D + 1)       # first fields of a path's run bounds
FEATURES = "+".join(f"64x{l}{p}" for l in range(5) for p in "eo")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def head():
    """The kernel tables of the full-width head's expansion."""
    tpe = TensorProductExpansion(FEATURES, FEATURES, FEATURES, "uvu")
    init_parameters(tpe, torch.Generator().manual_seed(0))
    return tpe, PairwiseTP(tpe)


def _decode(code):
    return code & 0xff, (code >> 8) & 0xff, code >> 16


def _row(offset):
    """The staged row at a byte offset of the kernel's non-zero codes."""
    rows, rest = np.divmod(offset, 4 * ADJ_ROW)
    assert (rest == 0).all()
    return rows


def _original_path(tpk, row):
    """The path table row that an adjoint path row stands for."""
    r0, _, row_base = row[:3]
    (q,) = np.flatnonzero((tpk.path_rows[:, 2] == r0)
                          & (tpk.path_rows[:, 4] == row_base))
    return tpk.path_rows[q]


def test_orders_hold_each_non_zero_once_sorted(head):
    _, tpk = head
    adj = tpk.adj
    codes, bits = adj.nz[..., 0], adj.nz[..., 1]
    assert adj.nz.shape == (2, tpk.nz_count, 2)
    for row in adj.paths:
        _, d1, _, _, _, _, _, nz0, nz1 = _original_path(tpk, row)
        m1, m2, m3 = _decode(tpk.nz_codes[nz0:nz1])
        want = sorted(zip(m1, m2, m3, tpk.nz_values[nz0:nz1]))
        z0, z1 = row[5:7]
        assert z1 - z0 == nz1 - nz0
        for order, d in ((0, d1), (1, row[1])):
            runs = row[RUNS[order]: RUNS[order] + d + 1] - z0
            assert runs[0] == 0 and runs[-1] == z1 - z0
            assert (row[RUNS[order] + d: RUNS[order] + MAX_D + 1] == z1).all()
            lead = np.repeat(np.arange(d), np.diff(runs))
            first = _row(codes[order, z0:z1] & 0xffff)
            m3_ = _row(codes[order, z0:z1] >> 16) - row[1]
            c = bits[order, z0:z1].view(np.float32)
            # order 0: m1 from the runs, (m2, m3) coded; order 1: m2 from
            # the runs, (m1, m3) coded
            got = (zip(lead, first, m3_, c) if order == 0
                   else zip(first, lead, m3_, c))
            assert sorted(got) == want
            keys = list(zip(lead, m3_, first))
            assert keys == sorted(keys)


CUTS = pytest.mark.parametrize("k", range(len(ADJ_TARGET_CHUNKS)),
                               ids=["coarse", "fine"])


@CUTS
def test_chunks_cover_each_left_irrep_in_order_within_the_cap(head, k):
    _, tpk = head
    cut, sizes = tpk.adj.cuts[k], tpk.adj.paths[:, 6] - tpk.adj.paths[:, 5]
    assert cut.cap == max(sizes.max(),
                          -(-tpk.nz_count // ADJ_TARGET_CHUNKS[k]))
    assert cut.chunks[0, 2] == 0 and cut.chunks[-1, 3] == tpk.n_paths
    assert (cut.chunks[1:, 2] == cut.chunks[:-1, 3]).all()
    left = [(s.start, mi.ir.dim) for s, mi in
            zip(tpk.irreps_a.slices(), tpk.irreps_a)]
    for x_off, d1 in left:
        mine = cut.chunks[(cut.chunks[:, 0] == x_off)]
        assert (mine[:, 1] == d1).all()
        # the irrep's paths, in the path table's order
        want = [r for r in tpk.path_rows if (r[0], r[1]) == (x_off, d1)]
        got = [_original_path(tpk, tpk.adj.paths[q])
               for q in range(mine[0, 2], mine[-1, 3])]
        assert np.array_equal(np.asarray(got), np.asarray(want))
        loads = [int(sizes[p0:p1].sum()) for _, _, p0, p1, _ in mine]
        assert max(loads) <= cut.cap
        # the fewest chunks the cap allows, and no cut that a smaller
        # largest chunk could move
        assert len(mine) == len(balanced_cuts(
            [int(s) for s in sizes[mine[0, 2]: mine[-1, 3]]], cut.cap)) - 1
    # l = 0 stays one chunk, l = 4 is split, the finer cut more
    assert len(cut.chunks[cut.chunks[:, 1] == 1]) == 2
    assert len(cut.chunks[cut.chunks[:, 1] == 9]) > 2 + 2 * k
    assert len(tpk.adj.cuts[1].chunks) > len(tpk.adj.cuts[0].chunks)


def test_balanced_cuts():
    assert balanced_cuts([5, 1, 1, 1, 1, 1, 5], 8) == [0, 4, 7]
    assert balanced_cuts([5, 1, 1, 1, 1, 1, 5], 11) == [0, 4, 7]
    assert balanced_cuts([3, 3, 3, 3], 6) == [0, 2, 4]
    assert balanced_cuts([4, 4, 4], 12) == [0, 3]
    assert balanced_cuts([2, 2, 2, 2, 2], 5) == [0, 2, 4, 5]
    assert balanced_cuts([], 5) == [0, 0]


@CUTS
def test_every_bw_row_and_d_left_column_has_one_owner(head, k):
    _, tpk = head
    cut, mul = tpk.adj.cuts[k], tpk.mul
    rows = np.concatenate([r0 + np.arange(d2)
                           for r0, d2 in tpk.adj.paths[:, :2]])
    assert sorted(rows) == list(range(tpk.R))
    cols, ws = [], []
    for x_off, d1, _, _, ws_col in cut.chunks:
        if ws_col < 0:
            cols.append(x_off + np.arange(mul * d1))
        else:
            ws.append(ws_col + np.arange(mul * d1))
    for x_off, width, col, n in cut.sums:
        cols.append(x_off + np.arange(width))
        assert n != 1
        for j in range(n):
            hits = [c for c in cut.chunks if c[0] == x_off and
                    c[4] == col + j * width]
            assert len(hits) == 1
    assert sorted(np.concatenate(cols)) == list(range(tpk.irreps_a.dim))
    ws = np.concatenate(ws)
    assert sorted(ws) == list(range(cut.ws_width))


@pytest.mark.parametrize("M", [1, 49, 96, 385, 1537, 3072, 4096])
def test_plan_keeps_two_blocks_per_multiprocessor(head, M):
    """Whole warps of 64 / mul elements: the most warps, then the coarsest
    cut, that still give two blocks per multiprocessor (the batch-16 head
    takes the fine cut with 8 warps, larger batches the coarse one)."""
    _, tpk = head
    cuts = tpk.adj.cuts
    for mul in (64, 8):
        per_warp = ADJ_ROW // mul
        k, tile = adjoint_plan(M, cuts, mul, 132)
        warps = tile // per_warp
        assert tile % per_warp == 0 and warps in (1, 2, 4, 8)
        blocks = -(-M // tile) * len(cuts[k].chunks)
        if warps > 1:
            assert blocks >= 2 * 132
        else:
            assert k == len(cuts) - 1
        # no plan with more warps, or as many on a coarser cut, would do
        for w2 in (8, 4, 2):
            for k2, c2 in enumerate(cuts):
                if w2 > warps or (w2 == warps and k2 < k):
                    assert -(-M // (w2 * per_warp)) * len(c2.chunks) \
                        < 2 * 132
    assert adjoint_plan(49, cuts, 64, 132) == (1, 8)
    assert adjoint_plan(3072, cuts, 64, 132) == (0, 8)


def walk(tpk, a, bw, dS, want_a=True, want_b=True, k=0):
    """The adjoint sweep as the kernel's units run it: per chunk, per path
    (its stage: d2 bw rows, then d3 dS rows), d left summed per m1 run and
    dbw per m2 run over the two orders, the chunk's d left stored or put
    in the workspace, then the partials added in chunk order, on the
    chunking ``tpk.adj.cuts[k]``.  Unwritten outputs stay NaN; sums in
    ``a``'s dtype."""
    adj, M, mul = tpk.adj, a.shape[0], tpk.mul
    cut = adj.cuts[k]
    codes = adj.nz[..., 0].astype(np.int64)
    first, third = _row(codes & 0xffff), _row(codes >> 16)
    coef = torch.tensor(adj.nz[..., 1].copy().view(np.float32))
    G_all = dS.reshape(M, -1, mul)
    da = torch.full_like(a, float("nan"))
    dbw = torch.full_like(bw, float("nan"))
    ws = torch.full((M * cut.ws_width,), float("nan"), dtype=a.dtype)
    for x_off, d1, p0, p1, ws_col in cut.chunks:
        A = a[:, x_off: x_off + mul * d1].reshape(M, mul, d1)
        dal = torch.zeros(M, mul, d1, dtype=a.dtype)
        for row in adj.paths[p0:p1]:
            r0, d2, row_base, row_stride, d3 = row[:5]
            stage = torch.cat([bw[:, r0: r0 + d2],
                               G_all[:, row_base + np.arange(d3) * row_stride]],
                              dim=1)
            runs_a, runs_b = (row[r: r + MAX_D + 1] for r in RUNS)
            for i in range(d1 if want_a else 0):
                for z in range(runs_a[i], runs_a[i + 1]):
                    dal[:, :, i] += coef[0, z] * stage[:, first[0, z]] \
                        * stage[:, third[0, z]]
            for i in range(d2 if want_b else 0):
                acc = torch.zeros(M, mul, dtype=a.dtype)
                for z in range(runs_b[i], runs_b[i + 1]):
                    acc += coef[1, z] * A[:, :, first[1, z]] \
                        * stage[:, third[1, z]]
                dbw[:, r0 + i] = acc
        if ws_col < 0:
            da[:, x_off: x_off + mul * d1] = dal.reshape(M, -1)
        else:
            ws[M * ws_col: M * (ws_col + mul * d1)] = dal.reshape(-1)
    for x_off, width, col, n in cut.sums:
        s = torch.zeros(M, width, dtype=a.dtype)
        for j in range(n):
            c0 = M * (col + j * width)
            s += ws[c0: c0 + M * width].reshape(M, width)
        da[:, x_off: x_off + width] = s
    return (da if want_a else None), (dbw if want_b else None)


def _d_scratch(tpk, wsel, gout):
    """dS: the mix's cotangent on the unmixed scratch rows."""
    S = torch.zeros(gout.shape[0], tpk.KM, dtype=gout.dtype,
                    requires_grad=True)
    with torch.enable_grad():
        return torch.autograd.grad(
            mix_rows(S, wsel, tpk.prob_rows, tpk.out_dim), S, gout)[0]


def _case(tpk, tpe, M, seed):
    rng = np.random.default_rng(seed)
    a, b, gout = (torch.tensor(rng.normal(size=(M, n)), dtype=torch.float32)
                  for n in (tpk.irreps_a.dim, tpk.irreps_b.dim, tpk.out_dim))
    with torch.no_grad():
        bw = tpk.weighted_right(tpe.tp.weight, b)
        wsel = tpk.flat_wsel(tpe.linear)
    return a, bw, wsel, gout


def _walk_against_plain(tpk, tpe, M, seed, want_a, want_b, k):
    """The walk against ``plain_backward``, both in float64."""
    a, bw, wsel, gout = (t.double() for t in _case(tpk, tpe, M, seed))
    got = walk(tpk, a, bw, _d_scratch(tpk, wsel, gout), want_a, want_b, k)
    want = tpk.plain_backward(a, bw, wsel, gout, (want_a, want_b, False))
    for g, w in zip(got, want[:2]):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.isfinite(g).all()
            assert _rel(g.numpy(), w.numpy()) < WALK_TOL


WANTS = [(True, True), (True, False), (False, True)]


@CUTS
@pytest.mark.parametrize("want", WANTS, ids=["both", "d_left", "dbw"])
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_walk_matches_plain_backward(spec, want, k):
    _, _, ttpe, _, _ = make(*spec, seed=11)
    tpk = PairwiseTP(ttpe)
    assert len(tpk.adj.cuts[k].sums) > 0    # some irrep is cut in chunks
    _walk_against_plain(tpk, ttpe, 41, 12, *want, k)


@CUTS
def test_walk_matches_plain_backward_at_full_width(head, k):
    tpe, tpk = head
    _walk_against_plain(tpk, tpe, 3, 13, True, True, k)


@partial(jax.jit, static_argnums=0)
def _jax_expand_grads(jtpe, params, a, b):
    """Gradients of ``sum(expand(a, b) * cos(arange))`` (the file's one
    jit, traced once per spec)."""
    def loss(p, a_, b_):
        o = jtpe.expand(p, a_, b_)
        return jnp.sum(o * jnp.cos(jnp.arange(o.size).reshape(o.shape)))

    return jax.grad(loss, argnums=(0, 1, 2))(params, a, b)


@pytest.fixture(scope="module")
def jax_grads():
    """Per spec: the port's expansion on the JAX parameters, the inputs and
    the gradients of JAX ``expand`` (computed once)."""
    cache = {}

    def get(spec):
        if spec not in cache:
            jtpe, params, ttpe, a, b = make(*spec, seed=14)
            gp, ga, gb = _jax_expand_grads(jtpe, params, jnp.asarray(a),
                                           jnp.asarray(b))
            want = {k: v.numpy() for k, v in
                    params_from_jax(jax.device_get(gp)).items()}
            want.update(left=np.asarray(ga), right=np.asarray(gb))
            cache[spec] = (ttpe, a, b, want)
        return cache[spec]

    return get


# which of left, right and the parameters ask for a gradient
ASKS = [(l, r, p) for l in (0, 1) for r in (0, 1) for p in (0, 1)
        if l or r or p]


@pytest.mark.parametrize("ask", ASKS,
                         ids=["".join("lrp"[i] for i in range(3) if a[i])
                              for a in ASKS])
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_routed_walk_gradients_match_jax(spec, ask, routed, monkeypatch,
                                         jax_grads):
    """``PairwiseTPFunction`` with its backward launch sent to ``walk``
    (dwsel from ``plain_backward``): every gradient asked for against JAX
    ``expand``; the launch is asked for exactly the cotangents that
    autograd needs."""
    ttpe, a, b, want = jax_grads(spec)
    tpk = PairwiseTP(ttpe)
    asked = []

    def launch_backward(tpk_, a_, bw, wsel, gout, wanted=(True,) * 3):
        asked.append(tuple(wanted))
        routed.backward.append(a_.shape[0])
        # the cut the wrapper takes for these elements on an H100
        k, _ = adjoint_plan(a_.shape[0], tpk_.adj.cuts, tpk_.mul, 132)
        da, dbw = walk(tpk_, a_, bw, _d_scratch(tpk_, wsel, gout),
                       wanted[0], wanted[1], k)
        dwsel = tpk_.plain_backward(a_, bw, wsel, gout,
                                    (False, False, True))[2] \
            if wanted[2] else None
        return da, dbw, dwsel

    monkeypatch.setattr(pairwise_mod, "launch_backward", launch_backward)
    ask_l, ask_r, ask_p = ask
    ttpe.requires_grad_(bool(ask_p))
    a_ = torch.tensor(a, requires_grad=bool(ask_l))
    b_ = torch.tensor(b, requires_grad=bool(ask_r))
    names = [n for n, t in (("left", a_), ("right", b_)) if t.requires_grad]
    names += [n for n, _ in ttpe.named_parameters()] if ask_p else []
    leaves = [t for t in (a_, b_) if t.requires_grad]
    leaves += list(ttpe.parameters()) if ask_p else []
    out = tpk(ttpe, a_, b_)
    grads = torch.autograd.grad(out, leaves,
                                torch.tensor(_cos_loss_np(out.shape)))
    ttpe.requires_grad_(True)
    assert routed == [41] and routed.backward == [41]
    # d left if left asks; dbw if right or tp.weight does; dwsel if the mix
    assert asked == [(bool(ask_l), bool(ask_r or ask_p), bool(ask_p))]
    for name, g in zip(names, grads):
        assert _rel(g.numpy(), want[name]) < GRAD_TOL, name
