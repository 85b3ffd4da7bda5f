"""The fused per-edge conv, K6 and K6b (``ops/cuda/uvu_conv.py``,
``uvu_fwd_kernel``, ``uvu_dws_kernel``, ``uvu_adj_kernel`` and the ordered
sums of ``csrc/uvu_conv.cu``), on the CPU:

- the host tables, on the narrow layer of ``tests/test_torch_uvu_conv.py``
  and on the full-width hamiltonian head's (64 channels of l <= 4, both
  parities, sh to l = 3): every output column (each cut of the
  components), every dwsel entry, every dw entry, every dx (node, column)
  and every dsh (edge, j) has exactly one owner;
- ``walk_forward`` and ``walk_backward``, a plain PyTorch emulation of the
  kernels' units, K steps, chunk sums and dx route (per-edge dx columns of
  each chunk, added per source node in the source-major edge order),
  against ``plain_forward`` / ``plain_backward`` at rel-linf 1e-12 in
  float64 (inputs cast from seeded float32 draws: only the summation
  orders differ): the narrow layer at E = 41 (a ragged tile, several
  dwsel chunks and sweep chunks, a shared source, one source outside
  [0, N), which reads x as zero) and the full-width tables at E = 3;
- through the ``routed`` stand-ins (the launches sent to the walks), the
  layer's output and gradients against JAX's ``FusedUVUConv`` on the
  ``convs`` fixture's parameters at that file's tolerances (no JAX jit).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_uvu_conv import (  # noqa: F401  (convs is a fixture)
    GRAD_TOL,
    TOL,
    N,
    _cotangent,
    _rel,
    convs,
)

from equivariant_nn_zoo_tpu.ops.fused_tp import FusedUVUConv as JFused
from equivariant_nn_zoo_tpu_torch.nn.message_passing import \
    FactorizedConvolution as TConv
from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
from equivariant_nn_zoo_tpu_torch.ops.cuda import uvu_conv as uvu_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda.pairwise_tp import (
    DWS_KC,
    DWS_TILE,
    FWD_SPLITS,
    dws_plan,
    forward_plan,
)
from equivariant_nn_zoo_tpu_torch.ops.cuda.uvu_conv import (
    ADJ_KC,
    ADJ_TARGET_CHUNKS,
    FWD_KC,
    UVUConv,
    adjoint_plan,
)
from equivariant_nn_zoo_tpu_torch.utils import init_parameters
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

WALK_TOL = 1e-12
SMS = 132                        # an H100's multiprocessors
FEATURES = "+".join(f"64x{l}{p}" for l in range(5) for p in "eo")
CUTS = pytest.mark.parametrize("k", range(len(ADJ_TARGET_CHUNKS)),
                               ids=["coarse", "fine"])
SPLITS = pytest.mark.parametrize("k", range(len(FWD_SPLITS)),
                                 ids=["groups", "threes", "ones"])


@pytest.fixture(scope="module")
def head():
    """The full-width hamiltonian head's per-edge conv and its tables."""
    conv = TConv(input_features=FEATURES, output_features=FEATURES,
                 node_attrs=None, edge_radial="8x0e",
                 edge_spherical="1x0e+1x1o+1x2e+1x3o", invariant_layers=2,
                 invariant_neurons=32, avg_num_neighbors=1, use_sc=False,
                 reduce=False)
    init_parameters(conv, torch.Generator().manual_seed(0))
    return conv


def _conv(request, which):
    if which == "full":
        return request.getfixturevalue("head")
    return request.getfixturevalue("convs")[2]


TABLES = pytest.mark.parametrize("which", ["full", "narrow"])


def _fused_codes(conv):
    nz = conv.fwd_tables.nz
    return (nz[:, 0] & 0xff, nz[:, 0] >> 8,
            torch.tensor(nz[:, 1].copy().view(np.float32)))


def _x_rows(conv, x, src):
    """x[src] with the rows of sources outside [0, N) zero."""
    ok = (src >= 0) & (src < x.shape[0])
    return torch.where(ok[:, None], x[src.clamp(0, x.shape[0] - 1)], 0.0)


def walk_forward(conv, x, sh, w, wsel, edge_src, k=None, sms=SMS):
    """K6 as its units run it on the cut ``fwd_units[k]`` (the plan's for
    these edges when None): per unit, K steps over channel chunks of
    ``FWD_KC`` and, inside each, its group's paths, each adding the S tiles
    of the unit's components (w times the sums of C sh[m2] x[m1] over
    their m3 runs) times the path's rows of the mix matrices; each unit's
    columns stored once.  Unwritten columns stay NaN; sums in x's dtype."""
    tab, E, mul = conv.fwd_tables, sh.shape[0], conv.fused.mul
    if k is None:
        k = forward_plan(E, tab.fwd_units, sms)
    m1, m2, coef = _fused_codes(conv)
    xe = _x_rows(conv, x, edge_src)
    wcols = conv.k6_wcols.numpy()
    out = torch.full((E, conv.out_dim), float("nan"), dtype=x.dtype)
    for p0, n, d3, m3_0, nm3, out_col, wo, b_off in tab.fwd_units[k]:
        acc = torch.zeros(nm3, E, wo, dtype=x.dtype)
        for u0 in range(0, mul, FWD_KC):
            ch = slice(u0, u0 + FWD_KC)
            for kp in range(n):
                x_off, d1, j0, _, _, z0, _ = tab.paths[p0 + kp, :7]
                runs = tab.paths[p0 + kp, 7:]
                X = xe[:, x_off: x_off + mul * d1].reshape(E, mul, d1)[:, ch]
                W = wsel[b_off + kp * mul * wo: b_off + (kp + 1) * mul * wo]
                wr = w[:, wcols[p0 + kp]: wcols[p0 + kp] + mul][:, ch]
                for i in range(nm3):
                    z = np.arange(z0 + runs[m3_0 + i], z0 + runs[m3_0 + i + 1])
                    cs = coef[z] * sh[:, j0 + m2[z]]            # [E, nz]
                    S = wr * (cs[:, None, :] * X[:, :, m1[z]]).sum(-1)
                    acc[i] += S @ W.reshape(mul, wo)[ch]
        for i in range(nm3):
            out[:, out_col + np.arange(wo) * d3 + m3_0 + i] = acc[i]
    return out


def walk_dws(conv, x, sh, w, edge_src, gout, sms=SMS):
    """K6b's dwsel as its units run it: per unit (path, slot, ``DWS_KC``
    channels) and chunk of edge tiles (``dws_plan``), per tile of
    ``DWS_TILE`` edges and component m3, S[m3]^T gout[m3]; each chunk's
    block stored once in the workspace, then the chunks added in order."""
    tab, E, mul = conv.fwd_tables, sh.shape[0], conv.fused.mul
    m1, m2, coef = _fused_codes(conv)
    xe = _x_rows(conv, x, edge_src)
    wcols = conv.k6_wcols.numpy()
    chunks, per = dws_plan(E, len(tab.dws_units), sms)
    tiles = -(-E // DWS_TILE)
    ws = torch.full((chunks, conv.wsel_len), float("nan"), dtype=x.dtype)
    for path, out_col, wo, b_off, u0 in tab.dws_units:
        x_off, d1, j0, _, d3, z0, _ = tab.paths[path, :7]
        runs = tab.paths[path, 7:]
        ch = slice(u0, min(u0 + DWS_KC, mul))
        X = xe[:, x_off: x_off + mul * d1].reshape(E, mul, d1)[:, ch]
        wr = w[:, wcols[path]: wcols[path] + mul][:, ch]
        S, G = [], []
        for m3 in range(d3):
            z = np.arange(z0 + runs[m3], z0 + runs[m3 + 1])
            cs = coef[z] * sh[:, j0 + m2[z]]
            S.append(wr * (cs[:, None, :] * X[:, :, m1[z]]).sum(-1))
            G.append(gout[:, out_col + np.arange(wo) * d3 + m3])
        rows = b_off + np.arange(u0, ch.stop)[:, None] * wo + np.arange(wo)
        for c in range(chunks):
            part = torch.zeros(ch.stop - u0, wo, dtype=x.dtype)
            for t in range(c * per, min(tiles, (c + 1) * per)):
                e = slice(t * DWS_TILE, min(E, (t + 1) * DWS_TILE))
                for m3 in range(d3):
                    part += S[m3][e].T @ G[m3][e]
            ws[c, rows.reshape(-1)] = part.reshape(-1)
    dwsel = ws[0].clone()
    for c in range(1, chunks):
        dwsel += ws[c]
    return dwsel


def walk_adjoint(conv, x, sh, w, wsel, edge_src, gout, k):
    """K6b's adjoint sweep as its units run it on ``adj_tables.cuts[k]``:
    per unit (chunk of one left irrep's paths, ``ADJ_KC`` channels) and
    path, dS from the path's slots (gout block times the path's mix rows),
    dx by the m1 runs (a sum per channel and m1 over the chunk's paths),
    t by the m2 runs, dw = sum_m2 sh t stored per path, dsh += sum_u w t
    in the unit's row.  Returns ``(dw, dx_ws [E, ws_width], dsh_ws [U, E,
    J])``; entries no unit wrote stay NaN."""
    adj, E, mul = conv.adj_tables, sh.shape[0], conv.fused.mul
    cut, J = adj.cuts[k], conv.fused.J_dim
    first, m3s = adj.nz[..., 0] & 0xff, adj.nz[..., 0] >> 8
    coef = torch.tensor(adj.nz[..., 1].copy().view(np.float32))
    xe = _x_rows(conv, x, edge_src)
    dw = torch.full_like(w, float("nan"))
    dx_ws = torch.full((E, cut.ws_width), float("nan"), dtype=x.dtype)
    dsh_ws = torch.full((len(cut.units), E, J), float("nan"), dtype=x.dtype)
    for u, (c, u0) in enumerate(cut.units):
        x_off, d1, p0, p1, ws_col = cut.chunks[c]
        ch = slice(u0, min(u0 + ADJ_KC, mul))
        X = xe[:, x_off: x_off + mul * d1].reshape(E, mul, d1)[:, ch]
        dxl = torch.zeros(E, ch.stop - u0, d1, dtype=x.dtype)
        row = torch.zeros(E, J, dtype=x.dtype)
        for q in range(p0, p1):
            j0, d2, _, _, d3 = adj.paths[q, :5]
            runs_a, runs_b = adj.paths[q, 7:17], adj.paths[q, 17:27]
            wcol, s0, n_slots = adj.ext[q]
            wr = w[:, wcol: wcol + mul][:, ch]
            dS = torch.zeros(E, d3, ch.stop - u0, dtype=x.dtype)
            for out_col, wo, b_off in adj.slots[s0: s0 + n_slots]:
                Wp = wsel[b_off: b_off + mul * wo].reshape(mul, wo)[ch]
                for m3 in range(d3):
                    dS[:, m3] += gout[:, out_col + np.arange(wo) * d3 + m3] \
                        @ Wp.T
            for i in range(d1):
                z = np.arange(runs_a[i], runs_a[i + 1])
                cs = coef[0, z] * sh[:, j0 + first[0, z]]          # [E, nz]
                dxl[:, :, i] += wr * (cs[:, None, :] * dS[:, m3s[0, z]]
                                      .transpose(1, 2)).sum(-1)
            dwv = torch.zeros(E, ch.stop - u0, dtype=x.dtype)
            for i in range(d2):
                z = np.arange(runs_b[i], runs_b[i + 1])
                t = (coef[1, z] * X[:, :, first[1, z]]
                     * dS[:, m3s[1, z]].transpose(1, 2)).sum(-1)
                dwv += sh[:, j0 + i, None] * t
                row[:, j0 + i] += (wr * t).sum(-1)
            dw[:, wcol + u0: wcol + ch.stop] = dwv
        cols = ws_col + np.arange(u0, ch.stop)[:, None] * d1 + np.arange(d1)
        dx_ws[:, cols.reshape(-1)] = dxl.reshape(E, -1)
        dsh_ws[u] = row
    return dw, dx_ws, dsh_ws


def dx_route(conv, cut, dx_ws, edge_src, order, N_):
    """dx as the ordered sums make it: per source node, its edges in the
    source-major order (then those past the last run whose source is the
    node), each irrep's chunks in order; zeros for an irrep of no chunk."""
    E = edge_src.shape[0]
    dx = torch.zeros(N_, conv.fused.irreps_in.dim, dtype=dx_ws.dtype)
    perm, ptr = order.src_perm.long(), order.src_ptr.long()
    tail = [int(e) for e in perm[int(ptr[N_]):]]
    for n in range(N_):
        edges = [int(e) for e in perm[int(ptr[n]): int(ptr[n + 1])]]
        edges += [e for e in tail if int(edge_src[e]) == n]
        for x_off, width, ws_col, n_chunks in cut.irreps:
            s = torch.zeros(width, dtype=dx_ws.dtype)
            for e in edges:
                for kc in range(n_chunks):
                    c0 = ws_col + kc * width
                    s += dx_ws[e, c0: c0 + width]
            dx[n, x_off: x_off + width] = s
    return dx


def walk_backward(conv, x, sh, w, wsel, edge_src, gout, order=None, k=None,
                  sms=SMS):
    """K6b's contract as its kernels compute it: ``(dx, dsh, dw, dwsel)``
    on the cut ``k`` of the adjoint sweep (the plan's when None) and the
    edges' ``order`` (built from the sources when None)."""
    E, N_ = sh.shape[0], x.shape[0]
    if k is None:
        k = adjoint_plan(E, conv.adj_tables.cuts, sms)
    if order is None:
        order = edge_order.build(edge_src, edge_src, N_)
    dw, dx_ws, dsh_ws = walk_adjoint(conv, x, sh, w, wsel, edge_src, gout,
                                     k)
    dsh = dsh_ws[0].clone()
    for u in range(1, dsh_ws.shape[0]):
        dsh += dsh_ws[u]
    dx = dx_route(conv, conv.adj_tables.cuts[k], dx_ws, edge_src, order, N_)
    return dx, dsh, dw, walk_dws(conv, x, sh, w, edge_src, gout, sms)


# ------------------------------------------------------------------ tables


@SPLITS
@TABLES
def test_forward_units_own_each_output_column_once(request, which, k):
    conv = _conv(request, which).full_conv
    units = conv.fwd_tables.fwd_units[k]
    seen = np.zeros(conv.out_dim, np.int64)
    for p0, n, d3, m3_0, nm3, out_col, wo, b_off in units:
        assert 1 <= nm3 <= FWD_SPLITS[k] and m3_0 + nm3 <= d3
        assert (conv.fwd_tables.paths[p0: p0 + n, 4] == d3).all()
        for m3 in range(m3_0, m3_0 + nm3):
            hit = [r for r in conv.prob_rows if r[4] == out_col + m3]
            assert len(hit) == 1 and hit[0][2] == b_off
            assert hit[0][1] == n * conv.fused.mul and hit[0][3] == wo
            seen[out_col + np.arange(wo) * d3 + m3] += 1
    assert (seen == 1).all()


@TABLES
def test_dws_units_own_each_dwsel_entry_once(request, which):
    conv = _conv(request, which).full_conv
    seen = np.zeros(conv.wsel_len, np.int64)
    for path, out_col, wo, b_off, u0 in conv.fwd_tables.dws_units:
        u = np.arange(u0, min(u0 + DWS_KC, conv.fused.mul))
        seen[(b_off + u[:, None] * wo + np.arange(wo)).reshape(-1)] += 1
    assert (seen == 1).all()


@CUTS
@TABLES
def test_adjoint_units_own_each_dw_dx_and_dsh_entry_once(request, which, k):
    """Per cut: each (path, channel) of dw in one unit; each chunk's dx
    columns in one unit per channel; the irreps cover every input column
    in order with their chunks' columns; one dsh row per unit; the path
    rows, slots and re-coded non-zeros agree with the conv's tables."""
    conv = _conv(request, which).full_conv
    adj, mul = conv.adj_tables, conv.fused.mul
    cut = adj.cuts[k]
    rows = conv.path_table.numpy().reshape(-1, 9)
    assert sorted(adj.order) == list(range(conv.n_paths))
    dw_seen = np.zeros((conv.n_paths, mul), np.int64)
    ws_seen = np.zeros(cut.ws_width, np.int64)
    for c, u0 in cut.units:
        x_off, d1, p0, p1, ws_col = cut.chunks[c]
        u = np.arange(u0, min(u0 + ADJ_KC, mul))
        for q in range(p0, p1):
            assert tuple(rows[adj.order[q], :2]) == (x_off, d1)
            dw_seen[adj.order[q], u] += 1
        ws_seen[ws_col + (u[:, None] * d1 + np.arange(d1)).reshape(-1)] += 1
    assert (dw_seen == 1).all() and (ws_seen == 1).all()
    assert cut.irreps[0, 0] == 0
    assert (cut.irreps[1:, 0] == cut.irreps[:-1, 0] + cut.irreps[:-1, 1]).all()
    assert cut.irreps[-1, 0] + cut.irreps[-1, 1] == conv.fused.irreps_in.dim
    for x_off, width, ws_col, n in cut.irreps:
        mine = cut.chunks[cut.chunks[:, 0] == x_off]
        assert len(mine) == n and (mine[:, 4] == ws_col
                                   + width * np.arange(n)).all()
    assert len({tuple(u) for u in cut.units}) == len(cut.units)
    # the paths' weight columns and slots
    for q, (wcol, s0, n_slots) in enumerate(adj.ext):
        assert wcol == rows[adj.order[q], 6]
        groups = [s for s in conv.slots
                  if s[0] <= adj.order[q] < s[0] + s[1]]
        assert n_slots == len(groups)
        for (p0, _, _, out_col, wo, b_off), slot in zip(
                groups, adj.slots[s0: s0 + n_slots]):
            assert tuple(slot) == (out_col, wo,
                                   b_off + (adj.order[q] - p0) * mul * wo)
    # both orders hold each non-zero of the path once, as (m1, m2, m3)
    for q, row in enumerate(adj.paths):
        nz0, nz1 = rows[adj.order[q], 7:9]
        code = conv.nz_idx.numpy()[nz0:nz1]
        want = sorted(zip(code & 0xff, (code >> 8) & 0xff, code >> 16))
        z = np.arange(row[5], row[6])
        d1 = rows[adj.order[q], 1]
        lead0 = np.repeat(np.arange(d1), np.diff(row[7: 8 + d1]))
        first, m3 = adj.nz[..., 0] & 0xff, adj.nz[..., 0] >> 8
        got0 = sorted(zip(lead0, first[0, z], m3[0, z]))
        lead1 = np.repeat(np.arange(row[1]), np.diff(row[17: 18 + row[1]]))
        got1 = sorted(zip(first[1, z], lead1, m3[1, z]))
        assert got0 == want and got1 == want


def test_dx_sum_takes_each_edge_once():
    """The dx sum's walk: the source-major order's runs hold each edge
    with a source in [0, N) once, at its source, and the edges of an
    endpoint outside [0, N) come after the last run, where the sum checks
    them one by one: each edge's dx columns reach one node, its source.
    (Each (edge, j) of dsh is one ordered sum over the units' rows, each
    unit writing its rows once: the walks hold both.)"""
    rng = np.random.default_rng(5)
    n, E = 9, 40
    src = torch.tensor(rng.integers(0, n, E))
    dst = torch.tensor(rng.integers(0, n, E))
    src[3], dst[7], src[11] = n + 2, -1, -3
    order = edge_order.build(src, dst, n)
    perm, ptr = order.src_perm.long(), order.src_ptr.long()
    owners = np.zeros(E, np.int64)
    for node in range(n):
        for e in perm[int(ptr[node]): int(ptr[node + 1])]:
            assert int(src[e]) == node
            owners[int(e)] += 1
    for e in perm[int(ptr[n]):]:
        owners[int(e)] += int(0 <= int(src[e]) < n)
    want = ((src >= 0) & (src < n)).numpy().astype(np.int64)
    assert (owners == want).all()


# ------------------------------------------------------------------ walks


def _inputs(conv, E, N_, seed):
    """Seeded float32 draws cast to float64: x [N_, in_dim], sh, w, gout,
    sources with a shared one, and the flat mix matrices."""
    rng = np.random.default_rng(seed)
    fused = conv.fused

    def draw(*shape, scale=1.0):
        return torch.tensor((rng.normal(size=shape) * scale).astype(
            np.float32)).double()

    x = draw(N_, fused.irreps_in.dim)
    sh = draw(E, fused.J_dim)
    w = draw(E, fused.weight_numel, scale=0.3)
    gout = draw(E, conv.out_dim)
    src = torch.tensor(rng.integers(0, N_, E))
    return x, sh, w, gout, src


def _plain64(conv):
    """A float64 copy of the conv for its plain contracts (its CG tables
    hold the kernels' float32 coefficients, exact in float64)."""
    return copy.deepcopy(conv).double()


def _walk_against_plain(tconv, E, N_, seed, src_fix=None):
    conv, lin = tconv.full_conv, tconv.tp.linear
    x, sh, w, gout, src = _inputs(conv, E, N_, seed)
    if src_fix is not None:
        src_fix(src, N_)
    with torch.no_grad():
        wsel = conv.flat_wsel(lin).double()
    out = walk_forward(conv, x, sh, w, wsel, src)
    dx, dsh, dw, dwsel = walk_backward(conv, x, sh, w, wsel, src, gout)
    for t in (out, dx, dsh, dw, dwsel):
        assert torch.isfinite(t).all()
    # the plain contracts on x with a zero row for the outside source
    x0 = torch.cat([x, x.new_zeros(1, x.shape[1])])
    src0 = torch.where((src >= 0) & (src < N_), src, N_)
    plain = _plain64(conv)
    with torch.no_grad():
        want = plain.plain_forward(x0, sh, w, wsel, src0)
    want_b = plain.plain_backward(x0, sh, w, wsel, src0, gout)
    assert _rel(out.numpy(), want.numpy()) < WALK_TOL
    for name, g, ref in zip(("dx", "dsh", "dw", "dwsel"),
                            (dx, dsh, dw, dwsel),
                            (want_b[0][:N_], *want_b[1:])):
        assert _rel(g.numpy(), ref.numpy()) < WALK_TOL, name
    return src


def test_walks_match_plain_on_the_narrow_layer(convs):
    """E = 41: two edge tiles of 16 and a ragged third, six dwsel chunks
    of one tile, several sweep chunks per irrep; edges 5-8 share a source,
    edge 40's source lies outside [0, N)."""
    tconv = convs[2]
    conv = tconv.full_conv
    assert dws_plan(41, len(conv.fwd_tables.dws_units), SMS)[0] > 1
    assert any(n > 1 for *_, n in conv.adj_tables.cuts[-1].irreps)

    def fix(src, n):
        src[5:9] = src[5]
        src[40] = n

    src = _walk_against_plain(tconv, 41, N, 21, fix)
    assert int(src[40]) == N and len(set(src[5:9].tolist())) == 1


@SPLITS
def test_walks_match_plain_at_every_cut(convs, k):
    """Every cut of K6's components against the plain forward, on the
    narrow layer at 41 edges (the backward's cuts: the next test)."""
    tconv = convs[2]
    conv = tconv.full_conv
    x, sh, w, _, src = _inputs(conv, 41, N, 22)
    with torch.no_grad():
        wsel = conv.flat_wsel(tconv.tp.linear).double()
        want = _plain64(conv).plain_forward(x, sh, w, wsel, src)
    out = walk_forward(conv, x, sh, w, wsel, src, k=k)
    assert _rel(out.numpy(), want.numpy()) < WALK_TOL


@CUTS
def test_adjoint_walk_matches_plain_at_both_cuts(convs, k):
    tconv = convs[2]
    conv = tconv.full_conv
    x, sh, w, gout, src = _inputs(conv, 41, N, 23)
    with torch.no_grad():
        wsel = conv.flat_wsel(tconv.tp.linear).double()
    dx, dsh, dw, _ = walk_backward(conv, x, sh, w, wsel, src, gout, k=k)
    want = _plain64(conv).plain_backward(x, sh, w, wsel, src, gout)
    for name, g, ref in zip(("dx", "dsh", "dw"), (dx, dsh, dw), want):
        assert _rel(g.numpy(), ref.numpy()) < WALK_TOL, name


def test_walks_match_plain_at_full_width(head):
    _walk_against_plain(head, 3, 2, 24)


# ------------------------------------------------------------------ routed


@pytest.fixture
def routed_walks(monkeypatch):
    """``UVUConv`` down its card path with the launches sent to the walks
    (float32, the plans' cuts); returns the launches' edge counts."""
    calls = []

    def launch_forward(conv, x, sh, w, wsel, edge_src):
        calls.append(("K6", sh.shape[0]))
        return walk_forward(conv, x, sh, w, wsel, edge_src)

    def launch_backward(conv, x, sh, w, wsel, edge_src, gout, order=None):
        calls.append(("K6b", sh.shape[0]))
        assert order is not None
        return walk_backward(conv, x, sh, w, wsel, edge_src, gout, order)

    monkeypatch.setattr(UVUConv, "forward", UVUConv.launch)
    monkeypatch.setattr(uvu_mod, "launch_forward", launch_forward)
    monkeypatch.setattr(uvu_mod, "launch_backward", launch_backward)
    return calls


def test_routed_walks_match_jax(convs, routed_walks):
    """The layer's per-edge conv, its launches sent to the walks on the
    edges' order: output and the gradients of x, sh, w and the mix
    Linear's parameters against JAX's ``FusedUVUConv`` (``reduce=False``)
    and its ``jax.grad``."""
    jconv, params, tconv, i = convs
    jf = JFused(jconv.tp, compute_dtype=jnp.float32)
    src, dst = (jnp.asarray(i[k], jnp.int32) for k in ("src", "dst"))

    def loss(lp, x, sh, w):
        out = jf(lp, x, src, dst, sh, w, N, reduce=False)
        return jnp.sum(out * jnp.cos(jnp.arange(out.size).reshape(
            out.shape))), out

    (_, ref_out), ref = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        params["tp"]["linear"], *(jnp.asarray(i[k])
                                  for k in ("x", "sh", "w")))
    args = [torch.tensor(i[k], requires_grad=True) for k in ("x", "sh", "w")]
    before = edge_order.builds
    out = tconv.full_conv(tconv.tp.linear, *args, torch.tensor(i["src"]),
                          torch.tensor(i["dst"]))
    assert _rel(out.detach().numpy(), ref_out) < TOL
    lin = dict(tconv.tp.linear.named_parameters())
    got = torch.autograd.grad(out, [*args, *lin.values()],
                              _cotangent(out.shape))
    assert [c for c, _ in routed_walks] == ["K6", "K6b"]
    assert edge_order.builds <= before + 1
    for name, g, want in zip(("dx", "dsh", "dw"), got, ref[1:]):
        assert _rel(g.numpy(), want) < GRAD_TOL, name
    from equivariant_nn_zoo_tpu_torch.utils.params import params_from_jax
    want_lin = params_from_jax(jax.device_get(ref[0]))
    for name, g in zip(lin, got[3:]):
        assert _rel(g.numpy(), want_lin[name].numpy()) < GRAD_TOL, name
