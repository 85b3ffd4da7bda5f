"""The fused forward (K5) and K5m of the pairwise expansion
(``ops/cuda/pairwise_tp.py``, ``pairwise_fwd_kernel`` and
``pairwise_dws_kernel`` in ``csrc/pairwise_tp.cu``) on the CPU:

- their host tables (``FusedTables``) at the full-width hamiltonian head's
  structure (64 channels of l <= 4, both parities, as ``Pairwise`` builds
  its expansion): each path's non-zeros once, sorted by m3, with their run
  bounds; one owner for every output column (each cut of the components)
  and for every dwsel entry; the plans at the head's element counts;
- ``fused_walk``, a plain PyTorch emulation of the kernels' units (K5: a
  unit's K steps over channel chunks and its group's paths, the S tiles of
  its components from the m3 runs; K5m: per chunk of element tiles, per
  tile and component, S^T gout, then the chunks added in order), against
  ``plain_forward`` and ``plain_backward``'s dwsel at rel-linf 1e-12
  (float64 inputs cast from seeded float32 draws: only the summation
  orders differ, so the check repeats whatever the thread count) on the
  specs of
  ``tests/test_torch_pairwise.py`` and at full width, and through that
  file's ``routed`` fixture (the launches sent to ``fused_walk``) against
  JAX ``expand`` and its gradients at ``GRAD_TOL``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pairwise import (  # noqa: F401  (routed is a fixture)
    GRAD_TOL,
    IDS,
    SPECS,
    TOL,
    _cos_loss_np,
    make,
    routed,
)
from test_torch_pairwise_adj import (  # noqa: F401  (fixtures)
    FEATURES,
    _rel,
    head,
    jax_grads,
)

from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as pairwise_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda.full_conv import MAX_D
from equivariant_nn_zoo_tpu_torch.ops.cuda.pairwise_tp import (
    DWS_KC,
    DWS_TILE,
    FWD_KC,
    FWD_SPLITS,
    FWD_TILE,
    PairwiseTP,
    dws_plan,
    forward_plan,
)
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

WALK_TOL = 1e-12
SMS = 132                        # an H100's multiprocessors
SPLITS = pytest.mark.parametrize("k", range(len(FWD_SPLITS)),
                                 ids=["groups", "threes", "ones"])


def _codes(tpk):
    nz = tpk.fused.nz
    return (nz[:, 0] & 0xff, nz[:, 0] >> 8,
            torch.tensor(nz[:, 1].copy().view(np.float32)))


def walk_forward(tpk, a, bw, wsel, k):
    """K5 as its units run it on the cut ``fwd_units[k]``: per unit, K
    steps over channel chunks of ``FWD_KC`` and, inside each, its paths,
    each adding the S tiles of the unit's components (summed over their m3
    runs) times the path's rows of the mix matrices; each unit's columns
    stored once.  Unwritten columns stay NaN; sums in ``a``'s dtype."""
    f, M, mul = tpk.fused, a.shape[0], tpk.mul
    m1, m2, coef = _codes(tpk)
    out = torch.full((M, tpk.out_dim), float("nan"), dtype=a.dtype)
    for p0, n, d3, m3_0, nm3, out_col, wo, b_off in f.fwd_units[k]:
        acc = torch.zeros(nm3, M, wo, dtype=a.dtype)
        for u0 in range(0, mul, FWD_KC):
            ch = slice(u0, u0 + FWD_KC)
            for kp in range(n):
                x_off, d1, r0, d2, _, z0, _ = f.paths[p0 + kp, :7]
                runs = f.paths[p0 + kp, 7:]
                A = a[:, x_off: x_off + mul * d1].reshape(M, mul, d1)
                W = wsel[b_off + kp * mul * wo: b_off + (kp + 1) * mul * wo]
                W = W.reshape(mul, wo)
                for i in range(nm3):
                    z = np.arange(z0 + runs[m3_0 + i], z0 + runs[m3_0 + i + 1])
                    S = (coef[z] * A[:, ch][:, :, m1[z]]
                         * bw[:, r0 + m2[z], ch].transpose(1, 2)).sum(-1)
                    acc[i] += S @ W[ch]
        for i in range(nm3):
            out[:, out_col + np.arange(wo) * d3 + m3_0 + i] = acc[i]
    return out


def walk_dws(tpk, a, bw, gout, sms=SMS):
    """K5m as its units run it: per unit (path, slot, ``DWS_KC``
    channels) and chunk of element tiles (``dws_plan``), per tile of
    ``DWS_TILE`` elements and component m3, S[m3]^T gout[m3]; each chunk's
    block stored once in the workspace, then the chunks added in order.
    Unwritten entries stay NaN; sums in ``a``'s dtype."""
    f, M, mul = tpk.fused, a.shape[0], tpk.mul
    m1, m2, coef = _codes(tpk)
    chunks, per = dws_plan(M, len(f.dws_units), sms)
    tiles = -(-M // DWS_TILE)
    ws = torch.full((chunks, tpk.wsel_len), float("nan"), dtype=a.dtype)
    for path, out_col, wo, b_off, u0 in f.dws_units:
        x_off, d1, r0, d2, d3, z0, _ = f.paths[path, :7]
        runs = f.paths[path, 7:]
        ch = slice(u0, min(u0 + DWS_KC, mul))
        A = a[:, x_off: x_off + mul * d1].reshape(M, mul, d1)[:, ch]
        S, G = [], []
        for m3 in range(d3):
            z = np.arange(z0 + runs[m3], z0 + runs[m3 + 1])
            S.append((coef[z] * A[:, :, m1[z]]
                      * bw[:, r0 + m2[z], ch].transpose(1, 2)).sum(-1))
            G.append(gout[:, out_col + np.arange(wo) * d3 + m3])
        rows = b_off + np.arange(u0, ch.stop)[:, None] * wo + np.arange(wo)
        for c in range(chunks):
            part = torch.zeros(ch.stop - u0, wo, dtype=a.dtype)
            for t in range(c * per, min(tiles, (c + 1) * per)):
                e = slice(t * DWS_TILE, min(M, (t + 1) * DWS_TILE))
                for m3 in range(d3):
                    part += S[m3][e].T @ G[m3][e]
            ws[c, rows.reshape(-1)] = part.reshape(-1)
    dwsel = ws[0].clone()
    for c in range(1, chunks):
        dwsel += ws[c]
    return dwsel


def fused_walk(tpk, a, bw, wsel, gout=None, k=None, sms=SMS):
    """``(out, dwsel)`` as K5 and K5m compute them, on the cut that the
    forward's plan takes for these elements on ``sms`` multiprocessors
    (or ``fwd_units[k]``); dwsel None without ``gout``."""
    if k is None:
        k = forward_plan(a.shape[0], tpk.fused.fwd_units, sms)
    return (walk_forward(tpk, a, bw, wsel, k),
            None if gout is None else walk_dws(tpk, a, bw, gout, sms))


@pytest.fixture(scope="module")
def small_heads():
    """Per spec: the port's expansion and its kernel tables."""
    out = {}
    for spec, name in zip(SPECS, IDS):
        _, _, ttpe, _, _ = make(*spec, seed=11)
        out[name] = (ttpe, PairwiseTP(ttpe))
    return out


def _tables(request, which):
    if which == "full":
        return request.getfixturevalue("head")[1]
    return request.getfixturevalue("small_heads")[which][1]


TABLES = pytest.mark.parametrize("which", ["full", *IDS])


@TABLES
def test_non_zeros_once_per_path_sorted_by_m3_with_runs(request, which):
    tpk = _tables(request, which)
    f = tpk.fused
    m1, m2, coef = _codes(tpk)
    assert len(f.paths) == tpk.n_paths
    for row, prow in zip(f.paths, tpk.path_rows):
        x_off, d1, r0, d2, d3, z0, n_z = row[:7]
        runs = row[7:]
        assert (x_off, d1, r0, d2) == tuple(prow[[0, 1, 2, 3]])
        assert z0 % 2 == 0 and n_z == prow[8] - prow[7]
        assert runs[0] == 0 and runs[d3] == n_z
        assert (np.diff(runs[: d3 + 1]) > 0).all()   # every m3 has some
        assert (runs[d3:] == n_z).all() and len(runs) == MAX_D + 1
        m3 = np.repeat(np.arange(d3), np.diff(runs[: d3 + 1]))
        z = np.arange(z0, z0 + n_z)
        got = list(zip(m3, m1[z], m2[z]))
        assert got == sorted(got)
        code = tpk.nz_codes[prow[7]: prow[8]]
        want = sorted(zip(code >> 16, code & 0xff, (code >> 8) & 0xff,
                          tpk.nz_values[prow[7]: prow[8]]))
        assert sorted(zip(m3, m1[z], m2[z], coef[z].numpy())) == want
    assert f.dims[3] == max(n + n % 2 for n in f.paths[:, 6])


@SPLITS
@TABLES
def test_forward_units_own_each_output_column_once(request, which, k):
    tpk = _tables(request, which)
    units = tpk.fused.fwd_units[k]
    seen = np.zeros(tpk.out_dim, np.int64)
    groups = {(p0, n) for p0, n in zip(units[:, 0], units[:, 1])}
    for p0, n, d3, m3_0, nm3, out_col, wo, b_off in units:
        assert 1 <= nm3 <= FWD_SPLITS[k] and m3_0 + nm3 <= d3
        assert (tpk.fused.paths[p0: p0 + n, 4] == d3).all()
        # the slot's mix problems: one per component, matrices from b_off
        for m3 in range(m3_0, m3_0 + nm3):
            hit = [r for r in tpk.prob_rows if r[4] == out_col + m3]
            assert len(hit) == 1 and hit[0][2] == b_off
            assert hit[0][1] == n * tpk.mul and hit[0][3] == wo
            seen[out_col + np.arange(wo) * d3 + m3] += 1
    assert (seen == 1).all()
    # the groups tile the paths
    starts = sorted(groups)
    assert starts[0][0] == 0 and sum(n for _, n in starts) == tpk.n_paths
    assert all(a[0] + a[1] == b[0] for a, b in zip(starts, starts[1:]))
    # heaviest first: whole groups of the largest d3 lead
    if k == 0 and which == "full":
        assert units[0, 2] == MAX_D


@TABLES
def test_dws_units_own_each_dwsel_entry_once(request, which):
    tpk = _tables(request, which)
    f, mul = tpk.fused, tpk.mul
    seen = np.zeros(tpk.wsel_len, np.int64)
    for path, out_col, wo, b_off, u0 in f.dws_units:
        assert u0 % DWS_KC == 0 and u0 < mul
        u = np.arange(u0, min(u0 + DWS_KC, mul))
        seen[(b_off + u[:, None] * wo + np.arange(wo)).reshape(-1)] += 1
        d3 = f.paths[path, 4]
        assert any(r[4] == out_col and r[5] == d3 for r in tpk.prob_rows)
    assert (seen == 1).all()


@pytest.mark.parametrize("M", [1, 49, 96, 385, 1537, 3072, 4096])
def test_plans_fill_the_card(head, M):
    """Whole groups wherever their tiles give two blocks per
    multiprocessor (the 512-molecule head's calls), the components split
    at batch 16's 49 and 96 elements; K5m's chunks: about
    ``DWS_BLOCKS_PER_SM`` blocks per multiprocessor, whole tiles each."""
    _, tpk = head
    f = tpk.fused
    k = forward_plan(M, f.fwd_units, SMS)
    tiles = -(-M // FWD_TILE)
    blocks = tiles * len(f.fwd_units[k])
    if k < len(FWD_SPLITS) - 1:
        assert blocks >= 2 * SMS
    for k2 in range(k):
        assert tiles * len(f.fwd_units[k2]) < 2 * SMS
    if M >= 1537:
        assert k == 0
    if M in (49, 96):
        assert k == len(FWD_SPLITS) - 1 and blocks >= SMS
    chunks, per = dws_plan(M, len(f.dws_units), SMS)
    dws_tiles = -(-M // DWS_TILE)
    assert (chunks - 1) * per < dws_tiles <= chunks * per
    assert chunks <= dws_tiles
    if M >= 49:
        assert chunks * len(f.dws_units) >= 2 * SMS


def _case(tpk, tpe, M, seed):
    rng = np.random.default_rng(seed)
    a, b, gout = (torch.tensor(rng.normal(size=(M, n)), dtype=torch.float32)
                  for n in (tpk.irreps_a.dim, tpk.irreps_b.dim, tpk.out_dim))
    with torch.no_grad():
        bw = tpk.weighted_right(tpe.tp.weight, b)
        wsel = tpk.flat_wsel(tpe.linear)
    return a, bw, wsel, gout


def _walk_against_plain(tpk, tpe, M, seed, k):
    """The walk against the plain contracts, both in float64."""
    a, bw, wsel, gout = (t.double() for t in _case(tpk, tpe, M, seed))
    out, dwsel = fused_walk(tpk, a, bw, wsel, gout, k)
    assert torch.isfinite(out).all() and torch.isfinite(dwsel).all()
    with torch.no_grad():
        want = tpk.plain_forward(a, bw, wsel)
    assert _rel(out.numpy(), want.numpy()) < WALK_TOL
    want_dwsel = tpk.plain_backward(a, bw, wsel, gout, (False, False, True))
    assert _rel(dwsel.numpy(), want_dwsel[2].numpy()) < WALK_TOL


@SPLITS
@pytest.mark.parametrize("spec", IDS)
def test_fused_walk_matches_plain(small_heads, spec, k):
    tpe, tpk = small_heads[spec]
    # 41 elements: a ragged last tile of both kernels, several K5m chunks
    assert dws_plan(41, len(tpk.fused.dws_units), SMS)[0] > 1
    _walk_against_plain(tpk, tpe, 41, 12, k)


@SPLITS
def test_fused_walk_matches_plain_at_full_width(head, k):
    tpe, tpk = head
    _walk_against_plain(tpk, tpe, 3, 13, k)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_routed_fused_walk_matches_jax(spec, routed, monkeypatch, jax_grads):
    """``PairwiseTP`` down its card path with the forward launch sent to
    ``fused_walk`` and the backward's dwsel to its K5m walk (d left and
    dbw from ``plain_backward``): the output against JAX ``expand``, and
    left's, right's and every parameter's gradient against JAX's."""
    ttpe, a, b, want = jax_grads(spec)
    jtpe, params, _, _, _ = make(*spec, seed=14)
    ref = np.asarray(jtpe.expand(params, jnp.asarray(a), jnp.asarray(b)))
    tpk = PairwiseTP(ttpe)
    calls = []

    def launch_forward(tpk_, a_, bw, wsel):
        calls.append("forward")
        return fused_walk(tpk_, a_, bw, wsel)[0]

    def launch_backward(tpk_, a_, bw, wsel, gout, wanted=(True,) * 3):
        calls.append("backward")
        da, dbw, _ = tpk_.plain_backward(a_, bw, wsel, gout,
                                         (*wanted[:2], False))
        dwsel = walk_dws(tpk_, a_, bw, gout) if wanted[2] else None
        return da, dbw, dwsel

    monkeypatch.setattr(pairwise_mod, "launch_forward", launch_forward)
    monkeypatch.setattr(pairwise_mod, "launch_backward", launch_backward)
    a_ = torch.tensor(a, requires_grad=True)
    b_ = torch.tensor(b, requires_grad=True)
    out = tpk(ttpe, a_, b_)
    assert _rel(out.detach().numpy(), ref) < TOL
    named = dict(ttpe.named_parameters())
    grads = torch.autograd.grad(out, [a_, b_, *named.values()],
                                torch.tensor(_cos_loss_np(out.shape)))
    assert calls == ["forward", "backward"]
    for name, g in zip(("left", "right", *named), grads):
        assert _rel(g.numpy(), want[name]) < GRAD_TOL, name
