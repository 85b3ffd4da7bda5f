"""K5 and its backward (K5m, K5a, K5b): the internal-weight all-uvu
tensor-product expansion of the hamiltonian head (``Pairwise``'s ``tp`` and
``tp_off``), around ``csrc/pairwise_tp.cu``.

The kernels replace the TPU kernels ``PallasPairwiseTP._fwd_kernel``,
``_bwd_kernel_dws``, ``_bwd_kernel_da`` and ``_bwd_kernel_dbw``
(``equivariant_nn_zoo_tpu/ops/pallas/pairwise.py:410, :504, :556, :591``).
For one ``TensorProductExpansion`` with internal weights the forward
computes ``expand(left, right)``:

    out[m] = Mix( sum_p CG_p( left[m] (x) bw_p[m] ) ),
    bw_p[m, u, j] = sum_v W_p[u, v] right[m, v, j]

over the paths whose mid irrep the mix ``Linear`` reads, sorted by output
irrep.  As in the TPU package, stage 1 (``bw``, the per-path weighting of
the right operand: one dense product per right slot) stays outside the
kernel, in PyTorch; the kernel does the outer product, the CG contraction
over host-built wigner_3j non-zeros (path weights folded in) and the mix
(the ``Linear``'s alphas folded into the flat matrices ``wsel``).  ``bw`` is
``R * mul`` floats per element (384 KB at the full-width head, as wide as
the mid), so the wrapper runs elements in chunks of ``CHUNK``; each chunk is
one launch, forward and backward.

One instance serves every expansion of the same structure (``tp`` and
``tp_off``): the expansion whose parameters to use is passed at call time.
For tensors on the CPU the wrapper runs the plain version
(``TensorProductExpansion.expand``, the mid-fused lowering) and autograd
differentiates it.  For CUDA tensors it goes, chunk by chunk, through
``PairwiseTPFunction`` on ``(left, bw, wsel)``, whose forward launches K5
(the CG contraction made path by path into shared memory and mixed there
on the tensor cores, over ``FusedTables``) and whose backward launches the
cotangents' kernels from one entry (``dwsel``: K5m, on the same tables;
``d left`` and ``dbw``: K5a and K5b, one adjoint sweep over
``AdjointTables``), or raises.  Stage 1 and
``flat_wsel`` are PyTorch, so autograd carries ``dbw`` back to
``tp.weight`` and ``right`` and ``dwsel`` (summed over the chunks) to the
mix ``Linear``.  Neither the forward nor K5m writes the unmixed scratch to
device memory; what a training step keeps per element is ``bw`` alone.
``plain_forward`` and ``plain_backward`` are plain PyTorch versions of the
kernels' contracts that walk the same tables, for the tests and the
on-card checks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..wigner import wigner_3j
from . import row_mix
from .build import check, check_tensor, load_library
from .full_conv import MAX_D, mix_rows
from .species_sc import _multiprocessors


#: the adjoint sweep (csrc/pairwise_tp.cu, pairwise_adj_kernel): floats of
#: a staged row (a warp's 32 lanes, two channels each), fields of a path
#: row and of a chunk row
ADJ_ROW = 64
ADJ_PATH_FIELDS = 7 + 2 * (MAX_D + 1)
ADJ_CHUNK_FIELDS = 5
#: the two cuts of the paths into chunks, coarse (large M: fewer units
#: and partial sums) and fine (small M: a shorter longest unit), by the
#: number of chunks each one's balance cap aims at
ADJ_TARGET_CHUNKS = (16, 32)


#: the fused forward (K5) and K5m (csrc/pairwise_tp.cu): elements of a K5
#: tile and channels of its K step, elements of a K5m tile and channels of
#: a K5m unit, the output multiplicity they take at most, and the fields
#: of a path row
FWD_TILE, FWD_KC = 16, 16
DWS_TILE, DWS_KC = 8, 64
MAX_WO = 64
FUSED_PATH_FIELDS = 7 + MAX_D + 1
#: K5's cuts of a group's components over units, by the most components a
#: unit takes: whole groups (large M), threes, ones (small M)
FWD_SPLITS = (MAX_D, 3, 1)
#: K5m's blocks to aim for, per multiprocessor
DWS_BLOCKS_PER_SM = 8


class FusedTables(NamedTuple):
    """Host tables of the fused forward (K5) and of K5m, built by
    ``fused_tables``.

    - ``paths [P, FUSED_PATH_FIELDS]``: the paths in the path table's order
      (output-irrep groups contiguous), each ``(x_off, d1, r0, d2, d3, z0,
      n_z, runs[MAX_D + 1])``: its left columns ``x_off + u * d1 + m1``, its
      bw rows ``r0 + m2``, its non-zeros ``nz[z0: z0 + n_z]`` sorted by
      (m3, m1, m2), ``z0`` even (every path's block is padded to an even
      length: the kernels copy two entries at a time), and the bounds of
      their runs of equal m3 relative to ``z0``, padded with the last;
    - ``nz [Z, 2]`` int32: ``m1 | m2 << 8`` beside the coefficient's
      float32 bits;
    - ``fwd_units``: per ``FWD_SPLITS`` a table ``[U, 8]`` of ``(p0,
      n_paths, d3, m3_0, nm3, out_col, wo, b_off)``: the paths ``[p0, p0 +
      n_paths)`` of a group, the components ``[m3_0, m3_0 + nm3)`` of one
      output slot, at columns ``out_col + j * d3 + m3`` for ``j < wo``, and
      the slot's mix matrices from ``b_off`` (path k's ``[mul, wo]`` at
      ``b_off + k * mul * wo``); heaviest first;
    - ``dws_units [U, 5]``: ``(path, out_col, wo, b_off, u0)``: the ``[DWS_KC,
      wo]`` block of dwsel at ``b_off + u * wo + j`` of the path's channels
      ``u0 <= u < u0 + DWS_KC`` (below mul); heaviest first;
    - ``dims`` int32: ``(max d1, max d2, max d3, max non-zeros of a path
      (even), max wo, max paths of a group)``, which size the kernels'
      shared memory.
    """
    paths: np.ndarray
    nz: np.ndarray
    fwd_units: tuple
    dws_units: np.ndarray
    dims: np.ndarray


def fused_tables(path_rows, d3s, nz_codes, nz_values, slots, mul):
    """The ``FusedTables`` of a path table (``PairwiseTP.path_rows``, the
    output dims ``d3s`` of its paths, the non-zeros ``nz_codes`` /
    ``nz_values``) and its output slots ``slots`` [(p0, n_paths, d3,
    out_col, wo, b_off)] per (group, slot), at multiplicity ``mul``."""
    paths, nz = [], []
    for q, (x_off, d1, r0, d2, _, _, _, nz0, nz1) in enumerate(path_rows):
        code = np.asarray(nz_codes[nz0:nz1], np.int64)
        m1, m2, m3 = code & 0xff, (code >> 8) & 0xff, code >> 16
        idx = np.lexsort((m2, m1, m3))
        bits = nz_values[nz0:nz1][idx].view(np.int32)
        z0, d3 = len(nz), d3s[q]
        nz += [[int(c), int(b)] for c, b in zip(m1[idx] | m2[idx] << 8, bits)]
        nz += [[0, 0]] * (len(nz) % 2)
        runs = np.searchsorted(m3[idx], np.arange(d3 + 1))
        paths.append([x_off, d1, r0, d2, d3, z0, nz1 - nz0, *runs,
                      *[runs[-1]] * (MAX_D - d3)])
    paths = np.asarray(paths, np.int32).reshape(-1, FUSED_PATH_FIELDS)
    runs = paths[:, 7:]

    # a rough cost of a unit: its non-zeros plus its MMA tiles
    fwd_units = []
    for split in FWD_SPLITS:
        units = []
        for p0, n, d3, out_col, wo, b_off in slots:
            for m3_0 in range(0, d3, split):
                nm3 = min(split, d3 - m3_0)
                nz_in = int((runs[p0: p0 + n, m3_0 + nm3]
                             - runs[p0: p0 + n, m3_0]).sum())
                units.append((-(nz_in + n * nm3 * wo // 4),
                              [p0, n, d3, m3_0, nm3, out_col, wo, b_off]))
        fwd_units.append(np.asarray(
            [u for _, u in sorted(units, key=lambda cu: cu[0])],
            np.int32).reshape(-1, 8))
    units = []
    for p0, n, d3, out_col, wo, b_off in slots:
        for k in range(n):
            for u0 in range(0, mul, DWS_KC):
                units.append((-(int(paths[p0 + k, 6]) + d3 * wo // 4),
                              [p0 + k, out_col, wo, b_off + k * mul * wo,
                               u0]))
    dws_units = np.asarray([u for _, u in sorted(units, key=lambda cu: cu[0])],
                           np.int32).reshape(-1, 5)
    n_z = paths[:, 6] if len(paths) else np.zeros(1, np.int32)
    dims = np.asarray([
        paths[:, 1].max(initial=1), paths[:, 3].max(initial=1),
        paths[:, 4].max(initial=1), int(n_z.max()) + int(n_z.max()) % 2,
        max((s[4] for s in slots), default=8),
        max((s[1] for s in slots), default=1)], np.int32)
    return FusedTables(paths=paths,
                       nz=np.asarray(nz, np.int32).reshape(-1, 2),
                       fwd_units=tuple(fwd_units), dws_units=dws_units,
                       dims=dims)


def forward_plan(M: int, fwd_units, sms: int) -> int:
    """K5's cut of the components (an index into ``FWD_SPLITS``) for M
    elements: the coarsest whose element tiles times units still give two
    blocks per multiprocessor, else the finest."""
    tiles = -(-M // FWD_TILE)
    for k, units in enumerate(fwd_units):
        if tiles * len(units) >= 2 * sms:
            return k
    return len(fwd_units) - 1


def dws_plan(M: int, n_units: int, sms: int):
    """K5m's chunks of element tiles: enough for ``DWS_BLOCKS_PER_SM``
    blocks per multiprocessor, at most one per tile.  Returns ``(chunks,
    tiles per chunk)``."""
    tiles = max(1, -(-M // DWS_TILE))
    want = min(tiles, max(1, -(-DWS_BLOCKS_PER_SM * sms // max(n_units, 1))))
    per = -(-tiles // want)
    return -(-tiles // per), per


class Chunking(NamedTuple):
    """One cut of the adjoint sweep's paths into units of work.

    - ``chunks [C, ADJ_CHUNK_FIELDS]``: ``(x_off, d1, p0, p1, ws_col)``,
      consecutive paths ``[p0, p1)`` of one left irrep (columns ``x_off``,
      ``mul * d1`` of them), about equal in non-zeros and at most ``cap``;
      ``ws_col`` is -1 where the chunk is its irrep's only one (it stores
      d left itself), else the column of its partial in the workspace
      ``[M * ws_width]`` (partial at ``M * ws_col + m * mul * d1``);
    - ``sums [S, 4]``: ``(x_off, width, ws_col, n)`` for each left irrep
      that does not have exactly one chunk: its d left columns are the sum
      of its ``n`` partials at ``ws_col + k * width`` in chunk order, or
      zeros where ``n`` is 0 (no path reads the irrep).
    """
    chunks: np.ndarray
    sums: np.ndarray
    ws_width: int
    cap: int


class AdjointTables(NamedTuple):
    """Host tables of the backward's adjoint sweep (K5a ``d left``, K5b
    ``dbw``), built by ``adjoint_tables``.

    - ``paths [P, ADJ_PATH_FIELDS]``: the paths in left-irrep order, each
      ``(r0, d2, row_base, row_stride, d3, nz0, nz1, runs_a[MAX_D + 1],
      runs_b[MAX_D + 1])``: its bw rows ``r0 + m2``, its scratch rows
      ``row_base + m3 * row_stride``, its non-zeros ``[nz0, nz1)`` of
      ``nz`` and the bounds of their runs of equal m1 (``runs_a[i]:
      runs_a[i + 1]``, order 0) and of equal m2 (``runs_b``, order 1),
      padded with the last bound;
    - ``nz [2, nz, 2]`` int32: each path's non-zeros in two orders, order
      0 m1-major (then m3, m2), order 1 m2-major (then m3, m1), as
      ``row(first) | row(d2 + m3) << 16`` beside the coefficient's float32
      bits, ``row(i) = 4 * ADJ_ROW * i`` the byte offset of staged row i:
      the first operand is bw row m2 (order 0) or left row m1 (order 1),
      and a path's stage holds its d2 bw rows, then its d3 dS rows;
    - ``cuts``: a ``Chunking`` per ``ADJ_TARGET_CHUNKS``.
    """
    paths: np.ndarray
    nz: np.ndarray
    cuts: tuple


def balanced_cuts(weights, cap):
    """Cut ``weights`` (each at most ``cap``) into the fewest runs of
    consecutive items whose sums stay within ``cap``, as even as possible:
    the smallest cap at which cutting greedily still gives that few runs.
    Returns the boundaries, first 0 and last ``len(weights)``."""
    def greedy(c):
        cuts, run = [0], 0
        for i, w in enumerate(weights):
            if run + w > c and run > 0:
                cuts.append(i)
                run = 0
            run += w
        return cuts + [len(weights)]

    if not weights:
        return [0, 0]
    k = len(greedy(cap)) - 1
    lo, hi = max(max(weights), -(-sum(weights) // k)), cap
    while lo < hi:
        mid = (lo + hi) // 2
        if len(greedy(mid)) - 1 <= k:
            hi = mid
        else:
            lo = mid + 1
    return greedy(lo)


def chunking(sizes, left_paths, mul, target):
    """The ``Chunking`` of paths with ``sizes`` non-zeros (in left-irrep
    order) whose balance cap aims at ``target`` chunks; ``left_paths``:
    per left irrep ``(x_off, d1, first path, path count)``."""
    cap = max(int(max(sizes, default=1)), -(-int(sum(sizes)) // target))
    chunks, sums, ws_width = [], [], 0
    for x_off, d1, p0, n_p in left_paths:
        cuts = balanced_cuts(list(sizes[p0: p0 + n_p]), cap)
        n_chunks = len(cuts) - 1 if n_p else 0
        width = mul * d1
        if n_chunks != 1:
            sums.append([x_off, width, ws_width, n_chunks])
        for k in range(n_chunks):
            chunks.append([x_off, d1, p0 + cuts[k], p0 + cuts[k + 1],
                           -1 if n_chunks == 1 else ws_width + k * width])
        ws_width += width * n_chunks if n_chunks > 1 else 0
    return Chunking(
        chunks=np.asarray(chunks, np.int32).reshape(-1, ADJ_CHUNK_FIELDS),
        sums=np.asarray(sums, np.int32).reshape(-1, 4),
        ws_width=ws_width, cap=cap)


def adjoint_tables(path_rows, d3s, nz_codes, nz_values, left, mul):
    """The ``AdjointTables`` of a path table (``PairwiseTP.path_rows``, the
    output dims ``d3s`` of its paths, the non-zeros ``nz_codes`` /
    ``nz_values``) for the left irreps ``left`` [(x_off, d1)] at
    multiplicity ``mul``."""
    path_rows = np.asarray(path_rows, np.int64).reshape(-1, 9)
    paths, nz, left_paths = [], [[], []], []
    for x_off, d1 in left:
        qs = [q for q, row in enumerate(path_rows)
              if (row[0], row[1]) == (x_off, d1)]
        left_paths.append((x_off, d1, len(paths), len(qs)))
        for q in qs:
            _, _, r0, d2, row_base, row_stride, _, nz0, nz1 = path_rows[q]
            code = nz_codes[nz0:nz1]
            m1, m2, m3 = code & 0xff, (code >> 8) & 0xff, code >> 16
            first = len(nz[0])
            runs = []
            for order, (lead, mid, last, d) in enumerate(
                    ((m1, m3, m2, d1), (m2, m3, m1, d2))):
                idx = np.lexsort((last, mid, lead))
                bits = nz_values[nz0:nz1][idx].view(np.int32)
                offsets = 4 * ADJ_ROW * (last[idx] | (d2 + m3[idx]) << 16)
                nz[order] += [[int(c), int(b)] for c, b in
                              zip(offsets, bits)]
                bounds = first + np.searchsorted(lead[idx], np.arange(d + 1))
                runs += list(bounds) + [bounds[-1]] * (MAX_D - d)
            paths.append([r0, d2, row_base, row_stride, d3s[q], first,
                          len(nz[0]), *runs])
    paths = np.asarray(paths, np.int32).reshape(-1, ADJ_PATH_FIELDS)
    sizes = paths[:, 6] - paths[:, 5]
    return AdjointTables(
        paths=paths, nz=np.asarray(nz, np.int32).reshape(2, -1, 2),
        cuts=tuple(chunking(sizes, left_paths, mul, target)
                   for target in ADJ_TARGET_CHUNKS))


def adjoint_plan(M: int, cuts, mul: int, sms: int):
    """The chunking and the elements per block of the adjoint sweep: the
    most warps of 8, 4 and 2 (64 / ``mul`` elements each), then the
    coarsest cut, whose tiles times chunks still give two blocks per
    multiprocessor; else one warp on the finest cut.  Returns ``(index
    into cuts, tile)``."""
    per_warp = ADJ_ROW // mul
    for warps in (8, 4, 2):
        for k, cut in enumerate(cuts):
            if -(-M // (warps * per_warp)) * len(cut.chunks) >= 2 * sms:
                return k, warps * per_warp
    return len(cuts) - 1, per_warp


class PairwiseTP(torch.nn.Module):
    """Constant tables of one internal-weight all-uvu
    ``TensorProductExpansion`` with uniform left multiplicity, and K5."""

    #: kernel launches, over all instances (the main path's proof of use)
    launches = 0
    backward_launches = 0
    #: elements per launch (bounds ``bw``: 1.5 GiB at the full-width head;
    #: the backward holds three such buffers, bw, dS and dbw)
    CHUNK = 4096

    def __init__(self, tpe):
        super().__init__()
        tp, lin = tpe.tp, tpe.linear
        if not (tpe.internal_weight and not lin.bias_slots and all(
                ins.mode == "uvu" and ins.has_weight
                for ins in tp.instructions)):
            raise ValueError("PairwiseTP needs an internal-weight all-uvu "
                             "expansion with a bias-free mix")
        irreps_a, irreps_b, mid = tp.irreps_in1, tp.irreps_in2, tp.irreps_out
        muls = {mi.mul for mi in irreps_a}
        if len(muls) != 1:
            raise ValueError("PairwiseTP needs a uniform left multiplicity")
        self.mul = mul = muls.pop()
        self.irreps_a, self.irreps_b = irreps_a, irreps_b
        self.irreps_out = lin.irreps_out
        self.out_dim = lin.irreps_out.dim

        w_off, ofs = [], 0
        for ins in tp.instructions:
            w_off.append(ofs)
            ofs += int(np.prod(tp._weight_shape(ins)))

        # paths the mix reads, sorted by output irrep (l, -p), then TPE order
        lin_out = {}
        for io, mo in enumerate(lin.irreps_out):
            lin_out.setdefault(mo.ir, []).append(io)
        order = sorted(
            (i for i, ins in enumerate(tp.instructions)
             if mid[ins.i_out].ir in lin_out),
            key=lambda i: (mid[tp.instructions[i].i_out].ir.l,
                           -mid[tp.instructions[i].i_out].ir.p, i))
        paths = [tp.instructions[i] for i in order]
        self.n_paths = len(paths)

        # bw rows: (right slot, path in our order, component j)
        by_slot = {}
        for q, ins in enumerate(paths):
            by_slot.setdefault(ins.i_in2, []).append(q)
        r0_of, r = {}, 0
        self.slots = []          # (i2, mul2, d2, paths of the slot)
        for i2 in sorted(by_slot):
            mi2 = irreps_b[i2]
            qs = by_slot[i2]
            idx = np.stack([
                w_off[order[q]] + np.arange(mul * mi2.mul) for q in qs])
            self.register_buffer(f"widx{i2}", torch.tensor(idx),
                                 persistent=False)
            self.slots.append((i2, mi2.mul, mi2.ir.dim, len(qs)))
            for q in qs:
                r0_of[q] = r
                r += mi2.ir.dim
        self.R = r

        # output-irrep groups (contiguous in path order); scratch rows are
        # component-major inside a group: row(g, m3, m) = k0_g + m3 * n_g + m
        groups, p, k0 = [], 0, 0
        while p < len(paths):
            ir = mid[paths[p].i_out].ir
            q = p
            while q < len(paths) and mid[paths[q].i_out].ir == ir:
                q += 1
            groups.append((ir, k0, q - p, ir.dim, p))
            k0 += (q - p) * ir.dim
            p = q
        self.KM = k0 * mul

        in_starts = [s.start for s in irreps_a.slices()]
        table, d3s, nz_idx, nz_c = [], [], [], []
        for ir, k0, n_paths, d, p0 in groups:
            for m in range(n_paths):
                ins = paths[p0 + m]
                mi1, mi2 = irreps_a[ins.i_in1], irreps_b[ins.i_in2]
                cg = wigner_3j(mi1.ir.l, mi2.ir.l, ir.l) * ins.path_weight
                if not (np.abs(cg) > 1e-10).any(axis=(0, 1)).all():
                    raise ValueError(
                        "PairwiseTP: a CG path has a component without a "
                        "non-zero; the kernel would leave its scratch row "
                        "unwritten")
                nz0 = len(nz_idx)
                for m3 in range(ir.dim):
                    for m1 in range(mi1.ir.dim):
                        for m2 in range(mi2.ir.dim):
                            if abs(cg[m1, m2, m3]) > 1e-10:
                                nz_idx.append(m1 | (m2 << 8) | (m3 << 16))
                                nz_c.append(cg[m1, m2, m3])
                # field 6 (K1's radial-weight column) is unused here
                table.append([in_starts[ins.i_in1], mi1.ir.dim,
                              r0_of[p0 + m], mi2.ir.dim, k0 + m, n_paths, 0,
                              nz0, len(nz_idx)])
                d3s.append(ir.dim)

        self.max_d = max((max(row[1], row[3], d) for row, d in
                          zip(table, d3s)), default=0)

        # mix problems: one per (group, component, output slot); mix rows of
        # the simplified Linear input in (path, u) order
        simplified = mid.simplify()
        lin_in_index = {mi.ir: ii for ii, mi in enumerate(simplified)}
        slot_rank, counter = {}, {}
        for slot, mi in enumerate(mid):
            slot_rank[slot] = counter.get(mi.ir, 0)
            counter[mi.ir] = slot_rank[slot] + mi.mul
        out_starts = [s.start for s in lin.irreps_out.slices()]
        probs, self.mix_plan, b_off = [], [], 0
        slots = []   # per (group, output slot): K5's and K5m's units
        for g, (ir, k0, n_paths, d, p0) in enumerate(groups):
            rows = np.concatenate([
                slot_rank[paths[p0 + m].i_out] + np.arange(mul)
                for m in range(n_paths)])
            self.register_buffer(f"rows{g}", torch.tensor(rows),
                                 persistent=False)
            for io in lin_out[ir]:
                wo = lin.irreps_out[io].mul
                self.mix_plan.append((g, lin_in_index[ir], io))
                slots.append((p0, n_paths, d, out_starts[io], wo, b_off))
                for dd in range(d):
                    probs.append([(k0 + dd * n_paths) * mul, n_paths * mul,
                                  b_off, wo, out_starts[io] + dd, d])
                b_off += n_paths * mul * wo
        self.wsel_len = b_off
        self.n_probs = len(probs)
        self.nz_count = len(nz_idx)

        # host copies for the plain contract, device buffers for the kernel
        self.path_rows = np.asarray(table, np.int32).reshape(-1, 9)
        self.prob_rows = np.asarray(probs, np.int32).reshape(-1, 6)
        self.nz_codes = np.asarray(nz_idx, np.int64)
        self.nz_values = np.asarray(nz_c, np.float32)
        # columns of no slot (an output irrep no path reaches) are zeros
        covered = {s[3] + c for s in slots for c in range(s[4] * s[2])}
        self.out_covered = covered == set(range(self.out_dim))
        # K5 and K5m: see fused_tables; the backward's adjoint sweep (K5a,
        # K5b): see adjoint_tables
        self.fused = fused_tables(self.path_rows, d3s, self.nz_codes,
                                  self.nz_values, slots, mul)
        left = [(s.start, mi.ir.dim) for s, mi in
                zip(irreps_a.slices(), irreps_a)]
        self.adj = adjoint_tables(self.path_rows, d3s, self.nz_codes,
                                  self.nz_values, left, mul)
        for name, rows in (
                ("fused_paths", self.fused.paths),
                ("fused_nz", self.fused.nz),
                *((f"fwd_units{k}", units)
                  for k, units in enumerate(self.fused.fwd_units)),
                ("dws_units", self.fused.dws_units),
                ("adj_paths", self.adj.paths), ("adj_nz", self.adj.nz),
                *((f"adj_chunks{k}", cut.chunks)
                  for k, cut in enumerate(self.adj.cuts)),
                *((f"adj_sums{k}", cut.sums)
                  for k, cut in enumerate(self.adj.cuts))):
            self.register_buffer(name, torch.tensor(rows.reshape(-1)),
                                 persistent=False)
        self.register_buffer("nz_c", torch.tensor(self.nz_values),
                             persistent=False)

    def forward(self, tpe, left: torch.Tensor,
                right: torch.Tensor) -> torch.Tensor:
        """left [M, dim_a], right [M, dim_b] -> [M, out_dim], with the
        parameters of ``tpe`` (an expansion of this instance's
        structure)."""
        if left.device.type == "cpu":
            return tpe.expand(left, right)
        return self.launch(tpe, left, right)

    def launch(self, tpe, left, right):
        """The kernel path: the flat mix matrices and, per chunk of
        elements, the weighted right operand in plain PyTorch, then K5,
        through ``PairwiseTPFunction`` (K5m, K5a, K5b in the backward) when
        a gradient is wanted."""
        weight = tpe.tp.weight
        wsel = self.flat_wsel(tpe.linear)
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (left, right, weight, wsel))
        outs = []
        for m0 in range(0, left.shape[0], self.CHUNK):
            a = left[m0: m0 + self.CHUNK].contiguous()
            bw = self.weighted_right(weight, right[m0: m0 + self.CHUNK])
            outs.append(PairwiseTPFunction.apply(self, a, bw, wsel)
                        if needs_grad else launch_forward(self, a, bw, wsel))
        if not outs:
            return left.new_zeros((0, self.out_dim))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def weighted_right(self, weight: torch.Tensor,
                       right: torch.Tensor) -> torch.Tensor:
        """Stage 1: ``bw [M, R, mul]``, rows (right slot, path, j)."""
        M, mul = right.shape[0], self.mul
        slices = self.irreps_b.slices()
        pieces = []
        for i2, mul2, d2, n in self.slots:
            W = weight[getattr(self, f"widx{i2}")].reshape(n, mul, mul2)
            b = right[:, slices[i2]].reshape(M, mul2, d2)
            pieces.append(torch.einsum("mvj,puv->mpju", b, W).reshape(
                M, n * d2, mul))
        return torch.cat(pieces, dim=1).contiguous()

    def flat_wsel(self, linear) -> torch.Tensor:
        """The mix matrices of every problem (alphas folded in), flattened
        in ``mix_plan`` order."""
        return torch.cat([
            linear.weight(ii, io)[getattr(self, f"rows{g}")].reshape(-1)
            for g, ii, io in self.mix_plan]).contiguous()

    def plain_forward(self, a, bw, wsel):
        """Plain PyTorch version of K5's contract on ``(left, bw, wsel)``:
        the CG contraction path by path over the kernel's own non-zero
        tables into the scratch rows, then the mix problems."""
        M, mul = a.shape[0], self.mul
        S = a.new_zeros((M, self.KM // mul, mul))
        c_all = self.nz_c.to(a.device)
        for x_off, d1, r0, _d2, row_base, row_stride, _, nz0, nz1 in \
                self.path_rows:
            code = torch.as_tensor(self.nz_codes[nz0:nz1], device=a.device)
            m1, m2, m3 = code & 0xff, (code >> 8) & 0xff, code >> 16
            av = a[:, x_off: x_off + mul * d1].reshape(M, mul, d1)[:, :, m1]
            bv = bw[:, r0 + m2, :]                      # [M, nnz, mul]
            term = av.transpose(1, 2) * bv * c_all[nz0:nz1, None]
            S.index_add_(1, row_base + m3 * row_stride, term)
        return mix_rows(S.reshape(M, self.KM), wsel, self.prob_rows,
                        self.out_dim)

    def plain_backward(self, a, bw, wsel, gout, wanted=(True, True, True)):
        """Plain PyTorch version of the backward kernels' contract:
        ``(d left, dbw, dwsel)`` for the cotangent ``gout``, by autograd of
        ``plain_forward``; None where ``wanted`` is false."""
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip((a, bw, wsel), wanted)]
            grads = iter(torch.autograd.grad(
                self.plain_forward(*ins),
                [t for t, need in zip(ins, wanted) if need], gout))
            return tuple(next(grads) if need else None for need in wanted)


class PairwiseTPFunction(torch.autograd.Function):
    """K5 forward; K5m, K5a and K5b backward, on one chunk of elements.
    Differentiable inputs: ``left``, the weighted right operand ``bw`` and
    the flat mix matrices.  (``needs_input_grad`` does not see grad mode,
    so ``PairwiseTP.launch`` calls this under grad mode only.)"""

    @staticmethod
    def forward(ctx, tpk, a, bw, wsel):
        ctx.save_for_backward(a, bw, wsel)
        ctx.tpk = tpk
        return launch_forward(tpk, a, bw, wsel)

    @staticmethod
    def backward(ctx, gout):
        return (None, *launch_backward(ctx.tpk, *ctx.saved_tensors,
                                       gout.contiguous(),
                                       ctx.needs_input_grad[1:]))


def _check_inputs(tpk, a, bw, wsel):
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"PairwiseTP kernel needs CUDA tensors, got {dev}")
    M = a.shape[0]
    check_tensor(a, "left", (M, tpk.irreps_a.dim), torch.float32, dev)
    check_tensor(bw, "bw", (M, tpk.R, tpk.mul), torch.float32, dev)
    check_tensor(wsel, "wsel", (tpk.wsel_len,), torch.float32, dev)
    if tpk.max_d > MAX_D:
        raise ValueError(f"the PairwiseTP kernels take irreps up to l = 4, "
                         f"got d = {tpk.max_d}")
    if tpk.mul % 4:
        raise ValueError(f"the PairwiseTP kernels take multiplicities that "
                         f"are multiples of 4, got {tpk.mul}")
    if any(wo % 8 or wo > MAX_WO for wo in tpk.fused.fwd_units[0][:, 6]):
        raise ValueError(f"the PairwiseTP kernels take output "
                         f"multiplicities that are multiples of 8 up to "
                         f"{MAX_WO}")
    if tpk.fused_paths.device != dev:
        raise ValueError("PairwiseTP tables are not on the input's device")
    _check_aligned(left=a, bw=bw, wsel=wsel)
    return dev, M


def _check_aligned(**tensors):
    """The fused kernels stage rows by 16-byte copies: every operand must
    start on 16 bytes."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"PairwiseTP kernel needs {name} to start on "
                             f"16 bytes")


def launch_forward(tpk, a, bw, wsel):
    """Launch K5 on one chunk: ``out [M, out_dim]``."""
    dev, M = _check_inputs(tpk, a, bw, wsel)
    k = forward_plan(M, tpk.fused.fwd_units, _multiprocessors(dev))
    new = torch.empty if tpk.out_covered else torch.zeros
    out = new((M, tpk.out_dim), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pairwise_tp_fwd(
            a.data_ptr(), M, tpk.irreps_a.dim,
            bw.data_ptr(), tpk.R, tpk.mul,
            tpk.fused_paths.data_ptr(), tpk.fused_nz.data_ptr(),
            tpk.fused.dims.ctypes.data,
            getattr(tpk, f"fwd_units{k}").data_ptr(),
            len(tpk.fused.fwd_units[k]),
            wsel.data_ptr(), out.data_ptr(), tpk.out_dim, stream,
        )
    check(err, "pairwise_tp_fwd")
    PairwiseTP.launches += 1
    return out


def launch_backward(tpk, a, bw, wsel, gout, wanted=(True, True, True)):
    """Launch the backward on one chunk: ``(d left [M, dim_a] (K5a),
    dbw [M, R, mul] (K5b), dwsel (K5m))``, all float32, from the forward's
    inputs and ``gout [M, out_dim]``; None where ``wanted`` is false (that
    kernel is not launched)."""
    dev, M = _check_inputs(tpk, a, bw, wsel)
    check_tensor(gout, "gout", (M, tpk.out_dim), torch.float32, dev)
    _check_aligned(gout=gout)
    if tpk.mul < 4 or ADJ_ROW % tpk.mul:
        raise ValueError(f"the PairwiseTP backward takes multiplicities "
                         f"that divide {ADJ_ROW}, from 4, got {tpk.mul}")

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    want_a, want_b, want_m = wanted
    da = empty(*a.shape) if want_a else None
    dbw = empty(*bw.shape) if want_b else None
    dwsel = empty(tpk.wsel_len) if want_m else None
    # work: the unmixed scratch's cotangent, the partial d left of the
    # irreps cut into several chunks, K5m's partial dwsel per chunk
    dS = empty(M, tpk.KM) if want_a or want_b else None
    sms = _multiprocessors(dev)
    k, tile = adjoint_plan(M, tpk.adj.cuts, tpk.mul, sms)
    cut = tpk.adj.cuts[k]
    da_ws = empty(M * cut.ws_width) if want_a else None
    if da_ws is not None and da_ws.numel() >= 2 ** 31:
        raise ValueError(f"the d left workspace of {da_ws.numel()} floats "
                         f"is too large")
    chunks, per = dws_plan(M, len(tpk.fused.dws_units), sms)
    dws_ws = empty(chunks * tpk.wsel_len) if want_m and chunks > 1 else None
    ws = row_mix.workspace(dev, gout.numel())   # see row_mix.workspace

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pairwise_tp_bwd(
            a.data_ptr(), M, tpk.irreps_a.dim,
            bw.data_ptr(), tpk.R, tpk.n_paths,
            tpk.fused_paths.data_ptr(), tpk.fused_nz.data_ptr(),
            tpk.fused.dims.ctypes.data,
            tpk.dws_units.data_ptr(), len(tpk.fused.dws_units), per,
            tpk.adj_paths.data_ptr(), tpk.adj.paths.ctypes.data,
            tpk.adj_nz.data_ptr(), len(tpk.adj.nz[0]),
            getattr(tpk, f"adj_chunks{k}").data_ptr(), cut.chunks.ctypes.data,
            len(cut.chunks), getattr(tpk, f"adj_sums{k}").data_ptr(),
            len(cut.sums), tile,
            tpk.KM, tpk.mul,
            wsel.data_ptr(), tpk.wsel_len,
            tpk.prob_rows.ctypes.data, tpk.n_probs,
            gout.data_ptr(), tpk.out_dim,
            ptr(dS), ptr(da), ptr(dbw), ptr(dwsel),
            int(want_m) | int(want_a) << 1 | int(want_b) << 2,
            ws.data_ptr(), ws.numel(), ptr(da_ws),
            0 if da_ws is None else da_ws.numel(), ptr(dws_ws), stream,
        )
    check(err, "pairwise_tp_bwd")
    PairwiseTP.backward_launches += 1
    return da, dbw, dwsel
