"""K1 and K2: the whole-convolution forward — radial MLP, gather, CG tensor
product times radial weight, scatter, and mix — and its VJP, as one wrapper
around ``csrc/full_conv.cu`` and ``csrc/full_conv_bwd.cu``.

The kernels replace the TPU kernels ``PallasFullConv._full_fwd_kernel`` and
``_full_bwd_kernel`` (``equivariant_nn_zoo_tpu/ops/pallas/fused_conv.py:926``
and ``:1051``) and keep their contract on the plain padded batch: global
``edge_index``, padded edges pointing at the dummy node with masked (zero)
``edge_radial``.  The TPU layout (one-hot window gathers, ``(u, e)`` lanes,
K8 row padding, run flush flags) is not carried over.

For tensors on the CPU the wrapper runs the plain version
(``FullyConnectedNet`` then ``FusedUVUConv``) and autograd differentiates
it.  For CUDA tensors it builds the kernels' flat weights in plain PyTorch
(scaled MLP weights, mix matrices with their alphas and ``pre_scale``) and
goes through ``FullConvFunction``, whose forward launches K1 and whose
backward launches K2, or raises; autograd carries the kernels' weight
gradients back to ``fc.w*`` and ``tp.linear.*``.  When ``sh`` needs a
gradient (forces through positions) K2 also returns the sh cotangent (the
TPU kernel's ``compute_dsh``); when it does not, K2 is launched without it,
so a training step pays nothing for it.  ``plain_forward`` and
``plain_backward`` are the plain PyTorch versions of the two kernels'
contracts on the same flat inputs, for the tests and the on-card checks.

With ``compute_dtype="bfloat16"`` the conv computes what the TPU kernels
compute at bfloat16 (``fused_conv.py:813-878, 926-1049`` and the
backward's own rounding points, ``:1051-1331``): the operands x, sh, the
scaled MLP weights and the mix matrices are bfloat16 tensors, every product
is summed in float32 and rounded where the TPU kernel rounds it, the
output is bfloat16, and K2's gradients come out in the dtypes of their
inputs (``f_bwd``, ``:2421-2433``).  Its backward is that contract, not
autograd of the rounded forward, so on the CPU too the layer goes through
``FullConvFunction``, with the plain contracts ``plain_forward_bf16`` and
``plain_backward_bf16`` in place of the launches.  The sh cotangent (K2's
dsh mode) has no bfloat16 variant yet and is refused.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..compute_dtype import compute_dtype_of
from ..fused_tp import FusedUVUConv
from ..gate import ScaledActivation, shifted_softplus
from ..segment import segment_sum
from ..wigner import wigner_3j
from . import edge_order, row_mix
from .build import KernelSwitch, check, check_tensor, load_library

MAX_RADIAL, MAX_HIDDEN, MAX_SH, MAX_D = 64, 64, 16, 9
# the walk (csrc/edge_walk.cuh): paths per block, the widest irrep K1
# takes on either side (l = 7), fields per path of the walk table
WALK_GROUPS, WALK_ROWS, WALK_FIELDS = 4, 16, 10
WALK_BLOCKS = 2048   # blocks the walk's grid aims at (walk_items)
# the bfloat16 walks' unit header (csrc/bf16_walk.cuh, kUnitFields): x_off,
# d1, MB, paths, columns N, n-tiles NT, forward k-steps KS, ints of the
# region, first tile, tiles, and the offsets of the columns, slots, forward
# and backward maps in the region
BF16_UNIT_FIELDS = 16
BF16_MAX_NT = 12     # n-tiles of 8 columns a unit (the kernels' kNt)
BF16 = torch.bfloat16
PLAIN_EDGES = 2048   # edges per chunk of the bfloat16 plain contracts


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (nearest even), kept in float32."""
    return t.to(BF16).float()


def _mask_rows(rows):
    """Map rows of tile indices (-1: no tile; the tiles of a row
    consecutive) as (mask, base) pairs, flattened."""
    out = []
    for row in rows:
        live = [n for n, ti in enumerate(row) if ti >= 0]
        out += [sum(1 << n for n in live), row[live[0]] if live else 0]
    return out


def mix_rows(scratch, wsel, prob_rows, out_dim: int) -> torch.Tensor:
    """The mix stage of the conv and pairwise kernels in plain PyTorch: per
    problem row ``(a_col, kdim, b_off, wo, c_off, c_stride)``,
    ``out[:, c_off + w * c_stride] = scratch[:, a_col: a_col + kdim] @
    wsel[b_off: b_off + kdim * wo].reshape(kdim, wo)``; columns of no
    problem are zero."""
    out = scratch.new_zeros((scratch.shape[0], out_dim))
    for a_col, kdim, b_off, wo, c_off, c_stride in prob_rows:
        blk = scratch[:, a_col: a_col + kdim] @ wsel[
            b_off: b_off + kdim * wo].reshape(kdim, wo)
        cols = c_off + c_stride * torch.arange(wo, device=scratch.device)
        out = out.index_add(1, cols, blk)
    return out


class ConvTables(KernelSwitch, torch.nn.Module):
    """Constant tables of one uvu ``TensorProductExpansion`` for the conv
    kernels (K1, K2 and the external-weight K4 family): the CG paths with
    their host-built wigner_3j non-zeros, and the mix problems; at
    bfloat16 also the plain contracts' index tables and the bfloat16
    walks' tiles.  Parameters are passed at call time, so this module
    holds buffers only."""

    def __init__(self, tpe, compute_dtype: str = "float32"):
        super().__init__()
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.fused = FusedUVUConv(tpe)
        fused = self.fused
        mul = fused.mul
        in_starts = [s.start for s in fused.irreps_in.slices()]
        j_starts = np.cumsum([0] + [mi.ir.dim for mi in fused.irreps_sh])

        # per-path table (our path order) and its sorted CG non-zeros.
        # Scratch rows are component-major inside each output-irrep group:
        # row(g, m3, m) = k0_g + m3 * n_paths_g + m
        paths, nz_idx, nz_c, cgs, d3s = [], [], [], [], []
        rows_complete = True
        for ir, k0, n_paths, d, p0 in fused.groups:
            for m in range(n_paths):
                ins = fused.paths[p0 + m]
                mi1 = fused.irreps_in[ins.i_in1]
                mi2 = fused.irreps_sh[ins.i_in2]
                cg = wigner_3j(mi1.ir.l, mi2.ir.l, ir.l) * ins.path_weight
                nz0 = len(nz_idx)
                rows_complete &= bool(
                    (np.abs(cg) > 1e-10).any(axis=(0, 1)).all())
                for m3 in range(ir.dim):
                    for m1 in range(mi1.ir.dim):
                        for m2 in range(mi2.ir.dim):
                            if abs(cg[m1, m2, m3]) > 1e-10:
                                nz_idx.append(m1 | (m2 << 8) | (m3 << 16))
                                nz_c.append(cg[m1, m2, m3])
                paths.append([
                    in_starts[ins.i_in1], mi1.ir.dim,
                    int(j_starts[ins.i_in2]), mi2.ir.dim,
                    k0 + m, n_paths, fused.path_w_offset[p0 + m],
                    nz0, len(nz_idx),
                ])
                cgs.append(cg)
                d3s.append(ir.dim)
        self.n_paths = len(paths)
        self.KM = fused.K_dim * mul
        # every (path, component) has a CG non-zero: a kernel that stores
        # each scratch row as it closes a component then writes all of them
        self.rows_complete = rows_complete

        # mix problems: one per (group, component, output slot); per
        # (group, slot) (p0, n_paths, d, out_col, wo, b_off)
        linear_out = fused.irreps_out
        out_starts = [s.start for s in linear_out.slices()]
        probs, plan, slots, b_off = [], [], [], 0
        for g, (ir, k0, n_paths, d, p0) in enumerate(fused.groups):
            for io in fused.lin_out.get(ir, []):
                wo = linear_out[io].mul
                plan.append((g, io))
                slots.append((p0, n_paths, d, out_starts[io], wo, b_off))
                for dd in range(d):
                    probs.append([(k0 + dd * n_paths) * mul, n_paths * mul,
                                  b_off, wo, out_starts[io] + dd, d])
                b_off += n_paths * mul * wo
        self.wsel_len = b_off
        self.mix_plan = plan
        self.slots = slots
        self.n_probs = len(probs)
        # the kernels' host code builds its products from the problem table
        self.prob_rows = np.asarray(probs, np.int32).reshape(-1, 6)
        self.max_d1 = max((p[1] for p in paths), default=0)
        self.max_d2 = max((p[3] for p in paths), default=0)
        self.out_dim = linear_out.dim

        def int_buffer(name, rows):
            self.register_buffer(
                name, torch.tensor(np.asarray(rows, np.int32).reshape(-1)),
                persistent=False)

        int_buffer("path_table", paths)
        int_buffer("nz_idx", nz_idx)
        self.register_buffer(
            "nz_c", torch.tensor(np.asarray(nz_c, np.float32)),
            persistent=False)
        self._walk_tables(paths, cgs, d3s, mul, int_buffer)
        if self.bf16:
            self._bf16_tables()

    def _walk_tables(self, paths, cgs, d3s, mul, int_buffer):
        """The node-major walk's tables (K1, K2 and the K4 family,
        ``csrc/edge_walk.cuh``): the paths sorted by left irrep, each with
        its sh irrep's width d2 last; their CG non-zeros sorted by
        (m3, m1, m2), the value and the sh index m2 of each; per path the
        bounds of each cell (m3, m1), d3 * d1 + 1 entries of ``walk_cells``;
        chunks of at most ``WALK_GROUPS`` paths of one left irrep (a block's
        paths), and for the K4 family's source-major walk, which does not
        stage x, chunks of at most as many consecutive paths of left irreps
        of one width (``walk_src_chunks``: fewer idle path slots); per left
        irrep the columns of its paths in K2's path-major dx rows."""
        order = sorted(range(len(paths)), key=lambda p: paths[p][0])
        rows, nz, cells, chunks, irreps = [], [], [], [], []
        dcol = 0
        for p in order:
            x_off, d1, j0, d2, row_base, row_stride, wcol = paths[p][:7]
            cg, d3 = cgs[p], d3s[p]
            rows.append([x_off, d1, j0, d3, row_base, row_stride, wcol, dcol,
                         len(cells), d2])
            for m3 in range(d3):
                for m1 in range(d1):
                    cells.append(len(nz))
                    nz += [(cg[m1, m2, m3], m2) for m2 in range(cg.shape[1])
                           if abs(cg[m1, m2, m3]) > 1e-10]
            cells.append(len(nz))
            if not irreps or irreps[-1][0] != x_off:
                irreps.append([x_off, d1, dcol, 0])
            irreps[-1][3] += 1
            dcol += d1 * mul
        def cut(runs):
            """Chunks of at most WALK_GROUPS paths, as even as may be, of
            each run of consecutive paths."""
            out, p0 = [], 0
            for n in runs:
                k = -(-n // WALK_GROUPS)
                for i in range(k):
                    size = n // k + (i < n % k)
                    out.append([p0, size])
                    p0 += size
            return out

        chunks = cut([n for *_, n in irreps])
        widths = []          # runs of consecutive left irreps of one width
        for _, d1, _, n in irreps:
            if widths and widths[-1][0] == d1:
                widths[-1][1] += n
            else:
                widths.append([d1, n])
        src_chunks = cut([n for _, n in widths])
        int_buffer("walk_table", rows)
        int_buffer("walk_cells", cells)
        int_buffer("walk_chunks", chunks)
        int_buffer("walk_src_chunks", src_chunks)
        int_buffer("walk_irreps", irreps)
        a = np.zeros((max(len(nz), 1), 2), np.float32)
        if nz:
            a[:len(nz), 0] = [c for c, _ in nz]
            a[:len(nz), 1] = np.asarray([m2 for _, m2 in nz],
                                        np.int32).view(np.float32)
        self.register_buffer("walk_nz", torch.tensor(a), persistent=False)
        self.n_chunks = len(chunks)
        self.n_src_chunks = len(src_chunks)
        self.n_walk_irreps = len(irreps)
        self.KMd = dcol               # K2's path-major dx row width
        # the most non-zeros of a chunk of either table (the kernels stage
        # them)
        self.max_chunk_nz = max(
            [cells[rows[c0 + n - 1][8] + rows[c0 + n - 1][3] * rows[c0][1]]
             - cells[rows[c0][8]] for c0, n in chunks + src_chunks] + [0])
        self.max_d3 = max(d3s, default=0)
        # every input column is read by some path: K2's dx needs no zeros
        covered = np.zeros(self.fused.irreps_in.dim, bool)
        for x_off, d1, *_ in irreps:
            covered[x_off: x_off + d1 * mul] = True
        self.dx_covered = bool(covered.all())

    def _bf16_tables(self):
        """What the bfloat16 plain contracts index by: per row k of the
        expansion's CG products (path order, ``k_start(p) + m3``) its
        scratch row (component-major inside the output group) and its
        path's radial-weight block; the CG operator rounded."""
        fused = self.fused
        srow, widx = [], []
        for g, (ir, k0, n_paths, d, p0) in enumerate(fused.groups):
            w = getattr(fused, f"widx{g}").tolist()
            for m in range(n_paths):
                for m3 in range(d):
                    srow.append(k0 + m3 * n_paths + m)
                    widx.append(w[m])
        self.register_buffer("bf16_srow", torch.tensor(srow),
                             persistent=False)
        self.register_buffer("bf16_widx", torch.tensor(widx),
                             persistent=False)
        J, K, I = fused.J_dim, fused.K_dim, fused.I_dim
        self.register_buffer(
            "bf16_C", round_bf16(fused.C_flat.reshape(J, K, I)),
            persistent=False)
        self._bf16_walk_tables(srow)

    def _bf16_walk_tables(self, srow):
        """The tables of the bfloat16 walks (``csrc/bf16_walk.cuh``): one
        unit per left irrep L (a block's work), its (path, m3) columns
        (paths sorted by sh irrep, then in walk order; m3 consecutive)
        padded to a multiple of 16, and the rounded CG coefficients cut
        into the B operands of ``mma.sync m16n8k16`` tiles, each stored as
        the 32 lanes' fragments (lane (g, t) = divmod(lane, 4) holds B[2t,
        g] | B[2t + 1, g] << 16, then B[2t + 8, g] | B[2t + 9, g] << 16, as
        bfloat16 bits):

        - the forward tiles ``mid = O C`` (K1 and K2): k-step ks = jp * MB
          + mb holds the outer-product columns (j, m1), j = 2 jp + c // 8,
          m1 = 8 mb + c % 8 for c < 16 (MB = ceil(d1 / 8)); n-tile nt the
          columns 8 nt .. 8 nt + 7;
        - the backward tiles ``douter = dmid C^T`` (K2): k-step kk holds
          the columns 16 kk .. 16 kk + 15, n-tile (j, mb) the m1 = 8 mb ..
          8 mb + 7 of one j.

        Only tiles with a non-zero coefficient are kept, in the order of
        the maps' rows (forward, then backward); a map row is (mask, base):
        its tiles are base + the set bits of mask below an n-tile (forward:
        a row per k-step over the NT n-tiles; backward: a row per (j, mb)
        over the NT / 2 k-steps).  ``bf16_walk_tab`` holds,
        per unit, the offset of its region, then the regions: a header
        (``BF16_UNIT_FIELDS``), per column its scratch row (-1 past N) and
        its path slot, per slot its W_out column, first column and d3, the
        forward map's KS rows and the backward map's J * MB rows.
        ``bf16_walk_dims`` (host): units, and the most n-tiles, forward
        k-steps, paths, x columns (mul * d1), ints of a region and tiles of
        a unit."""
        mul, J = self.fused.mul, self.fused.J_dim
        C = self.bf16_C.numpy()
        rows = self.walk_table.numpy().reshape(-1, WALK_FIELDS)
        k_of = {int(r): k for k, r in enumerate(srow)}
        bits = lambda v: torch.tensor(np.asarray(v, np.float32)).to(
            BF16).view(torch.int16).numpy().astype(np.int64) & 0xFFFF
        regions, tiles, dims = [], [], np.zeros(7, np.int64)
        p0 = 0
        for x_off, d1, _, n_paths in self.walk_irreps.numpy().reshape(-1, 4):
            ps = sorted(range(p0, p0 + n_paths), key=lambda p: (rows[p][2], p))
            p0 += n_paths
            i0, MB = x_off // mul, -(-d1 // 8)
            cols, slots = [], []
            for s, p in enumerate(ps):
                j0, d3, rb, rs, wcol = rows[p][[2, 3, 4, 5, 6]]
                slots += [wcol, len(cols) // 2, d3]
                for m3 in range(d3):
                    cols += [rb + m3 * rs, s]
            N = len(cols) // 2
            NT = -(-N // 16) * 2
            cols += [-1, 0] * (8 * NT - N)
            # the dense operand [(j, m1), column] of the forward product
            dense = np.zeros((J, 8 * MB, 8 * NT))
            for s, p in enumerate(ps):
                j0, d3, d2, c0 = rows[p][2], rows[p][3], rows[p][9], \
                    slots[3 * s + 1]
                k0 = k_of[int(rows[p][4])]
                dense[j0: j0 + d2, :d1, c0: c0 + d3] = C[
                    j0: j0 + d2, k0: k0 + d3, i0: i0 + d1].transpose(0, 2, 1)
            JP = -(-J // 2)
            dense = np.concatenate(
                [dense, np.zeros((2 * JP - J,) + dense.shape[1:])])
            unit_tiles = []

            def keep(b):                 # b [16, 8]: its tile index or -1
                if not b.any():
                    return -1
                g, t = np.divmod(np.arange(32), 4)
                pairs = [(2 * t, g), (2 * t + 8, g)]
                frag = np.stack([bits(b[k, n]) | bits(b[k + 1, n]) << 16
                                 for k, n in pairs], 1)
                unit_tiles.append(frag.astype(np.uint32).view(np.int32))
                return len(unit_tiles) - 1

            KS = JP * MB
            fmap = [[keep(dense[2 * jp: 2 * jp + 2, 8 * mb: 8 * mb + 8,
                                8 * nt: 8 * nt + 8].reshape(16, 8))
                     for nt in range(NT)]
                    for jp in range(JP) for mb in range(MB)]
            bmap = [[keep(dense[j, 8 * mb: 8 * mb + 8,
                                16 * kk: 16 * kk + 16].T)
                     for kk in range(NT // 2)]
                    for j in range(J) for mb in range(MB)]
            fmap, bmap = _mask_rows(fmap), _mask_rows(bmap)
            col0 = BF16_UNIT_FIELDS
            slot0 = col0 + len(cols)
            fmap0 = -(-(slot0 + len(slots)) // 2) * 2   # the rows: int2
            bmap0 = fmap0 + len(fmap)
            ints = -(-(bmap0 + len(bmap)) // 4) * 4
            head = [x_off, d1, MB, n_paths, N, NT, KS, ints,
                    len(tiles), len(unit_tiles), col0, slot0, fmap0, bmap0]
            region = np.zeros(ints, np.int64)
            region[:len(head)] = head
            region[col0: col0 + len(cols)] = cols
            region[slot0: slot0 + len(slots)] = slots
            region[fmap0: bmap0] = fmap
            region[bmap0: bmap0 + len(bmap)] = bmap
            regions.append(region)
            tiles += unit_tiles
            dims[1:7] = np.maximum(dims[1:7], [NT, KS, n_paths, mul * d1,
                                               ints, len(unit_tiles)])
        dims[0] = len(regions)
        lead = -(-len(regions) // 4) * 4
        offsets = np.cumsum([lead] + [len(r) for r in regions])[:-1]
        tab = np.concatenate([np.pad(offsets, (0, lead - len(regions)))]
                             + regions).astype(np.int32)
        self.register_buffer("bf16_walk_tab", torch.tensor(tab),
                             persistent=False)
        self.register_buffer(
            "bf16_walk_tiles",
            torch.tensor(np.stack(tiles).reshape(-1, 64) if tiles
                         else np.zeros((1, 64), np.int32)),
            persistent=False)
        self.bf16_walk_dims = dims.astype(np.int32)

    @property
    def bf16(self) -> bool:
        return self.compute_dtype == BF16

    def _x_table(self, x):
        """x [N, in_dim] -> [N, I, mul] (component-major per irrep)."""
        mul, blocks, ofs = self.fused.mul, [], 0
        for mi in self.fused.irreps_in:
            d = mi.ir.dim
            blocks.append(x[:, ofs: ofs + mul * d].reshape(-1, mul, d)
                          .transpose(1, 2))
            ofs += mul * d
        return torch.cat(blocks, dim=1)

    def _x_columns(self, t):
        """[N, I, mul] -> x's columns [N, in_dim]: the inverse of
        ``_x_table``."""
        cols, i0 = [], 0
        for mi in self.fused.irreps_in:
            d = mi.ir.dim
            cols.append(t[:, i0: i0 + d].transpose(1, 2).reshape(
                t.shape[0], -1))
            i0 += d
        return torch.cat(cols, dim=1)

    def _mid_bf16(self, xT, sh, src):
        """The CG products of some edges as ``_mid2_of`` rounds them
        (``fused_conv.py:848-878``): the outer products sh_j x_i rounded,
        contracted with the rounded CG in float32, rounded: ``[E, K,
        mul]``, rows in path order."""
        outer = round_bf16(sh[:, :, None, None] * xT[src][:, None])
        return round_bf16(torch.einsum("jki,ejiu->eku", self.bf16_C, outer))

    def plain_core(self, x, sh, w, wsel, edge_src, edge_dst, num_nodes):
        """The conv core on per-edge radial weights ``w [E, P * mul]``
        (columns in the expansion's instruction order) and the flat mix
        matrices: ``(out [N, out_dim], scratch [N, K * mul])``, the scratch
        holding the unmixed node sums in the kernels' row order
        (component-major inside each output-irrep group).  Plain PyTorch,
        differentiable to any order."""
        fused, mul, E = self.fused, self.fused.mul, sh.shape[0]
        w3 = w.reshape(E, -1, mul)                        # [E, P, mul]
        mid = fused.edge_mid(x, edge_src, sh)             # [E, K, mul]
        rows = []
        for g, (ir, k0, n_paths, d, p0) in enumerate(fused.groups):
            block = mid[:, k0: k0 + n_paths * d].reshape(E, n_paths, d, mul)
            block = block * w3[:, getattr(fused, f"widx{g}")][:, :, None]
            rows.append(block.transpose(1, 2).reshape(E, -1))
        scratch = segment_sum(torch.cat(rows, 1), edge_dst, int(num_nodes))
        return mix_rows(scratch, wsel, self.prob_rows, self.out_dim), scratch

    def flat_wsel(self, linear, pre_scale=None) -> torch.Tensor:
        """The mix matrices of every problem (alphas and ``pre_scale``
        folded in), flattened in ``mix_plan`` order.  At bfloat16 as the
        TPU kernel's caller rounds them (``fused_conv.py:2241-2242,
        2476-2478``): rounded, then multiplied by ``pre_scale`` rounded to
        bfloat16, and rounded again."""
        if self.bf16:
            wsel = torch.cat([
                self.fused.mix_weight(linear, g, io).to(BF16).reshape(-1)
                for g, io in self.mix_plan])
            if pre_scale is not None:
                # pre_scale rounded on the host (no copy to the device, so
                # a CUDA graph can record it); bfloat16 times an exact
                # bfloat16 value rounds as JAX's weakly typed product does
                wsel = wsel * float(torch.tensor(float(pre_scale)).to(BF16))
            return wsel.contiguous()
        pre = 1.0 if pre_scale is None else float(pre_scale)
        return torch.cat([
            (self.fused.mix_weight(linear, g, io) * pre).reshape(-1)
            for g, io in self.mix_plan
        ]).contiguous()


class FullConv(ConvTables):
    """K1 and K2 for one ``FactorizedConvolution``: the radial
    ``FullyConnectedNet`` and the expansion's mix ``Linear`` are passed at
    call time."""

    #: kernel launches, over all instances (the main path's proof of use)
    launches = 0
    backward_launches = 0
    dsh_launches = 0     # of the backward launches, those with the sh
                         # cotangent
    bf16_launches = 0    # the bfloat16 variants' launches, K1 and K2
    bf16_backward_launches = 0

    def __init__(self, tpe, fc, compute_dtype: str = "float32"):
        super().__init__(tpe, compute_dtype)
        act = fc.act
        if not (isinstance(act, ScaledActivation)
                and act.fn is shifted_softplus):
            raise ValueError("the conv kernel implements the normalized "
                             "shifted-softplus radial MLP only")
        self.act_cst = float(act.cst)
        self.fc_dims = list(fc.dims)

    def forward(self, fc, linear, x: torch.Tensor, edge_radial: torch.Tensor,
                sh: torch.Tensor, edge_src: torch.Tensor,
                edge_dst: torch.Tensor, num_nodes: int,
                pre_scale: Optional[float] = None) -> torch.Tensor:
        """x [N, in_dim] (already linear_1'd), masked edge_radial [E, R],
        sh [E, J], edge_src / edge_dst [E] -> [N, out_dim]."""
        if self.uses_kernel(x):
            return self.launch(fc, linear, x, edge_radial, sh, edge_src,
                               edge_dst, num_nodes, pre_scale)
        return self.plain(fc, linear, x, edge_radial, sh, edge_src,
                          edge_dst, num_nodes, pre_scale)

    def plain(self, fc, linear, x, edge_radial, sh, edge_src, edge_dst,
              num_nodes, pre_scale=None):
        """Plain PyTorch version of the kernel (the same math, dense; at
        bfloat16 the plain contracts through ``FullConvFunction``)."""
        if self.bf16:
            return self._bf16_call(fc, linear, x, edge_radial, sh, edge_src,
                                   edge_dst, num_nodes, pre_scale, False)
        weight = fc(edge_radial)
        return self.fused(linear, x, edge_src, edge_dst, sh, weight,
                          num_nodes, pre_scale)

    def launch(self, fc, linear, x, edge_radial, sh, edge_src, edge_dst,
               num_nodes, pre_scale=None):
        """The kernel path: the edge orders (``edge_order.shared``: one per
        set of edges, so once per model forward), flat weights in plain
        PyTorch, then K1, through ``FullConvFunction`` (K2 in the backward)
        when a gradient is wanted."""
        if self.bf16:
            return self._bf16_call(fc, linear, x, edge_radial, sh, edge_src,
                                   edge_dst, num_nodes, pre_scale, True)
        order = edge_order.shared(edge_src, edge_dst, num_nodes)
        if not torch.is_grad_enabled():
            return launch_forward(self, x, edge_radial, sh, edge_src,
                                  edge_dst, *self.flat_weights(
                                      fc, linear, pre_scale),
                                  int(num_nodes), order=order)[0]
        w_hidden, w_out, wsel = self.flat_weights(fc, linear, pre_scale)
        return FullConvFunction.apply(self, x, edge_radial, w_hidden, w_out,
                                      wsel, sh, edge_src, edge_dst,
                                      int(num_nodes), order)

    def _bf16_call(self, fc, linear, x, edge_radial, sh, edge_src, edge_dst,
                   num_nodes, pre_scale, kernel: bool):
        """The bfloat16 conv: x and sh rounded to bfloat16 (x may come
        rounded), the flat weights in bfloat16, then K1 (``kernel``) or its
        plain contract, through ``FullConvFunction`` when a gradient is
        wanted: ``[N, out_dim]`` bfloat16."""
        if torch.is_grad_enabled() and sh.requires_grad:
            raise NotImplementedError(
                "the bfloat16 conv has no sh cotangent (K2's dsh mode) yet: "
                "ROADMAP.md queue 1 item 3.3")
        order = (edge_order.shared(edge_src, edge_dst, num_nodes) if kernel
                 else None)
        args = (x.to(BF16), edge_radial, *self.flat_weights(fc, linear,
                                                            pre_scale),
                sh.to(BF16), edge_src, edge_dst, int(num_nodes), order,
                kernel)
        if not torch.is_grad_enabled():
            x_b, er, w_hidden, w_out, wsel, sh_b = args[:6]
            return _run_forward(kernel)(
                self, x_b, er, sh_b, edge_src, edge_dst, w_hidden, w_out,
                wsel, int(num_nodes), order=order)[0]
        return FullConvFunction.apply(self, *args)

    def flat_weights(self, fc, linear, pre_scale=None):
        """The kernels' weights: hidden MLP layers (each divided by
        sqrt(fan_in), flattened and concatenated), the last MLP layer
        ``[H, PC]`` likewise, and the mix matrices of every problem (alphas
        and ``pre_scale`` folded in), flattened in ``mix_plan`` order.
        At bfloat16 each as the TPU kernel's caller rounds it
        (``fused_conv.py:2471-2477``): every MLP weight divided by
        sqrt(fan_in), then rounded; the mix matrices as ``flat_wsel``
        rounds them."""
        n_hidden = len(self.fc_dims) - 2
        if self.bf16:
            ws = [(getattr(fc, f"w{i}") / float(self.fc_dims[i]) ** 0.5
                   ).to(BF16) for i in range(n_hidden + 1)]
            return (torch.cat([w.reshape(-1) for w in ws[:-1]]),
                    ws[-1].contiguous(), self.flat_wsel(linear, pre_scale))
        scale = [float(d) ** -0.5 for d in self.fc_dims[:-1]]
        w_hidden = torch.cat([
            (getattr(fc, f"w{i}") * scale[i]).reshape(-1)
            for i in range(n_hidden)
        ])
        w_out = getattr(fc, f"w{n_hidden}") * scale[n_hidden]
        return (w_hidden.contiguous(), w_out.contiguous(),
                self.flat_wsel(linear, pre_scale))

    def plain_forward(self, x, edge_radial, sh, edge_src, edge_dst,
                      w_hidden, w_out, wsel, num_nodes):
        """Plain PyTorch version of K1's contract on the flat weights:
        ``(out [N, out_dim], scratch [N, K * mul])``, the scratch holding
        the unmixed node sums in the kernel's row order (component-major
        inside each output-irrep group)."""
        R, H = self.fc_dims[0], self.fc_dims[1]
        h, ofs = edge_radial, 0
        for i in range(len(self.fc_dims) - 2):
            fan = R if i == 0 else H
            W = w_hidden[ofs: ofs + fan * H].reshape(fan, H)
            h = shifted_softplus(h @ W) * self.act_cst
            ofs += fan * H
        return self.plain_core(x, sh, h @ w_out, wsel, edge_src, edge_dst,
                               num_nodes)

    def plain_backward(self, x, edge_radial, sh, edge_src, edge_dst,
                       w_hidden, w_out, wsel, num_nodes, scratch, gout,
                       dsh: bool = False):
        """Plain PyTorch version of K2's contract: ``(dx, d edge_radial,
        dw_hidden, dw_out, dwsel)`` for the cotangent ``gout``, and with
        ``dsh`` the sh cotangent last, by autograd of ``plain_forward``
        (which recomputes what the kernel reads from ``scratch``)."""
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True)
                   for t in (x, edge_radial, w_hidden, w_out, wsel)]
            sh_in = sh.detach().requires_grad_(True) if dsh else sh
            out, _ = self.plain_forward(ins[0], ins[1], sh_in, edge_src,
                                        edge_dst, *ins[2:], num_nodes)
            return torch.autograd.grad(
                out, ins + [sh_in] if dsh else ins, gout)

    # ------------------------------------------------ bfloat16 contracts
    def _mlp_bf16(self, edge_radial, w_hidden, w_out):
        """The radial MLP as ``_mlp_fwd`` computes it at bfloat16
        (``fused_conv.py:813-828``): ``(pre-activations, the activations
        of every layer's input, w_edge)``, the input and every activation
        rounded, sums in float32, w_edge rounded."""
        R, H = self.fc_dims[0], self.fc_dims[1]
        h, zs, hs, ofs = round_bf16(edge_radial), [], [], 0
        for i in range(len(self.fc_dims) - 2):
            fan = R if i == 0 else H
            hs.append(h)
            z = h @ w_hidden[ofs: ofs + fan * H].float().reshape(fan, H)
            h = round_bf16(shifted_softplus(z) * self.act_cst)
            zs.append(z)
            ofs += fan * H
        hs.append(h)
        return zs, hs, round_bf16(h @ w_out.float())

    def plain_forward_bf16(self, x, edge_radial, sh, edge_src, edge_dst,
                           w_hidden, w_out, wsel, num_nodes):
        """Plain PyTorch version of K1's bfloat16 contract: ``(out [N,
        out_dim] bfloat16, scratch [N, K * mul] float32)`` from bfloat16 x,
        sh, MLP weights and mix matrices and float32 edge_radial.  Per edge
        and path w2d = bf16(mid * w_edge) (``:847``), the node sums in
        float32 (the scratch), rounded to bfloat16 before the mix, the mix
        summed in float32 over the bfloat16 matrices, the output rounded
        (``:1008-1047``)."""
        mul, N = self.fused.mul, int(num_nodes)
        xT, shf = self._x_table(x.float()), sh.float()
        scratch = x.new_zeros((N, self.KM), dtype=torch.float32)
        cols = (self.bf16_srow[:, None] * mul
                + torch.arange(mul, device=x.device)).reshape(-1)
        for e0 in range(0, sh.shape[0], PLAIN_EDGES):
            e = slice(e0, e0 + PLAIN_EDGES)
            _, _, w = self._mlp_bf16(edge_radial[e], w_hidden, w_out)
            w_mid = w.reshape(w.shape[0], -1, mul)[:, self.bf16_widx]
            mid = self._mid_bf16(xT, shf[e], edge_src[e])
            w2d = round_bf16(mid * w_mid).reshape(w.shape[0], -1)
            rows = torch.zeros_like(w2d).index_copy(1, cols, w2d)
            scratch = scratch + segment_sum(rows, edge_dst[e], N)
        out = mix_rows(round_bf16(scratch), wsel.float(), self.prob_rows,
                       self.out_dim)
        return out.to(BF16), scratch

    def plain_backward_bf16(self, x, edge_radial, sh, edge_src, edge_dst,
                            w_hidden, w_out, wsel, num_nodes, scratch, gout):
        """Plain PyTorch version of K2's bfloat16 contract, the TPU
        kernel's own rounding points (``fused_conv.py:1126-1312``) and not
        autograd of the rounded forward: ``(dx, d edge_radial, dw_hidden,
        dw_out, dwsel)``, in the dtypes of x, edge_radial and the weights
        (bfloat16, float32, bfloat16 ...).

        dS = bf16(gout wsel^T) per node, dwsel = bf16(S) ^T gout; per edge
        (all sums float32, then rounded): the recomputed mid and w_edge,
        g = dS[dst]; dw = the bf16 sum over a path's components of bf16(g
        mid); dmid = bf16(g w); douter[j, i] = bf16(C^T dmid); dx_e = the
        bf16 sum over j in order of bf16(sh_j douter[j]); dx = the float32
        sum over a node's edges, rounded; the MLP backward with every
        cotangent rounded (``:1264-1285``); dW, dwsel and dx rounded as the
        caller casts them to the inputs' dtypes (``:2421-2433``)."""
        mul, N = self.fused.mul, int(num_nodes)
        n_hidden = len(self.fc_dims) - 2
        g = gout.float()
        with torch.enable_grad():
            S = round_bf16(scratch).requires_grad_(True)
            ws = wsel.float().requires_grad_(True)
            out = mix_rows(S, ws, self.prob_rows, self.out_dim)
            dS, dwsel = torch.autograd.grad(out, (S, ws), g)
        dS = round_bf16(dS)
        xT, shf = self._x_table(x.float()), sh.float()
        cols = (self.bf16_srow[:, None] * mul
                + torch.arange(mul, device=x.device)).reshape(-1)
        C = self.bf16_C
        dxT = xT.new_zeros(xT.shape)
        dWs = [None] * (n_hidden + 1)
        ders = []
        R, H = self.fc_dims[0], self.fc_dims[1]
        fans = [R] + [H] * (n_hidden - 1)
        P = self.fc_dims[-1] // mul
        for e0 in range(0, sh.shape[0], PLAIN_EDGES):
            e = slice(e0, e0 + PLAIN_EDGES)
            E = shf[e].shape[0]
            zs, hs, w = self._mlp_bf16(edge_radial[e], w_hidden, w_out)
            w_mid = w.reshape(E, P, mul)[:, self.bf16_widx]
            mid = self._mid_bf16(xT, shf[e], edge_src[e])
            gv = dS[edge_dst[e]][:, cols].reshape(E, -1, mul)
            dwp = round_bf16(gv * mid)
            dw = mid.new_zeros((E, P, mul))
            k = 0
            for ir, k0, n_paths, d, p0 in self.fused.groups:
                blk = dwp[:, k: k + n_paths * d].reshape(E, n_paths, d, mul)
                acc = blk[:, :, 0]
                for dd in range(1, d):
                    acc = round_bf16(acc + blk[:, :, dd])
                dw[:, self.bf16_widx[k: k + n_paths * d: d]] = acc
                k += n_paths * d
            dmid = round_bf16(gv * w_mid)
            douter = round_bf16(torch.einsum("jki,eku->ejiu", C, dmid))
            c = round_bf16(shf[e][:, :, None, None] * douter)
            dxe = torch.zeros_like(c[:, 0])
            for j in range(c.shape[1]):
                dxe = round_bf16(dxe + c[:, j])
            dxT = dxT + segment_sum(dxe, edge_src[e], N)
            # the radial MLP backward, every cotangent rounded
            dh = dw.reshape(E, -1)
            for i in reversed(range(n_hidden + 1)):
                W = (w_out if i == n_hidden else w_hidden[
                    sum(f * H for f in fans[:i]):
                    sum(f * H for f in fans[: i + 1])].reshape(fans[i], H)
                     ).float()
                dWi = hs[i].T @ dh
                dWs[i] = dWi if dWs[i] is None else dWs[i] + dWi
                dh = round_bf16(dh @ W.T)
                if i > 0:
                    dh = round_bf16(dh * self.act_cst
                                    * torch.sigmoid(zs[i - 1]))
            ders.append(dh)
        dx = self._x_columns(dxT).to(BF16)
        der = torch.cat(ders) if ders else edge_radial.new_zeros(
            edge_radial.shape)
        return (dx, der, torch.cat([d.reshape(-1) for d in dWs[:-1]]).to(BF16),
                dWs[-1].to(BF16), dwsel.to(BF16))


def _plain_forward(conv, *args, order=None):
    return conv.plain_forward_bf16(*args)


def _plain_backward(conv, *args, order=None):
    return conv.plain_backward_bf16(*args)


def _run_forward(kernel: bool):
    """K1's launch, or the bfloat16 plain contract for CPU tensors (read
    at call time, so that a test may route the launches)."""
    return launch_forward if kernel else _plain_forward


def _run_backward(kernel: bool):
    return launch_backward if kernel else _plain_backward


class FullConvFunction(torch.autograd.Function):
    """K1 forward, K2 backward, on one edge order (saved for the backward).
    Differentiable inputs: ``x``, ``edge_radial``, the flat weights and
    ``sh``; K2 computes the sh cotangent only when ``sh`` needs a gradient.
    The backward is a kernel of first order: differentiating it again (a
    force loss on a first-order model) raises.  (``needs_input_grad`` does
    not see grad mode, so ``FullConv.launch`` calls this under grad mode
    only.)"""

    @staticmethod
    def forward(ctx, conv, x, edge_radial, w_hidden, w_out, wsel, sh,
                edge_src, edge_dst, num_nodes, order, kernel=True):
        out, scratch = _run_forward(kernel)(
            conv, x, edge_radial, sh, edge_src, edge_dst, w_hidden, w_out,
            wsel, num_nodes, order=order)
        ctx.save_for_backward(x, edge_radial, w_hidden, w_out, wsel, sh,
                              edge_src, edge_dst, scratch,
                              *(order if order is not None else ()))
        ctx.conv, ctx.num_nodes, ctx.kernel = conv, num_nodes, kernel
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        x, er, w_hidden, w_out, wsel, sh, src, dst, scratch, *order = \
            ctx.saved_tensors
        # the sh cotangent only when wanted (a keyword the launches take
        # only then)
        kw = {"dsh": True} if ctx.needs_input_grad[6] else {}
        grads = _run_backward(ctx.kernel)(
            ctx.conv, x, er, sh, src, dst, w_hidden, w_out, wsel,
            ctx.num_nodes, scratch, gout.contiguous(),
            order=edge_order.EdgeOrder(*order) if order else None, **kw)
        dsh = grads[5] if kw else None
        return (None, *grads[:5], dsh, None, None, None, None, None)


def check_structure(conv, backward: bool = False, dsh: bool = False) -> None:
    """Raise unless the kernels take this layer's sizes.  The forward keeps
    a node's sums and the left irrep's components in registers, up to
    ``WALK_ROWS`` of them (irreps up to l = 7 on either side); the backward
    holds one register row per component of the left irrep, up to ``MAX_D``
    of them (l = 4, the hamiltonian trunk).  The sh cotangent (``dsh``)
    holds a node matrix of every irrep up to l = 4 by each sh irrep up to
    l = 3, and sums each path's shares over lane groups of min(mul, 32)
    lanes (a power of two, at least 8).  At bfloat16 a block's four warps
    hold 16 channels each (mul up to 64) and a warp's accumulators the
    (path, component) columns of one left irrep, up to 96 of them."""
    fused = conv.fused
    R, H, PC = conv.fc_dims[0], conv.fc_dims[1], conv.fc_dims[-1]
    n_hidden = len(conv.fc_dims) - 2
    if not (R <= MAX_RADIAL and H <= MAX_HIDDEN and n_hidden >= 1
            and fused.J_dim <= MAX_SH and fused.mul * 4 <= 1024
            and all(h == H for h in conv.fc_dims[1:-1])
            and PC == fused.weight_numel):
        raise ValueError(f"FullConv kernel does not take MLP dims "
                         f"{conv.fc_dims}, J={fused.J_dim}, "
                         f"mul={fused.mul}")
    if max(conv.max_d1, conv.max_d3) > WALK_ROWS:
        raise ValueError(f"the FullConv kernels take irreps up to l = 7, "
                         f"got d = {max(conv.max_d1, conv.max_d3)}")
    if conv.bf16 and not (fused.mul <= 64
                          and conv.bf16_walk_dims[1] <= BF16_MAX_NT):
        raise ValueError(f"the bfloat16 FullConv kernels take mul up to 64 "
                         f"and up to {8 * BF16_MAX_NT} (path, component) "
                         f"columns a left irrep; got mul = {fused.mul}, "
                         f"{8 * int(conv.bf16_walk_dims[1])} columns")
    if backward and conv.max_d1 > MAX_D:
        raise ValueError(f"the FullConv backward takes left irreps up to "
                         f"l = 4, got d = {conv.max_d1}")
    lanes = min(fused.mul, 32)
    if dsh and not (max(conv.max_d1, conv.max_d3) <= MAX_D
                    and conv.max_d2 <= 7 and fused.mul >= 8
                    and lanes & (lanes - 1) == 0 and fused.mul % lanes == 0):
        raise ValueError(f"the FullConv sh cotangent takes irreps up to "
                         f"l = 4, sh irreps up to l = 3 and mul a multiple "
                         f"of a power of two >= 8; got d1 = {conv.max_d1}, "
                         f"d3 = {conv.max_d3}, d2 = {conv.max_d2}, "
                         f"mul = {fused.mul}")


def _check_inputs(conv, x, edge_radial, sh, edge_src, edge_dst, w_hidden,
                  w_out, wsel, num_nodes, backward=False, dsh=False):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"FullConv kernel needs CUDA tensors, got {dev}")
    fused = conv.fused
    N, E = int(num_nodes), sh.shape[0]
    R, H, PC = conv.fc_dims[0], conv.fc_dims[1], conv.fc_dims[-1]
    n_hidden = len(conv.fc_dims) - 2
    cd = conv.compute_dtype   # the dtype of the operands the kernels round
    if dsh and cd != torch.float32:
        raise NotImplementedError("K2's dsh mode has no bfloat16 variant "
                                  "yet: ROADMAP.md queue 1 item 3.3")
    check_tensor(x, "x", (N, fused.irreps_in.dim), cd, dev)
    check_tensor(sh, "sh", (E, fused.J_dim), cd, dev)
    check_tensor(edge_radial, "edge_radial", (E, R), torch.float32, dev)
    check_tensor(edge_src, "edge_src", (E,), torch.int64, dev)
    check_tensor(edge_dst, "edge_dst", (E,), torch.int64, dev)
    check_structure(conv, backward, dsh)
    if conv.path_table.device != dev:
        raise ValueError("FullConv tables are not on the input's device")
    n_w = R * H + (n_hidden - 1) * H * H
    check_tensor(w_hidden, "w_hidden", (n_w,), cd, dev)
    check_tensor(w_out, "w_out", (H, PC), cd, dev)
    check_tensor(wsel, "wsel", (conv.wsel_len,), cd, dev)
    return dev, N, E


def _walk_args(conv):
    """The walk tables' arguments of the C entries: the float32 walk's
    (``ConvTables._walk_tables``), or the bfloat16 walk's
    (``FullConv._bf16_walk_tables``)."""
    if conv.bf16:
        return (conv.bf16_walk_tab.data_ptr(),
                conv.bf16_walk_tiles.data_ptr(),
                int(conv.bf16_walk_dims[0]), conv.bf16_walk_dims.ctypes.data)
    return (conv.walk_table.data_ptr(), conv.walk_chunks.data_ptr(),
            conv.n_chunks, conv.walk_cells.data_ptr(),
            conv.walk_nz.data_ptr(), conv.max_chunk_nz, conv.max_d1,
            conv.max_d3)


def walk_items(E: int, n_chunks: int):
    """``(cap, T)`` of the node-major walk: T = ceil(E / cap) work items of
    cap edges (a node with more is walked in pieces), cap chosen so that
    the grid of T items by ``n_chunks`` path chunks holds about
    ``WALK_BLOCKS`` blocks, within [2, 64]."""
    cap = min(64, max(2, E * n_chunks // WALK_BLOCKS))
    return cap, max(1, -(-E // cap))


def _order(order, edge_src, edge_dst, N):
    """The given edge order, checked, or a new one."""
    if order is None:
        return edge_order.build(edge_src, edge_dst, N)
    E, dev = edge_src.shape[0], edge_src.device
    for name in ("dst", "src"):
        check_tensor(getattr(order, f"{name}_perm"), f"{name}_perm", (E,),
                     torch.int32, dev)
        check_tensor(getattr(order, f"{name}_ptr"), f"{name}_ptr", (N + 1,),
                     torch.int32, dev)
    return order


def launch_forward(conv, x, edge_radial, sh, edge_src, edge_dst, w_hidden,
                   w_out, wsel, num_nodes, order=None):
    """Launch K1: ``(out [N, out_dim], scratch [N, K * mul])``.  ``order``:
    the edges' ``EdgeOrder``, built here when not given."""
    dev, N, E = _check_inputs(conv, x, edge_radial, sh, edge_src, edge_dst,
                              w_hidden, w_out, wsel, num_nodes)
    order = _order(order, edge_src, edge_dst, N)
    fused = conv.fused
    R, H, PC = conv.fc_dims[0], conv.fc_dims[1], conv.fc_dims[-1]
    cap, T = walk_items(E, conv.n_chunks)
    scratch = torch.empty((N, conv.KM), dtype=torch.float32, device=dev)
    out = torch.empty((N, conv.out_dim), dtype=conv.compute_dtype,
                      device=dev)
    # work: the last hidden layer per edge, the long runs' pieces (and at
    # bfloat16 W_out transposed, [PC, MAX_HIDDEN])
    h_work = torch.empty((E, H), dtype=torch.float32, device=dev)
    pieces = torch.empty((T, conv.KM), dtype=torch.float32, device=dev)
    wt = (torch.empty((PC, MAX_HIDDEN), dtype=BF16, device=dev),) \
        if conv.bf16 else ()
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = lib.full_conv_fwd_bf16 if conv.bf16 else lib.full_conv_fwd
        err = entry(
            x.data_ptr(), N, fused.irreps_in.dim,
            sh.data_ptr(), fused.J_dim,
            edge_radial.data_ptr(), R,
            edge_src.data_ptr(), edge_dst.data_ptr(), E,
            w_hidden.data_ptr(), H, len(conv.fc_dims) - 2,
            w_out.data_ptr(), PC, conv.act_cst,
            *_walk_args(conv),
            order.dst_perm.data_ptr(), order.dst_ptr.data_ptr(), cap, T,
            h_work.data_ptr(), pieces.data_ptr(),
            *(t.data_ptr() for t in wt),
            scratch.data_ptr(), conv.KM, fused.mul,
            wsel.data_ptr(), conv.prob_rows.ctypes.data, conv.n_probs,
            out.data_ptr(), conv.out_dim, stream,
        )
    check(err, "full_conv_fwd")
    if conv.bf16:
        FullConv.bf16_launches += 1
    else:
        FullConv.launches += 1
    return out, scratch


def launch_backward(conv, x, edge_radial, sh, edge_src, edge_dst, w_hidden,
                    w_out, wsel, num_nodes, scratch, gout, order=None,
                    dsh: bool = False):
    """Launch K2: ``(dx, d edge_radial, dw_hidden, dw_out, dwsel)``, all
    float32, from the forward's inputs, its scratch and ``gout``; with
    ``dsh`` the sh cotangent ``[E, J]`` last.  ``order``: the edges'
    ``EdgeOrder``, built here when not given.  At bfloat16 (``gout``
    bfloat16) the gradients come in the dtypes of their inputs."""
    dev, N, E = _check_inputs(conv, x, edge_radial, sh, edge_src, edge_dst,
                              w_hidden, w_out, wsel, num_nodes,
                              backward=True, dsh=dsh)
    order = _order(order, edge_src, edge_dst, N)
    cap, T = walk_items(E, conv.n_chunks)
    check_tensor(scratch, "scratch", (N, conv.KM), torch.float32, dev)
    cd = conv.compute_dtype
    check_tensor(gout, "gout", (N, conv.out_dim), cd, dev)
    fused = conv.fused
    R, H, PC = conv.fc_dims[0], conv.fc_dims[1], conv.fc_dims[-1]
    n_hidden = len(conv.fc_dims) - 2

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    dx, der = empty(N, fused.irreps_in.dim, dtype=cd), empty(E, R)
    dw_hidden, dw_out, dwsel = empty(w_hidden.numel(), dtype=cd), \
        empty(H, PC, dtype=cd), empty(conv.wsel_len, dtype=cd)
    # work buffers: node cotangent of the scratch, per-edge radial-weight
    # cotangent, the MLP's pre-activations and activations, two rows, the
    # per-path dx rows and the long runs' pieces of them
    # (bfloat16: no per-path rows, the long runs' pieces of dx [T, in_dim],
    # W_out transposed [PC, MAX_HIDDEN])
    KMd = conv.KMd if not conv.bf16 else fused.irreps_in.dim
    work = [empty(N, conv.KM), empty(E, PC), empty(n_hidden, E, H),
            empty(n_hidden, E, H), empty(E, H), empty(E, H),
            *(() if conv.bf16 else (empty(N, KMd),)), empty(T, KMd),
            *((empty(PC, MAX_HIDDEN, dtype=BF16),) if conv.bf16 else ())]
    # the sh cotangent and its path chunks' rows, or null pointers
    d_sh = (empty(E, fused.J_dim), empty(conv.n_chunks, E, fused.J_dim)) \
        if dsh else ()
    ws = row_mix.workspace(dev, gout.numel())   # see row_mix.workspace
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = lib.full_conv_bwd_bf16 if conv.bf16 else lib.full_conv_bwd
        walk = _walk_args(conv) if conv.bf16 else (
            *_walk_args(conv), conv.walk_irreps.data_ptr(),
            conv.n_walk_irreps, KMd)
        err = entry(
            x.data_ptr(), N, fused.irreps_in.dim,
            sh.data_ptr(), fused.J_dim,
            edge_radial.data_ptr(), R,
            edge_src.data_ptr(), edge_dst.data_ptr(), E,
            w_hidden.data_ptr(), H, n_hidden,
            w_out.data_ptr(), PC, conv.act_cst,
            *walk, int(conv.dx_covered),
            order.src_perm.data_ptr(), order.src_ptr.data_ptr(), cap, T,
            scratch.data_ptr(), conv.KM, fused.mul,
            wsel.data_ptr(), conv.wsel_len,
            conv.prob_rows.ctypes.data, conv.n_probs,
            gout.data_ptr(), conv.out_dim,
            *(t.data_ptr() for t in work),
            dx.data_ptr(), der.data_ptr(), dw_hidden.data_ptr(),
            w_hidden.numel(), dw_out.data_ptr(), dwsel.data_ptr(),
            *(() if conv.bf16 else (t.data_ptr() for t in d_sh) if dsh
              else (None, None)),
            ws.data_ptr(), ws.numel(), stream,
        )
    check(err, "full_conv_bwd")
    if conv.bf16:
        FullConv.bf16_backward_launches += 1
    else:
        FullConv.backward_launches += 1
    if dsh:
        FullConv.dsh_launches += 1
        return dx, der, dw_hidden, dw_out, dwsel, d_sh[0]
    return dx, der, dw_hidden, dw_out, dwsel
