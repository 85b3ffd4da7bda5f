"""K6 and K6b: the per-edge uvu tensor-product convolution without the edge
sum, forward and backward, around ``csrc/uvu_conv.cu``.

The kernels replace the TPU kernels ``PallasUVUConv._fwd_kernel`` and
``_bwd_kernel`` (``equivariant_nn_zoo_tpu/ops/pallas/fused_conv.py:233`` and
``:278``), whose live use is the neighbor conv of the hamiltonian head
(``Pairwise``, ``reduce=False``):

    out[e] = Mix_wsel( w_e (.) CG(x[src_e] (x) sh_e) )        [E, out_dim]

with per-edge radial weights ``w [E, P * mul]`` from the caller's MLP
(columns in the expansion's instruction order) and the flat mix matrices
``wsel`` (the mix ``Linear``'s alphas folded in, ``ConvTables.flat_wsel``).
Row and table conventions are K1's (``ConvTables``); the gather of
``x[src]`` is an indexed load inside the kernel.

K6 is K5's fused forward on K6's operands: each path's CG tile is made in
shared memory and mixed there on the tensor cores, over the same host
tables (``pairwise_tp.fused_tables`` on ``ConvTables``' path table, cut by
``pairwise_tp.forward_plan``), so the unmixed rows never reach device
memory and nothing is saved for the backward.  K6b makes dwsel the way K5m
does (``dws_plan``'s chunks added in order), then one adjoint sweep
(``uvu_tables``: the paths in left-irrep order with their non-zeros in the
two orders of ``pairwise_tp.adjoint_tables``, cut into chunks of one left
irrep) makes dS in shared memory and stores dw once, each chunk's dx
columns per edge and each unit's dsh rows; dsh is the units' rows added in
order, dx each source node's edges added in the source-major order of
``edge_order`` (the trunk's, which ``edge_order.shared`` keeps).  No
atomics, no memsets of outputs.

For tensors on the CPU the wrapper runs the plain version
(``FusedUVUConv`` with ``reduce=False``) and autograd differentiates it.
For CUDA tensors it goes through ``UVUConvFunction``, whose forward
launches K6 and whose backward launches K6b (``dx``, ``dsh``, ``dw``,
``dwsel``), or raises; autograd carries ``dw`` back into the caller's radial
MLP and ``dwsel`` to ``tp.linear.*``.  ``plain_forward`` and
``plain_backward`` are the plain PyTorch versions of the two kernels'
contracts on the flat mix matrices, for the tests and the on-card checks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import edge_order
from .build import check, check_tensor, load_library
from .full_conv import MAX_D, MAX_SH, ConvTables
from .pairwise_tp import (
    ADJ_ROW,
    MAX_WO,
    adjoint_tables,
    balanced_cuts,
    dws_plan,
    forward_plan,
    fused_tables,
)
from .species_sc import _multiprocessors

#: K6's channels per K step (csrc/uvu_conv.cu, uvu_fwd_kernel; its units
#: and edge tiles are pairwise_tp's)
FWD_KC = 32
#: the adjoint sweep (csrc/uvu_conv.cu, uvu_adj_kernel): edges of a tile
#: and channels of a unit
ADJ_TILE, ADJ_KC = 16, 32
#: the two cuts of each left irrep's paths into chunks, coarse and fine, by
#: the number of chunks each one's balance cap aims at
ADJ_TARGET_CHUNKS = (8, 32)


class AdjointCut(NamedTuple):
    """One cut of the adjoint sweep's paths into units of work.

    - ``chunks [C, 5]``: ``(x_off, d1, p0, p1, ws_col)``, consecutive
      adjoint paths ``[p0, p1)`` of one left irrep (``mul * d1`` columns
      from ``x_off``), at most ``cap`` non-zeros; the chunk's dx columns of
      edge e at ``E * ws_col + e * mul * d1`` of the dx workspace;
    - ``units [U, 2]``: ``(chunk, u0)``, the chunk's channels ``[u0, u0 +
      ADJ_KC)``, heaviest first; unit u's dsh rows at ``[u, E, J]`` of the
      dsh workspace;
    - ``irreps [L, 4]``: ``(x_off, width, ws_col, n)`` for every left irrep
      in column order: its dx columns are the sum of its ``n`` chunks'
      partials at ``ws_col + k * width`` (zeros where ``n`` is 0);
    - ``ws_width``: the dx workspace's floats per edge.
    """
    chunks: np.ndarray
    units: np.ndarray
    irreps: np.ndarray
    ws_width: int


class UVUTables(NamedTuple):
    """Host tables of K6b's adjoint sweep, built by ``uvu_tables``; the
    paths and their run bounds are ``adjoint_tables``' (``paths``, left-irrep
    order).

    - ``order [P]``: the path-table index of each adjoint path;
    - ``ext [P, 3]``: ``(wcol, s0, n_slots)``: the path's radial-weight
      column and its path-slots ``slots[s0: s0 + n_slots]``;
    - ``slots [S, 3]``: ``(out_col, wo, b_off)``: an output slot of the
      path's group, and the path's ``[mul, wo]`` mix matrix at ``b_off``;
    - ``nz [2, Z, 2]`` int32: the non-zeros in ``adjoint_tables``' two
      orders (m1-major, m2-major), each ``first | m3 << 8`` beside the
      coefficient's float32 bits, ``first`` the sh index m2 (order 0) or
      the x component m1 (order 1);
    - ``cuts``: an ``AdjointCut`` per ``ADJ_TARGET_CHUNKS``;
    - ``dims`` int32: ``(max paths of a chunk, max non-zeros of a chunk,
      max d1, max d3, max wo)``, which size the kernel's shared memory.
    """
    paths: np.ndarray
    order: np.ndarray
    ext: np.ndarray
    slots: np.ndarray
    nz: np.ndarray
    cuts: tuple
    dims: np.ndarray


def adjoint_cut(sizes, left_paths, mul, target):
    """The ``AdjointCut`` of adjoint paths with ``sizes`` non-zeros (in
    left-irrep order) whose balance cap aims at ``target`` chunks;
    ``left_paths``: per left irrep ``(x_off, d1, first path, path
    count)``, in column order."""
    cap = max(int(max(sizes, default=1)), -(-int(sum(sizes)) // target))
    chunks, irreps, ws_col = [], [], 0
    for x_off, d1, p0, n_p in left_paths:
        cuts = balanced_cuts(list(sizes[p0: p0 + n_p]), cap) if n_p else [0]
        width = mul * d1
        irreps.append([x_off, width, ws_col, len(cuts) - 1])
        for k in range(len(cuts) - 1):
            chunks.append([x_off, d1, p0 + cuts[k], p0 + cuts[k + 1], ws_col])
            ws_col += width
    units = sorted(
        ((-int(sizes[c[2]: c[3]].sum()), [i, u0])
         for i, c in enumerate(chunks) for u0 in range(0, mul, ADJ_KC)),
        key=lambda cu: cu[0])
    return AdjointCut(
        chunks=np.asarray(chunks, np.int32).reshape(-1, 5),
        units=np.asarray([u for _, u in units], np.int32).reshape(-1, 2),
        irreps=np.asarray(irreps, np.int32).reshape(-1, 4),
        ws_width=ws_col)


def uvu_tables(path_rows, d3s, nz_codes, nz_values, slots, left, mul):
    """The ``UVUTables`` of a conv path table (``ConvTables``' rows ``(x_off,
    d1, j0, d2, row_base, row_stride, wcol, nz0, nz1)``, the output dims
    ``d3s`` of its paths, the non-zeros ``nz_codes`` / ``nz_values``), its
    output slots ``slots`` [(p0, n_paths, d3, out_col, wo, b_off)] per
    (group, slot) and its left irreps ``left`` [(x_off, d1)], at
    multiplicity ``mul``."""
    path_rows = np.asarray(path_rows, np.int64).reshape(-1, 9)
    adj = adjoint_tables(path_rows, d3s, nz_codes, nz_values, left, mul)
    order, left_paths = [], []
    for x_off, d1 in left:
        qs = [q for q, row in enumerate(path_rows)
              if (row[0], row[1]) == (x_off, d1)]
        left_paths.append((x_off, d1, len(order), len(qs)))
        order += qs
    ext, path_slots = [], []
    for q in order:
        mine = [(out_col, wo, b_off + (q - p0) * mul * wo)
                for p0, n, _, out_col, wo, b_off in slots if p0 <= q < p0 + n]
        ext.append([int(path_rows[q, 6]), len(path_slots), len(mine)])
        path_slots += mine
    # adjoint_tables codes a non-zero as staged-row byte offsets: first
    # operand row | (d2 + m3) << 16, rows of ADJ_ROW floats
    codes = adj.nz[..., 0].astype(np.int64)
    first, third = (codes & 0xffff) // (4 * ADJ_ROW), \
        (codes >> 16) // (4 * ADJ_ROW)
    d2 = np.zeros(codes.shape[1], np.int64)
    for r0, d2_, _, _, _, nz0, nz1, *_ in adj.paths:
        d2[nz0:nz1] = d2_
    nz = np.stack([first | (third - d2) << 8, adj.nz[..., 1]], -1)
    sizes = adj.paths[:, 6] - adj.paths[:, 5]
    cuts = tuple(adjoint_cut(sizes, left_paths, mul, target)
                 for target in ADJ_TARGET_CHUNKS)
    chunks = np.concatenate([c.chunks for c in cuts])
    dims = np.asarray([
        max(int((chunks[:, 3] - chunks[:, 2]).max(initial=1)), 1),
        max((int(sizes[p0:p1].sum()) for _, _, p0, p1, _ in chunks),
            default=2),
        chunks[:, 1].max(initial=1), adj.paths[:, 4].max(initial=1),
        max((s[4] for s in slots), default=8)], np.int32)
    return UVUTables(
        paths=adj.paths, order=np.asarray(order, np.int32),
        ext=np.asarray(ext, np.int32).reshape(-1, 3),
        slots=np.asarray(path_slots, np.int32).reshape(-1, 3),
        nz=nz.astype(np.int32), cuts=cuts, dims=dims)


def adjoint_plan(E: int, cuts, sms: int) -> int:
    """The adjoint sweep's cut for E edges: the coarsest whose edge tiles
    times units still give two blocks per multiprocessor, else the
    finest."""
    tiles = -(-E // ADJ_TILE)
    for k, cut in enumerate(cuts):
        if tiles * len(cut.units) >= 2 * sms:
            return k
    return len(cuts) - 1


class UVUConv(ConvTables):
    """K6 and K6b for one ``FactorizedConvolution`` built with
    ``reduce=False``; the expansion's mix ``Linear`` is passed at call time,
    the radial weights come from the caller's MLP."""

    #: kernel launches, over all instances (the main path's proof of use)
    launches = 0
    backward_launches = 0

    def __init__(self, tpe):
        super().__init__(tpe)
        if not self.rows_complete:
            raise ValueError("UVUConv: a CG path has a component without a "
                             "non-zero; the kernel would leave its rows "
                             "unmade")
        fused, mul = self.fused, self.fused.mul
        rows = self.path_table.numpy().reshape(-1, 9)
        d3s = [d for _, _, n, d, _ in fused.groups for _ in range(n)]
        codes = self.nz_idx.numpy().astype(np.int64)
        values = self.nz_c.numpy()
        # K6 and K6b's dwsel: see pairwise_tp.fused_tables; the adjoint
        # sweep: see uvu_tables
        self.fwd_tables = fused_tables(rows, d3s, codes, values, self.slots,
                                       mul)
        left = [(s.start, mi.ir.dim) for s, mi in
                zip(fused.irreps_in.slices(), fused.irreps_in)]
        self.adj_tables = uvu_tables(rows, d3s, codes, values, self.slots,
                                     left, mul)
        # columns of no slot (an output irrep no path reaches) are zeros
        covered = {s[3] + c for s in self.slots for c in range(s[4] * s[2])}
        self.out_covered = covered == set(range(self.out_dim))
        f, a = self.fwd_tables, self.adj_tables
        for name, table in (
                ("k6_paths", f.paths), ("k6_nz", f.nz),
                ("k6_wcols", rows[:, 6]),
                *((f"k6_fwd_units{k}", units)
                  for k, units in enumerate(f.fwd_units)),
                ("k6_dws_units", f.dws_units),
                ("k6_adj_paths", a.paths), ("k6_adj_ext", a.ext),
                ("k6_adj_slots", a.slots), ("k6_adj_nz", a.nz),
                *((f"k6_adj_{part}{k}", getattr(cut, part))
                  for k, cut in enumerate(a.cuts)
                  for part in ("chunks", "units", "irreps"))):
            self.register_buffer(
                name, torch.tensor(np.ascontiguousarray(table, np.int32)
                                   .reshape(-1)), persistent=False)

    def forward(self, linear, x: torch.Tensor, sh: torch.Tensor,
                w: torch.Tensor, edge_src: torch.Tensor,
                edge_dst: torch.Tensor) -> torch.Tensor:
        """x [N, in_dim] (already linear_1'd), sh [E, J], radial weights
        w [E, P * mul], edge_src [E] -> per-edge output [E, out_dim].
        ``edge_dst`` [E] (not read by the forward) names the edges whose
        order ``edge_order.shared`` keeps, which the backward walks."""
        if self.uses_kernel(x):
            return self.launch(linear, x, sh, w, edge_src, edge_dst)
        return self.fused(linear, x, edge_src, None, sh, w, x.shape[0],
                          reduce=False)

    def launch(self, linear, x, sh, w, edge_src, edge_dst):
        """The kernel path: the flat mix matrices in plain PyTorch, then
        K6, through ``UVUConvFunction`` (K6b in the backward, on the
        edges' source-major order) when a gradient is wanted."""
        wsel = self.flat_wsel(linear)
        args = (x.contiguous(), sh.contiguous(), w.contiguous(), wsel)
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            order = edge_order.shared(edge_src, edge_dst, x.shape[0])
            return UVUConvFunction.apply(self, *args, edge_src, order)
        return launch_forward(self, *args, edge_src)

    def plain_forward(self, x, sh, w, wsel, edge_src):
        """Plain PyTorch version of K6's contract: ``out [E, out_dim]``
        (the conv core with every edge its own destination)."""
        E = sh.shape[0]
        rows = torch.arange(E, device=x.device)
        return self.plain_core(x, sh, w, wsel, edge_src, rows, E)[0]

    def plain_backward(self, x, sh, w, wsel, edge_src, gout):
        """Plain PyTorch version of K6b's contract: ``(dx, dsh, dw,
        dwsel)`` for the cotangent ``gout``, by autograd of
        ``plain_forward``."""
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (x, sh, w, wsel)]
            return torch.autograd.grad(self.plain_forward(*ins, edge_src),
                                       ins, gout)


class UVUConvFunction(torch.autograd.Function):
    """K6 forward, K6b backward.  Differentiable inputs: ``x``, ``sh``,
    ``w`` and the flat mix matrices; saved: the inputs and the edges'
    order, nothing the forward computed.  (``needs_input_grad`` does not
    see grad mode, so ``UVUConv.launch`` calls this under grad mode
    only.)"""

    @staticmethod
    def forward(ctx, conv, x, sh, w, wsel, edge_src, order):
        ctx.save_for_backward(x, sh, w, wsel, edge_src, *order)
        ctx.conv = conv
        return launch_forward(conv, x, sh, w, wsel, edge_src)

    @staticmethod
    def backward(ctx, gout):
        x, sh, w, wsel, edge_src, *order = ctx.saved_tensors
        grads = launch_backward(ctx.conv, x, sh, w, wsel, edge_src,
                                gout.contiguous(),
                                order=edge_order.EdgeOrder(*order))
        return (None, *(g if need else None for g, need in
                        zip(grads, ctx.needs_input_grad[1:5])), None, None)


def _check_inputs(conv, x, sh, w, wsel, edge_src):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"UVUConv kernel needs CUDA tensors, got {dev}")
    fused = conv.fused
    N, E = x.shape[0], sh.shape[0]
    check_tensor(x, "x", (N, fused.irreps_in.dim), torch.float32, dev)
    check_tensor(sh, "sh", (E, fused.J_dim), torch.float32, dev)
    check_tensor(w, "w", (E, fused.weight_numel), torch.float32, dev)
    check_tensor(wsel, "wsel", (conv.wsel_len,), torch.float32, dev)
    check_tensor(edge_src, "edge_src", (E,), torch.int64, dev)
    dims = conv.fwd_tables.dims
    if not (N >= 1 and 1 <= fused.J_dim <= MAX_SH and fused.mul % 4 == 0
            and max(dims[:3]) <= MAX_D and dims[4] % 8 == 0
            and dims[4] <= MAX_WO):
        raise ValueError(
            f"the UVUConv kernels take N >= 1, J <= {MAX_SH}, irreps up to "
            f"l = 4, multiplicities that are multiples of 4 and output "
            f"multiplicities that are multiples of 8 up to {MAX_WO}; got "
            f"N={N}, J={fused.J_dim}, mul={fused.mul}, dims={dims}")
    if conv.k6_paths.device != dev:
        raise ValueError("UVUConv tables are not on the input's device")
    return dev, N, E


def _aligned(t):
    """``t``, or a copy that starts on 16 bytes: the kernels stage rows by
    16-byte copies."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_forward(conv, x, sh, w, wsel, edge_src):
    """Launch K6: ``out [E, out_dim]``."""
    dev, N, E = _check_inputs(conv, x, sh, w, wsel, edge_src)
    fused, tab = conv.fused, conv.fwd_tables
    new = torch.empty if conv.out_covered else torch.zeros
    out = new((E, conv.out_dim), dtype=torch.float32, device=dev)
    if E == 0:
        return out
    k = forward_plan(E, tab.fwd_units, _multiprocessors(dev))
    x, w, wsel = _aligned(x), _aligned(w), _aligned(wsel)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.uvu_conv_fwd(
            x.data_ptr(), N, fused.irreps_in.dim,
            sh.data_ptr(), fused.J_dim,
            w.data_ptr(), fused.weight_numel,
            edge_src.data_ptr(), E,
            conv.k6_paths.data_ptr(), conv.k6_nz.data_ptr(),
            tab.dims.ctypes.data, conv.k6_wcols.data_ptr(),
            getattr(conv, f"k6_fwd_units{k}").data_ptr(),
            len(tab.fwd_units[k]), fused.mul,
            wsel.data_ptr(), out.data_ptr(), conv.out_dim, stream,
        )
    check(err, "uvu_conv_fwd")
    UVUConv.launches += 1
    return out


def launch_backward(conv, x, sh, w, wsel, edge_src, gout, order=None):
    """Launch K6b: ``(dx [N, in_dim], dsh [E, J], dw [E, P * mul],
    dwsel)``, all float32, from the forward's inputs and ``gout [E,
    out_dim]``.  ``order``: the edges' ``EdgeOrder`` (its source-major
    half), built from the sources when not given."""
    dev, N, E = _check_inputs(conv, x, sh, w, wsel, edge_src)
    check_tensor(gout, "gout", (E, conv.out_dim), torch.float32, dev)
    fused, tab, adj = conv.fused, conv.fwd_tables, conv.adj_tables

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    if E == 0:
        return (torch.zeros((N, fused.irreps_in.dim), device=dev),
                empty(0, fused.J_dim), empty(0, fused.weight_numel),
                torch.zeros(conv.wsel_len, device=dev))
    if order is None:
        order = edge_order.build(edge_src, edge_src, N)
    for name, n in (("src_perm", E), ("src_ptr", N + 1)):
        check_tensor(getattr(order, name), name, (n,), torch.int32, dev)
    x, w, wsel, gout = (_aligned(t) for t in (x, w, wsel, gout))
    dx, dsh = empty(N, fused.irreps_in.dim), empty(E, fused.J_dim)
    dw, dwsel = empty(E, fused.weight_numel), empty(conv.wsel_len)
    sms = _multiprocessors(dev)
    chunks, per = dws_plan(E, len(tab.dws_units), sms)
    k = adjoint_plan(E, adj.cuts, sms)
    cut = adj.cuts[k]
    # work: dwsel's partial per chunk of edges, each chunk's dx columns
    # per edge, each unit's dsh rows
    dws_ws = empty(chunks * conv.wsel_len) if chunks > 1 else None
    dx_ws = empty(E * cut.ws_width)
    dsh_ws = empty(len(cut.units) * E * fused.J_dim)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.uvu_conv_bwd(
            x.data_ptr(), N, fused.irreps_in.dim,
            sh.data_ptr(), fused.J_dim,
            w.data_ptr(), fused.weight_numel,
            edge_src.data_ptr(), E,
            conv.k6_paths.data_ptr(), conv.k6_nz.data_ptr(),
            tab.dims.ctypes.data, conv.k6_wcols.data_ptr(),
            conv.k6_dws_units.data_ptr(), len(tab.dws_units), per,
            conv.k6_adj_paths.data_ptr(), conv.k6_adj_ext.data_ptr(),
            conv.k6_adj_slots.data_ptr(), conv.k6_adj_nz.data_ptr(),
            adj.nz.shape[1],
            getattr(conv, f"k6_adj_chunks{k}").data_ptr(),
            getattr(conv, f"k6_adj_units{k}").data_ptr(), len(cut.units),
            getattr(conv, f"k6_adj_irreps{k}").data_ptr(), len(cut.irreps),
            adj.dims.ctypes.data,
            order.src_perm.data_ptr(), order.src_ptr.data_ptr(),
            fused.mul, wsel.data_ptr(), conv.wsel_len,
            gout.data_ptr(), conv.out_dim,
            dx.data_ptr(), dsh.data_ptr(), dw.data_ptr(), dwsel.data_ptr(),
            0 if dws_ws is None else dws_ws.data_ptr(),
            dx_ws.data_ptr(), dsh_ws.data_ptr(), stream,
        )
    check(err, "uvu_conv_bwd")
    UVUConv.backward_launches += 1
    return dx, dsh, dw, dwsel
