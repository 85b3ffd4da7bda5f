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
gradients back to ``fc.w*`` and ``tp.linear.*``.  The sh cotangent is not
computed (``compute_dsh=False``, the energy path): the Function raises when
``sh`` needs a gradient.  ``plain_forward`` and ``plain_backward`` are the
plain PyTorch versions of the two kernels' contracts on the same flat
inputs, for the tests and the on-card checks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..fused_tp import FusedUVUConv
from ..gate import ScaledActivation, shifted_softplus
from ..segment import segment_sum
from ..wigner import wigner_3j
from . import edge_order, row_mix
from .build import check, check_tensor, load_library

MAX_RADIAL, MAX_HIDDEN, MAX_SH, MAX_D = 16, 64, 16, 9
# the walk (csrc/edge_walk.cuh): paths per block, the widest irrep K1
# takes on either side (l = 7), fields per path of the walk table
WALK_GROUPS, WALK_ROWS, WALK_FIELDS = 4, 16, 9
WALK_BLOCKS = 2048   # blocks the walk's grid aims at (walk_items)


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


class ConvTables(torch.nn.Module):
    """Constant tables of one uvu ``TensorProductExpansion`` for the conv
    kernels (K1, K2 and the external-weight K4 family): the CG paths with
    their host-built wigner_3j non-zeros, and the mix problems.  Parameters
    are passed at call time, so this module holds buffers only."""

    def __init__(self, tpe):
        super().__init__()
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

        # mix problems: one per (group, component, output slot)
        linear_out = fused.irreps_out
        out_starts = [s.start for s in linear_out.slices()]
        probs, plan, b_off = [], [], 0
        for g, (ir, k0, n_paths, d, p0) in enumerate(fused.groups):
            for io in fused.lin_out.get(ir, []):
                wo = linear_out[io].mul
                plan.append((g, io))
                for dd in range(d):
                    probs.append([(k0 + dd * n_paths) * mul, n_paths * mul,
                                  b_off, wo, out_starts[io] + dd, d])
                b_off += n_paths * mul * wo
        self.wsel_len = b_off
        self.mix_plan = plan
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

    def _walk_tables(self, paths, cgs, d3s, mul, int_buffer):
        """The node-major walk's tables (K1 and K2, ``csrc/edge_walk.cuh``):
        the paths sorted by left irrep; their CG non-zeros sorted by
        (m3, m1, m2), the value and the sh index m2 of each; per path the
        bounds of each cell (m3, m1), d3 * d1 + 1 entries of ``walk_cells``;
        chunks of at most ``WALK_GROUPS`` paths of one left irrep (a block's
        paths); per left irrep the columns of its paths in K2's path-major
        dx rows."""
        order = sorted(range(len(paths)), key=lambda p: paths[p][0])
        rows, nz, cells, chunks, irreps = [], [], [], [], []
        dcol = 0
        for p in order:
            x_off, d1, j0, _, row_base, row_stride, wcol = paths[p][:7]
            cg, d3 = cgs[p], d3s[p]
            rows.append([x_off, d1, j0, d3, row_base, row_stride, wcol, dcol,
                         len(cells)])
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
        p0 = 0
        for _, _, _, n in irreps:
            k = -(-n // WALK_GROUPS)
            for i in range(k):
                size = n // k + (i < n % k)
                chunks.append([p0, size])
                p0 += size
        int_buffer("walk_table", rows)
        int_buffer("walk_cells", cells)
        int_buffer("walk_chunks", chunks)
        int_buffer("walk_irreps", irreps)
        a = np.zeros((max(len(nz), 1), 2), np.float32)
        if nz:
            a[:len(nz), 0] = [c for c, _ in nz]
            a[:len(nz), 1] = np.asarray([m2 for _, m2 in nz],
                                        np.int32).view(np.float32)
        self.register_buffer("walk_nz", torch.tensor(a), persistent=False)
        self.n_chunks = len(chunks)
        self.n_walk_irreps = len(irreps)
        self.KMd = dcol               # K2's path-major dx row width
        # the most non-zeros of a chunk (the kernels stage them)
        self.max_chunk_nz = max(
            [cells[rows[c0 + n - 1][8] + rows[c0 + n - 1][3] * rows[c0][1]]
             - cells[rows[c0][8]] for c0, n in chunks] + [0])
        self.max_d3 = max(d3s, default=0)
        # every input column is read by some path: K2's dx needs no zeros
        covered = np.zeros(self.fused.irreps_in.dim, bool)
        for x_off, d1, *_ in irreps:
            covered[x_off: x_off + d1 * mul] = True
        self.dx_covered = bool(covered.all())

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
        folded in), flattened in ``mix_plan`` order."""
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

    def __init__(self, tpe, fc):
        super().__init__(tpe)
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
        if x.device.type == "cpu":
            return self.plain(fc, linear, x, edge_radial, sh, edge_src,
                              edge_dst, num_nodes, pre_scale)
        return self.launch(fc, linear, x, edge_radial, sh, edge_src,
                           edge_dst, num_nodes, pre_scale)

    def plain(self, fc, linear, x, edge_radial, sh, edge_src, edge_dst,
              num_nodes, pre_scale=None):
        """Plain PyTorch version of the kernel (the same math, dense)."""
        weight = fc(edge_radial)
        return self.fused(linear, x, edge_src, edge_dst, sh, weight,
                          num_nodes, pre_scale)

    def launch(self, fc, linear, x, edge_radial, sh, edge_src, edge_dst,
               num_nodes, pre_scale=None):
        """The kernel path: the edge orders (``edge_order.shared``: one per
        set of edges, so once per model forward), flat weights in plain
        PyTorch, then K1, through ``FullConvFunction`` (K2 in the backward)
        when a gradient is wanted."""
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

    def flat_weights(self, fc, linear, pre_scale=None):
        """The kernels' weights: hidden MLP layers (each divided by
        sqrt(fan_in), flattened and concatenated), the last MLP layer
        ``[H, PC]`` likewise, and the mix matrices of every problem (alphas
        and ``pre_scale`` folded in), flattened in ``mix_plan`` order."""
        n_hidden = len(self.fc_dims) - 2
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
                       w_hidden, w_out, wsel, num_nodes, scratch, gout):
        """Plain PyTorch version of K2's contract: ``(dx, d edge_radial,
        dw_hidden, dw_out, dwsel)`` for the cotangent ``gout``, by autograd
        of ``plain_forward`` (which recomputes what the kernel reads from
        ``scratch``)."""
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True)
                   for t in (x, edge_radial, w_hidden, w_out, wsel)]
            out, _ = self.plain_forward(ins[0], ins[1], sh, edge_src,
                                        edge_dst, *ins[2:], num_nodes)
            return torch.autograd.grad(out, ins, gout)


class FullConvFunction(torch.autograd.Function):
    """K1 forward, K2 backward, on one edge order (saved for the backward).
    Differentiable inputs: ``x``, ``edge_radial`` and the flat weights.  An
    ``sh`` that needs a gradient is refused: that cotangent is the force
    path's kernel, and this one must not stand in for it with zeros.  (``needs_input_grad`` does not
    see grad mode, so ``FullConv.launch`` calls this under grad mode
    only.)"""

    @staticmethod
    def forward(ctx, conv, x, edge_radial, w_hidden, w_out, wsel, sh,
                edge_src, edge_dst, num_nodes, order):
        if ctx.needs_input_grad[6]:
            raise NotImplementedError(
                "FullConv: the sh cotangent (forces through positions) is "
                "not computed by this kernel; sh must not need a gradient")
        out, scratch = launch_forward(conv, x, edge_radial, sh, edge_src,
                                      edge_dst, w_hidden, w_out, wsel,
                                      num_nodes, order=order)
        ctx.save_for_backward(x, edge_radial, w_hidden, w_out, wsel, sh,
                              edge_src, edge_dst, scratch, *order)
        ctx.conv, ctx.num_nodes = conv, num_nodes
        return out

    @staticmethod
    def backward(ctx, gout):
        x, er, w_hidden, w_out, wsel, sh, src, dst, scratch, *order = \
            ctx.saved_tensors
        grads = launch_backward(ctx.conv, x, er, sh, src, dst, w_hidden,
                                w_out, wsel, ctx.num_nodes, scratch,
                                gout.contiguous(),
                                order=edge_order.EdgeOrder(*order))
        return (None, *grads, None, None, None, None, None)


def check_structure(conv, backward: bool = False) -> None:
    """Raise unless the kernels take this layer's sizes.  The forward keeps
    a node's sums and the left irrep's components in registers, up to
    ``WALK_ROWS`` of them (irreps up to l = 7 on either side); the backward
    holds one register row per component of the left irrep, up to ``MAX_D``
    of them (l = 4, the hamiltonian trunk)."""
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
    if backward and conv.max_d1 > MAX_D:
        raise ValueError(f"the FullConv backward takes left irreps up to "
                         f"l = 4, got d = {conv.max_d1}")


def _check_inputs(conv, x, edge_radial, sh, edge_src, edge_dst, w_hidden,
                  w_out, wsel, num_nodes, backward=False):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"FullConv kernel needs CUDA tensors, got {dev}")
    fused = conv.fused
    N, E = int(num_nodes), sh.shape[0]
    R, H, PC = conv.fc_dims[0], conv.fc_dims[1], conv.fc_dims[-1]
    n_hidden = len(conv.fc_dims) - 2
    check_tensor(x, "x", (N, fused.irreps_in.dim), torch.float32, dev)
    check_tensor(sh, "sh", (E, fused.J_dim), torch.float32, dev)
    check_tensor(edge_radial, "edge_radial", (E, R), torch.float32, dev)
    check_tensor(edge_src, "edge_src", (E,), torch.int64, dev)
    check_tensor(edge_dst, "edge_dst", (E,), torch.int64, dev)
    check_structure(conv, backward)
    if conv.path_table.device != dev:
        raise ValueError("FullConv tables are not on the input's device")
    n_w = R * H + (n_hidden - 1) * H * H
    check_tensor(w_hidden, "w_hidden", (n_w,), torch.float32, dev)
    check_tensor(w_out, "w_out", (H, PC), torch.float32, dev)
    check_tensor(wsel, "wsel", (conv.wsel_len,), torch.float32, dev)
    return dev, N, E


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
    out = torch.empty((N, conv.out_dim), dtype=torch.float32, device=dev)
    # work: the last hidden layer per edge, the long runs' pieces
    h_work = torch.empty((E, H), dtype=torch.float32, device=dev)
    pieces = torch.empty((T, conv.KM), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.full_conv_fwd(
            x.data_ptr(), N, fused.irreps_in.dim,
            sh.data_ptr(), fused.J_dim,
            edge_radial.data_ptr(), R,
            edge_src.data_ptr(), edge_dst.data_ptr(), E,
            w_hidden.data_ptr(), H, len(conv.fc_dims) - 2,
            w_out.data_ptr(), PC, conv.act_cst,
            conv.walk_table.data_ptr(), conv.walk_chunks.data_ptr(),
            conv.n_chunks, conv.walk_cells.data_ptr(),
            conv.walk_nz.data_ptr(), conv.max_chunk_nz,
            conv.max_d1, conv.max_d3,
            order.dst_perm.data_ptr(), order.dst_ptr.data_ptr(), cap, T,
            h_work.data_ptr(), pieces.data_ptr(),
            scratch.data_ptr(), conv.KM, fused.mul,
            wsel.data_ptr(), conv.prob_rows.ctypes.data, conv.n_probs,
            out.data_ptr(), conv.out_dim, stream,
        )
    check(err, "full_conv_fwd")
    FullConv.launches += 1
    return out, scratch


def launch_backward(conv, x, edge_radial, sh, edge_src, edge_dst, w_hidden,
                    w_out, wsel, num_nodes, scratch, gout, order=None):
    """Launch K2: ``(dx, d edge_radial, dw_hidden, dw_out, dwsel)``, all
    float32, from the forward's inputs, its scratch and ``gout``.
    ``order``: the edges' ``EdgeOrder``, built here when not given."""
    dev, N, E = _check_inputs(conv, x, edge_radial, sh, edge_src, edge_dst,
                              w_hidden, w_out, wsel, num_nodes,
                              backward=True)
    order = _order(order, edge_src, edge_dst, N)
    cap, T = walk_items(E, conv.n_chunks)
    check_tensor(scratch, "scratch", (N, conv.KM), torch.float32, dev)
    check_tensor(gout, "gout", (N, conv.out_dim), torch.float32, dev)
    fused = conv.fused
    R, H, PC = conv.fc_dims[0], conv.fc_dims[1], conv.fc_dims[-1]
    n_hidden = len(conv.fc_dims) - 2

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dx, der = empty(N, fused.irreps_in.dim), empty(E, R)
    dw_hidden, dw_out, dwsel = empty(w_hidden.numel()), empty(H, PC), \
        empty(conv.wsel_len)
    # work buffers: node cotangent of the scratch, per-edge radial-weight
    # cotangent, the MLP's pre-activations and activations, two rows, the
    # per-path dx rows and the long runs' pieces of them
    work = [empty(N, conv.KM), empty(E, PC), empty(n_hidden, E, H),
            empty(n_hidden, E, H), empty(E, H), empty(E, H),
            empty(N, conv.KMd), empty(T, conv.KMd)]
    ws = row_mix.workspace(dev, gout.numel())   # see row_mix.workspace
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.full_conv_bwd(
            x.data_ptr(), N, fused.irreps_in.dim,
            sh.data_ptr(), fused.J_dim,
            edge_radial.data_ptr(), R,
            edge_src.data_ptr(), edge_dst.data_ptr(), E,
            w_hidden.data_ptr(), H, n_hidden,
            w_out.data_ptr(), PC, conv.act_cst,
            conv.walk_table.data_ptr(), conv.walk_chunks.data_ptr(),
            conv.n_chunks, conv.walk_cells.data_ptr(),
            conv.walk_nz.data_ptr(), conv.max_chunk_nz,
            conv.max_d1, conv.max_d3,
            conv.walk_irreps.data_ptr(), conv.n_walk_irreps, conv.KMd,
            int(conv.dx_covered),
            order.src_perm.data_ptr(), order.src_ptr.data_ptr(), cap, T,
            scratch.data_ptr(), conv.KM, fused.mul,
            wsel.data_ptr(), conv.wsel_len,
            conv.prob_rows.ctypes.data, conv.n_probs,
            gout.data_ptr(), conv.out_dim,
            *(t.data_ptr() for t in work),
            dx.data_ptr(), der.data_ptr(), dw_hidden.data_ptr(),
            w_hidden.numel(), dw_out.data_ptr(), dwsel.data_ptr(),
            ws.data_ptr(), ws.numel(), stream,
        )
    check(err, "full_conv_bwd")
    FullConv.backward_launches += 1
    return dx, der, dw_hidden, dw_out, dwsel
