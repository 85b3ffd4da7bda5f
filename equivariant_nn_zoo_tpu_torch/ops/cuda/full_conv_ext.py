"""K4f, K4b and K4g: the external-weight convolution core of the force path,
its VJP and its one-pass second-order backward, around
``csrc/full_conv_ext.cu``.

The kernels replace the TPU kernels ``PallasFullConv._full_fwd_kernel_ext``,
``_full_bwd_kernel_ext`` and ``_grad2_fused_kernel``
(``equivariant_nn_zoo_tpu/ops/pallas/fused_conv.py:1348``, ``:1432`` and
``:1618``).  On ``grad_order >= 2`` the radial MLP runs outside the kernels,
in PyTorch, so autograd differentiates it to any order; the kernels see the
4-linear core

    F(x, sh, w, wsel)[n] = Mix_wsel( sum_{e: dst_e = n}
                                      w_e (.) CG(x[src_e] (x) sh_e) )

with per-edge radial weights ``w [E, P * mul]`` (columns in the expansion's
instruction order) and the flat mix matrices ``wsel`` (alphas and
``1/sqrt(avg_num_neighbors)`` folded in, ``ConvTables.flat_wsel``).  Row and
table conventions are K1's (``ConvTables``).

The edge work is K1's and K2's node-major walks (``csrc/edge_walk.cuh``)
with external radial weights: the destination-major walk sums each node's
incoming messages into the scratch S (K4f; K4g's S_sum; K4b's S when no
saved one is given), the source-major walk gathers dS[dst] and sums each
node's dx rows, writes dw per edge and reduces dsh over the channels in the
block (K4b; K4g's c_x, c_w, c_s).  Both walk the ``EdgeOrder`` that
``edge_order.shared`` builds once per set of edges, so the trunk's five
layers of a forward share one; each node's sums are stored once with plain
stores, with no atomics, so every output repeats bit for bit.  The walks
are bound by instruction issue and latency between their barriers, at
0.06-0.09 of the entries' byte bound on an H100 (the note in
``csrc/full_conv_ext.cu`` has the parts' shares).

Autograd mirrors ``f2`` / ``g2`` of ``_make_pallas_fn_ext``
(``fused_conv.py:1871-2191``): ``FullConvExtFunction`` launches K4f, saves
its scratch S and the edge order, and its backward is
``FullConvExtBwdFunction``, whose forward launches K4b (dx, dsh, dw, dwsel:
the forces) on the saved S and order, and whose backward takes the
second-order cotangents.  With cotangents on dx, dsh and dw and none on
dwsel (a force-training step, every layer whose input depends on
positions) it launches K4g; otherwise it takes the pairing rule of the
4-linear core: one K4b call with the cotangent substituted into its operand
slot (so S is recomputed: no saved scratch is of those operands), and one
K4f call, per live slot.  A third differentiation raises.

Every edge is treated alike (padded edges included): the second-order rule
substitutes cotangents that are not masked into the ``w`` and ``sh`` slots,
so forward and backward must be exact adjoints.  Edges with an endpoint
outside [0, N) are dropped by all three kernels, as by K1; their per-edge
outputs are zero.

For tensors on the CPU the conv runs ``FusedUVUConv`` on the external
weights and autograd differentiates it; for CUDA tensors it goes through
the Functions or raises.  ``plain_forward``, ``plain_backward`` and
``plain_grad2`` are plain PyTorch versions of the three kernels' contracts
(autograd of ``ConvTables.plain_core``), for the tests and the on-card
checks.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import edge_order, row_mix
from .build import check, check_tensor, load_library
from .full_conv import MAX_SH, WALK_GROUPS, ConvTables, _order, walk_items

MAX_D = 7  # components of an l <= 3 irrep (the walks' register rows)


class FullConvExt(ConvTables):
    """The force path's conv core for one ``FactorizedConvolution``; the
    expansion's mix ``Linear`` is passed at call time, the radial weights
    come from the caller's MLP."""

    #: kernel launches, over all instances (the main path's proof of use)
    launches_fwd = 0
    launches_bwd = 0
    launches_grad2 = 0

    def forward(self, linear, x: torch.Tensor, sh: torch.Tensor,
                w: torch.Tensor, edge_src: torch.Tensor,
                edge_dst: torch.Tensor, num_nodes: int,
                pre_scale: Optional[float] = None) -> torch.Tensor:
        """x [N, in_dim] (already linear_1'd), sh [E, J], radial weights
        w [E, P * mul], edge_src / edge_dst [E] -> [N, out_dim]."""
        if self.uses_kernel(x):
            return self.launch(linear, x, sh, w, edge_src, edge_dst,
                               num_nodes, pre_scale)
        return self.fused(linear, x, edge_src, edge_dst, sh, w, num_nodes,
                          pre_scale)

    def launch(self, linear, x, sh, w, edge_src, edge_dst, num_nodes,
               pre_scale=None):
        """The kernel path: the edge orders (``edge_order.shared``: one per
        set of edges, so once per model forward), the flat mix matrices in
        plain PyTorch, then K4f through ``FullConvExtFunction``."""
        order = edge_order.shared(edge_src, edge_dst, num_nodes)
        return FullConvExtFunction.apply(
            self, x.contiguous(), sh.contiguous(), w.contiguous(),
            self.flat_wsel(linear, pre_scale), edge_src, edge_dst,
            int(num_nodes), order)

    def plain_forward(self, x, sh, w, wsel, edge_src, edge_dst, num_nodes):
        """Plain PyTorch version of K4f's contract: ``out [N, out_dim]``."""
        return self.plain_core(x, sh, w, wsel, edge_src, edge_dst,
                               num_nodes)[0]

    def plain_backward(self, x, sh, w, wsel, edge_src, edge_dst, num_nodes,
                       gout):
        """Plain PyTorch version of K4b's contract: ``(dx, dsh, dw,
        dwsel)`` for the cotangent ``gout``, by autograd of
        ``plain_forward``."""
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (x, sh, w, wsel)]
            out = self.plain_forward(*ins, edge_src, edge_dst, num_nodes)
            return torch.autograd.grad(out, ins, gout)

    def plain_grad2(self, x, cx, sh, csh, w, cw, wsel, edge_src, edge_dst,
                    num_nodes, gout):
        """Plain PyTorch version of K4g's contract: ``(c_x, c_s, c_w, c_m,
        c_g)``, the cotangents of ``(x, sh, w, wsel, gout)`` that the
        cotangents ``(cx, csh, cw)`` on K4b's ``(dx, dsh, dw)`` give, by
        double autograd of ``plain_forward``."""
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True)
                   for t in (x, sh, w, wsel, gout)]
            out = self.plain_forward(*ins[:4], edge_src, edge_dst, num_nodes)
            first = torch.autograd.grad(out, ins[:3], ins[4],
                                        create_graph=True)
            inner = sum((a * c).sum() for a, c in zip(first, (cx, csh, cw)))
            return torch.autograd.grad(inner, ins)


class FullConvExtFunction(torch.autograd.Function):
    """K4f forward, on one edge order; it saves K4f's scratch S and the
    order for the backward, ``FullConvExtBwdFunction`` (K4b), so a
    ``create_graph`` backward records the forces for a second one."""

    @staticmethod
    def forward(ctx, conv, x, sh, w, wsel, edge_src, edge_dst, num_nodes,
                order):
        out, scratch = launch_forward(conv, x, sh, w, wsel, edge_src,
                                      edge_dst, num_nodes, order=order)
        ctx.save_for_backward(x, sh, w, wsel, edge_src, edge_dst, scratch,
                              *order)
        ctx.conv, ctx.num_nodes = conv, num_nodes
        return out

    @staticmethod
    def backward(ctx, gout):
        x, sh, w, wsel, src, dst, scratch, *order = ctx.saved_tensors
        grads = FullConvExtBwdFunction.apply(
            ctx.conv, x, sh, w, wsel, src, dst, ctx.num_nodes,
            gout.contiguous(), edge_order.EdgeOrder(*order), scratch)
        return (None, *grads, None, None, None, None)


class FullConvExtBwdFunction(torch.autograd.Function):
    """K4b forward: ``(dx, dsh, dw, dwsel)``, on K4f's saved scratch of the
    same operands.  Backward: K4g when the cotangents of dx, dsh and dw are
    live and dwsel's is absent, else the pairing rule
    (``_make_pallas_fn_ext``'s ``g2_bwd``), whose K4b calls take
    substituted operands and so recompute their scratch.  Outputs without a
    cotangent arrive as None (``set_materialize_grads(False)``, the
    counterpart of JAX's symbolic zeros)."""

    @staticmethod
    def forward(ctx, conv, x, sh, w, wsel, edge_src, edge_dst, num_nodes,
                gout, order, scratch):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, sh, w, wsel, edge_src, edge_dst, gout,
                              *order)
        ctx.conv, ctx.num_nodes = conv, num_nodes
        return launch_backward(conv, x, sh, w, wsel, edge_src, edge_dst,
                               num_nodes, gout, order=order, scratch=scratch)

    @staticmethod
    def backward(ctx, cx, csh, cw, cwsel):
        x, sh, w, wsel, src, dst, gout, *order = ctx.saved_tensors
        order = edge_order.EdgeOrder(*order)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, sh, w, wsel, gout)):
            raise NotImplementedError(
                "FullConvExt: third-order autodiff is not provided")
        conv, N = ctx.conv, ctx.num_nodes
        cots = [None if c is None else c.contiguous()
                for c in (cx, csh, cw, cwsel)]
        cx, csh, cw, cwsel = cots
        if cx is not None and csh is not None and cw is not None \
                and cwsel is None:
            c_x, c_s, c_w, c_m, c_g = launch_grad2(
                conv, x, cx, sh, csh, w, cw, wsel, src, dst, N, gout,
                order=order)
            return (None, c_x, c_s, c_w, c_m, None, None, None, c_g, None,
                    None)
        # pairing rule: slot i's cotangent substituted into operand slot i
        # gives, through one K4b call, the cross terms of the other three
        # slots, and through one K4f call its share of gout's cotangent
        prims = (x, sh, w, wsel)
        parts = [[] for _ in range(4)]
        c_g = None
        for i, c in enumerate(cots):
            if c is None:
                continue
            ops = list(prims)
            ops[i] = c
            b = launch_backward(conv, *ops, src, dst, N, gout, order=order)
            for j in range(4):
                if j != i:
                    parts[j].append(b[j])
            f = launch_forward(conv, *ops, src, dst, N, order=order)[0]
            c_g = f if c_g is None else c_g + f
        c_x, c_s, c_w, c_m = (sum(p[1:], p[0]) if p else None
                              for p in parts)
        return None, c_x, c_s, c_w, c_m, None, None, None, c_g, None, None


def _check_inputs(conv, x, sh, w, wsel, edge_src, edge_dst, num_nodes):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"FullConvExt kernel needs CUDA tensors, got {dev}")
    fused = conv.fused
    N, E = int(num_nodes), sh.shape[0]
    check_tensor(x, "x", (N, fused.irreps_in.dim), torch.float32, dev)
    check_tensor(sh, "sh", (E, fused.J_dim), torch.float32, dev)
    check_tensor(w, "w", (E, fused.weight_numel), torch.float32, dev)
    check_tensor(wsel, "wsel", (conv.wsel_len,), torch.float32, dev)
    check_tensor(edge_src, "edge_src", (E,), torch.int64, dev)
    check_tensor(edge_dst, "edge_dst", (E,), torch.int64, dev)
    # the walks: one block of mul x WALK_GROUPS threads (at most 256), the
    # dsh shares summed over lane groups of min(mul, 32) lanes
    mul = fused.mul
    lanes = min(mul, 32)
    if not (fused.J_dim <= MAX_SH
            and max(conv.max_d1, conv.max_d2, conv.max_d3) <= MAX_D
            and 8 <= mul and mul * WALK_GROUPS <= 256
            and lanes & (lanes - 1) == 0 and mul % lanes == 0):
        raise ValueError(f"FullConvExt kernel does not take J={fused.J_dim},"
                         f" mul={mul}, max d1={conv.max_d1}")
    if conv.walk_table.device != dev:
        raise ValueError("FullConvExt tables are not on the input's device")
    return dev, N, E


def _call(name, conv, dev, edge_src, edge_dst, N, E, order, *rest):
    """Launch one C entry point with the arguments all three take first
    (sizes, edge list, walk tables, edge orders and work items), then
    ``rest`` (tensors, ints and None for a null pointer), on the current
    stream of ``dev``."""
    fused = conv.fused
    cap, T = walk_items(E, conv.n_chunks)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(
            N, fused.irreps_in.dim, fused.J_dim,
            edge_src.data_ptr(), edge_dst.data_ptr(), E,
            fused.weight_numel, conv.walk_table.data_ptr(),
            conv.walk_chunks.data_ptr(), conv.n_chunks,
            conv.walk_src_chunks.data_ptr(), conv.n_src_chunks,
            conv.walk_cells.data_ptr(), conv.walk_nz.data_ptr(),
            conv.max_chunk_nz, conv.max_d1, conv.max_d2, conv.max_d3,
            conv.walk_irreps.data_ptr(), conv.n_walk_irreps, conv.KMd,
            int(conv.dx_covered),
            *(t.data_ptr() for t in order), cap, T,
            conv.KM, fused.mul,
            conv.prob_rows.ctypes.data, conv.n_probs, conv.out_dim,
            *(t if isinstance(t, int) or t is None else t.data_ptr()
              for t in rest),
            stream)
    check(err, name)


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def _pieces(conv, dev, E, width):
    """The long runs' pieces buffer of a walk over rows ``width`` wide."""
    return _empty(dev, walk_items(E, conv.n_chunks)[1], width)


def launch_forward(conv, x, sh, w, wsel, edge_src, edge_dst, num_nodes,
                   order=None):
    """Launch K4f: ``(out [N, out_dim], scratch [N, K * mul])``, the scratch
    holding the unmixed node sums (K4b takes it back).  ``order``: the
    edges' ``EdgeOrder``, built here when not given."""
    dev, N, E = _check_inputs(conv, x, sh, w, wsel, edge_src, edge_dst,
                              num_nodes)
    order = _order(order, edge_src, edge_dst, N)
    scratch = _empty(dev, N, conv.KM)
    out = _empty(dev, N, conv.out_dim)
    _call("full_conv_ext_fwd", conv, dev, edge_src, edge_dst, N, E, order,
          x, sh, w, wsel, scratch, _pieces(conv, dev, E, conv.KM), out)
    FullConvExt.launches_fwd += 1
    return out, scratch


def _walk_work(conv, dev, N, E, scratch=True):
    """K4b's and K4g's work buffers: the scratch (None when not wanted), dS,
    the per-path dx rows, the long runs' pieces (of either walk) and the
    source-major walk's dsh rows of each of its chunks."""
    return (_empty(dev, N, conv.KM) if scratch else None,
            _empty(dev, N, conv.KM),
            _empty(dev, N, conv.KMd),
            _pieces(conv, dev, E, max(conv.KM, conv.KMd)),
            _empty(dev, conv.n_src_chunks, E, conv.fused.J_dim))


def launch_backward(conv, x, sh, w, wsel, edge_src, edge_dst, num_nodes,
                    gout, order=None, scratch=None):
    """Launch K4b: ``(dx, dsh, dw, dwsel)``, all float32, for the cotangent
    ``gout``.  ``scratch``: K4f's scratch of these same operands, or None
    (then recomputed); ``order``: the edges' ``EdgeOrder``, built here when
    not given."""
    dev, N, E = _check_inputs(conv, x, sh, w, wsel, edge_src, edge_dst,
                              num_nodes)
    check_tensor(gout, "gout", (N, conv.out_dim), torch.float32, dev)
    if scratch is not None:
        check_tensor(scratch, "scratch", (N, conv.KM), torch.float32, dev)
    order = _order(order, edge_src, edge_dst, N)
    dx, dsh = _empty(dev, *x.shape), _empty(dev, *sh.shape)
    dw, dwsel = _empty(dev, *w.shape), _empty(dev, conv.wsel_len)
    ws = row_mix.workspace(dev, gout.numel())   # see row_mix.workspace
    _call("full_conv_ext_bwd", conv, dev, edge_src, edge_dst, N, E, order,
          x, sh, w, wsel, gout, scratch,
          *_walk_work(conv, dev, N, E, scratch is None),
          dx, dsh, dw, dwsel, conv.wsel_len, ws, ws.numel())
    FullConvExt.launches_bwd += 1
    return dx, dsh, dw, dwsel


def launch_grad2(conv, x, cx, sh, csh, w, cw, wsel, edge_src, edge_dst,
                 num_nodes, gout, order=None):
    """Launch K4g: ``(c_x, c_s, c_w, c_m, c_g)``, all float32.  ``order``:
    the edges' ``EdgeOrder``, built here when not given."""
    dev, N, E = _check_inputs(conv, x, sh, w, wsel, edge_src, edge_dst,
                              num_nodes)
    check_tensor(cx, "cx", tuple(x.shape), torch.float32, dev)
    check_tensor(csh, "csh", tuple(sh.shape), torch.float32, dev)
    check_tensor(cw, "cw", tuple(w.shape), torch.float32, dev)
    check_tensor(gout, "gout", (N, conv.out_dim), torch.float32, dev)
    order = _order(order, edge_src, edge_dst, N)
    c_x, c_s = _empty(dev, *x.shape), _empty(dev, *sh.shape)
    c_w, c_m = _empty(dev, *w.shape), _empty(dev, conv.wsel_len)
    c_g = _empty(dev, N, conv.out_dim)
    ws = row_mix.workspace(dev, gout.numel())   # see row_mix.workspace
    _call("full_conv_ext_grad2", conv, dev, edge_src, edge_dst, N, E, order,
          x, cx, sh, csh, w, cw, wsel, gout, *_walk_work(conv, dev, N, E),
          c_x, c_s, c_w, c_m, c_g, conv.wsel_len, ws, ws.numel())
    FullConvExt.launches_grad2 += 1
    return c_x, c_s, c_w, c_m, c_g
