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

Autograd mirrors ``f2`` / ``g2`` of ``_make_pallas_fn_ext``
(``fused_conv.py:1871-2191``): ``FullConvExtFunction`` launches K4f and its
backward is ``FullConvExtBwdFunction``, whose forward launches K4b (dx, dsh,
dw, dwsel: the forces) and whose backward takes the second-order cotangents.
With cotangents on dx, dsh and dw and none on dwsel (a force-training step,
every layer whose input depends on positions) it launches K4g; otherwise it
takes the pairing rule of the 4-linear core: one K4b call with the cotangent
substituted into its operand slot, and one K4f call, per live slot.  A third
differentiation raises.

Every edge is treated alike (padded edges included): the second-order rule
substitutes cotangents that are not masked into the ``w`` and ``sh`` slots,
so forward and backward must be exact adjoints.  Edges with an endpoint
outside [0, N) are dropped by all three kernels, as by K1.

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

from . import row_mix
from .build import check, check_tensor, load_library
from .full_conv import MAX_SH, ConvTables

MAX_D = 7  # components of an l <= 3 irrep (the edge sweep's register rows)


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
        if x.device.type == "cpu":
            return self.fused(linear, x, edge_src, edge_dst, sh, w,
                              num_nodes, pre_scale)
        return self.launch(linear, x, sh, w, edge_src, edge_dst, num_nodes,
                           pre_scale)

    def launch(self, linear, x, sh, w, edge_src, edge_dst, num_nodes,
               pre_scale=None):
        """The kernel path: the flat mix matrices in plain PyTorch, then
        K4f through ``FullConvExtFunction``."""
        return FullConvExtFunction.apply(
            self, x.contiguous(), sh.contiguous(), w.contiguous(),
            self.flat_wsel(linear, pre_scale), edge_src, edge_dst,
            int(num_nodes))

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
    """K4f forward; the backward is ``FullConvExtBwdFunction`` (K4b), so a
    ``create_graph`` backward records the forces for a second one."""

    @staticmethod
    def forward(ctx, conv, x, sh, w, wsel, edge_src, edge_dst, num_nodes):
        ctx.save_for_backward(x, sh, w, wsel, edge_src, edge_dst)
        ctx.conv, ctx.num_nodes = conv, num_nodes
        return launch_forward(conv, x, sh, w, wsel, edge_src, edge_dst,
                              num_nodes)

    @staticmethod
    def backward(ctx, gout):
        x, sh, w, wsel, src, dst = ctx.saved_tensors
        grads = FullConvExtBwdFunction.apply(
            ctx.conv, x, sh, w, wsel, src, dst, ctx.num_nodes,
            gout.contiguous())
        return (None, *grads, None, None, None)


class FullConvExtBwdFunction(torch.autograd.Function):
    """K4b forward: ``(dx, dsh, dw, dwsel)``.  Backward: K4g when the
    cotangents of dx, dsh and dw are live and dwsel's is absent, else the
    pairing rule (``_make_pallas_fn_ext``'s ``g2_bwd``).  Outputs without a
    cotangent arrive as None (``set_materialize_grads(False)``, the
    counterpart of JAX's symbolic zeros)."""

    @staticmethod
    def forward(ctx, conv, x, sh, w, wsel, edge_src, edge_dst, num_nodes,
                gout):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, sh, w, wsel, edge_src, edge_dst, gout)
        ctx.conv, ctx.num_nodes = conv, num_nodes
        return launch_backward(conv, x, sh, w, wsel, edge_src, edge_dst,
                               num_nodes, gout)

    @staticmethod
    def backward(ctx, cx, csh, cw, cwsel):
        x, sh, w, wsel, src, dst, gout = ctx.saved_tensors
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
                conv, x, cx, sh, csh, w, cw, wsel, src, dst, N, gout)
            return None, c_x, c_s, c_w, c_m, None, None, None, c_g
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
            b = launch_backward(conv, *ops, src, dst, N, gout)
            for j in range(4):
                if j != i:
                    parts[j].append(b[j])
            f = launch_forward(conv, *ops, src, dst, N)
            c_g = f if c_g is None else c_g + f
        c_x, c_s, c_w, c_m = (sum(p[1:], p[0]) if p else None
                              for p in parts)
        return None, c_x, c_s, c_w, c_m, None, None, None, c_g


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
    mul = fused.mul
    lanes = min(mul, 32)
    if not (fused.J_dim <= MAX_SH and conv.max_d1 <= MAX_D
            and mul * 4 <= 1024 and lanes & (lanes - 1) == 0
            and mul % lanes == 0):
        raise ValueError(f"FullConvExt kernel does not take J={fused.J_dim},"
                         f" mul={mul}, max d1={conv.max_d1}")
    if conv.path_table.device != dev:
        raise ValueError("FullConvExt tables are not on the input's device")
    return dev, N, E


def _call(name, conv, dev, edge_src, edge_dst, N, E, *rest):
    """Launch one C entry point with the arguments all three take first
    (sizes, edge list, tables), then ``rest`` (tensors and ints), on the
    current stream of ``dev``."""
    fused = conv.fused
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(
            N, fused.irreps_in.dim, fused.J_dim,
            edge_src.data_ptr(), edge_dst.data_ptr(), E,
            fused.weight_numel, conv.path_table.data_ptr(), conv.n_paths,
            conv.nz_idx.data_ptr(), conv.nz_c.data_ptr(), conv.KM, fused.mul,
            conv.prob_rows.ctypes.data, conv.n_probs, conv.out_dim,
            *(t if isinstance(t, int) else t.data_ptr() for t in rest),
            stream)
    check(err, name)


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def launch_forward(conv, x, sh, w, wsel, edge_src, edge_dst, num_nodes):
    """Launch K4f: ``out [N, out_dim]``."""
    dev, N, E = _check_inputs(conv, x, sh, w, wsel, edge_src, edge_dst,
                              num_nodes)
    scratch = _empty(dev, N, conv.KM)
    out = _empty(dev, N, conv.out_dim)
    _call("full_conv_ext_fwd", conv, dev, edge_src, edge_dst, N, E,
          x, sh, w, wsel, scratch, out)
    FullConvExt.launches_fwd += 1
    return out


def launch_backward(conv, x, sh, w, wsel, edge_src, edge_dst, num_nodes,
                    gout):
    """Launch K4b: ``(dx, dsh, dw, dwsel)``, all float32, for the cotangent
    ``gout``; the scratch of these operands is recomputed (in the pairing
    rule they are substituted, so no saved forward scratch would do)."""
    dev, N, E = _check_inputs(conv, x, sh, w, wsel, edge_src, edge_dst,
                              num_nodes)
    check_tensor(gout, "gout", (N, conv.out_dim), torch.float32, dev)
    scratch, dS = _empty(dev, N, conv.KM), _empty(dev, N, conv.KM)
    dx, dsh = _empty(dev, *x.shape), _empty(dev, *sh.shape)
    dw, dwsel = _empty(dev, *w.shape), _empty(dev, conv.wsel_len)
    ws = row_mix.workspace(dev, gout.numel())   # see row_mix.workspace
    _call("full_conv_ext_bwd", conv, dev, edge_src, edge_dst, N, E,
          x, sh, w, wsel, gout, scratch, dS, dx, dsh, dw, dwsel,
          conv.wsel_len, ws, ws.numel())
    FullConvExt.launches_bwd += 1
    return dx, dsh, dw, dwsel


def launch_grad2(conv, x, cx, sh, csh, w, cw, wsel, edge_src, edge_dst,
                 num_nodes, gout):
    """Launch K4g: ``(c_x, c_s, c_w, c_m, c_g)``, all float32."""
    dev, N, E = _check_inputs(conv, x, sh, w, wsel, edge_src, edge_dst,
                              num_nodes)
    check_tensor(cx, "cx", tuple(x.shape), torch.float32, dev)
    check_tensor(csh, "csh", tuple(sh.shape), torch.float32, dev)
    check_tensor(cw, "cw", tuple(w.shape), torch.float32, dev)
    check_tensor(gout, "gout", (N, conv.out_dim), torch.float32, dev)
    scratch, dS = _empty(dev, N, conv.KM), _empty(dev, N, conv.KM)
    c_x, c_s = _empty(dev, *x.shape), _empty(dev, *sh.shape)
    c_w, c_m = _empty(dev, *w.shape), _empty(dev, conv.wsel_len)
    c_g = _empty(dev, N, conv.out_dim)
    ws = row_mix.workspace(dev, gout.numel())   # see row_mix.workspace
    _call("full_conv_ext_grad2", conv, dev, edge_src, edge_dst, N, E,
          x, cx, sh, csh, w, cw, wsel, gout, scratch, dS, c_x, c_s, c_w,
          c_m, c_g, conv.wsel_len, ws, ws.numel())
    FullConvExt.launches_grad2 += 1
    return c_x, c_s, c_w, c_m, c_g
