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

With ``compute_dtype="bfloat16"`` the core computes what the TPU kernels
compute at bfloat16 (``fused_conv.py:1348-1870`` and the casts of
``_make_pallas_fn_ext``, ``:2094-2188``): x, sh, w and the mix matrices
are bfloat16, every product is summed in float32 and rounded where the TPU
body rounds it, and the Functions round the cotangents and cast the
results where JAX's casts put them.  The contracts are the TPU body's
rounding points, not autograd of a rounded forward, so on the CPU too the
bfloat16 layer goes through the Functions, with ``plain_forward_bf16``,
``plain_backward_bf16`` and ``plain_grad2_bf16`` in place of the launches.
On the card K4f, K4b and K4g are the bfloat16 walks of
``csrc/bf16_walk.cuh`` (K1's and K2's, on the caller's radial weights; K4g
with its cotangents beside the operands; the sh cotangent summed over each
left irrep in the walk and over the irreps and channels by a second
pass).  A node's messages are summed in float32 and
rounded once, where the TPU kernel keeps its node accumulator in bfloat16
across windows (``:1427-1428``): the choice K1's bfloat16 port made.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..segment import segment_sum
from . import edge_order, row_mix
from .build import check, check_tensor, load_library
from .full_conv import (BF16, BF16_MAX_NT, MAX_SH, PLAIN_EDGES, WALK_GROUPS,
                        ConvTables, _order, mix_rows, round_bf16, walk_items)

MAX_D = 7  # components of an l <= 3 irrep (the walks' register rows)


class FullConvExt(ConvTables):
    """The force path's conv core for one ``FactorizedConvolution``; the
    expansion's mix ``Linear`` is passed at call time, the radial weights
    come from the caller's MLP."""

    #: kernel launches, over all instances (the main path's proof of use)
    launches_fwd = 0
    launches_bwd = 0
    launches_grad2 = 0
    bf16_launches_fwd = 0    # the bfloat16 variants' launches
    bf16_launches_bwd = 0
    bf16_launches_grad2 = 0

    def forward(self, linear, x: torch.Tensor, sh: torch.Tensor,
                w: torch.Tensor, edge_src: torch.Tensor,
                edge_dst: torch.Tensor, num_nodes: int,
                pre_scale: Optional[float] = None) -> torch.Tensor:
        """x [N, in_dim] (already linear_1'd), sh [E, J], radial weights
        w [E, P * mul], edge_src / edge_dst [E] -> [N, out_dim] (at
        bfloat16: x, sh and w rounded, as ``apply_grad2`` rounds them,
        ``fused_conv.py:2221, 2239, 2509``; the output bfloat16)."""
        if self.uses_kernel(x):
            return self.launch(linear, x, sh, w, edge_src, edge_dst,
                               num_nodes, pre_scale)
        if self.bf16:
            return self.launch(linear, x, sh, w, edge_src, edge_dst,
                               num_nodes, pre_scale, kernel=False)
        return self.fused(linear, x, edge_src, edge_dst, sh, w, num_nodes,
                          pre_scale)

    def launch(self, linear, x, sh, w, edge_src, edge_dst, num_nodes,
               pre_scale=None, kernel=True):
        """The kernel path: the edge orders (``edge_order.shared``: one per
        set of edges, so once per model forward), the flat mix matrices in
        plain PyTorch, then K4f through ``FullConvExtFunction``; without
        ``kernel`` (bfloat16 on the CPU) the Functions on the plain
        contracts."""
        order = (edge_order.shared(edge_src, edge_dst, num_nodes) if kernel
                 else None)
        if self.bf16:
            x, sh, w = (t.to(BF16) for t in (x, sh, w))
        return FullConvExtFunction.apply(
            self, x.contiguous(), sh.contiguous(), w.contiguous(),
            self.flat_wsel(linear, pre_scale), edge_src, edge_dst,
            int(num_nodes), order, kernel)

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


    # ------------------------------------------------ bfloat16 contracts
    def _w_rows(self, w):
        """w [E, P * mul] -> [E, K, mul] float32, each row k its path's
        radial weights."""
        return w.float().reshape(w.shape[0], -1, self.fused.mul)[
            :, self.bf16_widx]

    def _scratch_rows(self, t):
        """[E, K, mul] in path order -> [E, K * mul] in scratch order."""
        mul, E = self.fused.mul, t.shape[0]
        cols = (self.bf16_srow[:, None] * mul
                + torch.arange(mul, device=t.device)).reshape(-1)
        return t.new_zeros((E, self.KM)).index_copy(1, cols,
                                                    t.reshape(E, -1))

    def _gather_rows(self, dS, dst):
        """dS [N, K * mul] at the edges' destinations -> [E, K, mul] in
        path order."""
        mul = self.fused.mul
        cols = (self.bf16_srow[:, None] * mul
                + torch.arange(mul, device=dS.device)).reshape(-1)
        return dS[dst][:, cols].reshape(dst.shape[0], -1, mul)

    def _dw_sums(self, dwp):
        """[E, K, mul] bfloat16 products -> dw [E, P * mul]: per path the
        bfloat16 sum over its components in order (``:1549-1562``)."""
        E, mul = dwp.shape[0], self.fused.mul
        dw = dwp.new_zeros((E, self.fused.weight_numel // mul, mul))
        k = 0
        for ir, k0, n_paths, d, p0 in self.fused.groups:
            blk = dwp[:, k: k + n_paths * d].reshape(E, n_paths, d, mul)
            acc = blk[:, :, 0]
            for dd in range(1, d):
                acc = round_bf16(acc + blk[:, :, dd])
            dw[:, self.bf16_widx[k: k + n_paths * d: d]] = acc
            k += n_paths * d
        return dw.reshape(E, -1)

    def _douter_bf16(self, dmid):
        """douter = bf16(C^T dmid) (``_douter_of``, ``:879-905``): [E, K,
        mul] -> [E, J, I, mul]."""
        return round_bf16(torch.einsum("jki,eku->ejiu", self.bf16_C, dmid))

    @staticmethod
    def _dx_sum(terms):
        """dx_e: the bfloat16 sum over j in order of terms [E, J, I, mul]
        (``:1597-1601``)."""
        acc = terms[:, 0]
        for j in range(1, terms.shape[1]):
            acc = round_bf16(acc + terms[:, j])
        return acc

    @staticmethod
    def _channel_sums(do, xs):
        """bf16(sum_i bf16(do * x)) [E, J, mul] (``jnp.sum`` of bfloat16
        products, which sums in float32 and rounds)."""
        return round_bf16(round_bf16(do * xs[:, None]).sum(2))

    def _mix_adjoint_bf16(self, scratch, wsel, gout):
        """(dS = bf16(gout wsel^T), dwsel = bf16(S)^T gout float32): the
        mix adjoint of the rounded node sums (``:1479-1511, 1570-1590``);
        ``scratch`` None: dS alone."""
        if scratch is None:
            scratch = gout.new_zeros((gout.shape[0], self.KM),
                                     dtype=torch.float32)
        with torch.enable_grad():
            S = round_bf16(scratch.detach()).requires_grad_(True)
            ws = wsel.detach().float().requires_grad_(True)
            out = mix_rows(S, ws, self.prob_rows, self.out_dim)
            dS, dwsel = torch.autograd.grad(out, (S, ws), gout.float())
        return round_bf16(dS), dwsel

    def _chunks(self, E):
        return [slice(e0, e0 + PLAIN_EDGES)
                for e0 in range(0, E, PLAIN_EDGES)]

    def plain_forward_bf16(self, x, sh, w, wsel, edge_src, edge_dst,
                           num_nodes):
        """Plain PyTorch version of K4f's bfloat16 contract
        (``fused_conv.py:1366-1428``): ``(out [N, out_dim] bfloat16, scratch
        [N, K * mul] float32)``.  Per edge w2d = bf16(mid * w), mid =
        bf16(C . bf16(sh_j x_i)); the node sums in float32 (the scratch),
        rounded before the mix, the mix summed in float32 over the
        bfloat16 matrices, the output rounded."""
        N = int(num_nodes)
        xT, shf = self._x_table(x.float()), sh.float()
        scratch = shf.new_zeros((N, self.KM))
        for e in self._chunks(sh.shape[0]):
            mid = self._mid_bf16(xT, shf[e], edge_src[e])
            w2d = round_bf16(mid * self._w_rows(w[e]))
            scratch = scratch + segment_sum(self._scratch_rows(w2d),
                                            edge_dst[e], N)
        out = mix_rows(round_bf16(scratch), wsel.float(), self.prob_rows,
                       self.out_dim)
        return out.to(BF16), scratch

    def plain_backward_bf16(self, x, sh, w, wsel, edge_src, edge_dst,
                            num_nodes, gout, scratch=None):
        """Plain PyTorch version of K4b's bfloat16 contract, the TPU body's
        rounding points (``fused_conv.py:1479-1614``): ``(dx float32, dsh
        bfloat16, dw bfloat16, dwsel float32)`` as the kernel leaves them
        (the Function casts dx and dwsel, ``:2181-2188``).  ``scratch``:
        K4f's scratch of these operands, or None (recomputed).

        dS = bf16(gout wsel^T); per edge g = dS[dst], mid recomputed; dw
        = the bfloat16 sum over a path's components of bf16(g mid); dmid
        = bf16(g w); douter = bf16(C^T dmid); dx_e = the bfloat16 sum over
        j in order of bf16(sh_j douter_j), summed over a node's edges in
        float32; dsh_j = bf16(sum_u bf16(sum_i bf16(douter_j x)));
        dwsel = bf16(S)^T gout."""
        N = int(num_nodes)
        if scratch is None:
            scratch = self.plain_forward_bf16(x, sh, w, wsel, edge_src,
                                              edge_dst, N)[1]
        dS, dwsel = self._mix_adjoint_bf16(scratch, wsel, gout)
        xT, shf = self._x_table(x.float()), sh.float()
        dxT = xT.new_zeros(xT.shape)
        dshs, dws = [], []
        for e in self._chunks(sh.shape[0]):
            src, xs = edge_src[e], xT[edge_src[e]]
            mid = self._mid_bf16(xT, shf[e], src)
            gv = self._gather_rows(dS, edge_dst[e])
            dws.append(self._dw_sums(round_bf16(gv * mid)))
            do = self._douter_bf16(round_bf16(gv * self._w_rows(w[e])))
            dxe = self._dx_sum(round_bf16(shf[e][:, :, None, None] * do))
            dxT = dxT + segment_sum(dxe, src, N)
            dshs.append(round_bf16(self._channel_sums(do, xs).sum(-1)))
        return (self._x_columns(dxT), self._cat(dshs, sh).to(BF16),
                self._cat(dws, w).to(BF16), dwsel)

    def plain_grad2_bf16(self, x, cx, sh, csh, w, cw, wsel, edge_src,
                         edge_dst, num_nodes, gout):
        """Plain PyTorch version of K4g's bfloat16 contract
        (``fused_conv.py:1660-1870``): ``(c_x float32, c_s bfloat16, c_w
        bfloat16, c_m float32, c_g bfloat16)`` as the kernel leaves them
        (the Function casts c_x and c_m, ``:2121-2126``).

        With mid_a, mid_b, mid_c the rounded CG products of (cx, sh),
        (x, csh), (x, sh) and ab = bf16(mid_a + mid_b): per edge w2d =
        bf16(bf16(ab w) + bf16(mid_c cw)) summed per node in float32 into
        S, c_g = mix(bf16(S)) rounded, c_m = bf16(S)^T gout; c_w = the
        bfloat16 sum over a path's components of bf16(g ab); dow, doc =
        bf16(C^T bf16(g w)), bf16(C^T bf16(g cw)); c_x_e = the bfloat16
        sum over j of bf16(bf16(csh_j dow_j) + bf16(sh_j doc_j)), summed
        over a node's edges in float32; c_s_j = bf16(sum_u bf16(bf16(sum_i
        bf16(dow_j cx)) + bf16(sum_i bf16(doc_j x))))."""
        N = int(num_nodes)
        dS, _ = self._mix_adjoint_bf16(None, wsel, gout)
        xT, cxT = self._x_table(x.float()), self._x_table(cx.float())
        shf, cshf = sh.float(), csh.float()
        S, dxT = shf.new_zeros((N, self.KM)), xT.new_zeros(xT.shape)
        css, cws = [], []
        for e in self._chunks(sh.shape[0]):
            src = edge_src[e]
            ab = round_bf16(self._mid_bf16(cxT, shf[e], src)
                            + self._mid_bf16(xT, cshf[e], src))
            mid_c = self._mid_bf16(xT, shf[e], src)
            ww, wc = self._w_rows(w[e]), self._w_rows(cw[e])
            w2d = round_bf16(round_bf16(ab * ww) + round_bf16(mid_c * wc))
            S = S + segment_sum(self._scratch_rows(w2d), edge_dst[e], N)
            gv = self._gather_rows(dS, edge_dst[e])
            cws.append(self._dw_sums(round_bf16(gv * ab)))
            dow = self._douter_bf16(round_bf16(gv * ww))
            doc = self._douter_bf16(round_bf16(gv * wc))
            terms = round_bf16(
                round_bf16(cshf[e][:, :, None, None] * dow)
                + round_bf16(shf[e][:, :, None, None] * doc))
            dxT = dxT + segment_sum(self._dx_sum(terms), src, N)
            v = round_bf16(self._channel_sums(dow, cxT[src])
                           + self._channel_sums(doc, xT[src]))
            css.append(round_bf16(v.sum(-1)))
        c_g = mix_rows(round_bf16(S), wsel.float(), self.prob_rows,
                       self.out_dim).to(BF16)
        _, c_m = self._mix_adjoint_bf16(S, wsel, gout)
        return (self._x_columns(dxT), self._cat(css, sh).to(BF16),
                self._cat(cws, w).to(BF16), c_m, c_g)

    @staticmethod
    def _cat(parts, like):
        return torch.cat(parts) if parts else like.new_zeros(like.shape)


def _plain_forward(conv, *args, order=None):
    return conv.plain_forward_bf16(*args)


def _plain_backward(conv, *args, order=None, scratch=None):
    return conv.plain_backward_bf16(*args, scratch=scratch)


def _plain_grad2(conv, *args, order=None):
    return conv.plain_grad2_bf16(*args)


def _runs(kernel: bool):
    """The launches of K4f, K4b and K4g, or for CPU tensors at bfloat16
    their plain contracts (read at call time, so that a test may route
    the launches)."""
    if kernel:
        return launch_forward, launch_backward, launch_grad2
    return _plain_forward, _plain_backward, _plain_grad2


def _order_of(saved):
    return edge_order.EdgeOrder(*saved) if saved else None


class FullConvExtFunction(torch.autograd.Function):
    """K4f forward, on one edge order; it saves K4f's scratch S and the
    order for the backward, ``FullConvExtBwdFunction`` (K4b), so a
    ``create_graph`` backward records the forces for a second one."""

    @staticmethod
    def forward(ctx, conv, x, sh, w, wsel, edge_src, edge_dst, num_nodes,
                order, kernel=True):
        out, scratch = _runs(kernel)[0](conv, x, sh, w, wsel, edge_src,
                                        edge_dst, num_nodes, order=order)
        ctx.save_for_backward(x, sh, w, wsel, edge_src, edge_dst, scratch,
                              *(order if order is not None else ()))
        ctx.conv, ctx.num_nodes, ctx.kernel = conv, num_nodes, kernel
        return out

    @staticmethod
    def backward(ctx, gout):
        x, sh, w, wsel, src, dst, scratch, *order = ctx.saved_tensors
        grads = FullConvExtBwdFunction.apply(
            ctx.conv, x, sh, w, wsel, src, dst, ctx.num_nodes,
            gout.contiguous(), _order_of(order), scratch, ctx.kernel)
        # K4b leaves dx and dwsel in float32 at bfloat16; they take their
        # inputs' dtypes as f2_bwd casts them (fused_conv.py:2184-2187)
        grads = [g.to(t.dtype) for g, t in zip(grads, (x, sh, w, wsel))]
        return (None, *grads, None, None, None, None, None)


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
                gout, order, scratch, kernel=True):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, sh, w, wsel, edge_src, edge_dst, gout,
                              *(order if order is not None else ()))
        ctx.conv, ctx.num_nodes, ctx.kernel = conv, num_nodes, kernel
        return _runs(kernel)[1](conv, x, sh, w, wsel, edge_src, edge_dst,
                                num_nodes, gout, order=order,
                                scratch=scratch)

    @staticmethod
    def backward(ctx, cx, csh, cw, cwsel):
        x, sh, w, wsel, src, dst, gout, *order = ctx.saved_tensors
        order = _order_of(order)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, sh, w, wsel, gout)):
            raise NotImplementedError(
                "FullConvExt: third-order autodiff is not provided")
        conv, N = ctx.conv, ctx.num_nodes
        run_fwd, run_bwd, run_grad2 = _runs(ctx.kernel)
        # at bfloat16 the cotangents are rounded as g2_bwd rounds them
        # (fused_conv.py:2107-2114), and the results take the dtypes of
        # the operands (:2121-2126, 2162-2167)
        cots = [None if c is None else c.to(x.dtype).contiguous()
                for c in (cx, csh, cw, cwsel)]
        cx, csh, cw, cwsel = cots
        ins = (x, sh, w, wsel, gout)

        def cast(*grads):
            return tuple(None if g is None else g.to(t.dtype)
                         for g, t in zip(grads, ins))

        if cx is not None and csh is not None and cw is not None \
                and cwsel is None:
            c_x, c_s, c_w, c_m, c_g = cast(*run_grad2(
                conv, x, cx, sh, csh, w, cw, wsel, src, dst, N, gout,
                order=order))
            return (None, c_x, c_s, c_w, c_m, None, None, None, c_g, None,
                    None, None)
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
            b = run_bwd(conv, *ops, src, dst, N, gout, order=order)
            for j in range(4):
                if j != i:
                    parts[j].append(b[j])
            # the bfloat16 outputs summed in float32 (:2151-2161)
            f = run_fwd(conv, *ops, src, dst, N, order=order)[0].float()
            c_g = f if c_g is None else c_g + f
        c_x, c_s, c_w, c_m = (sum(p[1:], p[0]) if p else None
                              for p in parts)
        c_x, c_s, c_w, c_m, c_g = cast(c_x, c_s, c_w, c_m, c_g)
        return (None, c_x, c_s, c_w, c_m, None, None, None, c_g, None, None,
                None)


def _check_inputs(conv, x, sh, w, wsel, edge_src, edge_dst, num_nodes):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"FullConvExt kernel needs CUDA tensors, got {dev}")
    fused = conv.fused
    N, E = int(num_nodes), sh.shape[0]
    cd = conv.compute_dtype   # the operands' dtype
    check_tensor(x, "x", (N, fused.irreps_in.dim), cd, dev)
    check_tensor(sh, "sh", (E, fused.J_dim), cd, dev)
    check_tensor(w, "w", (E, fused.weight_numel), cd, dev)
    check_tensor(wsel, "wsel", (conv.wsel_len,), cd, dev)
    check_tensor(edge_src, "edge_src", (E,), torch.int64, dev)
    check_tensor(edge_dst, "edge_dst", (E,), torch.int64, dev)
    if conv.bf16:
        # the bfloat16 walks: four warps of 16 channels (mul <= 64), at
        # most 96 (path, component) columns a left irrep, sh up to
        # MAX_SH components
        if not (fused.mul <= 64 and fused.J_dim <= MAX_SH
                and conv.bf16_walk_dims[1] <= BF16_MAX_NT):
            raise ValueError(
                f"the bfloat16 FullConvExt kernels take mul up to 64, up "
                f"to {8 * BF16_MAX_NT} (path, component) columns a left "
                f"irrep and J <= {MAX_SH}; got mul = {fused.mul}, "
                f"{8 * int(conv.bf16_walk_dims[1])} columns, J = "
                f"{fused.J_dim}")
        if conv.bf16_walk_tab.device != dev:
            raise ValueError("FullConvExt tables are not on the input's "
                             "device")
        return dev, N, E
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


def _launch(name, dev, *args):
    """Launch C entry ``name`` on ``args`` (tensors as their device
    pointers, ints, host pointers, None for a null pointer) and the
    current stream of ``dev``."""
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), stream)
    check(err, name)


def _call(name, conv, dev, edge_src, edge_dst, N, E, order, *rest):
    """Launch one C entry point with the arguments all three take first
    (sizes, edge list, walk tables, edge orders and work items), then
    ``rest``, on the current stream of ``dev``."""
    fused = conv.fused
    cap, T = walk_items(E, conv.n_chunks)
    _launch(name, dev, N, fused.irreps_in.dim, fused.J_dim, edge_src,
            edge_dst, E, fused.weight_numel, conv.walk_table,
            conv.walk_chunks, conv.n_chunks, conv.walk_src_chunks,
            conv.n_src_chunks, conv.walk_cells, conv.walk_nz,
            conv.max_chunk_nz, conv.max_d1, conv.max_d2, conv.max_d3,
            conv.walk_irreps, conv.n_walk_irreps, conv.KMd,
            int(conv.dx_covered), *order, cap, T, conv.KM, fused.mul,
            conv.prob_rows.ctypes.data, conv.n_probs, conv.out_dim, *rest)


def _call_bf16(name, conv, dev, edge_src, edge_dst, N, E, order, *rest):
    """Launch one bfloat16 C entry with the arguments all three take first
    (sizes, edge list, the bfloat16 walks' tables, both edge orders, the
    walks' work items, the mix problems), then ``rest``, on the current
    stream of ``dev``."""
    fused = conv.fused
    cap, T = walk_items(E, conv.n_chunks)
    _launch(name, dev, N, fused.irreps_in.dim, fused.J_dim, edge_src,
            edge_dst, E, fused.weight_numel, conv.KM, fused.mul,
            conv.out_dim, conv.bf16_walk_tab, conv.bf16_walk_tiles,
            int(conv.bf16_walk_dims[0]), conv.bf16_walk_dims.ctypes.data,
            int(conv.dx_covered), *order, cap, T,
            conv.prob_rows.ctypes.data, conv.n_probs, *rest)


def _empty(dev, *shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=dev)


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
    out = _empty(dev, N, conv.out_dim, dtype=conv.compute_dtype)
    if conv.bf16:
        _call_bf16("full_conv_ext_fwd_bf16", conv, dev, edge_src, edge_dst,
                   N, E, order, x, sh, w, wsel, scratch,
                   _pieces(conv, dev, E, conv.KM), out)
        FullConvExt.bf16_launches_fwd += 1
        return out, scratch
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


def _bf16_work(conv, dev, N, E, halves):
    """The bfloat16 K4b's and K4g's work buffers: the scratch, the long
    runs' pieces (of either walk), dS and each left irrep's float32 sh
    cotangent sums ``[halves, units, E, J, mul]`` (K4g: two halves)."""
    T = walk_items(E, conv.n_chunks)[1]
    return (_empty(dev, N, conv.KM),
            _empty(dev, T, max(conv.KM, conv.fused.irreps_in.dim)),
            _empty(dev, N, conv.KM),
            _empty(dev, halves, int(conv.bf16_walk_dims[0]), E,
                   conv.fused.J_dim, conv.fused.mul))


def launch_backward(conv, x, sh, w, wsel, edge_src, edge_dst, num_nodes,
                    gout, order=None, scratch=None):
    """Launch K4b: ``(dx, dsh, dw, dwsel)``, all float32, for the cotangent
    ``gout``.  ``scratch``: K4f's scratch of these same operands, or None
    (then recomputed); ``order``: the edges' ``EdgeOrder``, built here when
    not given."""
    dev, N, E = _check_inputs(conv, x, sh, w, wsel, edge_src, edge_dst,
                              num_nodes)
    check_tensor(gout, "gout", (N, conv.out_dim), conv.compute_dtype, dev)
    if scratch is not None:
        check_tensor(scratch, "scratch", (N, conv.KM), torch.float32, dev)
    order = _order(order, edge_src, edge_dst, N)
    if conv.bf16:
        # dx and dwsel float32, dsh and dw bfloat16 (run_bwd's dtypes,
        # fused_conv.py:1982-1988); work: S when recomputed, the long runs'
        # pieces of S or dx, dS, each left irrep's dsh sums [units, E, J,
        # mul]
        bf = conv.compute_dtype
        dx, dsh = _empty(dev, *x.shape), _empty(dev, *sh.shape, dtype=bf)
        dw, dwsel = _empty(dev, *w.shape, dtype=bf), \
            _empty(dev, conv.wsel_len)
        ws = row_mix.workspace(dev, gout.numel())
        work = _bf16_work(conv, dev, N, E, 1)
        _call_bf16("full_conv_ext_bwd_bf16", conv, dev, edge_src, edge_dst,
                   N, E, order, x, sh, w, wsel, gout, scratch,
                   work[0] if scratch is None else None, *work[1:],
                   dx, dsh, dw, dwsel, conv.wsel_len, ws, ws.numel())
        FullConvExt.bf16_launches_bwd += 1
        return dx, dsh, dw, dwsel
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
    cd = conv.compute_dtype
    check_tensor(cx, "cx", tuple(x.shape), cd, dev)
    check_tensor(csh, "csh", tuple(sh.shape), cd, dev)
    check_tensor(cw, "cw", tuple(w.shape), cd, dev)
    check_tensor(gout, "gout", (N, conv.out_dim), cd, dev)
    order = _order(order, edge_src, edge_dst, N)
    if conv.bf16:
        # c_x and c_m float32, c_s, c_w and c_g bfloat16 (run_grad2's
        # dtypes, fused_conv.py:2050-2058); work: S_sum, the long runs'
        # pieces of S_sum or c_x, dS, each left irrep's two c_s sums
        c_x, c_s = _empty(dev, *x.shape), _empty(dev, *sh.shape, dtype=cd)
        c_w, c_m = _empty(dev, *w.shape, dtype=cd), \
            _empty(dev, conv.wsel_len)
        c_g = _empty(dev, N, conv.out_dim, dtype=cd)
        ws = row_mix.workspace(dev, gout.numel())
        _call_bf16("full_conv_ext_grad2_bf16", conv, dev, edge_src,
                   edge_dst, N, E, order, x, cx, sh, csh, w, cw, wsel, gout,
                   *_bf16_work(conv, dev, N, E, 2),
                   c_x, c_s, c_w, c_m, c_g, conv.wsel_len, ws, ws.numel())
        FullConvExt.bf16_launches_grad2 += 1
        return c_x, c_s, c_w, c_m, c_g
    c_x, c_s = _empty(dev, *x.shape), _empty(dev, *sh.shape)
    c_w, c_m = _empty(dev, *w.shape), _empty(dev, conv.wsel_len)
    c_g = _empty(dev, N, conv.out_dim)
    ws = row_mix.workspace(dev, gout.numel())   # see row_mix.workspace
    _call("full_conv_ext_grad2", conv, dev, edge_src, edge_dst, N, E, order,
          x, cx, sh, csh, w, cw, wsel, gout, *_walk_work(conv, dev, N, E),
          c_x, c_s, c_w, c_m, c_g, conv.wsel_len, ws, ws.numel())
    FullConvExt.launches_grad2 += 1
    return c_x, c_s, c_w, c_m, c_g
