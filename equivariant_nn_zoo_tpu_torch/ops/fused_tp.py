"""Dense uvu tensor-product convolution and scalar self-connection.

PyTorch counterparts of ``equivariant_nn_zoo_tpu/ops/fused_tp.py``.  They
are the plain versions of the port's conv and self-connection kernels
(``ops/cuda/full_conv.py``, ``ops/cuda/full_conv_ext.py`` and
``ops/cuda/species_sc.py``): the kernels' wrappers call them for tensors on
the CPU, and the tests hold them against the JAX package.  On the force
path (``grad_order >= 2``) ``FusedScalarFCTP`` is itself the
self-connection, on every device, as in the JAX package: the species-table
kernel is first-order only.  The JAX package's ``apply_blocks`` (a
kernel-layout handoff) has no counterpart here.

``FusedUVUConv`` restructures the per-path convolution into dense ops:

1.  ``M[e] = sh[e] @ C`` — the block-sparse CG operator ``C[J, K, I]`` for
    all paths at once (paths sorted by output irrep);
2.  ``mid[e] = M[e] @ x_T[src_e]`` — ``[E, K, I] x [E, I, mul]``;
3.  per-path radial weights, then the expansion's mix ``Linear`` per edge
    (a shared bias-free linear commutes with the edge sum);
4.  one ``index_add_`` into the node rows.

Parameters are those of the ``TensorProductExpansion`` (its mix ``Linear``
is passed at call time), so the module holds only constant tables.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .irreps import Irreps
from .segment import segment_sum
from .wigner import wigner_3j


class FusedUVUConv(torch.nn.Module):
    """Constant tables and bookkeeping for one uvu TensorProductExpansion
    with external (per-edge) weights and uniform input multiplicity."""

    def __init__(self, tpe):
        super().__init__()
        irreps_in = Irreps(tpe.irreps_in["left"])
        irreps_sh = Irreps(tpe.irreps_in["right"])
        self.irreps_in = irreps_in
        self.irreps_sh = irreps_sh
        muls = {mi.mul for mi in irreps_in}
        assert len(muls) == 1, "fused path requires uniform multiplicity"
        self.mul = muls.pop()
        for mi in irreps_sh:
            assert mi.mul == 1, "fused path requires mul-1 sh"

        instructions = tpe.tp.instructions
        mid_irreps = tpe.tp.irreps_out
        assert all(ins.mode == "uvu" and ins.has_weight
                   for ins in instructions)
        self.weight_numel = self.mul * len(instructions)

        # paths in OUR order: sorted by output irrep (l, -p), then TPE order;
        # each TPE instruction owns `mul` consecutive weight columns
        order = sorted(
            range(len(instructions)),
            key=lambda i: (mid_irreps[instructions[i].i_out].ir.l,
                           -mid_irreps[instructions[i].i_out].ir.p, i),
        )
        self.paths = [instructions[i] for i in order]
        self.path_w_offset = [i * self.mul for i in order]

        self.I_dim = sum(mi.ir.dim for mi in irreps_in)
        i_starts = np.cumsum([0] + [mi.ir.dim for mi in irreps_in])
        d3s = [mid_irreps[ins.i_out].ir.dim for ins in self.paths]
        k_starts = np.cumsum([0] + d3s)
        self.K_dim = int(k_starts[-1])
        j_starts = np.cumsum([0] + [mi.ir.dim for mi in irreps_sh])
        self.J_dim = int(j_starts[-1])
        C = np.zeros((self.J_dim, self.K_dim, self.I_dim), np.float32)
        for p, ins in enumerate(self.paths):
            l1 = irreps_in[ins.i_in1].ir.l
            l2 = irreps_sh[ins.i_in2].ir.l
            l3 = mid_irreps[ins.i_out].ir.l
            cg = wigner_3j(l1, l2, l3) * ins.path_weight  # [d1, d2, d3]
            i0, j0, k0 = i_starts[ins.i_in1], j_starts[ins.i_in2], k_starts[p]
            C[j0: j0 + 2 * l2 + 1, k0: k0 + 2 * l3 + 1,
              i0: i0 + 2 * l1 + 1] += np.transpose(cg, (1, 2, 0))
        self.register_buffer(
            "C_flat",
            torch.tensor(C.reshape(self.J_dim, self.K_dim * self.I_dim)),
            persistent=False,
        )

        # output-irrep groups, contiguous in our K order:
        # (ir, k_start, n_paths, d, first path index)
        groups = []
        p = 0
        while p < len(self.paths):
            ir = mid_irreps[self.paths[p].i_out].ir
            q = p
            while q < len(self.paths) and \
                    mid_irreps[self.paths[q].i_out].ir == ir:
                q += 1
            groups.append((ir, int(k_starts[p]), q - p, ir.dim, p))
            p = q
        self.groups = groups

        # mix Linear: simplified mid irreps -> irreps_out.  Row index in
        # the simplified block = (rank of the TPE mid slot) + u
        linear = tpe.linear
        self.irreps_out = linear.irreps_out
        slot_rank, counter = {}, {}
        for slot, mi in enumerate(mid_irreps):
            slot_rank[slot] = counter.get(mi.ir, 0)
            counter[mi.ir] = slot_rank[slot] + self.mul
        for g, (ir, k0, n_paths, d, p0) in enumerate(groups):
            ranks = [slot_rank[self.paths[p0 + m].i_out]
                     for m in range(n_paths)]
            perm = np.concatenate([np.arange(r, r + self.mul) for r in ranks])
            self.register_buffer(f"rows{g}", torch.tensor(perm),
                                 persistent=False)
            w_idx = [self.path_w_offset[p0 + m] // self.mul
                     for m in range(n_paths)]
            self.register_buffer(f"widx{g}", torch.tensor(w_idx),
                                 persistent=False)
        self.lin_in_index = {mi.ir: ii for ii, mi in
                             enumerate(mid_irreps.simplify())}
        self.lin_out = {}
        for io, mo in enumerate(linear.irreps_out):
            self.lin_out.setdefault(mo.ir, []).append(io)

    def mix_weight(self, linear, g: int, io: int) -> torch.Tensor:
        """Mix matrix of group ``g`` into output slot ``io`` with rows in
        (path, u) order: ``[n_paths * mul, mul_out]``, ``alpha`` applied."""
        ir = self.groups[g][0]
        return linear.weight(self.lin_in_index[ir], io)[
            getattr(self, f"rows{g}")]

    def edge_mid(self, x: torch.Tensor, edge_src: torch.Tensor,
                 sh: torch.Tensor) -> torch.Tensor:
        """Unweighted per-edge CG products ``[E, K, mul]`` (steps 1-2)."""
        mul = self.mul
        blocks = []
        ofs = 0
        for mi in self.irreps_in:
            d = mi.ir.dim
            b = x[:, ofs: ofs + mul * d].reshape(-1, mul, d)
            blocks.append(b.transpose(1, 2))
            ofs += mul * d
        xT = torch.cat(blocks, dim=1)                     # [N, I, mul]
        M = (sh @ self.C_flat).reshape(-1, self.K_dim, self.I_dim)
        return torch.bmm(M, xT[edge_src])

    def forward(self, linear, x: torch.Tensor, edge_src: torch.Tensor,
                edge_dst: torch.Tensor, sh: torch.Tensor,
                weight: torch.Tensor, num_nodes: int,
                pre_scale: Optional[float] = None) -> torch.Tensor:
        """x [N, in_dim] (already linear_1'd), sh [E, J], weight
        [E, weight_numel] -> node-summed mixed output [N, out_dim]."""
        E = sh.shape[0]
        mul = self.mul
        mid = self.edge_mid(x, edge_src, sh)              # [E, K, mul]
        w3 = weight.reshape(E, -1, mul)                   # [E, P, mul]
        out_blocks = {}
        for g, (ir, k0, n_paths, d, p0) in enumerate(self.groups):
            block = mid[:, k0: k0 + n_paths * d].reshape(E, n_paths, d, mul)
            wg = w3[:, getattr(self, f"widx{g}")]         # [E, n_paths, mul]
            block = block * wg[:, :, None, :]
            for io in self.lin_out.get(ir, []):
                w_sel = self.mix_weight(linear, g, io).reshape(
                    n_paths, mul, -1)
                o = torch.einsum("epdu,puw->edw", block, w_sel)
                out_blocks[io] = out_blocks[io] + o if io in out_blocks else o
        outs = []
        for io, mo in enumerate(self.irreps_out):
            if io in out_blocks:
                outs.append(out_blocks[io].transpose(1, 2).reshape(E, mo.dim))
            else:
                outs.append(x.new_zeros((E, mo.dim)))
        edge_out = torch.cat(outs, dim=-1)
        if pre_scale is not None:
            edge_out = edge_out * pre_scale
        return segment_sum(edge_out, edge_dst, num_nodes)


class FusedScalarFCTP:
    """Self-connection (FullyConnectedTensorProduct with pure-scalar right
    input): ``out[n] = x_block(n) @ A(n)`` with ``A(n) = attrs(n) @ W`` —
    two dense products per instruction instead of per-path einsums.
    Parameter-compatible with ``fully_connected_tp`` (same ``weight``)."""

    def __init__(self, tp):
        self.tp = tp
        ir2 = tp.irreps_in2
        assert all(mi.ir.l == 0 and mi.ir.p == 1 for mi in ir2), \
            "scalars only"
        self.items = []
        w_ofs = 0
        for ins in tp.instructions:
            shape = tp._weight_shape(ins)
            self.items.append((ins, w_ofs, shape))
            w_ofs += int(np.prod(shape))

    def __call__(self, x: torch.Tensor, attrs: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        N = x.shape[0]
        slices1 = tp.irreps_in1.slices()
        chunks = {}
        for ins, w_ofs, (mul1, mul2, mul_out) in self.items:
            d = tp.irreps_in1[ins.i_in1].ir.dim
            # wigner_3j(l, 0, l) is delta/sqrt(2l+1) — folded in
            w = (tp.weight[w_ofs: w_ofs + mul1 * mul2 * mul_out]
                 .reshape(mul1, mul2, mul_out)
                 * (ins.path_weight / np.sqrt(d)))
            A = torch.einsum("nv,uvw->nuw", attrs, w)     # [N, mul1, mul_out]
            xb = x[:, slices1[ins.i_in1]].reshape(N, mul1, d)
            o = torch.einsum("nuw,nuk->nwk", A, xb).reshape(N, mul_out * d)
            chunks[ins.i_out] = chunks[ins.i_out] + o \
                if ins.i_out in chunks else o
        return torch.cat([
            chunks[io] if io in chunks else x.new_zeros((N, mo.dim))
            for io, mo in enumerate(tp.irreps_out)
        ], dim=-1)
