"""K5: the internal-weight all-uvu tensor-product expansion of the
hamiltonian head (``Pairwise``'s ``tp`` and ``tp_off``), around
``csrc/pairwise_tp.cu``.

The kernel replaces the TPU kernel ``PallasPairwiseTP._fwd_kernel``
(``equivariant_nn_zoo_tpu/ops/pallas/pairwise.py:410``).  For one
``TensorProductExpansion`` with internal weights it computes
``expand(left, right)``:

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
one launch.

One instance serves every expansion of the same structure (``tp`` and
``tp_off``): the expansion whose parameters to use is passed at call time.
For tensors on the CPU the wrapper runs the plain version
(``TensorProductExpansion.expand``, the mid-fused lowering) and autograd
differentiates it.  For CUDA tensors it launches the kernel or raises.  The
kernel is forward-only: a CUDA call under grad mode with an input or
parameter that needs a gradient raises instead of returning a detached
tensor.  ``plain_forward`` is a plain PyTorch version of the kernel's
contract that walks the same tables, for the tests and the on-card checks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..wigner import wigner_3j
from .build import check, check_tensor, load_library
from .full_conv import mix_rows


class PairwiseTP(torch.nn.Module):
    """Constant tables of one internal-weight all-uvu
    ``TensorProductExpansion`` with uniform left multiplicity, and K5."""

    #: kernel launches, over all instances (the main path's proof of use)
    launches = 0
    #: elements per launch (bounds ``bw`` and the scratch: 2 x 1.5 GiB at
    #: the full-width head)
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
        table, nz_idx, nz_c = [], [], []
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
        for g, (ir, k0, n_paths, d, p0) in enumerate(groups):
            rows = np.concatenate([
                slot_rank[paths[p0 + m].i_out] + np.arange(mul)
                for m in range(n_paths)])
            self.register_buffer(f"rows{g}", torch.tensor(rows),
                                 persistent=False)
            for io in lin_out[ir]:
                wo = lin.irreps_out[io].mul
                self.mix_plan.append((g, lin_in_index[ir], io))
                for dd in range(d):
                    probs.append([(k0 + dd * n_paths) * mul, n_paths * mul,
                                  b_off, wo, out_starts[io] + dd, d])
                b_off += n_paths * mul * wo
        self.wsel_len = b_off
        self.n_probs = len(probs)
        self.max_wo = max((p[3] for p in probs), default=0)
        self.covers_output = {io for _, _, io in self.mix_plan} == {
            io for io, mo in enumerate(lin.irreps_out) if mo.dim}
        self.nz_count = len(nz_idx)

        # host copies for the plain contract, device buffers for the kernel
        self.path_rows = np.asarray(table, np.int32).reshape(-1, 9)
        self.prob_rows = np.asarray(probs, np.int32).reshape(-1, 6)
        self.nz_codes = np.asarray(nz_idx, np.int64)
        for name, rows in (("path_table", self.path_rows),
                           ("prob_table", self.prob_rows),
                           ("nz_idx", np.asarray(nz_idx, np.int32))):
            self.register_buffer(name, torch.tensor(rows.reshape(-1)),
                                 persistent=False)
        self.register_buffer(
            "nz_c", torch.tensor(np.asarray(nz_c, np.float32)),
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
        elements, the weighted right operand in plain PyTorch, then K5."""
        weight = tpe.tp.weight
        wsel = self.flat_wsel(tpe.linear)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (left, right, weight, wsel)):
            raise NotImplementedError(
                "PairwiseTP: the pairwise kernel has no backward yet; call "
                "it under torch.no_grad() or on the CPU")
        outs = [
            launch_forward(self, left[m0: m0 + self.CHUNK].contiguous(),
                           self.weighted_right(
                               weight, right[m0: m0 + self.CHUNK]), wsel)
            for m0 in range(0, left.shape[0], self.CHUNK)]
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


def launch_forward(tpk, a, bw, wsel):
    """Launch K5 on one chunk: ``out [M, out_dim]``."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"PairwiseTP kernel needs CUDA tensors, got {dev}")
    M = a.shape[0]
    check_tensor(a, "left", (M, tpk.irreps_a.dim), torch.float32, dev)
    check_tensor(bw, "bw", (M, tpk.R, tpk.mul), torch.float32, dev)
    check_tensor(wsel, "wsel", (tpk.wsel_len,), torch.float32, dev)
    if tpk.mul * 4 > 1024:
        raise ValueError(f"PairwiseTP kernel does not take mul={tpk.mul}")
    if tpk.path_table.device != dev:
        raise ValueError("PairwiseTP tables are not on the input's device")
    scratch = torch.empty((M, tpk.KM), dtype=torch.float32, device=dev)
    out = torch.empty((M, tpk.out_dim), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pairwise_tp_fwd(
            a.data_ptr(), M, tpk.irreps_a.dim,
            bw.data_ptr(), tpk.R,
            tpk.path_table.data_ptr(), tpk.n_paths,
            tpk.nz_idx.data_ptr(), tpk.nz_c.data_ptr(),
            scratch.data_ptr(), tpk.KM, tpk.mul,
            wsel.data_ptr(), tpk.prob_table.data_ptr(), tpk.n_probs,
            tpk.max_wo, out.data_ptr(), tpk.out_dim,
            int(not tpk.covers_output), stream,
        )
    check(err, "pairwise_tp_fwd")
    PairwiseTP.launches += 1
    return out
