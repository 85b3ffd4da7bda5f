"""K1: the whole-convolution forward — radial MLP, gather, CG tensor
product times radial weight, scatter, and mix — as one wrapper around
``csrc/full_conv.cu``.

It replaces the TPU kernel ``PallasFullConv._full_fwd_kernel``
(``equivariant_nn_zoo_tpu/ops/pallas/fused_conv.py:926``) and keeps its
contract on the plain padded batch: global ``edge_index``, padded edges
pointing at the dummy node with masked (zero) ``edge_radial``.  The TPU
layout (one-hot window gathers, ``(u, e)`` lanes, K8 row padding, run
flush flags) is not carried over.

For tensors on the CPU the wrapper runs the plain version
(``FullyConnectedNet`` then ``FusedUVUConv``); for CUDA tensors it launches
the kernels or raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..fused_tp import FusedUVUConv
from ..gate import ScaledActivation, shifted_softplus
from ..wigner import wigner_3j
from .build import check, check_tensor, load_library

MAX_RADIAL, MAX_HIDDEN, MAX_SH = 16, 64, 16


class FullConv(torch.nn.Module):
    """Constant tables for one ``FactorizedConvolution``'s K1 launch.

    Parameters are passed at call time (the radial ``FullyConnectedNet`` and
    the expansion's mix ``Linear``), so this module holds buffers only.
    """

    #: kernel launches, over all instances (the main path's proof of use)
    launches = 0

    def __init__(self, tpe, fc):
        super().__init__()
        self.fused = FusedUVUConv(tpe)
        act = fc.act
        if not (isinstance(act, ScaledActivation)
                and act.fn is shifted_softplus):
            raise ValueError("the conv kernel implements the normalized "
                             "shifted-softplus radial MLP only")
        self.act_cst = float(act.cst)
        self.fc_dims = list(fc.dims)
        fused = self.fused
        mul = fused.mul
        in_starts = [s.start for s in fused.irreps_in.slices()]
        j_starts = np.cumsum([0] + [mi.ir.dim for mi in fused.irreps_sh])

        # per-path table (our path order) and its sorted CG non-zeros.
        # Scratch rows are component-major inside each output-irrep group:
        # row(g, m3, m) = k0_g + m3 * n_paths_g + m
        paths, nz_idx, nz_c = [], [], []
        for ir, k0, n_paths, d, p0 in fused.groups:
            for m in range(n_paths):
                ins = fused.paths[p0 + m]
                mi1 = fused.irreps_in[ins.i_in1]
                mi2 = fused.irreps_sh[ins.i_in2]
                cg = wigner_3j(mi1.ir.l, mi2.ir.l, ir.l) * ins.path_weight
                nz0 = len(nz_idx)
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
        self.n_paths = len(paths)
        self.KM = fused.K_dim * mul

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
        self.mix_plan = plan
        self.n_probs = len(probs)
        self.max_wo = max((p[3] for p in probs), default=0)
        self.out_dim = linear_out.dim

        def int_buffer(name, rows):
            self.register_buffer(
                name, torch.tensor(np.asarray(rows, np.int32).reshape(-1)),
                persistent=False)

        int_buffer("path_table", paths)
        int_buffer("nz_idx", nz_idx)
        int_buffer("prob_table", probs)
        self.register_buffer(
            "nz_c", torch.tensor(np.asarray(nz_c, np.float32)),
            persistent=False)

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
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(f"FullConv kernel needs CUDA tensors, got {dev}")
        fused = self.fused
        N, E = int(num_nodes), sh.shape[0]
        in_dim = fused.irreps_in.dim
        R, H, PC = self.fc_dims[0], self.fc_dims[1], self.fc_dims[-1]
        n_hidden = len(self.fc_dims) - 2
        check_tensor(x, "x", (N, in_dim), torch.float32, dev)
        check_tensor(sh, "sh", (E, fused.J_dim), torch.float32, dev)
        check_tensor(edge_radial, "edge_radial", (E, R), torch.float32, dev)
        check_tensor(edge_src, "edge_src", (E,), torch.int64, dev)
        check_tensor(edge_dst, "edge_dst", (E,), torch.int64, dev)
        if not (R <= MAX_RADIAL and H <= MAX_HIDDEN and n_hidden >= 1
                and fused.J_dim <= MAX_SH and fused.mul * 4 <= 1024
                and all(h == H for h in self.fc_dims[1:-1])
                and PC == fused.weight_numel):
            raise ValueError(f"FullConv kernel does not take MLP dims "
                             f"{self.fc_dims}, J={fused.J_dim}, "
                             f"mul={fused.mul}")
        if self.path_table.device != dev:
            raise ValueError("FullConv tables are not on the input's device")

        scale = [float(d) ** -0.5 for d in self.fc_dims[:-1]]
        w_hidden = torch.cat([
            (getattr(fc, f"w{i}") * scale[i]).reshape(-1)
            for i in range(n_hidden)
        ]).contiguous()
        w_out = (getattr(fc, f"w{n_hidden}") * scale[n_hidden]).contiguous()
        pre = 1.0 if pre_scale is None else float(pre_scale)
        wsel = torch.cat([
            (fused.mix_weight(linear, g, io) * pre).reshape(-1)
            for g, io in self.mix_plan
        ]).contiguous()
        for name, t in (("w_hidden", w_hidden), ("w_out", w_out),
                        ("wsel", wsel)):
            check_tensor(t, name, tuple(t.shape), torch.float32, dev)

        scratch = torch.empty(N * self.KM, dtype=torch.float32, device=dev)
        out = torch.empty((N, self.out_dim), dtype=torch.float32, device=dev)
        lib = load_library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.full_conv_fwd(
                x.data_ptr(), N, in_dim,
                sh.data_ptr(), fused.J_dim,
                edge_radial.data_ptr(), R,
                edge_src.data_ptr(), edge_dst.data_ptr(), E,
                w_hidden.data_ptr(), H, n_hidden,
                w_out.data_ptr(), PC, self.act_cst,
                self.path_table.data_ptr(), self.n_paths,
                self.nz_idx.data_ptr(), self.nz_c.data_ptr(),
                scratch.data_ptr(), self.KM, fused.mul,
                wsel.data_ptr(), self.prob_table.data_ptr(), self.n_probs,
                self.max_wo, out.data_ptr(), self.out_dim, stream,
            )
        check(err, "full_conv_fwd")
        FullConv.launches += 1
        return out

