"""K3: the species-table self-connection forward, as one wrapper around
``csrc/species_sc.cu``.

It replaces the TPU kernel ``SpeciesScalarFCTP._fwd_kernel``
(``equivariant_nn_zoo_tpu/ops/pallas/sc.py:181``).  When ``node_attrs`` is
a pure per-species embedding (``featureModel`` guarantees it), the
self-connection ``fully_connected_tp(x, node_attrs)`` is

    out_l[n] = x_l[n] @ A_l[species_n],  A_l[t] = rep_t @ W_l * pw / sqrt(d)

with ``rep_t`` the attrs row of species ``t``.  The tables are built here in
plain PyTorch (as the TPU package builds them in XLA); the per-node product
is the kernel.  Instructions are taken one by one (no e/o slot pairing).

For tensors on the CPU the wrapper runs the plain version; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fused_tp import FusedScalarFCTP
from .build import check, check_tensor, load_library


class SpeciesScalarFCTP(torch.nn.Module):
    """Self-connection by per-species tables; parameter-compatible with
    ``fully_connected_tp`` (the ``weight`` of the TensorProduct passed at
    call time)."""

    #: kernel launches, over all instances (the main path's proof of use)
    launches = 0

    def __init__(self, tp, num_types: int):
        super().__init__()
        self.num_types = int(num_types)
        ir1, ir2 = tp.irreps_in1, tp.irreps_in2
        assert all(mi.ir.l == 0 and mi.ir.p == 1 for mi in ir2), \
            "scalars only"
        self.mul2 = ir2.num_irreps
        self.in_dim = ir1.dim
        self.irreps_out = tp.irreps_out
        in_starts = [s.start for s in ir1.slices()]
        instr = []
        w_ofs = 0
        for ins in tp.instructions:
            shape = tp._weight_shape(ins)  # (mul1, mul2, mul_out)
            instr.append(dict(
                ins=ins, w_ofs=w_ofs, shape=shape,
                d=ir1[ins.i_in1].ir.dim, x_off=in_starts[ins.i_in1],
            ))
            w_ofs += int(np.prod(shape))

        # kernel tables: items grouped by output slot.  The per-species
        # tables of all items are one [types, total] product rep @ W, with
        # W gathered from the flat weight: column (item, u, w) of row v is
        # weight[w_ofs + (u * mul2 + v) * mul_out + w], times pw / sqrt(d)
        out_starts = [s.start for s in tp.irreps_out.slices()]
        outs, items, cols, scale = [], [], [], []
        col = 0
        for io, mo in enumerate(tp.irreps_out):
            mine = [it for it in instr if it["ins"].i_out == io]
            if not mine:
                continue
            outs.append([out_starts[io], mo.ir.dim, mo.mul, len(items),
                         len(items) + len(mine)])
            for it in mine:
                mul1, mul2, mul_out = it["shape"]
                items.append([it["x_off"], mul1, col])
                u, w = np.meshgrid(np.arange(mul1), np.arange(mul_out),
                                   indexing="ij")
                base = it["w_ofs"] + u.reshape(-1) * mul2 * mul_out \
                    + w.reshape(-1)
                cols.append(base[None, :]
                            + np.arange(mul2)[:, None] * mul_out)
                scale.append(np.full(mul1 * mul_out, it["ins"].path_weight
                                     / np.sqrt(it["d"]), np.float32))
                col += mul1 * mul_out
        self.table_width = col
        self.n_outs = len(outs)
        self.register_buffer(
            "out_table", torch.tensor(np.asarray(outs, np.int32).reshape(-1)),
            persistent=False)
        self.register_buffer(
            "item_table",
            torch.tensor(np.asarray(items, np.int32).reshape(-1)),
            persistent=False)
        self.register_buffer(
            "w_index", torch.tensor(np.concatenate(cols, 1).reshape(-1)),
            persistent=False)
        self.register_buffer("w_scale", torch.tensor(np.concatenate(scale)),
                             persistent=False)

    def tables(self, tp, attrs: torch.Tensor,
               species: torch.Tensor) -> torch.Tensor:
        """Per-species tables of every instruction, ``[types, total]``:
        column block (item, u, w) holds ``A[t, u, w] = rep_t @ W * pw /
        sqrt(d)``, with ``rep_t`` the attrs row of species ``t``."""
        rep = attrs.new_zeros((self.num_types, self.mul2))
        rep[species.reshape(-1)] = attrs
        W = tp.weight[self.w_index].reshape(self.mul2, self.table_width)
        return rep @ (W * self.w_scale)

    def forward(self, tp, x: torch.Tensor, attrs: torch.Tensor,
                species: torch.Tensor) -> torch.Tensor:
        """x [N, in_dim], attrs [N, mul2], species [N] or [N, 1] (int64)
        -> [N, out_dim]."""
        if x.device.type == "cpu":
            return self.plain(tp, x, attrs, species)
        return self.launch(tp, x, attrs, species)

    def plain(self, tp, x, attrs, species):
        """Plain PyTorch version: the per-node formulation
        (``FusedScalarFCTP``), equal to the per-species tables when the
        attributes are species-pure."""
        return FusedScalarFCTP(tp)(x, attrs)

    def launch(self, tp, x, attrs, species):
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(
                f"SpeciesScalarFCTP kernel needs CUDA tensors, got {dev}")
        N = x.shape[0]
        spec = species.reshape(-1)
        check_tensor(x, "x", (N, self.in_dim), torch.float32, dev)
        check_tensor(attrs, "attrs", (N, self.mul2), torch.float32, dev)
        check_tensor(spec, "species", (N,), torch.int64, dev)
        if self.out_table.device != dev:
            raise ValueError("SpeciesScalarFCTP tables are not on the "
                             "input's device")
        tables = self.tables(tp, attrs, spec).contiguous()
        out_dim = self.irreps_out.dim
        out = torch.empty((N, out_dim), dtype=torch.float32, device=dev)
        lib = load_library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.species_sc_fwd(
                x.data_ptr(), N, self.in_dim, spec.data_ptr(),
                self.num_types, tables.data_ptr(), self.table_width,
                self.out_table.data_ptr(), self.n_outs,
                self.item_table.data_ptr(), out.data_ptr(), out_dim, stream,
            )
        check(err, "species_sc_fwd")
        SpeciesScalarFCTP.launches += 1
        return out
