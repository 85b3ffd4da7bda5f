"""K3 and K3b: the species-table self-connection, forward and backward, as
one wrapper around ``csrc/species_sc.cu``.

The kernels replace the TPU kernels ``SpeciesScalarFCTP._fwd_kernel`` and
``_bwd_kernel`` (``equivariant_nn_zoo_tpu/ops/pallas/sc.py:181`` and
``:208``).  When ``node_attrs`` is
a pure per-species embedding (``featureModel`` guarantees it), the
self-connection ``fully_connected_tp(x, node_attrs)`` is

    out_l[n] = x_l[n] @ A_l[species_n],  A_l[t] = rep_t @ W_l * pw / sqrt(d)

with ``rep_t`` the attrs row of species ``t``.  The tables are built here in
plain PyTorch (as the TPU package builds them in XLA); the per-node product
is the kernel.  Instructions are taken one by one (no e/o slot pairing).

For tensors on the CPU the wrapper runs the plain version
(``FusedScalarFCTP``) and autograd differentiates it; for CUDA tensors it
goes through ``SpeciesScalarFCTPFunction``, whose forward launches K3 and
whose backward launches K3b, or raises.  The tables' own gradient (to the
TensorProduct weight and the attributes) is left to autograd.  Beside each
kernel stands a plain PyTorch version of its contract on the same inputs
(``table_product`` and ``plain_backward``), used by the tests and the
on-card checks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fused_tp import FusedScalarFCTP
from .build import check, check_tensor, load_library

MAX_D = 9  # components of an l <= 4 irrep (the backward's register rows)


class SpeciesScalarFCTP(torch.nn.Module):
    """Self-connection by per-species tables; parameter-compatible with
    ``fully_connected_tp`` (the ``weight`` of the TensorProduct passed at
    call time)."""

    #: kernel launches, over all instances (the main path's proof of use)
    launches = 0
    backward_launches = 0

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
                it["col"] = col
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
        self.outs, self.items = outs, items
        # backward tables: items grouped by input slot, with their output
        # columns, and one row per input slot read by some item
        bwd, ins = [], []
        for i_in in sorted({it["ins"].i_in1 for it in instr}):
            mine = [it for it in instr if it["ins"].i_in1 == i_in]
            ins.append([mine[0]["x_off"], mine[0]["d"], mine[0]["shape"][0],
                        len(bwd), len(bwd) + len(mine)])
            bwd += [[it["x_off"], it["shape"][0], it["col"],
                     out_starts[it["ins"].i_out], it["d"], it["shape"][2]]
                    for it in mine]
        self.n_ins, self.n_bwd_items = len(ins), len(bwd)
        self.max_mul1 = max((b[1] for b in bwd), default=0)
        self.max_mo = max((b[5] for b in bwd), default=0)
        self.max_d = max((b[4] for b in bwd), default=0)
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
        self.register_buffer(
            "in_table", torch.tensor(np.asarray(ins, np.int32).reshape(-1)),
            persistent=False)
        self.register_buffer(
            "bwd_item_table",
            torch.tensor(np.asarray(bwd, np.int32).reshape(-1)),
            persistent=False)

    def tables(self, tp, attrs: torch.Tensor,
               species: torch.Tensor) -> torch.Tensor:
        """Per-species tables of every instruction, ``[types, total]``:
        column block (item, u, w) holds ``A[t, u, w] = rep_t @ W * pw /
        sqrt(d)``, with ``rep_t`` the attrs row of species ``t``.

        When a gradient flows to ``attrs``, ``rep_t`` is gathered from one
        node of species ``t`` (the first), so it reaches ``attrs`` once per
        species, as the TPU package's ``.at[].set`` gives it to one winner;
        an index-put over repeated species would hand every node of the
        species the whole gradient.  Without one, the index-put gives the
        same rows (species-pure attributes) in fewer kernels.  Species
        absent from the batch keep a zero row."""
        spec = species.reshape(-1)
        if torch.is_grad_enabled() and attrs.requires_grad:
            n = spec.shape[0]
            first = torch.full((self.num_types,), n, dtype=spec.dtype,
                               device=spec.device).scatter_reduce_(
                0, spec, torch.arange(n, device=spec.device), "amin")
            rep = torch.cat([attrs, attrs.new_zeros((1, self.mul2))])[first]
        else:
            rep = attrs.new_zeros((self.num_types, self.mul2))
            rep[spec] = attrs
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
        """The kernel path: tables in plain PyTorch, then K3, through
        ``SpeciesScalarFCTPFunction`` (K3b in the backward) when a
        gradient is wanted."""
        spec = species.reshape(-1)
        tables = self.tables(tp, attrs, spec)
        if not torch.is_grad_enabled():
            return launch_forward(self, x, spec, tables.contiguous())
        return SpeciesScalarFCTPFunction.apply(self, x, tables, spec)

    def table_product(self, x, species, tables):
        """Plain PyTorch version of K3's contract: ``out[n] = x[n] @
        A[species_n]`` per instruction, from the tables."""
        N = x.shape[0]
        A_n = tables[species.reshape(-1)]               # [N, table_width]
        chunks = []
        for out_off, d, mo, it0, it1 in self.outs:
            o = x.new_zeros((N, mo, d))
            for x_off, mul1, a_off in self.items[it0:it1]:
                A = A_n[:, a_off: a_off + mul1 * mo].reshape(N, mul1, mo)
                xb = x[:, x_off: x_off + mul1 * d].reshape(N, mul1, d)
                o = o + torch.einsum("nuw,nuk->nwk", A, xb)
            chunks.append((out_off, o.reshape(N, mo * d)))
        out = x.new_zeros((N, self.irreps_out.dim))
        for out_off, o in chunks:
            cols = torch.arange(out_off, out_off + o.shape[1],
                                device=x.device)
            out = out.index_add(1, cols, o)
        return out

    def plain_backward(self, x, species, tables, g):
        """Plain PyTorch version of K3b's contract: ``(dx, dtables)`` of
        ``table_product`` for the cotangent ``g``, by autograd."""
        with torch.enable_grad():
            xs = x.detach().requires_grad_(True)
            ts = tables.detach().requires_grad_(True)
            out = self.table_product(xs, species, ts)
            return torch.autograd.grad(out, (xs, ts), g)


class SpeciesScalarFCTPFunction(torch.autograd.Function):
    """K3 forward, K3b backward.  Differentiable inputs: ``x`` and the
    tables; autograd carries ``dtables`` on to the weight and attrs."""

    @staticmethod
    def forward(ctx, sc, x, tables, species):
        tables = tables.contiguous()
        out = launch_forward(sc, x, species, tables)
        ctx.save_for_backward(x, tables, species)
        ctx.sc = sc
        return out

    @staticmethod
    def backward(ctx, g):
        x, tables, species = ctx.saved_tensors
        dx, dtables = launch_backward(ctx.sc, x, species, tables,
                                      g.contiguous())
        return None, dx, dtables, None


def _check_inputs(sc, x, species, tables):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(
            f"SpeciesScalarFCTP kernel needs CUDA tensors, got {dev}")
    N = x.shape[0]
    check_tensor(x, "x", (N, sc.in_dim), torch.float32, dev)
    check_tensor(species, "species", (N,), torch.int64, dev)
    check_tensor(tables, "tables", (sc.num_types, sc.table_width),
                 torch.float32, dev)
    if sc.out_table.device != dev:
        raise ValueError("SpeciesScalarFCTP tables are not on the "
                         "input's device")
    return dev, N


def launch_forward(sc, x, species, tables):
    """Launch K3: ``out [N, out_dim]``."""
    dev, N = _check_inputs(sc, x, species, tables)
    out_dim = sc.irreps_out.dim
    out = torch.empty((N, out_dim), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.species_sc_fwd(
            x.data_ptr(), N, sc.in_dim, species.data_ptr(),
            sc.num_types, tables.data_ptr(), sc.table_width,
            sc.out_table.data_ptr(), sc.n_outs,
            sc.item_table.data_ptr(), out.data_ptr(), out_dim, stream,
        )
    check(err, "species_sc_fwd")
    SpeciesScalarFCTP.launches += 1
    return out


def launch_backward(sc, x, species, tables, g):
    """Launch K3b: ``(dx [N, in_dim], dtables [types, table_width])``."""
    dev, N = _check_inputs(sc, x, species, tables)
    check_tensor(g, "g", (N, sc.irreps_out.dim), torch.float32, dev)
    if sc.max_d > MAX_D:
        raise ValueError(f"the K3 backward takes irreps up to l = 4, got "
                         f"d = {sc.max_d}")
    dx = torch.empty((N, sc.in_dim), dtype=torch.float32, device=dev)
    dtables = torch.empty((sc.num_types, sc.table_width),
                          dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.species_sc_bwd(
            x.data_ptr(), N, sc.in_dim, species.data_ptr(), sc.num_types,
            tables.data_ptr(), sc.table_width, g.data_ptr(),
            sc.irreps_out.dim, sc.in_table.data_ptr(), sc.n_ins,
            sc.bwd_item_table.data_ptr(), sc.n_bwd_items, sc.max_mul1,
            sc.max_mo, sc.max_d, dx.data_ptr(), dtables.data_ptr(), stream,
        )
    check(err, "species_sc_bwd")
    SpeciesScalarFCTP.backward_launches += 1
    return dx, dtables
