"""K3 and K3b: the species-table self-connection, forward and backward, as
one wrapper around ``csrc/species_sc.cu``.

The kernels replace the TPU kernels ``SpeciesScalarFCTP._fwd_kernel`` and
``_bwd_kernel`` (``equivariant_nn_zoo_tpu/ops/pallas/sc.py:181`` and
``:208``).  When ``node_attrs`` is
a pure per-species embedding (``featureModel`` guarantees it), the
self-connection ``fully_connected_tp(x, node_attrs)`` is

    out_l[n] = x_l[n] @ A_l[species_n],  A_l[t] = rep_t @ W_l * pw / sqrt(d)

with ``rep_t`` the attrs row of species ``t``.  The tables are built here in
plain PyTorch (as the TPU package builds them in XLA); the per-species
products are the kernels.  They walk the nodes species-major, on the order
of ``species_order.shared`` (built once per forward and saved for the
backward), in tiles of one species each, so a block stages its species'
table once; the entry tables below list the (slot, column tile) and (item,
u tile, w tile) pieces the kernels' blocks take.  Instructions are taken
one by one (no e/o slot pairing).

For tensors on the CPU the wrapper runs the plain version
(``FusedScalarFCTP``) and autograd differentiates it; for CUDA tensors it
goes through ``SpeciesScalarFCTPFunction``, whose forward launches K3 and
whose backward launches K3b, or raises.  The tables' own gradient (to the
TensorProduct weight and the attributes) is left to autograd.  Beside each
kernel stands a plain PyTorch version of its contract on the same inputs
(``table_product`` and ``plain_backward``), used by the tests and the
on-card checks.

With ``compute_dtype="bfloat16"`` the tables, the output and the
backward's cotangent are bfloat16 and x is rounded to bfloat16, as the TPU
kernels take them (``sc.py:104-120, 165-172, 208-246, 307``): the tables
are bf16(bf16(rep) @ bf16(W pw / sqrt(d))), every product is summed in
float32 and rounded per instruction (the TPU kernel's blocks are per
instruction), the instructions of an output slot added in bfloat16, those
of an input slot's dx in float32 (each is a separate cotangent of x
there), and dtables rounded (the TPU kernel's caller casts it to the
tables' dtype).  dx comes out float32; autograd rounds it for a bfloat16 x.
On the CPU too the bfloat16 layer goes through
``SpeciesScalarFCTPFunction``, with the plain contracts in place of the
launches.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..compute_dtype import compute_dtype_of
from ..fused_tp import FusedScalarFCTP
from . import species_order
from .build import KernelSwitch, check, check_tensor, load_library

MAX_D = 9  # components of an l <= 4 irrep, the widest the kernels are run at
# the kernels' tiling (csrc/species_sc.cu): columns of a tile, (node,
# component) rows of a K3 / dx tile at most, rows of a dtables staging
# round, and the floats of a dtables tile
COLS, TILE_ROWS, ROUND = 64, 128, 64
TILE = COLS * COLS


def tile_nodes(rows: int, d: int) -> int:
    """Nodes of a tile of ``rows`` (node, component) rows."""
    return max(1, rows // d)


def tile_rows(reduction: int) -> int:
    """(node, component) rows of a K3 / dx tile whose slot sums over
    ``reduction`` (its items' mul1, or for dx their mul_out) in all: 128
    up to one 64-long chunk, fewer for a longer sum, down to 16, so that a
    block's work stays about one chunk's at 128 rows."""
    if reduction <= COLS:
        return TILE_ROWS
    return max(16, TILE_ROWS * COLS // reduction // 16 * 16)


def tile_bound(N: int, tn: int, runs: int) -> int:
    """At most this many tiles of ``tn`` positions cover ``runs`` runs of
    ``N`` positions in all (each run's last tile may be short)."""
    return -(-N // tn) + runs


@lru_cache(maxsize=None)
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def grad_chunk_rows(N: int, grad_entries: np.ndarray, blocks: int) -> int:
    """(node, component) rows per dtables chunk: the reduction is split so
    that the species' chunks give about ``blocks`` blocks, in multiples of
    64 rows (one staging round)."""
    rows = N * int(grad_entries[:, 3].sum())
    return max(64, -(-rows // max(1, blocks) // 64) * 64)


def grad_blocks(N: int, types: int, grad_entries: np.ndarray,
                chunk_rows: int) -> int:
    """Blocks of the dtables partials (tiles of the workspace)."""
    return sum(tile_bound(N, tile_nodes(chunk_rows, int(d)), types)
               for d in grad_entries[:, 3])


class SpeciesScalarFCTP(KernelSwitch, torch.nn.Module):
    """Self-connection by per-species tables; parameter-compatible with
    ``fully_connected_tp`` (the ``weight`` of the TensorProduct passed at
    call time)."""

    #: kernel launches, over all instances (the main path's proof of use)
    launches = 0
    backward_launches = 0
    bf16_launches = 0    # the bfloat16 variants' launches, K3 and K3b
    bf16_backward_launches = 0

    def __init__(self, tp, num_types: int, compute_dtype: str = "float32"):
        super().__init__()
        self.num_types = int(num_types)
        self.compute_dtype = compute_dtype_of(compute_dtype)
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
        self.outs, self.items = outs, items
        # the table columns of each instruction, in column order
        self.item_columns = sorted(
            (it[2], it[1] * o[2]) for o in outs for it in items[o[3]:o[4]])
        # backward tables: items grouped by input slot, with their output
        # columns, and one row per input slot (an input slot no item reads,
        # like an output slot no item writes, has an empty item range: the
        # kernels store zeros in its columns)
        bwd, ins = [], []
        for i_in, mi in enumerate(ir1):
            mine = [it for it in instr if it["ins"].i_in1 == i_in]
            ins.append([in_starts[i_in], mi.ir.dim, mi.mul, len(bwd),
                        len(bwd) + len(mine)])
            bwd += [[it["x_off"], it["shape"][0], it["col"],
                     out_starts[it["ins"].i_out], it["d"], it["shape"][2]]
                    for it in mine]
        self.max_d = max((o[1] for o in outs + ins), default=0)
        # the kernels' entries, one per 64-wide column tile: K3's (output
        # slot, first w, d, nodes per tile), dx's (input slot, first u, d,
        # nodes per tile) and dtables' (item, first u, first w, d); kept on
        # the host too, where the C entries count the blocks
        def product_entries(slots, reduction):
            return np.asarray(
                [[i, c, o[1], tile_nodes(tile_rows(reduction(o)), o[1])]
                 for i, o in enumerate(slots) for c in range(0, o[2], COLS)],
                np.int32).reshape(-1, 4)

        self.fwd_entries = product_entries(
            outs, lambda o: sum(it[1] for it in items[o[3]:o[4]]))
        self.dx_entries = product_entries(
            ins, lambda o: sum(b[5] for b in bwd[o[3]:o[4]]))
        self.grad_entries = np.asarray(
            [[i, u, w, b[4]] for i, b in enumerate(bwd)
             for u in range(0, b[1], COLS) for w in range(0, b[5], COLS)],
            np.int32).reshape(-1, 4)
        for name in ("fwd_entries", "dx_entries", "grad_entries"):
            self.register_buffer(
                f"{name}_table",
                torch.tensor(getattr(self, name).reshape(-1)),
                persistent=False)
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
        if self.bf16:
            # per instruction, rep rounded on its own (its cotangents add
            # up in float32, as the TPU package's per-item casts give them)
            bf, Ws = torch.bfloat16, W * self.w_scale
            return torch.cat([
                (rep.to(bf).float() @ Ws[:, a: a + n].to(bf).float()).to(bf)
                for a, n in self.item_columns], dim=1)
        return rep @ (W * self.w_scale)

    @property
    def bf16(self) -> bool:
        return self.compute_dtype == torch.bfloat16

    def forward(self, tp, x: torch.Tensor, attrs: torch.Tensor,
                species: torch.Tensor) -> torch.Tensor:
        """x [N, in_dim], attrs [N, mul2], species [N] or [N, 1] (int64)
        -> [N, out_dim]."""
        if self.uses_kernel(x):
            return self.launch(tp, x, attrs, species)
        return self.plain(tp, x, attrs, species)

    def plain(self, tp, x, attrs, species):
        """Plain PyTorch version: the per-node formulation
        (``FusedScalarFCTP``), equal to the per-species tables when the
        attributes are species-pure; at bfloat16 the plain contracts of K3
        and K3b through ``SpeciesScalarFCTPFunction``."""
        if self.bf16:
            return self._call(tp, x, attrs, species, False)
        return FusedScalarFCTP(tp)(x, attrs)

    def launch(self, tp, x, attrs, species):
        """The kernel path: the species order (``species_order.shared``:
        one per forward), tables in plain PyTorch, then K3, through
        ``SpeciesScalarFCTPFunction`` (K3b in the backward, on the same
        order) when a gradient is wanted."""
        return self._call(tp, x, attrs, species, True)

    def _call(self, tp, x, attrs, species, kernel: bool):
        spec = species.reshape(-1)
        order = (species_order.shared(spec, self.num_types) if kernel
                 else species_order.SpeciesOrder(None, None))
        tables = self.tables(tp, attrs, spec)
        if not torch.is_grad_enabled():
            return _run_forward(kernel)(self, _operand(self, x), spec,
                                        tables.contiguous(), order=order)
        return SpeciesScalarFCTPFunction.apply(self, x, tables, spec,
                                               *order, kernel)

    def table_product(self, x, species, tables):
        """Plain PyTorch version of K3's contract: ``out[n] = x[n] @
        A[species_n]`` per instruction, from the tables.  For bfloat16 x
        and tables the products are summed in float32 and the output is
        rounded to bfloat16."""
        if tables.dtype == torch.bfloat16:
            return self._table_product_bf16(x, species, tables)
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

    def _item_products(self, x, species, tables):
        """Per output slot and instruction ``(out_off, d, mo, item, x_n,
        A_n)``: the instruction's x block ``[N, mul1, d]`` and table rows
        ``[N, mul1, mo]``, float32 of the bfloat16-rounded operands."""
        N = x.shape[0]
        A_n = tables.float()[species.reshape(-1)]
        xr = x.to(torch.bfloat16).float()
        for out_off, d, mo, it0, it1 in self.outs:
            for item in self.items[it0:it1]:
                x_off, mul1, a_off = item
                yield (out_off, d, mo, item,
                       xr[:, x_off: x_off + mul1 * d].reshape(N, mul1, d),
                       A_n[:, a_off: a_off + mul1 * mo].reshape(N, mul1, mo))

    def _table_product_bf16(self, x, species, tables):
        """K3's bfloat16 contract: per instruction the float32 sum of the
        rounded operands' products, rounded; an output slot's
        instructions added in bfloat16: ``[N, out_dim]`` bfloat16."""
        bf = torch.bfloat16
        out = x.new_zeros((x.shape[0], self.irreps_out.dim), dtype=bf)
        slots = {}
        for out_off, d, mo, _, xb, A in self._item_products(x, species,
                                                            tables):
            o = torch.einsum("nuw,nuk->nwk", A, xb).reshape(
                x.shape[0], mo * d).to(bf)
            slots[out_off] = o if out_off not in slots else \
                slots[out_off] + o
        for out_off, o in slots.items():
            out[:, out_off: out_off + o.shape[1]] = o
        return out

    def plain_backward(self, x, species, tables, g):
        """Plain PyTorch version of K3b's contract: ``(dx, dtables)`` of
        ``table_product`` for the cotangent ``g``, by autograd; at
        bfloat16 (bfloat16 tables) per instruction the float32 sums
        rounded, dx added over an input slot's instructions in float32
        (float32), dtables bfloat16."""
        if tables.dtype == torch.bfloat16:
            return self._plain_backward_bf16(x, species, tables, g)
        with torch.enable_grad():
            xs = x.detach().requires_grad_(True)
            ts = tables.detach().requires_grad_(True)
            out = self.table_product(xs, species, ts)
            return torch.autograd.grad(out, (xs, ts), g)

    def _plain_backward_bf16(self, x, species, tables, g):
        N = x.shape[0]
        spec = species.reshape(-1)
        dx = x.new_zeros((N, self.in_dim), dtype=torch.float32)
        dt = tables.new_zeros(tables.shape, dtype=torch.float32)
        gf = g.float()
        for out_off, d, mo, (x_off, mul1, a_off), xb, A in \
                self._item_products(x, species, tables):
            gs = gf[:, out_off: out_off + mo * d].reshape(N, mo, d)
            dxi = torch.einsum("nwk,nuw->nuk", gs, A)
            dx[:, x_off: x_off + mul1 * d] += dxi.to(
                torch.bfloat16).float().reshape(N, -1)
            dA = torch.einsum("nwk,nuk->nuw", gs, xb).reshape(N, -1)
            dt[:, a_off: a_off + mul1 * mo] = dt[
                :, a_off: a_off + mul1 * mo].index_add(0, spec, dA)
        return dx, dt.to(torch.bfloat16)


def _plain_forward(sc, x, species, tables, order=None):
    return sc.table_product(x, species, tables)


def _operand(sc, x):
    """x as K3's entry takes it: rounded to bfloat16 at bfloat16."""
    return x.to(sc.compute_dtype)


def _plain_backward(sc, x, species, tables, g, order=None):
    return sc.plain_backward(x, species, tables, g)


def _run_forward(kernel: bool):
    """K3's launch, or its plain contract for CPU tensors (read at call
    time, so that a test may route the launches)."""
    return launch_forward if kernel else _plain_forward


def _run_backward(kernel: bool):
    return launch_backward if kernel else _plain_backward


class SpeciesScalarFCTPFunction(torch.autograd.Function):
    """K3 forward, K3b backward.  Differentiable inputs: ``x`` and the
    tables; autograd carries ``dtables`` on to the weight and attrs."""

    @staticmethod
    def forward(ctx, sc, x, tables, species, perm, ptr, kernel=True):
        tables = tables.contiguous()
        order = species_order.SpeciesOrder(perm, ptr)
        x = _operand(sc, x)
        out = _run_forward(kernel)(sc, x, species, tables, order=order)
        ctx.save_for_backward(x, tables, species, perm, ptr)
        ctx.sc, ctx.kernel = sc, kernel
        return out

    @staticmethod
    def backward(ctx, g):
        x, tables, species, perm, ptr = ctx.saved_tensors
        dx, dtables = _run_backward(ctx.kernel)(
            ctx.sc, x, species, tables, g.contiguous(),
            order=species_order.SpeciesOrder(perm, ptr))
        return None, dx, dtables, None, None, None, None


def _check_inputs(sc, x, species, tables, order):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(
            f"SpeciesScalarFCTP kernel needs CUDA tensors, got {dev}")
    N = x.shape[0]
    cd = sc.compute_dtype   # x, the tables, g and the outputs
    check_tensor(x, "x", (N, sc.in_dim), cd, dev)
    check_tensor(species, "species", (N,), torch.int64, dev)
    check_tensor(tables, "tables", (sc.num_types, sc.table_width), cd, dev)
    if sc.out_table.device != dev:
        raise ValueError("SpeciesScalarFCTP tables are not on the "
                         "input's device")
    if order is None:
        order = species_order.build(species, sc.num_types)
    check_tensor(order.perm, "perm", (N,), torch.int32, dev)
    check_tensor(order.ptr, "ptr", (sc.num_types + 1,), torch.int32, dev)
    return dev, N, order


def launch_forward(sc, x, species, tables, order=None):
    """Launch K3: ``out [N, out_dim]``, on ``order`` (the species order of
    ``species``, built here when missing)."""
    dev, N, order = _check_inputs(sc, x, species, tables, order)
    out_dim = sc.irreps_out.dim
    out = torch.empty((N, out_dim), dtype=sc.compute_dtype, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = lib.species_sc_fwd_bf16 if sc.bf16 else lib.species_sc_fwd
        err = entry(
            x.data_ptr(), N, sc.in_dim, order.perm.data_ptr(),
            order.ptr.data_ptr(), sc.num_types, tables.data_ptr(),
            sc.table_width, sc.out_table.data_ptr(),
            sc.item_table.data_ptr(), sc.fwd_entries_table.data_ptr(),
            sc.fwd_entries.ctypes.data, len(sc.fwd_entries),
            out.data_ptr(), out_dim, stream,
        )
    check(err, "species_sc_fwd")
    if sc.bf16:
        SpeciesScalarFCTP.bf16_launches += 1
    else:
        SpeciesScalarFCTP.launches += 1
    return out


def launch_backward(sc, x, species, tables, g, order=None):
    """Launch K3b: ``(dx [N, in_dim], dtables [types, table_width])``, on
    ``order`` (built here when missing); the dtables partials go to a
    workspace of ``grad_blocks`` tiles.  dx is float32, dtables in the
    compute dtype."""
    dev, N, order = _check_inputs(sc, x, species, tables, order)
    check_tensor(g, "g", (N, sc.irreps_out.dim), sc.compute_dtype, dev)
    if sc.max_d > MAX_D:
        raise ValueError(f"the K3 backward takes irreps up to l = 4, got "
                         f"d = {sc.max_d}")
    dx = torch.empty((N, sc.in_dim), dtype=torch.float32, device=dev)
    dtables = torch.empty((sc.num_types, sc.table_width),
                          dtype=sc.compute_dtype, device=dev)
    chunk_rows = grad_chunk_rows(N, sc.grad_entries,
                                 2 * _multiprocessors(dev))
    ws = torch.empty(
        grad_blocks(N, sc.num_types, sc.grad_entries, chunk_rows) * TILE,
        dtype=torch.float32, device=dev)
    if ws.numel() >= 2 ** 31:
        raise ValueError(f"the K3b workspace of {ws.numel()} floats is too "
                         f"large")
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = lib.species_sc_bwd_bf16 if sc.bf16 else lib.species_sc_bwd
        err = entry(
            x.data_ptr(), N, sc.in_dim, order.perm.data_ptr(),
            order.ptr.data_ptr(), sc.num_types, tables.data_ptr(),
            sc.table_width, g.data_ptr(), sc.irreps_out.dim,
            sc.in_table.data_ptr(), sc.bwd_item_table.data_ptr(),
            sc.dx_entries_table.data_ptr(), sc.dx_entries.ctypes.data,
            len(sc.dx_entries), sc.grad_entries_table.data_ptr(),
            sc.grad_entries.ctypes.data, len(sc.grad_entries), chunk_rows,
            ws.data_ptr(), ws.numel(), dx.data_ptr(), dtables.data_ptr(),
            stream,
        )
    check(err, "species_sc_bwd")
    if sc.bf16:
        SpeciesScalarFCTP.bf16_backward_launches += 1
    else:
        SpeciesScalarFCTP.backward_launches += 1
    return dx, dtables
