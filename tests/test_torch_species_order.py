"""The species order of the self-connection kernels K3 and K3b
(``ops/cuda/species_order.py``) and the kernels' walk over it, on the CPU
in numpy and PyTorch (no JAX):

- ``build`` on hard species tensors (absent species, out-of-range species
  on both sides, one species only, a single node, a padded ``GraphBatch``
  with its dummy node) and ``shared`` (reused for the same unchanged
  tensor, rebuilt after an in-place write, never reused for inference
  tensors);
- a numpy walk of ``csrc/species_sc.cu``'s blocking: the blocks' entries
  and tiles found as the kernels find them, K3's and dx's tiles (64-wide
  column tiles, 64-long reduction chunks, the slot's items summed, each
  element stored once, zeros for out-of-range species and for slots no
  item writes or reads), and dtables' partial tiles per species chunk
  summed in chunk order (absent species' rows zero).  It reproduces the
  plain contracts (``table_product``, ``plain_backward``) at rel-linf 1e-5
  at l <= 3 and l = 4;
- a training step of a narrow model with K3 / K3b routed to the plain
  contracts builds the order once, and every launch receives it.
"""

import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.ops.cuda import species_order
from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as species_sc_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda.species_sc import (
    COLS,
    ROUND,
    TILE_ROWS,
    SpeciesScalarFCTP,
    grad_blocks,
    grad_chunk_rows,
    tile_bound,
    tile_nodes,
)
from equivariant_nn_zoo_tpu_torch.ops.irreps import Irreps
from equivariant_nn_zoo_tpu_torch.ops.tensor_product import fully_connected_tp
from equivariant_nn_zoo_tpu_torch.utils import build, init_parameters
from test_torch_edge_order import SHIFTS, _energy_batch
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

TOL = 1e-5


def _order(species, types):
    o = species_order.build(torch.as_tensor(species), types)
    return o.perm.numpy(), o.ptr.numpy()


def _check_order(species, types):
    """perm is a stable sort by species with out-of-range species last;
    ptr bounds each species' run."""
    species = np.asarray(species).reshape(-1)
    perm, ptr = _order(species, types)
    assert perm.dtype == ptr.dtype == np.int32
    assert sorted(perm.tolist()) == list(range(len(species)))
    key = np.where((species >= 0) & (species < types), species, types)
    assert perm.tolist() == np.argsort(key, kind="stable").tolist()
    assert ptr.shape == (types + 1,)
    for t in range(types):
        assert (species[perm[ptr[t]: ptr[t + 1]]] == t).all()
        assert ptr[t + 1] - ptr[t] == (species == t).sum()
    assert ((species[perm[ptr[types]:]] < 0)
            | (species[perm[ptr[types]:]] >= types)).all()
    return perm, ptr


@pytest.mark.parametrize("case", ["absent", "out_of_range", "one_species",
                                  "single", "padded"])
def test_build_sorts_by_species(case):
    rng = np.random.default_rng(1)
    types = 10
    if case == "absent":
        species = rng.choice([1, 6, 7], size=50)
    elif case == "out_of_range":
        species = rng.integers(0, types, size=60)
        species[::7] = -1
        species[3::11] = types
    elif case == "one_species":
        species = np.full(33, 4)
    elif case == "single":
        species = np.array([3])
    else:
        gb = _energy_batch()  # 64 node slots: padded nodes are species 0
        species = gb["species"].numpy()
        assert gb["_node_mask"][-1, 0] == 0
    perm, ptr = _check_order(species, types)
    if case == "absent":
        assert ptr[1] == ptr[0] == 0 and ptr[2] == ptr[1] + (species == 1
                                                            ).sum()
    elif case == "out_of_range":
        assert len(perm) - ptr[types] == ((species < 0)
                                          | (species >= types)).sum() > 0
    elif case == "one_species":
        assert ptr.tolist() == [0] * 5 + [33] * 6
    elif case == "single":
        assert perm.tolist() == [0] and ptr.tolist() == [0] * 4 + [1] * 7


def test_shared_reuses_the_order_while_species_is_unchanged():
    species = torch.tensor([2, 0, 1, 2, 0, 5])
    builds = species_order.builds
    first = species_order.shared(species.reshape(-1), 6)
    again = species_order.shared(species.reshape(-1), 6)  # a new view
    assert again is first and species_order.builds == builds + 1
    species[0] = 1  # an in-place write bumps the version
    rebuilt = species_order.shared(species, 6)
    assert species_order.builds == builds + 2
    assert rebuilt.perm.tolist() == [1, 4, 0, 2, 3, 5]
    assert rebuilt.ptr.tolist() == [0, 2, 4, 5, 5, 5, 6]
    with torch.inference_mode():
        frozen = torch.tensor([1, 0])
        species_order.shared(frozen, 2)
        species_order.shared(frozen, 2)
    assert species_order.builds == builds + 4


# ---------------------------------------------------------- the kernels' walk

def _find_tile(i, tn, ptr, types, runs, N):
    """``find_tile`` of csrc/species_sc.cu: tile i of the runs in tiles of
    tn positions (run ``types`` is the tail of out-of-range species)."""
    for r in range(runs):
        b, e = int(ptr[r]), int(ptr[r + 1]) if r < types else N
        nt = -(-(e - b) // tn)
        if i < nt:
            return r, b + i * tn, min(b + (i + 1) * tn, e)
        i -= nt
    return None


def _walk_product(sc, src, perm, ptr, tables, bwd):
    """K3 (``bwd`` false: src = x) or dx (src = g) block by block, in
    float64: every element written once."""
    N, types = src.shape[0], sc.num_types
    slots = sc.in_table.reshape(-1, 5).tolist() if bwd else sc.outs
    items = sc.bwd_item_table.reshape(-1, 6).tolist() if bwd else sc.items
    dst = np.zeros((N, sc.in_dim if bwd else sc.irreps_out.dim))
    writes = np.zeros(dst.shape, np.int64)
    for slot, c0, d, tn in (sc.dx_entries if bwd
                            else sc.fwd_entries).tolist():
        dst_off, sd, width, it0, it1 = slots[slot]
        assert sd == d and 1 <= tn and tn * d <= TILE_ROWS
        cw = min(COLS, width - c0)
        for i in range(tile_bound(N, tn, types + 1)):
            tile = _find_tile(i, tn, ptr, types, types + 1, N)
            if tile is None:
                continue
            t, p0, p1 = tile
            nodes = perm[p0:p1]
            acc = np.zeros((len(nodes), d, cw))
            for it in range(it0, it1) if t < types else ():
                if bwd:
                    _, mul1, a_off, src_off, _, mo = items[it]
                    K = mo
                else:
                    _, mul1, a_off = items[it]
                    src_off, K, mo = items[it][0], mul1, width
                A = tables[t, a_off: a_off + mul1 * mo].reshape(mul1, mo)
                for k0 in range(0, K, COLS):
                    kc = min(COLS, K - k0)
                    A_s = (A[c0: c0 + cw, k0: k0 + kc].T if bwd
                           else A[k0: k0 + kc, c0: c0 + cw])
                    rows = src[nodes, src_off + k0 * d:
                               src_off + (k0 + kc) * d].reshape(-1, kc, d)
                    acc += np.einsum("nkm,kc->nmc", rows, A_s)
            cols = slice(dst_off + c0 * d, dst_off + (c0 + cw) * d)
            dst[nodes, cols] = acc.transpose(0, 2, 1).reshape(len(nodes), -1)
            writes[nodes, cols] += 1
    assert (writes == 1).all()
    return dst


def _walk_dtables(sc, x, g, perm, ptr, chunk_rows):
    """K3b's dtables: each (entry, chunk) block's partial tile summed over
    rounds of ROUND // d nodes, then each species' chunks in chunk order."""
    N, types = x.shape[0], sc.num_types
    items = sc.bwd_item_table.reshape(-1, 6).tolist()
    ws, spans, base = {}, [], 0
    for item, u0, w0, d in sc.grad_entries.tolist():
        x_off, mul1, _, out_off, _, mo = items[item]
        tn = tile_nodes(chunk_rows, d)
        uc, wc = min(COLS, mul1 - u0), min(COLS, mo - w0)
        bound = tile_bound(N, tn, types)
        for i in range(bound):
            tile = _find_tile(i, tn, ptr, types, types, N)
            if tile is None:
                continue
            _, p0, p1 = tile
            part = np.zeros((COLS, COLS))
            for p in range(p0, p1, max(1, ROUND // d)):
                nodes = perm[p: min(p + max(1, ROUND // d), p1)]
                xs = x[nodes, x_off + u0 * d: x_off + (u0 + uc) * d]
                gs = g[nodes, out_off + w0 * d: out_off + (w0 + wc) * d]
                part[:uc, :wc] += np.einsum(
                    "nkm,nwm->kw", xs.reshape(len(nodes), uc, d),
                    gs.reshape(len(nodes), wc, d))
            ws[base + i] = part
        spans.append((base, tn))
        base += bound
    assert base == grad_blocks(N, types, sc.grad_entries, chunk_rows)
    dA = np.zeros((types, sc.table_width))
    writes = np.zeros(dA.shape, np.int64)
    for (item, u0, w0, d), (base, tn) in zip(sc.grad_entries.tolist(), spans):
        _, mul1, a_off, _, _, mo = items[item]
        uc, wc = min(COLS, mul1 - u0), min(COLS, mo - w0)
        cols = (a_off + (u0 + np.arange(uc))[:, None] * mo
                + w0 + np.arange(wc)[None, :])
        i0 = 0
        for t in range(types):
            nt = -(-int(ptr[t + 1] - ptr[t]) // tn)
            s = np.zeros((COLS, COLS))
            for c in range(nt):  # chunk order
                s = s + ws[base + i0 + c]
            dA[t, cols] = s[:uc, :wc]
            writes[t, cols] += 1
            i0 += nt
    assert (writes == 1).all()
    return dA


WALK_CASES = {
    # a 150-wide slot (three w tiles), 70 input channels (two chunks and u
    # tiles), an output slot no item writes (1e), an input slot no item
    # reads (2o)
    "l3": ("70x0e+8x1o+8x2e+5x3o+4x2o", "150x0e+8x1o+8x1e+8x2e+5x3o"),
    "l4": ("8x0e+6x3o+8x4e", "24x0e+6x3o+8x4e"),
}


def _walk_case(name, seed=3):
    rng = np.random.default_rng(seed)
    types, N = 7, 300
    feats_in, feats_out = map(Irreps, WALK_CASES[name])
    tp = fully_connected_tp(feats_in, Irreps("4x0e"), feats_out)
    init_parameters(tp, torch.Generator().manual_seed(seed))
    sc = SpeciesScalarFCTP(tp, types)
    species = rng.integers(0, 4, size=N)  # 4, 5 and 6 absent
    species[::13] = -1
    species[5::17] = types
    x = rng.normal(size=(N, feats_in.dim)).astype(np.float32)
    g = rng.normal(size=(N, feats_out.dim)).astype(np.float32)
    tables = rng.normal(size=(types, sc.table_width)).astype(np.float32)
    return sc, species, x, g, tables


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_walk_reproduces_the_plain_contracts(name):
    sc, species, x, g, tables = _walk_case(name)
    # l3 has an output slot no item writes and an input slot none reads
    empty = [it0 == it1 for *_, it0, it1 in sc.outs + sc.in_table.reshape(
        -1, 5).tolist()]
    assert sum(empty) == (2 if name == "l3" else 0)
    perm, ptr = _order(species, sc.num_types)
    valid = (species >= 0) & (species < sc.num_types)
    vt = [torch.tensor(a[valid]) for a in (x, species, g)]
    want_out = sc.table_product(vt[0], vt[1], torch.tensor(tables)).numpy()
    want_dx, want_dA = (t.numpy() for t in sc.plain_backward(
        vt[0], vt[1], torch.tensor(tables), vt[2]))
    x64, g64, t64 = (a.astype(np.float64) for a in (x, g, tables))

    out = _walk_product(sc, x64, perm, ptr, t64, bwd=False)
    assert _rel(out[valid], want_out) <= TOL
    assert not out[~valid].any()
    dx = _walk_product(sc, g64, perm, ptr, t64, bwd=True)
    assert _rel(dx[valid], want_dx) <= TOL
    assert not dx[~valid].any()
    for blocks in (1, 16, 200):  # one chunk per run up to many
        rows = grad_chunk_rows(x.shape[0], sc.grad_entries, blocks)
        dA = _walk_dtables(sc, x64, g64, perm, ptr, rows)
        assert _rel(dA, want_dA) <= TOL
        assert not dA[4:].any()  # absent species


def test_entries_cover_every_column_once():
    """K3's entries tile every output column, dx's every input column,
    dtables' every table column, each once."""
    sc, *_ = _walk_case("l3")
    items = sc.bwd_item_table.reshape(-1, 6).tolist()
    for entries, slots, dim in (
            (sc.fwd_entries, sc.outs, sc.irreps_out.dim),
            (sc.dx_entries, sc.in_table.reshape(-1, 5).tolist(), sc.in_dim)):
        seen = np.zeros(dim, np.int64)
        for slot, c0, d, _ in entries.tolist():
            off, sd, width = slots[slot][:3]
            assert sd == d
            seen[off + c0 * d: off + min(c0 + COLS, width) * d] += 1
        assert (seen == 1).all()
    seen = np.zeros(sc.table_width, np.int64)
    for item, u0, w0, d in sc.grad_entries.tolist():
        _, mul1, a_off, _, _, mo = items[item]
        u = np.arange(u0, min(u0 + COLS, mul1))[:, None]
        w = np.arange(w0, min(w0 + COLS, mo))[None, :]
        np.add.at(seen, (a_off + u * mo + w).reshape(-1), 1)
    assert (seen == 1).all()


# ------------------------------------------------- one order per forward

def test_one_step_builds_the_order_once_and_routes_it(monkeypatch):
    """Through ``SpeciesScalarFCTPFunction`` with K3 / K3b routed to the
    plain contracts: a training step's gradients equal plain autograd's,
    one order is built, and every launch receives it."""
    layers = 3
    model = build(tlc.addEnergyOutput(tlc.featureModel(
        n_dim=8, l_max=2, node_attrs="4x0e", edge_radial="4x0e",
        num_types=10, num_layers=layers, r_max=3.0), SHIFTS))
    init_parameters(model, torch.Generator().manual_seed(0))
    gb = _energy_batch()

    def step():
        model.zero_grad()
        model(gb)["total_energy"].square().sum().backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}

    want = step()
    seen = {"fwd": [], "bwd": []}

    def launch(plain, what):
        def run(sc, *args, order=None):
            seen[what].append(order)
            return getattr(sc, plain)(*args)
        return run

    cls = species_sc_mod.SpeciesScalarFCTP
    monkeypatch.setattr(cls, "forward", cls.launch)
    monkeypatch.setattr(species_sc_mod, "launch_forward",
                        launch("table_product", "fwd"))
    monkeypatch.setattr(species_sc_mod, "launch_backward",
                        launch("plain_backward", "bwd"))
    builds = species_order.builds
    got = step()
    assert species_order.builds == builds + 1
    n_sc = sum(isinstance(m, cls) for m in model.modules())
    assert len(seen["fwd"]) == len(seen["bwd"]) == n_sc >= layers - 1
    first = seen["fwd"][0]
    ref = species_order.build(gb["species"], 10)
    assert all(torch.equal(a, b) for a, b in zip(first, ref))
    for order in seen["fwd"] + seen["bwd"]:
        assert all(a.data_ptr() == b.data_ptr() and torch.equal(a, b)
                   for a, b in zip(order, first))
    assert set(got) == set(want)
    for name in want:
        assert _rel(got[name].numpy(), want[name].numpy()) <= TOL, name
