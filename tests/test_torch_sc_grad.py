"""Gradients of the port's species-table self-connection (the tables that
K3 and K3b read) against the per-node formulation and the JAX package.

``SpeciesScalarFCTP.tables`` builds one row per species from the node
attributes.  Its gradient must reach the attributes once per species, as
the JAX kernel's ``.at[].set`` gives it to one winner; an index-put with
repeated species would hand each node of a species the whole gradient, so
the embedding table's gradient would be off by the species counts.  Inputs
are species-pure attributes gathered from a random embedding table, with
one species absent from the batch; tolerance rel-linf 1e-4 of max|grad|
(float32, different summation orders), as the JAX package's own test
(``tests/test_pallas.py::test_species_sc_matches_fused``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu.ops.irreps import Irreps as JIrreps
from equivariant_nn_zoo_tpu.ops.pallas.sc import \
    SpeciesScalarFCTP as JSpeciesScalarFCTP
from equivariant_nn_zoo_tpu.ops.tensor_product import \
    fully_connected_tp as jfully_connected_tp
from equivariant_nn_zoo_tpu_torch.ops.cuda.species_sc import SpeciesScalarFCTP
from equivariant_nn_zoo_tpu_torch.ops.fused_tp import FusedScalarFCTP
from equivariant_nn_zoo_tpu_torch.ops.irreps import Irreps
from equivariant_nn_zoo_tpu_torch.ops.tensor_product import fully_connected_tp
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

TOL = 1e-4
N, TYPES, M2 = 64, 6, 16  # species drawn from 0..4: type 5 is absent
FEATS = [
    "8x0e+8x1o+8x2e",
    "8x0e+8x0o+8x1e+8x1o",
    "8x0e+8x0o+8x1e",
]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _inputs(feats_str):
    rng = np.random.default_rng(0)
    feats = Irreps(feats_str)
    sc = fully_connected_tp(feats, Irreps(f"{M2}x0e"), feats)
    n_w = sum(int(np.prod(sc._weight_shape(i))) for i in sc.instructions)
    return dict(
        sc=sc,
        weight=rng.normal(size=(n_w,)).astype(np.float32),
        table=rng.normal(size=(TYPES, M2)).astype(np.float32),
        species=rng.integers(0, TYPES - 1, size=(N,)),
        x=rng.normal(size=(N, feats.dim)).astype(np.float32),
    )


def _cotangent(shape):
    return np.cos(0.05 * np.arange(np.prod(shape))).reshape(shape).astype(
        np.float32)


def _per_node(mod, x, species, tables):
    """``out[n] = x[n] @ A[species_n]`` per instruction, read from the
    module's kernel tables (output slots and items), in plain PyTorch."""
    outs = mod.out_table.reshape(-1, 5).tolist()
    items = mod.item_table.reshape(-1, 3).tolist()
    A_n = tables[species]
    out = x.new_zeros((x.shape[0], mod.irreps_out.dim))
    for out_off, d, mo, it0, it1 in outs:
        for x_off, mul1, a_off in items[it0:it1]:
            A = A_n[:, a_off: a_off + mul1 * mo].reshape(-1, mul1, mo)
            xb = x[:, x_off: x_off + mul1 * d].reshape(-1, mul1, d)
            o = torch.einsum("nuw,nuk->nwk", A, xb).reshape(-1, mo * d)
            cols = torch.arange(out_off, out_off + mo * d)
            out = out.index_add(1, cols, o)
    return out


def _port_grads(inp, formulation):
    sc = inp["sc"]
    with torch.no_grad():
        sc.weight.copy_(torch.tensor(inp["weight"]))
    sc.weight.grad = None
    x = torch.tensor(inp["x"], requires_grad=True)
    table = torch.tensor(inp["table"], requires_grad=True)
    species = torch.tensor(inp["species"], dtype=torch.int64)
    attrs = table[species]
    if formulation == "tables":
        mod = SpeciesScalarFCTP(sc, TYPES)
        out = _per_node(mod, x, species, mod.tables(sc, attrs, species))
    else:
        out = FusedScalarFCTP(sc)(x, attrs)
    (out * torch.tensor(_cotangent(out.shape))).sum().backward()
    return out.detach().numpy(), {"weight": sc.weight.grad.numpy(),
                                  "x": x.grad.numpy(),
                                  "table": table.grad.numpy()}


@pytest.mark.parametrize("feats_str", FEATS)
def test_table_gradient_matches_per_node(feats_str):
    inp = _inputs(feats_str)
    out_t, g_t = _port_grads(inp, "tables")
    out_f, g_f = _port_grads(inp, "fused")
    assert _rel(out_t, out_f) <= 1e-5
    for name in ("weight", "x", "table"):
        assert _rel(g_t[name], g_f[name]) <= TOL, (name, _rel(g_t[name],
                                                              g_f[name]))
    assert not g_t["table"][TYPES - 1].any()  # the absent species


@pytest.mark.parametrize("feats_str", FEATS)
def test_table_gradient_matches_jax_kernel(feats_str):
    """Against the TPU kernel ``SpeciesScalarFCTP`` in interpret mode on
    the same numpy inputs."""
    inp = _inputs(feats_str)
    feats = JIrreps(feats_str)
    jsc = jfully_connected_tp(feats, JIrreps(f"{M2}x0e"), feats)
    spk = JSpeciesScalarFCTP(jsc, TYPES, compute_dtype=jnp.float32, tile=32)
    spec = jnp.asarray(inp["species"][:, None], jnp.int32)

    def loss(w, x, tb):
        o = spk.apply({"weight": w}, x, tb[spec[:, 0]], spec)
        return jnp.sum(o * jnp.asarray(_cotangent(o.shape)))

    ref = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(inp["weight"]), jnp.asarray(inp["x"]),
        jnp.asarray(inp["table"]))
    _, got = _port_grads(inp, "tables")
    for name, want in zip(("weight", "x", "table"), ref):
        assert _rel(got[name], want) <= TOL, (name, _rel(got[name], want))


def test_plain_contracts_of_k3_and_k3b():
    """``table_product`` (K3's plain contract) is the per-node product and
    ``plain_backward`` (K3b's) its autograd, on the module's tables, which
    are the same whether or not a gradient flows to the attributes."""
    inp = _inputs(FEATS[0])
    sc = inp["sc"]
    with torch.no_grad():
        sc.weight.copy_(torch.tensor(inp["weight"]))
    mod = SpeciesScalarFCTP(sc, TYPES)
    species = torch.tensor(inp["species"], dtype=torch.int64)
    x = torch.tensor(inp["x"], requires_grad=True)
    table = torch.tensor(inp["table"], requires_grad=True)
    with torch.no_grad():  # the index-put that serves inference
        tables = mod.tables(sc, table[species], species)
    # the same rows as the gather that gradients take
    assert torch.equal(tables, mod.tables(sc, table[species], species))
    tables.requires_grad_(True)
    want = _per_node(mod, x, species, tables)
    got = mod.table_product(x, species, tables)
    assert _rel(got.detach(), want.detach()) <= 1e-6
    g = torch.tensor(_cotangent(want.shape))
    dx, dtables = torch.autograd.grad(want, (x, tables), g)
    pdx, pdtables = mod.plain_backward(x.detach(), species, tables.detach(), g)
    assert _rel(pdx, dx) <= 1e-6
    assert _rel(pdtables, dtables) <= 1e-6
