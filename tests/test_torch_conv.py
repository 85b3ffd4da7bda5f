"""Parity of the plain versions of the port's CUDA kernels against the JAX
package (CPU, f32, rel-linf 1e-5 forward, 2e-4 gradients as the JAX
package's own kernel-gradient test):

- K1 (``ops/cuda/full_conv.py``, radial MLP + gather + CG TP + scatter +
  mix) against ``FusedUVUConv`` after the JAX radial MLP, and against the
  TPU kernel ``PallasFullConv`` in interpret mode; K2, its VJP, as autograd
  of the plain K1 against the TPU kernel's backward (``compute_dsh`` off);
- K3 (``ops/cuda/species_sc.py``) against ``FusedScalarFCTP`` and the TPU
  kernel ``SpeciesScalarFCTP`` in interpret mode.

On the CPU the wrappers take their plain versions, which is what runs here.
The autograd Functions of the card path are exercised with their launches
routed to the plain contract functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu.data import Batch, Data, GraphBatch
from equivariant_nn_zoo_tpu.data.compute_edge import computeEdgeIndex
from equivariant_nn_zoo_tpu.nn.message_passing import \
    FactorizedConvolution as JConv
from equivariant_nn_zoo_tpu.ops.fused_tp import FusedScalarFCTP, FusedUVUConv
from equivariant_nn_zoo_tpu.ops.pallas.fused_conv import PallasFullConv
from equivariant_nn_zoo_tpu.ops.pallas.sc import SpeciesScalarFCTP
from equivariant_nn_zoo_tpu_torch.nn.message_passing import \
    FactorizedConvolution as TConv
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as species_sc_mod
from equivariant_nn_zoo_tpu_torch.utils.params import load_jax_params

TOL = 1e-5
TYPES = 5
KW = dict(
    input_features="8x0e+8x0o+8x1e+8x1o+8x2e+8x2o",
    output_features="8x0e+8x0o+24x0e+8x1e+8x1o+8x2e+8x2o",
    node_attrs="4x0e",
    edge_radial="8x0e",
    edge_spherical="1x0e+1x1o+1x2e",
    invariant_layers=2,
    invariant_neurons=8,
    avg_num_neighbors=5.0,
    use_sc=True,
)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _tiled_batch(seed=0, n_mol=6, T=32, W=32):
    """A tile-aligned JAX batch (the TPU kernel's layout)."""
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(5, 12))
        d = {"pos": rng.normal(size=(n, 3)) * 1.2,
             "species": rng.choice([1, 6, 7, 8], size=(n, 1))}
        out, attrs = computeEdgeIndex(
            d, {"pos": ("node", "1x1o"), "species": ("node", "1x0e")},
            r_max=3.0)
        d.update(out)
        mols.append(Data(attrs, **d))
    gb = GraphBatch.from_batch(Batch.from_data_list(mols), 128, 512, n_mol,
                               edge_tile=T, window=W)
    assert gb.dropped == 0
    return gb


@pytest.fixture(scope="module")
def convs():
    """A JAX conv layer and its port, on the same parameters."""
    jconv = JConv(**KW, fused=True, compute_dtype="float32")
    params = jconv.init(jax.random.PRNGKey(0))
    tconv = TConv(**KW, sc_species_types=TYPES)
    load_jax_params(tconv, params)
    return jconv, params, tconv


IN_DIM = 144  # 8 channels of 0e, 0o, 1e, 1o, 2e, 2o


def _k1_inputs(seed, N, E, src=None, dst=None, edge_mask=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, IN_DIM)).astype(np.float32)
    sh = rng.normal(size=(E, 9)).astype(np.float32)
    er = rng.normal(size=(E, 8)).astype(np.float32)
    if edge_mask is not None:
        er = er * edge_mask
    if src is None:
        src = rng.integers(0, N, size=E)
        dst = rng.integers(0, N, size=E)
    return x, sh, er, np.asarray(src), np.asarray(dst)


def _port_k1(tconv, x, sh, er, src, dst, N, pre):
    out = tconv.full_conv(
        tconv.fc, tconv.tp.linear, torch.tensor(x), torch.tensor(er),
        torch.tensor(sh), torch.tensor(src, dtype=torch.int64),
        torch.tensor(dst, dtype=torch.int64), N, pre_scale=pre)
    return out.detach().numpy()


@pytest.mark.parametrize("reference", ["fused", "pallas_interpret"])
def test_full_conv_plain_matches_jax(convs, reference):
    jconv, params, tconv = convs
    lp, fcp = params["tp"]["linear"], params["fc"]
    if reference == "fused":
        N, E = 32, 160
        x, sh, er, src, dst = _k1_inputs(1, N, E)
        w = jconv.fc.apply(fcp, jnp.asarray(er), compute_dtype="float32")
        ref = FusedUVUConv(jconv.tp, compute_dtype=jnp.float32)(
            lp, jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(sh), w, N, pre_scale=0.5)
    else:
        gb = _tiled_batch()
        N, E = gb.node_capacity, gb.edge_capacity
        ei = np.asarray(gb["edge_index"])
        # pad edges inside a run point at a real node of it: they vanish
        # only through the masked edge_radial, so both sides get it masked
        x, sh, er, src, dst = _k1_inputs(2, N, E, ei[0], ei[1],
                                         np.asarray(gb["_edge_mask"]))
        full = PallasFullConv(jconv.tp, jconv.fc, compute_dtype=jnp.float32,
                              tile=32, window=32)
        ref = full(fcp, lp, jnp.asarray(x), jnp.asarray(er), jnp.asarray(sh),
                   *(jnp.asarray(gb[k]) for k in (
                       "_edge_tile_win", "_edge_tile_first",
                       "_edge_tile_last", "_edge_src_local",
                       "_edge_dst_local")),
                   N, pre_scale=0.5)
    got = _port_k1(tconv, x, sh, er, src, dst, N, 0.5)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL, _rel(got, ref)


@pytest.mark.parametrize("reference", ["fused", "pallas_interpret"])
def test_species_sc_plain_matches_jax(convs, reference):
    jconv, params, tconv = convs
    rng = np.random.default_rng(3)
    N = 64
    table = rng.normal(size=(TYPES, 4)).astype(np.float32)
    species = rng.integers(0, TYPES, size=(N, 1))
    attrs = table[species[:, 0]]
    x = rng.normal(size=(N, tconv.species_sc.in_dim)).astype(np.float32)
    sc_params = params["sc"]
    if reference == "fused":
        ref = FusedScalarFCTP(jconv.sc, compute_dtype=jnp.float32).apply(
            sc_params, jnp.asarray(x), jnp.asarray(attrs))
    else:
        ref = SpeciesScalarFCTP(jconv.sc, TYPES, compute_dtype=jnp.float32,
                                tile=32).apply(
            sc_params, jnp.asarray(x), jnp.asarray(attrs),
            jnp.asarray(species, jnp.int32))
    got = tconv.species_sc(tconv.sc, torch.tensor(x), torch.tensor(attrs),
                           torch.tensor(species, dtype=torch.int64))
    got = got.detach().numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL, _rel(got, ref)


def test_padded_edges_contribute_nothing(convs):
    """Padded edges (src = dst = dummy node, masked radial) change no row
    but the dummy's, which pooling drops."""
    _, _, tconv = convs
    N, E, pad = 24, 96, 16
    x, sh, er, src, dst = _k1_inputs(4, N, E)
    dst = np.minimum(dst, N - 2)  # the last row is the dummy node
    base = _port_k1(tconv, x, sh, er, src, dst, N, 0.5)
    rng = np.random.default_rng(5)
    src2 = np.concatenate([src, np.full(pad, N - 1)])
    dst2 = np.concatenate([dst, np.full(pad, N - 1)])
    sh2 = np.concatenate([sh, rng.normal(size=(pad, 9)).astype(np.float32)])
    er2 = np.concatenate([er, np.zeros((pad, 8), np.float32)])
    padded = _port_k1(tconv, x, sh2, er2, src2, dst2, N, 0.5)
    assert np.isfinite(padded).all()
    np.testing.assert_allclose(padded[: N - 1], base[: N - 1],
                               rtol=1e-6, atol=1e-6 * np.abs(base).max())


def _sin_cotangent(shape):
    return np.sin(0.1 * np.arange(np.prod(shape))).reshape(shape).astype(
        np.float32)


def test_full_conv_grads_match_pallas_backward(convs):
    """Autograd of the port's plain K1 (the contract K2 implements) against
    the TPU kernel's VJP in interpret mode, with ``compute_dsh=False``:
    d x, d edge_radial, d ``fc.w*`` and d ``tp.linear.*``."""
    jconv, params, tconv = convs
    lp, fcp = params["tp"]["linear"], params["fc"]
    gb = _tiled_batch(seed=3)
    N, E = gb.node_capacity, gb.edge_capacity
    ei = np.asarray(gb["edge_index"])
    x, sh, er, src, dst = _k1_inputs(6, N, E, ei[0], ei[1],
                                     np.asarray(gb["_edge_mask"]))
    full = PallasFullConv(jconv.tp, jconv.fc, compute_dtype=jnp.float32,
                          tile=32, window=32, compute_dsh=False)
    tiles = [jnp.asarray(gb[k]) for k in (
        "_edge_tile_win", "_edge_tile_first", "_edge_tile_last",
        "_edge_src_local", "_edge_dst_local")]
    cot = jnp.asarray(_sin_cotangent((N, full_conv_mod.FullConv(
        tconv.tp, tconv.fc).out_dim)))

    def loss(fcp_, lp_, x_, er_):
        out = full(fcp_, lp_, x_, er_, jnp.asarray(sh), *tiles, N,
                   pre_scale=0.5)
        return jnp.sum(out * cot)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(fcp, lp, jnp.asarray(x),
                                               jnp.asarray(er))
    tconv.zero_grad()
    xt = torch.tensor(x, requires_grad=True)
    ert = torch.tensor(er, requires_grad=True)
    out = tconv.full_conv(tconv.fc, tconv.tp.linear, xt, ert,
                          torch.tensor(sh), torch.tensor(src),
                          torch.tensor(dst), N, pre_scale=0.5)
    (out * torch.tensor(np.asarray(cot))).sum().backward()
    pairs = [(f"fc.{k}", getattr(tconv.fc, k).grad, v)
             for k, v in ref[0].items()]
    pairs += [(f"tp.linear.{k}", getattr(tconv.tp.linear, k).grad, v)
              for k, v in ref[1].items()]
    pairs += [("x", xt.grad, ref[2]), ("edge_radial", ert.grad, ref[3])]
    assert len(pairs) == len(ref[0]) + len(ref[1]) + 2
    for name, got, want in pairs:
        assert _rel(got.numpy(), want) <= 2e-4, (name, _rel(got.numpy(),
                                                            want))


def _route_launches_to_plain(monkeypatch):
    """Send both wrappers through their autograd Functions (the card path)
    with every launch replaced by its plain contract function."""
    monkeypatch.setattr(full_conv_mod.FullConv, "forward",
                        full_conv_mod.FullConv.launch)
    monkeypatch.setattr(species_sc_mod.SpeciesScalarFCTP, "forward",
                        species_sc_mod.SpeciesScalarFCTP.launch)
    monkeypatch.setattr(full_conv_mod, "launch_forward",
                        lambda conv, *a, order=None: conv.plain_forward(*a))
    monkeypatch.setattr(full_conv_mod, "launch_backward",
                        lambda conv, *a, order=None: conv.plain_backward(*a))
    monkeypatch.setattr(species_sc_mod, "launch_forward",
                        lambda sc, *a: sc.table_product(*a))
    monkeypatch.setattr(species_sc_mod, "launch_backward",
                        lambda sc, *a: sc.plain_backward(*a))


def _conv_grads(tconv, x, sh, er, src, dst, table, species):
    tconv.zero_grad()
    xt = torch.tensor(x, requires_grad=True)
    ert = torch.tensor(er, requires_grad=True)
    tb = torch.tensor(table, requires_grad=True)
    sp = torch.tensor(species, dtype=torch.int64)
    data = {"input_features": xt, "edge_radial": ert,
            "edge_spherical": torch.tensor(sh),
            "edge_index": torch.tensor(np.stack([src, dst])),
            "node_attrs": tb[sp], "species": sp}
    out = tconv(data, {"input_features": (None, None)})[0][
        "output_features"]
    (out * torch.tensor(_sin_cotangent(out.shape))).sum().backward()
    grads = {n: p.grad.clone() for n, p in tconv.named_parameters()}
    grads.update(x=xt.grad, edge_radial=ert.grad, table=tb.grad)
    return out.detach(), grads


def test_functions_match_plain_autograd(convs, monkeypatch):
    """The layer's gradients through ``FullConvFunction`` and
    ``SpeciesScalarFCTPFunction`` (launches routed to the plain contracts
    of K1/K2 and K3/K3b) equal plain autograd's, for every parameter, the
    input features, the radial features and the embedding table."""
    _, _, tconv = convs
    N, E = 40, 300
    x, sh, er, src, dst = _k1_inputs(7, N, E)
    rng = np.random.default_rng(8)
    table = rng.normal(size=(TYPES, 4)).astype(np.float32)
    species = rng.integers(0, TYPES, size=N)
    want_out, want = _conv_grads(tconv, x, sh, er, src, dst, table, species)
    _route_launches_to_plain(monkeypatch)
    got_out, got = _conv_grads(tconv, x, sh, er, src, dst, table, species)
    assert _rel(got_out.numpy(), want_out.numpy()) <= TOL
    assert set(got) == set(want)
    for name in want:
        assert _rel(got[name].numpy(), want[name].numpy()) <= TOL, name


def test_function_raises_when_sh_needs_grad(convs, monkeypatch):
    """The sh cotangent belongs to the force path's kernel: the card path
    raises instead of returning a zero gradient for it."""
    _, _, tconv = convs
    _route_launches_to_plain(monkeypatch)
    N, E = 24, 96
    x, sh, er, src, dst = _k1_inputs(9, N, E)
    sh_t = torch.tensor(sh, requires_grad=True)
    with pytest.raises(NotImplementedError, match="sh cotangent"):
        tconv.full_conv(tconv.fc, tconv.tp.linear, torch.tensor(x),
                        torch.tensor(er), sh_t, torch.tensor(src),
                        torch.tensor(dst), N, pre_scale=0.5)
    with torch.no_grad():  # no gradient wanted: the forward runs
        out = tconv.full_conv(tconv.fc, tconv.tp.linear, torch.tensor(x),
                              torch.tensor(er), sh_t, torch.tensor(src),
                              torch.tensor(dst), N, pre_scale=0.5)
    assert out.shape == (N, tconv.full_conv.out_dim)
