"""The per-edge conv (K6 and K6b, ``ops/cuda/uvu_conv.py``) on the CPU, at
a small size (8 channels of l <= 2, the layer of ``tests/test_pallas.py``):

- its plain version, ``FusedUVUConv`` with ``reduce=False``, against the
  TPU kernel ``PallasUVUConv`` in interpret mode (``tile=32``, float32,
  ``reduce=False``) as ``tests/test_pallas.py`` runs it, and against JAX's
  ``FusedUVUConv``; rel-linf 1e-5 (float32, different summation orders);
- the ``reduce=False`` branch of ``FactorizedConvolution`` (``linear_1``,
  the radial MLP, the conv; no self-connection, no normalisation) against
  the JAX layer on the same parameters;
- the card path (flat mix matrices, the launch counters' place) with the
  launches routed to ``plain_forward`` and ``plain_backward``: values, and
  the gradients through ``UVUConvFunction`` against autograd of the plain
  version;
- dx, dsh, dw and the mix ``Linear``'s gradients against the VJP of the TPU
  kernel in interpret mode (as ``tests/test_pallas.py`` differentiates it,
  with ``reduce=False``) at rel-linf 2e-4, and ``plain_backward`` (K6b's
  contract: dx, dsh, dw, dwsel) against autograd of the plain version at
  1e-4;
- the size check of K1 and K2: both take an l = 4 layer (nine components),
  the backward refuses l = 5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu.nn.message_passing import \
    FactorizedConvolution as JConv
from equivariant_nn_zoo_tpu.ops.fused_tp import FusedUVUConv as JFused
from equivariant_nn_zoo_tpu.ops.pallas.fused_conv import PallasUVUConv
from equivariant_nn_zoo_tpu_torch.nn.message_passing import \
    FactorizedConvolution as TConv
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda import uvu_conv as uvu_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda.uvu_conv import UVUConv
from equivariant_nn_zoo_tpu_torch.utils.params import (
    load_jax_params,
    params_from_jax,
)
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

TOL = 1e-5
GRAD_TOL = 1e-4        # gradients: longer sums, other orders
INTERPRET_TOL = 2e-4   # against the interpret-mode kernel's own VJP
SPEC = "8x0e+8x0o+8x1e+8x1o+8x2e+8x2o"
KW = dict(
    input_features=SPEC,
    output_features=SPEC,
    node_attrs=None,
    edge_radial="8x0e",
    edge_spherical="1x0e+1x1o+1x2e",
    invariant_layers=2,
    invariant_neurons=8,
    avg_num_neighbors=1,
    use_sc=False,
    reduce=False,
)
N, E = 32, 128


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def convs():
    """A JAX per-edge conv layer, its port on the same parameters, and
    inputs from a numpy seed."""
    jconv = JConv(**KW, fused=True, compute_dtype="float32")
    params = jconv.init(jax.random.PRNGKey(0))
    tconv = TConv(**KW)
    load_jax_params(tconv, params)
    rng = np.random.default_rng(3)
    inputs = dict(
        x=rng.normal(size=(N, 144)).astype(np.float32),
        sh=rng.normal(size=(E, 9)).astype(np.float32),
        w=(rng.normal(size=(E, tconv.tp.tp.weight_numel)) * 0.3).astype(
            np.float32),
        er=rng.normal(size=(E, 8)).astype(np.float32),
        src=rng.integers(0, N, size=(E,)),
        dst=rng.integers(0, N, size=(E,)),
    )
    return jconv, params, tconv, inputs


@pytest.fixture
def routed(monkeypatch):
    """Send ``UVUConv`` down its card path with the launches replaced by
    the plain contracts.  The returned list holds the edge count of every
    forward launch; its ``backward`` attribute counts the backward
    launches."""

    class Calls(list):
        backward = 0

    calls = Calls()

    def launch(conv, *args):
        calls.append(args[1].shape[0])
        return conv.plain_forward(*args)

    def launch_backward(conv, *args, order=None):
        calls.backward += 1
        return conv.plain_backward(*args)

    monkeypatch.setattr(UVUConv, "forward", UVUConv.launch)
    monkeypatch.setattr(uvu_mod, "launch_forward", launch)
    monkeypatch.setattr(uvu_mod, "launch_backward", launch_backward)
    return calls


def _port_edge_out(tconv, i):
    with torch.no_grad():
        return tconv.full_conv(
            tconv.tp.linear, torch.tensor(i["x"]), torch.tensor(i["sh"]),
            torch.tensor(i["w"]), torch.tensor(i["src"]),
            torch.tensor(i["dst"])).numpy()


@pytest.mark.parametrize("ref_kind", ["interpret_kernel", "fused"])
def test_plain_version_matches_jax(convs, ref_kind):
    jconv, params, tconv, i = convs
    assert isinstance(tconv.full_conv, UVUConv)
    if ref_kind == "interpret_kernel":
        ref_conv = PallasUVUConv(jconv.tp, compute_dtype=jnp.float32,
                                 tile=32)
    else:
        ref_conv = JFused(jconv.tp, compute_dtype=jnp.float32)
    ref = ref_conv(params["tp"]["linear"], jnp.asarray(i["x"]),
                   jnp.asarray(i["src"], jnp.int32),
                   jnp.asarray(i["dst"], jnp.int32), jnp.asarray(i["sh"]),
                   jnp.asarray(i["w"]), N, reduce=False)
    got = _port_edge_out(tconv, i)
    assert got.shape == ref.shape == (E, 144)
    assert _rel(got, ref) < TOL


def test_layer_matches_jax(convs):
    """The whole ``reduce=False`` layer: per-edge rows, no neighbor-count
    factor, ``linear_1`` still applied."""
    jconv, params, tconv, i = convs
    ei = np.stack([i["src"], i["dst"]])
    mask = (np.arange(E) < E - 5).astype(np.float32)[:, None]
    jdata = {"input_features": jnp.asarray(i["x"]),
             "edge_radial": jnp.asarray(i["er"]),
             "edge_spherical": jnp.asarray(i["sh"]),
             "edge_index": jnp.asarray(ei, jnp.int32),
             "_edge_mask": jnp.asarray(mask)}
    attrs = {"input_features": ("node", SPEC)}
    ref, ref_attrs = jconv.apply(params, jdata, attrs)
    tdata = {k: torch.tensor(np.asarray(v)) for k, v in jdata.items()}
    tdata["edge_index"] = torch.tensor(ei)
    with torch.no_grad():
        got, got_attrs = tconv(tdata, attrs)
    assert got_attrs["output_features"] == ref_attrs["output_features"]
    got = got["output_features"].numpy()
    assert _rel(got, ref["output_features"]) < TOL
    assert np.abs(got[-5:]).max() == 0.0   # masked edges give zero rows


def test_kernel_contract_matches_plain(convs, routed):
    """The flat mix matrices and the kernel's contract reproduce the plain
    version."""
    _, _, tconv, i = convs
    got = _port_edge_out(tconv, i)      # the card path, launch routed
    assert routed == [E]
    with torch.no_grad():
        want = tconv.full_conv.fused(
            tconv.tp.linear, torch.tensor(i["x"]), torch.tensor(i["src"]),
            None, torch.tensor(i["sh"]), torch.tensor(i["w"]), N,
            reduce=False).numpy()
    assert _rel(got, want) < TOL


def _leaves(tconv, i, needs):
    """The layer's differentiable inputs as fresh leaves; ``needs`` names
    the ones that ask for a gradient (``parameter``: the mix Linear)."""
    tconv.requires_grad_("parameter" in needs)
    return [torch.tensor(i[k], requires_grad=k in needs)
            for k in ("x", "sh", "w")]


def _cotangent(shape):
    return torch.tensor(np.cos(np.arange(int(np.prod(shape)))).reshape(
        shape).astype(np.float32))


@pytest.mark.parametrize("needs", ["parameter", "x", "sh", "w"])
def test_routed_function_gradients_match_plain(convs, routed, needs):
    """Whatever asks for a gradient, the card path goes through
    ``UVUConvFunction`` (one K6, one K6b) and returns autograd's gradient
    of the plain version; without grad mode it launches K6 alone."""
    _, _, tconv, i = convs
    src, dst = torch.tensor(i["src"]), torch.tensor(i["dst"])
    try:
        args = _leaves(tconv, i, (needs,))
        out = tconv.full_conv(tconv.tp.linear, *args, src, dst)
        wanted = [t for t in (*args, *tconv.tp.linear.parameters())
                  if t.requires_grad]
        got = torch.autograd.grad(out, wanted, _cotangent(out.shape))
        assert routed == [E] and routed.backward == 1
        args = _leaves(tconv, i, (needs,))
        ref = tconv.full_conv.fused(tconv.tp.linear, args[0], src, None,
                                    args[1], args[2], N, reduce=False)
        wanted = [t for t in (*args, *tconv.tp.linear.parameters())
                  if t.requires_grad]
        want = torch.autograd.grad(ref, wanted, _cotangent(ref.shape))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert _rel(g.numpy(), w.numpy()) < GRAD_TOL
        with torch.no_grad():
            tconv.full_conv(tconv.tp.linear, *args, src, dst)
        assert routed == [E, E] and routed.backward == 1
    finally:
        tconv.requires_grad_(True)


def test_gradients_match_interpret_mode_kernel(convs, routed):
    """dx, dsh, dw and the mix Linear's gradients through the routed
    Function against ``jax.grad`` through the TPU kernel in interpret mode
    (its own backward kernel), ``reduce=False``."""
    jconv, params, tconv, i = convs
    kern = PallasUVUConv(jconv.tp, compute_dtype=jnp.float32, tile=32)
    src, dst = (jnp.asarray(i[k], jnp.int32) for k in ("src", "dst"))

    def loss(lp, x, sh, w):
        out = kern(lp, x, src, dst, sh, w, N, reduce=False)
        return jnp.sum(out * jnp.cos(jnp.arange(out.size).reshape(
            out.shape)))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
        params["tp"]["linear"], *(jnp.asarray(i[k])
                                  for k in ("x", "sh", "w")))
    args = _leaves(tconv, i, ("parameter", "x", "sh", "w"))
    out = tconv.full_conv(tconv.tp.linear, *args, torch.tensor(i["src"]),
                          torch.tensor(i["dst"]))
    lin = dict(tconv.tp.linear.named_parameters())
    got = torch.autograd.grad(out, [*args, *lin.values()],
                              _cotangent(out.shape))
    assert routed.backward == 1
    for name, g, want in zip(("dx", "dsh", "dw"), got, ref[1:]):
        assert _rel(g.numpy(), want) < INTERPRET_TOL, name
    want_lin = params_from_jax(jax.device_get(ref[0]))
    assert set(want_lin) == set(lin)
    for name, g in zip(lin, got[3:]):
        assert _rel(g.numpy(), want_lin[name].numpy()) < INTERPRET_TOL, name


def test_plain_backward_matches_autograd(convs):
    """K6b's plain contract (dx, dsh, dw, dwsel on the flat mix matrices)
    against autograd of ``FusedUVUConv(reduce=False)``; ``dwsel`` is
    carried to the Linear's parameters through ``flat_wsel``."""
    _, _, tconv, i = convs
    conv, lin = tconv.full_conv, tconv.tp.linear
    src = torch.tensor(i["src"])
    args = _leaves(tconv, i, ("parameter", "x", "sh", "w"))
    wsel = conv.flat_wsel(lin)
    with torch.no_grad():
        out = conv.plain_forward(*args, wsel, src)
    gout = _cotangent(out.shape)
    dx, dsh, dw, dwsel = conv.plain_backward(*args, wsel, src, gout)
    assert dwsel.shape == (conv.wsel_len,)
    d_lin = torch.autograd.grad(wsel, list(lin.parameters()), dwsel)
    ref = conv.fused(lin, args[0], src, None, args[1], args[2], N,
                     reduce=False)
    want = torch.autograd.grad(ref, [*args, *lin.parameters()], gout)
    for g, w in zip((dx, dsh, dw, *d_lin), want):
        assert _rel(g.numpy(), w.numpy()) < GRAD_TOL


def test_reduce_false_takes_no_self_connection():
    with pytest.raises(NotImplementedError, match="reduce=False"):
        TConv(**dict(KW, node_attrs="4x0e", use_sc=True),
              sc_species_types=5)
    with pytest.raises(NotImplementedError, match="reduce=False"):
        TConv(**KW, grad_order=2)


def _trunk_layer(l_max):
    spec = "+".join(f"4x{l}{'eo'[l % 2]}" for l in range(l_max + 1))
    return TConv(
        input_features=spec, output_features=spec, node_attrs="4x0e",
        edge_radial="8x0e", edge_spherical="1x0e+1x1o+1x2e+1x3o",
        invariant_layers=3, invariant_neurons=4, avg_num_neighbors=10,
        sc_species_types=9)


def test_k1_forward_takes_l4_and_backward_refuses():
    """The hamiltonian trunk's layers have l = 4 inputs (nine components):
    the forward kernel holds no per-irrep rows and takes any degree; the
    backward kernels hold up to ``MAX_D`` = 9 register rows, so they take
    l = 4 and refuse l = 5 (eleven components)."""
    conv = _trunk_layer(4)
    assert conv.full_conv.max_d1 == 9 == full_conv_mod.MAX_D
    full_conv_mod.check_structure(conv.full_conv)
    full_conv_mod.check_structure(conv.full_conv, backward=True)
    wide = _trunk_layer(5)
    assert wide.full_conv.max_d1 == 11
    full_conv_mod.check_structure(wide.full_conv)
    with pytest.raises(ValueError, match="backward takes left irreps"):
        full_conv_mod.check_structure(wide.full_conv, backward=True)
    full_conv_mod.check_structure(_trunk_layer(3).full_conv, backward=True)
