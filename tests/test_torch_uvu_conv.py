"""The per-edge conv (K6, ``ops/cuda/uvu_conv.py``) on the CPU, at a small
size (8 channels of l <= 2, the layer of ``tests/test_pallas.py``):

- its plain version, ``FusedUVUConv`` with ``reduce=False``, against the
  TPU kernel ``PallasUVUConv`` in interpret mode (``tile=32``, float32,
  ``reduce=False``) as ``tests/test_pallas.py`` runs it, and against JAX's
  ``FusedUVUConv``; rel-linf 1e-5 (float32, different summation orders);
- the ``reduce=False`` branch of ``FactorizedConvolution`` (``linear_1``,
  the radial MLP, the conv; no self-connection, no normalisation) against
  the JAX layer on the same parameters;
- the card path (flat mix matrices, the launch counter's place) with the
  launch routed to ``plain_forward``; a call that would need a gradient
  raises on that path;
- K1's size check: the forward takes an l = 4 layer (nine components), the
  backward refuses it.
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
from equivariant_nn_zoo_tpu_torch.utils.params import load_jax_params

TOL = 1e-5
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
    """Send ``UVUConv`` down its card path with the launch replaced by the
    plain contract; count the launches."""
    calls = []

    def launch(conv, *args):
        calls.append(args[1].shape[0])
        return conv.plain_forward(*args)

    monkeypatch.setattr(UVUConv, "forward", UVUConv.launch)
    monkeypatch.setattr(uvu_mod, "launch_forward", launch)
    return calls


def _port_edge_out(tconv, i):
    with torch.no_grad():
        return tconv.full_conv(
            tconv.tp.linear, torch.tensor(i["x"]), torch.tensor(i["sh"]),
            torch.tensor(i["w"]), torch.tensor(i["src"])).numpy()


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


@pytest.mark.parametrize("needs", ["parameter", "x", "sh", "w"])
def test_launch_raises_when_a_gradient_is_needed(convs, routed, needs):
    _, _, tconv, i = convs
    tconv.requires_grad_(needs == "parameter")
    args = [torch.tensor(i[k], requires_grad=needs == k)
            for k in ("x", "sh", "w")]
    try:
        with pytest.raises(NotImplementedError, match="no backward"):
            tconv.full_conv(tconv.tp.linear, *args, torch.tensor(i["src"]))
        assert routed == []
        with torch.no_grad():
            out = tconv.full_conv(tconv.tp.linear, *args,
                                  torch.tensor(i["src"]))
        assert torch.isfinite(out).all() and routed == [E]
    finally:
        tconv.requires_grad_(True)


def test_reduce_false_takes_no_self_connection():
    with pytest.raises(NotImplementedError, match="reduce=False"):
        TConv(**dict(KW, node_attrs="4x0e", use_sc=True),
              sc_species_types=5)
    with pytest.raises(NotImplementedError, match="reduce=False"):
        TConv(**KW, grad_order=2)


def test_k1_forward_takes_l4_and_backward_refuses():
    """The hamiltonian trunk's layers have l = 4 inputs (nine components):
    the forward kernel holds no per-irrep rows and takes them; the backward
    kernels hold ``MAX_D`` = 7 register rows and refuse."""
    conv = TConv(
        input_features="4x0e+4x1o+4x2e+4x3o+4x4e",
        output_features="4x0e+4x1o+4x2e+4x3o+4x4e", node_attrs="4x0e",
        edge_radial="8x0e", edge_spherical="1x0e+1x1o+1x2e+1x3o",
        invariant_layers=3, invariant_neurons=4, avg_num_neighbors=10,
        sc_species_types=9)
    assert conv.full_conv.max_d1 == 9 > full_conv_mod.MAX_D
    full_conv_mod.check_structure(conv.full_conv)
    with pytest.raises(ValueError, match="backward takes left irreps"):
        full_conv_mod.check_structure(conv.full_conv, backward=True)
    small = TConv(
        input_features="4x0e+4x1o+4x2e+4x3o",
        output_features="4x0e+4x1o+4x2e+4x3o", node_attrs="4x0e",
        edge_radial="8x0e", edge_spherical="1x0e+1x1o+1x2e",
        invariant_layers=3, invariant_neurons=4, avg_num_neighbors=10,
        sc_species_types=9)
    full_conv_mod.check_structure(small.full_conv, backward=True)
