"""The force path's convolution core (K4f, K4b, K4g and their autograd
Functions, ``ops/cuda/full_conv_ext.py``) on the CPU, at a small size
(8 channels of l <= 2, the layer of ``tests/test_pallas.py``):

- against the TPU kernels in interpret mode through JAX's
  ``FactorizedConvolution._second_order_conv`` (``PallasFullConv`` with
  ``compute_dsh``), with the port's Functions routed to the plain
  contracts: the inner gradients (the "forces" with respect to the radial
  features and sh) at rel-linf 2e-4, and the double gradients with respect
  to (fc, linear, x, edge_radial) at 5e-4, as ``tests/test_pallas.py``
  holds the TPU kernels to the XLA path.  Inner gradients with respect to
  (edge_radial, sh) leave dx's cotangent absent, so the second backward
  takes the pairing rule; with x as well it takes K4g.  The counters show
  which ran;
- the Functions (routed to the plain contracts) against plain autograd of
  the CPU route at rel-linf 1e-5, on all three second-order routes, and a
  third differentiation raising.
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
from equivariant_nn_zoo_tpu.ops.pallas.fused_conv import PallasFullConv
from equivariant_nn_zoo_tpu_torch.nn.message_passing import \
    FactorizedConvolution as TConv
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv_ext as ext_mod
from equivariant_nn_zoo_tpu_torch.utils.params import load_jax_params
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

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
IN_DIM = 144  # 8 channels of 0e, 0o, 1e, 1o, 2e, 2o
TILE_KEYS = ("_edge_tile_win", "_edge_tile_first", "_edge_tile_last",
             "_edge_src_local", "_edge_dst_local")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _tiled_batch(seed=0, n_mol=6, T=32, W=32):
    """A tile-aligned JAX batch (the TPU kernels' layout)."""
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
    """A JAX conv layer on the interpret-mode TPU kernels and its port
    (``grad_order=2``), on the same parameters."""
    jconv = JConv(**KW, fused=True, compute_dtype="float32")
    params = jconv.init(jax.random.PRNGKey(0))
    jconv.grad_order = 2
    jconv.full_conv = PallasFullConv(jconv.tp, jconv.fc,
                                     compute_dtype=jnp.float32, tile=32,
                                     window=32, compute_dsh=True)
    tconv = TConv(**KW, grad_order=2)
    load_jax_params(tconv, params)
    return jconv, params, tconv


def route_to_plain(monkeypatch, seen=None):
    """Send the port's conv through its autograd Functions (the card path)
    with every launch replaced by its plain contract (K4f's: ``plain_core``,
    which also returns the scratch); count the calls, and append each
    call's keyword arguments (the edge order, K4b's saved scratch) and
    result to ``seen[kind]`` when a dict is given."""
    calls = {"fwd": 0, "bwd": 0, "grad2": 0}

    def counted(kind, plain):
        def launch(conv, *args, **kw):
            calls[kind] += 1
            out = getattr(conv, plain)(*args)
            if seen is not None:
                seen.setdefault(kind, []).append((kw, out))
            return out
        return launch

    monkeypatch.setattr(ext_mod.FullConvExt, "forward",
                        ext_mod.FullConvExt.launch)
    monkeypatch.setattr(ext_mod, "launch_forward",
                        counted("fwd", "plain_core"))
    monkeypatch.setattr(ext_mod, "launch_backward",
                        counted("bwd", "plain_backward"))
    monkeypatch.setattr(ext_mod, "launch_grad2",
                        counted("grad2", "plain_grad2"))
    return calls


@pytest.fixture
def routed(monkeypatch):
    return route_to_plain(monkeypatch)


def _cos(k, shape):
    n = int(np.prod(shape))
    return np.cos((0.07 - 0.02 * k) * np.arange(n)).reshape(shape).astype(
        np.float32)


def _sin(shape):
    n = int(np.prod(shape))
    return np.sin(0.1 * np.arange(n)).reshape(shape).astype(np.float32)


def _port_energy(tconv, x, er, sh, src, dst, N):
    out = tconv.full_conv(tconv.tp.linear, x, sh, tconv.fc(er), src, dst, N,
                          pre_scale=0.5)
    return (out * torch.tensor(_sin(out.shape))).sum()


def _port_double_grads(tconv, x, er, sh, src, dst, N, argnums):
    """Inner gradients of the energy with respect to ``(x, er, sh)[argnums
    - 2]``, and the gradients of their cos-weighted sum with respect to
    fc, linear, x and er."""
    tconv.zero_grad()
    ins = [torch.tensor(a, requires_grad=True) for a in (x, er, sh)]
    e = _port_energy(tconv, *ins, src, dst, N)
    wrt = [ins[k - 2] for k in argnums]
    inner = torch.autograd.grad(e, wrt, create_graph=True)
    tot = sum((g * torch.tensor(_cos(k, g.shape))).sum()
              for k, g in enumerate(inner))
    params = dict(tconv.fc.named_parameters(prefix="fc"))
    params.update(tconv.tp.linear.named_parameters(prefix="linear"))
    outer = torch.autograd.grad(tot, [*params.values(), ins[0], ins[1]])
    grads = dict(zip([*params, "x", "er"], outer))
    return [g.detach().numpy() for g in inner], grads


@pytest.mark.parametrize("argnums,route", [((3, 4), "pairing"),
                                           ((2, 3, 4), "grad2")])
def test_force_conv_matches_pallas_interpret(convs, routed, argnums, route):
    jconv, params, tconv = convs
    lp, fcp = params["tp"]["linear"], params["fc"]
    gb = _tiled_batch(seed=5)
    N, E = gb.node_capacity, gb.edge_capacity
    rng = np.random.default_rng(6)
    x = rng.normal(size=(N, IN_DIM)).astype(np.float32)
    sh = rng.normal(size=(E, 9)).astype(np.float32)
    er = (rng.normal(size=(E, 8)) * np.asarray(gb["_edge_mask"])).astype(
        np.float32)
    tiles = tuple(jnp.asarray(gb[k]) for k in TILE_KEYS)
    src, dst = (jnp.asarray(gb["edge_index"][i]) for i in (0, 1))

    def e_so(fcp_, lp_, x_, er_, sh_):
        out = jconv._second_order_conv(fcp_, lp_, x_, er_, sh_, tiles, src,
                                       dst, N, 0.5)
        return jnp.sum(out * jnp.asarray(_sin(out.shape)))

    def force_loss(fcp_, lp_, x_, er_, sh_):
        gs = jax.grad(e_so, argnums=argnums)(fcp_, lp_, x_, er_, sh_)
        return sum(jnp.sum(g * jnp.asarray(_cos(k, g.shape)))
                   for k, g in enumerate(gs))

    args = (fcp, lp, jnp.asarray(x), jnp.asarray(er), jnp.asarray(sh))
    j_inner = jax.grad(e_so, argnums=argnums)(*args)
    j_outer = jax.grad(force_loss, argnums=(0, 1, 2, 3))(*args)

    tsrc, tdst = (torch.tensor(np.asarray(gb["edge_index"][i]))
                  for i in (0, 1))
    inner, grads = _port_double_grads(tconv, x, er, sh, tsrc, tdst, N,
                                      argnums)
    for got, want in zip(inner, j_inner):
        assert _rel(got, want) <= 2e-4, _rel(got, want)
    want = {f"fc.{k}": v for k, v in j_outer[0].items()}
    want.update({f"linear.{k}": v for k, v in j_outer[1].items()})
    want.update(x=j_outer[2], er=j_outer[3])
    assert set(grads) == set(want)
    for name, w in want.items():
        assert _rel(grads[name], w) <= 5e-4, (name, _rel(grads[name], w))
    # forward once, K4b for the inner gradient; then the second backward:
    # K4g once, or one K4b and one K4f per live slot (dw and dsh)
    if route == "grad2":
        assert routed == {"fwd": 1, "bwd": 1, "grad2": 1}
    else:
        assert routed == {"fwd": 3, "bwd": 3, "grad2": 0}


def _random_case(seed, N=24, E=120, pad=16):
    """Random operands with padded edges (src = dst = the last node, zero
    radial features, unit sh) at the end."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, IN_DIM)).astype(np.float32)
    sh = rng.normal(size=(E + pad, 9)).astype(np.float32)
    sh[E:] = 0.0
    sh[E:, 0] = 1.0
    er = rng.normal(size=(E + pad, 8)).astype(np.float32)
    er[E:] = 0.0
    src = np.concatenate([rng.integers(0, N - 1, size=E), np.full(pad, N - 1)])
    dst = np.concatenate([rng.integers(0, N - 1, size=E), np.full(pad, N - 1)])
    return x, er, sh, torch.tensor(src), torch.tensor(dst), N


def _double_grads(tconv, x, er, sh, src, dst, N, inner_wrt):
    """Like ``_port_double_grads`` but with any inner set: names from
    ``x``, ``er``, ``sh`` and ``linear`` (the mix weights)."""
    tconv.zero_grad()
    ins = dict(zip(("x", "er", "sh"),
                   (torch.tensor(a, requires_grad=True)
                    for a in (x, er, sh))))
    lin = dict(tconv.tp.linear.named_parameters(prefix="linear"))
    e = _port_energy(tconv, ins["x"], ins["er"], ins["sh"], src, dst, N)
    wrt = [t for k in inner_wrt
           for t in (lin.values() if k == "linear" else [ins[k]])]
    inner = torch.autograd.grad(e, wrt, create_graph=True)
    tot = sum((g * torch.tensor(_cos(k, g.shape))).sum()
              for k, g in enumerate(inner))
    params = dict(tconv.named_parameters())
    outer = torch.autograd.grad(tot, [*params.values(), *ins.values()],
                                allow_unused=True)
    return [g.detach() for g in inner], dict(zip([*params, *ins], outer))


@pytest.mark.parametrize("inner_wrt,want_calls", [
    (("er", "sh"), {"fwd": 3, "bwd": 3, "grad2": 0}),
    (("x", "er", "sh"), {"fwd": 1, "bwd": 1, "grad2": 1}),
    (("sh", "linear"), {"fwd": 3, "bwd": 3, "grad2": 0}),
])
def test_functions_match_plain_autograd(convs, monkeypatch, inner_wrt,
                                        want_calls):
    """Double gradients through ``FullConvExtFunction`` and
    ``FullConvExtBwdFunction`` (launches routed to the plain contracts of
    K4f, K4b and K4g) equal plain autograd of the CPU route, on the K4g
    route and on the pairing route with and without dwsel's cotangent;
    padded edges included, every gradient finite."""
    _, _, tconv = convs
    case = _random_case(7)
    want_inner, want = _double_grads(tconv, *case, inner_wrt)
    calls = route_to_plain(monkeypatch)
    got_inner, got = _double_grads(tconv, *case, inner_wrt)
    assert calls == want_calls
    for a, b in zip(got_inner, want_inner):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5
    assert set(got) == set(want)
    for name in want:
        if want[name] is None:
            assert got[name] is None, name
            continue
        assert torch.isfinite(got[name]).all(), name
        assert _rel(got[name].numpy(), want[name].numpy()) <= 1e-5, name


def test_third_order_raises(convs, routed):
    _, _, tconv = convs
    x, er, sh, src, dst, N = _random_case(8)
    ins = [torch.tensor(a, requires_grad=True) for a in (x, er, sh)]
    e = _port_energy(tconv, *ins, src, dst, N)
    inner = torch.autograd.grad(e, ins, create_graph=True)
    tot = sum((g * torch.tensor(_cos(k, g.shape))).sum()
              for k, g in enumerate(inner))
    with pytest.raises(NotImplementedError, match="third-order"):
        torch.autograd.grad(tot, ins[0], create_graph=True)
    assert torch.isfinite(torch.autograd.grad(tot, ins[0])[0]).all()
