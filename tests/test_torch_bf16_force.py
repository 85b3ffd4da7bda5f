"""The port's bfloat16 compute dtype on the force path against the JAX
package's (CPU).

At ``tests/test_torch_force.py``'s sizes (8 channels, l <= 2) the port's
bfloat16 plain contracts of K4f, K4b and K4g (``ops/cuda/full_conv_ext.py``
``plain_forward_bf16``, ``plain_backward_bf16``, ``plain_grad2_bf16``,
through the autograd Functions) are held against the TPU kernels at
bfloat16 in interpret mode (``PallasFullConv.apply_grad2``, ``E3_PALLAS``
forced), and the models against the JAX models built with
``E3_PALLAS=force`` and ``E3_COMPUTE_DTYPE=bfloat16``:

- K4f's output; K4b's dx, dsh, dw and dwsel (the gradients of the layer's
  x, sh, radial MLP and mix weights);
- K4g's five cotangents on both second-order routes (inner gradients with
  respect to (x, edge_radial, sh): K4g; to (edge_radial, sh): the pairing
  rule), through the gradients of a force loss with respect to every
  operand and weight (c_g reaches them through a loss quadratic in the
  output);
- the radial MLP's first and second derivatives (``FullyConnectedNet``
  against ``apply_T``, its output rounded);
- the per-node self-connection (``FusedScalarFCTP``) and its gradients;
- a 3-layer ``config_energy_force`` model at n_dim 8: energies, forces, one
  training step's loss and every parameter's gradient;
- a narrow model with the ``"nll"`` head (``config_diffusion``'s: the
  energy ``nll`` of a per-node self-connection trunk, ``score_pos`` its
  negative position gradient): ``score_pos``.

The bar of every check: the port is within HALF of JAX's own distance
between its bfloat16 and float32 results on the same inputs (rel-linf,
per tensor), as in ``tests/test_torch_bf16.py``, whose JAX references are
compiled the same way (``xla_allow_excess_precision`` off, so that XLA's
CPU compiler keeps every bfloat16 rounding of the Pallas source).

Also: the Functions with their launches routed to the plain contracts
give the CPU path's values bit for bit, with the float32 route's launch
counts; a third differentiation raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu.data import Batch as JBatch
from equivariant_nn_zoo_tpu.data import Data as JData
from equivariant_nn_zoo_tpu.data import GraphBatch as JGraphBatch
from equivariant_nn_zoo_tpu.models import layer_configs as jlc
from equivariant_nn_zoo_tpu.nn.message_passing import \
    FactorizedConvolution as JConv
from equivariant_nn_zoo_tpu.ops.fused_tp import \
    FusedScalarFCTP as JFusedScalarFCTP
from equivariant_nn_zoo_tpu.ops.pallas.fused_conv import PallasFullConv
from equivariant_nn_zoo_tpu.run import loss as jloss
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu_torch.data import Batch, Data, GraphBatch
from equivariant_nn_zoo_tpu_torch.models import build_model
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.nn.message_passing import \
    FactorizedConvolution as TConv
from equivariant_nn_zoo_tpu_torch.nn.mlp import FullyConnectedNet
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv_ext as ext_mod
from equivariant_nn_zoo_tpu_torch.ops.fused_tp import FusedScalarFCTP
from equivariant_nn_zoo_tpu_torch.run import Loss
from equivariant_nn_zoo_tpu_torch.utils import (
    build,
    load_jax_params,
    params_from_jax,
)
from test_torch_bf16 import HALF, _jit, _within_half
from test_torch_edge_order import torch_threads_per_worker
from test_torch_force import IN_DIM, KW, TILE_KEYS, _cos, _sin, _tiled_batch
from test_torch_force_model import ATTRS, LOSS, N_GRAPHS, SHIFTS, _molecules

torch_threads_per_worker()

CDS = ("bfloat16", "float32")
PRE = 0.5


@pytest.fixture(scope="module")
def layer():
    """A JAX conv layer, its bfloat16 port (``grad_order=2``) on the same
    parameters, and the layer's operands on a tile-aligned batch."""
    jconv = JConv(**KW, fused=True, compute_dtype="float32")
    params = jconv.init(jax.random.PRNGKey(0))
    tconv = TConv(**KW, grad_order=2, compute_dtype="bfloat16")
    load_jax_params(tconv, params)
    gb = _tiled_batch(seed=5)
    N, E = gb.node_capacity, gb.edge_capacity
    rng = np.random.default_rng(6)
    x = rng.normal(size=(N, IN_DIM)).astype(np.float32)
    sh = rng.normal(size=(E, 9)).astype(np.float32)
    er = (rng.normal(size=(E, 8)) * np.asarray(gb["_edge_mask"])).astype(
        np.float32)
    ei = np.asarray(gb["edge_index"])
    return dict(jconv=jconv, params=params, tconv=tconv, N=N,
                ops=(x, er, sh), ei=ei,
                tiles=tuple(jnp.asarray(gb[k]) for k in TILE_KEYS))


def _jax_out(c, cd):
    """The TPU kernels' conv at ``cd``: out(fc, linear, x, er, sh)."""
    jconv = c["jconv"]
    full = PallasFullConv(jconv.tp, jconv.fc, compute_dtype=getattr(jnp, cd),
                          tile=32, window=32, compute_dsh=True)

    def out(fcp, lp, x_, er_, sh_):
        return full.apply_grad2(fcp, lp, x_, er_, sh_, *c["tiles"], c["N"],
                                pre_scale=PRE)
    return out


def _jax_args(c):
    p = c["params"]
    return (p["fc"], p["tp"]["linear"], *(jnp.asarray(a) for a in c["ops"]))


def _port_out(c, ins):
    t = c["tconv"]
    x, er, sh = ins
    src, dst = (torch.tensor(c["ei"][i]) for i in (0, 1))
    return t.full_conv(t.tp.linear, x, sh, t.fc(er), src, dst, c["N"],
                       pre_scale=PRE)


def _leaves(c, grad=True):
    return [torch.tensor(a, requires_grad=grad) for a in c["ops"]]


def _named(c, fc_grads, lin_grads):
    out = {f"fc.{k}": v for k, v in fc_grads.items()}
    out.update({f"linear.{k}": v for k, v in lin_grads.items()})
    return out


def _port_params(c):
    t = c["tconv"]
    params = dict(t.fc.named_parameters(prefix="fc"))
    params.update(t.tp.linear.named_parameters(prefix="linear"))
    return params


def test_k4f_output_within_half(layer):
    got = _port_out(layer, _leaves(layer, False))
    assert got.dtype == torch.bfloat16
    want = {cd: np.asarray(_jit(_jax_out(layer, cd), *_jax_args(layer)))
            for cd in CDS}
    _within_half(got, want["bfloat16"], want["float32"], "K4f")


@pytest.fixture(scope="module")
def k4b_grads(layer):
    """The gradients of sum(out * sin) (K4b: dx -> x, dsh -> sh, dw -> the
    radial MLP's weights and edge_radial, dwsel -> the mix weights) at
    both dtypes in JAX and at bfloat16 in the port."""
    ref = {}
    for cd in CDS:
        out = _jax_out(layer, cd)

        def e(*a, out=out):
            o = out(*a)
            return jnp.sum(o * jnp.asarray(_sin(o.shape)))
        g = _jit(jax.grad(e, argnums=(0, 1, 2, 3, 4)), *_jax_args(layer))
        ref[cd] = dict(_named(layer, g[0], g[1]), x=g[2], er=g[3], sh=g[4])
    layer["tconv"].zero_grad()
    ins = _leaves(layer)
    o = _port_out(layer, ins).float()
    (o * torch.tensor(_sin(o.shape))).sum().backward()
    got = {n: p.grad.clone() for n, p in _port_params(layer).items()}
    got.update(x=ins[0].grad, er=ins[1].grad, sh=ins[2].grad)
    return got, ref


@pytest.mark.parametrize("which", ["x", "sh", "er", "fc", "linear"])
def test_k4b_gradients_within_half(k4b_grads, which):
    got, ref = k4b_grads
    names = [n for n in got if n == which or n.startswith(which + ".")]
    assert names
    for name in names:
        assert got[name].dtype == torch.float32, name
        _within_half(got[name], np.asarray(ref["bfloat16"][name]),
                     np.asarray(ref["float32"][name]), name)


INNER = {"grad2": (2, 3, 4), "pairing": (3, 4)}


def _jax_force_grads(c, cd, argnums):
    """Inner gradients of E = sum(sin * out^2) with respect to the
    operands ``argnums``, and the gradients of their cos-weighted sum
    with respect to every weight and operand."""
    out = _jax_out(c, cd)

    def e(*a):
        o = out(*a)
        return jnp.sum(jnp.asarray(_sin(o.shape)) * o * o)

    def force_loss(*a):
        gs = jax.grad(e, argnums=argnums)(*a)
        return sum(jnp.sum(g * jnp.asarray(_cos(k, g.shape)))
                   for k, g in enumerate(gs))
    args = _jax_args(c)
    inner = _jit(jax.grad(e, argnums=argnums), *args)
    g = _jit(jax.grad(force_loss, argnums=(0, 1, 2, 3, 4)), *args)
    return inner, dict(_named(c, g[0], g[1]), x=g[2], er=g[3], sh=g[4])


@pytest.fixture(scope="module", params=sorted(INNER))
def k4g_grads(request, layer):
    route = request.param
    argnums = INNER[route]
    ref = {cd: _jax_force_grads(layer, cd, argnums) for cd in CDS}
    layer["tconv"].zero_grad()
    ins = _leaves(layer)
    o = _port_out(layer, ins).float()
    e = (torch.tensor(_sin(o.shape)) * o * o).sum()
    inner = torch.autograd.grad(e, [ins[k - 2] for k in argnums],
                                create_graph=True)
    tot = sum((g * torch.tensor(_cos(k, g.shape))).sum()
              for k, g in enumerate(inner))
    params = _port_params(layer)
    outer = torch.autograd.grad(tot, [*params.values(), *ins])
    got = dict(zip([*params, "x", "er", "sh"], outer))
    return route, [g.detach() for g in inner], got, ref


def test_k4g_cotangents_within_half(k4g_grads, monkeypatch):
    route, inner, got, ref = k4g_grads
    for k, g in enumerate(inner):
        _within_half(g, np.asarray(ref["bfloat16"][0][k]),
                     np.asarray(ref["float32"][0][k]), f"inner {k}")
    assert set(got) == set(ref["bfloat16"][1])
    for name, g in got.items():
        _within_half(g, np.asarray(ref["bfloat16"][1][name]),
                     np.asarray(ref["float32"][1][name]), f"{route} {name}")


def test_k4g_route_taken(layer, monkeypatch):
    """The inner gradients with respect to (x, er, sh) take K4g in the
    second backward, those with respect to (er, sh) the pairing rule (an
    energy linear in the output: no second K4b for c_g)."""
    for route, argnums in INNER.items():
        calls = route_to_plain_bf16(monkeypatch)
        ins = _leaves(layer)
        o = _port_out(layer, ins).float()
        e = (torch.tensor(_sin(o.shape)) * o).sum()
        inner = torch.autograd.grad(e, [ins[k - 2] for k in argnums],
                                    create_graph=True)
        sum(g.sum() for g in inner).backward()
        assert calls == ({"fwd": 1, "bwd": 1, "grad2": 1} if route == "grad2"
                         else {"fwd": 3, "bwd": 3, "grad2": 0}), route
        monkeypatch.undo()


def test_mlp_first_and_second_derivatives_within_half(layer):
    """The radial MLP at bfloat16, its output rounded as apply_grad2
    rounds it (``fused_conv.py:2237-2239``): the output, the gradients of
    sum(w * cot) with respect to the weights and the input, and the
    gradients of a weighted sum of the input gradient (second order), each
    within half of JAX's distance."""
    jfc, p = layer["jconv"].fc, layer["params"]["fc"]
    er = np.random.default_rng(4).normal(size=(200, 8)).astype(np.float32)
    cot = _sin((200, jfc.dims[-1]))
    cot2 = _cos(1, er.shape)

    def apply(cd):
        def w(p_, e):
            return jfc.apply_T(p_, e.T, compute_dtype=cd).astype(
                getattr(jnp, cd)).T

        def first(p_, e):
            return jnp.sum(w(p_, e).astype(jnp.float32) * cot)

        def second(p_, e):
            return jnp.sum(jax.grad(first, argnums=1)(p_, e) * cot2)
        args = (p, jnp.asarray(er))
        return (np.asarray(_jit(w, *args).astype(jnp.float32)),
                _jit(jax.grad(first, argnums=(0, 1)), *args),
                _jit(jax.grad(second, argnums=(0, 1)), *args))

    ref = {cd: apply(cd) for cd in CDS}
    fc = FullyConnectedNet(jfc.dims, compute_dtype="bfloat16")
    load_jax_params(fc, p)
    e = torch.tensor(er, requires_grad=True)
    w = fc(e).to(torch.bfloat16)
    _within_half(w, ref["bfloat16"][0], ref["float32"][0], "MLP")
    ws = [getattr(fc, f"w{i}") for i in range(len(jfc.dims) - 1)]
    g = torch.autograd.grad((w.float() * torch.tensor(cot)).sum(),
                            [*ws, e], create_graph=True)
    g2 = torch.autograd.grad((g[-1] * torch.tensor(cot2)).sum(), [*ws, e])
    for order, got in ((1, g), (2, g2)):
        for i, gi in enumerate(got):
            key = f"w{i}" if i < len(ws) else None
            r16, r32 = (ref[cd][order][0][key] if key else
                        ref[cd][order][1] for cd in CDS)
            _within_half(gi, np.asarray(r16), np.asarray(r32),
                         f"MLP order {order} {key or 'input'}")


def test_fused_scalar_fctp_within_half(layer):
    """The per-node self-connection at bfloat16 (``apply_blocks``'s
    roundings) and its gradients to x, the weight and the attributes."""
    jsc, p = layer["jconv"].sc, layer["params"]["sc"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, IN_DIM)).astype(np.float32)
    attrs = rng.normal(size=(40, 4)).astype(np.float32)
    cot = _sin((40, layer["tconv"].sc.irreps_out.dim))

    def ref(cd):
        sc = JFusedScalarFCTP(jsc, compute_dtype=getattr(jnp, cd))

        def out(p_, x_, a_):
            return sc.apply(p_, x_, a_)
        args = (p, jnp.asarray(x), jnp.asarray(attrs))
        return (np.asarray(_jit(out, *args)),
                _jit(jax.grad(lambda *a: jnp.sum(out(*a) * cot),
                              argnums=(0, 1, 2)), *args))

    (o16, g16), (o32, g32) = ref("bfloat16"), ref("float32")
    t = layer["tconv"]
    t.zero_grad()
    sc = FusedScalarFCTP(t.sc, "bfloat16")
    xt = torch.tensor(x, requires_grad=True)
    at = torch.tensor(attrs, requires_grad=True)
    out = sc(xt, at)
    assert out.dtype == torch.float32
    (out * torch.tensor(cot)).sum().backward()
    _within_half(out, o16, o32, "sc")
    _within_half(t.sc.weight.grad, np.asarray(g16[0]["weight"]),
                 np.asarray(g32[0]["weight"]), "sc weight")
    _within_half(xt.grad, np.asarray(g16[1]), np.asarray(g32[1]), "sc x")
    _within_half(at.grad, np.asarray(g16[2]), np.asarray(g32[2]),
                 "sc attrs")


MODEL_KW = dict(n_dim=8, l_max=2, node_attrs="4x0e", edge_radial="4x0e",
                num_types=10, num_layers=3, r_max=3.0)
NLL_KW = dict(MODEL_KW, num_layers=2)


def _energy_force(lc):
    return lc.addForceOutput(lc.addEnergyOutput(
        lc.featureModel(**MODEL_KW), SHIFTS, output_key="energy"))


def _nll(lc, **kw):
    return lc.addForceOutput(lc.addEnergyOutput(
        lc.featureModel(**NLL_KW, **kw), shifts=None, output_key="nll"),
        y="nll", gradients="score_pos")


CAPS = (256, 1024)   # node and edge capacity (tiles and windows of 128)


def _jax_batch(mols):
    host = JBatch.from_data_list([JData(dict(ATTRS), **m) for m in mols])
    return JGraphBatch.from_batch(host, *CAPS, N_GRAPHS, edge_tile=128,
                                  window=128)


def _port_batch(mols):
    host = Batch.from_data_list([Data(dict(ATTRS), **m) for m in mols])
    gb = GraphBatch.from_batch(host, *CAPS, N_GRAPHS, "cpu")
    assert gb.dropped == 0
    return gb


def _jax_models(config_fn, fn):
    """``fn(model, params)`` for the JAX model built with the Pallas
    kernels forced at each compute dtype, on one set of parameters."""
    mp = pytest.MonkeyPatch()
    ref, params = {}, None
    try:
        mp.setenv("E3_PALLAS", "force")
        for cd in CDS:
            mp.setenv("E3_COMPUTE_DTYPE", cd)
            jmodel = jbuild(config_fn(jlc))
            if params is None:
                params = jmodel.init(jax.random.PRNGKey(0))
            ref[cd] = fn(jmodel, params)
    finally:
        mp.undo()
    return ref, params


@pytest.fixture(scope="module")
def model_case():
    """``config_energy_force``'s model at 3 layers, n_dim 8: JAX's energies,
    forces, one step's loss and gradients at both dtypes, and the port's
    at bfloat16 on the same parameters."""
    mols = _molecules()
    jgb = _jax_batch(mols)
    loss = jloss.Loss(LOSS)

    def fn(jmodel, params):
        def f(p):
            out = jmodel.apply(p, jgb)
            return (loss(out.data, jgb.data)[0],
                    (out["energy"], out["forces"]))
        (v, (e, fo)), g = _jit(jax.value_and_grad(f, has_aux=True), params)
        return (float(v), np.asarray(e), np.asarray(fo),
                params_from_jax(jax.device_get(g)))

    ref, params = _jax_models(_energy_force, fn)
    model = load_jax_params(
        build(tlc.withComputeDtype(_energy_force(tlc), "bfloat16")), params)
    gb = _port_batch(mols)
    out = model(gb)
    lv, _ = Loss(LOSS)(out.data, gb.data)
    lv.backward()
    n_real = int(gb["_node_mask"].sum())
    return dict(ref=ref, loss=lv.item(), n_real=n_real,
                energy=out["energy"].detach().numpy(),
                forces=out["forces"].detach().numpy(),
                grads={n: p.grad.clone() for n, p in
                       model.named_parameters()})


def test_model_energies_forces_and_loss_within_half(model_case):
    (v16, e16, f16, _), (v32, e32, f32, _) = (model_case["ref"][cd]
                                              for cd in CDS)
    n = len(_molecules())
    assert model_case["forces"].dtype == np.float32
    _within_half(model_case["energy"][:n], e16[:n], e32[:n], "energies")
    k = model_case["n_real"]
    _within_half(model_case["forces"][:k], f16[:k], f32[:k], "forces")
    assert abs(model_case["loss"] - v16) <= HALF * abs(v16 - v32)


@pytest.mark.parametrize("part", ["embedding", "layer0", "layer1", "layer2",
                                  "output"])
def test_model_gradients_within_half(model_case, part):
    g16, g32 = (model_case["ref"][cd][3] for cd in CDS)
    grads = model_case["grads"]
    names = [n for n in grads if n.startswith(f"func.{part}")
             or (part == "embedding" and n.startswith("func.node_features"))]
    assert names and set(grads) == set(g16)
    for name in names:
        _within_half(grads[name], g16[name].numpy(), g32[name].numpy(), name)


def test_nll_score_within_half():
    """``score_pos`` = -d nll / d pos of a narrow model with the ``"nll"``
    head on a per-node self-connection trunk, at bfloat16."""
    mols = _molecules(seed=4)
    jgb = _jax_batch(mols)
    ref, params = _jax_models(
        _nll, lambda m, p: np.asarray(_jit(
            lambda p_: m.apply(p_, jgb)["score_pos"], p)))
    model = load_jax_params(
        build(tlc.withComputeDtype(_nll(tlc, species_pure_attrs=False),
                                   "bfloat16")), params)
    assert all(c.fused_sc is not None for c in model.modules()
               if isinstance(c, TConv))
    gb = _port_batch(mols)
    with torch.no_grad():
        got = model(gb)["score_pos"].numpy()
    k = int(gb["_node_mask"].sum())
    _within_half(got[:k], ref["bfloat16"][:k], ref["float32"][:k], "score")


def route_to_plain_bf16(monkeypatch):
    """The bfloat16 conv through its card path (``uses_kernel`` true on the
    CPU, so the edge orders are built and the launches called) with every
    launch replaced by its bfloat16 plain contract; the calls counted."""
    calls = {"fwd": 0, "bwd": 0, "grad2": 0}

    def counted(kind, plain):
        def launch(conv, *args, order=None, **kw):
            assert order is not None
            calls[kind] += 1
            return getattr(conv, plain)(*args, **kw)
        return launch

    monkeypatch.setattr(ext_mod.FullConvExt, "uses_kernel",
                        lambda self, x: True)
    monkeypatch.setattr(ext_mod, "launch_forward",
                        counted("fwd", "plain_forward_bf16"))
    monkeypatch.setattr(ext_mod, "launch_backward",
                        counted("bwd", "plain_backward_bf16"))
    monkeypatch.setattr(ext_mod, "launch_grad2",
                        counted("grad2", "plain_grad2_bf16"))
    return calls


def test_functions_route_to_plain_contracts(monkeypatch):
    """A bfloat16 force-training step through the card path's Functions
    (the launches routed to the plain contracts) gives the CPU path's
    loss, forces and gradients bit for bit; per step each layer runs K4f
    once and K4b twice, layer 0 pairs (two more K4b and K4f calls) and
    the other layers take K4g."""
    mols = _molecules()
    gb = _port_batch(mols)
    mc = tlc.withComputeDtype(_energy_force(tlc), "bfloat16")

    def step(model):
        out = model(gb)
        lv, _ = Loss(LOSS)(out.data, gb.data)
        lv.backward()
        return lv.detach(), out["forces"].detach(), {
            n: p.grad for n, p in model.named_parameters()}

    model = build_model(mc, "cpu", torch.Generator().manual_seed(0))
    want = step(model)
    calls = route_to_plain_bf16(monkeypatch)
    got = step(build_model(mc, "cpu", torch.Generator().manual_seed(0)))
    layers = MODEL_KW["num_layers"]
    assert calls == {"fwd": layers + 2, "bwd": 2 * layers + 2,
                     "grad2": layers - 1}
    assert got[0].item() == want[0].item()
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    for name, g in want[2].items():
        np.testing.assert_array_equal(got[2][name].numpy(), g.numpy(),
                                      err_msg=name)


def test_third_order_raises(layer):
    ins = _leaves(layer)
    o = _port_out(layer, ins).float()
    e = (torch.tensor(_sin(o.shape)) * o).sum()
    inner = torch.autograd.grad(e, ins, create_graph=True)
    tot = sum((g * torch.tensor(_cos(k, g.shape))).sum()
              for k, g in enumerate(inner))
    with pytest.raises(NotImplementedError, match="third-order"):
        torch.autograd.grad(tot, ins[0], create_graph=True)
    assert torch.isfinite(torch.autograd.grad(tot, ins[0])[0]).all()
