"""The port's bfloat16 compute dtype against the JAX package's (CPU).

At ``test_torch_conv.py``'s narrow widths (8 channels, l <= 2) the port's
plain bfloat16 contracts are held against the TPU kernels at bfloat16 in
interpret mode (``PallasFullConv``, ``SpeciesScalarFCTP``), and the model
against the JAX model built with ``E3_PALLAS=force`` and
``E3_COMPUTE_DTYPE=bfloat16``:

- K1's output; K2's dx, d edge_radial, dW (``fc.w*``) and dwsel (the mix
  ``tp.linear.*``), ``compute_dsh`` off;
- K3's output, K3b's dx and dtables (through the tables to the
  self-connection weight and the embedding rows);
- the radial MLP (``FullyConnectedNet`` at bfloat16 against JAX's
  ``apply``);
- a 3-layer ``config_energy`` model at n_dim 8: its energies, and one
  training step's loss and every parameter's gradient.

The bar of every check: the port is within HALF of JAX's own distance
between its bfloat16 and float32 results on the same inputs (rel-linf,
per tensor), which holds only where the rounding points are mirrored.
Measured when this file was written: K1 0.0 against JAX's 5.7e-3; K2 at
most 1e-7 (``fc.w*``, a division rounded in another order) against
3.2e-3..1.0e-2; the model's energies 1.9e-7 against 5.0e-5, its loss 0.0,
its gradients at most 0.17 of JAX's distance (the embedding's, through
the whole graph).

XLA's CPU compiler drops a bfloat16 rounding that is followed by a
widening cast (``xla_allow_excess_precision``, on by default); the JAX
references are compiled with it off, so that they round wherever the
Pallas source rounds, as the TPU compiler does.

Also: a float32 model equals, bit for bit, the model built without the
option; every route without a bfloat16 kernel variant refuses it at
build, and the force path's (``grad_order=2``, ``config_energy_force``)
builds on the bfloat16 K4 family (``tests/test_torch_bf16_force.py``); the autograd Functions at bfloat16 with their launches routed to
the plain contracts give the plain path's values bit for bit.
"""

import copy

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
from equivariant_nn_zoo_tpu.ops.pallas.fused_conv import PallasFullConv
from equivariant_nn_zoo_tpu.ops.pallas.sc import \
    SpeciesScalarFCTP as JSpeciesSC
from equivariant_nn_zoo_tpu.run import loss as jloss
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.nn.message_passing import \
    FactorizedConvolution as TConv
from equivariant_nn_zoo_tpu_torch.nn.mlp import FullyConnectedNet
from equivariant_nn_zoo_tpu_torch.nn.output import Pairwise
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda.full_conv_ext import FullConvExt
from equivariant_nn_zoo_tpu_torch.ops.cuda import row_mix
from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as species_sc_mod
from equivariant_nn_zoo_tpu_torch.run import Loss
from equivariant_nn_zoo_tpu_torch.utils import (
    build,
    load_jax_params,
    params_from_jax,
)
from test_torch_conv import KW, TYPES, _k1_inputs, _sin_cotangent, \
    _tiled_batch
from test_torch_edge_order import torch_threads_per_worker
from test_torch_train import ATTRS, LOSS, MODEL_KW, N_GRAPHS, SHIFTS, \
    _molecules, _port_batch

torch_threads_per_worker()

HALF = 0.5
OPTS = {"xla_allow_excess_precision": False}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _jit(f, *args):
    """``f(*args)`` compiled with every bfloat16 rounding kept."""
    return jax.jit(f).lower(*args).compile(compiler_options=OPTS)(*args)


def _within_half(got, jax16, jax32, name=""):
    """The port's distance to JAX at bfloat16 is at most half of JAX's
    own bfloat16-vs-float32 distance."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    if not np.abs(jax32).max():
        # a gradient zero by symmetry (a path the output never reads)
        assert not np.abs(got).max() and not np.abs(jax16).max(), name
        return
    mine, theirs = _rel(got, jax16), _rel(jax16, jax32)
    assert theirs > 0, name
    assert mine <= HALF * theirs, (name, mine, theirs)


@pytest.fixture(scope="module")
def convs():
    """A JAX conv layer and its bfloat16 port on the same parameters, and
    K1's inputs on a tile-aligned batch (the TPU kernel's layout)."""
    jconv = JConv(**KW, fused=True, compute_dtype="float32")
    params = jconv.init(jax.random.PRNGKey(0))
    tconv = TConv(**KW, sc_species_types=TYPES, compute_dtype="bfloat16")
    load_jax_params(tconv, params)
    gb = _tiled_batch()
    N, E = gb.node_capacity, gb.edge_capacity
    ei = np.asarray(gb["edge_index"])
    inputs = _k1_inputs(2, N, E, ei[0], ei[1], np.asarray(gb["_edge_mask"]))
    tiles = [jnp.asarray(gb[k]) for k in (
        "_edge_tile_win", "_edge_tile_first", "_edge_tile_last",
        "_edge_src_local", "_edge_dst_local")]
    return dict(jconv=jconv, params=params, tconv=tconv, N=N,
                inputs=inputs, tiles=tiles)


def _jax_k1(c, cd, grads=False):
    """The TPU kernel's output at ``cd``, or with ``grads`` the gradients
    of sum(out * cot) by its VJP (``compute_dsh`` off)."""
    jconv, p, N = c["jconv"], c["params"], c["N"]
    x, sh, er, _, _ = c["inputs"]
    full = PallasFullConv(jconv.tp, jconv.fc, compute_dtype=cd, tile=32,
                          window=32, compute_dsh=False)
    cot = jnp.asarray(_sin_cotangent((N, c["tconv"].full_conv.out_dim)))

    def out(fcp, lp, x_, er_):
        return full(fcp, lp, x_, er_, jnp.asarray(sh), *c["tiles"], N,
                    pre_scale=0.5)

    args = (p["fc"], p["tp"]["linear"], jnp.asarray(x), jnp.asarray(er))
    if not grads:
        return np.asarray(_jit(out, *args))
    return _jit(jax.grad(lambda *a: jnp.sum(out(*a) * cot),
                         argnums=(0, 1, 2, 3)), *args)


def _port_k1(c, grad=False):
    t = c["tconv"]
    x, sh, er, src, dst = c["inputs"]
    t.zero_grad()
    xt = torch.tensor(x, requires_grad=grad)
    ert = torch.tensor(er, requires_grad=grad)
    out = t.full_conv(t.fc, t.tp.linear, xt, ert, torch.tensor(sh),
                      torch.tensor(src), torch.tensor(dst), c["N"],
                      pre_scale=0.5)
    assert out.dtype == torch.bfloat16
    if grad:
        cot = torch.tensor(_sin_cotangent(out.shape))
        (out.float() * cot).sum().backward()
    return out, xt, ert


def test_k1_output_within_half(convs):
    got, _, _ = _port_k1(convs)
    _within_half(got, _jax_k1(convs, jnp.bfloat16),
                 _jax_k1(convs, jnp.float32), "K1")


@pytest.fixture(scope="module")
def k2_grads(convs):
    """JAX's K2 gradients at both dtypes and the port's at bfloat16."""
    g16 = _jax_k1(convs, jnp.bfloat16, grads=True)
    g32 = _jax_k1(convs, jnp.float32, grads=True)
    _, xt, ert = _port_k1(convs, grad=True)
    t = convs["tconv"]
    out = {}
    for i, (prefix, mod) in enumerate((("fc", t.fc), ("tp.linear",
                                                       t.tp.linear))):
        for k in g16[i]:
            out[f"{prefix}.{k}"] = (getattr(mod, k).grad.clone(),
                                    g16[i][k], g32[i][k])
    out["x"] = (xt.grad, g16[2], g32[2])
    out["edge_radial"] = (ert.grad, g16[3], g32[3])
    return out


@pytest.mark.parametrize("which", ["x", "edge_radial", "fc", "tp.linear"])
def test_k2_gradients_within_half(k2_grads, which):
    names = [n for n in k2_grads if n == which or n.startswith(which + ".")]
    assert names
    for name in names:
        got, w16, w32 = k2_grads[name]
        assert got.dtype == torch.float32, name
        _within_half(got, w16, w32, name)


@pytest.fixture(scope="module")
def sc_case(convs):
    """K3's inputs: species-pure attributes of 5 species, 64 nodes."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(TYPES, 4)).astype(np.float32)
    species = rng.integers(0, TYPES, size=(64, 1))
    x = rng.normal(size=(64, convs["tconv"].species_sc.in_dim)).astype(
        np.float32)
    return table, species, x


def _jax_sc(convs, sc_case, cd):
    """K3's output and the gradients of sum(out * cot) to x, the weight
    and the embedding table, through the TPU kernels at ``cd``."""
    table, species, x = sc_case
    sc = JSpeciesSC(convs["jconv"].sc, TYPES, compute_dtype=cd, tile=32)
    cot = jnp.asarray(_sin_cotangent((64, convs["tconv"].sc.irreps_out.dim)))
    spec = jnp.asarray(species, jnp.int32)

    def out(p, x_, tb):
        return sc.apply(p, x_, tb[spec[:, 0]], spec)

    args = (convs["params"]["sc"], jnp.asarray(x), jnp.asarray(table))
    return (np.asarray(_jit(out, *args)),
            _jit(jax.grad(lambda *a: jnp.sum(out(*a) * cot),
                          argnums=(0, 1, 2)), *args))


def test_k3_and_k3b_within_half(convs, sc_case):
    table, species, x = sc_case
    t = convs["tconv"]
    (o16, g16), (o32, g32) = (_jax_sc(convs, sc_case, jnp.bfloat16),
                              _jax_sc(convs, sc_case, jnp.float32))
    t.zero_grad()
    xt = torch.tensor(x, requires_grad=True)
    tb = torch.tensor(table, requires_grad=True)
    sp = torch.tensor(species, dtype=torch.int64)
    out = t.species_sc(t.sc, xt, tb[sp[:, 0]], sp)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.tensor(_sin_cotangent(out.shape))).sum().backward()
    _within_half(out, o16, o32, "K3")
    _within_half(xt.grad, g16[1], g32[1], "K3b dx")
    _within_half(t.sc.weight.grad, g16[0]["weight"], g32[0]["weight"],
                 "K3b dtables -> weight")
    _within_half(tb.grad, g16[2], g32[2], "K3b dtables -> attrs")


def test_mlp_within_half(convs):
    jfc, p = convs["jconv"].fc, convs["params"]["fc"]
    er = np.random.default_rng(4).normal(size=(300, 8)).astype(np.float32)

    def apply(cd):
        return np.asarray(_jit(lambda p_, e: jfc.apply(p_, e,
                                                       compute_dtype=cd),
                               p, jnp.asarray(er)))

    fc = FullyConnectedNet(jfc.dims, compute_dtype="bfloat16")
    load_jax_params(fc, p)
    _within_half(fc(torch.tensor(er)), apply("bfloat16"), apply("float32"),
                 "MLP")


@pytest.fixture(scope="module")
def model_case():
    """The JAX model (E3_PALLAS=force) at both dtypes: per-graph energies,
    one step's loss and gradients; and the port's at bfloat16 on the same
    parameters."""
    mols = _molecules()
    host = JBatch.from_data_list([JData(dict(ATTRS), **m) for m in mols])
    jgb = JGraphBatch.from_batch(host, 256, 1024, N_GRAPHS, edge_tile=128,
                                 window=128)
    mp = pytest.MonkeyPatch()
    ref, params = {}, None
    try:
        mp.setenv("E3_PALLAS", "force")
        for cd in ("float32", "bfloat16"):
            mp.setenv("E3_COMPUTE_DTYPE", cd)
            jmodel = jbuild(jlc.addEnergyOutput(
                jlc.featureModel(**MODEL_KW), SHIFTS))
            if params is None:
                params = jmodel.init(jax.random.PRNGKey(0))
            loss = jloss.Loss(LOSS)

            def f(p, jmodel=jmodel, loss=loss):
                out = jmodel.apply(p, jgb)
                return (loss(out.data, jgb.data)[0],
                        out.data["total_energy"])

            (v, e), g = _jit(jax.value_and_grad(f, has_aux=True), params)
            ref[cd] = (float(v), np.asarray(e)[: len(mols), 0],
                       params_from_jax(jax.device_get(g)))
    finally:
        mp.undo()
    mc = tlc.addEnergyOutput(tlc.featureModel(**MODEL_KW), SHIFTS)
    model = load_jax_params(build(tlc.withComputeDtype(mc, "bfloat16")),
                            params)
    gb = _port_batch(mols)
    out = model(gb)
    loss, _ = Loss(LOSS)(out.data, gb.data)
    loss.backward()
    return dict(ref=ref, loss=loss.item(),
                energy=out["total_energy"].detach().numpy()[: len(mols), 0],
                grads={n: p.grad.clone() for n, p in
                       model.named_parameters()})


def test_model_energies_and_loss_within_half(model_case):
    (v32, e32, _), (v16, e16, _) = (model_case["ref"]["float32"],
                                    model_case["ref"]["bfloat16"])
    _within_half(model_case["energy"], e16, e32, "energies")
    assert abs(model_case["loss"] - v16) <= HALF * abs(v16 - v32)


@pytest.mark.parametrize("part", ["embedding", "layer0", "layer1", "layer2",
                                  "output"])
def test_model_gradients_within_half(model_case, part):
    g32, g16 = model_case["ref"]["float32"][2], model_case["ref"]["bfloat16"][2]
    names = [n for n in model_case["grads"] if n.startswith(part)
             or (part == "embedding" and n.startswith("node_features"))]
    assert names and set(model_case["grads"]) == set(g16)
    for name in names:
        _within_half(model_case["grads"][name], g16[name].numpy(),
                     g32[name].numpy(), name)


def test_float32_model_unchanged():
    """A model built with compute_dtype "float32" is the model built with
    no such key anywhere (the configs before the option): the same
    energies and gradients, bit for bit."""
    mols = _molecules()
    gb = _port_batch(mols)
    mc = tlc.addEnergyOutput(tlc.featureModel(**MODEL_KW), SHIFTS)
    got = []
    for m in (mc, dict(mc, compute_dtype="float32")):
        model = build_model(m, "cpu", torch.Generator().manual_seed(0))
        model.load_state_dict(got[0][2]) if got else None
        out = model(gb)
        assert torch.isfinite(out["total_energy"]).all()
        loss, _ = Loss(LOSS)(out.data, gb.data)
        loss.backward()
        got.append((out["total_energy"].detach(),
                    {n: p.grad for n, p in model.named_parameters()},
                    model.state_dict()))
    np.testing.assert_array_equal(got[0][0].numpy(), got[1][0].numpy())
    for name, g in got[0][1].items():
        np.testing.assert_array_equal(g.numpy(), got[1][1][name].numpy())


def test_float64_copy_keeps_its_dtype():
    """A float64 copy of a float32 model (the protein phases' reference)
    runs in float64: the layers widen only a bfloat16 input, and the
    energies agree with the float32 model's."""
    mols = _molecules()
    gb = _port_batch(mols)
    mc = tlc.addEnergyOutput(tlc.featureModel(**MODEL_KW), SHIFTS)
    model = build_model(mc, "cpu", torch.Generator().manual_seed(0))
    m64 = copy.deepcopy(model).double()
    torch.set_default_dtype(torch.float64)
    try:
        e64 = m64(gb._map(lambda v: v.double() if v.is_floating_point()
                          else v))["total_energy"].detach()
    finally:
        torch.set_default_dtype(torch.float32)
    assert e64.dtype == torch.float64
    e32 = model(gb)["total_energy"].detach()
    assert torch.isfinite(e64).all()
    assert _rel(e32.double(), e64) <= 1e-5


@pytest.mark.parametrize("route", ["reduce", "per_node_sc", "pairwise",
                                   "config_hamiltonian", "sh_gradient"])
def test_routes_without_bf16_kernels_refuse(route):
    kw = dict(KW, compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="bfloat16|dsh"):
        if route == "reduce":
            TConv(**dict(kw, use_sc=False, node_attrs=None), reduce=False)
        elif route == "per_node_sc":
            TConv(**kw)
        elif route == "pairwise":
            Pairwise("8x0e+8x1o", "8x0e", "1x0e+1x1o", "8x0e+8x1o",
                     "8x0e+8x1o", compute_dtype="bfloat16")
        elif route == "sh_gradient":
            t = TConv(**kw, sc_species_types=TYPES)
            x, sh, er, src, dst = _k1_inputs(5, 12, 40)
            t.full_conv(t.fc, t.tp.linear, torch.tensor(x),
                        torch.tensor(er),
                        torch.tensor(sh, requires_grad=True),
                        torch.tensor(src), torch.tensor(dst), 12)
        else:
            mc = dict(get_config(route)["model_config"],
                      compute_dtype="bfloat16")
            build_model(mc, "cpu")


@pytest.mark.parametrize("name", ["config_energy", "config_dipole",
                                  "grad_order", "config_energy_force",
                                  "config_diffusion_nll"])
def test_bf16_configs_build(name):
    """``config_energy`` and ``config_dipole`` build at bfloat16 from their
    model config's key: every conv takes the bfloat16 kernels (K1/K2 and
    K3/K3b); a ``grad_order=2`` layer, ``config_energy_force`` and
    ``config_diffusion`` ``"nll"`` take the bfloat16 K4 family and the
    per-node self-connection at bfloat16."""
    if name == "grad_order":
        convs = [TConv(**KW, sc_species_types=TYPES, grad_order=2,
                       compute_dtype="bfloat16")]
    else:
        cfg = (get_config("config_diffusion", "nll")
               if name == "config_diffusion_nll" else get_config(name))
        mc = dict(cfg["model_config"], compute_dtype="bfloat16")
        convs = [m for m in build_model(mc, "cpu").modules()
                 if isinstance(m, TConv)]
        assert len(convs) == mc["num_layers"], name
    assert convs and all(c.full_conv.bf16 and c.fc.compute_dtype == torch.
                         bfloat16 for c in convs), name
    for c in convs:
        if c.grad_order >= 2:
            assert isinstance(c.full_conv, FullConvExt) and c.species_sc \
                is None and c.fused_sc.compute_dtype == torch.bfloat16, name
        else:
            assert c.species_sc.bf16, name


def _route(monkeypatch, counts):
    """The card path's autograd Functions with every launch routed to the
    bfloat16 plain contracts, counted."""
    def counted(key, fn):
        def run(*a, **kw):
            counts[key] = counts.get(key, 0) + 1
            return fn(*a)
        return run

    for cls in (full_conv_mod.FullConv, species_sc_mod.SpeciesScalarFCTP):
        monkeypatch.setattr(cls, "forward", cls.launch)
    monkeypatch.setattr(full_conv_mod, "launch_forward", counted(
        "K1", lambda conv, *a: conv.plain_forward_bf16(*a)))
    monkeypatch.setattr(full_conv_mod, "launch_backward", counted(
        "K2", lambda conv, *a: conv.plain_backward_bf16(*a)))
    monkeypatch.setattr(species_sc_mod, "launch_forward", counted(
        "K3", lambda sc, *a: sc.table_product(*a)))
    monkeypatch.setattr(species_sc_mod, "launch_backward", counted(
        "K3b", lambda sc, *a: sc.plain_backward(*a)))


def test_functions_route_to_plain_contracts(monkeypatch):
    """A bfloat16 training step through the card path's Functions (the
    launches routed to the plain contracts) gives the CPU path's loss and
    gradients bit for bit, with one K1, K2, K3 and K3b per layer."""
    mols = _molecules()
    gb = _port_batch(mols)
    mc = tlc.withComputeDtype(
        tlc.addEnergyOutput(tlc.featureModel(**MODEL_KW), SHIFTS),
        "bfloat16")

    def step(model):
        out = model(gb)
        loss, _ = Loss(LOSS)(out.data, gb.data)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in
                               model.named_parameters()}

    model = build_model(mc, "cpu")
    want = step(model)
    counts = {}
    _route(monkeypatch, counts)
    routed = build_model(mc, "cpu")
    got = step(routed)
    assert counts == {"K1": 3, "K2": 3, "K3": 3, "K3b": 3}
    assert got[0].item() == want[0].item()
    for name, g in want[1].items():
        np.testing.assert_array_equal(got[1][name].numpy(), g.numpy())


def test_gemm_plain_version_rounds_operands():
    """The mix GEMM's bfloat16 plain version (``row_mix`` on CPU tensors
    with ``bf16``) is the float32 plan on operands rounded to bfloat16."""
    conv = TConv(**KW, sc_species_types=TYPES).full_conv
    rng = np.random.default_rng(6)
    S = torch.tensor(rng.normal(size=(40, conv.KM)).astype(np.float32))
    wsel = torch.tensor(rng.normal(size=conv.wsel_len).astype(np.float32))
    g = torch.tensor(rng.normal(size=(40, conv.out_dim)).astype(np.float32))
    r = full_conv_mod.round_bf16
    got = row_mix.launch_forward(S, wsel, conv.prob_rows, conv.out_dim,
                                 bf16=True)
    want = row_mix.launch_forward(r(S), r(wsel), conv.prob_rows,
                                  conv.out_dim)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for kind in (row_mix.ROWS, row_mix.WEIGHTS):
        got = row_mix.launch_backward(kind, conv.prob_rows, conv.KM, g, S=S,
                                      wsel=wsel, wsel_len=conv.wsel_len,
                                      bf16=True)
        want = row_mix.launch_backward(kind, conv.prob_rows, conv.KM, r(g),
                                       S=r(S), wsel=r(wsel),
                                       wsel_len=conv.wsel_len)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    A, B = S[:, :16].contiguous(), g[:, :24].contiguous()
    np.testing.assert_array_equal(
        row_mix.launch_matmul(A, B, a_t=True, bf16=True).numpy(),
        (r(A).T @ r(B)).numpy())
