"""Parity of the protein configs' modules in the port with the JAX package
(CPU, float32; outputs at rel-linf 1e-5, gradients at 1e-4), on numpy
inputs from a seed:

- ``symmetric_cutoff``, ``RadialBasisEncoding`` with a named or callable
  ``cutoff``, and ``RelativePositionEncoding``: its chain mask and the
  1e5 sentinel, whose envelope is 0 with a finite zero gradient;
- ``LayerNormalization`` and ``MessagePassing(normalize=True)`` at a
  narrow width; ``Split``;
- ``getScaler`` on a host ``Batch`` and on a ``GraphBatch``, for both
  protein configs' scaler chains and their inverses;
- ``masked2indexed`` and ``crop`` with a given generator;
- ``radius_graph_fixed`` and ``computeEdgeIndexDevice`` with
  ``chain_criteria_device`` on the same uniform draws: the edge list,
  mask, segments and counts equal JAX's exactly, also when the buffer
  overflows; padded slots point at the dummy node in the padding segment;
- K1 and K2 at 32-wide radial inputs through their autograd Function
  (launches routed to the plain contracts) against plain autograd.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import equivariant_nn_zoo_tpu.nn as jnn
from equivariant_nn_zoo_tpu.data import Batch as JBatch
from equivariant_nn_zoo_tpu.data import Data as JData
from equivariant_nn_zoo_tpu.data import GraphBatch as JGraphBatch
from equivariant_nn_zoo_tpu.data import compute_edge as jce
from equivariant_nn_zoo_tpu.models import protein_utils as jpu
from equivariant_nn_zoo_tpu.models.layer_configs import \
    featureModel as jfeatureModel
from equivariant_nn_zoo_tpu.utils import utils as jutils
import equivariant_nn_zoo_tpu_torch.nn as tnn
from equivariant_nn_zoo_tpu_torch.data import Batch, Data, GraphBatch
from equivariant_nn_zoo_tpu_torch.data import compute_edge as tce
from equivariant_nn_zoo_tpu_torch.models import protein_utils as tpu
from equivariant_nn_zoo_tpu_torch.models.layer_configs import featureModel
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.utils import build, load_jax_params
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

ATOMS = ("CA", "C", "N", "O")
ATTRS = {"species": ("node", "1x0e"), "chain_id": ("node", "1x0e"),
         "mask": ("node", "1x0e"), "_n_nodes": ("graph", "1x0e"),
         **{a: ("node", "1x1o") for a in ATOMS}}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def proteins(seed, n_prot=3, sizes=(24, 40)):
    """Protein chains as ``tests/test_protein.py`` makes them: random
    walks of 2 A steps, two chains, 10 % unresolved residues, C/N/O near
    each CA."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n_prot):
        n = int(rng.integers(*sizes))
        t = np.cumsum(rng.normal(size=(n, 3)) * 2.0, axis=0)
        item = {"species": rng.integers(0, 20, size=(n, 1)),
                "chain_id": (np.arange(n) // 20).reshape(-1, 1),
                "mask": (rng.random((n, 1)) < 0.9).astype(np.int64),
                "_n_nodes": np.array([[n]]),
                "CA": t.astype(np.float32)}
        for a in ATOMS[1:]:
            item[a] = (t + rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
        items.append(item)
    return items


def indexed(items, pkg):
    """The proteins after ``masked2indexed`` of the package ``pkg`` (the
    JAX or the port's ``protein_utils``), as one host batch."""
    data_cls, batch_cls, pu = ((JData, JBatch, jpu) if pkg == "jax"
                               else (Data, Batch, tpu))
    out = [pu.masked2indexed(batch_cls.from_data_list(
        [data_cls(dict(ATTRS), **it)])) for it in items]
    return batch_cls.from_data_list(
        [data_cls(dict(o.attrs), **{k: o[k] for k in o.keys()})
         for o in out])


# ------------------------------------------------------------- embeddings

def test_symmetric_cutoff_matches_jax():
    x = np.linspace(-200.0, 200.0, 801).astype(np.float32)
    for factor in (1 / 150, 1.0, 1 / 8):
        want = np.asarray(jnn.symmetric_cutoff(jnp.asarray(x), factor))
        got = tnn.symmetric_cutoff(torch.tensor(x), factor).numpy()
        assert rel(got, want) <= 1e-6


def test_sentinel_has_zero_envelope_and_finite_zero_gradient():
    """The cross-chain sentinel 1e5 over r_max 150 is far outside the
    symmetric envelope: value 0 and a gradient that is 0 and finite in
    float32, in both packages."""
    x = torch.tensor([1e5], dtype=torch.float32, requires_grad=True)
    y = tnn.symmetric_cutoff(x, 1 / 150)
    y.sum().backward()
    assert float(y.detach()) == 0.0
    assert torch.isfinite(x.grad).all() and float(x.grad) == 0.0
    g = jax.grad(lambda v: jnn.symmetric_cutoff(v, 1 / 150).sum())(
        jnp.asarray([1e5], jnp.float32))
    assert np.isfinite(np.asarray(g)).all() and float(g[0]) == 0.0


@pytest.mark.parametrize("cutoff", ["symmetric", "poly", "callable"])
def test_radial_basis_cutoff_matches_jax(cutoff):
    jcut = jnn.symmetric_cutoff if cutoff == "callable" else cutoff
    tcut = tnn.symmetric_cutoff if cutoff == "callable" else cutoff
    kw = dict(r_max=150.0, trainable=True, irreps_out="32x0e",
              one_over_r=False)
    jmod = jnn.RadialBasisEncoding(**kw, cutoff=jcut)
    params = jmod.init(jax.random.PRNGKey(1))
    tmod = load_jax_params(tnn.RadialBasisEncoding(**kw, cutoff=tcut),
                           params)
    x = np.random.default_rng(2).uniform(-160, 160, (64, 1)).astype(
        np.float32)
    want, _ = jmod.apply(params, {"input": jnp.asarray(x)},
                         {"input": ("edge", "1x0e")})
    got, _ = tmod({"input": torch.tensor(x)}, {"input": ("edge", "1x0e")})
    assert rel(got["radial_embedding"].detach().numpy(),
               want["radial_embedding"]) <= 1e-5


def relpos_pair():
    radial = dict(r_max=150, trainable=True, one_over_r=False)
    kw = dict(segment=("1x0e", "chain_id"), id=("1x0e", "id"),
              irreps_out=("32x0e", "rel_pos_embed"))
    jmod = jnn.RelativePositionEncoding(
        radial_encoding=dict(radial, module=jnn.RadialBasisEncoding,
                             cutoff=jnn.symmetric_cutoff), **kw)
    params = jmod.init(jax.random.PRNGKey(3))
    tmod = load_jax_params(tnn.RelativePositionEncoding(
        radial_encoding=dict(radial, module=tnn.RadialBasisEncoding,
                             cutoff=tnn.symmetric_cutoff), **kw), params)
    return jmod, params, tmod


def test_relative_position_encoding_matches_jax():
    jmod, params, tmod = relpos_pair()
    rng = np.random.default_rng(4)
    n, e = 30, 200
    chain = (np.arange(n) // 12).reshape(-1, 1)
    idv = (np.arange(n) * 2 + 5).reshape(-1, 1)
    ei = rng.integers(0, n, size=(2, e))
    want, _ = jmod.apply(
        params, {"input": jnp.asarray(chain), "id": jnp.asarray(idv),
                 "edge_index": jnp.asarray(ei)},
        {"input": ("node", "1x0e"), "id": ("node", "1x0e")})
    data = {"input": torch.tensor(chain), "id": torch.tensor(idv),
            "edge_index": torch.tensor(ei)}
    params_t = dict(tmod.named_parameters())
    got, _ = tmod(data, {"input": ("node", "1x0e"), "id": ("node", "1x0e")})
    out = got["output"]
    assert rel(out.detach().numpy(), want["output"]) <= 1e-5
    cross = chain[ei[0], 0] != chain[ei[1], 0]
    assert cross.any() and (~cross).any()
    assert (out[torch.tensor(cross)] == 0).all()
    # the basis frequencies' gradient: finite, none from cross-chain edges
    out.sum().backward()
    grad = params_t["radial.basis.bessel_weights"].grad
    assert torch.isfinite(grad).all()
    jgrad = jax.grad(lambda p: jmod.apply(
        p, {"input": jnp.asarray(chain), "id": jnp.asarray(idv),
            "edge_index": jnp.asarray(ei)},
        {"input": ("node", "1x0e"), "id": ("node", "1x0e")})[0][
            "output"].sum())(params)
    assert rel(grad.numpy(),
               jgrad["radial"]["basis"]["bessel_weights"]) <= 1e-4


# -------------------------------------------------------------- pointwise

NARROW = "8x0e+8x0o+8x1e+8x1o+8x2e+8x2o"


def _grad_pair(jmod, params, tmod, inputs, attrs, key="output"):
    """Output and every parameter's and input's gradient of ``sum(out *
    c)`` (c a fixed cosine) in both packages."""
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    floats = {k: v for k, v in jin.items() if v.dtype == jnp.float32}

    def jout_of(p, x):
        return jmod.apply(p, dict(jin, **x), attrs)[0][key]

    jout = jax.jit(jout_of)(params, floats)
    c = np.cos(np.arange(jout.size)).reshape(jout.shape).astype(np.float32)
    jgp, jgx = jax.jit(jax.grad(lambda p, x: jnp.sum(jout_of(p, x) * c),
                                argnums=(0, 1)))(params, floats)
    tin = {k: torch.tensor(v, requires_grad=v.dtype == np.float32)
           for k, v in inputs.items()}
    tout = tmod(tin, attrs)[0][key]
    (tout * torch.tensor(c)).sum().backward()
    return (jout, tout, jgp, jgx,
            {n: p.grad for n, p in tmod.named_parameters()}, tin)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def test_layer_normalization_matches_jax():
    irreps = "8x0e+8x0o+8x1e+4x1o+4x2e+8x2o+3x3o"
    jmod = jnn.LayerNormalization(irreps, irreps)
    params = {"std": jnp.asarray(np.random.default_rng(5).uniform(
        0.5, 1.5, 7).astype(np.float32))}
    tmod = load_jax_params(tnn.LayerNormalization(irreps, irreps), params)
    dim = sum(int(m) * (2 * int(s[-2]) + 1) for m, s in
              (t.split("x") for t in irreps.split("+")))
    x = np.random.default_rng(6).normal(size=(20, dim)).astype(np.float32)
    x[3] = 0.0          # a zero row: the eps keeps it finite
    jout, tout, jgp, jgx, tgp, tin = _grad_pair(
        jmod, params, tmod, {"input": x}, {"input": ("node", irreps)})
    assert rel(tout.detach().numpy(), jout) <= 1e-5
    assert rel(tgp["std"].numpy(), jgp["std"]) <= 1e-4
    assert rel(tin["input"].grad.numpy(), jgx["input"]) <= 1e-4


def test_split_matches_jax():
    outs = dict(a=("4x0e+2x1o", "a"), b=("3x0e", "b"), c=("2x2e", "c"))
    jmod = jnn.Split(("8x0e+4x1o+2x2e", "x"), **outs)
    params = jmod.init(jax.random.PRNGKey(7))
    tmod = load_jax_params(tnn.Split(("8x0e+4x1o+2x2e", "x"), **outs),
                           params)
    x = np.random.default_rng(8).normal(size=(10, 30)).astype(np.float32)
    want, wattrs = jmod.apply(params, {"input": jnp.asarray(x)},
                              {"input": ("node", "8x0e+4x1o+2x2e")})
    got, attrs = tmod({"input": torch.tensor(x)},
                      {"input": ("node", "8x0e+4x1o+2x2e")})
    assert list(got) == list(want) == ["a", "b", "c"]
    assert attrs == wattrs
    for k in want:
        assert rel(got[k].detach().numpy(), want[k]) <= 1e-5, k


@pytest.fixture(scope="module")
def normalized_layer():
    """A narrow normalized ``MessagePassing`` (the protein trunk's layer
    1) in both packages on the same parameters, and random inputs."""
    kw = dict(n_dim=8, l_max=2, edge_radial="32x0e", num_types=21,
              num_layers=2, r_max=5.0, node_attrs="4x0e",
              edge_spherical="1x0e+1x1o+1x2e", avg_num_neighbors=100,
              normalize=True)
    jnode = dict(jfeatureModel(**kw).layers)["layer1"]
    tnode = dict(featureModel(**kw, species_pure_attrs=False)["layers"])[
        "layer1"]
    jlayer = jutils.build(jnode)
    params = jlayer.init(jax.random.PRNGKey(9))
    tlayer = load_jax_params(build(tnode), params)
    rng = np.random.default_rng(10)
    n, e = 24, 90
    inputs = {
        "input_features": rng.normal(size=(n, 144)).astype(np.float32),
        "node_attrs": rng.normal(size=(n, 4)).astype(np.float32),
        "edge_radial": rng.normal(size=(e, 32)).astype(np.float32),
        "edge_spherical": rng.normal(size=(e, 9)).astype(np.float32),
        "edge_index": rng.integers(0, n, size=(2, e)),
    }
    return jlayer, params, tlayer, inputs


def test_normalized_message_passing_matches_jax(normalized_layer):
    jlayer, params, tlayer, inputs = normalized_layer
    assert tlayer.normalize and isinstance(tlayer.norm,
                                           tnn.LayerNormalization)
    attrs = {"input_features": ("node", NARROW),
             "node_attrs": ("node", "4x0e"),
             "edge_radial": ("edge", "32x0e"),
             "edge_spherical": ("edge", "1x0e+1x1o+1x2e")}
    jout, tout, jgp, jgx, tgp, tin = _grad_pair(
        jlayer, params, tlayer, inputs, attrs, key="output_features")
    assert rel(tout.detach().numpy(), jout) <= 1e-5
    want = _flat(jgp)
    assert set(want) == set(tgp)
    for name, g in want.items():
        assert rel(tgp[name].numpy(), g) <= 1e-4, name
    assert rel(tin["input_features"].grad.numpy(),
               jgx["input_features"]) <= 1e-4


def test_norm_nonlinearity_is_still_refused():
    node = dict(featureModel(n_dim=4, l_max=1, edge_radial="8x0e",
                             num_types=3, num_layers=1, r_max=5.0,
                             node_attrs="3x0e")["layers"])["layer0"]
    with pytest.raises(NotImplementedError):
        build(dict(node, nonlinearity_type="norm"))


# ---------------------------------------------------------------- scalers

def _config_module(name):
    return importlib.import_module(
        f"equivariant_nn_zoo_tpu_torch.models.{name}")


@pytest.mark.parametrize("name", ["config_diffusion_CA",
                                  "config_diffusion_backbone"])
def test_scalers_match_jax_on_host_and_device(name):
    jdc = importlib.import_module(
        f"equivariant_nn_zoo_tpu.models.{name}").get_config().data_config
    dc = _config_module(name).get_config()["data_config"]
    items = proteins(11)
    jhost, host = indexed(items, "jax"), indexed(items, "torch")
    for jscale, scale in ((jdc.scaler, dc["scaler"]),
                          (jdc.inverse_scaler, dc["inverse_scaler"])):
        want = jscale(jhost)
        got = scale(host)
        jgb = jscale(JGraphBatch.from_batch(jhost, 120, 16, 4))
        gb = scale(GraphBatch.from_batch(host, 120, 16, 4, "cpu"))
        for atom in ATOMS:
            assert rel(got[atom], want[atom]) <= 1e-6, atom
            assert rel(gb[atom].numpy(), np.asarray(jgb[atom])) <= 1e-5, atom
            # the device form on the live rows equals the host form
            live = gb["_node_mask"][:, 0] > 0
            assert rel(gb[atom][live].numpy(), got[atom]) <= 1e-5, atom
            assert (gb[atom][~live] == 0).all(), atom
    # each protein's CA centred; the inverse undoes everything but the
    # mean shift: every diffused atom comes back as itself minus the mean
    keys = _config_module(name).get_config()["diffusion_keys"]
    centered = dc["scaler"](host)
    back = dc["inverse_scaler"](centered)
    seg = host.nodeSegment()
    mean = np.stack([host["CA"][seg == g].mean(0)
                     for g in range(len(items))])[seg]
    assert np.abs(centered["CA"] + mean / 25.83
                  - host["CA"] / 25.83).max() <= 1e-5
    for atom in keys:
        assert rel(back[atom], host[atom] - mean) <= 1e-5, atom


# ------------------------------------------------------- masking and crop

def test_masked2indexed_and_crop_match_jax():
    items = proteins(12, n_prot=2, sizes=(40, 60))
    for it in items:
        jb = jpu.masked2indexed(JBatch.from_data_list(
            [JData(dict(ATTRS), **it)]))
        tb = tpu.masked2indexed(Batch.from_data_list(
            [Data(dict(ATTRS), **it)]))
        assert set(tb.keys()) == set(jb.keys())
        for k in jb.keys():
            np.testing.assert_array_equal(np.asarray(tb[k]),
                                          np.asarray(jb[k]), err_msg=k)
        assert tb.attrs["id"] == ("node", "1x0e")
        for keep in (("CA",), ATOMS):
            jd, ja = jpu.crop(dict(jb.data), dict(jb.attrs), max_nodes=20,
                              keep_atoms=keep,
                              rng=np.random.default_rng(13))
            td, ta = tpu.crop(dict(tb.data), dict(tb.attrs), max_nodes=20,
                              keep_atoms=keep,
                              rng=np.random.default_rng(13))
            assert set(td) == set(jd) and ta == ja
            for k in jd:
                np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    data = {"chain_id": np.array([[0], [0], [1], [1]])}
    ei = np.array([[0, 1, 2, 0], [1, 0, 3, 3]])
    np.testing.assert_array_equal(
        tpu.criteria(data, ei, rng=np.random.default_rng(0)),
        jpu.criteria(data, ei, rng=np.random.default_rng(0)))


# ----------------------------------------------------------- radius graph

def _edge_batches(n_cap=100, e_cap=2000, g=4, seed=14):
    """The scaled CA proteins as one JAX and one port padded batch."""
    jdc = importlib.import_module(
        "equivariant_nn_zoo_tpu.models.config_diffusion_CA").get_config(
    ).data_config
    dc = _config_module("config_diffusion_CA").get_config()["data_config"]
    items = proteins(seed)
    jgb = JGraphBatch.from_batch(jdc.scaler(indexed(items, "jax")), n_cap,
                                 e_cap, g)
    gb = GraphBatch.from_batch(dc["scaler"](indexed(items, "torch")), n_cap,
                               e_cap, g, "cpu")
    return jgb, gb


@pytest.mark.parametrize("e_cap", [2000, 700])
def test_device_radius_graph_matches_jax(e_cap):
    """Both edge layers, with the chain criteria on the same uniform
    draws: every output equal; at 700 slots the candidates overflow and
    both drop the same pairs."""
    jgb, gb = _edge_batches(e_cap=e_cap)
    n = gb.node_capacity
    key = jax.random.PRNGKey(15)
    u = np.asarray(jax.random.uniform(key, (n, n)))
    jdata = dict(jgb.data, _edge_rng=key)
    want, wattrs = jce.computeEdgeIndexDevice(
        jdata, dict(jgb.attrs), r_max=8.0 / 25.83, key="CA",
        criteria=jce.chain_criteria_device)
    data = dict(gb.data, _edge_rand=torch.tensor(u))
    got, attrs = tce.computeEdgeIndexDevice(
        data, dict(gb.attrs), r_max=8.0 / 25.83, key="CA",
        criteria=tce.chain_criteria_device)
    assert set(got) == set(want) and attrs == wattrs
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k]), err_msg=k)
    assert got["edge_index"].dtype == torch.int64
    overflow = int(got["_edge_overflow"][0, 0])
    assert (overflow > 0) == (e_cap == 700)
    live = got["_edge_mask"][:, 0] > 0
    assert int(live.sum()) == int(got["_n_edges"].sum())
    dummy = n - 1
    assert (got["edge_index"][:, ~live] == dummy).all()
    assert (got["_edge_segment"][~live] == gb.n_graphs).all()
    # the live edges first, in pair order
    assert live[: int(live.sum())].all()
    key_ = got["edge_index"][0] * n + got["edge_index"][1]
    assert (key_[live][1:] > key_[live][:-1]).all()


def test_radius_graph_without_criteria_and_with_a_generator():
    """Without criteria, the radius graph alone equals JAX's; with the
    criteria and no ``_edge_rand``, the draws come from the layer's
    generator: two calls differ, two fresh generators of one seed agree."""
    jgb, gb = _edge_batches(seed=16)
    args = (8.0 / 25.83, gb.node_capacity - 1)
    want = jce.radius_graph_fixed(
        jgb["CA"], jgb["_node_segment"], jgb["_node_mask"], 2000, *args)
    got = tce.radius_graph_fixed(
        gb["CA"], gb["_node_segment"], gb["_node_mask"], 2000, *args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def edges(rand):
        return tce.computeEdgeIndexDevice(
            dict(gb.data), dict(gb.attrs), r_max=8.0 / 25.83, key="CA",
            criteria=tce.chain_criteria_device, rand=rand)[0]["edge_index"]

    rand = tce.EdgeRandom(3)
    first, second = edges(rand), edges(rand)
    assert not torch.equal(first, second)
    assert torch.equal(first, edges(tce.EdgeRandom(3)))


# ------------------------------------------------------ K1/K2 at R = 32

def test_k1_k2_take_32_wide_radial_inputs(monkeypatch):
    """The protein trunk's conv (32-wide radial inputs, 3 hidden layers):
    ``check_structure`` takes it, and its card path (``FullConvFunction``,
    launches routed to the plain contracts) matches plain autograd in the
    output and every gradient."""
    tnode = dict(featureModel(
        n_dim=8, l_max=2, edge_radial="32x0e", num_types=21, num_layers=2,
        r_max=5.0, node_attrs="4x0e", edge_spherical="1x0e+1x1o+1x2e",
        avg_num_neighbors=100, normalize=True,
        species_pure_attrs=False)["layers"])["layer1"]
    layer = build(tnode)
    torch.manual_seed(0)
    for p in layer.parameters():
        torch.nn.init.normal_(p)
    conv = layer.conv
    fconv = conv.full_conv
    assert fconv.fc_dims[0] == 32
    full_conv_mod.check_structure(fconv, backward=True)
    rng = np.random.default_rng(17)
    n, e = 30, 150
    x = torch.tensor(rng.normal(size=(n, 144)).astype(np.float32))
    er = torch.tensor(rng.normal(size=(e, 32)).astype(np.float32))
    sh = torch.tensor(rng.normal(size=(e, 9)).astype(np.float32))
    src = torch.tensor(rng.integers(0, n, size=e))
    dst = torch.tensor(rng.integers(0, n, size=e))
    gout = torch.tensor(rng.normal(size=(n, fconv.out_dim)).astype(
        np.float32))

    def run():
        xx, ee = x.clone().requires_grad_(), er.clone().requires_grad_()
        layer.zero_grad(set_to_none=True)
        out = fconv(conv.fc, conv.tp.linear, xx, ee, sh, src, dst, n,
                    pre_scale=0.1)
        (out * gout).sum().backward()
        grads = {k: p.grad.clone() for k, p in layer.named_parameters()
                 if p.grad is not None}
        return out.detach(), xx.grad, ee.grad, grads

    want = run()
    calls = {"K1": 0, "K2": 0}

    def counting(key, attr):
        def launch(mod, *args, order=None):
            calls[key] += 1
            return getattr(mod, attr)(*args)
        return launch

    monkeypatch.setattr(full_conv_mod.FullConv, "forward",
                        full_conv_mod.FullConv.launch)
    monkeypatch.setattr(full_conv_mod, "launch_forward",
                        counting("K1", "plain_forward"))
    monkeypatch.setattr(full_conv_mod, "launch_backward",
                        counting("K2", "plain_backward"))
    got = run()
    assert calls == {"K1": 1, "K2": 1}
    for a, b in zip(got[:3], want[:3]):
        assert rel(a.numpy(), b.numpy()) <= 1e-5
    assert set(got[3]) == set(want[3]) and got[3]
    for name in want[3]:
        assert rel(got[3][name].numpy(), want[3][name].numpy()) <= 1e-4, \
            name
