"""Protein diffusion in the port (``config_diffusion_CA``,
``config_diffusion_backbone``) held to the JAX package on the CPU, as
``tests/test_protein.py`` runs the JAX pipeline: an HDF5 file of synthetic
proteins written to a temporary directory, ``CondensedDataset`` -> loader
(``masked2indexed``, ``crop``, the config's ``edge_capacity``) -> scaler
-> the model, whose first layer builds the radius graph in its buffer.

- The loader's batches and the scaler's output equal the JAX pipeline's;
- both configs' layer lists, settings and parameter trees (full width)
  are the JAX configs';
- at n_dim 8 (2 layers; the backbone's ``concat3`` needs 4) with the
  32-wide radial inputs and node attributes kept: every ``score_*`` at
  given times against the JAX default CPU path at rel-linf 1e-5 on shared
  weights and the same edge draws, the edges exactly; one SDE
  micro-step's loss and gradients at 1e-4 on replayed t, z and edge
  draws; the PC sampler (four diffusion keys, an edge set drawn anew per
  evaluation as JAX folds it from t) and its inverse-scaled host batch at
  1e-4;
- the card path's Functions, launches routed to the plain contracts: K1
  once per layer and evaluation (8 at full depth), K2 once per layer and
  micro-step, never K3, K3b or the K4 family;
- ``check_structure`` takes every conv of both full-width configs and
  refuses radial inputs wider than 64;
- the sampler rebuilds the edges from the current CA in every evaluation;
  ``saveProtein`` writes the sample.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from ml_collections.config_dict import ConfigDict

from equivariant_nn_zoo_tpu.data.dataloader import \
    getDataIters as jgetDataIters
from equivariant_nn_zoo_tpu.models import get_config as jget_config
from equivariant_nn_zoo_tpu.run import sde_sampling as jsampling
from equivariant_nn_zoo_tpu.run import sde_utils as jsde
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu_torch.data import Batch, getDataIters
from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
from equivariant_nn_zoo_tpu_torch.nn import FactorizedConvolution
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.run import sde_sampling, sde_utils
from equivariant_nn_zoo_tpu_torch.utils import build, load_jax_params
from equivariant_nn_zoo_tpu_torch.utils.saveload import saveProtein
from test_torch_diffusion import route_all
from test_torch_edge_order import torch_threads_per_worker
from test_torch_sde import Replay, flat, rel

torch_threads_per_worker()

CONFIGS = ("config_diffusion_CA", "config_diffusion_backbone")
NARROW = {"config_diffusion_CA": dict(n_dim=8, num_layers=2),
          "config_diffusion_backbone": dict(n_dim=8, num_layers=4)}
E_CAP = 4096
T = np.array([[0.3], [0.8]], np.float32)
SAMPLER_SDE = dict(beta_min=0.1, beta_max=4.0, N=5)


def write_proteins(path, seed=5, n=16):
    """``tests/test_protein.py``'s file: random-walk chains of 24-47
    residues, two chains each, 10 % unresolved, C/N/O near each CA."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        k = int(rng.integers(24, 48))
        t = np.cumsum(rng.normal(size=(k, 3)) * 2.0, axis=0)
        item = {"species": rng.integers(0, 20, size=(k, 1)),
                "chain_id": (np.arange(k) // 24).reshape(-1, 1),
                "mask": (rng.random((k, 1)) < 0.9).astype(np.int64),
                "_n_nodes": k, "CA": t.astype(np.float32)}
        for a in ["C", "N", "O"]:
            item[a] = (t + rng.normal(size=(k, 3)) * 0.5).astype(np.float32)
        items.append(item)
    attrs = {"species": ("node", "1x0e"), "chain_id": ("node", "1x0e"),
             "mask": ("node", "1x0e"), "_n_nodes": ("graph", "1x0e")}
    for a in ["CA", "C", "N", "O"]:
        attrs[a] = ("node", "1x1o")
    Batch.from_data_list(items, attrs).dumpHDF5(str(path))
    return str(path)


@pytest.fixture(scope="module")
def protein_file(tmp_path_factory):
    return write_proteins(tmp_path_factory.mktemp("prot") / "pdb_0.hdf5")


def narrow_jax_config(name, **widths):
    """The JAX config ``name`` with ``widths`` (``n_dim``, ``num_layers``)
    in place of its own: its ``ConfigDict`` sets them as it builds."""
    mod = importlib.import_module(f"equivariant_nn_zoo_tpu.models.{name}")

    class Narrow(ConfigDict):
        def __setattr__(self, key, value):
            super().__setattr__(key, widths.get(key, value))

    old = mod.ConfigDict
    mod.ConfigDict = Narrow
    try:
        return mod.get_config("")
    finally:
        mod.ConfigDict = old


def narrow_config(name):
    """The port's config ``name`` at ``NARROW[name]``'s widths, set in the
    protein configs' model settings while it builds."""
    ca = importlib.import_module(
        "equivariant_nn_zoo_tpu_torch.models.config_diffusion_CA")
    with pytest.MonkeyPatch.context() as mp:
        for key, value in NARROW[name].items():
            mp.setitem(ca.MODEL, key, value)
        return get_config(name)


def loader_batches(protein_file, jcfg, cfg):
    """The first training batch of both packages' loaders on the file
    (batch 2, the config's preprocess, ``E_CAP`` edge slots), scaled."""
    for c in (jcfg, cfg):
        dc = c.data_config if c is jcfg else c["data_config"]
        # the backbone config names one file, the CA config a list
        dc["path"] = protein_file if isinstance(
            jcfg.data_config.path, str) else [protein_file]
        dc["n_train"], dc["n_val"], dc["edge_capacity"] = 0.7, 0.3, E_CAP
    jcfg.batch_size = cfg["batch_size"] = 2
    jgb = next(jgetDataIters(jcfg, seed=0)[0])
    gb = next(getDataIters(cfg, seed=0)[0])
    return jcfg.data_config.scaler(jgb), cfg["data_config"]["scaler"](gb)


@pytest.fixture(scope="module", params=CONFIGS)
def narrow(request, protein_file):
    """One config at the narrow width in both packages on the same
    parameters and the loaders' first batch; the JAX outputs at ``T``
    (jitted once) on edge draws from a key, and the JAX loss and
    gradients of one SDE micro-step."""
    name = request.param
    jcfg, cfg = narrow_jax_config(name, **NARROW[name]), narrow_config(name)
    jmodel = jbuild(jcfg.model_config)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = load_jax_params(build(cfg["model_config"]), params)
    jgb, gb = loader_batches(protein_file, jcfg, cfg)
    n = gb.node_capacity
    edge_key = jax.random.PRNGKey(11)
    rand = np.asarray(jax.random.uniform(edge_key, (n, n)))
    keys = [f"score_{k}" for k in jcfg.diffusion_keys] + [
        "edge_index", "_edge_mask", "_edge_segment", "_n_edges",
        "_edge_overflow"]
    jgb_t = jgb.replace(t=jnp.asarray(T), _edge_rng=edge_key)
    jgb_t.attrs["t"] = ("graph", "1x0e")
    out = jax.jit(lambda p, b: {k: jmodel.apply(p, b)[k] for k in keys})(
        params, jgb_t)
    sde = jsde.VPSDE(dict(jcfg.diffusion_keys), N=50)
    loss_fn = jsde.get_sde_loss_fn(sde, True, reduce_mean=True)
    key = jax.random.PRNGKey(5)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(jmodel, p, b, key), has_aux=True))(
            params, jgb.replace(_edge_rng=edge_key))
    _, kt, kp = jax.random.split(key, 3)
    draws = [("uniform", np.asarray(jax.random.uniform(kt, (2, 1))))]
    for k in sde.irreps:
        kp, sub = jax.random.split(kp)
        draws.append(("normal", np.asarray(jax.random.normal(
            sub, (n, 3), jnp.float32))))
    return dict(name=name, jcfg=jcfg, cfg=cfg, jmodel=jmodel, params=params,
                model=model, jgb=jgb, gb=gb, rand=rand,
                out={k: np.asarray(v) for k, v in out.items()},
                loss=float(loss), grads=flat(grads), draws=draws)


def with_t(gb, t=T, **extra):
    return sde_utils.with_t(gb, torch.tensor(t)).replace(**extra)


def edge_layer(model):
    """The ``edge_index`` layer (a ``partial`` of
    ``computeEdgeIndexDevice``) whose ``keywords["rand"]`` draws the
    criteria's uniforms."""
    return dict(model.layers)["edge_index"]


# ------------------------------------------------------ pipeline, configs

def test_loader_batches_match_jax(narrow):
    jgb, gb = narrow["jgb"], narrow["gb"]
    assert gb.edge_capacity == E_CAP == jgb.edge_capacity
    assert gb.node_capacity == jgb.node_capacity
    assert int(gb["_edge_mask"].sum()) == 0     # the model builds them
    assert (gb["edge_index"] == gb.node_capacity - 1).all()
    for key in ("species", "chain_id", "id", "_node_segment", "_node_mask",
                *narrow["cfg"]["diffusion_keys"]):
        got, want = gb[key].numpy(), np.asarray(jgb[key])
        assert got.shape == want.shape, key
        if got.dtype.kind == "f":
            assert rel(got, want) <= 1e-6, key
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("name", CONFIGS)
def test_full_width_configs_match_jax(name):
    """Layer names and order, the settings, the data settings and the
    parameter tree (names and shapes) of the full-width config; every
    conv takes the per-node self-connection and K1/K2's limits."""
    jcfg, cfg = jget_config(name), get_config(name)
    jmc, mc = jcfg.model_config, cfg["model_config"]
    assert [n for n, _ in mc["layers"]] == [n for n, _ in jmc.layers]
    for key in ("learning_rate", "batch_size", "grad_acc", "use_ema",
                "ema_decay", "ema_use_num_updates", "optimizer_name",
                "lr_scheduler_name", "lr_scheduler_patience",
                "lr_scheduler_factor", "grad_clid_norm"):
        assert cfg[key] == jcfg[key], key
    assert list(cfg["diffusion_keys"].items()) == list(
        dict(jcfg.diffusion_keys).items())
    for key in ("n_dim", "l_max", "r_max", "num_layers", "edge_radial",
                "node_attrs"):
        assert mc[key] == jmc[key], key
    for key in ("n_train", "n_val", "std", "train_val_split", "shuffle",
                "edge_capacity"):
        assert cfg["data_config"][key] == jcfg.data_config[key], key
    crop, jcrop = (dc["preprocess"][1] for dc in (cfg["data_config"],
                                                  jcfg.data_config))
    assert {"keep_atoms": ("CA",), **jcrop.keywords} == {
        "keep_atoms": ("CA",), **crop.keywords}
    shapes = jax.eval_shape(jbuild(jmc).init, jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(path).replace("']['", ".").strip("[']"):
            tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_leaves_with_path(shapes)}
    model = build(mc)
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert got == want
    assert {"layer0.norm.std", "relative_position.radial.basis."
            "bessel_weights", "concat1.linear.b0",
            "concat2.linear.b0"} <= set(got)
    assert ("concat3.linear.b0" in got) == (name.endswith("backbone"))
    convs = [m for m in model.modules()
             if isinstance(m, FactorizedConvolution)]
    assert len(convs) == 8
    for conv in convs:
        assert conv.species_sc is None and conv.grad_order == 1
        assert conv.full_conv.fc_dims[:4] == [32, 64, 64, 64]
        full_conv_mod.check_structure(conv.full_conv, backward=True)


def test_check_structure_refuses_radial_inputs_past_64():
    wide = FactorizedConvolution(
        input_features="4x0e+4x1o", output_features="4x0e+4x1o",
        node_attrs="3x0e", edge_radial="65x0e",
        edge_spherical="1x0e+1x1o", invariant_layers=2,
        invariant_neurons=8, avg_num_neighbors=5.0)
    with pytest.raises(ValueError, match="MLP dims"):
        full_conv_mod.check_structure(wide.full_conv)
    at_64 = FactorizedConvolution(
        input_features="4x0e+4x1o", output_features="4x0e+4x1o",
        node_attrs="3x0e", edge_radial="64x0e",
        edge_spherical="1x0e+1x1o", invariant_layers=2,
        invariant_neurons=8, avg_num_neighbors=5.0)
    full_conv_mod.check_structure(at_64.full_conv, backward=True)


# -------------------------------------------------------- model, step

def test_scores_and_edges_match_jax(narrow):
    with torch.no_grad():
        out = narrow["model"](with_t(narrow["gb"], _edge_rand=torch.tensor(
            narrow["rand"])))
    for key, want in narrow["out"].items():
        got = out[key].numpy()
        assert got.shape == want.shape, key
        if key.startswith("score_"):
            assert np.isfinite(got).all(), key
            assert rel(got, want) <= 1e-5, (key, rel(got, want))
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    assert int(out["_edge_overflow"].max()) == 0
    assert int(out["_n_edges"].sum()) > 0


def test_sde_micro_step_matches_jax(narrow):
    model = narrow["model"]
    sde = sde_utils.VPSDE(narrow["cfg"]["diffusion_keys"], N=50)
    loss_fn = sde_utils.get_sde_loss_fn(sde, True, reduce_mean=True)
    noise = Replay(narrow["draws"])
    model.zero_grad(set_to_none=True)
    loss, parts = loss_fn(model, narrow["gb"].replace(
        _edge_rand=torch.tensor(narrow["rand"])), noise)
    loss.backward()
    assert noise.done
    assert set(parts) == {*sde.irreps, "total"}
    assert rel(loss.item(), narrow["loss"]) <= 1e-5
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    assert set(grads) == set(narrow["grads"])
    for name, want in narrow["grads"].items():
        got = grads[name].numpy()
        if not np.abs(want).any():
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        assert rel(got, want) <= 1e-4, (name, rel(got, want))
    model.zero_grad(set_to_none=True)


def test_card_path_launches(narrow, monkeypatch):
    """Routed to the plain contracts: an evaluation launches K1 once per
    layer, a micro-step K1 and K2 once per layer; K3, K3b and the K4
    family never; the micro-step's gradients equal plain autograd's."""
    model, cfg = narrow["model"], narrow["cfg"]
    layers = cfg["model_config"]["num_layers"]
    gb = narrow["gb"].replace(_edge_rand=torch.tensor(narrow["rand"]))
    sde = sde_utils.VPSDE(cfg["diffusion_keys"], N=50)
    loss_fn = sde_utils.get_sde_loss_fn(sde, True, reduce_mean=True)

    def step():
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, gb, sde_utils.Noise("cpu", 3))
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}

    want_loss, want = step()
    calls, ext = route_all(monkeypatch)
    with torch.no_grad():
        model(with_t(gb))
    assert calls == {"K1": layers, "K2": 0, "K3": 0, "K3b": 0}
    calls.update({k: 0 for k in calls})
    got_loss, got = step()
    assert calls == {"K1": layers, "K2": layers, "K3": 0, "K3b": 0}
    assert ext == {"fwd": 0, "bwd": 0, "grad2": 0}
    assert rel(got_loss, want_loss) <= 1e-6
    for name in want:
        assert rel(got[name].numpy(), want[name].numpy()) <= 1e-5, name
    model.zero_grad(set_to_none=True)


def test_full_depth_evaluation_launches_eight_k1(protein_file, monkeypatch):
    """``config_diffusion_CA`` at full width and depth: one score
    evaluation launches K1 8 times (once per layer) and nothing else."""
    cfg = get_config("config_diffusion_CA")
    model = build_model(cfg["model_config"], "cpu")
    _, gb = loader_batches(protein_file, narrow_jax_config(
        "config_diffusion_CA", n_dim=8, num_layers=2), cfg)
    calls, ext = route_all(monkeypatch)
    with torch.no_grad():
        out = model(with_t(gb))
    assert calls == {"K1": 8, "K2": 0, "K3": 0, "K3b": 0}
    assert ext == {"fwd": 0, "bwd": 0, "grad2": 0}
    assert torch.isfinite(out["score_CA"]).all()


# --------------------------------------------------------------- sampler

def jax_pc_draws(key, n, corrector_steps, shapes):
    """JAX's draws of the PC sampler with several keys (``sde_sampling``:
    the prior, then per step the corrector's and the predictor's), one
    per key in order, each key splitting its own stream."""
    key, kp = jax.random.split(key)
    draws = []
    for s in shapes:
        kp, sub = jax.random.split(kp)
        draws.append(("normal", np.asarray(jax.random.normal(
            sub, s, jnp.float32))))
    for _ in range(n):
        key, kc, kpred = jax.random.split(key, 3)
        for _ in range(corrector_steps):
            for s in shapes:
                kc, sub = jax.random.split(kc)
                draws.append(("normal", np.asarray(jax.random.normal(
                    sub, s, jnp.float32))))
        for s in shapes:
            kpred, sub = jax.random.split(kpred)
            draws.append(("normal", np.asarray(jax.random.normal(
                sub, s, jnp.float32))))
    return draws


class EdgeReplay:
    """The edge layer's uniform draws, handed out in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def uniform(self, shape, device):
        a = self.draws.pop(0)
        assert a.shape == tuple(shape)
        return torch.tensor(a, device=device)


def jax_edge_draws(sde, n, corrector_steps, eps=1e-3):
    """The JAX edge layer's draws in the PC sampler: per evaluation a key
    folded from the step's t (``compute_edge.py:152-158``)."""
    out = []
    for t in np.asarray(jnp.linspace(sde.T, eps, sde.N)):
        salt = (jnp.float32(t) * 1e6).astype(jnp.int32)
        key = jax.random.fold_in(jax.random.PRNGKey(0), salt)
        out += [np.asarray(jax.random.uniform(key, (n, n)))] * (
            corrector_steps + 1)
    return out


# two steps: the sampler on these random-weight models multiplies any
# difference 5-13 times a step (a relative 1e-6 nudge of the prior in the
# port alone grows to 5e-6, 7e-5, 3e-4, 2e-3, 1e-2 over five steps at N =
# 5), so the two packages' float32 rounding crosses 1e-4 by step 3 (the
# backbone at 2.1e-4 at N = 3); beta_max 1 keeps the corrector's alpha at
# t = 1 (1 - 1 / 2) positive
SAMPLER_PC = dict(beta_min=0.1, beta_max=1.0, N=2)
SAMPLER_EPS = 0.5


def test_pc_sampler_matches_jax(narrow, monkeypatch):
    """The PC sampler over every diffusion key, its edges drawn anew in
    each evaluation, and the inverse-scaled host batch, at 1e-4."""
    jcfg, cfg = narrow["jcfg"], narrow["cfg"]
    keys = list(cfg["diffusion_keys"])
    jsde_ = jsde.VPSDE(dict(jcfg.diffusion_keys), **SAMPLER_PC)
    jpc = jsampling.get_pc_sampler(
        jsde_, jsampling.get_predictor("euler_maruyama"),
        jsampling.get_corrector("langevin"), None, snr=0.16, n_steps=1,
        eps=SAMPLER_EPS)
    jmodel = narrow["jmodel"]
    jout, nfe = jax.jit(lambda p, b, k: jpc(jmodel, p, b, k))(
        narrow["params"], narrow["jgb"], jax.random.PRNGKey(2))
    n = narrow["gb"].node_capacity
    sde = sde_utils.VPSDE(cfg["diffusion_keys"], **SAMPLER_PC)
    noise = Replay(jax_pc_draws(jax.random.PRNGKey(2), sde.N, 1,
                                [(n, 3)] * len(keys)))
    edges = EdgeReplay(jax_edge_draws(sde, n, 1, SAMPLER_EPS))
    monkeypatch.setitem(edge_layer(narrow["model"]).keywords, "rand", edges)
    pc = sde_sampling.get_pc_sampler(
        sde, sde_sampling.get_predictor("euler_maruyama"),
        sde_sampling.get_corrector("langevin"), None, snr=0.16, n_steps=1,
        eps=SAMPLER_EPS)
    out, got_nfe = pc(narrow["model"], narrow["gb"], noise)
    assert noise.done and not edges.draws
    assert got_nfe == int(nfe) == 2 * sde.N
    for key in keys:
        assert torch.isfinite(out[key]).all(), key
        assert rel(out[key].numpy(), np.asarray(jout[key])) <= 1e-4, key
    want = jcfg.data_config.inverse_scaler(jout.to_batch())
    host = cfg["data_config"]["inverse_scaler"](out.to_batch())
    for key in keys:
        assert rel(host[key], want[key]) <= 1e-4, key


def test_sampler_rebuilds_edges_and_writes_a_pdb(narrow, tmp_path):
    """Each evaluation's edges come from the current CA: the edge lists
    of two steps differ, and every live edge's vector is CA[dst] - CA[src]
    of the positions that evaluation sees; the sample, inverse-scaled, is
    written as a .pdb ending in END."""
    model, cfg = narrow["model"], narrow["cfg"]
    seen = []

    def check(mod, args):
        data = args[0]
        live = data["_edge_mask"][:, 0] > 0
        src, dst = data["edge_index"]
        vec = data["CA"][dst] - data["CA"][src]
        seen.append((data["edge_index"].clone(), float(
            (data["vectors"] - vec)[live].abs().max())))

    hook = model.spharm_edges.register_forward_pre_hook(check)
    sde = sde_utils.VPSDE(cfg["diffusion_keys"], **SAMPLER_SDE)
    sampling = sde_sampling.get_sampling_fn(
        dict(sampling=dict(method="pc", predictor="euler_maruyama",
                           corrector="langevin", snr=0.16, n_steps_each=1,
                           noise_removal=True),
             training=dict(continuous=True)),
        sde, cfg["data_config"]["inverse_scaler"], 1e-3)
    host, nfe = sampling(model, narrow["gb"], sde_utils.Noise("cpu", 4))
    hook.remove()
    assert len(seen) == nfe == 10
    assert max(err for _, err in seen) == 0.0
    assert not torch.equal(seen[0][0], seen[2][0])
    assert "edge_vector" not in host.keys()
    f = saveProtein(host, str(tmp_path), filename="sample")
    content = open(f).read()
    assert "CA" in content and content.strip().endswith("END")
    n_res = int(host["_n_nodes"][0, 0])
    atoms = len(cfg["diffusion_keys"])
    assert sum(line.startswith("ATOM") for line in
               content.splitlines()) == n_res * atoms
