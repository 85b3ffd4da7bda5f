"""Model-level parity of the port's ``config_diffusion`` (both specs, full
width: n_dim 32, l_max 2, 4 layers, 18 species) with the JAX package's
default CPU path, on small batches of fully-connected molecules (CPU,
f32):

- the layer list and the parameter tree are the JAX config's; no layer
  builds the species-table self-connection (K3);
- ``score_pos`` (and ``nll``) at given per-graph times, rel-linf 1e-5;
- the self-connection sees ``t``: two copies of one molecule at two times
  get different self-connection outputs (the species tables would give
  them the same);
- padded edges: the outputs stay the same when the edge capacity grows,
  with ``concat1``'s bias making the padded edges' ``edge_radial``
  non-zero;
- the card path's autograd Functions, with their launches routed to the
  plain contracts: launches per score evaluation, per sampler run and per
  training step (K1 and K2 on spec ``""``, K4f, K4b and K4g on ``"nll"``,
  never K3 or K3b), and the step's gradients equal plain autograd's;
- the sampler derives every step's edge vectors from the current
  positions, even when it is given a batch that carries edge vectors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu.models import get_config as jget_config
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
from equivariant_nn_zoo_tpu_torch.nn import FactorizedConvolution
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as species_sc_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda.species_sc import (
    SpeciesScalarFCTP,
)
from equivariant_nn_zoo_tpu_torch.run import sde_sampling, sde_utils
from equivariant_nn_zoo_tpu_torch.utils import build, load_jax_params
from test_torch_edge_order import torch_threads_per_worker
from test_torch_force import route_to_plain
from test_torch_sde import (
    G,
    N_CAP,
    jax_batch,
    molecules,
    port_batch,
    rel,
)

torch_threads_per_worker()

SPECS = ("", "nll")
LAYERS = 4
T = np.array([[0.3], [0.9], [0.02], [0.6]], np.float32)


def with_t(gb, t=T):
    return sde_utils.with_t(gb, torch.tensor(t))


@pytest.fixture(scope="module", params=SPECS)
def slice_(request):
    """The JAX model of one spec, its parameters and its outputs at ``T``
    on the default CPU path (jitted once), and the port's model on the
    same parameters."""
    spec = request.param
    jcfg = jget_config("config_diffusion", spec)
    jmodel = jbuild(jcfg.model_config)
    params = jmodel.init(jax.random.PRNGKey(0))
    mols = molecules(seed=2)
    jgb = jax_batch(mols).replace(t=jnp.asarray(T))
    jgb.attrs["t"] = ("graph", "1x0e")
    keys = ("score_pos", "nll") if spec else ("score_pos",)
    out = jax.jit(lambda p, b: {k: jmodel.apply(p, b)[k] for k in keys})(
        params, jgb)
    cfg = get_config("config_diffusion", spec)
    model = load_jax_params(build(cfg["model_config"]), params)
    return dict(spec=spec, jcfg=jcfg, cfg=cfg, model=model, mols=mols,
                out={k: np.asarray(v) for k, v in out.items()})


def _layers(model_config):
    return model_config.get("layers") or model_config["func"]["layers"]


def test_config_matches_jax_and_takes_no_species_tables(slice_):
    cfg, jcfg = slice_["cfg"], slice_["jcfg"]
    jmc = jcfg.model_config
    assert [n for n, _ in _layers(cfg["model_config"])] == \
        [n for n, _ in (jmc.func.layers if "func" in jmc else jmc.layers)]
    for key in ("learning_rate", "batch_size", "grad_clid_norm", "grad_acc",
                "ema_decay", "ema_use_num_updates"):
        assert cfg[key] == jcfg[key], key
    assert cfg["diffusion_keys"] == dict(jcfg.diffusion_keys)
    model = slice_["model"]
    convs = [m for m in model.modules()
             if isinstance(m, FactorizedConvolution)]
    assert len(convs) == LAYERS
    for conv in convs:
        assert conv.species_sc is None and conv.fused_sc is not None
        assert conv.grad_order == (2 if slice_["spec"] else 1)
    assert not any(isinstance(m, SpeciesScalarFCTP) for m in model.modules())


def test_outputs_match_jax(slice_):
    with torch.no_grad():
        out = slice_["model"](with_t(port_batch(slice_["mols"])))
    for key, want in slice_["out"].items():
        got = out[key].numpy()
        assert got.shape == want.shape, key
        assert np.isfinite(got).all(), key
        assert rel(got, want) <= 1e-5, (key, rel(got, want))


def test_self_connection_takes_each_graphs_time(monkeypatch):
    """Two copies of one molecule at t = 0.1 and 0.8: the first layer's
    self-connection, which reads the time-mixed ``node_attrs``, gives the
    two copies different outputs on the card path (routed to the plain
    contracts); K3's per-species tables, built from one node per species,
    would give both copies the same."""
    route_all(monkeypatch)
    model = build_model(get_config("config_diffusion")["model_config"],
                        "cpu")
    mol = molecules(seed=6, n_mol=1)[0]
    gb = with_t(port_batch([mol, mol], g=2), np.array([[0.1], [0.8]],
                                                       np.float32))
    seen = {}
    conv = model.layer0.conv
    hook = conv.register_forward_pre_hook(
        lambda mod, args: seen.update(data=args[0]))
    with torch.no_grad():
        model(gb)
        hook.remove()
        data = seen["data"]
        sc = conv.self_connection(data["input_features"], data)
    n = len(mol["pos"])
    assert torch.equal(data["species"][:n], data["species"][n: 2 * n])
    assert torch.equal(data["input_features"][:n],
                       data["input_features"][n: 2 * n])
    diff = (sc[:n] - sc[n: 2 * n]).abs().max()
    assert diff > 1e-3 * sc[:2 * n].abs().max(), float(diff)


def test_first_order_conv_without_species_types_is_per_node():
    conv = FactorizedConvolution(
        input_features="4x0e+4x1o", output_features="4x0e+4x1o",
        node_attrs="3x0e", edge_radial="4x0e",
        edge_spherical="1x0e+1x1o", invariant_layers=1,
        invariant_neurons=8, avg_num_neighbors=5.0)
    assert conv.grad_order == 1
    assert conv.species_sc is None and conv.fused_sc is not None


def test_padded_edges_change_nothing(slice_):
    model = build_model(slice_["cfg"]["model_config"], "cpu",
                        torch.Generator().manual_seed(1))
    trunk = getattr(model, "func", model)
    with torch.no_grad():
        trunk.concat1.linear.b0.fill_(0.7)
        trunk.concat2.linear.b0.fill_(-0.4)
    mols = slice_["mols"]
    small = with_t(port_batch(mols))
    large = with_t(port_batch(mols, e_cap=small.edge_capacity + 64))
    assert int(small["_edge_mask"].sum()) < small.edge_capacity
    with torch.no_grad():
        a, b = model(small), model(large)
    n_real = int(small["_node_mask"].sum())
    for key in slice_["out"]:
        x, y = a[key], b[key]
        if x.shape[0] == N_CAP:
            x, y = x[:n_real], y[:n_real]
        assert torch.isfinite(x).all()
        assert rel(y.numpy(), x.numpy()) <= 1e-6, key


def route_all(monkeypatch):
    """Every trunk kernel's wrapper down its card path with each launch
    replaced by its plain contract, counted: K1 and K2 (``FullConv``), K3
    and K3b (``SpeciesScalarFCTP``) and, through ``route_to_plain``, K4f,
    K4b and K4g."""
    calls = {"K1": 0, "K2": 0, "K3": 0, "K3b": 0}

    def counting(key, attr):
        def launch(mod, *args, order=None):
            calls[key] += 1
            return getattr(mod, attr)(*args)
        return launch

    for mod, cls, fwd, bwd in (
            (full_conv_mod, full_conv_mod.FullConv,
             counting("K1", "plain_forward"),
             counting("K2", "plain_backward")),
            (species_sc_mod, species_sc_mod.SpeciesScalarFCTP,
             counting("K3", "table_product"),
             counting("K3b", "plain_backward"))):
        monkeypatch.setattr(cls, "forward", cls.launch)
        monkeypatch.setattr(mod, "launch_forward", fwd)
        monkeypatch.setattr(mod, "launch_backward", bwd)
    ext = route_to_plain(monkeypatch)
    return calls, ext


def _loss_and_grads(model, gb, seed):
    sde = sde_utils.VPSDE({"pos": 3}, N=50)
    loss_fn = sde_utils.get_sde_loss_fn(sde, True, reduce_mean=True)
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, gb, sde_utils.Noise("cpu", seed))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in
                         model.named_parameters() if p.grad is not None}


def test_card_path_launches_and_gradients(slice_, monkeypatch):
    """Routed to the plain contracts: one score evaluation launches each
    layer's forward kernel once (spec ``"nll"``: K4f and, for the position
    gradient, K4b), a PC sampler run ``N x 2`` evaluations' worth, a
    training step K2 per layer (``"nll"``: the force path's second-order
    pattern, layer 0's input features not depending on positions); K3 and
    K3b never; the step's loss and gradients equal plain autograd's."""
    model, spec = slice_["model"], slice_["spec"]
    gb = port_batch(slice_["mols"])
    want_loss, want = _loss_and_grads(model, gb, 0)
    calls, ext = route_all(monkeypatch)

    with torch.no_grad():
        model(with_t(gb))
    if spec:
        assert ext == {"fwd": LAYERS, "bwd": LAYERS, "grad2": 0}
    else:
        assert calls == {"K1": LAYERS, "K2": 0, "K3": 0, "K3b": 0}

    for counts in (calls, ext):
        counts.update({k: 0 for k in counts})
    sde = sde_utils.VPSDE({"pos": 3}, N=2)
    pc = sde_sampling.get_pc_sampler(
        sde, sde_sampling.get_predictor("euler_maruyama"),
        sde_sampling.get_corrector("langevin"), None, snr=0.16)
    _, nfe = pc(model, gb, sde_utils.Noise("cpu", 1))
    assert nfe == 4
    if spec:
        assert ext == {"fwd": LAYERS * nfe, "bwd": LAYERS * nfe, "grad2": 0}
    else:
        assert calls == {"K1": LAYERS * nfe, "K2": 0, "K3": 0, "K3b": 0}

    for counts in (calls, ext):
        counts.update({k: 0 for k in counts})
    got_loss, got = _loss_and_grads(model, gb, 0)
    if spec:
        assert ext == {"fwd": LAYERS + 2, "bwd": 2 * LAYERS + 2,
                       "grad2": LAYERS - 1}
        assert calls["K3"] == calls["K3b"] == 0
    else:
        assert calls == {"K1": LAYERS, "K2": LAYERS, "K3": 0, "K3b": 0}
    assert rel(got_loss, want_loss) <= 1e-6
    assert set(got) == set(want)
    for name in want:
        assert rel(got[name].numpy(), want[name].numpy()) <= 1e-5, name


def test_sampler_derives_edge_vectors_from_current_positions():
    """Each score evaluation's edge vectors are ``pos[dst] - pos[src]`` of
    the positions it is given, also when the input batch carries stale
    edge vectors (and lengths) from its own positions."""
    model = build_model(get_config("config_diffusion")["model_config"],
                        "cpu")
    gb = port_batch(molecules(seed=7))
    src, dst = gb["edge_index"]
    stale = gb["pos"][dst] - gb["pos"][src]
    gb = gb.replace(edge_vector=stale,
                    edge_length=stale.norm(dim=-1, keepdim=True))
    real = gb["_edge_mask"][:, 0] > 0
    errors = []

    def check(mod, args):
        data = args[0]
        vec = data["pos"][dst] - data["pos"][src]
        errors.append(float((data["vectors"] - vec)[real].abs().max()))

    hook = model.spharm_edges.register_forward_pre_hook(check)
    sde = sde_utils.VPSDE({"pos": 3}, beta_max=4.0, N=5)
    pc = sde_sampling.get_pc_sampler(
        sde, sde_sampling.get_predictor("euler_maruyama"),
        sde_sampling.get_corrector("langevin"), None, snr=0.16)
    out, nfe = pc(model, gb, sde_utils.Noise("cpu", 2))
    hook.remove()
    assert len(errors) == nfe == 10
    assert max(errors) == 0.0, errors
    assert "edge_vector" not in out and torch.isfinite(out["pos"]).all()
    ode = sde_sampling.get_ode_sampler(sde, None, n_steps=2)
    assert "edge_vector" not in ode(model, gb, sde_utils.Noise("cpu", 3))[0]
