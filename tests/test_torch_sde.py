"""Parity of the port's VP-SDE stack (``run/sde_utils.py``,
``run/sde_sampling.py``) with the JAX package's, on the full-width
``config_diffusion`` (both specs) and small batches of fully-connected
molecules (CPU, f32):

- ``VPSDE``: the discrete tables, ``marginal_std``, ``sde`` and
  ``reverse`` at rel-linf 1e-6, and the JAX tests' marginal statistics
  and finite coarse schedules;
- the loss and one step's gradient of every parameter against
  ``jax.value_and_grad`` of ``get_sde_loss_fn`` (rel 1e-5 / 1e-4), with
  ``t`` and ``z`` drawn from JAX's own key schedule and replayed into the
  port's noise source (``Replay``);
- four steps of ``get_step_fn`` (``grad_acc`` 2, clip 1.0, EMA 0.99):
  parameters, Adam's moments and count, and the EMA at 1e-4; a NaN batch
  leaves the parameters and Adam's state bit for bit; the evaluation step
  takes the EMA model;
- the PC and ODE samplers at N = 5 on replayed noise: positions at 1e-4.
  The last step divides the model's output by the marginal std at
  t = 1e-3 (about 0.01), so the outputs' float32 differences come out
  about 100 times larger in the positions.

JAX's functions are jitted once per file (module-scoped fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from equivariant_nn_zoo_tpu.data import Batch as JBatch
from equivariant_nn_zoo_tpu.data import Data as JData
from equivariant_nn_zoo_tpu.data import GraphBatch as JGraphBatch
from equivariant_nn_zoo_tpu.models import get_config as jget_config
from equivariant_nn_zoo_tpu.run import sde_sampling as jsampling
from equivariant_nn_zoo_tpu.run import sde_utils as jsde
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu_torch.data import (
    Batch,
    Data,
    GraphBatch,
    computeEdgeIndex,
)
from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
from equivariant_nn_zoo_tpu_torch.models.sde_config import (
    get_config as sde_get_config,
)
from equivariant_nn_zoo_tpu_torch.run import sde_sampling, sde_utils
from equivariant_nn_zoo_tpu_torch.utils import build, load_jax_params
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

SPECS = ("", "nll")
N_CAP, E_CAP, G = 40, 160, 4    # three molecules: one padded graph
ATTRS = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
         "bond_type": ("edge", "1x0e"), "_n_edges": ("graph", "1x0e")}
LR = 1e-3


def molecules(seed=0, n_mol=3, sizes=(4, 8)):
    """Fully-connected molecules as ``bench.py``'s
    ``synthetic_diffusion_mols`` makes them (smaller)."""
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(*sizes))
        d = {"pos": (rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
             "species": rng.integers(0, 18, size=(n, 1))}
        out, _ = computeEdgeIndex(d, dict(ATTRS), r_max=9999.0)
        d.update(out)
        d["bond_type"] = rng.integers(0, 4, size=(d["edge_index"].shape[1],
                                                  1))
        mols.append(d)
    return mols


def port_batch(mols, n_cap=N_CAP, e_cap=E_CAP, g=G):
    host = Batch.from_data_list([Data(dict(ATTRS), **m) for m in mols])
    gb = GraphBatch.from_batch(host, n_cap, e_cap, g, "cpu")
    assert gb.dropped == 0
    return gb


def jax_batch(mols, n_cap=N_CAP, e_cap=E_CAP, g=G):
    host = JBatch.from_data_list([JData(dict(ATTRS), **m) for m in mols])
    return JGraphBatch.from_batch(host, n_cap, e_cap, g)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


class Replay:
    """A noise source that hands out given draws in order, checking each
    draw's kind and shape; ``done`` once all are used."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, kind, shape):
        want, a = self.draws.pop(0)
        assert (want, a.shape) == (kind, tuple(shape)), (want, a.shape,
                                                          kind, shape)
        return torch.tensor(np.asarray(a))

    def normal(self, shape):
        return self._next("normal", shape)

    def uniform(self, shape):
        return self._next("uniform", shape)

    @property
    def done(self):
        return not self.draws


# ---- JAX's key schedule (sde_utils.py: loss_fn and step_fn; sde_sampling:
# ---- the prior, the PC body, the corrector and the predictor)

def jax_loss_draws(key, g, shape):
    _, kt, kp = jax.random.split(key, 3)
    _, sub = jax.random.split(kp)
    return [("uniform", np.asarray(jax.random.uniform(kt, (g, 1)))),
            ("normal", np.asarray(jax.random.normal(sub, shape,
                                                    jnp.float32)))]


def jax_step_draws(rng, n_steps, g, shape):
    draws = []
    for _ in range(n_steps):
        rng, sub = jax.random.split(rng)
        draws += jax_loss_draws(sub, g, shape)
    return draws


def jax_prior(key, shape):
    key, kp = jax.random.split(key)
    _, sub = jax.random.split(kp)
    return key, [("normal", np.asarray(jax.random.normal(sub, shape,
                                                         jnp.float32)))]


def jax_pc_draws(key, n, corrector_steps, shape):
    key, draws = jax_prior(key, shape)
    for _ in range(n):
        key, kc, kpred = jax.random.split(key, 3)
        for _ in range(corrector_steps):
            kc, sub = jax.random.split(kc)
            draws.append(("normal", np.asarray(
                jax.random.normal(sub, shape, jnp.float32))))
        _, sub = jax.random.split(kpred)
        draws.append(("normal", np.asarray(
            jax.random.normal(sub, shape, jnp.float32))))
    return draws


def flat(tree):
    """A JAX pytree of arrays as {dotted name: numpy array}."""
    return {jax.tree_util.keystr(path).replace("']['", ".").strip("[']"):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module", params=SPECS)
def ref(request):
    """The JAX model of one spec, its parameters, and the loss and
    gradient of one step on the default CPU path (jitted once)."""
    spec = request.param
    jmodel = jbuild(jget_config("config_diffusion", spec).model_config)
    params = jmodel.init(jax.random.PRNGKey(0))
    mols = molecules()
    sde = jsde.VPSDE({"pos": 3}, N=50)
    loss_fn = jsde.get_sde_loss_fn(sde, True, reduce_mean=True)
    key = jax.random.PRNGKey(5)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(jmodel, p, jax_batch(mols), key),
        has_aux=True))(params)
    return dict(spec=spec, jmodel=jmodel, params=params, mols=mols,
                loss=float(loss), grads=flat(grads),
                draws=jax_loss_draws(key, G, (N_CAP, 3)))


def port_model(ref):
    model = build(get_config("config_diffusion", ref["spec"])["model_config"])
    return load_jax_params(model, ref["params"])


# ------------------------------------------------------------------ VPSDE

def test_vpsde_tables_match_jax():
    for n in (5, 50, 1000):
        want = jsde.VPSDE({"pos": 3}, N=n)
        got = sde_utils.VPSDE({"pos": 3}, N=n)
        for name in ("discrete_betas", "alphas", "alphas_cumprod",
                     "sqrt_alphas_cumprod", "sqrt_1m_alphas_cumprod"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(want, name), rtol=1e-6,
                                       atol=0, err_msg=f"{name} N={n}")
        assert (got.T, got.N, got.irreps) == (want.T, want.N, want.irreps)


def test_vpsde_tables_finite_for_coarse_schedules():
    for n in (2, 10, 50, 1000):
        sde = sde_utils.VPSDE({"pos": 3}, beta_min=0.1, beta_max=20, N=n)
        for name in ("alphas_cumprod", "sqrt_alphas_cumprod",
                     "sqrt_1m_alphas_cumprod", "discrete_betas"):
            assert np.isfinite(getattr(sde, name)).all(), (name, n)
        assert (sde.alphas_cumprod >= 0).all()
        assert (sde.alphas_cumprod <= 1).all()
        assert (sde.sqrt_1m_alphas_cumprod <= 1).all()


def test_vpsde_marginal_statistics():
    sde = sde_utils.VPSDE({"pos": 3}, beta_min=0.1, beta_max=20, N=100)
    gb = port_batch(molecules(seed=3, n_mol=4), g=4)
    noise = sde_utils.Noise("cpu", 0)
    perturbed, misc = sde.marginal(
        sde_utils.with_t(gb, torch.full((4, 1), 0.99)), noise)
    assert float(misc["std"].max()) > 0.99   # ~N(0, 1) at t ~ 1
    mask = gb["_node_mask"][:, 0] > 0
    assert 0.5 < float(perturbed["pos"][mask].std()) < 2.0
    near0, _ = sde.marginal(
        sde_utils.with_t(gb, torch.full((4, 1), 1e-4)), noise)
    np.testing.assert_allclose(near0["pos"][mask], gb["pos"][mask],
                               atol=0.05)


def test_vpsde_std_sde_and_reverse_match_jax():
    """``marginal_std``, one forward ``sde`` step and one ``reverse`` step
    (a fixed score) on the same t and z, at 1e-6."""
    mols = molecules(seed=1)
    t = np.array([[0.3], [0.9], [0.02], [0.6]], np.float32)
    jgb = jax_batch(mols).replace(t=jnp.asarray(t))
    jgb.attrs["t"] = ("graph", "1x0e")
    gb = sde_utils.with_t(port_batch(mols), torch.tensor(t))
    score = np.cos(np.arange(N_CAP * 3)).reshape(N_CAP, 3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    z = np.asarray(jax.random.normal(jax.random.split(key)[1], (N_CAP, 3),
                                     jnp.float32))
    want = jsde.VPSDE({"pos": 3}, N=50)
    got = sde_utils.VPSDE({"pos": 3}, N=50)
    assert rel(got.marginal_std(gb), want.marginal_std(jgb)) <= 1e-6
    assert rel(got.sde(gb, Replay([("normal", z)]))["pos"],
               want.sde(jgb, key)["pos"]) <= 1e-6
    back = want.reverse(lambda b: {"score_pos": jnp.asarray(score)})
    port_back = got.reverse(lambda b: {"score_pos": torch.tensor(score)})
    assert rel(port_back.sde(gb, Replay([("normal", z)]))["pos"],
               back.sde(jgb, key)["pos"]) <= 1e-6
    assert (port_back.N, port_back.T) == (50, 1)


# ------------------------------------------------------------ loss, grads

def test_loss_and_gradients_match_jax(ref):
    model = port_model(ref)
    sde = sde_utils.VPSDE({"pos": 3}, N=50)
    loss_fn = sde_utils.get_sde_loss_fn(sde, True, reduce_mean=True)
    noise = Replay(ref["draws"])
    loss, parts = loss_fn(model, port_batch(ref["mols"]), noise)
    loss.backward()
    assert noise.done
    assert set(parts) == {"pos", "total"}
    assert rel(loss.item(), ref["loss"]) <= 1e-5
    # a parameter the loss does not reach (the nll head's bias: the score
    # is a position gradient) has no .grad; JAX gives it zeros
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    assert set(grads) == set(ref["grads"])
    for name, want in ref["grads"].items():
        got = grads[name].numpy()
        if not np.abs(want).any():
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        assert rel(got, want) <= 1e-4, (name, rel(got, want))


# ------------------------------------------------------------------ steps

@pytest.fixture(scope="module")
def jax_steps(ref):
    """Four JAX steps (grad_acc 2, clip 1.0, EMA 0.99) from key 1, then an
    evaluation step: the states after each."""
    sde = jsde.VPSDE({"pos": 3}, N=50)
    optimizer = optax.adam(LR)
    state = jsde.init_sde_state(ref["params"], optimizer,
                                jax.random.PRNGKey(1))
    kw = dict(reduce_mean=True, grad_clid_norm=1.0, grad_acc=2,
              ema_decay=0.99)
    step = jsde.get_step_fn(sde, True, model=ref["jmodel"],
                            optimizer=optimizer, **kw)
    gb = jax_batch(ref["mols"])
    losses = []
    for _ in range(4):
        state, loss, _ = step(state, gb)
        losses.append(float(loss))
    eval_step = jsde.get_step_fn(sde, False, model=ref["jmodel"])
    _, eval_loss, _ = eval_step(state, gb)
    adam_state = state["opt_state"][0]
    return dict(losses=losses, params=flat(state["params"]),
                ema=flat(state["ema"]["params"]), mu=flat(adam_state.mu),
                nu=flat(adam_state.nu), count=int(adam_state.count),
                eval_loss=float(eval_loss),
                draws=jax_step_draws(jax.random.PRNGKey(1), 4, G,
                                     (N_CAP, 3)),
                eval_draws=jax_step_draws(_rng_after(jax.random.PRNGKey(1),
                                                     4), 1, G, (N_CAP, 3)),
                kw=kw)


def _rng_after(rng, n_steps):
    """The state's key after ``n_steps`` steps."""
    for _ in range(n_steps):
        rng, _ = jax.random.split(rng)
    return rng


def test_step_fn_matches_jax(ref, jax_steps):
    model = port_model(ref)
    sde = sde_utils.VPSDE({"pos": 3}, N=50)
    optimizer = sde_utils.adam(model, LR)
    noise = Replay(jax_steps["draws"] + jax_steps["eval_draws"])
    state = sde_utils.init_sde_state(model, noise)
    step = sde_utils.get_step_fn(sde, True, model=model,
                                 optimizer=optimizer, **jax_steps["kw"])
    losses = []
    for _ in range(4):
        state, loss, parts = step(state, port_batch(ref["mols"]))
        losses.append(loss.item())
    assert state["step"] == 4 and state["ema"]["num_updates"] == 4
    np.testing.assert_allclose(losses, jax_steps["losses"], rtol=1e-4)
    named = dict(model.named_parameters())
    ema = dict(state["ema"]["model"].named_parameters())
    for name, p in named.items():
        st = optimizer.state[p]
        assert int(st["step"]) == jax_steps["count"] == 2
        for what, got, want in (
                ("param", p.detach(), jax_steps["params"][name]),
                ("ema", ema[name], jax_steps["ema"][name]),
                ("mu", st["exp_avg"], jax_steps["mu"][name]),
                ("nu", st["exp_avg_sq"], jax_steps["nu"][name])):
            if not np.abs(want).any():
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{what} {name}")
                continue
            assert rel(got.numpy(), want) <= 1e-4, (what, name,
                                                    rel(got.numpy(), want))
    eval_step = sde_utils.get_step_fn(sde, False)
    _, eval_loss, _ = eval_step(state, port_batch(ref["mols"]))
    assert noise.done
    assert rel(eval_loss.item(), jax_steps["eval_loss"]) <= 1e-4


def test_nan_gradient_skips_the_update(ref):
    """A batch whose gradients are NaN leaves the parameters and Adam's
    state (its count too) bit for bit as they were; the EMA still counts
    the step."""
    model = port_model(ref)
    sde = sde_utils.VPSDE({"pos": 3}, N=50)
    optimizer = sde_utils.adam(model, LR)
    state = sde_utils.init_sde_state(model, sde_utils.Noise("cpu", 0))
    step = sde_utils.get_step_fn(sde, True, model=model, optimizer=optimizer,
                                 grad_clid_norm=1.0)
    gb = port_batch(ref["mols"])
    state, _, _ = step(state, gb)     # one good step: Adam has state
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    adam_before = {n: {k: v.clone() for k, v in optimizer.state[p].items()}
                   for n, p in model.named_parameters()}
    state, loss, _ = step(state, gb.replace(pos=gb["pos"] * float("nan")))
    assert not np.isfinite(loss.item())
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), before[name]), name
        for k, v in optimizer.state[p].items():
            assert torch.equal(v, adam_before[name][k]), (name, k)
        assert not p.grad.any()    # the accumulator is zeroed in place
    assert state["ema"]["num_updates"] == 2 and state["step"] == 2


# --------------------------------------------------------------- samplers

# beta_max 4 keeps the corrector's discrete alphas (1 - beta_max / N at
# t = 1) positive at N = 5; at the default 20 they are negative there and
# both packages' Langevin step sizes are NaN
SAMPLER_SDE = dict(beta_min=0.1, beta_max=4.0, N=5)


@pytest.fixture(scope="module")
def jax_samples(ref):
    sde = jsde.VPSDE({"pos": 3}, **SAMPLER_SDE)
    pc = jsampling.get_pc_sampler(
        sde, jsampling.get_predictor("euler_maruyama"),
        jsampling.get_corrector("langevin"), None, snr=0.16, n_steps=1,
        eps=1e-3)
    ode = jsampling.get_ode_sampler(sde, None, eps=1e-3, n_steps=5)
    gb = jax_batch(ref["mols"])
    jmodel = ref["jmodel"]
    out = {}
    for name, fn, key in (("pc", pc, 2), ("ode", ode, 4)):
        res, nfe = jax.jit(lambda p, b, k, fn=fn: fn(jmodel, p, b, k))(
            ref["params"], gb, jax.random.PRNGKey(key))
        out[name] = (np.asarray(res["pos"]), int(nfe), key)
    return out


def test_pc_sampler_matches_jax(ref, jax_samples):
    model = port_model(ref)
    sde = sde_utils.VPSDE({"pos": 3}, **SAMPLER_SDE)
    want, want_nfe, key = jax_samples["pc"]
    noise = Replay(jax_pc_draws(jax.random.PRNGKey(key), 5, 1, (N_CAP, 3)))
    pc = sde_sampling.get_pc_sampler(
        sde, sde_sampling.get_predictor("euler_maruyama"),
        sde_sampling.get_corrector("langevin"), None, snr=0.16, n_steps=1,
        eps=1e-3)
    out, nfe = pc(model, port_batch(ref["mols"]), noise)
    assert noise.done
    assert nfe == want_nfe == 5 * (1 + 1)
    assert torch.isfinite(out["pos"]).all()
    assert rel(out["pos"].numpy(), want) <= 1e-4, rel(out["pos"].numpy(),
                                                       want)


def test_ode_sampler_matches_jax(ref, jax_samples):
    model = port_model(ref)
    sde = sde_utils.VPSDE({"pos": 3}, **SAMPLER_SDE)
    want, want_nfe, key = jax_samples["ode"]
    _, draws = jax_prior(jax.random.PRNGKey(key), (N_CAP, 3))
    noise = Replay(draws)
    ode = sde_sampling.get_ode_sampler(sde, None, eps=1e-3, n_steps=5)
    out, nfe = ode(model, port_batch(ref["mols"]), noise)
    assert noise.done
    assert nfe == want_nfe == 2 * (5 - 1)
    assert rel(out["pos"].numpy(), want) <= 1e-4, rel(out["pos"].numpy(),
                                                       want)


def test_sampling_fn_and_registries():
    """``get_sampling_fn`` on ``sde_config``'s settings returns the real
    graphs' positions on the host; the registries hold the ``none``
    variants and refuse unknown names."""
    cfg = sde_get_config()
    assert cfg["sampling"]["method"] == "pc"
    assert sde_sampling.get_predictor("none") is sde_sampling.NonePredictor
    assert sde_sampling.get_corrector("none") is sde_sampling.NoneCorrector
    with pytest.raises(KeyError):
        sde_sampling.get_predictor("nonexistent")
    with pytest.raises(ValueError, match="unknown"):
        sde_sampling.get_sampling_fn(
            dict(cfg, sampling=dict(cfg["sampling"], method="x")),
            sde_utils.VPSDE({"pos": 3}, N=3), None, 1e-3)
    model = build_model(get_config("config_diffusion")["model_config"],
                        "cpu")
    mols = molecules(seed=4)
    fn = sde_sampling.get_sampling_fn(
        cfg, sde_utils.VPSDE({"pos": 3}, **SAMPLER_SDE), None, 1e-3)
    host, nfe = fn(model, port_batch(mols), sde_utils.Noise("cpu", 3))
    assert nfe == 10
    assert host["pos"].shape == (sum(len(m["pos"]) for m in mols), 3)
    assert np.isfinite(host["pos"]).all()
