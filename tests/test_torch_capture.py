"""The compiled step (``run/capture.py``, CUDA-graph capture as the port's
``jax.jit``) and the repairs it needed, on the CPU:

- ``capture.enabled``: on by default for a CUDA device in one process or
  under an NCCL process group, off on the CPU and under a gloo group;
  ``capture=True`` raises on the CPU, for every entry point, and under a
  gloo group; ``parallel.shutdown`` drops every graph before it ends the
  group;
- ``capture.Step``'s bookkeeping with a stand-in for
  ``torch.cuda.CUDAGraph`` (``ReplayingGraph``): one graph per signature,
  the warm-up count, one pool, the static inputs, the launch counts, the
  generators, ``drop``, and a capture that fails;
- the stand-in replays by running the function again on the static
  inputs and copying into the captured outputs, which is what a graph's
  replay does on the card; through it the captured trainer (four steps,
  ``grad_acc``, the watch hook, a resume), the SDE step, the samplers and
  serving equal their eager runs bit for bit;
- both sort-order caches build afresh while a capture is reported;
- the EMA with a device count equals JAX's ``make_ema_update`` over 12
  steps; the optimizers with a tensor rate equal optax; the SDE step's
  on-device skip (a non-finite gradient at step 3 of 6) equals JAX's
  jitted ``step_fn``; the samplers on the device timestep table equal
  JAX's on replayed draws; state loads copy in place.
"""

import gc
from copy import deepcopy
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from equivariant_nn_zoo_tpu.models import get_config as jget_config
from equivariant_nn_zoo_tpu.run import sde_sampling as jsampling
from equivariant_nn_zoo_tpu.run import sde_utils as jsde
from equivariant_nn_zoo_tpu.run.trainer import make_ema_update
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu_torch import inference
from equivariant_nn_zoo_tpu_torch.data import (
    Batch,
    Data,
    GraphBatch,
    computeEdgeIndex,
)
from equivariant_nn_zoo_tpu_torch.data.compute_edge import EdgeRandom
from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.ops.cuda import FullConv, edge_order
from equivariant_nn_zoo_tpu_torch.ops.cuda import species_order
from equivariant_nn_zoo_tpu_torch.run import capture, sde_sampling, sde_utils
from equivariant_nn_zoo_tpu_torch.run.trainer import (
    OPTIMIZERS,
    Trainer,
    ema_update,
)
from equivariant_nn_zoo_tpu_torch.utils import load_jax_params
from test_torch_edge_order import torch_threads_per_worker
from test_torch_sde import (
    G,
    LR,
    N_CAP,
    SAMPLER_SDE,
    Replay,
    flat,
    jax_batch,
    jax_pc_draws,
    jax_prior,
    jax_step_draws,
    molecules,
    port_batch,
    rel,
)

torch_threads_per_worker()


# ------------------------------------------------------------ the stand-in

class ReplayingGraph:
    """``torch.cuda.CUDAGraph``'s stand-in on the CPU.  The CPU has no
    deferred work, so the function runs for real while it is "captured";
    the first replay after the capture is that run, and every later replay
    runs the function again on the static inputs and copies its results
    into the captured outputs (``rerun``, set by ``CPUStep``)."""

    def __init__(self):
        self.generators, self.replays = [], 0
        self.pool_in = self.mode = None
        self.handle = object()
        self.rerun = None
        self._captured = False

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.pool_in, self.mode = pool, capture_error_mode

    def capture_end(self):
        self._captured = True

    def pool(self):
        return self.handle

    def replay(self):
        self.replays += 1
        if self._captured:
            self._captured = False
        else:
            self.rerun()


class CPUStep(capture.Step):
    """``capture.Step`` over ``ReplayingGraph``."""

    def __init__(self, name, fn, **kw):
        kw.setdefault("graph", ReplayingGraph)
        super().__init__(name, fn, **kw)

    def _capture(self, entry, args, leaves):
        super()._capture(entry, args, leaves)
        static = capture._unflatten(args, iter(entry.inputs))
        outs = []
        capture._flatten(entry.outputs, outs)

        def rerun():
            # a graph relaunches kernels, not their wrappers: what a
            # wrapper counts while the stand-in reruns is taken back
            launches = FullConv.launches
            new = []
            capture._flatten(self.fn(*static), new)
            FullConv.launches = launches
            for dst, src in zip(outs, new):
                dst.copy_(src.detach())

        entry.graph.rerun = rerun


@pytest.fixture
def captured(monkeypatch):
    """Every entry point compiles (through ``CPUStep``) unless it is
    given ``capture=False``; the steps made are listed.  The runs are
    compared bit for bit, so torch takes one intra-op thread meanwhile:
    with several, a CPU reduction may split its work differently from one
    call to the next (seen in the first steps of a process)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    made = []

    def step(name, fn, **kw):
        made.append(CPUStep(name, fn, **kw))
        return made[-1]

    monkeypatch.setattr(capture, "enabled",
                        lambda c, device, draws=(): c is not False)
    monkeypatch.setattr(capture, "Step", step)
    monkeypatch.setattr(inference, "_FORWARDS",
                        inference.weakref.WeakKeyDictionary())
    yield made
    torch.set_num_threads(threads)


# --------------------------------------------------------------- enabled

def test_enabled_picks_capture_and_raises_where_it_cannot_run():
    assert capture.enabled(None, "cuda") is True
    assert capture.enabled(None, "cpu") is False
    assert capture.enabled(False, "cuda") is False
    with pytest.raises(ValueError, match="CUDA device"):
        capture.enabled(True, "cpu")
    model = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        Trainer(model, {"y": 1.0}, capture=True)
    sde = sde_utils.VPSDE({"pos": 3}, N=5)
    with pytest.raises(ValueError, match="CUDA device"):
        sde_utils.get_step_fn(sde, True, model=model,
                              optimizer=sde_utils.adam(model, 1e-3),
                              capture=True)
    mols = molecules()
    with pytest.raises(ValueError, match="CUDA device"):
        inference.evaluate(model, [port_batch(mols)], capture=True)
    sampler = sde_sampling.get_ode_sampler(sde, None, n_steps=3,
                                           capture=True)
    with pytest.raises(ValueError, match="CUDA device"):
        sampler(None, port_batch(mols))


def test_default_is_eager_under_a_process_group(monkeypatch):
    """Under a gloo group the steps run eagerly and ``capture=True``
    raises: only NCCL collectives can be recorded into a CUDA graph.
    Under NCCL (the group's backend stubbed here) the steps are captured
    by default, the gradients' all-reduce inside the graph."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        assert capture.enabled(None, "cuda") is False
        assert capture.enabled(False, "cuda") is False
        with pytest.raises(ValueError, match="gloo process group"):
            capture.enabled(True, "cuda")
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        assert capture.enabled(None, "cuda") is True
        assert capture.enabled(True, "cuda") is True
        assert capture.enabled(None, "cpu") is False
        assert capture.enabled(False, "cuda") is False
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()
    assert capture.enabled(None, "cuda") is True


def test_shutdown_releases_every_graph_first(monkeypatch):
    """``parallel.shutdown`` drops every step's graphs before it destroys
    the process group (NCCL's destroy waits for ever on a communicator
    that a live graph recorded); the steps capture anew afterwards."""
    from equivariant_nn_zoo_tpu_torch import parallel

    step = CPUStep("held", lambda x: x + 1)
    for _ in range(3):
        step(torch.ones(2))
    assert step.captures == 1 and step.graphs
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    real, seen = dist.destroy_process_group, []

    def destroy(*args, **kwargs):
        seen.append(len(step.graphs))
        real(*args, **kwargs)

    monkeypatch.setattr(dist, "destroy_process_group", destroy)
    parallel.shutdown()
    assert seen == [0] and not dist.is_initialized()
    step(torch.ones(2))
    (entry,) = step.graphs.values()
    assert entry.calls == 1 and entry.graph is None


# ------------------------------------------------------------ bookkeeping

def test_step_bookkeeping():
    """Warm-up, one capture and one graph per signature, one pool, copies
    into the static inputs, launches counted where the wrapper runs (the
    warm-up and the capture, never a replay), the generators registered,
    ``drop``."""
    calls = []

    def fn(x, d):
        calls.append(x.shape)
        FullConv.launches += 1        # as a kernel wrapper counts
        return {"y": 2 * x + sum(d.values())}

    gen = SimpleNamespace(device=torch.device("cuda"))
    step = CPUStep("toy", fn, generators=lambda: [gen])
    launches0 = FullConv.launches
    xs = [torch.full((3,), float(i)) for i in range(5)]
    a = torch.ones(3)
    for i in range(2):                        # the warm-up runs eagerly
        assert torch.equal(step(xs[i], {"a": a})["y"], 2 * xs[i] + 1)
        (entry,) = step.graphs.values()
        assert entry.calls == i + 1 and entry.graph is None
    assert step.captures == 0 and FullConv.launches - launches0 == 2
    out = step(xs[2], {"a": a})               # capture, then one replay
    assert step.captures == 1 and entry.graph.replays == 1
    assert torch.equal(out["y"], 2 * xs[2] + 1)
    assert entry.graph.generators == [gen]
    assert entry.graph.mode == "thread_local" and entry.graph.pool_in is None
    assert FullConv.launches - launches0 == 3   # two runs and the capture
    static_y = out["y"]
    out = step(xs[3], {"a": 3 * a})           # copied in, replayed
    assert out["y"] is static_y and torch.equal(out["y"], 2 * xs[3] + 3)
    assert torch.equal(entry.inputs[0], xs[3])
    assert torch.equal(entry.inputs[1], 3 * a)
    assert FullConv.launches - launches0 == 3 and step.captures == 1
    # a static input passed back in is not copied onto itself
    entry.inputs[0].fill_(7.0)
    assert torch.equal(step(entry.inputs[0], {"a": a})["y"],
                        torch.full((3,), 15.0))
    # a new signature: its own warm-up and graph, in the same pool
    wide = [torch.ones(5) * i for i in range(3)]
    for x in wide:
        step(x, {"a": torch.ones(5)})
    assert len(step.graphs) == 2 and step.captures == 2
    second = step.graphs[next(k for k in step.graphs
                              if step.graphs[k] is not entry)]
    assert second.graph.pool_in is entry.graph.handle
    # a signature is the structure too: another key is another graph
    step(xs[0], {"b": a})
    assert len(step.graphs) == 3
    step.drop()
    assert not step.graphs and step.pool is None
    step(xs[4], {"a": a})
    (entry,) = step.graphs.values()
    assert entry.calls == 1 and entry.graph is None


def test_no_garbage_is_collected_inside_a_capture():
    """The collector runs before a capture and is off during it (a
    destructor calling the CUDA runtime there, as an old graph's does,
    would void the capture); it is back on after, also after a failure."""
    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        if len(seen) == 6:
            raise RuntimeError("during capture")
        return x + 1

    for name in ("gc", "gc_broken"):
        step = CPUStep(name, fn)
        step(torch.ones(2))
        step(torch.ones(2))
        if name == "gc":
            step(torch.ones(2))               # captured
        else:
            with pytest.raises(RuntimeError, match="during capture"):
                step(torch.ones(2))
        assert gc.isenabled()
    assert seen == [True, True, False] * 2


def test_failed_capture_raises_with_the_step_name():
    state = {"n": 0}

    def fn(x):
        state["n"] += 1
        if state["n"] > 2:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return x + 1

    step = CPUStep("broken", fn)
    step(torch.ones(2))
    step(torch.ones(2))
    with pytest.raises(RuntimeError, match="'broken'.*capture failed.*"
                                           "not permitted"):
        step(torch.ones(2))


def test_capture_only_where_a_replay_renews_every_draw():
    """A step whose draws come from a source without ``capturable`` (given
    arrays at a host cursor) runs eagerly by default, and ``capture=True``
    raises for it; ``Noise``, ``EdgeRandom`` and a model drawing from one
    capture."""
    replay = Replay([])
    rand = EdgeRandom(0)
    model = torch.nn.Module()
    model.layers = [("edge_index", partial(lambda data, attrs, rand=None:
                                           None, rand=rand))]
    assert sde_utils.Noise.capturable and EdgeRandom.capturable
    assert capture.renews(SimpleNamespace(capturable=True), model, None)
    assert not capture.renews(replay) and not capture.renews(model, replay)
    assert capture.enabled(None, "cuda", (rand, model)) is True
    assert capture.enabled(None, "cuda", (replay, model)) is False
    assert capture.enabled(False, "cuda", (replay,)) is False
    with pytest.raises(ValueError, match="cannot renew"):
        capture.enabled(True, "cuda", (model, replay))
    # a model whose edge layer draws from a host source
    model.layers = [("edge_index", partial(lambda data, attrs, rand=None:
                                           None, rand=replay))]
    assert capture.enabled(None, "cuda", (model,)) is False


def test_steps_ask_with_their_sources_of_draws(diffusion, monkeypatch):
    """The samplers and the SDE step pass their noise source and model to
    ``capture.enabled``, so a source of given arrays keeps them eager."""
    asked = []
    real = capture.enabled

    def spy(c, device, draws=()):
        asked.append(tuple(draws))
        return real(c, device, draws)

    monkeypatch.setattr(capture, "enabled", spy)
    model = diffusion_model(diffusion)
    sde = sde_utils.VPSDE({"pos": 3}, **SAMPLER_SDE)
    _, draws = jax_prior(jax.random.PRNGKey(4), (N_CAP, 3))
    noise = Replay(draws)
    sde_sampling.get_ode_sampler(sde, None, eps=1e-3, n_steps=5)(
        model, port_batch(diffusion["mols"]), noise)
    assert asked == [(noise, model)]
    noise = Replay(diffusion["draws"])
    state = sde_utils.init_sde_state(model, noise)
    step = sde_utils.get_step_fn(sde_utils.VPSDE({"pos": 3}, N=50), True,
                                 model=model,
                                 optimizer=sde_utils.adam(model, LR),
                                 **diffusion["kw"])
    step(state, port_batch(diffusion["mols"]))
    assert asked[-1] == (noise, model)


def test_generators_of_noise_edge_draws_and_models():
    cuda = SimpleNamespace(device=torch.device("cuda"))
    cpu = torch.Generator()
    rand = SimpleNamespace(generators={"cuda": cuda})
    layer = partial(lambda data, attrs, rand=None: None, rand=rand)
    model = torch.nn.Module()
    model.layers = [("edge_index", layer), ("other", torch.nn.Identity())]
    assert capture.generators(SimpleNamespace(generator=cuda)) == [cuda]
    assert capture.generators(SimpleNamespace(generator=cpu)) == []
    assert capture.generators(model, Replay([])) == [cuda]


# ------------------------------------------------------------ sort orders

@pytest.mark.parametrize("which", ["edge", "species"])
def test_order_caches_build_afresh_while_capturing(monkeypatch, which):
    """An order cached by the warm-up is never handed to a capture on the
    same tensors: the capture builds its own (shared by its layers) and
    leaves the cache alone."""
    src = torch.tensor([3, 0, 2, 1, 0])
    dst = torch.tensor([0, 1, 1, 3, 2])
    mod, args = ((edge_order, (src, dst, 4)) if which == "edge"
                 else (species_order, (src, 4)))
    eager = mod.shared(*args)
    builds = mod.builds
    assert mod.shared(*args) is eager and mod.builds == builds
    capturing = {"on": True}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing["on"])
    inside = mod.shared(*args)
    assert inside is not eager and mod.builds == builds + 1
    for a, b in zip(inside, eager):
        assert torch.equal(a, b)
    assert mod.shared(*args) is inside and mod.builds == builds + 1
    assert mod._last[2] is eager               # the cache is untouched
    capturing["on"] = False
    assert mod.shared(*args) is eager and mod.builds == builds + 1
    assert mod._captured is None
    capturing["on"] = True
    assert mod.shared(*args) is not inside     # a new capture, a new order
    assert mod.builds == builds + 2


# ------------------------------------------------------- EMA, optimizers

@pytest.mark.parametrize("use_num_updates", [True, False])
def test_ema_with_a_device_count_matches_jax(use_num_updates):
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (3,), ()]
    ema = [rng.normal(size=s).astype(np.float32) for s in shapes]
    update = make_ema_update(0.99, use_num_updates)
    jstate = {"params": [jnp.asarray(e) for e in ema],
              "num_updates": jnp.zeros((), jnp.int32)}
    port = [torch.tensor(e) for e in ema]
    count = torch.zeros((), dtype=torch.int32)
    for _ in range(12):
        live = [rng.normal(size=s).astype(np.float32) for s in shapes]
        jstate = update(jstate, [jnp.asarray(p) for p in live])
        ema_update(port, [torch.tensor(p) for p in live], count, 0.99,
                   use_num_updates)
        assert int(count) == int(jstate["num_updates"])
        for got, want in zip(port, jstate["params"]):
            assert rel(got.numpy(), want) <= 1e-6


TENSOR_RATE_CASES = [
    ("Adam", {}, optax.adam, {}),
    ("Adam", {"b1": 0.8}, optax.adam, {"b1": 0.8}),
    ("AdamW", {"weight_decay": 0.1}, optax.adamw, {"weight_decay": 0.1}),
    ("SGD", {}, optax.sgd, {}),
    ("SGD", {"momentum": 0.9}, optax.sgd, {"momentum": 0.9}),
    ("SGD", {"momentum": 0.9, "nesterov": True}, optax.sgd,
     {"momentum": 0.9, "nesterov": True}),
    ("RMSprop", {"centered": True, "decay": 0.8}, optax.rmsprop,
     {"centered": True, "decay": 0.8}),
    ("RMSprop", {"momentum": 0.5, "nesterov": True}, optax.rmsprop,
     {"momentum": 0.5, "nesterov": True}),
    ("RMSprop", {"eps_in_sqrt": False, "bias_correction": True,
                 "initial_scale": 0.1, "centered": True}, optax.rmsprop,
     {"eps_in_sqrt": False, "bias_correction": True, "initial_scale": 0.1,
      "centered": True}),
]


@pytest.mark.parametrize("name,kwargs,opt_fn,opt_kwargs", TENSOR_RATE_CASES)
def test_optimizers_with_a_tensor_rate_match_optax(name, kwargs, opt_fn,
                                                   opt_kwargs):
    """Six steps with the rate a tensor, changed in place after the third
    (``Trainer._set_lr``), against optax fed the same gradients; the rate
    tensor and the state tensors stay the same objects."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Linear(4, 3))
    rate = torch.tensor(1e-2)
    opt = OPTIMIZERS[name](model.parameters(), rate, **kwargs)
    params = {n: jnp.asarray(p.detach().numpy().copy())
              for n, p in model.named_parameters()}
    jopt = optax.inject_hyperparams(opt_fn)(learning_rate=1e-2,
                                            **opt_kwargs)
    state = jopt.init(params)
    rng = np.random.default_rng(1)
    held = None
    for step in range(6):
        if step == 3:
            Trainer._set_lr(SimpleNamespace(optimizer=opt), 5e-3)
            state.hyperparams["learning_rate"] = jnp.asarray(5e-3,
                                                             jnp.float32)
        grads = {n: rng.normal(size=params[n].shape).astype(np.float32)
                 for n in params}
        for n, p in model.named_parameters():
            p.grad = torch.tensor(grads[n])
        opt.step()
        assert opt.param_groups[0]["lr"] is rate
        tensors = [id(t) for s in opt.state.values() for t in s.values()]
        assert held is None or tensors == held
        held = tensors
        updates, state = jopt.update(
            {n: jnp.asarray(g) for n, g in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for n, p in model.named_parameters():
            want = np.asarray(params[n])
            err = np.abs(p.detach().numpy() - want).max()
            assert err <= 1e-5 * max(np.abs(want).max(), 1.0), (step, n, err)


def test_optimizer_state_loads_in_place():
    model = torch.nn.Linear(3, 2)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt = OPTIMIZERS["Adam"](model.parameters(), torch.tensor(1e-3))
    opt.step()
    saved = opt.state_dict()
    saved = {"state": {i: {k: v.clone() * 2 for k, v in s.items()}
                       for i, s in saved["state"].items()},
             "param_groups": [dict(g, lr=np.float32(5e-4),
                                   capturable=True)
                              for g in saved["param_groups"]]}
    held = {id(t) for s in opt.state.values() for t in s.values()}
    rate = opt.param_groups[0]["lr"]
    assert capture.load_optimizer_state(opt, saved) is True
    assert {id(t) for s in opt.state.values() for t in s.values()} == held
    assert opt.param_groups[0]["lr"] is rate
    assert float(rate) == np.float32(5e-4)
    assert "capturable" not in opt.param_groups[0]   # not the run's
    for p, (i, s) in zip(model.parameters(), saved["state"].items()):
        for k, v in s.items():
            assert torch.equal(opt.state[p][k], v)
    fresh = OPTIMIZERS["Adam"](torch.nn.Linear(3, 2).parameters(),
                               torch.tensor(1e-3))
    fresh_rate = fresh.param_groups[0]["lr"]
    # the state is made with the optimizer: a fresh one loads in place
    assert capture.load_optimizer_state(fresh, saved) is True
    # a file whose state does not match key for key loads into new tensors
    assert capture.load_optimizer_state(fresh, dict(saved, state={})) is False
    assert fresh.param_groups[0]["lr"] is fresh_rate
    assert float(fresh_rate) == np.float32(5e-4)
    assert "capturable" not in fresh.param_groups[0]


# ------------------------------------------------------------ the trainer

SHIFTS = [0.0, -16.4, 0, 0, 0, 0, -1036.0, -1489.0, -2047.0, 0]


def energy_batches(n_batches, seed, per_batch=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        mols = []
        for _ in range(per_batch):
            n = int(rng.integers(3, 7))
            d = {"pos": rng.normal(size=(n, 3)) * 1.2,
                 "species": rng.choice([1, 6, 7, 8], size=(n, 1)),
                 "total_energy": rng.normal(size=(1, 1))}
            attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
                     "total_energy": ("graph", "1x0e")}
            e, attrs = computeEdgeIndex(d, attrs, r_max=4.0)
            d.update(e)
            mols.append(Data(attrs, **d))
        out.append(GraphBatch.from_batch(Batch.from_data_list(mols), 24,
                                         96, per_batch + 1, "cpu"))
    return out


def energy_trainer(capture_arg, **kw):
    mc = tlc.addEnergyOutput(tlc.featureModel(
        l_max=1, edge_spherical="1x0e+1x1o", node_attrs="4x0e",
        edge_radial="4x0e", num_types=10, r_max=4.0, n_dim=4,
        num_layers=2), shifts=SHIFTS)
    model = build_model(mc, "cpu", torch.Generator().manual_seed(0))
    settings = dict(learning_rate=1e-2, optimizer_name="Adam",
                    lr_scheduler_name="ReduceLROnPlateau",
                    lr_scheduler_patience=0, lr_scheduler_factor=0.5,
                    use_ema=True, ema_decay=0.99, max_gradient_norm=1.0,
                    max_epochs=10, batch_size=3)
    settings.update(kw)
    return Trainer(model, {"total_energy": [1.0, "MSELoss"]},
                   capture=capture_arg, **settings)


def trainer_state(tr):
    out = {f"p.{n}": p.detach().clone()
           for n, p in tr.model.named_parameters()}
    out.update({f"e.{n}": p.detach().clone()
                for n, p in tr.ema_model.named_parameters()})
    for n, p in tr.model.named_parameters():
        out.update({f"o.{n}.{k}": v.clone()
                    for k, v in tr.optimizer.state.get(p, {}).items()})
    out["ema_count"] = tr.ema_count.clone()
    return out


def assert_same(a, b):
    """Equal bit for bit.  A parameter that no loss reaches has no
    gradient in an eager step, and no optimizer state; a captured step
    gives it a zero gradient (every leaf steps, as in optax), whose Adam
    moments stay zero: that is the only difference allowed."""
    assert set(a) <= set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in set(b) - set(a):
        assert k.startswith("o.") and (k.endswith(".step")
                                       or not b[k].any()), k


@pytest.mark.parametrize("grad_acc", [1, 3])
def test_captured_trainer_equals_eager(captured, grad_acc):
    """Two epochs of six training batches (three distinct, so replays see
    other batches than their capture) and two validation batches, the
    rate changed by the scheduler between them, and the watch hook: the
    captured trainer's parameters, EMA, optimizer state, losses and
    metrics equal the eager trainer's bit for bit.  Then a resume after
    the first epoch (a fresh trainer: its optimizer state loads into new
    tensors, so its graphs are dropped and captured anew) ends where the
    uninterrupted captured run does, bit for bit."""
    train = energy_batches(3, 0) * 2
    val = energy_batches(2, 1)
    runs = {}
    for name in ("eager", "captured"):
        tr = energy_trainer(False if name == "eager" else None,
                            grad_acc=grad_acc, watch_freq=2)
        logs = []
        for _ in range(2):
            tr.epoch_step(train, val)
            logs.append(dict(tr.mae_dict, wall=0.0))
            if name == "captured" and not runs.get("after_one"):
                # a copy: on the CPU ``as_dict``'s arrays share the live
                # optimizer state's memory
                runs["after_one"] = (deepcopy(tr.as_dict(
                    state_dict=True, training_progress=True)),
                                     {n: p.detach().clone() for n, p in
                                      tr.model.named_parameters()})
        runs[name] = (tr, logs)
    (eager, elog), (capt, clog) = runs["eager"], runs["captured"]
    assert elog == clog
    assert_same(trainer_state(eager), trainer_state(capt))
    watched = getattr(eager, "watch_dict", {})
    assert bool(watched) == (grad_acc == 1)
    assert set(watched) <= set(getattr(capt, "watch_dict", {}))
    for k, v in watched.items():
        if isinstance(v, tuple):
            assert all(np.array_equal(a, b) for a, b in zip(v,
                                                           capt.watch_dict[k]))
        else:
            assert v == capt.watch_dict[k], k
    steps = {s.name: s for s in captured[:4]}
    used = ["train"] if grad_acc == 1 else ["accumulate", "apply"]
    for name, step in steps.items():
        if name in used + ["eval"]:
            assert step.captures == 1 and len(step.graphs) == 1, name
        else:
            assert step.captures == 0, name
    # the resume
    saved, params = runs["after_one"]
    model = energy_trainer(False).model
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
    saved = dict(saved)
    saved["progress"] = dict(saved["progress"], stop_arg=None)
    resumed = Trainer.from_dict(saved, model=model)
    assert resumed._steps and resumed.ema_num_updates == (
        capt.ema_num_updates // 2)
    resumed.epoch_step(train, val)
    assert dict(resumed.mae_dict, wall=0.0) == clog[1]
    assert_same(trainer_state(capt), trainer_state(resumed))


# -------------------------------------------------- SDE step and samplers

@pytest.fixture(scope="module")
def diffusion():
    """The ``""`` spec's JAX model and parameters, six jitted JAX steps
    (Adam, clip 1.0, EMA 0.99) with a non-finite gradient at step 3, and
    JAX's PC and ODE samples at N = 5."""
    jmodel = jbuild(jget_config("config_diffusion", "").model_config)
    params = jmodel.init(jax.random.PRNGKey(0))
    mols = molecules()
    sde = jsde.VPSDE({"pos": 3}, N=50)
    optimizer = optax.adam(LR)
    state = jsde.init_sde_state(params, optimizer, jax.random.PRNGKey(1))
    kw = dict(reduce_mean=True, grad_clid_norm=1.0, ema_decay=0.99)
    step = jsde.get_step_fn(sde, True, model=jmodel, optimizer=optimizer,
                            **kw)
    gb = jax_batch(mols)
    pos = np.array(gb["pos"])
    pos[0, 0] = np.inf
    bad = gb.replace(pos=pos)
    losses, states = [], []
    for i in range(6):
        state, loss, _ = step(state, bad if i == 2 else gb)
        losses.append(float(loss))
        states.append(dict(params=flat(state["params"]),
                           ema=flat(state["ema"]["params"]),
                           mu=flat(state["opt_state"][0].mu),
                           nu=flat(state["opt_state"][0].nu),
                           count=int(state["opt_state"][0].count)))
    sampler_sde = jsde.VPSDE({"pos": 3}, **SAMPLER_SDE)
    pc = jsampling.get_pc_sampler(
        sampler_sde, jsampling.get_predictor("euler_maruyama"),
        jsampling.get_corrector("langevin"), None, snr=0.16, n_steps=1,
        eps=1e-3)
    ode = jsampling.get_ode_sampler(sampler_sde, None, eps=1e-3, n_steps=5)
    samples = {}
    for name, fn, key in (("pc", pc, 2), ("ode", ode, 4)):
        res, _ = jax.jit(lambda p, b, k, fn=fn: fn(jmodel, p, b, k))(
            params, gb, jax.random.PRNGKey(key))
        samples[name] = np.asarray(res["pos"])
    return dict(params=params, mols=mols, kw=kw, losses=losses,
                states=states,
                draws=jax_step_draws(jax.random.PRNGKey(1), 6, G,
                                     (N_CAP, 3)),
                samples=samples)


def diffusion_model(diffusion):
    model = build_model(get_config("config_diffusion", "")["model_config"],
                        "cpu")
    return load_jax_params(model, diffusion["params"])


def sde_run(diffusion, noise, capture_arg):
    model = diffusion_model(diffusion)
    sde = sde_utils.VPSDE({"pos": 3}, N=50)
    optimizer = sde_utils.adam(model, LR)
    state = sde_utils.init_sde_state(model, noise)
    step = sde_utils.get_step_fn(sde, True, model=model,
                                 optimizer=optimizer, capture=capture_arg,
                                 **diffusion["kw"])
    gb = port_batch(diffusion["mols"])
    pos = gb["pos"].clone()
    pos[0, 0] = float("inf")
    bad = gb.replace(pos=pos)
    losses, states = [], []
    for i in range(6):
        state, loss, _ = step(state, bad if i == 2 else gb)
        losses.append(loss.item())
        states.append(dict(
            params={n: p.detach().clone()
                    for n, p in model.named_parameters()},
            ema={n: p.detach().clone() for n, p in
                 state["ema"]["model"].named_parameters()},
            mu={n: optimizer.state[p]["exp_avg"].clone()
                for n, p in model.named_parameters()},
            nu={n: optimizer.state[p]["exp_avg_sq"].clone()
                for n, p in model.named_parameters()},
            count={n: int(optimizer.state[p]["step"])
                   for n, p in model.named_parameters()}))
    return losses, states, state


def test_sde_skip_on_the_device_matches_jax(diffusion):
    """A non-finite gradient at step 3 of 6: the skipped step leaves the
    parameters and Adam's state (its count too) bit for bit, the EMA still
    moves, and every step's state equals JAX's ``lax.cond`` skip."""
    losses, states, state = sde_run(diffusion, Replay(diffusion["draws"]),
                                    False)
    assert not np.isfinite(losses[2]) and not np.isfinite(
        diffusion["losses"][2])
    finite = [i for i in range(6) if i != 2]
    np.testing.assert_allclose(np.array(losses)[finite],
                               np.array(diffusion["losses"])[finite],
                               rtol=1e-5)
    for what in ("params", "mu", "nu"):
        for n, v in states[2][what].items():
            assert torch.equal(v, states[1][what][n]), (what, n)
    assert state["ema"]["num_updates"] == 6
    for got, want in zip(states, diffusion["states"]):
        assert set(got["count"].values()) == {want["count"]}
        for what in ("params", "ema", "mu", "nu"):
            for n, v in got[what].items():
                w = want[what][n]
                if not np.abs(w).any():
                    np.testing.assert_array_equal(v.numpy(), w)
                    continue
                assert rel(v.numpy(), w) <= 1e-4, (what, n, rel(v.numpy(),
                                                                 w))


def test_captured_sde_step_equals_eager(diffusion, captured):
    runs = [sde_run(diffusion, sde_utils.Noise("cpu", 3), c)
            for c in (False, None)]
    (l0, s0, st0), (l1, s1, st1) = runs
    np.testing.assert_array_equal(l0, l1)
    for a, b in zip(s0, s1):
        for what in ("params", "ema", "mu", "nu"):
            assert_same(a[what], b[what])
        assert a["count"] == b["count"]
    (step,) = [s for s in captured if s.name == "sde_apply"]
    assert step.captures == 1 and len(step.graphs) == 1
    evaluate = sde_utils.get_step_fn(sde_utils.VPSDE({"pos": 3}, N=50),
                                     False, capture=False)
    gb = port_batch(diffusion["mols"])
    st0["noise"], st1["noise"] = (sde_utils.Noise("cpu", 5),
                                  sde_utils.Noise("cpu", 5))
    eager = [evaluate(st0, gb)[1].item() for _ in range(4)]
    evaluate = sde_utils.get_step_fn(sde_utils.VPSDE({"pos": 3}, N=50),
                                     False, capture=None)
    assert eager == [evaluate(st1, gb)[1].item() for _ in range(4)]
    (step,) = [s for s in captured if s.name == "sde_eval"]
    assert step.captures == 1


def test_sde_loads_copy_in_place_or_capture_anew(diffusion, captured):
    """``load_sde_state_dict`` copies into the tensors the captured step
    reads (same graphs after it); a load that replaces the optimizer's
    state gets new graphs."""
    model = diffusion_model(diffusion)
    optimizer = sde_utils.adam(model, LR)
    state = sde_utils.init_sde_state(model, sde_utils.Noise("cpu", 3))
    step = sde_utils.get_step_fn(sde_utils.VPSDE({"pos": 3}, N=50), True,
                                 model=model, optimizer=optimizer,
                                 **diffusion["kw"])
    gb = port_batch(diffusion["mols"])
    for _ in range(3):
        state, _, _ = step(state, gb)
    made = len(captured)
    held = [id(t) for st in optimizer.state.values() for t in st.values()]
    tree = sde_utils.sde_state_dict(state, model, optimizer)
    sde_utils.load_sde_state_dict(tree, state, model, optimizer)
    assert held == [id(t) for st in optimizer.state.values()
                    for t in st.values()]
    assert state["ema"]["num_updates"] == 3
    step(state, gb)
    assert len(captured) == made and captured[-1].captures == 1
    optimizer.load_state_dict(optimizer.state_dict())
    step(state, gb)
    assert len(captured) == made + 1


@pytest.mark.parametrize("kind", ["pc", "ode"])
def test_samplers_on_device_timesteps_match_jax(diffusion, captured, kind):
    """The samplers' device timestep table and step counter, eager and
    through the stand-in graph, on JAX's own draws: equal to each other
    bit for bit and to JAX at the sampler tests' 1e-4."""
    sde = sde_utils.VPSDE({"pos": 3}, **SAMPLER_SDE)
    model = diffusion_model(diffusion)
    outs = []
    for capture_arg in (False, None):
        if kind == "pc":
            draws = jax_pc_draws(jax.random.PRNGKey(2), 5, 1, (N_CAP, 3))
            sampler = sde_sampling.get_pc_sampler(
                sde, sde_sampling.get_predictor("euler_maruyama"),
                sde_sampling.get_corrector("langevin"), None, snr=0.16,
                n_steps=1, eps=1e-3, capture=capture_arg)
        else:
            _, draws = jax_prior(jax.random.PRNGKey(4), (N_CAP, 3))
            sampler = sde_sampling.get_ode_sampler(
                sde, None, eps=1e-3, n_steps=5, capture=capture_arg)
        noise = Replay(draws)
        out, _ = sampler(model, port_batch(diffusion["mols"]), noise)
        assert noise.done
        outs.append(out)
    assert torch.equal(outs[0]["pos"], outs[1]["pos"])
    assert torch.equal(outs[0]["t"], outs[1]["t"])
    last = np.linspace(1.0, 1e-3, 5).astype(np.float32)[
        -1 if kind == "pc" else -2]
    assert float(outs[0]["t"][0, 0]) == last
    (step,) = [s for s in captured if s.name == f"{kind}_sampler"]
    assert step.captures == 1
    (entry,) = step.graphs.values()
    assert entry.graph.replays == (5 if kind == "pc" else 4) - 2
    got = outs[0]["pos"].numpy()
    assert rel(got, diffusion["samples"][kind]) <= 1e-4


def test_captured_serving_equals_eager(captured):
    """``evaluate`` through one graph per capacity, kept with the model
    across calls, equals the eager forward."""
    tr = energy_trainer(False)
    batches = energy_batches(4, 2)
    want = inference.evaluate(tr.model, batches, ["total_energy"],
                              capture=False)
    for _ in range(2):
        got = inference.evaluate(tr.model, batches, ["total_energy"])
        np.testing.assert_array_equal(got["total_energy"],
                                      want["total_energy"])
    (step,) = captured
    assert step.captures == 1 and len(step.graphs) == 1
    (entry,) = step.graphs.values()
    assert entry.graph.replays == 8 - 2
