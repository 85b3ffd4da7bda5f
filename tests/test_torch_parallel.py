"""The port's data parallelism on the CPU: two gloo ranks, each a
subprocess with one torch thread and its own timeout, running a runner
script written into ``tmp_path``:

- the port's train CLI at ``--world_size 2`` on two HDF5 shards, as
  ``tests/test_multiprocess.py`` drives the JAX CLI: both ranks exit 0
  with equal parameters, and only rank 0 writes checkpoints;
- three DDP training steps of the port's ``Trainer`` from JAX-initialised
  parameters, each rank on its own shard, against the JAX package's
  ``make_dp_train_step`` on a 2-device virtual mesh with optax Adam on the
  same shards: losses at rtol 1e-5, parameters at 1e-4; for the energy
  head and for ``config_energy_force``'s (forces by ``autograd.grad``
  inside the forward);
- a resume of two ranks continues each rank's own split and loader
  stream (the train CLI, bit for bit against an unbroken run) and each
  rank's own SDE noise (the diffusion loop);
- unequal shards (32 and 24 molecules, so 2 and 1 training batches) end
  within their timeout (the ranks agree on the batch count);
- ``grad_acc`` 2 under DDP equals one process's step on the mean gradient
  of the four micro-batches (1e-5);
- ranks whose validation data differ see the same, averaged, validation
  loss and stop at the same epoch;
- the SDE step's NaN/Inf skip: when one rank's batch is poisoned, both
  ranks skip the step and keep equal parameters;
- one step at two ranks of ``config_dipole``, ``config_hamiltonian`` (the
  ``Trainer``), ``config_diffusion`` ``"nll"`` and ``config_diffusion_CA``
  (``get_step_fn``), narrow where the tests narrow them, all in one spawn,
  against one process's step on both ranks' batches (``grad_acc`` 2, each
  micro-batch with its rank's noise): each rank's loss at 1e-6, the
  gradient the optimizer steps on at 1e-5 of the largest (Adam turns the
  1e-17 noise of gradients that are zero by symmetry into steps of its
  rate, so the parameters after it are not compared), the ranks'
  parameters equal bit for bit (a parameter without a gradient,
  ``"nll"``'s energy bias, averages zeros, with no
  ``find_unused_parameters``);
- in the same spawn, the flat reduce (``parallel.GradReducer``) against
  ``DistributedDataParallel`` on the energy model, at ``grad_acc`` 1 and
  2 (``no_sync`` on the first micro-batch): equal gradients bit for bit;
- two ranks' loaders with ``num_shards`` 2 yield the parts of each global
  batch that the JAX loader stacks for a 2-device mesh.
"""

import os
import pickle
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from equivariant_nn_zoo_tpu.data import Batch as JBatch
from equivariant_nn_zoo_tpu.data import Data as JData
from equivariant_nn_zoo_tpu.data import GraphBatch as JGraphBatch
from equivariant_nn_zoo_tpu.models import layer_configs as jlc
from equivariant_nn_zoo_tpu.parallel import make_mesh
from equivariant_nn_zoo_tpu.parallel.data_parallel import (
    make_dp_train_step,
    put_sharded,
    stack_shards,
)
from equivariant_nn_zoo_tpu.run.loss import Loss as JLoss
from equivariant_nn_zoo_tpu.utils import build as jbuild
from equivariant_nn_zoo_tpu_torch import parallel
from equivariant_nn_zoo_tpu_torch.data import Batch, Data, GraphBatch
from equivariant_nn_zoo_tpu_torch.data import computeEdgeIndex
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.run import Trainer
from equivariant_nn_zoo_tpu_torch.utils import build, load_jax_params
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
NARROW = dict(n_dim=4, l_max=1, edge_spherical="1x0e+1x1o",
              node_attrs="4x0e", edge_radial="4x0e", num_types=10,
              num_layers=1, r_max=4.0)
ATTRS = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
         "atom_types": ("node", "1x0e"), "total_energy": ("graph", "1x0e")}
N_CAP, E_CAP, G = 64, 256, 4

RUNNER = r'''
import os, pickle, sys

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from equivariant_nn_zoo_tpu_torch import parallel, train
from equivariant_nn_zoo_tpu_torch.models import (
    build_model, get_config, register_config,
)
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.run import Trainer
from equivariant_nn_zoo_tpu_torch.utils import (
    build, load_jax_params, params_to_jax,
)

NARROW = {narrow!r}
scenario, rank, world, port, tmp = sys.argv[1:6]
rank, world, port = int(rank), int(world), int(port)
# the test process hosts the rendezvous store (parallel.host_store)
_init = parallel.init_distributed
parallel.init_distributed = (
    lambda *args, **kwargs: _init(*args, **kwargs, is_master=False))


def number(text):
    x = float(text)
    return int(x) if x >= 1 else x


def tiny(spec=None):
    cfg = get_config("config_energy")
    mc = tlc.featureModel(**NARROW)
    cfg["model_config"] = tlc.addEnergyOutput(mc, shifts=[0.0] * 10)
    cfg.update(batch_size=8, max_epochs=int(os.environ["MAX_EPOCHS"]))
    for key in [k for k in cfg if k.startswith("early_stopping")]:
        del cfg[key]
    if os.environ.get("LOWER_BOUND"):
        cfg["early_stopping_lower_bounds"] = {{
            "validation_loss": float(os.environ["LOWER_BOUND"])}}
    cfg["data_config"] = dict(
        cfg["data_config"], path=os.environ["SHARDS"].split(","),
        n_train=number(os.environ["N_TRAIN"]),
        n_val=number(os.environ["N_VAL"]),
        train_val_split="random" if os.environ.get("SHUFFLE") else
        "sequential", shuffle=bool(os.environ.get("SHUFFLE")), num_workers=0,
        key_map={{"Z": ("species", "atom_types"), "R": "pos",
                  "U0": "total_energy"}})
    return cfg


def digest(model):
    return float(sum(float(p.detach().abs().sum())
                     for p in model.parameters()))


def cli():
    register_config("config_tiny_mp", tiny)
    trainer = train.run([
        "--config", "config_tiny_mp", "--device", "cpu",
        "--world_size", str(world), "--process_id", str(rank),
        "--master_port", str(port),
        "--workdir", os.path.join(tmp, f"wd{{rank}}"), "--name", "mp",
        "--seed", "0", "--log_period", "1000",
        *(["--resume_from", os.environ["RESUME"]]
          if os.environ.get("RESUME") else [])])
    history = [(h["epoch"], h["validation_loss"]) for h in HISTORY]
    return dict(digest=digest(trainer.model), iepoch=trainer.iepoch,
                stop=trainer.stop_arg, history=history,
                n_batches=len(trainer.dl_train),
                params=params_to_jax(trainer.model),
                train_idcs=np.asarray(trainer.train_idcs))


HISTORY = []
_end = Trainer.end_of_epoch_log


def _record(self):
    _end(self)
    HISTORY.append(dict(self.mae_dict))


Trainer.end_of_epoch_log = _record


def steps():
    """Steps of a DDP Trainer on this rank's shards (``inputs.pkl``)."""
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    parallel.init_distributed(world, rank, "127.0.0.1", port, "cpu")
    model = tlc.addEnergyOutput(tlc.featureModel(**NARROW),
                                shifts=[0.0] * 10,
                                output_key=inputs["energy_key"])
    if inputs["forces"]:
        model = tlc.addForceOutput(model)
    model = load_jax_params(build(model), inputs["params"])
    trainer = Trainer(model, inputs["loss_coeffs"],
                      learning_rate=1e-2, optimizer_name="Adam",
                      grad_acc=inputs["grad_acc"])
    losses = []
    for shards in inputs["steps"]:
        trainer.batch_step(shards[rank])
        losses.append(parallel.all_reduce_mean(
            {{"loss": trainer.batch_losses["loss"]}})["loss"].item())
    parallel.shutdown()
    return dict(losses=losses, params=params_to_jax(model))


def sde_nan():
    """Two SDE steps of config_diffusion; rank 1's second batch is NaN."""
    from equivariant_nn_zoo_tpu_torch.run import sde_utils

    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    parallel.init_distributed(world, rank, "127.0.0.1", port, "cpu")
    cfg = get_config("config_diffusion", "")
    model = build_model(cfg["model_config"], "cpu",
                        torch.Generator().manual_seed(0))
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-2)
    sde = sde_utils.VPSDE(cfg["diffusion_keys"], N=10)
    step = sde_utils.get_step_fn(sde, True, model=model, optimizer=optimizer,
                                 reduce_mean=True, grad_clid_norm=1.0)
    state = sde_utils.init_sde_state(model, sde_utils.Noise("cpu", rank))
    out = {{}}
    for i, gb in enumerate(inputs["batches"][rank]):
        state, loss, _ = step(state, gb)
        out[f"loss{{i}}"] = float(loss)
        out[f"params{{i}}"] = params_to_jax(model)
        out[f"adam_steps{{i}}"] = sorted(
            int(s["step"]) for s in optimizer.state.values())
    parallel.shutdown()
    return out


def sde_resume():
    """The diffusion loop of two ranks through the CLI, its noise draws
    recorded: without RESUME for steps 0 and 1, then the t that each
    rank's stream draws next; with RESUME (rank 0's meta checkpoint) for
    step 2, its first t."""
    from equivariant_nn_zoo_tpu_torch.run import sde_utils

    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    draws = []

    class Recording(sde_utils.Noise):
        def uniform(self, shape):
            out = super().uniform(shape)
            draws.append(out.clone())
            return out

    sde_utils.Noise = Recording

    def config(spec=None):
        cfg = get_config("config_diffusion", "")
        cfg["batch_size"] = 4
        cfg["data_config"] = dict(
            cfg["data_config"], path=None, data=inputs["data"],
            attrs=inputs["attrs"], preprocess=[], n_train=8, n_val=4)
        return cfg

    register_config("config_tiny_sde", config)
    resume = os.environ.get("RESUME")
    sde_file = os.path.join(tmp, f"sde{{rank}}.py")
    with open(sde_file, "w") as f:
        f.write("from equivariant_nn_zoo_tpu_torch.models.sde_config "
                "import get_config as g\n"
                "def get_config():\n"
                "    c = g()\n"
                f"    c['training']['n_iters'] = {{2 if resume else 1}}\n"
                "    c['training']['snapshot_sampling'] = False\n"
                "    c['model']['num_scales'] = 10\n"
                "    return c\n")
    state = train.run([
        "--config", "config_tiny_sde", "--device", "cpu",
        "--world_size", str(world), "--process_id", str(rank),
        "--master_port", str(port), "--sde_config", sde_file,
        "--workdir", os.path.join(tmp, f"wd{{rank}}"), "--name", "sde",
        "--seed", "0", "--log_period", "1", "--eval_period", "100",
        "--save_period", "100", *(["--resume_from", resume] if resume
                                  else [])])
    if resume:
        return dict(step=state["step"], first=draws[0].numpy())
    return dict(step=state["step"], drawn=[d.numpy() for d in draws],
                next=state["noise"].uniform(draws[0].shape).numpy())


def ddp_against_flat(case):
    """The narrow energy model's gradients from this rank's first
    ``grad_acc`` micro-batches, through DDP (``no_sync`` on all but the
    last) and through the flat reduce, from one seed."""
    import contextlib

    from equivariant_nn_zoo_tpu_torch.run import Loss

    loss = Loss(case["loss"])
    out = {{}}
    for grad_acc in (1, 2):
        micro = case["batches"][rank][:grad_acc]
        for how in ("ddp", "flat"):
            model = build_model(case["model_config"], "cpu",
                                torch.Generator().manual_seed(0))

            class Step(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.model = model

                def forward(self, gb):
                    return loss(self.model(gb).data, gb.data)[0]

            if how == "ddp":
                ddp = torch.nn.parallel.DistributedDataParallel(
                    Step(), broadcast_buffers=False)
                for i, gb in enumerate(micro):
                    with (ddp.no_sync() if i + 1 < grad_acc
                          else contextlib.nullcontext()):
                        ddp(gb).backward()
            else:
                grads = parallel.GradReducer(model.parameters())
                for gb in micro:
                    Step()(gb).backward()
                grads.reduce()
            out[(grad_acc, how)] = {{
                n: p.grad.numpy().copy() for n, p in model.named_parameters()}}
    return out


def configs():
    """One step of each config of ``inputs.pkl`` on this rank's batch (the
    ``Trainer``, or ``get_step_fn`` with this rank's noise), the gradients
    the optimizer steps on recorded; then ``ddp_against_flat``."""
    from equivariant_nn_zoo_tpu_torch.run import sde_utils

    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    parallel.init_distributed(world, rank, "127.0.0.1", port, "cpu")
    out = {{}}
    for name, case in inputs["cases"].items():
        model = build_model(case["model_config"], "cpu",
                            torch.Generator().manual_seed(0))
        gb = case["batches"][rank]
        grads = {{}}

        def record(opt, args, kwargs):
            grads.update({{n: p.grad.numpy().copy()
                          for n, p in model.named_parameters()}})

        if "loss" in case:
            trainer = Trainer(model, case["loss"], learning_rate=1e-2,
                              optimizer_name="Adam")
            trainer.optimizer.register_step_pre_hook(record)
            trainer.batch_step(gb)
            loss = trainer.batch_losses["loss"]
        else:
            sde = sde_utils.VPSDE(case["diffusion_keys"], N=50)
            optimizer = sde_utils.adam(model, 1e-2)
            optimizer.register_step_pre_hook(record)
            step = sde_utils.get_step_fn(
                sde, True, model=model, optimizer=optimizer,
                reduce_mean=True, grad_clid_norm=1.0)
            state = sde_utils.init_sde_state(model,
                                             sde_utils.Noise("cpu", rank))
            state, loss, _ = step(state, gb)
        out[name] = dict(loss=float(loss), grads=grads, params={{
            n: p.detach().numpy().copy()
            for n, p in model.named_parameters()}})
    out["ddp"] = ddp_against_flat(inputs["ddp"])
    parallel.shutdown()
    return out


result = dict(cli=cli, steps=steps, sde_nan=sde_nan,
              sde_resume=sde_resume, configs=configs)[scenario]()
with open(os.path.join(tmp, f"out{{rank}}.pkl"), "wb") as f:
    pickle.dump(result, f)
print("RANK_DONE", rank, flush=True)
'''


def run_ranks(tmp_path, scenario, env=None, world=2):
    """Run ``scenario`` of the runner in ``world`` rank subprocesses; fail
    on a non-zero exit or the timeout; return each rank's result."""
    runner = tmp_path / "runner.py"
    runner.write_text(RUNNER.format(repo=REPO, narrow=NARROW))
    store = parallel.host_store()  # the ranks' rendezvous, until they end
    port = store.port
    full_env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, str(runner), scenario, str(r), str(world),
         str(port), str(tmp_path)], env=full_env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    results = []
    for r in range(world):
        with open(tmp_path / f"out{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def write_shard(path, seed, n_mols=32, scale=1.0):
    """``tests/test_multiprocess.py``'s shard: 4-9 atoms of H/C/N/O,
    N(0, 1) energies (times ``scale``)."""
    rng = np.random.default_rng(seed)
    Rs, Zs, Us, n_nodes = [], [], [], []
    for _ in range(n_mols):
        n = int(rng.integers(4, 10))
        Rs.append(rng.normal(size=(n, 3)) * 1.1)
        Zs.append(rng.choice([1, 6, 7, 8], size=(n, 1)))
        Us.append([float(rng.normal()) * scale])
        n_nodes.append([n])
    with h5py.File(path, "w") as f:
        f["R"] = np.concatenate(Rs).astype(np.float32)
        f["Z"] = np.concatenate(Zs).astype(np.int64)
        f["U0"] = np.asarray(Us, np.float32)
        f["_n_nodes"] = np.asarray(n_nodes, np.int64)
        f.attrs["R"] = ("node", "1x1o")
        f.attrs["Z"] = ("node", "1x0e")
        f.attrs["U0"] = ("graph", "1x0e")
        f.attrs["_n_nodes"] = ("graph", "1x0e")


def shards_env(tmp_path, sizes=(32, 32), scales=(1.0, 1.0), n_train=24,
               n_val=8, max_epochs=2):
    paths = []
    for rank, (n, scale) in enumerate(zip(sizes, scales)):
        paths.append(str(tmp_path / f"shard_{rank}.hdf5"))
        write_shard(paths[-1], seed=rank, n_mols=n, scale=scale)
    return dict(SHARDS=",".join(paths), N_TRAIN=str(n_train),
                N_VAL=str(n_val), MAX_EPOCHS=str(max_epochs))


def test_two_rank_cli_matches_the_multiprocess_contract(tmp_path):
    """``tests/test_multiprocess.py`` through the port's CLI: both ranks
    end, with equal parameters, and only rank 0 writes checkpoints."""
    res = run_ranks(tmp_path, "cli", shards_env(tmp_path))
    assert res[0]["digest"] == res[1]["digest"]
    # the ranks trained on different shards: the mean gradient moved both
    assert res[0]["iepoch"] == res[1]["iepoch"] == 2
    rank0 = os.listdir(tmp_path / "wd0" / "default_project" / "mp")
    rank1 = os.listdir(tmp_path / "wd1" / "default_project" / "mp")
    assert {"best.pt", "trainer.pt", "stdout.txt", "log.txt"} <= set(rank0)
    assert not {"best.pt", "trainer.pt", "stdout.txt", "log.txt"} & \
        set(rank1)


def test_unequal_shards_finish(tmp_path):
    """Shards of 32 and 24 molecules at n_train 0.66 give 2 and 1
    training batches of 8: without the agreed count rank 0 would wait for
    rank 1 in its second step's all-reduce until the timeout."""
    env = shards_env(tmp_path, sizes=(32, 24), n_train=0.66, n_val=0.34)
    res = run_ranks(tmp_path, "cli", env)
    assert [r["n_batches"] for r in res] == [2, 1]
    assert res[0]["digest"] == res[1]["digest"]
    assert res[0]["iepoch"] == res[1]["iepoch"] == 2


def test_ranks_with_different_validation_stop_together(tmp_path):
    """Rank 1's energies are 30 times rank 0's, so its own validation loss
    is ~900 times larger (~6e2 against ~9e5).  Both ranks see the mean of
    the two in every epoch, so early stopping and the scheduler read the
    same numbers: with a lower bound of 1e4 on the validation loss, rank
    0 alone would stop after its first epoch and leave rank 1 waiting;
    together both run to ``max_epochs``."""
    env = dict(shards_env(tmp_path, scales=(1.0, 30.0), max_epochs=3),
               LOWER_BOUND="1e4")
    res = run_ranks(tmp_path, "cli", env)
    assert res[0]["history"] == res[1]["history"]
    assert len(res[0]["history"]) == 3
    assert res[0]["iepoch"] == res[1]["iepoch"] == 3
    assert res[0]["stop"] == res[1]["stop"] == "max epochs"
    assert res[0]["digest"] == res[1]["digest"]


ENERGY_LOSS = {"total_energy": [1.0, "MSELoss"]}
# config_energy_force's loss on its energy and its forces, which the model
# takes by autograd.grad inside the forward
FORCE_LOSS = {"energy": [1e3, "MSELoss"], "forces": [3e4, "MSELoss"]}
FORCE_ATTRS = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
               "atom_types": ("node", "1x0e"), "energy": ("graph", "1x0e"),
               "forces": ("node", "1x1o")}


def test_resumed_ranks_continue_their_own_streams(tmp_path):
    """Two ranks, each on its own shard (32 and 40 molecules) with a random
    split and shuffled batches: one epoch, then a resume from rank 0's
    ``trainer.pt`` for a second, ends bit for bit where two epochs in one
    run end, on both ranks.  Each rank takes back its own split and loader stream from the
    file; rank 0's on rank 1 would give rank 1 other batches."""
    runs = {}
    for name in ("full", "half"):
        (tmp_path / name).mkdir()
    env = dict(shards_env(tmp_path, sizes=(32, 40), n_train=0.75,
                          n_val=0.25), SHUFFLE="1")
    runs["full"] = run_ranks(tmp_path / "full", "cli", env)
    run_ranks(tmp_path / "half", "cli", dict(env, MAX_EPOCHS="1"))
    resume = tmp_path / "half" / "wd0" / "default_project" / "mp"
    runs["resumed"] = run_ranks(tmp_path / "half", "cli", dict(
        env, RESUME=str(resume / "trainer.pt")))
    # the ranks' shards differ in size, so do their splits
    assert len(runs["full"][0]["train_idcs"]) == 24
    assert len(runs["full"][1]["train_idcs"]) == 30
    for rank in range(2):
        full, resumed = runs["full"][rank], runs["resumed"][rank]
        assert resumed["iepoch"] == full["iepoch"] == 2
        np.testing.assert_array_equal(resumed["train_idcs"],
                                      full["train_idcs"])
        assert resumed["history"][-1] == full["history"][-1]
        got, want = _flat(resumed["params"]), _flat(full["params"])
        for k in want:
            assert np.array_equal(got[k], want[k]), (rank, k)


def test_resumed_sde_ranks_continue_their_own_draws(tmp_path):
    """The diffusion loop at two ranks (``config_diffusion`` ``""``), each
    rank's noise from its own seed: after a resume from rank 0's
    checkpoint each rank's first t is the one its own stream would have
    drawn next, not rank 0's."""
    from test_torch_sde import ATTRS as SDE_ATTRS
    from test_torch_sde import molecules

    host = Batch.from_data_list([Data(dict(SDE_ATTRS), **m)
                                 for m in molecules(seed=3, n_mol=12)])
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(dict(data=host.data, attrs=host.attrs), f)
    first = run_ranks(tmp_path, "sde_resume")
    meta = tmp_path / "wd0" / "default_project" / "sde" / \
        "checkpoints-meta" / "checkpoint.pth"
    again = run_ranks(tmp_path, "sde_resume", dict(RESUME=str(meta)))
    assert not np.array_equal(first[0]["next"], first[1]["next"])
    for rank in range(2):
        assert first[rank]["step"] == 2 and again[rank]["step"] == 3
        np.testing.assert_array_equal(again[rank]["first"],
                                      first[rank]["next"])


def _molecules(seed, n_mol=3, forces=False):
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(4, 8))
        d = {"pos": rng.normal(size=(n, 3)) * 1.2,
             "species": rng.choice([1, 6, 7, 8], size=(n, 1))}
        if forces:
            d.update(energy=rng.normal(size=(1, 1)),
                     forces=rng.normal(size=(n, 3)))
        else:
            d["total_energy"] = rng.normal(size=(1, 1))
        d["atom_types"] = d["species"]
        attrs = FORCE_ATTRS if forces else ATTRS
        out, _ = computeEdgeIndex(d, dict(attrs), r_max=4.0)
        d.update(out)
        mols.append(d)
    return mols


def _both_batches(mols, attrs):
    """The port's and the JAX package's padded batch of ``mols``."""
    host = Batch.from_data_list([Data(dict(attrs), **m) for m in mols])
    jhost = JBatch.from_data_list([JData(dict(attrs), **m) for m in mols])
    return (GraphBatch.from_batch(host, N_CAP, E_CAP, G, "cpu"),
            JGraphBatch.from_batch(jhost, N_CAP, E_CAP, G))


def _dp_reference(forces):
    """Three steps of JAX's ``make_dp_train_step`` on a 2-device mesh
    (optax Adam 1e-2), each step two shards; the port's batches of the
    same molecules; JAX's initial parameters; the inputs of the runner's
    ``steps``."""
    energy_key = "energy" if forces else "total_energy"
    config = jlc.addEnergyOutput(jlc.featureModel(**NARROW),
                                 shifts=[0.0] * 10, output_key=energy_key)
    jmodel = jbuild(jlc.addForceOutput(config) if forces else config)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    steps, jsteps = [], []
    for step in range(3):
        pairs = [_both_batches(_molecules(10 * step + r, forces=forces),
                               FORCE_ATTRS if forces else ATTRS)
                 for r in range(2)]
        steps.append([p[0] for p in pairs])
        jsteps.append([p[1] for p in pairs])
    mesh = make_mesh(2)
    optimizer = optax.adam(1e-2)
    loss_coeffs = FORCE_LOSS if forces else ENERGY_LOSS
    dp_step = make_dp_train_step(jmodel, JLoss(loss_coeffs), optimizer,
                                 mesh)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt = optimizer.init(p)
    losses = []
    for shards in jsteps:
        p, opt, _, loss, _ = dp_step(p, opt, None,
                                     put_sharded(stack_shards(shards), mesh))
        losses.append(float(loss))
    return dict(params=params, steps=steps, losses=losses,
                final=jax.device_get(p),
                inputs=dict(params=params, forces=forces,
                            energy_key=energy_key, loss_coeffs=loss_coeffs))


@pytest.fixture(scope="module")
def dp_reference():
    return _dp_reference(forces=False)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _ddp_steps_match(ref, tmp_path):
    """Two gloo ranks from JAX's initial parameters against JAX's
    ``make_dp_train_step`` on two virtual devices, three steps: the mean
    loss over the ranks at rtol 1e-5, every parameter at 1e-4, and the
    two ranks' parameters equal bit for bit."""
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(dict(ref["inputs"], grad_acc=1, steps=ref["steps"]), f)
    res = run_ranks(tmp_path, "steps")
    np.testing.assert_allclose(res[0]["losses"], ref["losses"], rtol=1e-5)
    assert res[0]["losses"] == res[1]["losses"]
    want = _flat(ref["final"])
    for rank in range(2):
        got = _flat(res[rank]["params"])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    for k in want:
        assert np.array_equal(_flat(res[0]["params"])[k],
                              _flat(res[1]["params"])[k]), k


def test_ddp_steps_match_jax_dp_train_step(dp_reference, tmp_path):
    """The energy model (``config_energy``'s head)."""
    _ddp_steps_match(dp_reference, tmp_path)


def test_ddp_force_steps_match_jax_dp_train_step(tmp_path):
    """``config_energy_force``'s head (its forces by ``autograd.grad``
    inside the forward, which DDP's backward then differentiates again)
    and loss, without ``find_unused_parameters``."""
    _ddp_steps_match(_dp_reference(forces=True), tmp_path)


def test_grad_acc_under_ddp_is_the_mean_gradient(dp_reference, tmp_path):
    """``grad_acc`` 2 on two ranks (micro-batches a, b on rank 0 and c, d
    on rank 1) takes one Adam step on the mean of the four gradients: one
    process's ``grad_acc`` 4 over a, b, c, d, at 1e-5."""
    (a, c), (b, d) = dp_reference["steps"][:2]
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(dict(dp_reference["inputs"], grad_acc=2,
                         steps=[[a, c], [b, d]]), f)
    res = run_ranks(tmp_path, "steps")
    model = load_jax_params(build(tlc.addEnergyOutput(
        tlc.featureModel(**NARROW), shifts=[0.0] * 10)),
        dp_reference["params"])
    one = Trainer(model, {"total_energy": [1.0, "MSELoss"]},
                  learning_rate=1e-2, optimizer_name="Adam", grad_acc=4)
    for gb in (a, b, c, d):
        one.batch_step(gb)
    from equivariant_nn_zoo_tpu_torch.utils import params_to_jax

    want = _flat(params_to_jax(model))
    start = _flat(dp_reference["params"])
    for rank in range(2):
        got = _flat(res[rank]["params"])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # the step was taken: Adam moved every parameter by about the rate
    moved = max(float(np.abs(want[k] - start[k]).max()) for k in want)
    assert 5e-3 < moved < 2e-2


def test_sde_nan_skip_agrees_across_ranks(tmp_path):
    """Step 1 on finite batches moves both ranks alike; at step 2 rank 1's
    batch is NaN and rank 0's finite: the skip reads the all-reduced
    gradients, so both ranks skip (parameters and Adam's step count stay),
    although rank 0's own gradient was finite."""
    from test_torch_sde import molecules, port_batch

    batches = []
    for rank in range(2):
        first = port_batch(molecules(seed=rank))
        second = port_batch(molecules(seed=10 + rank))
        if rank == 1:
            second = second.replace(pos=torch.full_like(second["pos"],
                                                        float("nan")))
        batches.append([first, second])
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(dict(batches=batches), f)
    res = run_ranks(tmp_path, "sde_nan")
    assert np.isfinite(res[0]["loss1"]) and not np.isfinite(res[1]["loss1"])
    for rank in range(2):
        assert res[rank]["adam_steps0"] == res[rank]["adam_steps1"]
        assert set(res[rank]["adam_steps1"]) == {1}
        for k, v in _flat(res[rank]["params0"]).items():
            assert np.array_equal(_flat(res[rank]["params1"])[k], v), k
    first0, first1 = _flat(res[0]["params0"]), _flat(res[1]["params0"])
    for k in first0:
        assert np.array_equal(first0[k], first1[k]), k


def test_sharded_loader_parts_match_jax_mesh_shards(tmp_path):
    """Two ranks' loaders with ``num_shards`` 2 (one seed, shuffled, with
    capacities that fit every part) yield, part for part, the sub-batches
    that the JAX loader stacks for a 2-device mesh, over two epochs."""
    from functools import partial

    from equivariant_nn_zoo_tpu.data.compute_edge import (
        computeEdgeIndex as jcomputeEdgeIndex,
    )
    from equivariant_nn_zoo_tpu.data.dataloader import (
        DataLoader as JDataLoader,
    )
    from equivariant_nn_zoo_tpu.data.dataset import (
        CondensedDataset as JCondensedDataset,
    )
    from equivariant_nn_zoo_tpu_torch.data import (
        CondensedDataset,
        DataLoader,
    )

    path = str(tmp_path / "a.hdf5")
    write_shard(path, seed=4, n_mols=26)
    kw = dict(batch_size=8, shuffle=True, seed=5, node_capacity=48,
              edge_capacity=512, prefetch=0, drop_last=True)
    key_map = {"Z": ("species", "atom_types"), "R": "pos",
               "U0": "total_energy"}
    ranks = [DataLoader(CondensedDataset(
        path=path, key_map=key_map,
        preprocess=[partial(computeEdgeIndex, r_max=3.0)]),
        num_shards=2, shard_index=r, **kw) for r in range(2)]
    jax_dl = JDataLoader(JCondensedDataset(
        path=path, key_map=key_map,
        preprocess=[partial(jcomputeEdgeIndex, r_max=3.0)]),
        num_shards=2, **kw)
    for _ in range(2):
        want = list(jax_dl)
        parts = [list(dl) for dl in ranks]
        assert len(want) == len(parts[0]) == len(parts[1]) == 3
        for b, stacked in enumerate(want):
            for r in range(2):
                got = parts[r][b]
                assert got.n_graphs == 4 and got.dropped == 0
                for key, value in stacked.data.items():
                    np.testing.assert_array_equal(
                        got[key].numpy(), np.asarray(value)[r], err_msg=key)


# ------------------------------------------- the configs at two ranks


def _config_cases(tmp_path):
    """Each config's model config and the two ranks' batches (and its loss
    for the ``Trainer``, or its diffusion keys for ``get_step_fn``), at
    the widths of the config's own tests."""
    from test_torch_dipole import LOSS as DIPOLE_LOSS
    from test_torch_dipole import NARROW as DIPOLE
    from test_torch_dipole import dipole_config
    from test_torch_dipole import molecules as dipole_molecules
    from test_torch_dipole import port_batch as dipole_batch
    from test_torch_hamiltonian import LOSS as HAMILTONIAN_LOSS
    from test_torch_hamiltonian import (
        _labelled,
        _molecules,
        _port_batch,
        _port_config,
    )
    from test_torch_protein import E_CAP as PROTEIN_E_CAP
    from test_torch_protein import narrow_config, write_proteins
    from test_torch_sde import molecules as sde_molecules
    from test_torch_sde import port_batch as sde_batch

    from equivariant_nn_zoo_tpu_torch.models import get_config
    from equivariant_nn_zoo_tpu_torch.nn import PointwiseLinear
    from equivariant_nn_zoo_tpu_torch.data import getDataIters

    ca = narrow_config("config_diffusion_CA")
    ca["data_config"].update(
        path=[write_proteins(tmp_path / "pdb_0.hdf5")], n_train=0.7,
        n_val=0.3, edge_capacity=PROTEIN_E_CAP)
    ca["batch_size"] = 2
    loader = getDataIters(ca, seed=0)[0]
    rng = np.random.default_rng(12)
    proteins = []
    for _ in range(2):
        gb = ca["data_config"]["scaler"](next(loader))
        n = gb.node_capacity
        proteins.append(gb.replace(_edge_rand=torch.tensor(
            rng.uniform(size=(n, n)).astype(np.float32))))
    nll = get_config("config_diffusion", "nll")
    return {
        "config_dipole": dict(
            model_config=dipole_config(tlc, PointwiseLinear, **DIPOLE),
            loss=DIPOLE_LOSS,
            batches=[dipole_batch(dipole_molecules(seed=r)) for r in (0, 1)]),
        "config_hamiltonian": dict(
            model_config=_port_config(), loss=HAMILTONIAN_LOSS,
            batches=[_port_batch(_labelled(_molecules(seed=r), seed=r))
                     for r in (0, 1)]),
        'config_diffusion "nll"': dict(
            model_config=nll["model_config"],
            diffusion_keys=dict(nll["diffusion_keys"]),
            batches=[sde_batch(sde_molecules(seed=r)) for r in (0, 1)]),
        "config_diffusion_CA": dict(
            model_config=ca["model_config"],
            diffusion_keys=dict(ca["diffusion_keys"]), batches=proteins),
    }


def _one_process(case):
    """One process's step on both ranks' batches: ``grad_acc`` 2, the
    micro-batches in rank order, each SDE micro-step with its rank's
    noise.  Returns the micro-steps' losses and the gradients the
    optimizer steps on."""
    from equivariant_nn_zoo_tpu_torch.models import build_model
    from equivariant_nn_zoo_tpu_torch.run import sde_utils

    model = build_model(case["model_config"], "cpu",
                        torch.Generator().manual_seed(0))
    grads = {}

    def record(opt, args, kwargs):
        grads.update({n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()})

    losses = []
    if "loss" in case:
        trainer = Trainer(model, case["loss"], learning_rate=1e-2,
                          optimizer_name="Adam", grad_acc=2)
        trainer.optimizer.register_step_pre_hook(record)
        for gb in case["batches"]:
            trainer.batch_step(gb)
            losses.append(float(trainer.batch_losses["loss"]))
    else:
        sde = sde_utils.VPSDE(case["diffusion_keys"], N=50)
        optimizer = sde_utils.adam(model, 1e-2)
        optimizer.register_step_pre_hook(record)
        step = sde_utils.get_step_fn(
            sde, True, model=model, optimizer=optimizer, reduce_mean=True,
            grad_clid_norm=1.0, grad_acc=2)
        state = sde_utils.init_sde_state(model)
        for rank, gb in enumerate(case["batches"]):
            state["noise"] = sde_utils.Noise("cpu", rank)
            state, loss, _ = step(state, gb)
            losses.append(float(loss))
    return losses, grads


@pytest.fixture(scope="module")
def two_rank_configs(tmp_path_factory, dp_reference):
    """The ``configs`` scenario's results (one spawn), each config's
    one-process reference, and the energy model's inputs for DDP."""
    tmp_path = tmp_path_factory.mktemp("configs")
    cases = _config_cases(tmp_path)
    (a, c), (b, d) = dp_reference["steps"][:2]
    energy = dict(model_config=tlc.addEnergyOutput(
        tlc.featureModel(**NARROW), shifts=[0.0] * 10), loss=ENERGY_LOSS,
        batches=[[a, b], [c, d]])
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(dict(cases=cases, ddp=energy), f)
    ranks = run_ranks(tmp_path, "configs")
    return dict(ranks=ranks, want={name: _one_process(case)
                                   for name, case in cases.items()})


CONFIG_NAMES = ["config_dipole", "config_hamiltonian",
                'config_diffusion "nll"', "config_diffusion_CA"]


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_configs_step_at_two_ranks(two_rank_configs, name):
    """Each rank's loss is the one-process step's on that rank's batch;
    every rank steps on the gradient of the one-process step on both
    batches, and the ranks' parameters end equal."""
    ranks = two_rank_configs["ranks"]
    losses, want = two_rank_configs["want"][name]
    np.testing.assert_allclose([r[name]["loss"] for r in ranks], losses,
                               rtol=1e-6)
    scale = max(float(np.abs(v).max()) for v in want.values())
    assert scale > 0
    for rank in range(2):
        got = ranks[rank][name]["grads"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=k)
    params = [r[name]["params"] for r in ranks]
    for k in params[0]:
        assert np.array_equal(params[0][k], params[1][k]), k


@pytest.mark.parametrize("grad_acc", [1, 2])
def test_flat_reduce_gives_ddp_gradients(two_rank_configs, grad_acc):
    """The flat buffers' all-reduce and division give, on both ranks, the
    gradients that DDP gives, bit for bit, with ``no_sync`` on the
    micro-batches that apply nothing."""
    for rank in range(2):
        got = two_rank_configs["ranks"][rank]["ddp"]
        ddp, flat = got[(grad_acc, "ddp")], got[(grad_acc, "flat")]
        assert ddp.keys() == flat.keys()
        for k in ddp:
            np.testing.assert_array_equal(flat[k], ddp[k], err_msg=k)
