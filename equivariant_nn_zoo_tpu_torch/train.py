"""The training command line of the port.

    python -m equivariant_nn_zoo_tpu_torch.train --config config_energy \\
        --workdir results --name run0
    python -m equivariant_nn_zoo_tpu_torch.train --config config_energy \\
        --dp 2                                    # two local ranks
    python -m equivariant_nn_zoo_tpu_torch.train --config config_energy \\
        --world_size 2 --process_id 0 --master_addr host0 --master_port 29500

PyTorch counterpart of the repository's ``train.py``, with its flags on
``argparse`` (the JAX CLI's ``--platform`` is ``--device`` here: ``cuda``
unless the caller asks for ``cpu``; without a card a CUDA run raises).  A
config with ``diffusion_keys`` goes to ``train_diffusion`` (the VP-SDE
loop over ``run/sde_utils.py``), any other to ``train_regression`` (the
``Trainer``).  Files go to ``<workdir>/<project>/<name>``, the log also to
its ``stdout.txt`` (rank 0).

Data parallelism is the reference's own: one process per rank and the
gradients' mean over the ranks (``parallel/``), where the JAX CLI builds a
device mesh.

- ``--dp N`` (N > 1) starts N local ranks with
  ``torch.multiprocessing.spawn``; as the JAX CLI's in-process mesh splits
  one global batch of ``batch_size`` over N devices, each rank loads its
  ``batch_size / N`` graphs of every global batch
  (``Trainer(shard_split=True)``; the diffusion loop gives each rank
  ``batch_size / N`` graphs a step from its share of the dataset files).
  ``--dp 0`` uses one rank per card
  when the batch divides evenly and one rank otherwise; ``--dp 1`` one
  rank.  Ranks past the number of cards share a card over gloo.
- ``--world_size W --process_id r`` joins rank r of W processes (on one
  host or several) at ``--master_addr:--master_port``; each rank loads
  ``batch_size`` graphs a step from its share of the dataset files
  (``shard_paths``).

Only rank 0 writes checkpoints, ``stdout.txt`` and the per-batch lines.
``--wandb`` logs to wandb from rank 0 (``TrainerWandB``); ``wandb`` is
imported only then, and its absence is an error.
"""

from __future__ import annotations

import argparse
import importlib.util
import logging
import os
import sys
from pathlib import Path
from time import perf_counter

import numpy as np
import torch

from . import parallel
from .models import CONFIG_REGISTRY, build_model, get_config, register_config
from .utils import countParameters


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX CLI's flags (``train.py:18-50``), ``--platform`` as
    ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m equivariant_nn_zoo_tpu_torch.train",
        description="Train a named config of the model zoo.")
    add = p.add_argument
    add("--sde_config", default=None,
        help="Python file with get_config() for SDE training; defaults to "
             "models/sde_config.py.")
    add("--workdir", default="results", help="Work directory.")
    add("--config", required=True, help="The name of the config.")
    add("--config_spec", default="", help="Config specification.")
    add("--name", default="default", help="Name of the experiment.")
    add("--seed", type=int, default=0, help="The RNG seed.")
    add("--dataloader_num_workers", type=int, default=4,
        help="Host-side prefetch depth (advisory, as in the JAX CLI).")
    add("--resume_from", default=None,
        help="Trainer/model checkpoint to resume from.")
    add("--profiling", action=argparse.BooleanOptionalAction, default=False,
        help="Profile the training batches.")
    add("--equivariance_test", action=argparse.BooleanOptionalAction,
        default=False, help="Train on rotated copies and test them.")
    add("--wandb", action=argparse.BooleanOptionalAction, default=False,
        help="Log to wandb (rank 0).")
    add("--project", default="default_project",
        help="The name of the project.")
    add("--verbose", default="INFO", help="Logging verbosity.")
    add("--log_period", type=int, default=100,
        help="Batches between log lines.")
    add("--eval_period", type=int, default=20,
        help="Steps between evaluations (diffusion).")
    add("--save_period", type=int, default=2000,
        help="Epochs (regression) or steps (diffusion) between "
             "checkpoints.")
    add("--device", default="cuda", choices=("cuda", "cpu"),
        help="cuda (default) or cpu.")
    add("--dp", type=int, default=0,
        help="Local data-parallel ranks: 0 = one per card when the batch "
             "divides evenly, 1 = one rank.")
    add("--world_size", type=int, default=1,
        help="Number of processes (multi-host).")
    add("--master_addr", default="127.0.0.1", help="Rendezvous address.")
    add("--master_port", type=int, default=10000, help="Rendezvous port.")
    add("--process_id", type=int, default=0,
        help="This process's rank (multi-host).")
    return p.parse_args(argv)


def setSeed(seed):
    np.random.seed(seed)


def _dp_ranks(batch_size: int, dp: int, device_count: int) -> int:
    """The number of local ranks for ``--dp`` (``_make_dp_mesh``'s guards):
    an explicit ``dp`` that does not divide the batch raises; auto mode
    (``dp`` 0) takes one rank per card and falls back to one rank, with a
    warning, when the batch does not divide evenly."""
    n = dp if dp > 0 else device_count
    if n <= 1:
        return 1
    if batch_size % n != 0:
        if dp > 0:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"--dp={n}")
        logging.warning("auto-DP disabled: batch_size %d %% %d devices != 0",
                        batch_size, n)
        return 1
    logging.info("data parallel over %d local ranks", n)
    return n


def _device(args) -> torch.device:
    """This rank's device: the process group's, else ``--device``; a CUDA
    run without a card raises."""
    if parallel.device() is not None:
        return parallel.device()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "false; pass --device cpu to run on the CPU")
    return torch.device(args.device)


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def build_regression_trainer(config: dict, args):
    """The ``Trainer`` of ``train_regression``, its dataset set and (rank
    0) its first ``trainer.pt`` written, before any step."""
    from .data.dataloader import shard_paths
    from .data.dataset import CondensedDataset
    from .run.trainer import Trainer, TrainerWandB
    from .utils import pruneArgs

    rank, world = parallel.rank(), parallel.world_size()
    cls = TrainerWandB if args.wandb and rank == 0 else Trainer
    trainer_kwargs = dict(config)
    trainer_kwargs.pop("model_config", None)
    trainer_kwargs.update(
        workdir=args.workdir, seed=args.seed,
        equivariance_test=args.equivariance_test, profiling=args.profiling,
        log_period=args.log_period, save_period=args.save_period,
        shard_split=getattr(args, "shard_split", False))
    model = build_model(config["model_config"], _device(args),
                        _generator(args.seed))
    if not args.resume_from:
        setSeed(args.seed)
        trainer = cls(model=model, **trainer_kwargs)
    else:
        trainer = cls.from_file(args.resume_from, model=model,
                                **trainer_kwargs)
    logging.info("Successfully built the network...")
    data_config = dict(config["data_config"])
    if not getattr(args, "shard_split", False):
        # one share of the dataset files a process (the JAX CLI's
        # per-process sharding); --dp ranks split each global batch instead
        data_config["path"] = shard_paths(data_config.get("path"), rank,
                                          world)
    dataset = CondensedDataset(**pruneArgs(CondensedDataset, **data_config))
    if args.equivariance_test:
        # the dataset becomes batch_size * 2 rotated copies of one sample
        batch_size = config["batch_size"]
        dataset.equivarianceTest(batch_size * 2)
        trainer.data_config = dict(trainer.data_config, n_train=batch_size,
                                   n_val=batch_size,
                                   train_val_split="sequential")
    trainer.set_dataset(dataset, validation_dataset=None)
    trainer.save()  # every rank: it gathers their streams; rank 0 writes
    return trainer


def train_regression(config: dict, args):
    """Build the trainer (``build_regression_trainer``) and train it."""
    trainer = build_regression_trainer(config, args)
    trainer.train()
    return trainer


def _sde_config(args) -> dict:
    if args.sde_config:
        spec = importlib.util.spec_from_file_location("sde_cfg",
                                                      args.sde_config)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.get_config()
    from .models.sde_config import get_config as sde_get_config

    return sde_get_config()


def train_diffusion(config: dict, args):
    """The VP-SDE training loop (the JAX CLI's ``train_diffusion``): steps
    ``state["step"]`` to ``n_iters`` through ``get_step_fn`` (the gradients averaged
    over the ranks under a process group), an evaluation step with the EMA model every
    ``eval_period`` steps, and every ``save_period`` steps and at the end
    the evaluation losses' mean (over the steps and the ranks) into
    ``ReduceLROnPlateau``, whose rate is logged and, as in the JAX loop,
    not given to the optimizer, and on rank 0 the checkpoints
    (``checkpoints/<step>.pth`` and ``checkpoints-meta/checkpoint.pth``,
    ``sde_state_dict``'s tree, with every rank's noise state) and with
    ``snapshot_sampling`` a sample of the EMA model and its ground truth
    through ``config["saveMol"]``.  Returns the state, its ``log`` the
    training losses' means of each ``log_period`` window and the
    evaluation means with the plateau rate (``lr``), each with the
    seconds since the first step."""
    from .data.dataloader import getDataIters
    from .parallel import all_reduce_mean
    from .run import sde_sampling as sampling
    from .run import sde_utils
    from .run.lr_scheduler import ReduceLROnPlateau
    from .run.trainer import OPTIMIZERS, _prefixed
    from .utils.saveload import (
        finish_all_writes,
        restore_checkpoint,
        save_checkpoint,
    )

    sde_config = _sde_config(args)
    workdir = args.workdir
    save_mol = config["saveMol"]
    rank, world = parallel.rank(), parallel.world_size()
    dev = _device(args)

    checkpoint_dir = os.path.join(workdir, "checkpoints")
    checkpoint_meta = os.path.join(workdir, "checkpoints-meta",
                                   "checkpoint.pth")
    if rank == 0:
        Path(checkpoint_dir).mkdir(parents=True, exist_ok=True)
        Path(os.path.dirname(checkpoint_meta)).mkdir(parents=True,
                                                     exist_ok=True)

    model = build_model(config["model_config"], dev, _generator(args.seed))
    logging.info(f"Number of parameters {countParameters(model)}.")
    opt_kwargs = _prefixed("optimizer", config)
    opt_kwargs.pop("name", None)
    optimizer = OPTIMIZERS[config["optimizer_name"]](
        list(model.parameters()), config["learning_rate"], **opt_kwargs)
    state = sde_utils.init_sde_state(
        model, sde_utils.Noise(dev, args.seed + 1 + rank))
    if args.resume_from is not None:
        tree = restore_checkpoint(args.resume_from, None)
        if tree is not None:
            sde_utils.load_sde_state_dict(tree, state, model, optimizer)
            logging.info(f"Resumed from checkpoint {args.resume_from}.")
    initial_step = int(state["step"])

    sde = sde_utils.VPSDE(
        diffusion_keys=dict(config["diffusion_keys"]),
        beta_min=sde_config["model"]["beta_min"],
        beta_max=sde_config["model"]["beta_max"],
        N=sde_config["model"]["num_scales"])
    training = sde_config["training"]
    train_step_fn = sde_utils.get_step_fn(
        sde, True, model=model, optimizer=optimizer,
        reduce_mean=training["reduce_mean"],
        continuous=training["continuous"],
        grad_clid_norm=config.get("grad_clid_norm"),
        grad_acc=config.get("grad_acc", 1),
        ema_decay=sde_config["model"]["ema_rate"])
    eval_step_fn = sde_utils.get_step_fn(
        sde, False, model=model, reduce_mean=training["reduce_mean"],
        continuous=training["continuous"])

    scaler = config["data_config"].get("scaler", lambda x: x)
    inverse_scaler = config["data_config"].get("inverse_scaler",
                                               lambda x: x)
    train_iter, eval_iter = getDataIters(
        config, seed=args.seed, process_index=rank, process_count=world)
    sampling_fn = sampling.get_sampling_fn(sde_config, sde, inverse_scaler,
                                           1e-3)
    lr_sched = ReduceLROnPlateau(
        config["learning_rate"],
        factor=config.get("lr_scheduler_factor", 0.8),
        patience=config.get("lr_scheduler_patience", 1))
    num_train_steps = training["n_iters"]
    wandb = None
    if args.wandb and rank == 0:
        import wandb

    def window_means(lst):
        """One host read for a window of device-scalar dicts, averaged
        over the steps and the ranks."""
        means = {k: torch.stack([item[k] for item in lst]).mean()
                 for k in lst[0]}
        return {k: float(v) for k, v in all_reduce_mean(means).items()}

    logging.info("Starting training loop at step %d." % (initial_step,))
    loss_lst, eval_loss_lst, state["log"] = [], [], []
    t0 = perf_counter()
    for step in range(initial_step, num_train_steps + 1):
        gb = scaler(next(train_iter).to(dev))
        state, loss, losses = train_step_fn(state, gb)
        loss_lst.append(losses)

        if step % args.log_period == 0 and step > 0:
            loss_dict = window_means(loss_lst)
            state["log"].append(dict(step=step, seconds=perf_counter() - t0,
                                     **loss_dict))
            logging.info("step: %d, training_loss: %.5e"
                         % (step, loss_dict["total"]))
            if wandb is not None:
                wandb.log(dict(loss_dict, optim_step=step))
            loss_lst = []

        if step % args.eval_period == 0:
            egb = scaler(next(eval_iter).to(dev))
            state, _, eval_losses = eval_step_fn(state, egb)
            eval_loss_lst.append(eval_losses)

        if not (step != 0 and step % args.save_period == 0
                or step == num_train_steps):
            continue
        if eval_loss_lst:
            loss_dict = {f"{k}_val": v
                         for k, v in window_means(eval_loss_lst).items()}
            state["log"].append(dict(step=step, seconds=perf_counter() - t0,
                                     **loss_dict))
            eval_loss_mean = loss_dict["total_val"]
            logging.info("step: %d, eval_loss: %.5e" % (step, eval_loss_mean))
            state["log"][-1]["lr"] = lr_sched.step(eval_loss_mean)
            eval_loss_lst = []
            if wandb is not None:
                wandb.log(dict(loss_dict, lr=lr_sched.lr, optim_step=step))
        tree = sde_utils.sde_state_dict(state, model, optimizer)
        if rank != 0:
            continue
        save_checkpoint(os.path.join(checkpoint_dir, f"{step}.pth"), tree)
        save_checkpoint(checkpoint_meta, tree)
        if training["snapshot_sampling"]:
            sample_dir = os.path.join(workdir, "samples", f"iter_{step}")
            Path(sample_dir).mkdir(parents=True, exist_ok=True)
            gt_name = save_mol(inverse_scaler(gb.to_batch()),
                               workdir=workdir, filename="ground_truth")
            samples, _ = sampling_fn(state["ema"]["model"], gb,
                                     sde_utils.Noise(dev, args.seed + step))
            fname = save_mol(samples, idx=0, workdir=workdir,
                             filename=f"{step}")
            if wandb is not None:
                wandb.log({"sample": wandb.Molecule(fname),
                           "ground_truth": wandb.Molecule(gt_name),
                           "optim_step": step})
    finish_all_writes()
    return state


def _jsonable(tree):
    if isinstance(tree, dict):
        return {str(k): _jsonable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jsonable(v) for v in tree]
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    return repr(tree)


def _train(args, config):
    """One rank's run: the log file, wandb, then the config's training
    loop."""
    args.workdir = os.path.join(args.workdir, args.project, args.name)
    os.makedirs(args.workdir, exist_ok=True)
    handler = None
    if parallel.rank() == 0:
        handler = logging.FileHandler(os.path.join(args.workdir,
                                                   "stdout.txt"))
        logging.getLogger().addHandler(handler)
    try:
        if args.wandb and parallel.rank() == 0:
            import wandb

            wandb.init(project=args.project, name=args.name,
                       config=_jsonable(config))
        setSeed(args.seed)
        if "diffusion_keys" in config:
            return train_diffusion(config, args)
        return train_regression(config, args)
    finally:
        if handler is not None:
            logging.getLogger().removeHandler(handler)
            handler.close()


def _logging(args):
    logging.basicConfig(
        level=getattr(logging, args.verbose.upper(), logging.INFO),
        format="%(levelname)s - %(filename)s - %(asctime)s - %(message)s")


def _spawned_rank(rank, argv, n, port, name, fn):
    """A ``--dp`` rank started by ``torch.multiprocessing.spawn``: the
    config function comes along, so that a config registered at run time
    exists here too."""
    register_config(name, fn)
    args = parse_args(argv)
    _logging(args)
    parallel.init_distributed(n, rank, "127.0.0.1", port, args.device,
                              is_master=False)
    try:
        config = get_config(args.config, args.config_spec or None)
        args.shard_split = "diffusion_keys" not in config
        if not args.shard_split:
            config = dict(config, batch_size=config["batch_size"] // n)
        _train(args, config)
    finally:
        parallel.shutdown()


def run(argv=None):
    """Parse ``argv`` and train: in this process (one rank, or one rank
    of ``--world_size``), or in ``--dp`` spawned local ranks.  Returns the
    trainer (regression) or the state (diffusion) of this process's rank,
    None when it spawned the ranks."""
    args = parse_args(argv)
    _logging(args)
    config = get_config(args.config, args.config_spec or None)
    if args.world_size > 1:
        if args.dp > 1:
            raise ValueError("--dp and --world_size > 1 do not combine")
        parallel.init_distributed(args.world_size, args.process_id,
                                  args.master_addr, args.master_port,
                                  args.device)
        try:
            return _train(args, config)
        finally:
            parallel.shutdown()
    if args.device == "cuda" and not torch.cuda.is_available():
        _device(args)  # raises
    n = _dp_ranks(int(config["batch_size"]), args.dp,
                  torch.cuda.device_count() if args.device == "cuda" else 1)
    if n == 1:
        return _train(args, config)
    store = parallel.host_store()  # the ranks' rendezvous, until they end
    torch.multiprocessing.spawn(
        _spawned_rank, nprocs=n, join=True,
        args=(list(sys.argv[1:] if argv is None else argv), n, store.port,
              args.config, CONFIG_REGISTRY[args.config]))
    return None


def main(argv=None):
    run(argv)


if __name__ == "__main__":
    main()
