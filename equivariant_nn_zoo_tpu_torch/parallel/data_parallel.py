"""Data parallelism over a process group: the port's counterpart of the JAX
package's ``parallel/data_parallel.py``.

The JAX package shards one batch over a device mesh with ``shard_map`` and
takes the mean over the ``dp`` axis of each shard's mean loss
(``make_dp_loss_fn``); differentiating through it averages the gradients.
The port runs one process per rank, each on its own batch, and wraps the
module that computes the loss in ``DistributedDataParallel``, whose
all-reduce averages the gradients over the ranks during ``backward``: the
same mean over ranks of each rank's mean loss.  Device scalars that the
ranks must agree on go through ``all_reduce_mean``, host metrics through
``mean_over_ranks``, batch counts through ``agree_min`` and wall times
through ``agree_max``.

``stack_shards`` and ``put_sharded`` have no counterpart: with one process
per rank each rank's loader makes its own batch, so there is no leading
device axis to stack or place (as the loader has no tile layout, which
exists for the TPU kernels).

A training step calls its loss through ``LossStep(model, fn)``, and
under a process group through that module in DDP (``step_module``), so
that there is one forward and backward path with or without ranks.  The
wrapped module must return the loss as a tensor (with its parts beside
it): with ``find_unused_parameters`` DDP walks the autograd graph from the
tensors of the output to find the parameters that got no gradient, and it
cannot see inside a ``GraphBatch``.  DDP raises at the next step when a
parameter got no gradient and it was not told to look.

One training step of each of the seven configs without DDP
(``tools/torch_unused_params.py``, every parameter at full width) leaves
one parameter without a gradient: ``func.output_linear.linear.b0`` of
``config_diffusion`` ``"nll"``, the bias of the energy whose position
gradient is the score.  That config sets ``find_unused_parameters``, which
the diffusion loop passes to ``get_step_fn``; no regression config
needs it, and the ``Trainer`` does not read it.  Under DDP, steps of
``config_energy`` (the CPU tests and the card's two-rank CLI run),
``config_energy_force`` (its forces through ``autograd.grad`` inside the
forward) and ``config_diffusion`` ``""`` (the CPU tests) have run without
it; the other configs have not yet run under DDP.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from . import mesh


class LossStep(torch.nn.Module):
    """``fn(model, *args)`` as one module, the unit that a step calls and
    DDP wraps: ``model`` is its one submodule, so DDP reduces exactly its
    parameters.  ``fn`` returns the loss tensor first."""

    def __init__(self, model: torch.nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def step_module(loss_step: LossStep,
                find_unused_parameters: bool = False) -> torch.nn.Module:
    """What a training step calls: ``loss_step`` in DDP (``wrap_model``)
    under a process group, else ``loss_step`` itself."""
    if not dist.is_initialized():
        return loss_step
    return wrap_model(loss_step,
                      find_unused_parameters=find_unused_parameters)


def no_sync(module: torch.nn.Module, sync: bool):
    """``module.no_sync()`` when ``module`` is DDP and ``sync`` is false
    (a micro-step that applies nothing), else a context that does
    nothing."""
    if sync or not isinstance(module,
                              torch.nn.parallel.DistributedDataParallel):
        return contextlib.nullcontext()
    return module.no_sync()


def wrap_model(module: torch.nn.Module, device=None,
               find_unused_parameters: bool = False) -> torch.nn.Module:
    """``module`` in ``DistributedDataParallel`` over the default process
    group.  Buffers are constants that every rank builds alike, so they are
    not broadcast on each forward."""
    device = torch.device(device if device is not None
                          else next(module.parameters()).device)
    kwargs = dict(find_unused_parameters=find_unused_parameters,
                  broadcast_buffers=False)
    if device.type == "cuda":
        kwargs["device_ids"] = [device.index if device.index is not None
                                else torch.cuda.current_device()]
    return torch.nn.parallel.DistributedDataParallel(module, **kwargs)


def _comm_device(like: torch.device) -> torch.device:
    """Where a collective's operand lives: the card under NCCL, the host
    under gloo."""
    return like if mesh.backend() == "nccl" else torch.device("cpu")


def all_reduce_mean(values: Dict[str, object]) -> Dict[str, object]:
    """The mean over the ranks of each scalar in ``values`` (tensors or
    numbers, summed in float64 by one all-reduce for the whole dict): a
    tensor comes back as a tensor of its dtype on its device, a number as
    a float.  Unchanged without a process group."""
    if not dist.is_initialized() or not values:
        return values
    keys = sorted(values)
    dev = next((v.device for v in values.values()
                if isinstance(v, torch.Tensor)), torch.device("cpu"))
    flat = torch.stack([torch.as_tensor(values[k], dtype=torch.float64,
                                        device=dev).reshape(())
                        for k in keys]).to(_comm_device(dev))
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat = (flat / dist.get_world_size()).to(dev)
    out = {}
    for i, k in enumerate(keys):
        v = values[k]
        out[k] = (flat[i].to(v.dtype) if isinstance(v, torch.Tensor)
                  else float(flat[i]))
    return out


def mean_over_ranks(values: Dict[str, float]) -> Dict[str, float]:
    """The mean over the ranks of each number in ``values``, over the ranks
    that have the key (per-species metrics name only the species a rank
    saw): one ``all_gather_object``.  Unchanged without a process group."""
    if not dist.is_initialized():
        return values
    gathered = gather_objects({k: float(v) for k, v in values.items()})
    keys = list(values) + sorted({k for g in gathered for k in g} -
                                 set(values))
    return {k: float(np.mean([g[k] for g in gathered if k in g]))
            for k in keys}


def gather_objects(obj) -> List:
    """Every rank's ``obj`` (picklable), in rank order: one
    ``all_gather_object``; ``[obj]`` without a process group."""
    if not dist.is_initialized():
        return [obj]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, obj)
    return gathered


def agree_min(n: int) -> int:
    """The least ``n`` over the ranks: the number of batches every rank
    can take, so that no rank waits in an all-reduce that another rank
    never reaches."""
    if not dist.is_initialized():
        return int(n)
    dev = mesh.device() or torch.device("cpu")
    t = torch.tensor([int(n)], dtype=torch.int64, device=_comm_device(dev))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def agree_max(x: float) -> float:
    """The largest ``x`` over the ranks (a wall time, for instance)."""
    if not dist.is_initialized():
        return float(x)
    dev = mesh.device() or torch.device("cpu")
    t = torch.tensor([float(x)], dtype=torch.float64,
                     device=_comm_device(dev))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())
