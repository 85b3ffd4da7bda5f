"""Data parallelism over a process group: the port's counterpart of the JAX
package's ``parallel/data_parallel.py``.

The JAX package shards one batch over a device mesh with ``shard_map`` and
takes the mean over the ``dp`` axis of each shard's mean loss
(``make_dp_loss_fn``); differentiating through it averages the gradients,
a ``psum`` that ``jax.jit`` records inside the step.  The port runs one
process per rank, each on its own batch, and keeps each parameter's
gradient as a view of one flat buffer per dtype (``GradReducer``), made
once and summed into in place by ``backward``; after the backward of a
step that applies, one ``all_reduce`` of each buffer and a division by the
world size give every rank the mean over the ranks of each rank's mean
loss gradient.  Under NCCL that collective is recorded into the step's
CUDA graph (``run.capture``); under gloo the steps stay eager.  A
parameter that gets no gradient keeps its zeros and averages zeros, as
JAX's ``psum`` does, so no config needs DDP's ``find_unused_parameters``.
Rank 0's parameters are broadcast when the reducer is made, as DDP does
when it wraps a module.  Device scalars that the ranks must agree on go
through ``all_reduce_mean``, host metrics through ``mean_over_ranks``,
batch counts through ``agree_min`` and wall times through ``agree_max``.

``stack_shards`` and ``put_sharded`` have no counterpart: with one process
per rank each rank's loader makes its own batch, so there is no leading
device axis to stack or place (as the loader has no tile layout, which
exists for the TPU kernels).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch
import torch.distributed as dist

from . import mesh


class GradReducer:
    """The gradients of ``params`` as views of one flat buffer per dtype
    (set as each parameter's ``.grad``, zeroed and summed into in place by
    the steps), and ``reduce``, their mean over the ranks.  Whether a
    process group exists is read once, here: under one, rank 0's
    parameters are broadcast to every rank now and ``reduce`` all-reduces;
    without one it does nothing."""

    def __init__(self, params: Iterable[torch.nn.Parameter]):
        self.params = list(params)
        self.grouped = dist.is_available() and dist.is_initialized()
        groups: Dict[torch.dtype, List[torch.nn.Parameter]] = {}
        for p in self.params:
            groups.setdefault(p.dtype, []).append(p)
        self.flats = []
        with torch.no_grad():
            for ps in groups.values():
                flat = torch.cat([p.reshape(-1) for p in ps])
                if self.grouped:
                    # DDP's broadcast of rank 0's parameters at build time
                    dist.broadcast(flat, 0)
                    for p, part in zip(ps, _parts(flat, ps)):
                        p.copy_(part)
                flat.zero_()
                for p, part in zip(ps, _parts(flat, ps)):
                    p.grad = part
                self.flats.append(flat)
        self._views = [p.grad for p in self.params]

    def grads(self) -> List[torch.Tensor]:
        """The parameters' ``.grad`` as they stand."""
        return [p.grad for p in self.params]

    def attached(self) -> bool:
        """Whether every parameter's ``.grad`` is still this reducer's
        view (a caller may have set one to None or to another tensor)."""
        return all(p.grad is v for p, v in zip(self.params, self._views))

    def zero_(self) -> None:
        for flat in self.flats:
            flat.zero_()

    def finite(self) -> torch.Tensor:
        """A device bool: every gradient is finite (after ``reduce``, the
        same on every rank)."""
        return torch.stack([torch.isfinite(f).all()
                            for f in self.flats]).all()

    def reduce(self) -> None:
        """The mean over the ranks of every gradient, in place: one
        ``all_reduce`` (sum) of each flat buffer, then the division by the
        world size, with no host read (under NCCL it is captured with the
        step).  Nothing without a process group."""
        if not self.grouped:
            return
        world = dist.get_world_size()
        for flat in self.flats:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            flat.div_(world)


def _parts(flat: torch.Tensor, params) -> List[torch.Tensor]:
    """``flat``'s consecutive pieces, each shaped as one of ``params``."""
    return [part.view_as(p) for part, p in zip(
        flat.split([p.numel() for p in params]), params)]


def _comm_device(like: torch.device) -> torch.device:
    """Where a collective's operand lives: the card under NCCL, the host
    under gloo."""
    return like if mesh.backend() == "nccl" else torch.device("cpu")


def all_reduce_mean(values: Dict[str, object]) -> Dict[str, object]:
    """The mean over the ranks of each scalar in ``values`` (tensors or
    numbers, summed in float64 by one all-reduce for the whole dict): a
    tensor comes back as a tensor of its dtype on its device, a number as
    a float (a host read: inside a captured step pass tensors only).
    Unchanged without a process group."""
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
