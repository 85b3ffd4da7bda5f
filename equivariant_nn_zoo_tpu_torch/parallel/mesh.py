"""Process-group helpers: the port's counterpart of the JAX package's
``parallel/mesh.py``.

The JAX package places a one-axis ``dp`` mesh over the chips and lets XLA
insert the gradient all-reduce.  The port runs one process per rank, as
the reference's ``mp.spawn`` does, and keeps here what the mesh
answered there: which rank this process is, how many ranks there are, and
which device a rank drives.

``init_distributed`` sets up the default process group.  The ranks first
meet on a ``TCPStore`` at ``master_addr:master_port`` and tell each other
their host names, so that each rank knows how many ranks share its host
and its own index among them (its local rank).  A rank drives
``cuda:(local_rank % device_count)`` unless the caller asks for the CPU.

The backend is a choice of transport, not a fallback: NCCL when every
rank of the host has a card of its own; gloo on the CPU, and when ranks
share a card (NCCL refuses two ranks on one device).  A CUDA run never
drops to the CPU; without a card it raises.
"""

from __future__ import annotations

import logging
import socket
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

_STATE = {"device": None}


def host_store(master_addr: str = "127.0.0.1",
               timeout: float = 600.0) -> dist.TCPStore:
    """A rendezvous store on a port that the system chooses, for ranks that
    this process starts: they join at ``store.port`` with ``is_master``
    false, and the store must live until they end.  It holds its port from
    the moment the port is chosen; a port found free and released again
    may be taken by another process before rank 0 binds it."""
    return dist.TCPStore(master_addr, 0, None, True,
                         timedelta(seconds=timeout), wait_for_workers=False)


def init_distributed(world_size: int, rank: int,
                     master_addr: str = "127.0.0.1",
                     master_port: int = 29500, device="cuda",
                     timeout: float = 600.0,
                     is_master: Optional[bool] = None) -> torch.device:
    """Join rank ``rank`` of a group of ``world_size`` processes and return
    the device this rank drives (``device`` ``"cuda"`` or ``"cpu"``).
    Rank 0 hosts the rendezvous store, unless ``is_master`` is false (the
    store of ``host_store``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: a CUDA device was asked for "
                           "and torch.cuda.is_available() is false")
    wait = timedelta(seconds=timeout)
    if is_master is None:
        is_master = rank == 0
    store = dist.TCPStore(master_addr, int(master_port), world_size,
                          is_master=is_master, timeout=wait)
    store.set(f"host/{rank}", socket.gethostname())
    hosts = [store.get(f"host/{r}").decode() for r in range(world_size)]
    here = [r for r in range(world_size) if hosts[r] == hosts[rank]]
    local_rank, local_world = here.index(rank), len(here)
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
        backend = "nccl" if local_world <= n_cards else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=wait)
    _STATE["device"] = device
    if rank == 0:
        logging.info(
            "process group: %d ranks, backend %s (%d ranks on this host, "
            "device %s)", world_size, backend, local_world, device)
    return device


def shutdown():
    """Leave the process group (a no-op without one), after dropping every
    captured step's graphs (``run.capture.release``): NCCL's destroy waits
    for ever on a communicator that a live graph recorded."""
    if dist.is_initialized():
        from ..run import capture

        capture.release()
        dist.destroy_process_group()
    _STATE["device"] = None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    return world_size() > 1


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def device() -> Optional[torch.device]:
    """The device ``init_distributed`` gave this rank (None without a
    group)."""
    return _STATE["device"]
