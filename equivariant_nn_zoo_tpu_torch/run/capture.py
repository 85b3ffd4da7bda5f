"""The compiled step: CUDA-graph capture, the port's counterpart of
``jax.jit``.

The JAX package jits every entry point: the trainer's four steps, the
serving forward, the SDE steps and the samplers' loops.  The port runs each
of them as a ``Step``, which records the function once per batch signature
into a ``torch.cuda.CUDAGraph`` and then replays it: one host call for the
thousands of kernel launches of a training step.

- **Signature.** A call's tensors' shapes, dtypes and devices, and the
  structure around them (dict keys, ``GraphBatch`` capacities).  The
  loader pads every batch to fixed capacities, so a run has one signature
  per split; a new signature gets a graph of its own, as ``jit`` traces
  anew for a new shape.  All graphs of one ``Step`` share a memory pool.
- **Warm-up.** The first ``WARMUP`` calls of a signature (2) run eagerly on
  a side stream, as real calls: lazily made state (optimizer moments,
  kernel tables, the kernel library itself) exists before the capture.
  The next call captures the function and replays it once, so the
  sequence of updates is the eager run's.
- **Replay.** A call copies its tensors into the graph's static inputs (a
  tensor that already is the static input is not copied), replays, and
  returns the static outputs.  A caller must take what it keeps from them
  before the next replay of any graph of the ``Step``: a later replay
  overwrites them.
- **State.** Parameters, gradients, optimizer and EMA state live outside
  the graphs' pool and are read and written in place by the replays.  A
  load must copy into those tensors (``load_optimizer_state``); where it
  cannot, the owner calls ``drop`` and the next calls capture anew.
- **Draws.** Generators that the function draws from are registered with
  each graph (``generators``), so that each replay draws new numbers and
  advances the generator as the eager call does.  A step that draws from
  a source a replay cannot renew (``renews``) runs eagerly.
- **Launch counts.** A kernel wrapper counts its launches on the host
  (``FullConv.launches``, ...) where it launches: an eager call and a
  capture count, a replay does not (it relaunches the kernels, not their
  wrappers).  The kernels a replay ran are counted on the device
  (``torch.profiler``).
- **No fallback.** A capture that fails raises with the step's name and
  the CUDA error; nothing runs eagerly in its place.  The garbage
  collector is run before a capture and held off during it, so that no
  destructor calls the CUDA runtime inside (an old graph's would), and
  the allocator's cached blocks are handed back first, as
  ``torch.cuda.graph`` does.

``enabled`` decides whether a step runs captured: by default on a CUDA
device, in one process or under an NCCL process group, whose collectives
(the gradients' mean, ``parallel.GradReducer``) a graph records as
``jax.jit`` records JAX's ``psum``.  Under a gloo group the steps run
eagerly: only NCCL collectives can be recorded into a CUDA graph.  NCCL
will not destroy a communicator while a graph that recorded one of its
collectives lives (the destroy waits for ever), so ``release`` drops every
step's graphs and ``parallel.shutdown`` calls it before it ends the group.
"""

from __future__ import annotations

import gc
import weakref
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..data.graph_batch import GraphBatch

#: eager calls of a new signature before its capture
WARMUP = 2
#: every Step made, for ``release``
_STEPS: "weakref.WeakSet[Step]" = weakref.WeakSet()


def enabled(capture: Optional[bool], device, draws=()) -> bool:
    """Whether a step on ``device`` runs captured.  ``None``: on for a CUDA
    device in one process or under an NCCL process group; off on the CPU,
    under a gloo group, and where a replay could not draw afresh from one
    of ``draws`` (the step's sources of random numbers, see ``renews``).
    ``True`` raises where capture cannot run; ``False`` is eager."""
    device = torch.device(device)
    gloo = (dist.is_available() and dist.is_initialized()
            and dist.get_backend() != "nccl")
    if capture is False:
        return False
    if capture and device.type != "cuda":
        raise ValueError(f"capture=True needs a CUDA device, not {device}")
    if capture and gloo:
        raise ValueError("capture=True under a gloo process group: only "
                         "NCCL collectives can be recorded into a CUDA "
                         "graph, so the steps of a gloo run are eager")
    if capture and not renews(*draws):
        raise ValueError("capture=True with a source of draws that a replay "
                         "cannot renew (it has no capturable = True): each "
                         "replay would reuse the draw made at the capture")
    return device.type == "cuda" and not gloo and renews(*draws)


# ------------------------------------------------------------------ trees

def _flatten(tree, leaves: List[torch.Tensor]):
    """The structure of ``tree`` (hashable), its tensors appended to
    ``leaves``.  A ``GraphBatch``'s attributes are not part of it."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return None
    if isinstance(tree, GraphBatch):
        return ("GraphBatch", tree.n_graphs, tree.node_capacity,
                tree.edge_capacity, _flatten(tree.data, leaves))
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _flatten(v, leaves))
                                 for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_flatten(v, leaves)
                                              for v in tree)
    return ("const", tree)


def _unflatten(tree, leaves):
    """``tree`` with its tensors taken in order from the iterator
    ``leaves`` (``tree`` gives the structure and the attributes)."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, GraphBatch):
        return GraphBatch(_unflatten(tree.data, leaves), dict(tree.attrs),
                          tree.n_graphs, tree.node_capacity,
                          tree.edge_capacity, tree.dropped)
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return tree


def _detached(tree):
    leaves: List[torch.Tensor] = []
    _flatten(tree, leaves)
    return _unflatten(tree, iter([t.detach() for t in leaves]))


# -------------------------------------------------------------- the step

class _Graph:
    """One signature's state: eager calls so far, then the graph, its
    static inputs and outputs."""

    __slots__ = ("calls", "graph", "inputs", "outputs")

    def __init__(self):
        self.calls = 0
        self.graph = None
        self.inputs: List[torch.Tensor] = []
        self.outputs = None


class Step:
    """``fn`` compiled: ``step(*args)`` returns what ``fn(*args)`` returns,
    eagerly for the first ``WARMUP`` calls of a signature, then from a CUDA
    graph.  ``generators()`` lists the generators ``fn`` draws from (called
    at each capture, after the warm-up made them).  ``graph`` makes the
    graph objects (``torch.cuda.CUDAGraph``; a test passes a stand-in)."""

    def __init__(self, name: str, fn: Callable, generators: Callable = None,
                 graph: Callable = None):
        self.name = name
        self.fn = fn
        self.generators = generators or (lambda: ())
        self.graph_factory = graph
        self.graphs: Dict[tuple, _Graph] = {}
        self.pool = None
        self.captures = 0
        self._stream = None
        _STEPS.add(self)

    def __call__(self, *args):
        leaves: List[torch.Tensor] = []
        structure = _flatten(args, leaves)
        signature = (structure, tuple((tuple(t.shape), t.dtype, t.device)
                                      for t in leaves))
        entry = self.graphs.setdefault(signature, _Graph())
        if entry.graph is None:
            if entry.calls < WARMUP:
                entry.calls += 1
                return self._side(lambda: self.fn(*args), leaves)
            self._capture(entry, args, leaves)
        else:
            for dst, src in zip(entry.inputs, leaves):
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
        entry.graph.replay()
        return entry.outputs

    def drop(self) -> None:
        """Forget every graph (after a load that could not copy into the
        tensors they read): the next calls warm up and capture anew."""
        self.graphs.clear()
        self.pool = None

    def _cuda(self, leaves) -> bool:
        return self.graph_factory is None or any(t.is_cuda for t in leaves)

    def _side(self, run, leaves):
        """``run()`` on the step's side stream, ordered after and before
        the current stream's work (on the CPU, ``run()``)."""
        if not self._cuda(leaves):
            return run()
        current = torch.cuda.current_stream()
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = run()
        current.wait_stream(self._stream)
        return out

    def _capture(self, entry: _Graph, args, leaves) -> None:
        entry.inputs = [t.detach().clone() for t in leaves]
        static = _unflatten(args, iter(entry.inputs))
        graph = (self.graph_factory or torch.cuda.CUDAGraph)()
        for generator in self.generators():
            graph.register_generator_state(generator)
        # nothing is collected inside the capture: a destructor that calls
        # the CUDA runtime there (an old graph's, a profiler's) voids it.
        # What is collected now, and the allocator's cached blocks, go back
        # to the device, where the graph's pool can take them.
        if self._cuda(leaves):
            torch.cuda.synchronize()
        gc.collect()
        if self._cuda(leaves):
            torch.cuda.empty_cache()

        def record():
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                out = self.fn(*static)
            except Exception as exc:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is void; the first error says why
                raise RuntimeError(f"step {self.name!r}: CUDA-graph capture "
                                   f"failed: {exc}") from exc
            try:
                graph.capture_end()
            except RuntimeError as exc:
                raise RuntimeError(f"step {self.name!r}: CUDA-graph capture "
                                   f"failed: {exc}") from exc
            return out

        collecting = gc.isenabled()
        gc.disable()
        try:
            outputs = self._side(record, leaves)
        finally:
            if collecting:
                gc.enable()
        entry.outputs = _detached(outputs)
        entry.graph = graph
        if self.pool is None:
            self.pool = graph.pool()
        self.captures += 1


def release() -> None:
    """Drop the graphs of every ``Step`` of the process (each captures anew
    at its next calls) once the card has finished their replays.  A
    process group's NCCL communicator is destroyed only after the graphs
    that recorded its collectives: ``parallel.shutdown`` calls this."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for step in list(_STEPS):
        step.drop()
    gc.collect()


# ------------------------------------------------------------ state loads

@torch.no_grad()
def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state_dict: dict) -> bool:
    """Load ``state_dict`` into ``optimizer``, copying every value into the
    tensor that already holds it (the rate too), so that captured steps
    keep reading them.  Where the optimizer's state does not match the
    saved one key for key and shape for shape (no step taken yet), it is
    loaded by ``load_state_dict`` into new tensors and the function returns
    False: the caller drops its graphs.  Of a saved group only the
    settings that the run's group has are read (a file written by a torch
    optimizer also holds ``capturable``, ``foreach``, ...)."""
    groups = optimizer.param_groups
    saved_groups = [{k: v for k, v in s.items() if k in g}
                    for g, s in zip(groups, state_dict["param_groups"])]
    params = [p for g in groups for p in g["params"]]
    ids = [i for g in saved_groups for i in g["params"]]
    saved = state_dict["state"]

    def same(p, i):
        own, new = optimizer.state.get(p, {}), saved.get(i, {})
        return set(own) == set(new) and all(
            not torch.is_tensor(v) or tuple(v.shape) == tuple(
                torch.as_tensor(new[k]).shape) for k, v in own.items())

    rates = [g["lr"] for g in groups]
    if len(params) != len(ids) or not all(map(same, params, ids)):
        optimizer.load_state_dict(dict(state_dict,
                                       param_groups=saved_groups))
        for g, rate in zip(optimizer.param_groups, rates):
            if torch.is_tensor(rate):
                rate.fill_(float(g["lr"]))
                g["lr"] = rate
        return False
    for p, i in zip(params, ids):
        own = optimizer.state.get(p, {})
        for k, v in saved.get(i, {}).items():
            if torch.is_tensor(own[k]):
                own[k].copy_(torch.as_tensor(v))
            else:
                own[k] = v
    for g, s in zip(groups, saved_groups):
        for k, v in s.items():
            if k == "params":
                continue
            if torch.is_tensor(g.get(k)):
                g[k].fill_(float(v))
            else:
                g[k] = v
    return True


def _sources(sources) -> list:
    """``sources`` with each model replaced by the ``EdgeRandom`` that its
    in-model edge layer draws from (if any)."""
    out = []
    for src in sources:
        if isinstance(src, torch.nn.Module):
            for _, layer in getattr(src, "layers", ()):
                rand = getattr(layer, "keywords", {}).get("rand")
                if rand is not None:
                    out.append(rand)
        elif src is not None:
            out.append(src)
    return out


def renews(*sources) -> bool:
    """Whether each replay draws afresh from every one of ``sources`` (a
    noise source, an ``EdgeRandom``, a model's in-model edge layer).  A
    source says so with ``capturable = True``: its draws come from a
    generator on the card that the graph registers (``sde_utils.Noise``,
    ``EdgeRandom``), or from device state that the step itself advances.
    Any other source (one that hands out host arrays, or arrays on the card
    at a host cursor) would be read once, while the graph is captured, and
    every replay would reuse that draw."""
    return all(getattr(src, "capturable", False)
               for src in _sources(sources))


def generators(*sources) -> List[torch.Generator]:
    """The CUDA generators of ``sources``: a noise source's
    ``generator``, an ``EdgeRandom``'s ``generators``, and those of the
    ``EdgeRandom`` that a model's in-model edge layer draws from."""
    out = []
    for src in _sources(sources):
        gen = getattr(src, "generator", None)
        found = [gen] if gen is not None else list(
            getattr(src, "generators", {}).values())
        out += [g for g in found if g.device.type == "cuda"]
    return list({id(g): g for g in out}.values())
