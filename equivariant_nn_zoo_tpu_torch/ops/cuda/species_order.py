"""The species order of the self-connection kernels K3 and K3b, in plain
PyTorch.

K3 and K3b (``csrc/species_sc.cu``) walk the nodes species by species, so
that a block stages one species' table once and applies it to a tile of
that species' nodes.  ``build`` makes the order on the species' device with
no host synchronisation (a stable sort and a binary search): ``perm`` lists
the node ids sorted by species, ``ptr[t]: ptr[t + 1]`` are species ``t``'s
positions in it, and nodes whose species lies outside ``[0, types)`` are
sorted past ``ptr[types]``, where the kernels write their rows as zero and
add nothing to the tables' gradient.  The kernels cut each run into tiles
themselves, from ``ptr``.

``shared`` builds the order once per species tensor: the five trunk layers
of a model forward pass the same ``species`` and get one order, which
``SpeciesScalarFCTPFunction`` saves for the backward.  During a CUDA-graph
capture it builds the order inside the graph and stores nothing in the
cache, as ``edge_order.shared`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .edge_order import _signature, capturing


class SpeciesOrder(NamedTuple):
    perm: torch.Tensor  # int32 [N]: node ids, species-major
    ptr: torch.Tensor   # int32 [types + 1]: runs in perm


#: orders built, over the process (the tests count them)
builds = 0
_last: Optional[tuple] = None
_captured: Optional[tuple] = None   # the order of the capture in progress


def build(species: torch.Tensor, types: int) -> SpeciesOrder:
    """The order of the nodes by ``species`` ([N], any integer dtype) over
    ``types`` species."""
    global builds
    builds += 1
    t = int(types)
    spec = species.reshape(-1)
    key = torch.where((spec >= 0) & (spec < t), spec, t)
    sorted_key, perm = torch.sort(key, stable=True)
    ptr = torch.searchsorted(sorted_key,
                             torch.arange(t + 1, device=spec.device))
    return SpeciesOrder(perm.to(torch.int32), ptr.to(torch.int32))


def shared(species: torch.Tensor, types: int) -> SpeciesOrder:
    """``build``, reused while the same species tensor comes back
    unchanged.  The last species tensor is held, so its memory cannot pass
    to another tensor while the entry stands; an in-place write bumps its
    version.  Inference tensors carry no version and are never reused.
    During a capture the cache is neither read nor written."""
    global _last, _captured
    if species.is_inference():
        return build(species, types)
    key = (_signature(species), int(types))
    if capturing():
        if _captured is None or _captured[0] != key:
            _captured = (key, species, build(species, types))
        return _captured[2]
    _captured = None
    if _last is None or _last[0] != key:
        _last = (key, species, build(species, types))
    return _last[2]
