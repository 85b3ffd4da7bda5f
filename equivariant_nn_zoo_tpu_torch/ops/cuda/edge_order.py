"""Node-major edge orders for the conv kernels K1 and K2, in plain PyTorch.

K1 (``csrc/full_conv.cu``) walks the edges by destination and K2
(``csrc/full_conv_bwd.cu``) by source, so that each node's sums stay in
registers and are stored once (``csrc/edge_walk.cuh``).  ``build`` makes
both orders on the edges' device with no host synchronisation (a stable
sort and a binary search): ``perm`` lists the edge ids sorted by the key
endpoint, ``ptr[n]: ptr[n + 1]`` are node ``n``'s positions in it, and
edges with an endpoint outside ``[0, N)`` are sorted past ``ptr[N]``, where
no walk reads them (a segment sum drops such ids; K1 drops those edges).
The edges need not come sorted.

``shared`` builds the orders once per set of edges: the five trunk layers
of a model forward pass the same ``edge_index`` rows and get one order,
which ``FullConvFunction`` saves for the backward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class EdgeOrder(NamedTuple):
    dst_perm: torch.Tensor  # int32 [E]: edge ids, destination-major
    dst_ptr: torch.Tensor   # int32 [N + 1]: runs in dst_perm
    src_perm: torch.Tensor  # int32 [E]: edge ids, source-major
    src_ptr: torch.Tensor   # int32 [N + 1]: runs in src_perm


#: orders built, over the process (the tests count them)
builds = 0
_last: Optional[tuple] = None


def build(edge_src: torch.Tensor, edge_dst: torch.Tensor,
          num_nodes: int) -> EdgeOrder:
    """Both orders of the edges ``edge_src -> edge_dst`` over ``num_nodes``
    nodes."""
    global builds
    builds += 1
    n = int(num_nodes)
    valid = (edge_src >= 0) & (edge_src < n) & (edge_dst >= 0) & \
        (edge_dst < n)
    nodes = torch.arange(n + 1, device=edge_src.device)

    def by(key):
        key = torch.where(valid, key, n)
        sorted_key, perm = torch.sort(key, stable=True)
        ptr = torch.searchsorted(sorted_key, nodes)
        return perm.to(torch.int32), ptr.to(torch.int32)

    return EdgeOrder(*by(edge_dst), *by(edge_src))


def _signature(t: torch.Tensor):
    return (t.device, t.data_ptr(), tuple(t.shape), t.stride(), t._version)


def shared(edge_src: torch.Tensor, edge_dst: torch.Tensor,
           num_nodes: int) -> EdgeOrder:
    """``build``, reused while the same edge tensors come back unchanged.
    The last edge tensors are held, so their memory cannot pass to another
    tensor while the entry stands; an in-place write bumps their version.
    Inference tensors carry no version and are never reused."""
    global _last
    if edge_src.is_inference() or edge_dst.is_inference():
        return build(edge_src, edge_dst, num_nodes)
    key = (_signature(edge_src), _signature(edge_dst), int(num_nodes))
    if _last is None or _last[0] != key:
        _last = (key, (edge_src, edge_dst),
                 build(edge_src, edge_dst, num_nodes))
    return _last[2]
