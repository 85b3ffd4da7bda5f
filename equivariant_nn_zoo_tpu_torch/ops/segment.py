"""Segment (scatter) sums over the first axis with a fixed segment count.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/ops/segment.py``.  Batches
are padded with one trailing dummy segment, so callers pass a static
``num_segments`` and drop the last row where it is padding.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.reshape(-1), data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, eps: float = 1e-9) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(data.shape[:1], dtype=data.dtype, device=data.device)
    count = segment_sum(ones, segment_ids, num_segments)
    return total / torch.clamp(count, min=eps).reshape(
        (-1,) + (1,) * (data.dim() - 1))
