"""The compute dtype option of the port's layers: ``"float32"`` or
``"bfloat16"``, as the JAX package spells its ``compute_dtype``
(``E3_COMPUTE_DTYPE``)."""

from __future__ import annotations

import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(name) -> torch.dtype:
    """The torch dtype of a ``compute_dtype`` option."""
    if str(name) not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[str(name)]
