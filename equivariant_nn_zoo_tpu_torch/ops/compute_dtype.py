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


class _Product(torch.autograd.Function):
    """``einsum(eq, a, b)`` of two bfloat16 tensors, summed in float32 (a
    product of two bfloat16 values is exact in float32): JAX's
    ``dot_general(a, b, preferred_element_type=float32)``.  Its backward
    is JAX's transposes, each cotangent rounded to its operand's dtype;
    they read the operands anew (``b.float()``), so that a second
    differentiation sends every use of a bfloat16 tensor its own bfloat16
    cotangent and autograd adds them in bfloat16, as JAX adds the
    cotangents of a bfloat16 value.  (One float32 copy read by the
    forward and the backward would sum them in float32 and round once.)
    Every index of an operand appears in the other operand or the
    output."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return torch.einsum(eq, a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        ea, eb = ins.split(",")
        ga = gb = None
        if ctx.needs_input_grad[1]:
            ga = torch.einsum(f"{out},{eb}->{ea}", g, b.float()).to(a.dtype)
        if ctx.needs_input_grad[2]:
            gb = torch.einsum(f"{ea},{out}->{eb}", a.float(), g).to(b.dtype)
        return None, ga, gb


def bf16_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` with a and b rounded to bfloat16, summed in
    float32 (float32 result), differentiable to any order with JAX's
    roundings (``_Product``)."""
    return _Product.apply(eq, a.to(torch.bfloat16), b.to(torch.bfloat16))
