"""The precision a reference runs in.

``"float32"``: every product in float32 with TF32 off (the configurations
state float32). ``"tf32"``: the control, the nearest precision below it:
each matrix product's operands rounded to TF32's 10-bit mantissa (round to
nearest even), products and sums in float32, which is what a TF32 tensor
core computes. The rounding is done here and not by
``torch.backends.cuda.matmul.allow_tf32``, so the control reads the same
on the card and on the CPU, where the tests run it.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (8-bit exponent, 10-bit mantissa)."""
    i = x.contiguous().view(torch.int32)
    r = ((i >> 13) & 1) + 0xFFF
    return ((i + r) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(b).mT, to_tf32(a).mT @ g


def matmul(precision: str):
    """The matrix product of ``precision``: a @ b, differentiable."""
    if precision == "float32":
        return torch.matmul
    if precision == "tf32":
        return _TF32MatMul.apply
    raise ValueError(f"unknown precision {precision!r}")
