"""Float helpers that keep the reference's IEEE rounding in PyTorch."""

from __future__ import annotations

import torch


def true_div(a, b):
    """IEEE ``a / b`` where either side may be a Python scalar.

    PyTorch turns a Python scalar over a tensor (and, on CUDA, a tensor
    over a Python scalar) into a multiplication by a reciprocal, which
    rounds differently from the reference's division; a 0-d tensor on the
    operand's device keeps the true quotient."""
    like = a if torch.is_tensor(a) else b
    if not torch.is_tensor(a):
        a = torch.tensor(a, dtype=like.dtype, device=like.device)
    if not torch.is_tensor(b):
        b = torch.tensor(b, dtype=like.dtype, device=like.device)
    return torch.div(a, b)


def ieee_sqrt(x):
    """Correctly rounded f32 square root (CUDA's ``sqrtf``).  PyTorch's
    CPU kernel may miss by an ulp; the square root of the f64 value,
    rounded once to f32, is exact."""
    return torch.sqrt(x.double()).float()


def floor_mod(x, y: float):
    """jnp.mod for floats and a positive divisor: the C remainder, moved
    into [0, y) when negative (floored, not truncated)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & (r < 0), r + y, r)
