"""Float32 arithmetic with a fixed rounding order.

Where the JAX package's XLA-CPU programs contract a multiply and an add
into one fused multiply-add, the port rounds the same way, so that its
results are bit-equal on the CPU and on CUDA alike.
"""

from __future__ import annotations

import torch


def _f64(x):
    return x.double() if isinstance(x, torch.Tensor) else float(x)


def fma_f32(a, b, c) -> torch.Tensor:
    """f32 a * b + c with one rounding (at least one operand a tensor;
    Python floats must hold f32 values): the product of two f32 values is
    exact in float64, so only the sum rounds before the cast (a second
    rounding there needs the sum within 2^-53 of an f32 midpoint)."""
    return (_f64(a) * _f64(b) + _f64(c)).float()
