"""Float32 arithmetic with a fixed rounding order.

Where the JAX package's XLA-CPU programs contract a multiply and an add
into one fused multiply-add, the port rounds the same way, so that its
results are bit-equal on the CPU and on CUDA alike.
"""

from __future__ import annotations

import torch

# A float64 sum sits exactly on the midpoint of two normal f32 values when
# its low 29 mantissa bits are 1 << 28: the one case in which the cast to
# f32 can round a second time.
_LOW29 = (1 << 29) - 1
_HALF = 1 << 28


# Up to this many elements fma_f32 corrects densely and never waits for the
# device; above it, it gathers the hits, which costs one host sync per call
# and saves eight float64 passes over the whole tensor.
_DENSE_MAX = 1 << 22


def _f64(x):
    return x.double() if isinstance(x, torch.Tensor) else float(x)


def _at(x, shape, where) -> torch.Tensor:
    """The float64 operand x, broadcast to `shape`, at the index tuple
    `where`."""
    return torch.as_tensor(x, dtype=torch.float64,
                           device=where[0].device).expand(shape)[where]


def _toward_exact(s, p, c) -> torch.Tensor:
    """s = float64(p + c), moved one float64 ulp toward the exact p + c
    where the two differ (TwoSum's error term gives the side)."""
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    return torch.nextafter(s, torch.addcmul(s, torch.sign(err), s.abs()))


def fma_f32(a, b, c) -> torch.Tensor:
    """f32 a * b + c with one rounding (at least one operand a tensor;
    Python floats must hold f32 values; results in f32's normal range).

    The product of two f32 values is exact in float64, so only the sum
    rounds.  Where that sum sits on an f32 midpoint and was not exact, it
    is stepped one float64 ulp toward the exact value before the cast, so
    the cast is the only rounding that decides the result.  The midpoint
    test is a mask and a compare of each sum's low 32 bits (little-endian)
    and hits a few elements in 2^29.  A result of at most _DENSE_MAX
    elements is corrected under that mask in place of a search, so the
    call queues its work and returns; a larger one gathers its hits
    (``nonzero``: one host sync in a call of milliseconds) and runs TwoSum
    on those alone.  Both give the same bits.
    """
    p = _f64(a) * _f64(b)
    c = _f64(c)
    s = p + c
    flat = s.reshape(-1)
    hit = (flat.view(torch.int32)[::2] & _LOW29) == _HALF
    if flat.numel() <= _DENSE_MAX:
        flat = torch.where(hit, _toward_exact(s, p, c).reshape(-1), flat)
    else:
        hits = hit.nonzero().squeeze(1)
        if hits.numel():
            shape = s.shape if s.dim() else (1,)
            where = torch.unravel_index(hits, shape)
            flat[hits] = _toward_exact(flat[hits], _at(p, shape, where),
                                       _at(c, shape, where))
    return flat.float().reshape(s.shape)
