"""JAX's Threefry-2x32 random stream, in torch int64 arithmetic.

Draws what ``jax.random`` draws under JAX's default
``jax_threefry_partitionable=True`` (checked against JAX 0.9.0) with
64-bit mode off, on any torch device:

  * ``prng_key(seed)`` is ``PRNGKey(seed)``: the key words (0, seed mod
    2^32) (JAX keeps only the seed's low 32 bits);
  * ``split(key, num)``: key i is both words of the hash of the counter
    (0, i);
  * ``random_bits``: the 32 bits at flat index i are x0 ^ x1 of the hash of
    the counter (i >> 32, i mod 2^32);
  * ``uniform``, ``normal``, ``randint`` and ``permutation`` follow
    ``jax/_src/random.py``.  ``normal`` is sqrt(2) * erf_inv(u) for u
    uniform in [nextafter(-1, 0), 1), with XLA's f32 erf_inv polynomial
    and the XLA CPU backend's log1p and log written out op by op, with
    the multiply-adds that backend contracts rounded once (a sum takes a
    product into a fused multiply-add when the product has no other use;
    of two such products the first operand's), so the normals and the
    integer draws are bit-equal to JAX's on the CPU.

Every value is a uint32 held in an int64 tensor, so sums and shifts never
overflow; ``& M32`` reduces them mod 2^32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cphnsw_tpu_torch.ops.rounding import fma_f32

M32 = 0xFFFFFFFF
# Threefry-2x32, 20 rounds (Salmon et al., "Parallel random numbers: as
# easy as 1, 2, 3"); the constants are those of JAX's threefry2x32.
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
# Elements hashed per step of the samplers (bounds their int64 temporaries
# at a few hundred MB).
CHUNK = 1 << 22

Key = tuple[int, int]


def _f32(x: float) -> float:
    return float(np.float32(x))


# XLA's f32 erf_inv (Giles' single-precision approximation): w < 5 and
# w >= 5 coefficient rows, highest degree first.
ERFINV_LT5 = tuple(map(_f32, (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941)))
ERFINV_GE5 = tuple(map(_f32, (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682)))
# XLA's log1p below |x| < sqrt(2) - 1: a Cephes rational approximation.
LOG1P_NUM = tuple(map(_f32, (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1)))
LOG1P_DEN = tuple(map(_f32, (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1)))
LOG1P_SMALL = _f32(0.41421356237309504880)
# The XLA CPU backend's f32 log (the Cephes logf polynomial).
LOG_P = tuple(map(_f32, (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)))
LOG_Q1 = _f32(-2.12194440e-4)
LOG_Q2 = _f32(0.693359375)
SQRT_HALF = _f32(0.707106781186547524)
MIN_NORMAL = float(np.finfo(np.float32).tiny)
SQRT2 = _f32(np.sqrt(2.0))
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def prng_key(seed: int) -> Key:
    """The key words of ``jax.random.PRNGKey(seed)``."""
    return (0, int(seed) & M32)


def hash2x32(key: Key, c0: torch.Tensor, c1: torch.Tensor):
    """Threefry-2x32 of the counter words (c0, c1), int64 tensors holding
    uint32 values; returns the two output words the same way."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (c0 + ks[0]) & M32
    x1 = (c1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & M32
    return x0, x1


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(key, num)`` as a list of keys."""
    c = torch.arange(num, dtype=torch.int64)
    x0, x1 = hash2x32(key, torch.zeros_like(c), c)
    return list(zip(x0.tolist(), x1.tolist()))


def random_bits(key: Key, start: int, count: int, device) -> torch.Tensor:
    """The 32-bit draws at flat indices [start, start + count) of any
    sampler shape, as int64."""
    idx = torch.arange(start, start + count, dtype=torch.int64,
                       device=device)
    x0, x1 = hash2x32(key, idx >> 32, idx & M32)
    return x0 ^ x1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """f32 uniforms in [0, 1): the top 23 bits as the mantissa of [1, 2),
    minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
        - 1.0


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = fma_f32(p, x, c)
    return p


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 log for positive x: x = m * 2^e with m in
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial in m - 1, e * ln 2 added
    in two parts."""
    bits = x.clamp_min(MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < SQRT_HALF
    t = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.float()
    t2 = t * t
    t3 = t2 * t
    y = fma_f32(fma_f32(t, LOG_P[0], LOG_P[1]), t, LOG_P[2])
    y1 = fma_f32(fma_f32(t, LOG_P[3], LOG_P[4]), t, LOG_P[5])
    y2 = fma_f32(fma_f32(t, LOG_P[6], LOG_P[7]), t, LOG_P[8])
    # the sum of two products contracts the first one: y * t3 + (Q1 * e)
    y = fma_f32(fma_f32(fma_f32(y, t3, y1), t3, y2), t3, LOG_Q1 * e)
    t = fma_f32(-0.5, t2, t)
    return fma_f32(LOG_Q2, e, t + y)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log1p: the Cephes rational approximation where
    |x| < sqrt(2) - 1, log(1 + x) elsewhere."""
    x2 = x * x
    small = (x * x2) * (_horner(x, LOG1P_NUM) / _horner(x, LOG1P_DEN))
    small = x + fma_f32(-0.5, x2, small)
    return torch.where(x.abs() < LOG1P_SMALL, small, _log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erf_inv for |x| < 1."""
    w = -_log1p(-(x * x))
    lt = w < 5.0
    # a correctly rounded f32 sqrt on every device: torch's CPU f32 sqrt
    # is not one (~0.7% of these draws off by an ulp)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, ERFINV_LT5[0], ERFINV_GE5[0])
    for lo, hi in zip(ERFINV_LT5[1:], ERFINV_GE5[1:]):
        p = fma_f32(p, w, torch.where(lt, lo, hi))
    return p * x


def normal(key: Key, shape, device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on `device`."""
    count = math.prod(shape)
    out = torch.empty(count, dtype=torch.float32, device=device)
    for s in range(0, count, CHUNK):
        u = uniform_from_bits(random_bits(key, s, min(CHUNK, count - s),
                                          device))
        # uniform on [lo, 1): u * (1 - lo) + lo, where 1 - lo rounds to 2
        u = (u * 2.0 + NORMAL_LO).clamp_min(NORMAL_LO)
        out[s:s + u.shape[0]] = erf_inv(u) * SQRT2
    return out.reshape(shape)


def randint(key: Key, count: int, low: int, high: int,
            device) -> torch.Tensor:
    """``jax.random.randint(key, (count,), low, high)`` (int32, 0 <= low
    < high < 2^31) as int64: two 32-bit draws per value reduced mod the
    span with uint32 wrap-around, as JAX does."""
    k_hi, k_lo = split(key, 2)
    span = high - low
    mult = (((1 << 16) % span) ** 2) % span
    out = torch.empty(count, dtype=torch.int64, device=device)
    for s in range(0, count, CHUNK):
        c = min(CHUNK, count - s)
        hi = random_bits(k_hi, s, c, device)
        lo = random_bits(k_lo, s, c, device)
        off = (((hi % span) * mult) + (lo % span)) & M32
        out[s:s + c] = low + off % span
    return out


def permutation(key: Key, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as int64: rounds of stable sorts
    of arange(n) by fresh 32-bit keys (enough rounds that all sort keys
    are distinct with high probability)."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        key, sub = split(key, 2)
        order = torch.sort(random_bits(sub, 0, n, device), stable=True)[1]
        x = x[order]
    return x
