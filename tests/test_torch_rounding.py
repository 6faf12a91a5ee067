"""``ops/rounding.fma_f32`` against exact arithmetic.

A fused multiply-add rounds a * b + c once.  The port computes it through
float64, where a second rounding could slip in when the float64 sum lands
on an f32 midpoint; these tests hold it to the exact result, computed with
``fractions.Fraction`` and rounded once to the nearest f32 (ties to even),
on the witness of that fault, on triples built to sit next to midpoints,
on random triples, and through ``kernels/scan_keys.folded_scores``.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from cphnsw_tpu_torch.kernels import scan_keys
from cphnsw_tpu_torch.ops import rounding
from cphnsw_tpu_torch.ops.rounding import fma_f32

N_SWEEP = 12_000


def round_f32(x: Fraction) -> np.float32:
    """The f32 nearest to x, ties to even (|x| below the f32 maximum)."""
    if x == 0:
        return np.float32(0.0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    n, rem = divmod(x, ulp)
    if rem * 2 > ulp or (rem * 2 == ulp and n % 2 == 1):
        n += 1
    return np.float32(sign * float(n * ulp))


def exact_fma(a, b, c) -> np.ndarray:
    return np.array([round_f32(Fraction(float(x)) * Fraction(float(y))
                               + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)


def near_midpoint_triples(n: int, seed: int):
    """Triples whose exact a * b + c lies within a few float64 ulps of an
    f32 midpoint: c = m * 2^k with a 24-bit m, a * b = (half an ulp of c)
    * (1 + u) * (1 + v) with u, v tiny multiples of 2^-23, so the sum is
    the midpoint plus a remainder the float64 sum rounds away."""
    rng = np.random.default_rng(seed)
    m = rng.integers(1 << 23, 1 << 24, n).astype(np.float64)
    k = rng.integers(-40, 40, n)
    c = np.ldexp(m, k) * rng.choice([-1.0, 1.0], n)
    u = rng.integers(-200, 201, n).astype(np.float64) * 2.0 ** -23
    # v = -u leaves the second-order remainder -u^2; a step of 2^-23 more
    # leaves a first-order one
    v = -u + rng.integers(-1, 2, n) * 2.0 ** -23
    s = rng.integers(-30, 30, n)
    a = np.ldexp(1.0 + u, s)
    b = np.ldexp(1.0 + v, k - 1 - s) * rng.choice([-1.0, 1.0], n)
    out = [x.astype(np.float32) for x in (a, b, c)]
    for x64, x32 in zip((a, b, c), out):
        assert (x64 == x32).all()
    return out


def random_triples(n: int, seed: int):
    rng = np.random.default_rng(seed)
    a, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    # c near -a * b as often as not, so the sum cancels
    c = np.where(rng.random(n) < 0.5, rng.standard_normal(n),
                 -(a.astype(np.float64) * b)
                 * (1 + rng.integers(-8, 9, n) * 2.0 ** -24))
    return a, b, c.astype(np.float32)


def fma(a, b, c) -> np.ndarray:
    return fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()


def test_witness_rounds_once():
    a = np.float32(1 + 2.0 ** -18)
    b = np.float32(2.0 ** -24 * (1 - 2.0 ** -18))
    c = np.float32(1 + 2.0 ** -23)
    got = fma(*(np.array([x]) for x in (a, b, c)))
    assert got.dtype == np.float32
    assert got[0] == np.float32(1 + 2.0 ** -23) == exact_fma([a], [b], [c])[0]
    # the float64 sum rounded twice gives the next f32 up
    assert np.float32(np.float64(a) * np.float64(b) + np.float64(c)) \
        == np.float32(1 + 2.0 ** -22)


@pytest.mark.parametrize("seed", [0, 1])
def test_near_midpoint_sweep_exact(seed):
    a, b, c = near_midpoint_triples(N_SWEEP, seed)
    want = exact_fma(a, b, c)
    # the sweep does reach the fault: double rounding gets some wrong
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != want).sum() > 100
    np.testing.assert_array_equal(fma(a, b, c), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_sweep_exact(seed):
    a, b, c = random_triples(N_SWEEP, seed)
    np.testing.assert_array_equal(fma(a, b, c), exact_fma(a, b, c))


def test_small_and_large_exponents_exact():
    """Midpoints across f32's normal range, down to its smallest normal
    binade and up to its largest."""
    rng = np.random.default_rng(2)
    n = 4000
    k = np.concatenate([np.full(n // 2, -149), np.full(n // 2, 103)])
    c = np.ldexp(rng.integers(1 << 23, 1 << 24, n).astype(np.float64), k)
    u = rng.integers(-50, 51, n) * 2.0 ** -23
    a = np.ldexp(1.0 + u, (k - 1) // 2)
    b = np.ldexp(1.0 - u, k - 1 - (k - 1) // 2)
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    assert np.isfinite(c).all() and (np.abs(b) > 0).all()
    want = exact_fma(a, b, c)
    assert (np.abs(want) >= np.finfo(np.float32).tiny).all()
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != want).sum() > 100
    np.testing.assert_array_equal(fma(a, b, c), want)


@pytest.mark.parametrize("dense_max", [0, 1 << 40])
def test_both_routes_exact(monkeypatch, dense_max):
    """The correction under the mask (small results, no host sync) and the
    one on the gathered hits (large results) give the same exact bits,
    also on broadcast operands and a 0-dim result."""
    monkeypatch.setattr(rounding, "_DENSE_MAX", dense_max)
    a, b, c = near_midpoint_triples(2000, 6)
    np.testing.assert_array_equal(fma(a, b, c), exact_fma(a, b, c))
    t = torch.from_numpy
    got = fma_f32(t(a[:32])[:, None], t(b[:32])[None, :], float(c[0]))
    for i in range(32):
        np.testing.assert_array_equal(
            got[i].numpy(),
            exact_fma(np.full(32, a[i]), b[:32], np.full(32, c[0])))
    one = fma_f32(t(a)[7], t(b)[7], t(c)[7])
    assert one.shape == () and one.numpy() == exact_fma(a[7:8], b[7:8],
                                                        c[7:8])[0]
    # permuted strides: the result keeps its logical order
    a2, b2, c2 = (t(x[:1200]).reshape(30, 40).T for x in (a, b, c))
    np.testing.assert_array_equal(
        fma_f32(a2, b2, c2).numpy(),
        exact_fma(a[:1200], b[:1200], c[:1200]).reshape(30, 40).T)


def test_small_results_never_search(monkeypatch):
    """Up to _DENSE_MAX elements the call gathers nothing (``nonzero``
    would make the host wait for the device)."""
    def boom(*a, **kw):
        raise AssertionError("searched for hits")
    monkeypatch.setattr(torch.Tensor, "nonzero", boom)
    a, b, c = near_midpoint_triples(64, 8)
    np.testing.assert_array_equal(fma(a, b, c), exact_fma(a, b, c))
    assert rounding._DENSE_MAX >= 1 << 21      # a 1024-row group of 2048


def test_python_float_operands():
    a, b, c = near_midpoint_triples(64, 3)
    t = torch.from_numpy
    for i in range(0, 64, 8):
        fa, fb, fc = float(a[i]), float(b[i]), float(c[i])
        full = np.full_like(a, 1.0)
        np.testing.assert_array_equal(
            fma_f32(fa, t(b), t(c)).numpy(), exact_fma(full * a[i], b, c))
        np.testing.assert_array_equal(
            fma_f32(t(a), fb, fc).numpy(),
            exact_fma(a, full * b[i], full * c[i]))
        np.testing.assert_array_equal(
            fma_f32(fa, fb, t(c)).numpy(),
            exact_fma(full * a[i], full * b[i], c))


def test_broadcast_and_special_values():
    a, b, c = near_midpoint_triples(32, 4)
    got = fma_f32(torch.from_numpy(a)[:, None], torch.from_numpy(b)[None, :],
                  torch.from_numpy(c)[:, None]).numpy()
    assert got.shape == (32, 32)
    for i in range(32):
        np.testing.assert_array_equal(
            got[i], exact_fma(np.full(32, a[i]), b, np.full(32, c[i])))
    inf = torch.tensor([np.inf, -np.inf, np.nan, 0.0], dtype=torch.float32)
    got = fma_f32(inf, 1.0, torch.zeros(4)).numpy()
    assert got[0] == np.inf and got[1] == -np.inf and np.isnan(got[2])
    assert got[3] == 0.0


def test_folded_scores_match_exact_reference():
    """The kernel's plain version on a small store: every score equals the
    chain of five single-rounded FMAs computed exactly."""
    rng = np.random.default_rng(5)
    q_n, rows = 6, 40
    fs = rng.integers(-2000, 2000, (q_n, rows)).astype(np.float32)
    aux = rng.standard_normal((6, rows)).astype(np.float32)
    w_fs = rng.standard_normal(q_n).astype(np.float32)
    y_aux = rng.standard_normal((q_n, 5)).astype(np.float32)
    got = scan_keys.folded_scores(
        torch.from_numpy(fs), torch.from_numpy(aux), torch.from_numpy(w_fs),
        torch.from_numpy(y_aux)).numpy()

    def f(x):
        return Fraction(float(x))

    for q in range(q_n):
        for r in range(rows):
            want = scan_keys_reference_score(
                fs[q, r], aux[:, r], w_fs[q], y_aux[q], f)
            assert got[q, r] == want, (q, r)


def scan_keys_reference_score(fs, aux, w, y, f):
    """``folded_scores``' operation order: the two plain f32 products round
    on their own, each of the five multiply-adds rounds once."""
    acc = round_f32(f(round_f32(f(w) * f(aux[5]))) * f(fs)
                    + f(round_f32(f(y[0]) * f(aux[0]))))
    for j in range(1, 5):
        acc = round_f32(f(y[j]) * f(aux[j]) + f(acc))
    return acc
