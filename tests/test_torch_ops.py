"""Parity of the PyTorch port's ops against the JAX package.

Inputs are made with numpy from a seed and go through both packages.
Each tolerance is stated where it is checked, with its reason.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cphnsw_tpu.calibration import huber as jhuber
from cphnsw_tpu.ops import hadamard as jhad
from cphnsw_tpu.ops import pack as jpack
from cphnsw_tpu.ops import quantize as jquant
from cphnsw_tpu.search import scan as jscan
from cphnsw_tpu_torch.calibration import huber as thuber
from cphnsw_tpu_torch.ops import hadamard as thad
from cphnsw_tpu_torch.ops import pack as tpack
from cphnsw_tpu_torch.ops import quantize as tquant
from cphnsw_tpu_torch.search import scan as tscan

torch.set_num_threads(2)

# Elementwise agreement floor where the two packages sum in different
# orders: a code can flip where a value sits on a rounding (.5) or sign
# tie, which is rare but not impossible.
MIN_EQUAL = 0.999


def clustered(seed, n, dim, n_clusters=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3.0
    assign = rng.integers(0, n_clusters, size=n)
    return centers[assign] + rng.standard_normal((n, dim)).astype(np.float32)


def equal_frac(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).mean())


@pytest.mark.parametrize("seed", [0, 42])
def test_rotation_signs_bit_equal(seed):
    for p in (16, 32, 64, 128, 256, 512, 1024, 2048):
        want = np.asarray(jhad.rotation_signs(seed, p))
        got = thad.rotation_signs(seed, p).numpy()
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes(), p


@pytest.mark.parametrize("p", [16, 128])
def test_fwht_and_rotate_match(p):
    # rtol 1e-6: the butterflies are the same f32 adds in the same order;
    # only the final scaling may round differently by an ulp.
    x = np.random.default_rng(p).standard_normal((64, p)).astype(np.float32)
    np.testing.assert_allclose(thad.fwht(torch.from_numpy(x)).numpy(),
                               np.asarray(jhad.fwht(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    signs = jhad.rotation_signs(7, p)
    np.testing.assert_allclose(
        thad.rotate(torch.from_numpy(x), thad.rotation_signs(7, p)).numpy(),
        np.asarray(jhad.rotate(jnp.asarray(x), signs)), rtol=1e-6, atol=1e-7)
    assert thad.next_pow2(p - 1) == jhad.next_pow2(p - 1)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_encode_vectors_match(bits):
    x = clustered(bits, 1500, 24)
    p = thad.next_pow2(24)
    raw_j = jhad.pad_to(jnp.asarray(x), p)
    cen_j = jquant.compute_centroid(raw_j)
    enc_j = jquant.encode_vectors(raw_j, cen_j, jhad.rotation_signs(42, p),
                                  bits)
    raw_t = thad.pad_to(torch.from_numpy(x), p)
    cen_t = tquant.compute_centroid(raw_t)
    enc_t = tquant.encode_vectors(raw_t, cen_t, thad.rotation_signs(42, p),
                                  bits)
    # codes: >= 99.9% equal (norm and mean are summed in another order, so
    # a coordinate on a rounding or sign tie can flip)
    assert equal_frac(enc_t.u.numpy(), enc_j.u) >= MIN_EQUAL
    # nop, ip_qo: rtol 1e-5, a few f32 ulps of reordered sums
    np.testing.assert_allclose(enc_t.nop.numpy(), np.asarray(enc_j.nop),
                               rtol=1e-5)
    same = (enc_t.u.numpy() == np.asarray(enc_j.u)).all(axis=1)
    np.testing.assert_allclose(enc_t.ip_qo.numpy()[same],
                               np.asarray(enc_j.ip_qo)[same], rtol=1e-5)


def test_encode_queries_match():
    q = clustered(5, 256, 40)
    p = thad.next_pow2(40)
    qc_j = jquant.encode_queries(jnp.asarray(q), jhad.rotation_signs(42, p))
    qc_t = tquant.encode_queries(torch.from_numpy(q),
                                 thad.rotation_signs(42, p))
    # levels: >= 99.9% equal (rounding ties after reordered sums)
    assert equal_frac(qc_t.q_u.numpy(), qc_j.q_u) >= MIN_EQUAL
    same = (qc_t.q_u.numpy() == np.asarray(qc_j.q_u)).all(axis=1)
    # coeff_a, coeff_b: rtol 1e-5 on queries whose levels agree
    for name in ("coeff_a", "coeff_b"):
        np.testing.assert_allclose(getattr(qc_t, name).numpy()[same],
                                   np.asarray(getattr(qc_j, name))[same],
                                   rtol=1e-5, err_msg=name)
    # coeff_c = -(P*vmin + delta*sum_u)/sqrt(P) cancels two terms of size
    # ~P*|vmin| (XLA may fuse them into one FMA), so its error is relative
    # to those terms: 1e-5 of their magnitude
    vmin = np.asarray(qc_j.q_rot).min(axis=1)
    scale = (p * np.abs(vmin) + np.abs(np.asarray(qc_j.coeff_a))
             * np.sqrt(p) / 2 * np.asarray(qc_j.q_u).sum(axis=1)) / np.sqrt(p)
    err = np.abs(qc_t.coeff_c.numpy() - np.asarray(qc_j.coeff_c))
    assert (err[same] <= 1e-5 * scale[same]).all(), err.max()


@pytest.mark.parametrize("bits,p", [(1, 16), (2, 48), (4, 128)])
def test_pack_planes_byte_equal(bits, p):
    u = np.random.default_rng(bits).integers(0, 1 << bits, size=(300, p))
    u = u.astype(np.int32)
    planes_j = np.asarray(jpack.pack_planes(jnp.asarray(u), bits))
    planes_t = tpack.pack_planes(torch.from_numpy(u), bits)
    # the planes are the file format: byte-equal, exactly
    assert planes_t.numpy().view(np.uint32).tobytes() == planes_j.tobytes()
    np.testing.assert_array_equal(
        tpack.unpack_codes_i8(planes_t, p).numpy(),
        np.asarray(jpack.unpack_codes_i8(jnp.asarray(planes_j), p)))
    np.testing.assert_array_equal(tpack.unpack_planes(planes_t, p).numpy(), u)
    assert tpack.num_words(p) == jpack.num_words(p)


def test_unpack_codes_i8_row_chunked(monkeypatch):
    u = np.random.default_rng(3).integers(0, 16, size=(1000, 64))
    planes = tpack.pack_planes(torch.from_numpy(u.astype(np.int32)), 4)
    monkeypatch.setattr(tpack, "UNPACK_CHUNK", 256)
    np.testing.assert_array_equal(
        tpack.unpack_codes_i8(planes, 64).numpy(), u.astype(np.int8))


def test_rerank_sketch_int8_match():
    x = clustered(9, 3000, 32)
    xj = jnp.asarray(x)
    sk_j = jscan.make_rerank_sketch(xj, jnp.sum(xj * xj, -1),
                                    force_int8=True)
    x_t = torch.from_numpy(x)
    sk_t = tscan.make_rerank_sketch(x_t, (x_t * x_t).sum(-1),
                                    force_int8=True)
    # scales: the same max / 127 in f32; XLA may round the division
    # differently by one ulp (rtol 1e-6)
    np.testing.assert_allclose(sk_t.scale.numpy(), np.asarray(sk_j.scale),
                               rtol=1e-6)
    # codes: >= 99.9% equal (a division can land on a .5 tie differently)
    assert equal_frac(sk_t.store.numpy(), sk_j.store) >= MIN_EQUAL
    # norms of the sketch points: rtol 1e-5, reordered f32 sums
    np.testing.assert_allclose(sk_t.norm_sq.numpy(), np.asarray(sk_j.norm_sq),
                               rtol=1e-5)


def test_huber_equal():
    rng = np.random.default_rng(11)
    e = rng.standard_normal(2000)
    t = 0.8 * e + 0.1 + 0.05 * rng.standard_cauchy(2000)
    # the port's huber.py is a numpy copy: results are equal, exactly
    assert thuber.fit_affine_huber(e, t) == jhuber.fit_affine_huber(e, t)
    assert thuber.mad_lower_fence(np.abs(e)) == jhuber.mad_lower_fence(
        np.abs(e))
    assert thuber.mad_sigma(t) == jhuber.mad_sigma(t)
