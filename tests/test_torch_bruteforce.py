"""The port's brute-force index against the JAX package's.

Data as ``tests/test_bruteforce.py``: 4,000 x 48 clustered rows, 50
queries, k = 10, top_c = 100.  The search is held against JAX on one
store: the JAX store converted with ``store_from_arrays`` and JAX's
calibration, so selection and rerank are compared on equal inputs.
"""

import numpy as np
import pytest
import torch

from cphnsw_tpu.search import bruteforce as jbf
from cphnsw_tpu_torch.ops import estimate as tes
from cphnsw_tpu_torch.search import bruteforce as tbf

torch.set_num_threads(2)

N, DIM, Q, K, TOP_C = 4000, 48, 50, 10, 100
MIN_OVERLAP = 0.99


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1234)
    centers = rng.standard_normal((32, DIM)).astype(np.float32) * 3.0
    base = centers[rng.integers(0, 32, size=N)] + rng.standard_normal(
        (N, DIM)).astype(np.float32)
    queries = base[rng.choice(N, Q, replace=False)] + 0.1 * \
        rng.standard_normal((Q, DIM)).astype(np.float32)
    d = ((queries[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    return base, queries, np.argsort(d, axis=1)[:, :K]


@pytest.fixture(scope="module", params=[1, 2, 4], ids=["1bit", "2bit",
                                                       "4bit"])
def jax_index(request, data):
    return jbf.BruteForceIndex(DIM, bits=request.param).build(data[0])


def overlap(a, b) -> float:
    return float((a[:, :, None] == b[:, None, :]).any(-1).mean())


def port_store(jidx):
    return tbf.store_from_arrays(
        [np.asarray(a) for a in jidx.store], device="cpu")


def test_build_store_matches_jax(jax_index, data):
    bits = jax_index.bits
    got = tbf.build_store(data[0], bits, device="cpu")
    want = jax_index.store
    assert got.codes_u.dtype == torch.int8 and got.wpc.dtype == torch.int32
    np.testing.assert_array_equal(got.raw.numpy(), np.asarray(want.raw))
    np.testing.assert_array_equal(got.signs.numpy(), np.asarray(want.signs))
    # codes: >= 99.9% equal (a level can flip on a rounding tie)
    assert (got.codes_u.numpy() == np.asarray(want.codes_u)).mean() >= 0.999
    for name in ("nop", "centroid", "norm_sq"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_calibrate_affine_matches_jax(jax_index):
    """The same store gives the same fit within 1e-5 relative."""
    bits = jax_index.bits
    got = tbf.calibrate_affine(port_store(jax_index), bits)
    want = jbf.calibrate_affine(jax_index.store, bits)
    assert got.dot_slack == 0.0
    for name in ("affine_a", "affine_b", "ip_qo_floor"):
        np.testing.assert_allclose(getattr(got, name),
                                   float(getattr(want, name)), rtol=1e-5,
                                   err_msg=name)


def test_search_batch_matches_jax(jax_index, data):
    base, queries, gt = data
    bits = jax_index.bits
    ids_j, d_j = jax_index.search_batch(queries, k=K, top_c=TOP_C)
    idx = tbf.BruteForceIndex(DIM, bits=bits, device="cpu")
    idx.store = port_store(jax_index)
    c = jax_index.calib
    idx.calib = tes.CalibParams(*(float(v) for v in c))
    ids_t, d_t = idx.search_batch(queries, k=K, top_c=TOP_C)
    assert ids_t.shape == (Q, K) and ids_t.dtype == np.int64
    assert overlap(ids_t, np.asarray(ids_j)) >= MIN_OVERLAP
    # exact reranked distances, ascending
    d_true = ((queries[:, None, :] - base[ids_t]) ** 2).sum(-1)
    np.testing.assert_allclose(d_t, d_true, rtol=1e-3, atol=1e-3)
    assert (np.diff(d_t, axis=1) >= -1e-5).all()


def test_port_build_recall(jax_index, data):
    """The port's own build + calibration reaches the JAX test's recall
    floors and returns what the JAX index returns on its own build."""
    base, queries, gt = data
    bits = jax_index.bits
    idx = tbf.BruteForceIndex(DIM, bits=bits, device="cpu").build(base)
    ids, _ = idx.search_batch(queries, k=K, top_c=TOP_C)
    assert overlap(ids, gt) >= {1: 0.85, 2: 0.95, 4: 0.97}[bits]
    ids_j, _ = jax_index.search_batch(queries, k=K, top_c=TOP_C)
    assert overlap(ids, np.asarray(ids_j)) >= MIN_OVERLAP
