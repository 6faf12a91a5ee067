"""The port's Threefry stream and device dataset recipe against JAX's.

The JAX package draws synthetic stores of n * dim >= 64M elements on its
accelerator from ``jax.random`` (``cphnsw_tpu/utils/datasets.py::
_device_synthetic``); the port draws the same stream in torch
(``ops/threefry.py``).  Here both run on the CPU at 4096 x 64 with 32
clusters and 100 queries, under JAX's default
``jax_threefry_partitionable=True``.  The integer draws (key splits,
cluster assignment, query rows) must be equal, and so must the normal
draws (MAX_ULPS = 0): the port's erf_inv, log1p and log follow the program
XLA's CPU backend runs operation by operation, contractions included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cphnsw_tpu.utils import datasets as jdata
from cphnsw_tpu_torch.ops import threefry
from cphnsw_tpu_torch.utils import datasets as tdata

torch.set_num_threads(2)

N, DIM, N_QUERIES, N_CLUSTERS = 4096, 64, 100, 32
MAX_ULPS = 0


@pytest.fixture(autouse=True)
def one_thread():
    """Run each test's torch CPU work on one thread: on some hosts a CPU
    pool thread has been seen to round its part of a parallel f32 op (a
    sqrt) one ulp differently, which makes bit-level comparisons flaky."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in f32 units in the last place (a monotone integer map of
    the f32 bits, so a difference across zero counts its steps)."""
    def ordinal(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordinal(a) - ordinal(b))


def jax_keys(seed):
    return [tuple(int(w) for w in k)
            for k in np.asarray(jax.random.split(jax.random.PRNGKey(seed),
                                                 5))]


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 11])
def test_key_split_equal(seed):
    assert threefry.prng_key(seed) == tuple(
        int(w) for w in np.asarray(jax.random.PRNGKey(seed)))
    assert threefry.split(threefry.prng_key(seed), 5) == jax_keys(seed)


@pytest.mark.parametrize("seed", [0, 7])
def test_integer_draws_equal(seed):
    """The cluster assignment (randint) and the query rows (choice without
    replacement: a permutation's head) of the recipe, also at a span that
    is not a power of two and at a larger n."""
    _, ka, _, kq, _ = threefry.split(threefry.prng_key(seed), 5)
    _, ka_j, _, kq_j, _ = jax.random.split(jax.random.PRNGKey(seed), 5)
    for span in (N_CLUSTERS, 1000):
        got = threefry.randint(ka, N, 0, span, "cpu").numpy()
        want = np.asarray(jax.random.randint(ka_j, (N,), 0, span))
        np.testing.assert_array_equal(got, want)
    for n in (N, 100_000):
        got = threefry.permutation(kq, n, "cpu")[:N_QUERIES].numpy()
        want = np.asarray(jax.random.choice(kq_j, n, (N_QUERIES,),
                                            replace=False))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7])
def test_normal_draws_within_ulps(seed):
    kc, _, kn, _, _ = threefry.split(threefry.prng_key(seed), 5)
    kc_j, _, kn_j, _, _ = jax.random.split(jax.random.PRNGKey(seed), 5)
    got = threefry.normal(kn, (N, DIM), "cpu").numpy()
    want = np.asarray(jax.random.normal(kn_j, (N, DIM), jnp.float32))
    assert got.shape == want.shape
    assert ulps(got, want).max() <= MAX_ULPS
    assert (got == want).mean() >= 0.999
    got = threefry.normal(kc, (N_CLUSTERS, DIM), "cpu").numpy()
    want = np.asarray(jax.random.normal(kc_j, (N_CLUSTERS, DIM),
                                        jnp.float32))
    assert ulps(got, want).max() <= MAX_ULPS


@pytest.mark.parametrize("seed", [0, 7])
def test_normal_draws_bit_equal_at_2_20(seed):
    """2^20 draws: every branch of erf_inv (w < 5 and beyond) and of log1p
    (the rational approximation and the log) many times over."""
    _, _, kn, _, _ = threefry.split(threefry.prng_key(seed), 5)
    _, _, kn_j, _, _ = jax.random.split(jax.random.PRNGKey(seed), 5)
    got = threefry.normal(kn, (1 << 20,), "cpu").numpy()
    want = np.asarray(jax.random.normal(kn_j, (1 << 20,), jnp.float32))
    assert (np.abs(got) > 4.0).sum() > 10      # the w >= 5 branch ran
    differ = ulps(got, want)
    assert (differ > 0).sum() == 0, ((differ > 0).sum(), differ.max())


@pytest.mark.parametrize("seed", [0, 3])
def test_device_synthetic_matches_jax(seed):
    """The recipe as a whole: centres and queries within MAX_ULPS; a base
    row is a centre plus noise, so it is held to MAX_ULPS of the larger
    addend; the ground truth of each package's data is equal."""
    base_t, q_t = tdata._device_synthetic(N, DIM, N_QUERIES, N_CLUSTERS, seed,
                                          "cpu")
    base_j, q_j = jdata._device_synthetic(N, DIM, N_QUERIES, N_CLUSTERS, seed)
    base_t, base_j = base_t.numpy(), np.asarray(base_j)
    assert base_t.shape == (N, DIM) and q_t.shape == (N_QUERIES, DIM)
    assert q_t.dtype == base_t.dtype == np.float32

    kc, ka, _, _, _ = threefry.split(threefry.prng_key(seed), 5)
    centers = threefry.normal(kc, (N_CLUSTERS, DIM), "cpu").numpy() * 3.0
    assign = threefry.randint(ka, N, 0, N_CLUSTERS, "cpu").numpy()
    noise = base_t - centers[assign]
    scale = np.maximum(np.abs(centers[assign]), np.abs(noise))
    spacing = np.spacing(scale.astype(np.float32))
    assert (np.abs(base_t - base_j) <= MAX_ULPS * spacing).all()
    q_scale = np.maximum(np.abs(q_t), np.abs(base_t[:1]).max())
    assert (np.abs(q_t - q_j) <= MAX_ULPS * np.spacing(q_scale)).all()
    assert (base_t == base_j).mean() >= 0.999

    gt_j = jdata._device_groundtruth(base_j, q_j, 10)
    gt_t = tdata.device_groundtruth(base_t, q_t, 10, device="cpu",
                                    row_chunk=1000)
    np.testing.assert_array_equal(gt_t, gt_j)


def test_make_synthetic_uses_threefry_only_on_cuda(monkeypatch):
    """The device recipe runs on a CUDA device at n * dim >= 64M; on the
    CPU every size takes the host numpy recipe, as the JAX package's CPU
    backend does."""
    assert tdata.DEVICE_DATA_MIN_ELEMENTS == 64 << 20
    monkeypatch.setattr(tdata, "DEVICE_DATA_MIN_ELEMENTS", 1)
    kw = dict(n_queries=20, gt_k=5, n_clusters=8, seed=3)
    got = tdata.make_synthetic("synthetic-2k-16d", gt_device="cpu",
                               cache_dir=None, **kw)
    want = jdata.make_synthetic("synthetic-2k-16d", cache_dir=None, **kw)
    assert "base_dev_factory" not in got
    assert got["base"].tobytes() == want["base"].tobytes()
