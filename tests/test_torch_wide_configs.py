"""The port's scan engine against the JAX package at the widths of the JAX
package's recorded workloads: 960d (GIST1M's shape, P = 1024), 1536d by
inner product (1537 columns, P = 2048, the streamed query tile on the
card) and 96d (Deep10M's shape, P = 128), at k = 10 and 100.

Both packages run on the CPU on the same seeded data.  The JAX search is
its accelerator path in interpret mode with the int8 sketch, as in
``tests/test_torch_scan_index.py``.  The tolerances below were measured on
these inputs; each states its figure.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cphnsw_tpu.api.scan_index import ScanIndex as JScanIndex
from cphnsw_tpu.search import scan as jscan
from cphnsw_tpu_torch import ScanIndex

torch.set_num_threads(2)

Q = 32
# (dim, metric) of each workload's shape
CONFIGS = {"960d": (960, "l2"), "1536d-ip": (1536, "ip"), "96d": (96, "l2")}
# Returned ids agree with the JAX fused path on >= 0.99 (measured
# 0.99969 at 960d, k = 100, and 1.0 in the other cases): the selection is
# approximate at the survivor cut.
MIN_OVERLAP = 0.99
# Plane words equal to the JAX package's: CAQ's coordinate descent flips
# a code on a last-bit difference of its inputs (the centroid and the
# rotated norms are summed in another order).  >= 99.9% at 1 bit
# (measured 100% at 960d and 96d, 99.9995% at 1536d) and at 2 bits
# (99.96% at 960d on 1000 rows); >= 98.5% at 4 bits for P >= 1024
# (measured 98.99% at 960d, 98.89% at 1536d).
MIN_PLANES = {1: 0.999, 4: 0.985}
# Budget anchors equal, ranks within 5%: rank quantiles over near-equal
# estimates (measured: equal, or one rank apart, e.g. 29 against 28).
RANK_RTOL = 0.05


def clustered(seed, n, dim, n_clusters=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3.0
    assign = rng.integers(0, n_clusters, size=n)
    return centers[assign] + rng.standard_normal((n, dim)).astype(np.float32)


@functools.cache
def data(config, n):
    dim, _ = CONFIGS[config]
    base = clustered(0, n, dim)
    rng = np.random.default_rng(1)
    queries = base[rng.choice(n, Q, replace=False)] + 0.05 * \
        rng.standard_normal((Q, dim)).astype(np.float32)
    return base, queries


@functools.cache
def indexes(config, bits, n):
    """(JAX index, port index) on the same data."""
    dim, metric = CONFIGS[config]
    base = data(config, n)[0]
    jidx = JScanIndex(dim, bits=bits, metric=metric).build(base).finalize()
    tidx = ScanIndex(dim, bits=bits, metric=metric, device="cpu").build(
        base).finalize()
    return jidx, tidx


def overlap(a, b) -> float:
    return float((a[:, :, None] == b[:, None, :]).any(-1).mean())


def jax_fused_search(jidx, queries, top_c, k):
    """The JAX accelerator path on the f16-rounded queries, sketch mode;
    squared distances in the store's (augmented, for ip) space."""
    arrays = jidx._arrays
    sketch = jscan.make_rerank_sketch(arrays.raw, arrays.norm_sq,
                                      force_int8=True)
    chunk, n_eq, rem = jscan.chunk_plan(arrays.raw.shape[0], len(queries))
    ids, d = jscan.scan_search(
        arrays, jnp.asarray(queries.astype(np.float16)), jidx._signs,
        jnp.float32(jidx._affine_a), jnp.float32(jidx._affine_b),
        jnp.asarray(jidx._n), kappa=float((1 << jidx._bits) - 1), k=k,
        top_c=max(min(top_c, chunk), k), chunk=chunk, n_eq=n_eq, rem=rem,
        fused=True, interpret=True, sketch=sketch)
    return np.asarray(ids), np.asarray(d)


@pytest.mark.parametrize("config,bits,n", [
    ("960d", 1, 3000), ("1536d-ip", 1, 3000), ("96d", 1, 3000),
    ("960d", 4, 1000), ("1536d-ip", 4, 1000)])
def test_finalize_matches_jax(config, bits, n):
    jidx, tidx = indexes(config, bits, n)
    assert tidx._padded == jidx._padded
    # the padded (and, for ip, augmented) store: bit-equal
    np.testing.assert_array_equal(tidx._arrays.raw.numpy(),
                                  np.asarray(jidx._arrays.raw))
    assert tidx._ip_norm_bound == jidx._ip_norm_bound
    planes_t = tidx._node_host["planes"]
    assert planes_t.dtype == np.uint32
    assert (planes_t == jidx._node_host["planes"]).mean() >= MIN_PLANES[bits]
    np.testing.assert_array_equal(tidx._budget.anchors, jidx._budget.anchors)
    np.testing.assert_allclose(tidx._budget.ranks, jidx._budget.ranks,
                               rtol=RANK_RTOL)


@pytest.mark.parametrize("config,k", [
    ("960d", 100), ("1536d-ip", 10), ("1536d-ip", 100), ("96d", 100)])
def test_search_matches_jax(config, k):
    n = 3000
    jidx, tidx = indexes(config, 1, n)
    base, queries = data(config, n)
    ids_t, d_t = tidx.search_batch(queries, k=k)
    ids_j, d_j = jax_fused_search(jidx, queries, tidx._budget.top_c(k, n), k)
    assert ids_t.shape == (Q, k)
    assert overlap(ids_t, ids_j) >= MIN_OVERLAP
    q16 = queries.astype(np.float16).astype(np.float32)
    agree = ids_t == ids_j
    norms = tidx._arrays.norm_sq.numpy()[np.maximum(ids_t, 0)]
    # the rerank's exact f32 distances, rtol 1e-5 of the norms they cancel
    # (|q|^2 + |x|^2 - 2<q, x> summed in another order)
    scale = (q16 ** 2).sum(1)[:, None] + norms
    if CONFIGS[config][1] == "ip":
        # both packages turn the augmented-space distance into a score
        # with the unrounded query's norm and the store's norm bound
        qn = (queries ** 2).sum(1)[:, None]
        d_j = (qn + jidx._ip_norm_bound - d_j) / 2.0
        # the scores are the inner products of the f16-rounded queries,
        # in descending order (as test_ip_metric holds them)
        got = np.take_along_axis(q16 @ base.T, ids_t, axis=1)
        np.testing.assert_allclose(d_t, got, rtol=1e-3, atol=1e-2)
        assert np.all(np.diff(d_t, axis=1) <= 1e-4 * scale[:, 1:])
    assert (np.abs(d_t - d_j)[agree] <= 1e-5 * scale[agree]).all()
