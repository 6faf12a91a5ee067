"""The PyTorch port's scan engine as a whole against the JAX package.

The JAX package's own ScanIndex.search_batch takes its XLA path on the
CPU, which is not the accelerator main path; the reference for the port's
search is therefore the JAX fused path run in interpret mode, with the
int8 sketch: scan_search(..., fused=True, interpret=True, sketch=int8).
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cphnsw_tpu.api.scan_index import ScanIndex as JScanIndex
from cphnsw_tpu.search import scan as jscan
from cphnsw_tpu_torch import CPIndex, ScanIndex
from cphnsw_tpu_torch.api import scan_index as tsi
from cphnsw_tpu_torch.search import scan as tscan
from cphnsw_tpu_torch.utils.eval import recall_at_k

torch.set_num_threads(2)

N, DIM, Q, K = 3000, 32, 64, 10
# Returned-id overlap floor between the packages: selection is approximate
# (ties between equal keys of different bins may fall either way at the
# survivor cut), the rerank is exact.
MIN_OVERLAP = 0.99


def clustered(seed, n, dim, n_clusters=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3.0
    assign = rng.integers(0, n_clusters, size=n)
    return centers[assign] + rng.standard_normal((n, dim)).astype(np.float32)


def overlap(a, b) -> float:
    return float((a[:, :, None] == b[:, None, :]).any(-1).mean())


@pytest.fixture(scope="module")
def data():
    base = clustered(0, N, DIM)
    rng = np.random.default_rng(1)
    queries = base[rng.choice(N, Q, replace=False)] + 0.05 * \
        rng.standard_normal((Q, DIM)).astype(np.float32)
    return base, queries


@pytest.fixture(scope="module")
def jax_index(data):
    return JScanIndex(DIM, bits=1).build(data[0]).finalize()


@pytest.fixture(scope="module")
def port_index(data):
    return ScanIndex(DIM, bits=1, device="cpu").build(data[0]).finalize()


@pytest.fixture(scope="module")
def jax_index4(data):
    return JScanIndex(DIM, bits=4).build(data[0]).finalize()


def jax_fused_search(jidx, queries, top_c, k=K, sketch_mode=True):
    """The JAX accelerator path on the f16-rounded queries: sketch mode,
    or estimate mode (no sketch)."""
    arrays = jidx._arrays
    n_pad = arrays.raw.shape[0]
    sketch = None
    if sketch_mode:
        sketch = jscan.make_rerank_sketch(arrays.raw, arrays.norm_sq,
                                          force_int8=True)
    chunk, n_eq, rem = jscan.chunk_plan(n_pad, len(queries))
    top_c = max(min(top_c, chunk), k)
    ids, d = jscan.scan_search(
        arrays, jnp.asarray(queries.astype(np.float16)), jidx._signs,
        jnp.float32(jidx._affine_a), jnp.float32(jidx._affine_b),
        jnp.asarray(jidx._n), kappa=float((1 << jidx._bits) - 1), k=k,
        top_c=top_c, chunk=chunk, n_eq=n_eq, rem=rem, fused=True,
        interpret=True, sketch=sketch)
    return np.asarray(ids), np.asarray(d)


def jax_state(jidx):
    """(header, arrays) of a JAX index: what its save() would write."""
    header = {
        "magic": tsi.MAGIC, "version": tsi.VERSION, "dim": jidx._dim,
        "padded": jidx._padded, "bits": jidx._bits, "n": jidx._n,
        "rotation_seed": jidx._seed, "metric": jidx._metric,
        "ip_norm_bound": jidx._ip_norm_bound,
        "affine_a": jidx._affine_a, "affine_b": jidx._affine_b,
        "ip_qo_floor": jidx._ip_qo_floor,
        "budget_anchors": jidx._budget.anchors.tolist(),
        "budget_ranks": jidx._budget.ranks.tolist(),
    }
    arrays = dict(jidx._node_host, raw=np.asarray(jidx._arrays.raw),
                  centroid=np.asarray(jidx._centroid))
    return header, arrays


def check_search(tidx, jidx, queries):
    """Port search_batch vs the JAX fused path at the port's top_c."""
    ids_t, d_t = tidx.search_batch(queries, k=K)
    ids_j, d_j = jax_fused_search(jidx, queries, tidx._budget.top_c(K, N))
    assert overlap(ids_t, ids_j) >= MIN_OVERLAP
    # distances on agreeing ids: the exact f32 rerank, rtol 1e-5 of the
    # norms it cancels (|q|^2 + |x|^2 - 2<q, x> summed in another order)
    agree = ids_t == ids_j
    q16 = queries.astype(np.float16).astype(np.float32)
    scale = (q16 ** 2).sum(1)[:, None] + tidx._arrays.norm_sq.numpy()[
        np.maximum(ids_t, 0)]
    assert (np.abs(d_t - d_j)[agree] <= 1e-5 * scale[agree]).all()
    return ids_t


@pytest.mark.parametrize("bits", [1, 4])
def test_finalize_matches_jax(data, bits, jax_index, port_index, jax_index4):
    if bits == 1:
        jidx, tidx = jax_index, port_index
    else:
        jidx = jax_index4
        tidx = ScanIndex(DIM, bits=bits, device="cpu").build(
            data[0]).finalize()
    # planes: >= 99.9% of words equal (a code can flip on a rounding tie)
    planes_t = tidx._node_host["planes"]
    assert planes_t.dtype == np.uint32
    assert (planes_t == jidx._node_host["planes"]).mean() >= 0.999
    np.testing.assert_array_equal(tidx._arrays.raw.numpy(),
                                  np.asarray(jidx._arrays.raw))
    # affine fit: rtol 1e-3 (Huber IRLS over slightly different f32 inputs)
    np.testing.assert_allclose(
        [tidx._affine_a, tidx._affine_b, tidx._ip_qo_floor],
        [jidx._affine_a, jidx._affine_b, jidx._ip_qo_floor], rtol=1e-3)
    # budget ranks within 5%: rank quantiles over near-equal estimates
    np.testing.assert_array_equal(tidx._budget.anchors, jidx._budget.anchors)
    np.testing.assert_allclose(tidx._budget.ranks, jidx._budget.ranks,
                               rtol=0.05)
    assert set(tidx.build_stages) == set(jidx.build_stages)


def test_search_matches_jax_fused_path(data, jax_index, port_index):
    ids = check_search(port_index, jax_index, data[1])
    base, queries = data
    d = ((queries[:, None, :] - base[None]) ** 2).sum(-1)
    assert recall_at_k(ids, np.argsort(d, 1)[:, :K], K) >= 0.99


def test_load_state_from_jax_index(data, jax_index):
    header, arrays = jax_state(jax_index)
    tidx = ScanIndex(DIM, bits=1, device="cpu").load_state(header, arrays)
    assert tidx.is_finalized and tidx.size == N
    # the same index: planes byte-equal, folded constants to f32 rounding
    assert tidx._arrays.planes.numpy().view(np.uint32).tobytes() == \
        jax_index._node_host["planes"].tobytes()
    np.testing.assert_allclose(tidx._arrays.node_aux.numpy(),
                               np.asarray(jax_index._arrays.node_aux),
                               rtol=1e-6)
    check_search(tidx, jax_index, data[1])


@pytest.mark.parametrize("bits", [1, 4])
def test_estimate_mode_search_matches_jax(data, bits, jax_index, jax_index4):
    """The fused path without a sketch: the kernel scores the unpacked
    RaBitQ codes and top_c candidates are reranked."""
    jidx = jax_index if bits == 1 else jax_index4
    tidx = ScanIndex(DIM, bits=bits, device="cpu").load_state(*jax_state(jidx))
    queries = data[1]
    top_c = jidx._budget.top_c(K, N)
    ids_j, d_j = jax_fused_search(jidx, queries, top_c, sketch_mode=False)
    ids_t, d_t = tscan.scan_search(
        tidx._arrays, torch.from_numpy(queries.astype(np.float16)),
        tidx._signs, tidx._affine_a, tidx._affine_b, N,
        kappa=float((1 << bits) - 1), k=K, top_c=top_c)
    assert overlap(ids_t.numpy(), ids_j) >= MIN_OVERLAP


def _npz(path):
    with np.load(path) as z:
        header = json.loads(bytes(z["header"].tobytes()).decode())
        return header, {k: z[k] for k in z.files if k != "header"}


def test_cross_load(data, jax_index, port_index, tmp_path):
    queries = data[1]
    # JAX file -> port -> file again: same header, same arrays
    f_j = tmp_path / "jax.npz"
    jax_index.save(f_j)
    tidx = CPIndex(DIM, bits=1, device="cpu")
    tidx.load(f_j)
    f_t = tmp_path / "port.npz"
    tidx.save(f_t)
    (h_j, a_j), (h_t, a_t) = _npz(f_j), _npz(f_t)
    assert h_t == h_j
    assert sorted(a_t) == sorted(a_j)
    for key in a_j:
        assert a_t[key].dtype == a_j[key].dtype, key
        np.testing.assert_array_equal(a_t[key], a_j[key], err_msg=key)
    check_search(tidx._index, jax_index, queries)

    # port file -> JAX: same header and arrays, searches agree
    f_p = tmp_path / "port_built.npz"
    port_index.save(f_p)
    jidx = JScanIndex(DIM, bits=1).load(f_p)
    h_p, a_p = _npz(f_p)
    assert h_p["n"] == jidx.size and h_p["affine_a"] == jidx._affine_a
    for key in ("nop", "ip_qo", "ip_cp", "wpc", "planes"):
        np.testing.assert_array_equal(jidx._node_host[key], a_p[key])
    np.testing.assert_array_equal(np.asarray(jidx._arrays.raw), a_p["raw"])
    check_search(port_index, jidx, queries)


def test_ip_metric(tmp_path):
    base = clustered(3, 2000, 24)
    queries = clustered(4, 32, 24)
    idx = ScanIndex(24, bits=4, metric="ip", device="cpu").build(
        base).finalize()
    ids, scores = idx.search_batch(queries, k=K)
    true_ip = queries @ base.T
    gt = np.argsort(-true_ip, axis=1)[:, :K]
    assert recall_at_k(ids, gt, K) >= 0.85
    # scores are the inner products (of the f16-rounded queries), descending
    q16 = queries.astype(np.float16).astype(np.float32)
    got = np.take_along_axis(q16 @ base.T, ids, axis=1)
    np.testing.assert_allclose(scores, got, rtol=1e-3, atol=1e-2)
    assert np.all(np.diff(scores, axis=1) <= 1e-4)

    f = tmp_path / "ip.npz"
    idx.save(f)
    idx2 = ScanIndex(24, bits=4, metric="ip", device="cpu").load(f)
    ids2, s2 = idx2.search_batch(queries, k=K)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_allclose(scores, s2, rtol=1e-5)
    with pytest.raises(ValueError):
        ScanIndex(24, bits=4, device="cpu").load(f)     # metric mismatch


def test_k_exceeds_n():
    base = clustered(5, 300, 16)
    idx = ScanIndex(16, bits=1, device="cpu").build(base).finalize()
    ids, dists = idx.search_batch(base[:8], k=512)
    assert ids.shape == dists.shape == (8, 512)
    assert (ids[:, 300:] == -1).all()
    assert np.isfinite(dists[:, :300]).all()
    assert (ids[:, 0] == np.arange(8)).all()   # self-match first


def test_cpindex_auto_is_scan(data, monkeypatch):
    base, queries = data
    idx = CPIndex(DIM, bits=1, device="cpu")
    assert idx.engine is None
    idx.build(torch.from_numpy(base[:1000]))    # a tensor builds as well
    idx.finalize()
    assert idx.engine == "scan" and idx.size == 1000 and idx.is_finalized
    ids, dists = idx.search(queries[0], k=5)
    assert ids.shape == (5,) and dists.dtype == np.float32
    np_idx = ScanIndex(DIM, bits=1, device="cpu").build(base[:1000]).finalize()
    np.testing.assert_array_equal(
        idx.search_batch(queries, k=K)[0], np_idx.search_batch(queries, k=K)[0])
    graph = CPIndex(DIM, engine="graph", device="cpu")
    graph.build(base[:300])
    graph.finalize()
    assert graph.engine == "graph" and graph.size == 300
    # the default device is the GPU; without one it raises, never moves
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CPIndex(DIM)
    with pytest.raises(RuntimeError, match="cuda"):
        ScanIndex(DIM)


def test_package_imports_no_jax():
    code = ("import sys, cphnsw_tpu_torch, cphnsw_tpu_torch.utils.datasets, "
            "cphnsw_tpu_torch.utils.eval, cphnsw_tpu_torch.utils.native, "
            "cphnsw_tpu_torch.api.upper_layers, "
            "cphnsw_tpu_torch.calibration.calibrate, "
            "cphnsw_tpu_torch.calibration.evt, "
            "cphnsw_tpu_torch.graph.build, cphnsw_tpu_torch.graph.nndescent, "
            "cphnsw_tpu_torch.graph.pruning, cphnsw_tpu_torch.graph.stats, "
            "cphnsw_tpu_torch.search.beam; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('cphnsw_tpu.') or m == 'cphnsw_tpu' "
            "for m in sys.modules), 'cphnsw_tpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stderr
