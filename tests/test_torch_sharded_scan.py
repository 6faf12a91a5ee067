"""The port's ShardedScanIndex against the JAX package's.

Both packages shard the same seeded data over a (2, 4) mesh of CPU
devices.  On the CPU the JAX facade's search takes its XLA path, which is
not the accelerator path; the reference for the port's search is the JAX
accelerator path run per shard in interpret mode, in estimate mode (no
sketch), merged shard-major in numpy: exactly what the JAX package's
sharded search computes on a TPU mesh.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cphnsw_tpu.api.scan_index import ScanIndex as JScanIndex
from cphnsw_tpu.parallel import sharded as jsh
from cphnsw_tpu.search import scan as jscan
from cphnsw_tpu_torch import ScanIndex, ShardedScanIndex
from cphnsw_tpu_torch.api import scan_index as tsi
from cphnsw_tpu_torch.kernels import scan_keys
from cphnsw_tpu_torch.parallel import sharded as tsh
from cphnsw_tpu_torch.search import scan as tscan

torch.set_num_threads(2)

N, DIM, Q, K = 3000, 24, 32, 10
MIN_OVERLAP = 0.99


def clustered(seed, n, dim, n_clusters=12):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 4.0
    return centers[rng.integers(0, n_clusters, n)] + rng.standard_normal(
        (n, dim)).astype(np.float32)


def overlap(a, b) -> float:
    return float((a[:, :, None] == b[:, None, :]).any(-1).mean())


def l2_gt(x, q, k=K):
    return np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), 1)[:, :k]


@pytest.fixture(scope="module")
def data():
    x = clustered(0, N, DIM)
    rng = np.random.default_rng(1)
    q = x[rng.choice(N, Q, replace=False)] + 0.01
    return x, q


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    return jsh.make_mesh(2, 4)


@pytest.fixture(scope="module")
def mesh():
    return tsh.make_mesh(2, 4, [torch.device("cpu")] * 8)


@pytest.fixture(scope="module")
def jax_index(data, jax_mesh):
    return jsh.ShardedScanIndex(DIM, bits=1).build(data[0], jax_mesh)


@pytest.fixture(scope="module")
def port_index(data, mesh):
    return ShardedScanIndex(DIM, bits=1).build(data[0], mesh)


@pytest.fixture(scope="module")
def jax_file(jax_index, tmp_path_factory):
    f = tmp_path_factory.mktemp("sharded_scan") / "jax.npz"
    jax_index.save(f)
    return f


@pytest.fixture(scope="module")
def port_from_jax(jax_file, mesh):
    """The port's ShardedScanIndex on exactly the JAX index."""
    return ShardedScanIndex(DIM, bits=1).load(jax_file, mesh)


def jax_reference(jidx, queries, k=K):
    """The JAX sharded scan as a TPU mesh runs it: per shard the fused
    kernel (interpret mode) in estimate mode, then the all-gather merge
    (shard-major concatenation, lower index first on ties)."""
    inner, store = jidx._inner, jidx._store
    n = inner._n
    s_count, n_local = store.raw.shape[:2]
    k_eff = min(k, n)
    q16 = queries.astype(np.float16)
    chunk = jscan.chunk_plan(n_local, len(queries))[0]
    top_c = max(min(inner._budget.top_c(k_eff, n), chunk), k_eff)
    k_local = min(k_eff, n_local)
    tc = max(min(top_c, n_local), k_local)
    parts_i, parts_d = [], []
    for s in range(s_count):
        arrays = jscan.ScanArrays(
            planes=store.planes[s], node_aux=store.node_aux[s],
            raw=store.raw[s], norm_sq=store.norm_sq[s])
        c, n_eq, rem = jscan.chunk_plan(n_local, len(queries))
        n_s = max(min(n - s * n_local, n_local), 0)
        ids, d = jscan.scan_search(
            arrays, jnp.asarray(q16), inner._signs,
            jnp.float32(inner._affine_a), jnp.float32(inner._affine_b),
            jnp.asarray(n_s), kappa=float((1 << inner._bits) - 1),
            k=k_local, top_c=tc, chunk=c, n_eq=n_eq, rem=rem, fused=True,
            interpret=True, sketch=None)
        ids = np.asarray(ids)
        parts_i.append(np.where(ids >= 0, ids + s * n_local, -1))
        parts_d.append(np.asarray(d))
    cat_i, cat_d = np.concatenate(parts_i, 1), np.concatenate(parts_d, 1)
    order = np.argsort(cat_d, axis=1, kind="stable")[:, :k_eff]
    ids = np.take_along_axis(cat_i, order, 1)
    d = np.take_along_axis(cat_d, order, 1)
    return np.where(d < np.finfo(np.float32).max, ids, -1), d


def check_against_reference(ids_t, d_t, jidx, queries, x):
    ids_j, d_j = jax_reference(jidx, queries)
    assert overlap(ids_t, ids_j) >= MIN_OVERLAP
    # distances on agreeing ids: the exact f32 rerank, rtol 1e-5 of the
    # norms it cancels (|q|^2 + |x|^2 - 2<q, x> summed in another order)
    agree = (ids_t == ids_j) & (ids_t >= 0)
    q16 = queries.astype(np.float16).astype(np.float32)
    scale = (q16 ** 2).sum(1)[:, None] + (x ** 2).sum(1)[np.maximum(ids_t, 0)]
    assert (np.abs(d_t - d_j)[agree] <= 1e-5 * scale[agree]).all()


def test_build_matches_jax(port_index, jax_index):
    ti, ji = port_index._inner, jax_index._inner
    # affine fit: rtol 1e-3 (Huber IRLS over slightly different f32 inputs)
    np.testing.assert_allclose(
        [ti._affine_a, ti._affine_b, ti._ip_qo_floor],
        [ji._affine_a, ji._affine_b, ji._ip_qo_floor], rtol=1e-3)
    # budget ranks within 5%: rank quantiles over near-equal estimates
    np.testing.assert_array_equal(ti._budget.anchors, ji._budget.anchors)
    np.testing.assert_allclose(ti._budget.ranks, ji._budget.ranks, rtol=0.05)
    store = jax_index._store
    shards = port_index._store.shards[0]
    assert port_index._store.rows == store.raw.shape[1]
    for s, arrays in enumerate(shards):
        np.testing.assert_array_equal(arrays.raw.numpy(),
                                      np.asarray(store.raw[s]))
        # planes: >= 99.9% of words equal (a code can flip on a rounding
        # tie); folded constants: >= 99.9% within rtol 1e-3 (the centroid
        # and floor differ by f32 summation order)
        planes_j = np.asarray(store.planes[s])
        assert (arrays.planes.numpy().view(np.uint32) == planes_j).mean() \
            >= 0.999
        aux_j = np.asarray(store.node_aux[s])
        assert np.isclose(arrays.node_aux.numpy(), aux_j, rtol=1e-3,
                          atol=1e-6).mean() >= 0.999
    assert set(port_index.build_stages) == {
        "centroid", "encode", "calibrate", "candidate_budget", "place"}
    # one shard's store per device: every shard holds N_s rows only
    assert all(a.raw.shape[0] == port_index._store.rows for a in shards)


def test_search_matches_jax_reference(data, jax_index, port_from_jax):
    x, q = data
    ids, d = port_from_jax.search_batch(q, k=K)
    check_against_reference(ids, d, jax_index, q, x)
    assert overlap(ids, l2_gt(x, q)) >= 0.99


def test_port_build_searches_like_jax(data, jax_index, port_index):
    """The port's own build (its affine fit and budget, not JAX's) gives
    the JAX build's results."""
    x, q = data
    before = scan_keys.launches
    ids, d = port_index.search_batch(q, k=K)
    # CPU tensors run the kernel's plain version, which does not count
    assert scan_keys.launches == before
    check_against_reference(ids, d, jax_index, q, x)
    assert (ids >= 0).all() and (ids < N).all()


def test_loaded_state_matches_jax_store(jax_index, port_from_jax):
    store = jax_index._store
    per = port_from_jax._store.rows
    for s, arrays in enumerate(port_from_jax._store.shards[0]):
        assert arrays.planes.numpy().view(np.uint32).tobytes() == \
            np.asarray(store.planes[s]).tobytes()
        np.testing.assert_array_equal(arrays.raw.numpy(),
                                      np.asarray(store.raw[s]))
        # genuine rows: the same folded constants; pad rows score
        # PAD_SCORE (the file keeps zeros for their other constants, as
        # the JAX package's own load then does)
        rows = max(min(N - s * per, per), 0)
        aux_t, aux_j = arrays.node_aux.numpy(), np.asarray(store.node_aux[s])
        np.testing.assert_allclose(aux_t[:, :rows], aux_j[:, :rows],
                                   rtol=1e-6)
        np.testing.assert_array_equal(aux_t[0, rows:], aux_j[0, rows:])
    # data rows on one device share the shard's tensors
    rows = port_from_jax._store.shards
    assert rows[1][2].raw.data_ptr() == rows[0][2].raw.data_ptr()


def test_load_state_from_jax_memory(data, jax_index, port_from_jax, mesh):
    """load_state installs the in-memory JAX index (its header fields, node
    constants and stacked shard arrays as host numpy) and searches exactly
    as the same index loaded from its file."""
    ji, store = jax_index._inner, jax_index._store
    header = {
        "magic": tsi.MAGIC, "version": tsi.VERSION, "dim": ji._dim,
        "padded": ji._padded, "bits": ji._bits, "n": ji._n,
        "rotation_seed": ji._seed, "metric": ji._metric,
        "ip_norm_bound": ji._ip_norm_bound, "affine_a": ji._affine_a,
        "affine_b": ji._affine_b, "ip_qo_floor": ji._ip_qo_floor,
        "budget_anchors": ji._budget.anchors.tolist(),
        "budget_ranks": ji._budget.ranks.tolist(),
    }
    arrays = {key: np.asarray(ji._node_host[key])
              for key in ("nop", "ip_qo", "ip_cp", "wpc")}
    arrays.update(
        raw=np.asarray(store.raw).reshape(-1, store.raw.shape[-1]),
        planes=np.asarray(store.planes).reshape(-1, *store.planes.shape[2:]),
        centroid=np.asarray(ji._centroid))
    idx = ShardedScanIndex(DIM, bits=1).load_state(header, arrays, mesh)
    _, q = data
    ids, d = idx.search_batch(q, k=K)
    ids_f, d_f = port_from_jax.search_batch(q, k=K)
    np.testing.assert_array_equal(ids, ids_f)
    np.testing.assert_array_equal(d, d_f)


def _candidates(arrays, qpad, signs, inner, n, top_c):
    """Estimate-mode candidate ids (Q, top_c) of one store."""
    p = arrays.raw.shape[1]
    qc, w_fs, y_aux = tscan._query_side(qpad, signs, inner._affine_a,
                                        inner._affine_b,
                                        float((1 << inner._bits) - 1))
    bins, _, rows_kpad = scan_keys.fused_bin_plan(arrays.raw.shape[0], top_c)
    codes, aux = tscan.estimate_store_operands(arrays.planes,
                                               arrays.node_aux, rows_kpad, p)
    keys = scan_keys.fused_scan_keys(codes, aux, qc.q_u.to(torch.int8), w_fs,
                                     y_aux, bins)
    ids = tscan._decode_keys(keys, top_c, bins).numpy()
    return [set(row[row < n].tolist()) for row in ids]


def test_attach_single_device_build(data, mesh):
    """Sharding a finalized single-device index: each shard's top-c is a
    superset of its share of the global top-c, so the sharded distances
    are never worse than the single-device estimate-mode search's."""
    x, q = data
    single = ScanIndex(DIM, bits=1, device="cpu").build(x).finalize()
    arrays, n = single._arrays, single.size
    top_c = single._budget.top_c(K, n)
    q_t = torch.from_numpy(q.astype(np.float16))
    ids_1, d_1 = tscan.scan_search(
        arrays, q_t, single._signs, single._affine_a, single._affine_b, n,
        kappa=1.0, k=K, top_c=top_c)
    qpad = q_t.float()
    glob = _candidates(arrays, qpad, single._signs, single, n, top_c)

    idx = ShardedScanIndex(DIM, bits=1)
    idx._inner = single
    idx._attach(mesh)
    assert single._arrays is None               # single copy released
    ids_s, d_s = idx.search_batch(q, k=K)
    assert (d_s <= d_1.numpy() + 1e-5).all()
    assert overlap(ids_s, ids_1.numpy()) >= 0.9
    per = idx._store.rows
    tc = max(min(idx._top_c(K, Q // 2), per), K)
    for s, sh in enumerate(idx._store.shards[0]):
        n_s = max(min(n - s * per, per), 0)
        local = _candidates(sh, qpad, single._signs, single, n_s, tc)
        for g, loc in zip(glob, local):
            mine = {i - s * per for i in g if s * per <= i < (s + 1) * per}
            assert mine <= loc


def test_sub_batches_equal_one_call(data, port_from_jax, monkeypatch):
    """Each shard's query block searched in slices (the divergence from
    the JAX facade's one call) gives the ids of one call."""
    x, q = data
    idx = port_from_jax
    before = scan_keys.launches
    one_i, one_d = idx.search_batch(q, k=K)
    for sub in (7, 16):
        # a sub-batch cap below 256 is taken as it is
        assert tsh.derived_sub_batch(idx._store.rows, 512, cap=sub) == sub
        monkeypatch.setattr(tsh, "SEARCH_SUB_BATCH", sub)
        calls = []
        real = tsh.scan.scan_search
        monkeypatch.setattr(tsh.scan, "scan_search",
                            lambda *a, **kw: calls.append(1) or real(*a, **kw))
        ids, d = idx.search_batch(q, k=K)
        np.testing.assert_array_equal(ids, one_i)
        # the same rerank per query; f32 rounding only if the CPU matmul
        # blocks differently by batch size
        np.testing.assert_allclose(d, one_d, rtol=1e-6)
        # per data row (16 queries) and shard: ceil(16 / sub) slices
        assert len(calls) == 2 * 4 * -(-(Q // 2) // sub)
        monkeypatch.undo()
    assert scan_keys.launches == before


def test_pad_rows_odd_queries_and_k_beyond_n(data, port_from_jax):
    x, q = data
    idx = port_from_jax
    per = idx._store.rows
    assert per * 4 > N                  # the last shard holds pad rows
    # a query at the last vector: its shard's pad rows never surface
    qs = np.concatenate([x[-1:] + 0.01, q[:6]]).astype(np.float32)
    ids, d = idx.search_batch(qs, k=K)
    assert (ids >= 0).all() and (ids < N).all()
    assert ids[0, 0] == N - 1
    for row in ids:
        assert len(np.unique(row)) == K
    # odd query counts pad to the data axis and trim: rows unchanged
    ids_all, _ = idx.search_batch(q, k=K)
    np.testing.assert_array_equal(idx.search_batch(q[:7], k=K)[0],
                                  ids_all[:7])
    # k > n pads like the single-device facade
    ids_big, d_big = idx.search_batch(q[:3], k=N + 5)
    assert ids_big.shape == d_big.shape == (3, N + 5)
    assert (ids_big[:, N:] == -1).all()
    assert (d_big[:, N:] == np.finfo(np.float32).max).all()
    assert (np.sort(ids_big[:, :N], axis=1) == np.arange(N)).all()


def test_provider_build_equals_array_build(mesh):
    x = clustered(2, 1500, 16)
    calls = []

    def provider(s, start, rows):
        calls.append((s, start, rows))
        return x[start:start + rows]

    provider.n_rows = len(x)
    idx_p = ShardedScanIndex(16, bits=1).build(provider, mesh)
    idx_a = ShardedScanIndex(16, bits=1).build(torch.from_numpy(x), mesh)
    # called per shard with contiguous rows (twice: centroid, encode)
    spans = sorted({(st, st + r) for _, st, r in calls if r})
    assert spans[0][0] == 0 and spans[-1][1] == len(x)
    q = x[::100] + 0.01
    ids_p, d_p = idx_p.search_batch(q, k=5)
    ids_a, d_a = idx_a.search_batch(q, k=5)
    np.testing.assert_array_equal(ids_p, ids_a)
    np.testing.assert_array_equal(d_p, d_a)
    assert idx_p._inner._affine_a == idx_a._inner._affine_a


def test_ip_metric(mesh, jax_mesh):
    x = clustered(3, 2000, 16) * np.random.default_rng(4).uniform(
        0.7, 1.4, (2000, 1)).astype(np.float32)
    q = clustered(5, 24, 16)
    jidx = jsh.ShardedScanIndex(16, bits=2, metric="ip").build(x, jax_mesh)
    tidx = ShardedScanIndex(16, bits=2, metric="ip").build(x, mesh)
    ti, ji = tidx._inner, jidx._inner
    assert ti._ip_norm_bound == pytest.approx(ji._ip_norm_bound, rel=1e-6)
    np.testing.assert_allclose(ti._centroid.numpy(), np.asarray(ji._centroid),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ti._budget.ranks, ji._budget.ranks, rtol=0.05)
    ids, scores = tidx.search_batch(q, k=K)
    gt = np.argsort(-(q @ x.T), axis=1)[:, :K]
    assert overlap(ids, gt) >= 0.9
    # the scores are the inner products of the f16-rounded queries
    q16 = q.astype(np.float16).astype(np.float32)
    np.testing.assert_allclose(scores, np.take_along_axis(q16 @ x.T, ids, 1),
                               rtol=1e-3, atol=1e-2)
    ids_j, _ = jax_reference(jidx, np.concatenate(
        [q, np.zeros((len(q), 1), np.float32)], axis=1))
    assert overlap(ids, ids_j) >= MIN_OVERLAP


def test_jax_file_loads_in_port(data, jax_file, port_from_jax):
    x, q = data
    ids_sh, d_sh = port_from_jax.search_batch(q, k=K)
    # the same file is a plain ScanIndex file: single-device loadable.
    # The shard top-c is a superset of the global one, so the sharded
    # result is never worse (the single-device search runs sketch mode,
    # whose 512 survivors hold the true top-10 here)
    single = ScanIndex(DIM, bits=1, device="cpu").load(jax_file)
    ids_1, d_1 = single.search_batch(q, k=K)
    assert (d_sh <= d_1 + 1e-5).all()
    assert overlap(ids_sh, ids_1) >= 0.99
    assert single.size == port_from_jax.size == N


def _npz(path):
    with np.load(path) as z:
        header = json.loads(bytes(z["header"].tobytes()).decode())
        return header, {k: z[k] for k in z.files if k != "header"}


def test_file_round_trips(data, jax_file, port_from_jax, port_index, mesh,
                          tmp_path):
    x, q = data
    # JAX file -> port -> file again: same header, same arrays
    f_t = tmp_path / "again.npz"
    port_from_jax.save(f_t)
    (h_j, a_j), (h_t, a_t) = _npz(jax_file), _npz(f_t)
    assert h_t == h_j
    assert sorted(a_t) == sorted(a_j)
    for key in a_j:
        assert a_t[key].dtype == a_j[key].dtype, key
        np.testing.assert_array_equal(a_t[key], a_j[key], err_msg=key)

    # the port's build -> file -> JAX ScanIndex and the port, sharded again
    f_p = tmp_path / "port.npz"
    port_index.save(f_p)
    jidx = JScanIndex(DIM, bits=1).load(f_p)
    h_p, a_p = _npz(f_p)
    assert jidx.size == N and h_p["affine_a"] == jidx._affine_a
    for key in ("nop", "ip_qo", "ip_cp", "wpc", "planes"):
        np.testing.assert_array_equal(jidx._node_host[key], a_p[key])
    np.testing.assert_array_equal(np.asarray(jidx._arrays.raw), a_p["raw"])
    ids_a, d_a = port_index.search_batch(q, k=K)
    ids_j, _ = jidx.search_batch(q, k=K)
    assert overlap(ids_j, ids_a) >= 0.99
    loaded = ShardedScanIndex(DIM, bits=1).load(f_p, mesh)
    ids_b, d_b = loaded.search_batch(q, k=K)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-6, atol=1e-4)


def test_make_mesh_and_merge(monkeypatch):
    cpu = torch.device("cpu")
    m = tsh.make_mesh(1, 3, [cpu] * 4)
    assert m.shape == {"data": 1, "model": 3}
    assert m.unique_devices() == [cpu]
    with pytest.raises(ValueError, match="need 6 devices"):
        tsh.make_mesh(2, 3, [cpu] * 4)
    # "cuda" without an index names the current card, as a tensor's
    # device does (the per-device lookups key on it); without CUDA the
    # mesh raises instead of moving to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    m = tsh.make_mesh(1, 2, ["cuda", torch.device("cuda")])
    assert list(m.devices.flat) == [torch.device("cuda", 0)] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsh.make_mesh(1, 2, ["cuda"] * 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsh.make_mesh(1, 2)
    # the merge orders like lax.top_k: the lower index first on ties
    d = np.array([[3.0, 1.0, 2.0, 1.0, 5.0, 1.0]], np.float32)
    ids = np.arange(6, dtype=np.int32)[None] + 100
    got_i, got_d = tsh.merge_topk(
        [torch.from_numpy(ids[:, :3]), torch.from_numpy(ids[:, 3:])],
        [torch.from_numpy(d[:, :3]), torch.from_numpy(d[:, 3:])], 4, cpu)
    neg, sel = jax.lax.top_k(jnp.asarray(-d), 4)
    np.testing.assert_array_equal(got_i.numpy(), ids[:, np.asarray(sel)[0]])
    np.testing.assert_array_equal(got_d.numpy(), -np.asarray(neg))
