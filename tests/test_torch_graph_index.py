"""The port's graph Index as a whole against the JAX package.

Index builds in the two packages draw NNDescent from the same Threefry
keys, so port-built indexes are held to JAX-built ones by their graphs
(every row's edges, per upper level too), their search ids and their
recall on the same data; files cross over in both directions and then
search the same graph, held by id overlap.  Each tolerance is stated
where it is checked.
"""

import json

import numpy as np
import pytest
import torch

from cphnsw_tpu.api.index import CPIndex as JCPIndex
from cphnsw_tpu.api.index import Index as JIndex
from cphnsw_tpu_torch import CPIndex, Index
from cphnsw_tpu_torch.api import upper_layers as tul

torch.set_num_threads(2)

N, K = 2000, 10
MIN_OVERLAP = 0.99
# Share of rows whose edge sets equal the JAX package's: the packages sum
# distances in another order, so a near tie at rank R can flip a row.
MIN_EQUAL_ROWS = 0.999


def clustered(seed, n, dim, n_clusters=24):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 4.0
    return centers[rng.integers(0, n_clusters, n)] + rng.standard_normal(
        (n, dim)).astype(np.float32)


def case_data(metric, dim):
    x = clustered(11, N, dim)
    rng = np.random.default_rng(12)
    if metric == "ip":
        x = x * rng.uniform(0.7, 1.4, (N, 1)).astype(np.float32)
        q = rng.standard_normal((40, dim)).astype(np.float32)
        gt = np.argsort(-(q @ x.T), 1)[:, :K]
    else:
        q = x[rng.choice(N, 40, replace=False)] + 0.05 * rng.standard_normal(
            (40, dim)).astype(np.float32)
        gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), 1)[:, :K]
    return x, q, gt


def recall(ids, gt):
    return float((ids[:, :, None] == gt[:, None, :]).any(-1).mean())


def overlap(a, b):
    return float((a[:, :, None] == b[:, None, :]).any(-1).mean())


def original_edges(ids, new_to_old):
    """The BFS-permuted (N, R) neighbour ids as edges between the caller's
    ids: row v holds the sorted neighbours of original vector v."""
    ids = np.asarray(ids)
    mapped = np.where(ids >= 0, new_to_old[np.maximum(ids, 0)], -1)
    out = np.empty_like(mapped)
    out[new_to_old] = mapped
    return np.sort(out, axis=1)


def equal_rows(a, b) -> float:
    return float((np.sort(a, 1) == np.sort(b, 1)).all(1).mean())


def _build(metric, entry, dim):
    """(case, data, JAX-built index, port-built index)."""
    x, q, gt = case_data(metric, dim)
    kw = dict(bits=1, entry_strategy=entry, metric=metric)
    jidx = JIndex(dim, **kw).build(x).finalize()
    tidx = Index(dim, device="cpu", **kw).build(x).finalize()
    return (metric, entry, dim), (x, q, gt), jidx, tidx


@pytest.fixture(scope="module")
def l2_seed():
    return _build("l2", "seed", 32)


@pytest.fixture(scope="module")
def ip_seed():
    return _build("ip", "seed", 24)


@pytest.fixture(scope="module")
def l2_hnsw():
    return _build("l2", "hnsw", 32)


@pytest.fixture(params=["l2_seed", "ip_seed", "l2_hnsw"])
def built(request):
    return request.getfixturevalue(request.param)


def test_recall_matches_jax(built):
    _, (x, q, gt), jidx, tidx = built
    ids_t, d_t = tidx.search_batch(q, k=K)
    ids_j, _ = jidx.search_batch(q, k=K)
    assert recall(ids_t, gt) >= recall(ids_j, gt) - 0.02
    # the same graph searched alike: the beam's selection is approximate
    assert overlap(ids_t, ids_j) >= MIN_OVERLAP
    assert ids_t.dtype == np.int64 and d_t.dtype == np.float32
    assert set(tidx.build_stages) >= {"nndescent", "prune", "reverse+prune",
                                      "encode_blocks", "calibrate",
                                      "step_budget"}


def test_graph_equals_jax(built):
    """The final graph of each build (pruned, BFS-permuted) and, for the
    HNSW entry, every upper level: the JAX package's on >= 99.9% of rows."""
    (_, entry, _), _, jidx, tidx = built
    got = original_edges(tidx._neighbors.ids.numpy(), tidx._new_to_old)
    want = original_edges(jidx._neighbors.ids, jidx._new_to_old)
    share = equal_rows(got, want)
    assert share >= MIN_EQUAL_ROWS, share
    if entry != "hnsw":
        assert tidx._upper is None and jidx._upper is None
        return
    up_t, up_j = tidx._upper, jidx._upper
    assert len(up_t.node_ids) == len(up_j.node_ids)
    assert up_t.entry_global == int(up_j.entry_global)
    for lvl in range(len(up_j.node_ids)):
        # the levels come from one numpy seed: the same subsets; then each
        # level's graph row by row (local indices)
        np.testing.assert_array_equal(up_t.node_ids[lvl].numpy(),
                                      np.asarray(up_j.node_ids[lvl]))
        share = equal_rows(up_t.nbr_idx[lvl].numpy(),
                           np.asarray(up_j.nbr_idx[lvl]))
        assert share >= MIN_EQUAL_ROWS, (lvl, share)


def test_results_are_exact(built):
    (metric, _, _), (x, q, _), _, tidx = built
    ids, d = tidx.search_batch(q, k=K)
    rows = np.arange(len(q))[:, None]
    if metric == "ip":
        want = (q @ x.T)[rows, ids]
        assert np.all(np.diff(d, axis=1) <= 1e-4)       # descending scores
    else:
        want = ((q[:, None] - x[None]) ** 2).sum(-1)[rows, ids]
        assert np.all(np.diff(d, axis=1) >= -1e-4)
    # exact f32 distances / inner products of the returned rows
    np.testing.assert_allclose(d, want, rtol=1e-3, atol=1e-3)
    ids1, d1 = tidx.search(q[3], k=K)
    np.testing.assert_array_equal(ids1, ids[3])


def test_upper_layers_reach_every_node(l2_hnsw):
    _, _, _, tidx = l2_hnsw
    up = tidx._upper
    assert up is not None and len(up.node_ids) >= 1
    for lvl in range(len(up.node_ids)):
        ids = up.node_ids[lvl].numpy()
        sel = up.nbr_idx[lvl].numpy()
        entry_local = int(np.searchsorted(ids, up.entry_global))
        assert ids[entry_local] == up.entry_global
        assert tul._reached_from(sel, entry_local).all(), lvl
        lm = up.local_of_global[lvl].numpy()
        np.testing.assert_array_equal(lm[ids], np.arange(len(ids)))


def _npz(path):
    with np.load(path) as z:
        header = json.loads(bytes(z["header"].tobytes()).decode())
        return header, {k: z[k] for k in z.files if k != "header"}


def test_cross_load(built, tmp_path):
    (metric, _, dim), (x, q, _), jidx, tidx = built
    # JAX file -> port CPIndex: the same graph searches alike
    f_j = tmp_path / "jax.npz"
    jidx.save(f_j)
    port = CPIndex(dim, bits=1, metric=metric, device="cpu")
    port.load(str(f_j))
    assert port.engine == "graph" and port.size == N and port.is_finalized
    ids_p, _ = port.search_batch(q, k=K)
    ids_j, _ = jidx.search_batch(q, k=K)
    assert overlap(ids_p, ids_j) >= MIN_OVERLAP
    # ... and writes it back unchanged: same header, same arrays
    f_t = tmp_path / "again.npz"
    port.save(str(f_t))
    (h_j, a_j), (h_t, a_t) = _npz(f_j), _npz(f_t)
    assert h_t == h_j
    assert sorted(a_t) == sorted(a_j)
    for key in a_j:
        assert a_t[key].dtype == a_j[key].dtype, key
        np.testing.assert_array_equal(a_t[key], a_j[key], err_msg=key)

    # port file -> JAX CPIndex
    f_p = tmp_path / "port.npz"
    tidx.save(f_p)
    jax_loaded = JCPIndex(dim, bits=1, metric=metric)
    jax_loaded.load(str(f_p))
    assert jax_loaded.engine == "graph"
    ids_t, _ = tidx.search_batch(q, k=K)
    ids_jl, _ = jax_loaded.search_batch(q, k=K)
    assert overlap(ids_jl, ids_t) >= MIN_OVERLAP


def _error(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_bad_headers_behave_alike(l2_seed, tmp_path):
    (_, _, dim), _, jidx, _ = l2_seed
    f = tmp_path / "g.npz"
    jidx.save(f)
    header, arrays = _npz(f)
    bad_version = tmp_path / "v.npz"
    np.savez(bad_version, header=np.frombuffer(json.dumps(
        dict(header, version=2)).encode(), dtype=np.uint8), **arrays)
    cases = [
        (f, dict(dim=dim + 1)), (f, dict(bits=2)), (f, dict(r=16)),
        (f, dict(rotation_seed=7)), (f, dict(metric="ip")),
        (bad_version, {}),
    ]
    for path, kw in cases:
        args = {"dim": dim, "bits": 1, "metric": "l2"}
        args.update(kw)
        d = args.pop("dim")
        want = _error(lambda: JIndex(d, **args).load(path))
        got = _error(lambda: Index(d, device="cpu", **args).load(path))
        assert got == want, kw
    # a scan file is not a graph file; the facade checks the engine
    scan = CPIndex(dim, bits=1, device="cpu")
    scan.build(clustered(3, 300, dim))
    scan.finalize()
    f_s = tmp_path / "scan.npz"
    scan.save(str(f_s))
    assert _error(lambda: Index(dim, device="cpu").load(f_s)) == _error(
        lambda: JIndex(dim).load(f_s))
    assert "engine" in _error(
        lambda: CPIndex(dim, engine="graph", device="cpu").load(str(f_s)))
    assert "engine" in _error(
        lambda: CPIndex(dim, engine="scan", device="cpu").load(str(f)))


def test_lifecycle_and_k_beyond_n():
    idx = CPIndex(16, bits=2, engine="graph", device="cpu")
    with pytest.raises(RuntimeError):
        idx.search_batch(np.zeros((1, 16), np.float32))
    with pytest.raises(RuntimeError):
        idx.finalize()
    x = clustered(4, 120, 16)
    idx.build(torch.from_numpy(x))              # a tensor builds as well
    with pytest.raises(ValueError):
        idx._index.build(np.zeros((0, 16), np.float32))
    idx.build(x)
    idx.finalize()
    assert idx.engine == "graph" and idx.size == 120
    ids, d = idx.search_batch(x[:4], k=200)
    assert ids.shape == d.shape == (4, 200)
    assert (ids[:, 120:] == -1).all()
    assert (d[:, 120:] == np.finfo(np.float32).max).all()
    assert (ids[:, 0] == np.arange(4)).all()    # self-match first
