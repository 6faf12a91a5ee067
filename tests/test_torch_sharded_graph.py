"""The port's ShardedIndex (sharded graph engine) against the JAX package's.

One JAX ShardedIndex (n = 1507, dim = 24, R = 16 on a (2, 4) mesh: n is
not a multiple of the 4 shards, so shard-padding rows are live) is saved
and loaded by the port, so both packages search the same subgraphs with
the same pooled params.  The port's own build draws each shard's
NNDescent from the JAX package's Threefry keys (seed + shard), so it is
held to JAX's build by every shard's graph, its search ids and its recall
on the same data.
"""

import json

import numpy as np
import pytest
import torch

import jax

from cphnsw_tpu.parallel import sharded as jsh
from cphnsw_tpu_torch import ShardedIndex
from cphnsw_tpu_torch.api import index as tindex
from cphnsw_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(2)

N, DIM, R, K = 1507, 24, 16, 10
MIN_OVERLAP = 0.99
# Share of a shard's rows whose edge sets equal the JAX package's: the
# packages sum distances in another order, so a near tie can flip a row.
MIN_EQUAL_ROWS = 0.999


def overlap(a, b) -> float:
    return float((a[:, :, None] == b[:, None, :]).any(-1).mean())


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1234)
    centers = rng.standard_normal((12, DIM)).astype(np.float32) * 4.0
    x = centers[rng.integers(0, 12, N)] + rng.standard_normal(
        (N, DIM)).astype(np.float32)
    q = x[rng.choice(N, 32, replace=False)] + 0.05 * rng.standard_normal(
        (32, DIM)).astype(np.float32)
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), 1)[:, :K]
    return x, q, gt


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
    return jsh.ShardedIndex(dim=DIM, bits=1, r=R).build(data[0], jax_mesh)


@pytest.fixture(scope="module")
def jax_file(jax_index, tmp_path_factory):
    f = tmp_path_factory.mktemp("sharded_graph") / "jax.npz"
    jax_index.save(f)
    return f


@pytest.fixture(scope="module")
def port_from_jax(jax_file, mesh):
    return ShardedIndex(DIM, bits=1, r=R).load(jax_file, mesh)


@pytest.fixture(scope="module")
def port_index(data, mesh):
    return ShardedIndex(DIM, bits=1, r=R).build(data[0], mesh)


def _npz(path):
    with np.load(path) as z:
        header = json.loads(bytes(z["header"].tobytes()).decode())
        return header, {k: z[k] for k in z.files if k != "header"}


def test_jax_file_installs_the_same_index(jax_index, port_from_jax):
    assert port_from_jax._step_budget == jax_index._step_budget
    assert port_from_jax._n == N
    want, got = jax_index._params, port_from_jax._params
    for key in ("affine_a", "affine_b", "ip_qo_floor", "gamma", "gamma_max",
                "gamma_beta"):
        assert getattr(got, key) == float(getattr(want, key)), key
    assert got.gamma_warmup == int(want.gamma_warmup)
    np.testing.assert_array_equal(got.slack_levels.numpy(),
                                  np.asarray(want.slack_levels))
    for s, sh in enumerate(port_from_jax._store.shards[0]):
        np.testing.assert_array_equal(sh.raw.numpy(),
                                      np.asarray(jax_index._store.raw[s]))
        np.testing.assert_array_equal(
            sh.neighbors.planes.numpy().view(np.uint32),
            np.asarray(jax_index._store.nbr_planes[s]))
    assert port_from_jax._max_steps(K) == jax_index._max_steps(K)


def test_load_state_from_jax_memory(data, jax_index, port_from_jax, mesh):
    """load_state installs the in-memory JAX index (header fields, pooled
    params and the stacked shard arrays as host numpy) and searches exactly
    as the same index loaded from its file."""
    p = jax_index._params
    header = {
        "magic": tsh.SHARDED_MAGIC, "version": tsh.SHARDED_VERSION,
        "dim": DIM, "bits": 1, "r": R, "seed": jax_index.seed,
        "n": jax_index._n, "step_budget": jax_index._step_budget,
        "params": {f: np.asarray(getattr(p, f)).tolist() for f in p._fields},
    }
    arrays = {f: np.asarray(getattr(jax_index._store, f))
              for f in tsh.STORE_FIELDS}
    idx = ShardedIndex(DIM, bits=1, r=R).load_state(header, arrays, mesh)
    assert idx._step_budget == port_from_jax._step_budget
    _, q, _ = data
    ids, d = idx.search_batch(q, k=K)
    ids_f, d_f = port_from_jax.search_batch(q, k=K)
    np.testing.assert_array_equal(ids, ids_f)
    np.testing.assert_array_equal(d, d_f)


def test_derivations_match_jax_on_its_store(jax_index, port_from_jax):
    """_pooled_params and _derive_shard_step_budget run by the port on the
    JAX subgraphs give JAX's params and step budget."""
    shards = list(port_from_jax._store.shards[0])
    params = tsh._pooled_params(shards, port_from_jax._signs_h, 1, R,
                                port_from_jax._padded)
    want = jax_index._params
    # the same samples up to f32 order, then identical host numpy: the
    # fitted scalars within rtol 1e-3, the EVT slack ladder within 1e-2
    for key in ("affine_a", "affine_b", "ip_qo_floor", "gamma", "gamma_max",
                "gamma_beta"):
        np.testing.assert_allclose(getattr(params, key),
                                   float(getattr(want, key)), rtol=1e-3,
                                   err_msg=key)
    assert params.gamma_warmup == int(want.gamma_warmup)
    np.testing.assert_allclose(params.slack_levels.numpy(),
                               np.asarray(want.slack_levels), rtol=1e-2)
    budget = tsh._derive_shard_step_budget(
        shards, port_from_jax._params, port_from_jax._signs_h, 1, R, 42)
    # the 99th-percentile step of equal-quality searches: within one
    # 8-step bucket of JAX's at each anchor
    for k_anchor in (10, 100):
        assert abs(budget[k_anchor] - jax_index._step_budget[k_anchor]) <= 8


def test_search_matches_jax(data, jax_index, port_from_jax):
    x, q, gt = data
    ids_j, d_j = jax_index.search_batch(q, k=K)
    ids_t, d_t = port_from_jax.search_batch(q, k=K)
    assert overlap(ids_t, ids_j) >= MIN_OVERLAP
    # exact f32 distances: on agreeing ids rtol 1e-5 of |q|^2 + |x|^2,
    # the terms the exact distance cancels; all against numpy at 1e-3
    agree = (ids_t == ids_j) & (ids_t >= 0)
    scale = (q ** 2).sum(1)[:, None] + (x ** 2).sum(1)[np.maximum(ids_t, 0)]
    assert (np.abs(d_t - d_j)[agree] <= 1e-5 * scale[agree]).all()
    want = ((q[:, None] - x[None]) ** 2).sum(-1)[np.arange(len(q))[:, None],
                                                 ids_t]
    np.testing.assert_allclose(d_t, want, rtol=1e-3, atol=1e-3)
    assert overlap(ids_t, gt) > 0.88
    # arbitrary (non-data-axis-multiple) query counts pad and trim
    np.testing.assert_array_equal(port_from_jax.search_batch(q[:7], k=K)[0],
                                  ids_t[:7])


def test_n_seeds_matches_jax(data, jax_index, port_from_jax):
    """sharded_search(n_seeds=2) on JAX's own subgraphs against JAX's with
    n_seeds=2: every shard's beam starts from two entry candidates in both
    packages."""
    import jax.numpy as jnp
    _, q, gt = data
    ids_j, _ = jsh.sharded_search(
        jax_index._store, jnp.asarray(q), jax_index._params,
        jax_index._signs, jax_index._mesh, bits=1, k=K,
        max_steps=jax_index._max_steps(K), n_seeds=2, n_real=N)
    idx = port_from_jax
    ids_t, d_t = tsh.sharded_search(
        idx._store, q, idx._params_dev, idx._signs, idx._mesh, bits=1, k=K,
        max_steps=idx._max_steps(K), n_real=N, n_seeds=2)
    ids_t, ids_j = ids_t.numpy(), np.asarray(ids_j)
    assert overlap(ids_t, ids_j) >= MIN_OVERLAP
    assert ((ids_t >= 0) & (ids_t < N)).all()
    assert overlap(ids_t, gt) > 0.88
    # the default is the facade's 4 seeds, bit for bit
    ids_4, d_4 = tsh.sharded_search(
        idx._store, q, idx._params_dev, idx._signs, idx._mesh, bits=1, k=K,
        max_steps=idx._max_steps(K), n_real=N)
    ids_f, d_f = idx.search_batch(q, k=K)
    np.testing.assert_array_equal(ids_4.numpy(), ids_f)
    np.testing.assert_array_equal(d_4.numpy(), d_f)
    ids_e, _ = tsh.sharded_search(
        idx._store, q, idx._params_dev, idx._signs, idx._mesh, bits=1, k=K,
        max_steps=idx._max_steps(K), n_real=N, n_seeds=4)
    np.testing.assert_array_equal(ids_e.numpy(), ids_f)


def test_n_seeds_reaches_every_shards_beam(data, port_from_jax, monkeypatch):
    """Every shard's beam is called with the caller's n_seeds, and the
    argument decides the result: with no step taken the merged list holds
    each shard's seeds and nothing else."""
    _, q, _ = data
    idx = port_from_jax
    seen = []
    real = tsh.beam.search_batch

    def spy(*a, **kw):
        seen.append(kw["n_seeds"])
        return real(*a, **kw)

    monkeypatch.setattr(tsh.beam, "search_batch", spy)

    def run(**kw):
        return tsh.sharded_search(
            idx._store, q, idx._params_dev, idx._signs, idx._mesh, bits=1,
            k=K, n_real=N, **kw)[0].numpy()

    run(max_steps=idx._max_steps(K), n_seeds=2)
    n_shards = idx._mesh.shape["data"] * idx._mesh.shape["model"]
    assert len(seen) >= n_shards and set(seen) == {2}
    seen.clear()
    run(max_steps=idx._max_steps(K))
    assert set(seen) == {4}
    n_model = idx._mesh.shape["model"]
    for n_seeds in (1, 2):
        valid = (run(max_steps=0, n_seeds=n_seeds) >= 0).sum(1)
        # n_seeds per shard, less any shard-padding duplicate masked out
        assert (valid <= n_seeds * n_model).all()
        assert (valid >= n_seeds * n_model - 1).all()
    assert ((run(max_steps=0, n_seeds=4) >= 0).sum(1) == K).all()


def test_port_build_recall(data, jax_index, port_index):
    x, q, gt = data
    ids_t, d_t = port_index.search_batch(q, k=K)
    ids_j, _ = jax_index.search_batch(q, k=K)
    assert overlap(ids_t, gt) >= overlap(ids_j, gt) - 0.02
    # the same subgraphs searched alike: the beam's selection is approximate
    assert overlap(ids_t, ids_j) >= MIN_OVERLAP
    assert ids_t.dtype == np.int64 and d_t.dtype == np.float32
    assert 16 <= port_index._step_budget[10] <= 512
    assert set(port_index.build_stages) == {"shard_graphs", "calibrate",
                                            "step_budget", "place"}
    # the shard-padding rows (original id >= n) sit in the last shard
    orig = port_index._store.shards[0][3].orig_ids.numpy()
    assert (orig >= N).sum() == 4 * port_index._store.rows - N


def _shard_edges(nbr_ids, orig_ids):
    """A shard's BFS-permuted (N_s, R) neighbour ids as edges between the
    caller's ids, rows in the order of their caller's id."""
    nbr_ids, orig_ids = np.asarray(nbr_ids), np.asarray(orig_ids)
    mapped = np.where(nbr_ids >= 0, orig_ids[np.maximum(nbr_ids, 0)], -1)
    return np.sort(mapped[np.argsort(orig_ids, kind="stable")], axis=1)


def test_port_build_graphs_equal_jax(jax_index, port_index):
    """Every shard's graph, built from seed + shard's keys in both
    packages: the JAX package's on >= 99.9% of its rows."""
    shards = port_index._store.shards[0]
    assert len(shards) == np.asarray(jax_index._store.nbr_ids).shape[0]
    for s, sh in enumerate(shards):
        np.testing.assert_array_equal(
            np.sort(sh.orig_ids.numpy()),
            np.sort(np.asarray(jax_index._store.orig_ids[s])))
        got = _shard_edges(sh.neighbors.ids.numpy(), sh.orig_ids.numpy())
        want = _shard_edges(jax_index._store.nbr_ids[s],
                            jax_index._store.orig_ids[s])
        share = float((got == want).all(1).mean())
        assert share >= MIN_EQUAL_ROWS, (s, share)


def test_pad_rows_masked(data, port_index, port_from_jax):
    """n is not a multiple of the shard count: shard-padding duplicates of
    the last vector never appear in results."""
    x, q, _ = data
    queries = np.concatenate([x[-1:] + 0.01, q[:15]]).astype(np.float32)
    for idx in (port_index, port_from_jax):
        ids, _ = idx.search_batch(queries, k=K)
        assert (ids < N).all() and ids[0, 0] == N - 1
        for row in ids:
            v = row[row >= 0]
            assert len(np.unique(v)) == len(v), row


def test_visited_sub_batches_are_exact(data, port_from_jax, monkeypatch):
    _, q, _ = data
    ids_one, d_one = port_from_jax.search_batch(q, k=K)
    rows = port_from_jax._store.rows
    # a budget of 5 queries' dense visited tables per beam call
    monkeypatch.setattr(tindex, "VISITED_BYTES_BUDGET", 5 * (rows + 1))
    ids_sub, d_sub = port_from_jax.search_batch(q, k=K)
    np.testing.assert_array_equal(ids_sub, ids_one)
    # the CPU matmul blocks by batch size: distances to f32 rounding
    np.testing.assert_allclose(d_sub, d_one, rtol=1e-5)


def test_file_round_trips(data, jax_file, port_from_jax, port_index, mesh,
                          jax_mesh, tmp_path):
    x, q, _ = data
    # JAX file -> port -> file again: same header, same arrays
    f_t = tmp_path / "again.npz"
    port_from_jax.save(f_t)
    (h_j, a_j), (h_t, a_t) = _npz(jax_file), _npz(f_t)
    assert h_t == h_j
    assert sorted(a_t) == sorted(a_j)
    for key in a_j:
        assert a_t[key].dtype == a_j[key].dtype, key
        np.testing.assert_array_equal(a_t[key], a_j[key], err_msg=key)

    # the port's build -> file -> JAX, and back into the port
    f_p = tmp_path / "port.npz"
    port_index.save(f_p)
    jax_loaded = jsh.ShardedIndex(dim=DIM, bits=1, r=R).load(f_p, jax_mesh)
    assert jax_loaded._step_budget == port_index._step_budget
    ids_t, d_t = port_index.search_batch(q, k=K)
    ids_j, _ = jax_loaded.search_batch(q, k=K)
    assert overlap(ids_j, ids_t) >= MIN_OVERLAP
    again = ShardedIndex(DIM, bits=1, r=R).load(f_p, mesh)
    ids_a, d_a = again.search_batch(q, k=K)
    np.testing.assert_array_equal(ids_a, ids_t)
    np.testing.assert_array_equal(d_a, d_t)


def test_bad_files_behave_alike(jax_file, mesh, jax_mesh):
    cases = [dict(dim=DIM + 1), dict(bits=2), dict(r=8), dict(seed=7)]
    for kw in cases:
        args = dict(dim=DIM, bits=1, r=R)
        args.update(kw)
        with pytest.raises(ValueError) as want:
            jsh.ShardedIndex(**args).load(jax_file, jax_mesh)
        with pytest.raises(ValueError) as got:
            ShardedIndex(**args).load(jax_file, mesh)
        assert str(got.value) == str(want.value), kw
    with pytest.raises(ValueError, match="shards; mesh model axis is 2"):
        ShardedIndex(DIM, bits=1, r=R).load(
            jax_file, tsh.make_mesh(1, 2, [torch.device("cpu")] * 2))
