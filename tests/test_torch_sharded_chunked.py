"""The per-shard chunked selection of the port's sharded scan
(``sharded_scan_search(fused=False)``) against the JAX package's.

The JAX package runs this selection on every mesh that is not all TPUs:
each shard scores its rows chunk by chunk, keeps two keys per bin, decodes
top_c candidates and reranks them, and the shards' lists merge.  One JAX
ShardedScanIndex (n = 32,700, dim = 24, 1 bit; 8,192 rows per shard on a
(2, 4) mesh of CPU devices, the last shard holding pad rows) is built and
the port loads that very state, so both packages select from the same
codes and constants with the same local chunk plan.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cphnsw_tpu.parallel import sharded as jsh
from cphnsw_tpu.search import scan as jscan
from cphnsw_tpu_torch import ShardedScanIndex
from cphnsw_tpu_torch.kernels import scan_keys
from cphnsw_tpu_torch.parallel import sharded as tsh
from cphnsw_tpu_torch.search import scan as tscan

from test_torch_sharded_scan import clustered, overlap

torch.set_num_threads(2)

N, DIM, Q, K = 32_700, 24, 32, 10
MIN_OVERLAP = 0.99
# two chunks per shard, each binned four rows to a bin at TOP_C
PLAN = dict(chunk=4096, n_eq=2, rem=0)
TOP_C = 200


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    x = clustered(0, N, DIM)
    rng = np.random.default_rng(1)
    q = x[rng.choice(N, Q, replace=False)] + 0.05 * rng.standard_normal(
        (Q, DIM)).astype(np.float32)
    jidx = jsh.ShardedScanIndex(DIM, bits=1).build(x, jsh.make_mesh(2, 4))
    f = tmp_path_factory.mktemp("sharded_chunked") / "jax.npz"
    jidx.save(f)
    mesh = tsh.make_mesh(2, 4, [torch.device("cpu")] * 8)
    tidx = ShardedScanIndex(DIM, bits=1).load(f, mesh)
    return x, q.astype(np.float16), jidx, tidx


def jax_search(jidx, q16, top_c, plan, fused=False):
    inner = jidx._inner
    aff_a, aff_b, n_dev = inner._dev_scalars
    ids, d = jsh.sharded_scan_search(
        jidx._store, jnp.asarray(q16), inner._signs, aff_a, aff_b, n_dev,
        jidx._mesh, kappa=1.0, k=K, top_c=top_c, fused=fused, **plan)
    return np.asarray(ids), np.asarray(d)


def port_search(tidx, q16, top_c, **kw):
    inner = tidx._inner
    ids, d = tsh.sharded_scan_search(
        tidx._store, q16, tidx._signs, inner._affine_a, inner._affine_b,
        inner._n, tidx._mesh, kappa=1.0, k=K, top_c=top_c, **kw)
    return ids.numpy(), d.numpy()


def check(x, q16, ids_t, d_t, ids_j, d_j):
    assert ids_t.shape == ids_j.shape == (Q, K)
    assert overlap(ids_t, ids_j) >= MIN_OVERLAP
    # distances on agreeing ids: the exact f32 rerank, rtol 1e-5 of the
    # norms it cancels
    agree = (ids_t == ids_j) & (ids_t >= 0)
    qf = q16.astype(np.float32)
    scale = (qf ** 2).sum(1)[:, None] + (x ** 2).sum(1)[np.maximum(ids_t, 0)]
    assert agree.mean() > 0.9
    assert (np.abs(d_t - d_j)[agree] <= 1e-5 * scale[agree]).all()
    assert ((ids_t >= 0) & (ids_t < N)).all()


def test_local_plan_matches_jax(setup):
    """chunk=None takes the local plan, scan.chunk_plan(rows per shard,
    queries per data block): the plan the JAX facade passes."""
    x, q16, jidx, tidx = setup
    n_local = tidx._store.rows
    assert n_local == int(jidx._store.raw.shape[1]) == 8192
    plan = jscan.chunk_plan(n_local, Q // 2)
    assert tscan.chunk_plan(n_local, Q // 2) == plan
    top_c = max(min(jidx._inner._budget.top_c(K, N), plan[0]), K)
    ids_j, d_j = jax_search(jidx, q16, top_c,
                            dict(zip(("chunk", "n_eq", "rem"), plan)))
    before = scan_keys.launches
    ids_t, d_t = port_search(tidx, q16, top_c, fused=False)
    assert scan_keys.launches == before
    check(x, q16, ids_t, d_t, ids_j, d_j)
    # the same plan passed in is the same call
    ids_p, d_p = port_search(
        tidx, q16, top_c, fused=False,
        **dict(zip(("chunk", "n_eq", "rem"), plan)))
    np.testing.assert_array_equal(ids_p, ids_t)
    np.testing.assert_array_equal(d_p, d_t)
    # and it is what the JAX facade returns on this mesh
    ids_f, _ = jidx.search_batch(q16.astype(np.float32), k=K)
    assert overlap(ids_t, ids_f) >= MIN_OVERLAP
    gt = np.argsort(((q16.astype(np.float32)[:, None] - x[None]) ** 2
                     ).sum(-1), 1)[:, :K]
    assert overlap(ids_t, gt) >= 0.99


def test_explicit_plan_matches_jax(setup):
    """Two binned chunks per shard (group 4: two keys kept of every four
    rows) with a candidate budget below the derived one."""
    x, q16, jidx, tidx = setup
    layout = tscan.chunk_layout(
        tscan.plan_slices(tidx._store.rows, **PLAN), TOP_C)
    assert [g for _, _, g, _ in layout] == [4, 4]
    ids_j, d_j = jax_search(jidx, q16, TOP_C, PLAN)
    ids_t, d_t = port_search(tidx, q16, TOP_C, fused=False, **PLAN)
    check(x, q16, ids_t, d_t, ids_j, d_j)


def test_default_call_is_unchanged(setup):
    """The default arguments give the fused selection as before: the
    facade's ids bit for bit, and a chunk plan passed beside fused=True
    changes nothing."""
    x, q16, jidx, tidx = setup
    qf = q16.astype(np.float32)
    ids_f, d_f = tidx.search_batch(qf, k=K)
    top_c = tidx._top_c(K, Q // 2)
    ids_d, d_d = port_search(tidx, q16, top_c)
    np.testing.assert_array_equal(ids_d, ids_f)
    np.testing.assert_array_equal(d_d, d_f)
    ids_p, d_p = port_search(tidx, q16, top_c, fused=True, **PLAN)
    np.testing.assert_array_equal(ids_p, ids_f)
    np.testing.assert_array_equal(d_p, d_f)
    # the chunked selection agrees with the fused one on the same budget
    ids_c, _ = port_search(tidx, q16, top_c, fused=False)
    assert overlap(ids_c, ids_f) >= MIN_OVERLAP


def test_sliced_call_equals_one_call(setup, monkeypatch):
    """Every slice of a data block uses the block's one chunk plan, so a
    call sliced into sub-batches returns the ids of one call."""
    x, q16, jidx, tidx = setup
    one_i, one_d = port_search(tidx, q16, TOP_C, fused=False)
    plans = []
    real = tsh.scan.scan_search

    def spy(*a, **kw):
        plans.append((kw["chunk"], kw["n_eq"], kw["rem"], kw["fused"]))
        return real(*a, **kw)

    monkeypatch.setattr(tsh, "SEARCH_SUB_BATCH", 5)
    monkeypatch.setattr(tsh.scan, "scan_search", spy)
    ids, d = port_search(tidx, q16, TOP_C, fused=False)
    np.testing.assert_array_equal(ids, one_i)
    # the same rerank per query; the CPU matmul blocks differently by
    # batch size, so f32 rounding of the norms the distance cancels
    qf = q16.astype(np.float32)
    scale = (qf ** 2).sum(1)[:, None] + (x ** 2).sum(1)[ids]
    assert (np.abs(d - one_d) <= 1e-6 * scale).all()
    # per data block (16 queries) and shard: ceil(16 / 5) slices, all on
    # the plan of the whole block
    assert len(plans) == 2 * 4 * 4
    assert set(plans) == {(*tscan.chunk_plan(8192, Q // 2), False)}


def test_bad_plan_raises(setup):
    x, q16, jidx, tidx = setup
    with pytest.raises(ValueError, match="does not cover"):
        port_search(tidx, q16, TOP_C, fused=False, chunk=4096, n_eq=1, rem=0)
