"""The port's DABS beam search against the JAX package on the same graph.

Each bit width builds one JAX graph Index (n = 2000, dim = 32, R = 16, as
tests/test_beam.py does); the port loads that very state (load_state from
the saved file), so both packages search the same graph with the same
SearchParams and entry candidates.  Top-k tie order and hash-visited
scatter winners differ between the packages and only change which
duplicate expansions happen, so the checks compare id overlap and the
distances of agreeing ids, never the order.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cphnsw_tpu.api.index import Index as JIndex
from cphnsw_tpu.ops import estimate as jest
from cphnsw_tpu.search import beam as jbeam
from cphnsw_tpu_torch import Index
from cphnsw_tpu_torch.api import index as tindex
from cphnsw_tpu_torch.calibration import calibrate as tcal
from cphnsw_tpu_torch.ops import estimate as tes
from cphnsw_tpu_torch.search import beam as tbeam

torch.set_num_threads(2)

N, DIM, R, K = 2000, 32, 16, 10
MIN_OVERLAP = 0.99


def clustered(seed, n, dim, n_clusters=24):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 4.0
    return centers[rng.integers(0, n_clusters, n)] + rng.standard_normal(
        (n, dim)).astype(np.float32)


def load_npz(path):
    with np.load(path) as z:
        header = json.loads(bytes(z["header"].tobytes()).decode())
        return header, {k: z[k] for k in z.files if k != "header"}


@pytest.fixture(scope="module")
def data():
    x = clustered(5, N, DIM)
    rng = np.random.default_rng(6)
    q = x[rng.choice(N, 48, replace=False)] + 0.05 * rng.standard_normal(
        (48, DIM)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module", params=[1, 2, 4], ids=["1bit", "2bit",
                                                       "4bit"])
def pair(request, data, tmp_path_factory):
    """(JAX index, the port's Index on the same state)."""
    bits = request.param
    jidx = JIndex(DIM, bits=bits, r=R).build(data[0]).finalize()
    f = tmp_path_factory.mktemp("beam") / f"j{bits}.npz"
    jidx.save(f)
    tidx = Index(DIM, bits=bits, r=R, device="cpu").load_state(*load_npz(f))
    return jidx, tidx


def check_agree(ids_t, d_t, ids_j, d_j, q, raw):
    ids_t, ids_j = np.asarray(ids_t), np.asarray(ids_j)
    overlap = (ids_t[:, :, None] == ids_j[:, None, :]).any(-1).mean()
    assert overlap >= MIN_OVERLAP, overlap
    # distances of agreeing ids: rtol 1e-5 of |q|^2 + |x|^2, the terms the
    # exact distance cancels (f32 sums taken in another order)
    agree = (ids_t == ids_j) & (ids_t >= 0)
    scale = (q ** 2).sum(1)[:, None] + (raw ** 2).sum(1)[np.maximum(ids_t, 0)]
    err = np.abs(np.asarray(d_t) - np.asarray(d_j))
    assert (err[agree] <= 1e-5 * scale[agree]).all()


@pytest.mark.parametrize("hash_bits", [0, 13], ids=["dense", "hash"])
def test_beam_matches_jax(pair, data, hash_bits):
    jidx, tidx = pair
    q = data[1]
    qpad = np.pad(q, ((0, 0), (0, tidx._padded - DIM)))
    kw = dict(bits=tidx._bits, k=K, beam_cap=2 * R, max_steps=96,
              expand_width=4, visited_hash_bits=hash_bits)
    ids_j, d_j = jbeam.search_batch(
        jidx._raw, jidx._norm_sq, jidx._neighbors, jidx._entry_candidates,
        jidx._signs, jnp.asarray(qpad), jidx._params, **kw)
    ids_t, d_t = tbeam.search_batch(
        tidx._raw, tidx._norm_sq, tidx._neighbors, tidx._entry_candidates,
        tidx._signs, torch.from_numpy(qpad), tidx._params, **kw)
    check_agree(ids_t, d_t, ids_j, d_j, qpad, tidx._raw.numpy())
    # results are exact distances, ascending, without duplicate ids
    ids_t, d_t = ids_t.numpy(), d_t.numpy()
    assert (np.diff(np.where(ids_t >= 0, d_t, np.inf), axis=1) >= 0).all()
    for row in ids_t:
        assert len(np.unique(row[row >= 0])) == (row >= 0).sum()


def test_beam_rerank_width_and_seeds_match_jax(pair, data):
    """rerank_width = 8 of the E * R = 64 candidates per step get the
    exact rerank, 2 seeds per query; rerank_width >= E * R is the same
    search as 0 (rerank everything)."""
    jidx, tidx = pair
    qpad = np.pad(data[1], ((0, 0), (0, tidx._padded - DIM)))
    kw = dict(bits=tidx._bits, k=K, beam_cap=2 * R, max_steps=96,
              expand_width=4)
    args_t = (tidx._raw, tidx._norm_sq, tidx._neighbors,
              tidx._entry_candidates, tidx._signs, torch.from_numpy(qpad),
              tidx._params)
    ids_j, d_j = jbeam.search_batch(
        jidx._raw, jidx._norm_sq, jidx._neighbors, jidx._entry_candidates,
        jidx._signs, jnp.asarray(qpad), jidx._params, rerank_width=8,
        n_seeds=2, **kw)
    ids_t, d_t = tbeam.search_batch(*args_t, rerank_width=8, n_seeds=2,
                                    **kw)
    check_agree(ids_t, d_t, ids_j, d_j, qpad, tidx._raw.numpy())
    full = tbeam.search_batch(*args_t, **kw)
    wide = tbeam.search_batch(*args_t, rerank_width=4 * R, **kw)
    assert torch.equal(full[0], wide[0]) and torch.equal(full[1], wide[1])


def test_index_search_matches_jax(pair, data):
    jidx, tidx = pair
    x, q = data
    ids_j, d_j = jidx.search_batch(q, k=K)
    ids_t, d_t = tidx.search_batch(q, k=K)
    check_agree(ids_t, d_t, ids_j, d_j, q, x)
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), 1)[:, :K]
    assert (ids_t[:, :, None] == gt[:, None]).any(-1).mean() > 0.9


def test_step_budget_matches_jax(pair):
    jidx, tidx = pair
    tidx._step_budget = None
    tidx._derive_step_budget()
    # the 99th-percentile step of equal-quality searches: within one
    # 8-step bucket of the derived budget at every k
    for k in (1, 10, 32, 100):
        assert abs(tidx._max_steps(k) - jidx._max_steps(k)) <= 8, k


def test_search_params_match(pair):
    jidx, tidx = pair
    want = jidx._params
    got = tidx._params
    for key in ("affine_a", "affine_b", "ip_qo_floor", "gamma", "gamma_max",
                "gamma_beta"):
        assert getattr(got, key) == float(getattr(want, key)), key
    assert got.gamma_warmup == int(want.gamma_warmup)
    np.testing.assert_array_equal(got.slack_levels.numpy(),
                                  np.asarray(want.slack_levels))


def test_early_exit_check_is_exact(pair, data, monkeypatch):
    """Reading the done flags every few steps (one host sync each) gives
    the same result as the JAX loop's check before every step."""
    _, tidx = pair
    q = torch.from_numpy(data[1])
    every = tbeam.DONE_CHECK_EVERY
    out = {}
    for check in (1, every):
        monkeypatch.setattr(tbeam, "DONE_CHECK_EVERY", check)
        out[check] = tidx._beam(q, tidx._entry_candidates, K, 64,
                                debug_state=True)
        assert bool(out[check][2].done.all())
    (ids1, d1, s1), (ids8, d8, s8) = out[1], out[every]
    assert torch.equal(ids1, ids8) and torch.equal(d1, d8)
    assert torch.equal(s1.res_step, s8.res_step)
    assert s1.steps <= s8.steps < s1.steps + every


def test_visited_sub_batches_are_exact(pair, data, monkeypatch):
    _, tidx = pair
    q = np.concatenate([data[1], data[1][::-1] + 0.01])
    ids_one, d_one = tidx.search_batch(q, k=K)
    assert tidx._sub_batch() >= len(q)
    # a budget of 7 queries' visited tables: 14 sub-batches
    monkeypatch.setattr(tindex, "VISITED_BYTES_BUDGET", 7 * (N + 1))
    assert tidx._sub_batch() == 7
    ids_sub, d_sub = tidx.search_batch(q, k=K)
    np.testing.assert_array_equal(ids_sub, ids_one)
    np.testing.assert_array_equal(d_sub, d_one)


@pytest.mark.parametrize("p", [32, 2048])
def test_fastscan_sums_exact(p):
    rng = np.random.default_rng(p)
    codes = rng.integers(0, 16, (8, 64, p)).astype(np.int32)
    q_u = rng.integers(0, 16, (8, p)).astype(np.int32)
    want = np.asarray(jest.fastscan_sums(jnp.asarray(codes), jnp.asarray(q_u)))
    got = tes.fastscan_sums(torch.from_numpy(codes), torch.from_numpy(q_u))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert (got.numpy().astype(np.int64) == want).all()


def test_fastscan_sums_refuse_inexact_width():
    codes = torch.zeros((1, 1, 1 << 17), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^24"):
        tes.fastscan_sums(codes, torch.zeros((1, 1 << 17),
                                               dtype=torch.int32))


def test_distances_with_bounds_match():
    rng = np.random.default_rng(3)
    shape = (16, 64)
    ip, ipb, ip_cp = (rng.standard_normal(shape).astype(np.float32)
                      for _ in range(3))
    nop = rng.uniform(0.1, 3.0, shape).astype(np.float32)
    ip_qo = rng.uniform(-0.1, 1.0, shape).astype(np.float32)
    dqp = rng.uniform(0.0, 9.0, (16, 1)).astype(np.float32)
    dqp[0] = 0.0                                     # degenerate rows
    slack = rng.uniform(0, 0.2, (16, 1)).astype(np.float32)
    jc = jest.CalibParams(1.1, -0.05, 0.02, jnp.asarray(slack))
    tc = tes.CalibParams(1.1, -0.05, 0.02, torch.from_numpy(slack))
    want = jest.distances_with_bounds(*map(jnp.asarray, (ip, ipb, nop, ip_qo,
                                                         ip_cp, dqp)), jc)
    got = tes.distances_with_bounds(*map(torch.from_numpy, (
        ip, ipb, nop, ip_qo, ip_cp, dqp)), tc)
    # elementwise f32 in the same order; rtol 1e-5 of nop^2 + d_qp^2, the
    # terms est and lower cancel
    scale = nop * nop + dqp
    for g, w in zip(got, want):
        assert (np.abs(g.numpy() - np.asarray(w)) <= 1e-5 * scale).all()


@pytest.mark.parametrize("bits", [2, 4])
def test_unpack_msb_is_the_top_two_bits(bits):
    """The beam takes the MSB codes as u >> (bits - 2); unpack_msb of the
    packed planes gives the same, as the JAX package's does."""
    from cphnsw_tpu.ops import pack as jpack
    from cphnsw_tpu_torch.ops import pack as tpack

    rng = np.random.default_rng(bits)
    u = rng.integers(0, 1 << bits, (64, 128)).astype(np.int32)
    planes = tpack.pack_planes(torch.from_numpy(u), bits)
    got = tpack.unpack_msb(planes, 128, bits)
    want = jpack.unpack_msb(jnp.asarray(planes.numpy().view(np.uint32)),
                            128, bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), u >> (bits - 2))
    np.testing.assert_array_equal(tpack.weighted_popcount(got).numpy(),
                                  np.asarray(jpack.weighted_popcount(want)))


def test_to_search_params_rounds_to_f32(pair):
    jidx, _ = pair
    params = tcal.to_search_params(jidx._snapshot, "cpu")
    assert params.gamma == float(np.float32(jidx._snapshot.search_gamma))
    assert params.slack_levels.dtype == torch.float32
