"""The beam step in the segments its CUDA kernels take, held to the JAX
package, and the kernels' launch plan.

On the CPU the step runs the plain versions of its segments
(``search/beam.py``: pop, expand, merge, gamma) around the exact
distances.  The composed step is held
to the JAX package's ``search_batch`` (ids, the step each result was
pushed, each query's last improving step and the loop's steps) over bit
widths 1/2/4, expand widths 1/4, R 16/32, dense and hashed visited tables,
rerank widths 0 and 8, k 10 and 100 (beam_cap 400) and done checks every
1 and 8 steps; the merge's top-k and the expansion's estimates against
the JAX functions that compute them.  The launch plan is plain Python,
checked at the main path's, the k = 100 and the sharded shapes, at shapes
whose workspace lives in global scratch, and at the shapes it refuses (those
the plain step cannot compute either); a launcher refuses CPU tensors, and
a CPU search builds no library and launches nothing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cphnsw_tpu.api.index import Index as JIndex
from cphnsw_tpu.ops import estimate as jest
from cphnsw_tpu.search import beam as jbeam
from cphnsw_tpu_torch import Index
from cphnsw_tpu_torch.kernels import beam_step, nvcc
from cphnsw_tpu_torch.ops import pack
from cphnsw_tpu_torch.search import beam as tbeam
from test_torch_beam import DIM, N, clustered, load_npz

torch.set_num_threads(2)

# (bits, R, expand_width, visited_hash_bits, rerank_width, k): every value
# of each axis at least once; beam_cap = max(2R, 4k), as Index sets it
CASES = {
    "1bit-r16-e1-dense-rw0-k10": (1, 16, 1, 0, 0, 10),
    "1bit-r32-e4-hash-rw0-k10": (1, 32, 4, 13, 0, 10),
    "1bit-r32-e4-hash-rw8-k100": (1, 32, 4, 13, 8, 100),
    "2bit-r16-e4-dense-rw8-k10": (2, 16, 4, 0, 8, 10),
    "2bit-r32-e1-hash-rw0-k100": (2, 32, 1, 13, 0, 100),
    "4bit-r16-e4-hash-rw8-k100": (4, 16, 4, 13, 8, 100),
    "4bit-r32-e1-dense-rw0-k10": (4, 32, 1, 0, 0, 10),
    "4bit-r32-e4-dense-rw0-k100": (4, 32, 4, 0, 0, 100),
}
MAX_STEPS = 200


@pytest.fixture(scope="module")
def data():
    x = clustered(5, N, DIM)
    rng = np.random.default_rng(7)
    return x, x[rng.choice(N, 40, replace=False)] + 0.05 * \
        rng.standard_normal((40, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def indexes(data, tmp_path_factory):
    """(bits, R) -> (JAX graph Index, the port's Index on its state)."""
    built = {}

    def get(bits, r):
        if (bits, r) not in built:
            jidx = JIndex(DIM, bits=bits, r=r).build(data[0]).finalize()
            f = tmp_path_factory.mktemp("beam_kernel") / f"j{bits}-{r}.npz"
            jidx.save(f)
            built[bits, r] = jidx, Index(DIM, bits=bits, r=r,
                                         device="cpu").load_state(
                *load_npz(f))
        return built[bits, r]

    return get


def _padded(tidx, q):
    return np.pad(q, ((0, 0), (0, tidx._padded - DIM)))


@pytest.mark.parametrize("case", list(CASES))
def test_segmented_step_matches_jax(indexes, data, case, monkeypatch):
    bits, r, ew, hash_bits, rw, k = CASES[case]
    jidx, tidx = indexes(bits, r)
    qpad = _padded(tidx, data[1])
    kw = dict(bits=bits, k=k, beam_cap=max(2 * r, 4 * k),
              max_steps=MAX_STEPS, expand_width=ew,
              visited_hash_bits=hash_bits, rerank_width=rw,
              debug_state=True)
    ids_j, d_j, s_j = jbeam.search_batch(
        jidx._raw, jidx._norm_sq, jidx._neighbors, jidx._entry_candidates,
        jidx._signs, jnp.asarray(qpad), jidx._params, **kw)
    steps_j = int(s_j.steps)
    assert steps_j < MAX_STEPS and bool(np.asarray(s_j.done).all())
    ids_j, d_j = np.asarray(ids_j), np.asarray(d_j)
    raw = tidx._raw.numpy()
    for check in (1, 8):
        monkeypatch.setattr(tbeam, "DONE_CHECK_EVERY", check)
        ids_t, d_t, s_t = tbeam.search_batch(
            tidx._raw, tidx._norm_sq, tidx._neighbors,
            tidx._entry_candidates, tidx._signs, torch.from_numpy(qpad),
            tidx._params, **kw)
        ids_t, d_t = ids_t.numpy(), d_t.numpy()
        # the same results, each pushed at the same step; two results may
        # trade places only where their exact distances tie within the
        # port's summation-order error (rtol 1e-5 of |q|^2 + |x|^2, the
        # terms the distance cancels): at k = 100 such ties occur
        for row in range(len(ids_t)):
            assert dict(zip(ids_t[row], s_t.res_step[row].tolist())) == \
                dict(zip(ids_j[row], np.asarray(s_j.res_step)[row].tolist()))
        moved = ids_t != ids_j
        scale = (qpad ** 2).sum(1)[:, None] + (raw ** 2).sum(1)[
            np.maximum(ids_t, 0)]
        assert (np.abs(d_t - d_j)[moved] <= 1e-5 * scale[moved]).all()
        assert moved.mean() <= 0.01
        np.testing.assert_array_equal(s_t.last_improve.numpy(),
                                      np.asarray(s_j.last_improve))
        assert s_t.steps == min(MAX_STEPS, -(-steps_j // check) * check)


def _pop_state(beam_cap, k, seed):
    """A seeded batch of 24 beams for the pop: values from a pool of four
    (ties), a third of the slots FLOAT_MAX holes (one row all holes), the
    results full in half the rows, a quarter of the queries done, the
    step counter at 41; and the constants the pop reads."""
    rng = np.random.default_rng(seed)
    q = 24
    pool = np.array([0.25, 1.0, 1.5, 4.0], np.float32)
    est = rng.choice(pool, (q, beam_cap)).astype(np.float32)
    est[rng.random((q, beam_cap)) < 1 / 3] = tbeam.FLOAT_MAX
    est[5] = tbeam.FLOAT_MAX
    res_d = np.full((q, k), tbeam.FLOAT_MAX, np.float32)
    res_d[::2] = rng.choice(pool, (q // 2, k))
    t = torch.from_numpy
    s = tbeam.BeamState(
        beam_ids=t(rng.integers(0, 10_000, (q, beam_cap)).astype(np.int32)),
        beam_est=t(est), beam_lower=t(rng.choice(pool, (q, beam_cap))),
        res_ids=None, res_d=t(res_d), visited=None,
        gamma_q=t(rng.choice(np.float32([1.0, 2.0, 5.0]), q)),
        ratio_sum=None, ratio_sq=None, ratio_cnt=None,
        slack_cnt=t(rng.integers(0, 6, q).astype(np.int32)),
        done=t(rng.random(q) < 0.25),
        steps=torch.tensor(41, dtype=torch.int32), last_improve=None,
        res_step=None)
    params = tbeam.SearchParams.default(device="cpu")._replace(
        slack_levels=torch.tensor([0.0, 0.5, 1.0, 2.0]))
    return s, params


@pytest.mark.parametrize("ew", [1, 4, 32, 33, 99, 100])
def test_plain_pop_selects_stably_and_counts_the_step(ew):
    """The plain pop at beam_cap 100 (not a multiple of 32) with FLOAT_MAX
    holes and ties, E from 1 to beam_cap: the popped slots are lax.top_k's
    (the lower slot first among equal values), every output follows from
    them as the JAX step derives it, and the step counter is steps + 1, a
    () int32 tensor."""
    beam_cap, k = 100, 10
    s, params = _pop_state(beam_cap, k, ew)
    c = tbeam._Consts(*[None] * 8, params=params, bits=1, k=k, r=1,
                      words=1, expand_width=ew, rw=1, h_size=0)
    pop = tbeam._pop_plain(s, c)
    est = s.beam_est.numpy()
    slots = np.asarray(jax.lax.top_k(-jnp.asarray(est), ew)[1])
    np.testing.assert_array_equal(
        slots, np.argsort(est, axis=1, kind="stable")[:, :ew])
    rows = np.arange(len(est))[:, None]
    pop_est = est[rows, slots]
    valid = pop_est < tbeam.FLOAT_MAX
    d_k = s.res_d.numpy()[:, k - 1]
    full = d_k < tbeam.FLOAT_MAX
    with np.errstate(over="ignore"):       # gamma * FLOAT_MAX, as torch
        done = s.done.numpy() | ~valid[:, 0] | (
            full & (pop_est[:, 0] >= s.gamma_q.numpy() * d_k))
    expand_e = (~done[:, None] & valid & ~(
        full[:, None] & (s.beam_lower.numpy()[rows, slots] > d_k[:, None])))
    ids = s.beam_ids.numpy()[rows, slots]
    want_est = est.copy()
    popped = np.zeros(est.shape, bool)
    popped[rows, slots] = valid
    want_est[~done[:, None] & popped] = tbeam.FLOAT_MAX
    np.testing.assert_array_equal(pop.beam_est.numpy(), want_est)
    np.testing.assert_array_equal(pop.done.numpy(), done)
    np.testing.assert_array_equal(pop.active.numpy(), ~done)
    np.testing.assert_array_equal(pop.expand_e.numpy(), expand_e)
    np.testing.assert_array_equal(pop.expand.numpy(), expand_e.any(1))
    np.testing.assert_array_equal(pop.pop_ids.numpy(), ids)
    np.testing.assert_array_equal(pop.cur_safe.numpy(),
                                  np.where(expand_e, ids, 0))
    np.testing.assert_array_equal(
        pop.slack_cnt.numpy(), s.slack_cnt.numpy() + expand_e.sum(1))
    np.testing.assert_array_equal(
        pop.dot_slack.numpy(),
        params.slack_levels.numpy()[np.minimum(s.slack_cnt.numpy(), 3)])
    assert pop.next_step.dtype == torch.int32 and pop.next_step.shape == ()
    assert int(pop.next_step) == 42 and int(s.steps) == 41
    assert expand_e.any() and (~valid).any() and done.any() and \
        (~done).any()


@pytest.mark.parametrize("rw", [8, 32, 100, 128])
def test_lane_sums_match_a_float32_loop(rw):
    """The gamma update's row sums (``_lane_sums``) equal a float32 loop
    in the kernel's order, bit for bit: lane l from +0.0 over the entries
    l, l + 32, ..., then the lanes folded at 16, 8, 4, 2, 1; with +0.0,
    -0.0 (a row of -0.0 alone sums to +0.0) and NaN entries."""
    rng = np.random.default_rng(rw)
    x = (rng.standard_normal((12, rw)) * 10.0 ** rng.integers(
        -3, 4, (12, rw))).astype(np.float32)
    x[0] = -0.0
    x[1, ::3] = 0.0
    x[2, ::2] = -0.0
    x[3, rw // 2] = np.nan
    want = np.zeros(12, np.float32)
    for row in range(12):
        lanes = [np.float32(0.0)] * 32
        for j in range(rw):
            lanes[j % 32] = np.float32(lanes[j % 32] + x[row, j])
        half = 16
        while half:
            lanes = [np.float32(lanes[i] + lanes[i + half])
                     for i in range(half)]
            half //= 2
        want[row] = lanes[0]
    got = tbeam._lane_sums(torch.from_numpy(x)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.int32)[~nan],
                                  want.view(np.int32)[~nan])
    assert got.view(np.int32)[0] == 0      # +0.0, not -0.0
    assert nan[3] and not nan[:3].any()


def test_merge_results_match_jax():
    """The merge's stable top-k of results and pushes: ties (FLOAT_MAX
    slots, repeated distances) go to the lower index, as lax.top_k's."""
    rng = np.random.default_rng(3)
    for k, width in ((10, 132), (100, 232), (4, 9)):
        q = 16
        pool = np.array([0.5, 1.0, 2.0, tbeam.FLOAT_MAX], np.float32)
        res_d = np.sort(rng.choice(pool, (q, k)), axis=1).astype(np.float32)
        cand_d = rng.choice(pool, (q, width)).astype(np.float32)
        res_ids = rng.integers(-1, 500, (q, k)).astype(np.int32)
        cand_ids = rng.integers(0, 500, (q, width)).astype(np.int32)
        res_step = rng.integers(0, 30, (q, k)).astype(np.int32)
        want = jbeam._merge_results(
            jnp.asarray(res_ids), jnp.asarray(res_d), jnp.asarray(res_step),
            jnp.asarray(cand_ids), jnp.asarray(cand_d), jnp.int32(31), k)
        got = tbeam._merge_results(
            *(torch.from_numpy(a) for a in (res_ids, res_d, res_step,
                                            cand_ids, cand_d)),
            torch.tensor(31, dtype=torch.int32), k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_expand_estimates_match_jax(indexes, data, bits):
    """The expansion's estimates of the first step's valid candidates
    equal the JAX package's fastscan, decode and bound functions on the
    same codes, query levels and parent distances, bit for bit; their
    lower bounds agree within the CPU sqrt's rounding."""
    _, tidx = indexes(bits, 16)
    s, c = tbeam._start(
        tidx._raw, tidx._norm_sq, tidx._neighbors, tidx._entry_candidates,
        tidx._signs, torch.from_numpy(_padded(tidx, data[1])), tidx._params,
        bits, 10, 40, 4, 4, 0, 0)
    pop = tbeam._pop_plain(s, c)
    d_qp_sq = torch.rand(pop.cur_safe.shape, generator=torch.Generator(
    ).manual_seed(bits)) * 40.0
    ex = tbeam._expand_plain(s, c, pop, d_qp_sq)
    q, er, r, p = d_qp_sq.shape[0], 4 * c.r, c.r, c.raw.shape[1]
    g = c.fused[pop.cur_safe]
    planes = g[..., 5 * r:(5 + bits * c.words) * r].reshape(
        q, 4, bits, c.words, r).permute(0, 1, 4, 2, 3)
    u = pack.unpack_planes(planes, p).reshape(q, er, p).numpy()
    aux = g[..., r:5 * r].view(torch.float32).reshape(
        q, 4, 4, r).permute(2, 0, 1, 3).reshape(4, q, er).numpy()
    q_u = c.q_u.numpy()
    coeff = [jnp.asarray(t.numpy()) for t in c.coeff]
    k_scale = float((1 << bits) - 1)
    ip_full = jest.ip_from_fastscan(jest.fastscan_sums(u, q_u), aux[3],
                                    *coeff, k_scale)
    if bits >= 2:
        u_msb = u >> (bits - 2)
        ip_bound = jest.ip_from_fastscan(jest.fastscan_sums(u_msb, q_u),
                                         u_msb.sum(-1), *coeff, 3.0)
    else:
        ip_bound = ip_full
    params = c.params
    calib = jest.CalibParams(
        affine_a=params.affine_a, affine_b=params.affine_b,
        ip_qo_floor=params.ip_qo_floor,
        dot_slack=jnp.asarray(pop.dot_slack.numpy())[:, None])
    est, lower = jest.distances_with_bounds(
        ip_full, ip_bound, aux[0], aux[1], aux[2],
        jnp.repeat(jnp.asarray(d_qp_sq.numpy()), r, axis=1), calib)
    valid = (ex.nbr_ids >= 0).numpy() & pop.expand_e.repeat_interleave(
        r, dim=1).numpy()
    assert valid.sum() > q * r
    np.testing.assert_array_equal(ex.est.numpy()[valid],
                                  np.asarray(est)[valid])
    # torch's CPU sqrt of d_qp^2 can round one ulp off the correctly
    # rounded root that XLA (and CUDA) give: the lower bound then moves by
    # at most a few ulps of nop^2 + d_qp^2, the terms it subtracts
    nop = aux[0]
    scale = (nop * nop + np.repeat(d_qp_sq.numpy(), r, axis=1))[valid]
    err = np.abs(ex.lower.numpy()[valid] - np.asarray(lower)[valid])
    assert (err <= 1e-6 * scale).all()


# the cell's (1M rows, R = 32, E = 4, 1 bit, P = 128), the step budget's
# k = 100, a graph shard's (E = 1) at k 10 and 100, the 7f rerank cap,
# 1536d's P, and (past the limits an earlier plan had) k = 250 and 2,500,
# R = 128 and P = 65,536: (pop, expand, merge) as (threads, workspace
# bytes, dynamic shared bytes, variant), 0 shared bytes where the
# workspace lives in global scratch (the pop, a warp per query, has none
# at any beam_cap); first as planned, then with the expansion and the
# merge generic (beam_step.GENERIC_ONLY)
PLAN_SHAPES = {
    "cell": ((1024, 64, 10, 4, 32, 128, 128, 1, 4),
             ((256, 0, 0, "warp"), (128, 8784, 8784, "bulk"),
              (192, 3376, 3376, "rank")),
             ((128, 3328, 3328), (256, 8640, 8640))),
    "k100": ((1024, 400, 100, 4, 32, 128, 128, 1, 4),
             ((256, 0, 0, "warp"), (128, 8784, 8784, "bulk"),
              (544, 8848, 8848, "rank")),
             ((128, 3328, 3328), (256, 19872, 19872))),
    "shard-k10": ((1024, 128, 10, 1, 32, 32, 128, 1, 4),
                  ((256, 0, 0, "warp"), (32, 2256, 2256, "bulk"),
                   (160, 2608, 2608, "rank")),
                  ((128, 1216, 1216), (256, 5136, 5136))),
    "shard-k100": ((128, 400, 100, 1, 32, 32, 128, 4, 4),
                   ((256, 0, 0, "warp"), (32, 3792, 3792, "bulk"),
                    (448, 7312, 7312, "rank")),
                   ((128, 1216, 1216), (256, 13088, 13088))),
    "rerank8": ((1024, 64, 10, 4, 32, 8, 128, 1, 4),
                ((256, 0, 0, "warp"), (128, 10704, 10704, "bulk"),
                 (192, 3376, 3376, "rank")),
                ((128, 4352, 4352), (256, 5408, 5408))),
    "p2048-e4-r64": ((512, 128, 10, 4, 64, 256, 2048, 2, 64),
                     ((256, 0, 0, "warp"),
                      (256, 145424, 145424, "bulk"),
                      (384, 6192, 6192, "rank")),
                     ((256, 13824, 13824), (256, 17088, 17088))),
    "k250": ((1024, 1000, 250, 4, 32, 128, 128, 1, 4),
             ((256, 0, 0, "warp"), (128, 8784, 8784, "bulk"),
              (256, 39136, 39136, "generic")),
             ((128, 3328, 3328), (256, 39136, 39136))),
    "k2500": ((64, 10000, 2500, 4, 32, 128, 128, 1, 4),
              ((256, 0, 0, "warp"), (128, 8784, 8784, "bulk"),
               (256, 317472, 0, "generic")),
              ((128, 3328, 3328), (256, 317472, 0))),
    "r128-rw8": ((64, 256, 10, 4, 128, 8, 128, 2, 4),
                 ((256, 0, 0, "warp"), (512, 49616, 49616, "bulk"),
                  (768, 11824, 11824, "rank")),
                 ((256, 15872, 15872), (256, 20000, 20000))),
    "p65536": ((16, 64, 10, 4, 32, 128, 65536, 1, 2048),
               ((256, 0, 0, "warp"), (128, 264960, 0, "generic"),
                (192, 3376, 3376, "rank")),
               ((128, 264960, 0), (256, 8640, 8640))),
}


@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_launch_plan_at_the_paths_shapes(shape):
    args, want, _ = PLAN_SHAPES[shape]
    plan = beam_step.launch_plan(*args)
    assert tuple(tuple(p) for p in plan) == want
    for p in plan:
        assert p.smem == (p.workspace if p.workspace <=
                          beam_step.SMEM_PER_BLOCK else 0)


@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_generic_only_plans_the_generic_kernels(shape, monkeypatch):
    """With GENERIC_ONLY the expansion and the merge are the generic
    kernels, planned as before their Hopper variants; the pop has one
    variant, the warp pop, at every shape."""
    args, want, generic = PLAN_SHAPES[shape]
    monkeypatch.setattr(beam_step, "GENERIC_ONLY", True)
    plan = beam_step.launch_plan(*args)
    assert tuple(plan.pop) == want[0]
    assert tuple(tuple(p) for p in plan[1:]) == tuple(
        g + ("generic",) for g in generic)


# (q, beam_cap, k, E, R, rw, P, bits, words): the variant of the expansion
# and the merge, with E*R not a multiple of 32 (R = 24, E = 3; R = 5), the
# shard's E = 1, rw < E*R, 1 to 4 bits, and the largest Hopper shapes
VARIANT_SHAPES = {
    "r24-e3": ((64, 48, 10, 3, 24, 72, 128, 2, 4), "bulk", "rank", 96, 128),
    "r24-e3-rw8": ((64, 48, 10, 3, 24, 8, 128, 4, 4), "bulk", "rank", 96,
                   128),
    "r5-e1-p40": ((64, 16, 10, 1, 5, 5, 40, 3, 2), "bulk", "rank", 32, 32),
    "e1-dense-k100": ((64, 400, 100, 1, 32, 32, 128, 1, 4), "bulk", "rank",
                      32, 448),
    "er1024": ((64, 64, 10, 8, 128, 1024, 128, 1, 4), "bulk", "generic",
               1024, 256),
    "er1056": ((64, 64, 10, 33, 32, 1056, 128, 1, 4), "generic", "generic",
               256, 256),
    "beam768": ((64, 640, 10, 4, 32, 128, 128, 1, 4), "bulk", "rank", 128,
                768),
    "beam769": ((64, 641, 10, 4, 32, 128, 128, 1, 4), "bulk", "generic",
                128, 256),
    "res1056": ((64, 200, 900, 4, 32, 128, 128, 1, 4), "bulk", "generic",
                128, 256),
}


@pytest.mark.parametrize("shape", list(VARIANT_SHAPES))
def test_launch_plan_chooses_the_variant_by_shape(shape):
    """The Hopper variants take a shape where one thread an entry fits a
    block (E*R within 1,024 and both merge sorts within 768, in whole
    warps: the kernels' launch bounds) and the workspace fits in shared
    memory; the generic kernels take the rest."""
    args, expand, merge, expand_threads, merge_threads = VARIANT_SHAPES[shape]
    plan = beam_step.launch_plan(*args)
    q, beam_cap, k, ew, r, rw, p, bits, words = args
    er = ew * r
    assert (plan.expand.variant, plan.merge.variant) == (expand, merge)
    assert (plan.expand.threads, plan.merge.threads) == (expand_threads,
                                                         merge_threads)
    if expand == "bulk":
        # the popped rows' used spans (16-byte multiples) alone
        row = -(-(5 + bits * words) * r // 4) * 16
        assert plan.expand.workspace >= ew * row + 16 * words
        assert plan.expand.threads >= er and plan.expand.threads % 32 == 0
        assert plan.expand.smem == plan.expand.workspace
    if merge == "rank":
        entries = max(k + rw + ew, beam_cap + er)
        assert entries <= plan.merge.threads < entries + 32
        assert plan.merge.workspace >= 12 * plan.merge.threads + 4 * (k + er)
        assert plan.merge.smem == plan.merge.workspace


def test_launch_plan_takes_generic_where_shared_memory_is_short(
        monkeypatch):
    """A Hopper variant runs from shared memory only: below its workspace
    the plan names the generic kernel, which works from global scratch;
    rows that are not 16-byte aligned (no bulk copy) take it too."""
    args = PLAN_SHAPES["cell"][0]
    plan = beam_step.launch_plan(*args)
    monkeypatch.setattr(beam_step, "SMEM_PER_BLOCK",
                        min(plan.expand.workspace, plan.merge.workspace) - 1)
    small = beam_step.launch_plan(*args)
    assert (small.expand.variant, small.merge.variant) == ("generic",
                                                          "generic")
    assert small.expand.workspace < plan.expand.workspace
    monkeypatch.setattr(beam_step, "SMEM_PER_BLOCK", 0)
    none = beam_step.launch_plan(*args)
    assert all(p.smem == 0 and p.variant == "generic" for p in none[1:])
    assert none.pop == plan.pop and plan.pop.smem == 0   # no workspace
    monkeypatch.undo()
    q, beam_cap, k, ew, r, rw, p, bits, words = args
    assert beam_step.expand_plan(q, ew, r, rw, p, bits, words,
                                 rows_aligned=False).variant == "generic"


@pytest.mark.parametrize("args", [
    (64, 64, 10, 5, 64, 320, 128, 1, 4),       # E * R = 320 candidates
    (64, 900, 100, 4, 32, 128, 128, 1, 4),     # beam sort of 1028
    (64, 400, 900, 4, 32, 128, 128, 1, 4),     # result sort of 1032
    (64, 64, 10, 4, 32, 128, 8192, 1, 256),    # P = 8192
], ids=["er320", "beam1028", "res1032", "p8192"])
def test_launch_plan_takes_the_shapes_past_the_old_limits(args):
    """Shapes an earlier plan refused (E*R above 256, sorts above 1,024,
    P above 4,096) that Index and the plain step take: each launch gets a
    workspace that holds its sorts, in shared memory or global scratch
    (the generic merge: both sorts' entries and their values; the rank
    merge: a run entry and a rank a thread, one thread an entry of the
    larger sort; the pop, a warp a query, needs none)."""
    plan = beam_step.launch_plan(*args)
    q, beam_cap, k, ew, r, rw, p = args[:7]
    assert tuple(plan.pop) == (beam_step.WARP_THREADS, 0, 0, "warp")
    assert plan.expand.workspace >= 4 * p + 22 * ew * r
    if plan.merge.variant == "rank":
        assert plan.merge.threads >= max(k + rw + ew, beam_cap + ew * r)
        assert plan.merge.workspace >= 12 * plan.merge.threads
    else:
        assert plan.merge.workspace >= 20 * (k + rw + ew + beam_cap + ew * r)


@pytest.mark.parametrize("args", [
    (0, 64, 10, 4, 32, 128, 128, 1, 4),        # no query
    (64, 64, 10, 4, 32, 200, 128, 1, 4),       # rerank width above E * R
    (64, 64, 10, 4, 32, 128, 128, 8, 4),       # 8 bit planes
    (64, 64, 10, 4, 32, 128, 128, 1, 5),       # words that P does not fill
    (64, 2, 10, 4, 32, 128, 128, 1, 4),        # more pops than slots
    (64, 64, 0, 4, 32, 128, 128, 1, 4),        # no result
    (64, 64, 10, 0, 32, 128, 128, 1, 4),       # no pop
    (64, 64, 10, 4, 32, 128, 74_566, 1, 2331),  # fastscan sums past 2^24
], ids=["q0", "rw200", "bits8", "words", "pops", "k0", "e0", "p74566"])
def test_launch_plan_rejects_shapes_beyond_the_limits(args):
    with pytest.raises(ValueError):
        beam_step.launch_plan(*args)


def _state(tidx, data, **kw):
    opts = dict(bits=tidx._bits, k=10, beam_cap=64, n_seeds=4,
                expand_width=4, rerank_width=0, visited_hash_bits=0)
    opts.update(kw)
    return tbeam._start(
        tidx._raw, tidx._norm_sq, tidx._neighbors, tidx._entry_candidates,
        tidx._signs, torch.from_numpy(_padded(tidx, data[1])), tidx._params,
        **opts)


def _launches(s, c, pop, d_qp_sq, ex, exact_rr, ratio):
    """A call of each launcher on the state's tensors, as the step's CUDA
    segments make them."""
    p = c.params
    return {
        "pop": lambda: beam_step.beam_pop(
            s.beam_est, s.beam_ids, s.beam_lower, s.res_d, s.gamma_q,
            s.done, s.slack_cnt, p.slack_levels, s.steps, c.expand_width),
        "expand": lambda: beam_step.beam_expand(
            c.fused, c.q_u, *(t.squeeze(1) for t in c.coeff), s.res_d,
            pop.active, pop.expand_e, pop.cur_safe, pop.dot_slack, d_qp_sq,
            s.visited, r=c.r, bits=c.bits, words=c.words, rw=c.rw,
            affine_a=p.affine_a, affine_b=p.affine_b,
            ip_qo_floor=p.ip_qo_floor),
        "merge": lambda: beam_step.beam_merge(
            s.res_ids, s.res_d, s.res_step, s.last_improve, pop.beam_est,
            s.beam_ids, s.beam_lower, s.gamma_q, pop.next_step, pop.active,
            pop.expand, pop.expand_e, pop.pop_ids, pop.cur_safe, d_qp_sq,
            *ex, exact_rr),
        "gamma": lambda: beam_step.beam_gamma(
            s.ratio_sum, s.ratio_sq, s.ratio_cnt, s.gamma_q, pop.expand,
            ratio, ratio > 0, p.gamma, p.gamma_max, p.gamma_beta,
            p.gamma_warmup),
    }


def _plain_segments(s, c):
    pop = tbeam._pop_plain(s, c)
    d_qp_sq = torch.ones(pop.cur_safe.shape)
    ex = tbeam._expand_plain(s, c, pop, d_qp_sq)
    exact_rr = torch.ones(ex.rr_node.shape)
    return pop, d_qp_sq, ex, exact_rr, torch.zeros(exact_rr.shape)


def test_cuda_state_beyond_the_limits_raises_before_a_launch(
        indexes, data, monkeypatch):
    """A shape the kernels refuse raises on a CUDA device from the plan,
    before any library is loaded (the device is faked: no card)."""
    _, tidx = indexes(1, 16)
    s, c = _state(tidx, data, rerank_width=8)
    segments = _plain_segments(s, c)

    def no_library(*a, **kw):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(beam_step, "load_library", no_library)
    monkeypatch.setattr(beam_step, "_cuda", lambda t: torch.device("cuda", 0))
    # more pops than beam slots; a rerank width above E * R; 8 bit planes
    calls = _launches(s, c._replace(expand_width=65), *segments)
    with pytest.raises(ValueError, match="outside 1..beam_cap"):
        calls["pop"]()
    calls = _launches(s, c._replace(rw=65, bits=8), *segments)
    with pytest.raises(ValueError, match="rerank width 65"):
        calls["expand"]()
    pop, d_qp_sq, ex, exact_rr, ratio = segments
    calls = _launches(s, c, pop, d_qp_sq, ex, torch.ones(
        (exact_rr.shape[0], 65)), ratio)
    with pytest.raises(ValueError, match="rerank width 65"):
        calls["merge"]()


def test_launchers_refuse_cpu_tensors(indexes, data, monkeypatch):
    """A launcher takes CUDA tensors only: on CPU tensors each raises
    before a plan, a library or a count (the step runs its plain segments
    there)."""
    _, tidx = indexes(1, 16)
    s, c = _state(tidx, data, rerank_width=8, visited_hash_bits=13)

    def no_library(*a, **kw):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(beam_step, "load_library", no_library)
    counts = (beam_step.pop_launches, beam_step.expand_launches,
              beam_step.merge_launches, beam_step.gamma_launches)
    for name, call in _launches(s, c, *_plain_segments(s, c)).items():
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert (beam_step.pop_launches, beam_step.expand_launches,
            beam_step.merge_launches, beam_step.gamma_launches) == counts


def test_cpu_search_builds_and_launches_nothing(indexes, data, monkeypatch):
    """On the CPU the step runs the plain versions: no nvcc, no library,
    no launch counted; the result is the plain step's."""
    _, tidx = indexes(1, 16)

    def no_build(*a, **kw):
        raise AssertionError("a library was built or loaded on the CPU")

    monkeypatch.setattr(nvcc, "build_library", no_build)
    monkeypatch.setattr(nvcc, "load", no_build)
    monkeypatch.setattr(beam_step, "load_library", no_build)
    counts = (beam_step.pop_launches, beam_step.expand_launches,
              beam_step.merge_launches, beam_step.gamma_launches)
    s, c = _state(tidx, data, visited_hash_bits=13, rerank_width=8)
    t, u = _state(tidx, data, visited_hash_bits=13, rerank_width=8)
    for _ in range(12):
        s = tbeam._step(s, c)
        t = tbeam._plain_step(t, u)
    for name, a, b in zip(tbeam.BeamState._fields, s, t):
        assert torch.equal(a, b), name
    assert (beam_step.pop_launches, beam_step.expand_launches,
            beam_step.merge_launches, beam_step.gamma_launches) == counts
