"""The port's graph build against the JAX package: evt, pruning, stats,
host ops, edge codes and NNDescent.

Inputs are made with numpy from a seed and go through both packages on
the CPU.  NNDescent draws from a torch.Generator in the port and from
Threefry in JAX, so the working graphs differ and are compared by quality;
every stage after it is fed the JAX package's own working graph and held
to its output on that same input.  Each tolerance is stated where it is
checked, with its reason.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cphnsw_tpu.calibration import evt as jevt
from cphnsw_tpu.graph import build as jbuild
from cphnsw_tpu.graph import nndescent as jnnd
from cphnsw_tpu.graph import pruning as jprune
from cphnsw_tpu.graph import stats as jstats
from cphnsw_tpu.ops import hadamard as jhad
from cphnsw_tpu_torch.calibration import evt as tevt
from cphnsw_tpu_torch.graph import build as tbuild
from cphnsw_tpu_torch.graph import nndescent as tnnd
from cphnsw_tpu_torch.graph import pruning as tprune
from cphnsw_tpu_torch.graph import stats as tstats
from cphnsw_tpu_torch.ops import hadamard as thad
from cphnsw_tpu_torch.utils import native as tnative

torch.set_num_threads(2)

N, DIM, R = 2000, 32, 16
# A store of several NNDescent chunks with a tail: 1024-node chunks (the
# floor of _chunk_for) over 2500 nodes.
N_CHUNKED, CHUNK = 2500, 1024
# Share of equal plane words between the packages' edge codes: a code can
# flip where a coordinate sits on a rounding or sign tie after sums taken
# in another order.  Also the share of working-graph rows whose edge sets
# are equal: the packages sum a candidate's distance in another order, so
# a near tie at rank R can flip.
MIN_EQUAL = 0.999
# Candidate distances |x|^2 + |c|^2 - 2<x, c>: the dot products are summed
# in another order, so they agree within 1e-6 of the norms the subtraction
# cancels, not of the distance.
DIST_RTOL = 1e-6


def clustered(seed, n, dim, n_clusters=24):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 4.0
    return centers[rng.integers(0, n_clusters, n)] + rng.standard_normal(
        (n, dim)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def key_of(jkey):
    """A JAX raw PRNG key as the port's (word, word) key."""
    return tuple(int(w) for w in np.asarray(jkey))


def edge_sets_equal(a, b) -> np.ndarray:
    """Per row: the two (N, R) id matrices hold the same set of edges."""
    return (np.sort(np.asarray(a), 1) == np.sort(np.asarray(b), 1)).all(1)


def assert_dists_close(got, want, ids, norm_sq):
    """Distances within DIST_RTOL of |x|^2 + |c|^2 wherever the JAX slot
    holds an edge; both sides FLOAT_MAX where it is empty."""
    got, want, ids = np.asarray(got), np.asarray(want), np.asarray(ids)
    valid = ids >= 0
    scale = norm_sq[:, None] + norm_sq[np.maximum(ids, 0)]
    assert (np.abs(got - want)[valid] <= DIST_RTOL * scale[valid]).all()
    np.testing.assert_array_equal(got[~valid], want[~valid])


@pytest.fixture(scope="module")
def data():
    x = clustered(5, N, DIM)
    norm_sq = (x.astype(np.float32) ** 2).sum(1).astype(np.float32)
    nop = np.linalg.norm(x - x.mean(0), axis=1).astype(np.float32)
    return x, norm_sq, nop


@pytest.fixture(scope="module")
def jax_wg(data):
    x, norm_sq, _ = data
    return jnnd.run_adaptive(jnp.asarray(x), jnp.asarray(norm_sq), R, seed=3)


@pytest.fixture(scope="module")
def chunked_data():
    x = clustered(7, N_CHUNKED, DIM)
    return x, (x ** 2).sum(1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_build(data):
    """The JAX package's full build at 1 bit (BFS-permuted graph)."""
    x, norm_sq, nop = data
    signs = jhad.rotation_signs(42, DIM)
    return jbuild.build_graph(jnp.asarray(x), jnp.asarray(norm_sq),
                              jnp.asarray(nop), signs, bits=1, r=R)


# ------------------------------------------------------------------ evt
def _residuals(kind):
    rng = np.random.default_rng(11)
    if kind == "exponential":
        return rng.exponential(2.0, 20_000)
    if kind == "pareto":
        return rng.pareto(3.0, 20_000)
    if kind == "mixture":     # a tail the KS test rejects
        return np.concatenate([rng.exponential(1.0, 15_000),
                               10.0 + rng.uniform(0, 1, 5_000)])
    return rng.exponential(1.0, 100)        # "small": too short to fit


@pytest.mark.parametrize("kind", ["exponential", "pareto", "mixture",
                                  "small"])
def test_evt_matches_jax(kind):
    # identical numpy inputs through identical numpy code: rtol 1e-9
    resid = _residuals(kind)
    want = jevt.fit_gpd_stable(resid, 64).to_dict()
    got = tevt.fit_gpd_stable(resid, 64).to_dict()
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   err_msg=key)
    st_j = jevt.EVTState.from_dict(want)
    st_t = tevt.EVTState.from_dict(got)
    for alpha in (0.3, 1e-2, 1e-4, 1e-7):
        np.testing.assert_allclose(tevt.evt_quantile(alpha, st_t),
                                   jevt.evt_quantile(alpha, st_j), rtol=1e-9)


# -------------------------------------------------------------- pruning
def _jax_candidates(data, jax_wg):
    """The JAX package's deduped, distance-sorted candidate lists of the
    reverse+prune stage: pruned lists plus capped reverse edges."""
    x, norm_sq, nop = data
    raw, ns = jnp.asarray(x), jnp.asarray(norm_sq)
    ci, cd = jprune.prepare_candidates(jax_wg.ids, jax_wg.dists)
    pd = jprune.candidate_pair_dists(raw, ns, ci)
    sel, sel_d = jprune.select_alpha_cng(ci, cd, pd, jnp.zeros_like(cd),
                                         1.2, 0.1, 2.4, R)
    rev, rev_d = jbuild._reverse_candidates(sel, sel_d, 2 * R)
    return (jnp.concatenate([sel, rev], axis=1),
            jnp.concatenate([sel_d, rev_d], axis=1))


def test_prepare_candidates_and_pair_dists(data, jax_wg):
    x, norm_sq, _ = data
    ids, dists = _jax_candidates(data, jax_wg)
    ci_j, cd_j = jprune.prepare_candidates(ids, dists)
    ci_t, cd_t = tprune.prepare_candidates(t(ids), t(dists))
    # dedup + stable sorts on identical inputs: equal
    np.testing.assert_array_equal(ci_t.numpy(), np.asarray(ci_j))
    np.testing.assert_array_equal(cd_t.numpy(), np.asarray(cd_j))

    pd_j = np.asarray(jprune.candidate_pair_dists(
        jnp.asarray(x), jnp.asarray(norm_sq), ci_j))
    pd_t = tprune.candidate_pair_dists(t(x), t(norm_sq), ci_t).numpy()
    ci = np.asarray(ci_j)
    valid = (ci >= 0)[:, :, None] & (ci >= 0)[:, None, :]
    assert ((pd_t >= 3e38) == ~valid).all()
    # |a|^2 + |b|^2 - 2<a, b> summed in another order: rtol 1e-5 of the
    # norms the subtraction cancels
    ns = norm_sq[np.maximum(ci, 0)]
    scale = ns[:, :, None] + ns[:, None, :]
    assert (np.abs(pd_t - pd_j)[valid] <= 1e-5 * scale[valid]).all()


def test_select_alpha_cng_ids_equal(data, jax_wg):
    x, norm_sq, nop = data
    ids, dists = _jax_candidates(data, jax_wg)
    ci, cd = jprune.prepare_candidates(ids, dists)
    # tie-free inputs: both packages get the same pair distances
    pd = jprune.candidate_pair_dists(jnp.asarray(x), jnp.asarray(norm_sq), ci)
    err = jnp.where(ci >= 0, 0.2 * jnp.asarray(nop)[jnp.maximum(ci, 0)], 0.0)
    args = (1.3, 0.5, 2.6, R)
    sel_j, sd_j = jprune.select_alpha_cng(ci, cd, pd, err, *args)
    sel_t, sd_t = tprune.select_alpha_cng(t(ci), t(cd), t(pd), t(err), *args)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(sd_t.numpy(), np.asarray(sd_j))


def test_graph_stats_match(data, jax_wg):
    x, norm_sq, _ = data
    want = jstats.derive_graph_stats(jnp.asarray(x), jnp.asarray(norm_sq),
                                     jax_wg.ids, jax_wg.dists, 44)
    got = tstats.derive_graph_stats(t(x), t(norm_sq), t(jax_wg.ids),
                                    t(jax_wg.dists), 44)
    # the same numpy sample; inter-neighbour distances differ by f32
    # summation order only: rtol 1e-5
    np.testing.assert_allclose(
        [got.avg_degree, got.alpha, got.tau, got.alpha_max],
        [want.avg_degree, want.alpha, want.tau, want.alpha_max], rtol=1e-5)


# ------------------------------------------------------------- host ops
def test_host_ops_match(data, jax_wg):
    x, norm_sq, _ = data
    assert tnative.load() is not None, "the C compiler builds hostops.c"
    ids = np.asarray(jax_wg.ids)
    dists = np.asarray(jax_wg.dists)
    rev_j = jbuild._reverse_candidates(jnp.asarray(ids), jnp.asarray(dists),
                                       2 * R)
    rev_t = tbuild._reverse_candidates(t(ids), t(dists), 2 * R)
    for got, want in zip(rev_t, rev_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    centroid = x.mean(0)
    hub_j = jbuild.find_hub_entry(jnp.asarray(x), jnp.asarray(norm_sq),
                                  jnp.asarray(centroid), jnp.asarray(ids))
    assert tbuild.find_hub_entry(t(x), t(centroid), t(ids)) == hub_j
    np.testing.assert_array_equal(tbuild.bfs_order(ids, hub_j),
                                  jbuild.bfs_order(ids, hub_j))


def test_host_op_fallbacks_match_native(data, jax_wg, monkeypatch):
    ids = np.asarray(jax_wg.ids)
    dists = np.asarray(jax_wg.dists)
    nat_rev = tbuild._reverse_candidates(t(ids), t(dists), 2 * R)
    nat_bfs = tbuild.bfs_order(ids, 7)
    monkeypatch.setattr(tnative, "load", lambda: None)
    np_rev = tbuild._reverse_candidates(t(ids), t(dists), 2 * R)
    # the C heap keeps its own slot order: compare each row as a set
    for a, b in zip(nat_rev[0].numpy(), np_rev[0].numpy()):
        assert sorted(a) == sorted(b)
    np.testing.assert_array_equal(np.sort(nat_rev[1].numpy(), 1),
                                  np.sort(np_rev[1].numpy(), 1))
    np_bfs = tbuild.bfs_order(ids, 7)
    assert sorted(np_bfs.tolist()) == list(range(len(ids)))
    assert np_bfs[7] == nat_bfs[7] == 0


# ----------------------------------------------------------- edge codes
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_encode_neighbor_blocks_match(jax_build, bits):
    raw = np.asarray(jax_build.raw)
    ids = np.asarray(jax_build.neighbors.ids)
    signs = jhad.rotation_signs(42, DIM)
    want = jbuild.encode_neighbor_blocks(jnp.asarray(raw), jnp.asarray(ids),
                                         signs, bits)
    got = tbuild.encode_neighbor_blocks(t(raw), t(ids),
                                        thad.rotation_signs(42, DIM), bits)
    planes_j = np.asarray(want.planes)
    planes_t = got.planes.contiguous().numpy().view(np.uint32)
    assert planes_t.shape == planes_j.shape
    assert (planes_t == planes_j).mean() >= MIN_EQUAL
    # where every plane word of an edge agrees, so does its wpc, and nop,
    # ip_qo, ip_cp agree to f32 summation order: rtol 1e-5 of the
    # channel's scale (ip_cp sums signed terms and can sit near 0)
    same = (planes_t == planes_j).all(axis=(2, 3))
    aux_t, aux_j = got.aux.numpy(), np.asarray(want.aux)
    scale = np.abs(aux_j).max(axis=(0, 1))
    assert (np.abs(aux_t - aux_j)[same] <= 1e-5 * scale).all()
    # the fused rows are the JAX layout: byte-equal outside differing codes
    fused_t, fused_j = got.fused.numpy(), np.asarray(want.fused)
    assert fused_t.shape == fused_j.shape and fused_t.shape[1] % 128 == 0
    np.testing.assert_array_equal(fused_t[:, :R], fused_j[:, :R])
    rows = same.all(axis=1)
    np.testing.assert_array_equal(fused_t[rows, 5 * R:],
                                  fused_j[rows, 5 * R:])
    assert rows.mean() >= 0.95


# ----------------------------------------------------------- nndescent
@pytest.mark.parametrize("chunked", [False, True])
def test_init_random_matches_jax(data, chunked_data, chunked):
    """The derived chunk (one chunk at n = 2000), and chunk=1024 at
    n = 2500: three chunks, each from its own split key, the last a tail
    that draws the first values of its key."""
    x, norm_sq = chunked_data if chunked else data[:2]
    kw = dict(seed=3, chunk=CHUNK if chunked else None)
    want = jnnd.init_random(jnp.asarray(x), jnp.asarray(norm_sq), R, **kw)
    got = tnnd.init_random(t(x), t(norm_sq), R, **kw)
    # the same draws, each row's pool kept in the same order: ids equal
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.flags.numpy(), np.asarray(want.flags))
    assert_dists_close(got.dists, want.dists, want.ids, norm_sq)


@pytest.mark.parametrize("case", ["working_graph", "all_old"])
def test_prefer_new_sample_matches_jax(jax_wg, case):
    """The sampler's noise is the key's uniforms, scored bucket + 0.999 *
    noise with one rounding, as XLA-CPU contracts it inside the jitted
    join (op by op, JAX rounds twice): equal samples.  In the all-old case
    (16384 rows of 16 old entries, key 28) row 7133 samples otherwise if
    the score is rounded twice."""
    if case == "working_graph":
        ids, flags = np.asarray(jax_wg.ids), np.asarray(jax_wg.flags)
        flags = flags & (np.arange(N)[:, None] % 3 > 0)    # some old ones
        ids = np.where(np.arange(R)[None] % 5 == 4, -1, ids)  # some empty
        key = jax.random.PRNGKey(21)
    else:
        ids = np.tile(np.arange(16, dtype=np.int32), (16384, 1))
        flags = np.zeros(ids.shape, bool)
        key = jax.random.PRNGKey(28)
    sample = jax.jit(jnnd._prefer_new_sample, static_argnums=2)
    want, _ = sample(jnp.asarray(ids), jnp.asarray(flags), tnnd.SAMPLE_FWD,
                     key)
    got = tnnd._prefer_new_sample(t(ids), t(flags), tnnd.SAMPLE_FWD,
                                  key_of(key))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _heavy_in_degree():
    """Ids drawn from 0..19 on 200 rows of 8: every target has far more
    than r_rev sources."""
    rng = np.random.default_rng(4)
    return rng.integers(0, 20, (200, 8)).astype(np.int32)


@pytest.mark.parametrize("case", ["working_graph", "heavy_in_degree"])
@pytest.mark.parametrize("r_rev", [2, 16])
def test_reverse_lists_match_jax(jax_wg, case, r_rev):
    ids = np.asarray(jax_wg.ids) if case == "working_graph" \
        else _heavy_in_degree()
    key = jax.random.split(jax.random.PRNGKey(9))[1]
    want = np.asarray(jnnd.reverse_lists(jnp.asarray(ids), key, r_rev))
    got = tnnd.reverse_lists(t(ids), key_of(key), r_rev).numpy()
    # integer draws and stable sorts: equal, the -1 last slots included
    np.testing.assert_array_equal(got, want)
    if case == "heavy_in_degree":
        assert (want[:20, r_rev - 1] == -1).all()


@pytest.mark.parametrize("chunked", [False, True])
def test_join_round_matches_jax(data, chunked_data, jax_wg, chunked,
                                monkeypatch):
    """One round with the same round key: on JAX's working graph (one
    chunk), and from JAX's chunk=1024 random init at n = 2500 with
    JOIN_CHUNK = 1024 in both packages (three chunks, each from the next
    key of the chain, and a tail)."""
    if chunked:
        x, norm_sq = chunked_data
        monkeypatch.setattr(jnnd, "JOIN_CHUNK", CHUNK)
        monkeypatch.setattr(tnnd, "JOIN_CHUNK", CHUNK)
        wg = jnnd.init_random(jnp.asarray(x), jnp.asarray(norm_sq), R,
                              seed=5, chunk=CHUNK)
    else:
        x, norm_sq = data[:2]
        wg = jax_wg
    key = jax.random.PRNGKey(17)
    want, upd_j = jnnd.join_round(jnp.asarray(x), jnp.asarray(norm_sq), wg,
                                  R, key)
    got, upd_t = tnnd.join_round(t(x), t(norm_sq),
                                 tnnd.WorkingGraph(*map(t, wg)), R,
                                 key_of(key))
    ids_j, ids_t = np.asarray(want.ids), got.ids.numpy()
    same = (ids_t == ids_j).all(1)
    # the same samples and candidates everywhere; where the packages'
    # distances flip a near tie at rank R a row differs, at most 0.1% of
    # rows, each changing at most R flags of the update count
    assert same.mean() >= MIN_EQUAL, f"{(~same).sum()} of {len(same)} rows"
    np.testing.assert_array_equal(got.flags.numpy()[same],
                                  np.asarray(want.flags)[same])
    assert abs(upd_t - upd_j) <= R * (~same).sum(), (upd_t, upd_j)
    # even on a flipped row the kept distances are those of a near tie
    assert_dists_close(got.dists, want.dists, want.ids, norm_sq)


def test_nndescent_quality_matches_jax(data, jax_wg):
    x, norm_sq, _ = data
    wg = tnnd.run_adaptive(t(x), t(norm_sq), R, seed=3)
    got = tnnd.knn_graph_recall(wg, x, k=10)
    want = jnnd.knn_graph_recall(jax_wg, x, k=10)
    assert got >= want - 0.02, (got, want)
    # JAX's keys in JAX's order: the JAX package's graph, up to near ties
    same = edge_sets_equal(wg.ids.numpy(), jax_wg.ids)
    assert same.mean() >= MIN_EQUAL, f"{(~same).sum()} of {N} rows differ"
    ids = wg.ids.numpy()
    assert not (ids == np.arange(N)[:, None]).any()
    for row in ids:
        v = row[row >= 0]
        assert len(np.unique(v)) == len(v)
    d = np.where(ids >= 0, wg.dists.numpy(), np.inf)
    assert np.all(np.diff(d, axis=1) >= 0)


@pytest.mark.parametrize("r_rev", [2, 16])
def test_reverse_lists_are_capped_in_edges(data, jax_wg, r_rev):
    ids = t(jax_wg.ids)
    rev = tnnd.reverse_lists(ids, key_of(jax.random.PRNGKey(0)),
                             r_rev).numpy()
    fwd = ids.numpy()
    assert rev.shape == (N, r_rev)
    in_deg = np.bincount(fwd[fwd >= 0], minlength=N)
    for v in range(N):
        srcs = rev[v][rev[v] >= 0]
        # every source is a real in-edge, each once; an over-full target
        # keeps r_rev - 1 and -1 in its last slot, as the JAX package does
        assert all(v in fwd[s] for s in srcs)
        assert len(np.unique(srcs)) == len(srcs)
        if in_deg[v] <= r_rev:
            assert len(srcs) == in_deg[v]
        else:
            assert len(srcs) == r_rev - 1 and rev[v, -1] == -1


def test_build_graph_end_to_end(data):
    x, norm_sq, nop = data
    res = tbuild.build_graph(t(x), t(norm_sq), t(nop),
                             thad.rotation_signs(42, DIM), bits=1, r=R)
    ids = res.neighbors.ids.numpy()
    assert ids.shape == (N, R) and 0 <= res.entry_point < N
    assert sorted(res.old_to_new.tolist()) == list(range(N))
    assert (ids >= 0).sum(1).mean() > 12
    # the permuted arrays follow the permutation
    new_to_old = np.argsort(res.old_to_new)
    np.testing.assert_array_equal(res.raw.numpy(), x[new_to_old])
    # edge nop is the parent-neighbour distance
    xp = res.raw.numpy()
    nop_e = res.neighbors.aux.numpy()[..., 0]
    sel = ids >= 0
    want = np.linalg.norm(xp[np.maximum(ids, 0)] - xp[:, None, :], axis=-1)
    np.testing.assert_allclose(nop_e[sel], want[sel], rtol=1e-4, atol=1e-4)
    assert set(res.stages) == {"nndescent", "stats", "prune",
                               "reverse+prune", "reorder", "encode_blocks"}
