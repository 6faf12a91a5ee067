"""The port's chunked and exact scan selections, its bf16 sketch and the
two-stage rerank against the JAX package's, on the same store.

One JAX ScanIndex (n = 20,000, dim = 32, 1 bit) is built; the port loads
that very state, so both packages select from the same codes and
constants.  The chunk plan is passed in directly: 4 chunks of 4,096 rows
(more than the JAX package's MAX_UNROLL = 2, so its chunks run in a
lax.scan) and a remainder of 3,840.  Keys are compared in the JAX
package's u32 convention (the port's signed key ^ 0x80000000).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cphnsw_tpu.api.scan_index import ScanIndex as JScanIndex
from cphnsw_tpu.search import scan as jscan
from cphnsw_tpu_torch import ScanIndex
from cphnsw_tpu_torch.search import scan as tscan

from test_torch_scan_index import clustered, jax_state, overlap

torch.set_num_threads(2)

N, DIM, Q, K = 20_000, 32, 48, 10
PLAN = dict(chunk=4096, n_eq=4, rem=3840)
MIN_OVERLAP = 0.99
# keys of each package's own chunk scores: >= 99.9% equal
MIN_KEY_EQUAL = 0.999


@pytest.fixture(autouse=True)
def one_thread():
    """Run each test's torch CPU work on one thread: on some hosts a CPU
    pool thread has been seen to round its part of a parallel f32 op (a
    sqrt) one ulp differently, which makes bit-level comparisons flaky."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    base = clustered(3, N, DIM, n_clusters=24)
    rng = np.random.default_rng(4)
    queries = base[rng.choice(N, Q, replace=False)] + 0.05 * \
        rng.standard_normal((Q, DIM)).astype(np.float32)
    jidx = JScanIndex(DIM, bits=1).build(base).finalize()
    tidx = ScanIndex(DIM, bits=1, device="cpu").load_state(*jax_state(jidx))
    return jidx, tidx, queries


def to_u32(keys: torch.Tensor) -> np.ndarray:
    return keys.numpy().view(np.uint32) ^ np.uint32(0x80000000)


def search_both(pair, top_c, *, k=K, sketch=None, **kw):
    """(port ids, port dists, JAX ids, JAX dists) of scan_search on the
    same queries; `sketch` is None, "bf16" or "int8"."""
    jidx, tidx, queries = pair
    sk_j = sk_t = None
    if sketch is not None:
        sk_j = jscan.make_rerank_sketch(jidx._arrays.raw,
                                        jidx._arrays.norm_sq,
                                        force_int8=sketch == "int8")
        sk_t = tscan.make_rerank_sketch(tidx._arrays.raw,
                                        tidx._arrays.norm_sq,
                                        force_int8=sketch == "int8")
    ids_j, d_j = jscan.scan_search(
        jidx._arrays, jnp.asarray(queries), jidx._signs,
        jnp.float32(jidx._affine_a), jnp.float32(jidx._affine_b),
        jnp.asarray(N), kappa=1.0, k=k, top_c=top_c, sketch=sk_j, **PLAN,
        **kw)
    ids_t, d_t = tscan.scan_search(
        tidx._arrays, torch.from_numpy(queries), tidx._signs,
        tidx._affine_a, tidx._affine_b, N, kappa=1.0, k=k, top_c=top_c,
        sketch=sk_t, **PLAN, **kw)
    return ids_t.numpy(), d_t.numpy(), np.asarray(ids_j), np.asarray(d_j)


def check_distances(pair, ids_t, d_t, ids_j, d_j):
    """Distances of agreeing ids: the exact f32 rerank, rtol 1e-5 of the
    norms it cancels (the same sums taken in another order)."""
    _, tidx, queries = pair
    agree = (ids_t == ids_j) & (ids_t >= 0)
    scale = (queries ** 2).sum(1)[:, None] + tidx._arrays.norm_sq.numpy()[
        np.maximum(ids_t, 0)]
    assert agree.mean() > 0.9
    assert (np.abs(d_t - d_j)[agree] <= 1e-5 * scale[agree]).all()


@pytest.mark.parametrize("size", [256, 512, 768, 3840, 4096, 20224, 65536])
def test_bin_plan_matches_jax(size):
    for want in (1, 100, 341, 480, 1440, 2048, 5000, 100_000):
        assert tscan._bin_plan(size, want) == jscan._bin_plan(size, want)


@pytest.mark.parametrize("g", [1, 2, 8])
def test_binned_keys_match_jax(pair, g):
    """The same scores give the same keys; the two packages' chunk scores
    of the same store and query operands give keys >= 99.9% equal (the
    port rounds in the order XLA-CPU contracts the JAX scores to)."""
    jidx, tidx, queries = pair
    size = PLAN["chunk"]
    bins = size // g
    rng = np.random.default_rng(g)
    score = (rng.standard_normal((Q, size)) * 50).astype(np.float32)
    score[:, ::7] = -score[:, ::7]
    want = np.asarray(jscan._binned_keys(jnp.asarray(score), g, bins))
    got = to_u32(tscan._binned_keys(torch.from_numpy(score), g, bins))
    assert got.shape == want.shape == ((Q, size) if g == 1 else (Q, 2 * bins))
    np.testing.assert_array_equal(got, want)

    qpad = np.pad(queries, ((0, 0), (0, tidx._padded - DIM)))
    qc, w_fs, y_aux = jscan._query_side(jnp.asarray(qpad), jidx._signs,
                                        jidx._affine_a, jidx._affine_b, 1.0)
    q_u = np.array(qc.q_u, dtype=np.int8)
    score_j = jax.jit(jscan._chunk_scores, static_argnums=5)(
        jidx._arrays.planes[:size], jidx._arrays.node_aux[:, :size],
        jnp.asarray(q_u), w_fs, y_aux, tidx._padded)
    score_t = tscan._chunk_scores(
        tidx._arrays.planes[:size], tidx._arrays.node_aux[:, :size],
        torch.from_numpy(q_u), torch.from_numpy(np.array(w_fs)),
        torch.from_numpy(np.array(y_aux)), tidx._padded)
    want = np.asarray(jscan._binned_keys(score_j, g, bins))
    got = to_u32(tscan._binned_keys(score_t, g, bins))
    assert (got == want).mean() >= MIN_KEY_EQUAL


@pytest.mark.parametrize("top_c, sketch", [(40, None), (900, None),
                                           (1500, None), (4096, "bf16"),
                                           (4096, "int8")],
                         ids=["g8", "g2", "g1", "bf16-two-stage",
                              "int8-two-stage"])
def test_chunked_search_matches_jax(pair, top_c, sketch):
    """scan_search(fused=False) over 4 equal chunks and a remainder: top_c
    40, 900 and 1500 give 8, 2 and 1 groups per chunk; 4096 candidates
    rerank two-stage through a sketch."""
    ids_t, d_t, ids_j, d_j = search_both(pair, top_c, sketch=sketch,
                                         fused=False)
    assert ids_t.shape == ids_j.shape == (Q, K)
    assert overlap(ids_t, ids_j) >= MIN_OVERLAP
    check_distances(pair, ids_t, d_t, ids_j, d_j)


@pytest.mark.parametrize("top_c", [64, 300])
def test_exact_select_matches_jax(pair, top_c):
    ids_t, d_t, ids_j, d_j = search_both(pair, top_c, exact_select=True)
    np.testing.assert_array_equal(np.sort(ids_t, 1), np.sort(ids_j, 1))
    check_distances(pair, ids_t, d_t, ids_j, d_j)


def test_chunked_default_plan_and_bad_plan(pair):
    """Without a plan the chunked path takes chunk_plan(N_pad, Q); a plan
    that does not cover the store is refused."""
    jidx, tidx, queries = pair
    args = (tidx._arrays, torch.from_numpy(queries), tidx._signs,
            tidx._affine_a, tidx._affine_b, N)
    kw = dict(kappa=1.0, k=K, top_c=300, fused=False)
    n_pad = tidx._arrays.raw.shape[0]
    ids_a, _ = tscan.scan_search(*args, **kw)
    ids_b, _ = tscan.scan_search(*args, **kw,
                                 **dict(zip(("chunk", "n_eq", "rem"),
                                            tscan.chunk_plan(n_pad, Q))))
    assert torch.equal(ids_a, ids_b)
    with pytest.raises(ValueError, match="does not cover"):
        tscan.scan_search(*args, **kw, chunk=4096, n_eq=4, rem=0)


def test_bf16_sketch_bit_equal(pair, monkeypatch):
    jidx, tidx, _ = pair
    sk_j = jscan.make_rerank_sketch(jidx._arrays.raw, jidx._arrays.norm_sq)
    sk_t = tscan.make_rerank_sketch(tidx._arrays.raw, tidx._arrays.norm_sq)
    assert sk_j.scale is None and sk_t.scale is None
    assert sk_t.store.dtype == torch.bfloat16
    np.testing.assert_array_equal(sk_t.store.view(torch.int16).numpy(),
                                  np.asarray(sk_j.store).view(np.int16))
    # the raw store's norms, as the JAX package keeps them
    assert sk_t.norm_sq is tidx._arrays.norm_sq
    # above the size limit, or when forced, the sketch is int8
    assert tscan.make_rerank_sketch(tidx._arrays.raw, tidx._arrays.norm_sq,
                                    force_int8=True).scale is not None
    monkeypatch.setattr(tscan, "BF16_SKETCH_MAX_RAW_BYTES",
                        tidx._arrays.raw.numel() * 4 - 1)
    assert tscan.make_rerank_sketch(tidx._arrays.raw,
                                    tidx._arrays.norm_sq).scale is not None


@pytest.mark.parametrize("sketch", ["bf16", "int8"])
def test_two_stage_rerank_matches_jax(pair, sketch):
    """_rerank of 6,000 candidates per query (the true nearest rows in a
    shuffled order, plus pad ids past n): the sketch selects 512
    survivors, the exact f32 pass the top k."""
    jidx, tidx, queries = pair
    raw = tidx._arrays.raw.numpy()
    qpad = np.pad(queries, ((0, 0), (0, tidx._padded - DIM)))
    d = ((qpad[:, None, :] - raw[None, :N]) ** 2).sum(-1)
    rng = np.random.default_rng(7)
    cand = np.argsort(d, axis=1)[:, :6000]
    cand = rng.permuted(cand, axis=1).astype(np.int32)
    cand[:, :8] = N + 5                       # pad rows are priced out
    assert cand.shape[1] >= tscan.TWO_STAGE_MIN_C
    qnorm = (qpad ** 2).sum(1)
    sk_j = jscan.make_rerank_sketch(jidx._arrays.raw, jidx._arrays.norm_sq,
                                    force_int8=sketch == "int8")
    sk_t = tscan.make_rerank_sketch(tidx._arrays.raw, tidx._arrays.norm_sq,
                                    force_int8=sketch == "int8")
    ids_j, d_j = jscan._rerank(
        jidx._arrays.raw, jidx._arrays.norm_sq, jnp.asarray(qpad),
        jnp.asarray(qnorm), jnp.asarray(cand), N, K, sketch=sk_j)
    ids_t, d_t = tscan._rerank(
        tidx._arrays.raw, tidx._arrays.norm_sq, torch.from_numpy(qpad),
        torch.from_numpy(qnorm), torch.from_numpy(cand).long(), N, K,
        sketch=sk_t)
    ids_t, d_t = ids_t.numpy(), d_t.numpy()
    ids_j, d_j = np.asarray(ids_j), np.asarray(d_j)
    assert overlap(ids_t, ids_j) >= MIN_OVERLAP
    check_distances((None, tidx, queries), ids_t, d_t, ids_j, d_j)
    # the exact top k of the candidates
    true = np.sort(d, axis=1)[:, :K]
    assert overlap(ids_t, np.argsort(d, axis=1)[:, :K]) >= MIN_OVERLAP
    assert (d_t >= true - 1e-3 * (1 + true)).all()
