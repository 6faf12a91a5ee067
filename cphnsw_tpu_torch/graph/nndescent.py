"""Batched NNDescent kNN-graph construction.

PyTorch counterpart of ``cphnsw_tpu/graph/nndescent.py``: the working
graph is a fixed-shape (N, R) neighbour matrix (ids, dists, new-flags); a
join round samples forward and reverse lists (preferring "new" entries),
scores every candidate with chunked gathered fp32 products and merges the
top R per node; the adaptive round controller runs on the host around it,
reading one update count per round.

Every random value is drawn from JAX's Threefry stream
(``ops/threefry.py``) with the JAX package's keys, split in its order:
``init_random`` from ``PRNGKey(seed)``, the rounds from
``PRNGKey(seed + 1)``.  So the working graph is the JAX package's, up to
a near tie at rank R that distances summed in another order may flip.

``reverse_lists`` keeps the JAX package's slot rule: a target with more
than ``r_rev`` sources keeps ``r_rev - 1`` of them and -1 in its last
slot, as the JAX scatter leaves it (see ``reverse_lists``).

Differences from the JAX package that do not change what is computed:
node chunks are sliced to their true length instead of padding the tail
with clamped ids (a tail draws the first values of its key: a Threefry
value depends only on the key and its flat index), and chunk outputs are
written into preallocated tensors without a host sync per chunk (the
CUDA caching allocator bounds the live set).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from cphnsw_tpu_torch.ops import threefry
from cphnsw_tpu_torch.ops.estimate import full_fp32
from cphnsw_tpu_torch.ops.rounding import fma_f32
from cphnsw_tpu_torch.ops.threefry import Key

INVALID = -1
FLOAT_MAX = float(torch.finfo(torch.float32).max)

# Forward/reverse list samples per join round (fixed-cap incremental join).
SAMPLE_FWD = 4
SAMPLE_REV = 4
# Weight of the uniform noise under the sampling buckets, as an f32 value.
NOISE_SCALE = float(np.float32(0.999))

# Device-memory budget for a chunk's gathered candidate block
# (b * C * P * 4 bytes).
CHUNK_BYTES_BUDGET = 1 << 31  # 2 GB
JOIN_CHUNK = 32768


class WorkingGraph(NamedTuple):
    ids: torch.Tensor    # (N, R) int32, -1 = empty slot
    dists: torch.Tensor  # (N, R) f32, FLOAT_MAX for empty
    flags: torch.Tensor  # (N, R) bool, True = new since last join


def top_k_smallest(x: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries along dim 1, ascending,
    the lower index first among equal values: the order ``lax.top_k(-x, k)``
    gives.  Ties are common where keys saturate (FLOAT_MAX slots, the
    +1e18 backfill keys of the alpha-CNG prune), so the order matters."""
    vals, idx = torch.sort(x, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def _chunk_for(n: int, cand_width: int, p: int, cap: int) -> int:
    b = CHUNK_BYTES_BUDGET // max(cand_width * p * 4, 1)
    b = max(1024, min(cap, b))
    return min(b, n)


def _pairwise_dist_to_cands(raw, norm_sq, node_ids, cand_ids):
    """d^2(node_i, cand_ij) for nodes (B,) x candidates (B, C); invalid
    candidates and self edges -> FLOAT_MAX."""
    safe_cand = cand_ids.clamp_min(0).long()
    x = raw[node_ids]                                   # (B, P)
    c = raw[safe_cand]                                  # (B, C, P)
    with full_fp32():
        dots = torch.bmm(c, x[:, :, None])[..., 0]
    d = (norm_sq[node_ids][:, None] + norm_sq[safe_cand]
         - 2.0 * dots).clamp_min(0.0)
    invalid = (cand_ids < 0) | (cand_ids == node_ids[:, None])
    return torch.where(invalid, FLOAT_MAX, d)


def _merge_top_r(old_ids, old_dists, cand_ids, cand_dists, r: int):
    """Merge candidate lists into the working lists: dedup by id, keep the
    R smallest distances.  Returns (ids, dists, new_flags, n_updates)."""
    ids = torch.cat([old_ids, cand_ids], dim=1)
    dists = torch.cat([old_dists, cand_dists], dim=1)
    ids_s, order = torch.sort(ids, dim=1, stable=True)
    dists_s = torch.gather(dists, 1, order)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = (ids_s[:, 1:] == ids_s[:, :-1]) & (ids_s[:, 1:] >= 0)
    dists_s = torch.where(dup | (ids_s < 0), FLOAT_MAX, dists_s)

    new_dists, sel = top_k_smallest(dists_s, r)
    new_ids = torch.gather(ids_s, 1, sel)
    new_ids = torch.where(new_dists >= FLOAT_MAX, INVALID, new_ids)

    was_old = ((new_ids[:, :, None] == old_ids[:, None, :])
               & (new_ids[:, :, None] >= 0)).any(-1)
    new_flags = (new_ids >= 0) & ~was_old
    return new_ids, new_dists, new_flags, new_flags.sum()


def _dedup_sort_pairs(ids, dists):
    """Sort candidate pairs by (id, dist) so dedup keeps the best copy:
    a stable sort by id after a sort by distance."""
    dists1, order_d = torch.sort(dists, dim=1, stable=True)
    ids1 = torch.gather(ids, 1, order_d)
    ids2, order_i = torch.sort(ids1, dim=1, stable=True)
    return ids2, torch.gather(dists1, 1, order_i)


def _new_graph(n: int, r: int, device):
    return WorkingGraph(
        ids=torch.full((n, r), INVALID, dtype=torch.int32, device=device),
        dists=torch.full((n, r), FLOAT_MAX, device=device),
        flags=torch.zeros((n, r), dtype=torch.bool, device=device),
    )


def init_random(raw, norm_sq, r: int, seed: int = 42,
                chunk: int | None = None) -> WorkingGraph:
    """Coupon-collector random init: a pool of ~R*ln(n/R) random
    candidates per node, keep the R nearest.  Each node chunk draws from
    its own key, split from ``PRNGKey(seed)``, so the graph follows the
    chunking, as in the JAX package.  `chunk` overrides the nodes drawn
    per step; the build always derives it: the override is for tests that
    want several chunks on a small store."""
    n = raw.shape[0]
    dev = raw.device
    pool = min(
        int(r * math.ceil(math.log(max(n / r, 2.0)))) if n > r else n - 1,
        max(n - 1, 1),
    )
    pool = max(pool, min(r, n - 1))
    if chunk is None:
        chunk = _chunk_for(n, pool, raw.shape[1], 16384)
    key = threefry.prng_key(seed)
    out = _new_graph(n, r, dev)
    for start in range(0, n, chunk):
        node_ids = torch.arange(start, min(start + chunk, n), device=dev)
        b = node_ids.shape[0]
        key, sub = threefry.split(key)
        # the JAX package draws (chunk, pool) for a tail too: its rows are
        # the first b * pool values of the key
        cand = threefry.randint(sub, b * pool, 0, n, dev).to(
            torch.int32).reshape(b, pool)
        d = _pairwise_dist_to_cands(raw, norm_sq, node_ids, cand)
        cand, d = _dedup_sort_pairs(cand, d)
        empty_ids = torch.full((b, r), INVALID, dtype=torch.int32,
                               device=dev)
        empty_d = torch.full((b, r), FLOAT_MAX, device=dev)
        ids, dists, _, _ = _merge_top_r(empty_ids, empty_d, cand, d, r)
        out.ids[start:start + b] = ids
        out.dists[start:start + b] = dists
    return out._replace(flags=out.ids >= 0)


def reverse_lists(ids: torch.Tensor, key: Key, r_rev: int) -> torch.Tensor:
    """Capped reverse-neighbour lists: for each edge (i -> v), i becomes a
    reverse neighbour of v; each v keeps its r_rev sources of the lowest
    random priority, drawn from `key` per call, except that a v with more
    than r_rev sources keeps r_rev - 1 of them and -1 in its last slot."""
    n, r = ids.shape
    dev = ids.device
    src = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(
        n, r).reshape(-1)
    tgt = ids.reshape(-1)
    prio = threefry.randint(key, n * r, 0, 1 << 20, dev)
    tgt_safe = torch.where(tgt >= 0, tgt, n)          # invalid sorts last
    # two-pass stable sort == sort by (tgt, prio)
    order_p = torch.sort(prio, stable=True).indices
    order = order_p[torch.sort(tgt_safe[order_p], stable=True).indices]
    tgt_sorted = tgt_safe[order].contiguous()
    src_sorted = src[order]
    first = torch.searchsorted(tgt_sorted, tgt_sorted, side="left")
    rank = torch.arange(tgt_sorted.shape[0], device=dev) - first
    real = tgt_sorted < n
    keep = (rank < r_rev) & real
    rev = torch.full((n + 1, r_rev), INVALID, dtype=torch.int32, device=dev)
    # kept (target, rank) pairs are distinct: dropped entries go to the
    # spare row n, slot 0
    rev[torch.where(keep, tgt_sorted, n).long(),
        torch.where(keep, rank, 0)] = torch.where(keep, src_sorted, INVALID)
    # The JAX scatter (cphnsw_tpu/graph/nndescent.py:206-209) writes every
    # source of rank >= r_rev as -1 onto slot r_rev - 1 of its target, after
    # the source of rank r_rev - 1; XLA-CPU keeps the last write, so an
    # over-full target ends in -1.  Kept as the reference gives it: a fix
    # belongs to both packages or to neither.
    over = (rank >= r_rev) & real
    rev[tgt_sorted[over].long(), r_rev - 1] = INVALID
    return rev[:n]


def _prefer_new_sample(ids, flags, k_sample: int, key: Key):
    """Pick k_sample entries per row, preferring flagged (new) ones; the
    noise is the first rows * r uniforms of `key`."""
    rows, r = ids.shape
    noise = threefry.uniform_from_bits(
        threefry.random_bits(key, 0, rows * r, ids.device)).reshape(rows, r)
    # new entries get priority bucket 0, old valid 1, invalid 2; XLA-CPU
    # contracts bucket + noise * 0.999 into one fused multiply-add
    bucket = torch.where(ids < 0, 2.0, torch.where(flags, 0.0, 1.0))
    _, sel = top_k_smallest(fma_f32(noise, NOISE_SCALE, bucket), k_sample)
    return torch.gather(ids, 1, sel)


def _join_chunk(raw, norm_sq, wg: WorkingGraph, rev, key: Key, start: int,
                b: int):
    """Join for the node block [start, start + b): forward samples from the
    first half of `key`'s split, reverse samples from the second."""
    n, r = wg.ids.shape
    rows = slice(start, start + b)
    idx = torch.arange(start, start + b, device=raw.device)
    my_ids = wg.ids[rows]
    my_rev = rev[rows]
    k1, k2 = threefry.split(key, 2)
    fwd_sample = _prefer_new_sample(my_ids, wg.flags[rows], SAMPLE_FWD, k1)
    rev_sample = _prefer_new_sample(my_rev, my_rev >= 0, SAMPLE_REV, k2)

    # candidates: members of the sampled forward/reverse lists, plus the
    # reverse neighbours themselves
    def members(sample):
        cand = wg.ids[sample.clamp_min(0).long()]         # (b, S, R)
        cand = torch.where((sample < 0)[:, :, None], INVALID, cand)
        return cand.reshape(b, -1)

    cand = torch.cat([members(fwd_sample), members(rev_sample), my_rev],
                     dim=1)
    d = _pairwise_dist_to_cands(raw, norm_sq, idx, cand)
    cand, d = _dedup_sort_pairs(cand, d)
    return _merge_top_r(my_ids, wg.dists[rows], cand, d, r)


def join_round(raw, norm_sq, wg: WorkingGraph, r: int,
               round_key: Key) -> tuple[WorkingGraph, int]:
    """One NNDescent join round over the whole graph (every chunk reads
    the round's input graph); returns the update count.  `round_key`
    splits into the reverse lists' key and a chain that gives each chunk
    its own."""
    n = wg.ids.shape[0]
    k_rev, k_join = threefry.split(round_key)
    rev = reverse_lists(wg.ids, k_rev, r)
    cand_width = (SAMPLE_FWD + SAMPLE_REV + 1) * r
    b = _chunk_for(n, cand_width, raw.shape[1], JOIN_CHUNK)
    out = _new_graph(n, r, raw.device)
    total = torch.zeros((), dtype=torch.int64, device=raw.device)
    for start in range(0, n, b):
        bb = min(b, n - start)
        k_join, k = threefry.split(k_join)
        ids, dists, flags, upd = _join_chunk(raw, norm_sq, wg, rev, k,
                                             start, bb)
        out.ids[start:start + bb] = ids
        out.dists[start:start + bb] = dists
        out.flags[start:start + bb] = flags
        total += upd
    return out, int(total)          # one host sync per round


def run_adaptive(raw, norm_sq, r: int, seed: int = 42,
                 verbose: bool = False) -> WorkingGraph:
    """Adaptive NNDescent loop: two probe rounds measure the update-rate
    decay, from which the EMA smoothing, convergence threshold, minimum
    rounds (geometric extrapolation) and hard cap are derived."""
    n = raw.shape[0]
    wg = init_random(raw, norm_sq, r, seed=seed)
    key = threefry.prng_key(seed + 1)

    total_edges = max(n * r, 1)
    key, k0, k1 = threefry.split(key, 3)
    wg, upd0 = join_round(raw, norm_sq, wg, r, k0)
    rate0 = upd0 / total_edges
    wg, upd1 = join_round(raw, norm_sq, wg, r, k1)
    rate1 = upd1 / total_edges

    decay_ratio = rate1 / rate0 if rate0 > 1e-12 else 0.5
    ema_alpha = float(np.clip(1.0 - decay_ratio, 0.2, 0.8))
    # an absolute update-rate floor: <0.2% of edges changing per round
    # means the graph has stopped improving measurably
    converge_rate = max(2e-3, 1.0 / total_edges)

    if 0.0 < decay_ratio < 1.0 and rate0 > converge_rate:
        min_rounds = int(math.ceil(
            math.log(converge_rate / rate0) / math.log(decay_ratio)))
        min_rounds = int(np.clip(min_rounds, 2,
                                 math.sqrt(math.log2(max(n, 64)))))
    else:
        min_rounds = 2
    hard_cap = int(np.clip(min_rounds * 3, 10,
                           min(n, max(500, int(math.isqrt(n))))))

    ema_rate = ema_alpha * rate1 + (1 - ema_alpha) * rate0
    for rnd in range(2, hard_cap):
        key, k = threefry.split(key)
        wg, upd = join_round(raw, norm_sq, wg, r, k)
        rate = upd / total_edges
        ema_rate = ema_alpha * rate + (1 - ema_alpha) * ema_rate
        if verbose:
            print(f"nndescent round {rnd}: rate={rate:.5f} "
                  f"ema={ema_rate:.5f}", flush=True)
        if rnd >= min_rounds and min(rate, ema_rate) < converge_rate:
            break
    return wg


def knn_graph_recall(wg: WorkingGraph, raw: np.ndarray, k: int) -> float:
    """Fraction of true k-NN edges present in the working graph (test
    utility; host numpy, O(n^2) memory)."""
    x = np.asarray(raw)
    d = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    gt = np.argsort(d, axis=1)[:, :k]
    ids = wg.ids.cpu().numpy() if isinstance(wg.ids, torch.Tensor) \
        else np.asarray(wg.ids)
    return float((gt[:, :, None] == ids[:, None, :]).any(-1).mean())
