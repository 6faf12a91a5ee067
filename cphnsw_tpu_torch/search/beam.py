"""Batched DABS beam search at layer 0.

PyTorch counterpart of ``cphnsw_tpu/search/beam.py``.  The whole query
batch advances in lockstep: every step pops the best ``expand_width`` beam
entries per query (masked by per-query done flags), gathers each popped
node's fused neighbour row, scores all E*R edges with the fastscan
estimator and its lower bound, exact-reranks the survivors, and merges
results and beam.  Per query, the semantics are the JAX package's:

  * DABS termination: stop when the best beam estimate >= gamma_q * d_k
    and the result heap is full; lower-bound expansion skip;
  * per-expansion slack-level escalation along the EVT ladder;
  * warmup until k results: every unseen neighbour is exact-scored and
    enqueued un-gated;
  * candidate gates: lower-bound skip, est < d_k -> exact rerank + result
    push, est < gamma_q * d_k -> enqueue;
  * online gamma_q adaptation from the est/exact ratio spread;
  * visited dedup in a dense (Q, N+1) mask or a (Q, 2^b+1) hash table.

Where the port differs from the JAX package, and why results stay the
same up to which duplicate expansions happen (the result heap dedups):

  * ``lax.while_loop`` becomes a Python loop over chunks of
    ``DONE_CHECK_EVERY`` steps that reads the done flags on the host once
    per chunk, capped at max_steps: a step of a finished query is a no-op
    (every update is masked by ``active``), so the extra steps change
    nothing but the step counter;
  * on CUDA, where one device program would run the JAX loop, the port
    captures one chunk in a CUDA graph and replays it: one launch per
    chunk in place of ~2,000 small ones, the same kernels in the same
    order (the remainder past the last whole chunk runs eagerly).  The
    graph is kept with the buffers it works on for the next call of the
    same shapes, within a byte budget per device; a call that captures
    runs its first chunk eagerly.  A kept graph replays the functions it
    captured: ``drop_replays()`` after patching one;
  * the beam's ``approx_max_k`` is an exact selection; every top-k breaks
    ties by the lower index first, as ``lax.top_k`` does;
  * where two ids of one step hash to one visited slot, the port keeps
    the last in row order (``_last_writers``), so its searches repeat
    exactly on CUDA; the JAX scatter fixes no winner;
  * the fastscan int32 contraction is an exact fp32 product
    (``estimate.fastscan_sums``);
  * on CUDA the step's pop (with the step counter), expansion, merge and
    gamma update are four hand-written kernels (``kernels/beam_step.py``)
    around the exact distances, which stay torch ops
    (``estimate.exact_l2_sq``): they update the state in place, skip the
    queries that are done, and give the bits of the step's plain segments
    (``_plain_step``, which the CPU runs);
  * the gamma adaptation sums each query's ratios in a fixed order
    (``_lane_sums``), the one its kernel takes; the JAX package's
    ``jnp.sum`` takes XLA's.
"""

from __future__ import annotations

import functools
import itertools
import weakref
from typing import NamedTuple

import torch

from cphnsw_tpu_torch.graph.build import NeighborStore
from cphnsw_tpu_torch.graph.nndescent import top_k_smallest
from cphnsw_tpu_torch.kernels import beam_step
from cphnsw_tpu_torch.ops import estimate, hadamard, pack, quantize
from cphnsw_tpu_torch.ops.estimate import full_fp32
from cphnsw_tpu_torch.ops.quantize import EPS_SMALL
from cphnsw_tpu_torch.utils.device import resolve_device

FLOAT_MAX = float(torch.finfo(torch.float32).max)
# Steps between host reads of the done flags (one device->host sync each);
# on CUDA, the steps of one captured graph.
DONE_CHECK_EVERY = 8


class SearchParams(NamedTuple):
    """Calibration-derived search constants: f32-valued Python scalars and
    the (L,) f32 slack ladder on the search device."""

    affine_a: float
    affine_b: float
    ip_qo_floor: float
    slack_levels: torch.Tensor
    gamma: float          # search_gamma (baseline)
    gamma_max: float
    gamma_beta: float
    gamma_warmup: int

    @classmethod
    def default(cls, num_levels: int = 4, device="cuda") -> "SearchParams":
        """The uncalibrated constants of the JAX package's
        ``SearchParams.default``: the identity affine, no slack, gamma 1
        that never adapts; the slack ladder lies on `device` (the card by
        default, as the JAX package's lie on its default device; without
        CUDA that default raises)."""
        return cls(affine_a=1.0, affine_b=0.0, ip_qo_floor=0.0,
                   slack_levels=torch.zeros(num_levels, dtype=torch.float32,
                                            device=resolve_device(device)),
                   gamma=1.0, gamma_max=1.5, gamma_beta=0.0,
                   gamma_warmup=1 << 30)


class BeamState(NamedTuple):
    beam_ids: torch.Tensor    # (Q, B) int32
    beam_est: torch.Tensor    # (Q, B) f32, FLOAT_MAX = empty
    beam_lower: torch.Tensor  # (Q, B)
    res_ids: torch.Tensor     # (Q, K) int32, sorted by distance
    res_d: torch.Tensor       # (Q, K) f32, FLOAT_MAX = empty
    visited: torch.Tensor     # (Q, N+1) bool or (Q, 2^b+1) int32
    gamma_q: torch.Tensor     # (Q,)
    ratio_sum: torch.Tensor
    ratio_sq: torch.Tensor
    ratio_cnt: torch.Tensor   # (Q,) int32
    slack_cnt: torch.Tensor   # (Q,) int32
    done: torch.Tensor        # (Q,) bool
    steps: int                # loop steps run (during the loop, a ()
                              # int32 counter on the device)
    last_improve: torch.Tensor  # (Q,) int32: step of last result change
    res_step: torch.Tensor    # (Q, K) int32: step each result was pushed


def _merge_results(res_ids, res_d, res_step, cand_ids, cand_d,
                   step: torch.Tensor, k: int):
    ids = torch.cat([res_ids, cand_ids], dim=1)
    d = torch.cat([res_d, cand_d], dim=1)
    steps = torch.cat([res_step, step.expand(cand_ids.shape)], dim=1)
    top_d, sel = top_k_smallest(d, k)
    return ids.gather(1, sel), top_d, steps.gather(1, sel)


def _last_writers(slot, ok):
    """ok with every entry dropped that a later ok entry of its row writes
    over (same hash slot): one writer per slot, the last in row order, so
    the scatter is deterministic on every device."""
    w = slot.shape[1]
    later = torch.ones((w, w), dtype=torch.bool, device=slot.device).triu(1)
    clash = ((slot[:, :, None] == slot[:, None, :]) & later
             & ok[:, None, :]).any(dim=-1)
    return ok & ~clash


def _seed_beam(raw, norm_sq, entry_candidates, qpad, qnorm, beam_cap: int,
               k: int, n_seeds: int):
    """(seeds (Q, S) int32 with -1 for empty slots, seed_d (Q, S))."""
    cands = entry_candidates.to(device=raw.device, dtype=torch.int64)
    if cands.ndim == 2:
        # per-query entry seeds (HNSW upper-layer descent); id < 0 marks
        # an empty slot, priced FLOAT_MAX so it never reaches the results
        n_seeds = min(cands.shape[1], beam_cap, k)
        seeds = cands[:, :n_seeds]
        safe = seeds.clamp_min(0)
        seed_d = estimate.exact_l2_sq(qpad, qnorm, raw[safe], norm_sq[safe])
        seed_d = torch.where(seeds >= 0, seed_d, FLOAT_MAX)
        seed_d, order = torch.sort(seed_d, dim=1, stable=True)
        seeds = seeds.gather(1, order)
        seeds = torch.where(seed_d < FLOAT_MAX, seeds, -1)
    else:
        # seed scan: exact distances to the shared candidate pool, top-S
        cands = cands.reshape(-1)
        n_seeds = min(n_seeds, cands.shape[0], beam_cap, k)
        with full_fp32():
            cand_dots = qpad @ raw[cands].T
        d_cand = (qnorm[:, None] + norm_sq[cands][None, :]
                  - 2.0 * cand_dots).clamp_min(0.0)            # (Q, M)
        seed_d, slot = top_k_smallest(d_cand, n_seeds)
        seeds = cands[slot]
    return seeds.to(torch.int32), seed_d


class _Consts(NamedTuple):
    """What the steps read and never write: the batch's tensors, which a
    captured graph reads by address, and the scalars its ops bake in."""

    raw: torch.Tensor
    norm_sq: torch.Tensor
    fused: torch.Tensor
    qpad: torch.Tensor
    qnorm: torch.Tensor
    q_u: torch.Tensor
    coeff: tuple                # (Q, 1) coeff_a, coeff_b, coeff_c
    earlier: torch.Tensor       # (er, er) bool: row index > column index
    params: SearchParams
    bits: int
    k: int
    r: int
    words: int
    expand_width: int
    rw: int                     # candidates exact-reranked per step
    h_size: int                 # hash-visited slots; 0: dense visited


def search_batch(raw, norm_sq, neighbors: NeighborStore, entry_candidates,
                 signs, queries, params: SearchParams, bits: int, k: int,
                 beam_cap: int = 128, max_steps: int = 512,
                 n_seeds: int = 4, expand_width: int = 1,
                 rerank_width: int = 0, visited_hash_bits: int = 0,
                 debug_state: bool = False):
    """DABS layer-0 search for a batch of queries (Q, <= P) on raw's
    device.

    entry_candidates: (M,) node ids (the hub entry plus a fixed sample),
    exact-scored per query to seed its beam with the n_seeds nearest, or
    (Q, S) per-query seeds with -1 for empty slots.  rerank_width > 0
    caps each step's exact rerank at that many of the best estimates (the
    rest keep their estimates as beam priority); 0 reranks every
    candidate.  Returns (ids (Q, k) int32, dists (Q, k) f32 exact squared
    L2, ascending), plus the final BeamState when debug_state."""
    buf, consts = _start(raw, norm_sq, neighbors, entry_candidates, signs,
                         queries, params, bits, k, beam_cap, n_seeds,
                         expand_width, rerank_width, visited_hash_bits)
    dev = raw.device
    keep = not debug_state
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            buf, steps = _run_steps(buf, consts, max_steps, neighbors, keep)
    else:
        buf, steps = _run_steps(buf, consts, max_steps, neighbors, keep)

    # copies: on CUDA the buffers are kept for the next call
    ids = torch.where(buf.res_d < FLOAT_MAX, buf.res_ids, -1)
    if not debug_state:
        return ids, buf.res_d.clone()
    return ids, buf.res_d.clone(), BeamState(
        *(t.clone() for t in buf))._replace(steps=steps)


def _start(raw, norm_sq, neighbors: NeighborStore, entry_candidates, signs,
           queries, params: SearchParams, bits: int, k: int, beam_cap: int,
           n_seeds: int, expand_width: int, rerank_width: int,
           visited_hash_bits: int) -> tuple[BeamState, _Consts]:
    """search_batch's seeded state before the first step (its step
    counter a () int32 tensor on raw's device) and the constants the steps
    read."""
    n, p = raw.shape
    q = queries.shape[0]
    r = neighbors.r
    dev = raw.device
    er = expand_width * r

    # a copy, never the caller's tensor: a kept graph reads it by address
    # and a later call writes its own queries there
    qpad = hadamard.pad_to(queries.to(dev, torch.float32), p).clone()
    qc = quantize.encode_queries(qpad, signs)
    qnorm = (qpad * qpad).sum(dim=-1)

    seeds, seed_d = _seed_beam(raw, norm_sq, entry_candidates, qpad, qnorm,
                               beam_cap, k, n_seeds)
    s = seeds.shape[1]
    beam_ids = torch.full((q, beam_cap), -1, dtype=torch.int32, device=dev)
    beam_ids[:, :s] = seeds
    beam_est = torch.full((q, beam_cap), FLOAT_MAX, device=dev)
    beam_est[:, :s] = seed_d
    res_ids = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    res_ids[:, :s] = seeds
    res_d = torch.full((q, k), FLOAT_MAX, device=dev)
    res_d[:, :s] = seed_d
    # empty (-1) seed slots go to the spare visited slot
    h_size = 1 << visited_hash_bits if visited_hash_bits > 0 else 0
    if h_size:
        visited = torch.full((q, h_size + 1), -1, dtype=torch.int32,
                             device=dev)
        seed_slot = (seeds % h_size).long()
        keep = _last_writers(seed_slot, seeds >= 0)
        visited.scatter_(1, torch.where(keep, seed_slot, h_size),
                         torch.where(keep, seeds, -1))
    else:
        visited = torch.zeros((q, n + 1), dtype=torch.bool, device=dev)
        visited.scatter_(1, torch.where(seeds >= 0, seeds, n).long(), True)

    buf = BeamState(
        beam_ids=beam_ids, beam_est=beam_est,
        beam_lower=torch.zeros((q, beam_cap), device=dev),
        res_ids=res_ids, res_d=res_d, visited=visited,
        gamma_q=torch.full((q,), params.gamma, device=dev),
        ratio_sum=torch.zeros(q, device=dev),
        ratio_sq=torch.zeros(q, device=dev),
        ratio_cnt=torch.zeros(q, dtype=torch.int32, device=dev),
        slack_cnt=torch.zeros(q, dtype=torch.int32, device=dev),
        done=torch.zeros(q, dtype=torch.bool, device=dev),
        steps=torch.zeros((), dtype=torch.int32, device=dev),
        last_improve=torch.zeros(q, dtype=torch.int32, device=dev),
        res_step=torch.zeros((q, k), dtype=torch.int32, device=dev))
    consts = _Consts(
        raw=raw, norm_sq=norm_sq, fused=neighbors.fused, qpad=qpad,
        qnorm=qnorm, q_u=qc.q_u,
        coeff=tuple(c[:, None] for c in (qc.coeff_a, qc.coeff_b,
                                         qc.coeff_c)),
        earlier=(torch.arange(er, device=dev)[:, None]
                 > torch.arange(er, device=dev)[None, :]),   # (er, er)
        params=params, bits=bits, k=k, r=r, words=neighbors.words,
        expand_width=expand_width,
        rw=min(rerank_width, er) if rerank_width > 0 else er, h_size=h_size)
    return buf, consts


class _Replay(NamedTuple):
    """A captured chunk kept across calls: its replay, the state and input
    buffers it reads and writes by address, the bytes it holds (those
    buffers and the graph's memory pool) and when it was last used."""

    run: object
    buf: BeamState
    consts: _Consts
    nbytes: int
    used: int


# Captured chunks kept across calls, per neighbour store (an entry goes
# with its store): on an H100 a capture per call cost 20% of a 1024-query
# batch on a 1M-row graph (PERF.md).  The entries of one device hold at
# most KEPT_BYTES_PER_DEVICE, as much as one Index sub-batch's visited
# table may take (api/index.py), the least recently used dropped first: a
# search whose entry alone takes more frees its graph at return.  A
# debug_state search replays a kept graph but keeps none it captures.
_REPLAYS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
KEPT_BYTES_PER_DEVICE = 2 << 30
_USES = itertools.count()


def drop_replays():
    """Free every kept graph.  A kept graph replays the functions it
    captured: call this after patching one that the beam step calls."""
    _REPLAYS.clear()


def kept_bytes(device=None) -> int:
    """Bytes held by the kept graphs on `device` (on every device for
    None): their state and input buffers and their memory pools."""
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return sum(e.nbytes for kept in list(_REPLAYS.values())
               for e in kept.values()
               if dev is None or e.buf.done.device == dev)


def _keep(kept: dict, key, entry: _Replay):
    """Keep entry in kept (a store's entries in _REPLAYS) as the most
    recently used, then drop the least recently used entries of its device
    until they hold at most KEPT_BYTES_PER_DEVICE."""
    kept[key] = entry._replace(used=next(_USES))
    dev = entry.buf.done.device
    mine = sorted(((e.used, key_, d) for d in list(_REPLAYS.values())
                   for key_, e in d.items() if e.buf.done.device == dev),
                  key=lambda x: x[0])
    total = sum(d[key_].nbytes for _, key_, d in mine)
    for _, key_, d in mine:
        if total <= KEPT_BYTES_PER_DEVICE:
            break
        total -= d.pop(key_).nbytes


def _inputs(c: _Consts) -> tuple:
    """The consts that are the batch's own: a kept graph's copies of them
    are loaded with each call's."""
    return c.coeff + (c.qpad, c.qnorm, c.q_u)


def _replay_key(buf: BeamState, c: _Consts) -> tuple:
    """What a captured chunk bakes in: the device, every buffer's shape and
    type, the index's tensors by address, and the scalars."""
    p = c.params
    return (buf.done.device,
            tuple((t.shape, t.dtype) for t in tuple(buf) + _inputs(c)),
            tuple((t.data_ptr(), t.shape, t.dtype) for t in (
                c.raw, c.norm_sq, c.fused, p.slack_levels)),
            p.affine_a, p.affine_b, p.ip_qo_floor, p.gamma, p.gamma_max,
            p.gamma_beta, p.gamma_warmup, c.bits, c.k, c.r, c.words,
            c.expand_width, c.rw, c.h_size, DONE_CHECK_EVERY)


def _load(entry: _Replay, buf: BeamState, c: _Consts) -> _Replay:
    """Copy this call's initial state and query inputs into a kept
    entry's buffers."""
    for dst, src in zip(tuple(entry.buf) + _inputs(entry.consts),
                        tuple(buf) + _inputs(c)):
        dst.copy_(src)
    return entry


def _run_steps(buf: BeamState, c: _Consts, max_steps: int, store,
               keep: bool) -> tuple[BeamState, int]:
    """Advance the state in buf to the end of the search: chunks of
    DONE_CHECK_EVERY steps, each followed by one host read of the done
    flags, then the rest of max_steps unread.  Returns (the final state,
    the steps run).

    On CUDA every chunk replays one captured graph, one launch each.  A
    graph kept for store and this call's shapes (_REPLAYS) is replayed
    from the first chunk; a call that finds none runs its first chunk
    eagerly on a side stream (real work, and the warm-up of that stream's
    handles), then captures a chunk on it for its later chunks, and keeps
    the graph with its buffers when `keep` and the byte budget allow."""
    every = DONE_CHECK_EVERY
    full, rest = divmod(max_steps, every)
    side = kept = key = entry = None
    if buf.done.is_cuda:
        side = _side_stream(buf.done.device)
        kept = _REPLAYS.setdefault(store, {})
        key = _replay_key(buf, c)
        entry = kept.pop(key, None)
        if entry is not None:
            buf, c = _load(entry, buf, c)[1:3]

    def chunk():
        _advance(buf, c, every)

    run = entry.run if entry is not None else None
    pool = 0
    steps = max_steps
    for i in range(full):
        if run is not None:
            run()
        elif side is not None and i == 0:
            main = torch.cuda.current_stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                chunk()
            main.wait_stream(side)
        elif side is not None:
            # the graph's private pool is reserved while it is captured
            before = torch.cuda.memory_reserved(buf.done.device)
            run = _graphed(chunk, side)
            pool = torch.cuda.memory_reserved(buf.done.device) - before
            run()
        else:
            chunk()
        if bool(buf.done.all()):
            steps = (i + 1) * every
            break
    else:
        if rest:
            _advance(buf, c, rest)
    if entry is not None:
        _keep(kept, key, entry)
    elif run is not None and keep:
        _keep(kept, key, _Replay(run, buf, c, max(pool, 0) + sum(
            t.nbytes for t in tuple(buf) + _inputs(c) + (c.earlier,)), 0))
    return buf, steps


@functools.cache
def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    """The stream each call's first chunk runs on and its graph is captured
    on: one per device for the process.  A new stream from PyTorch's pool
    on every call would grow the allocator's cache, which reuses a freed
    block only on the stream that allocated it."""
    return torch.cuda.Stream(dev)


def _graphed(fn, stream):
    """Capture fn's device work on `stream` into one CUDA graph (nothing
    runs while it is captured) and return the graph's replay, which
    launches that work on the current stream.  CUDAGraph's own
    capture_begin / capture_end, not the torch.cuda.graph context, which
    on entry synchronizes and empties the allocator's cache."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            fn()
        finally:
            graph.capture_end()
    return graph.replay


def _advance(buf: BeamState, c: _Consts, steps: int):
    """Run `steps` steps from the state in buf and write the result back
    into buf (visited is updated in place by every step)."""
    s = buf
    for _ in range(steps):
        s = _step(s, c)
    for new, old in zip(s, buf):
        if new is not old:
            old.copy_(new)




# ------------------------------------------------------------ the step
#
# One step in segments: the pop (and the step counter), the exact distance
# to each popped node, the expansion, the exact distances of the
# candidates it picked for the rerank, the merge and the gamma update.
# The exact distances are torch ops on every device; the other segments
# are plain torch (`_pop_plain` ...) on the CPU and the kernels of
# kernels/beam_step.py on CUDA (`_pop` ...), which update the state in
# place and equal the plain segments bit for bit.


class Popped(NamedTuple):
    beam_est: torch.Tensor    # (Q, B) the popped entries of active queries
                              # at FLOAT_MAX
    done: torch.Tensor        # (Q,) bool, after this step
    slack_cnt: torch.Tensor   # (Q,) int32, after this step
    active: torch.Tensor      # (Q,) bool: not done
    expand: torch.Tensor      # (Q,) bool: any entry expanded
    expand_e: torch.Tensor    # (Q, E) bool: the popped entries expanded
    pop_ids: torch.Tensor     # (Q, E) int32
    cur_safe: torch.Tensor    # (Q, E) int64: expanded node, 0 elsewhere
    dot_slack: torch.Tensor   # (Q,) f32: the slack level of this step
    next_step: torch.Tensor   # () int32: the steps run after this one


class Expanded(NamedTuple):
    nbr_ids: torch.Tensor     # (Q, E*R) int32, as the fused rows hold them
    est: torch.Tensor         # (Q, E*R) f32 estimated distances
    lower: torch.Tensor       # (Q, E*R) f32 their lower bounds
    cand_ok: torch.Tensor     # (Q, E*R) bool: new, past the lower gate
    rerank: torch.Tensor      # (Q, E*R) bool: also past the estimate gate
    rr_slots: torch.Tensor | None  # (Q, rw) int64 candidates picked, None
                                   # when rw = E*R (all of them)
    rr_node: torch.Tensor     # (Q, rw) int64 their node ids (0: invalid)
    rr_ok: torch.Tensor       # (Q, rw) bool: rerank at those slots
    est_rr: torch.Tensor      # (Q, rw) f32: est at those slots


class Merged(NamedTuple):
    res_ids: torch.Tensor
    res_d: torch.Tensor
    res_step: torch.Tensor
    last_improve: torch.Tensor
    beam_est: torch.Tensor
    beam_ids: torch.Tensor
    beam_lower: torch.Tensor
    ratio: torch.Tensor       # (Q, rw) f32: est / exact of the candidates
                              # that feed the gamma adaptation, 0 elsewhere
    contrib: torch.Tensor     # (Q, rw) bool: those candidates


def _pop_plain(s: BeamState, c: _Consts) -> Popped:
    """Pop the best E beam entries of each query: the DABS termination,
    the lower-bound skip, the nodes to expand and the slack level; and
    count the step."""
    k, expand_width = c.k, c.expand_width
    num_levels = c.params.slack_levels.shape[0]
    beam_est = s.beam_est
    pop_est, pop_slots = top_k_smallest(beam_est, expand_width)
    pop_lower = s.beam_lower.gather(1, pop_slots)
    pop_ids = s.beam_ids.gather(1, pop_slots)
    pop_valid = pop_est < FLOAT_MAX

    d_k = s.res_d[:, k - 1]
    res_full = d_k < FLOAT_MAX
    terminate = res_full & (pop_est[:, 0] >= s.gamma_q * d_k)
    done = s.done | ~pop_valid[:, 0] | terminate
    active = ~done

    popped = torch.zeros_like(beam_est, dtype=torch.bool).scatter_(
        1, pop_slots, pop_valid)
    beam_est = torch.where(active[:, None] & popped, FLOAT_MAX, beam_est)

    # per-entry lower-bound expansion skip
    skip = res_full[:, None] & (pop_lower > d_k[:, None])
    expand_e = active[:, None] & pop_valid & ~skip            # (Q, E)
    expand = expand_e.any(dim=1)
    cur_safe = torch.where(expand_e, pop_ids, 0).long()       # (Q, E)

    # slack-level escalation
    dot_slack = c.params.slack_levels[s.slack_cnt.clamp_max(num_levels - 1)]
    slack_cnt = s.slack_cnt + expand_e.sum(dim=1, dtype=torch.int32)
    return Popped(beam_est, done, slack_cnt, active, expand, expand_e,
                  pop_ids, cur_safe, dot_slack, s.steps + 1)


def _expand_plain(s: BeamState, c: _Consts, pop: Popped,
                  d_qp_sq) -> Expanded:
    """Score the E*R neighbours of the popped nodes (d_qp_sq: (Q, E)
    exact distances to them), drop the seen ones and the repeats, mark the
    new ones visited (s.visited, in place), gate them, and pick the rw to
    rerank exactly."""
    q = s.beam_est.shape[0]
    n, p = c.raw.shape
    r, k, bits, params = c.r, c.k, c.bits, c.params
    expand_width = c.expand_width
    er = expand_width * r
    h_size = c.h_size
    visited = s.visited
    k_scale = float((1 << bits) - 1)
    msb_scale = 1.0 if bits < 2 else 3.0
    d_k = s.res_d[:, k - 1]
    res_full = d_k < FLOAT_MAX
    expand_e, cur_safe = pop.expand_e, pop.cur_safe

    # ---- score all E*R candidates per query ----
    g = c.fused[cur_safe]                                    # (Q, E, F)
    nbr_ids = g[..., :r].reshape(q, er)
    valid = (nbr_ids >= 0) & expand_e.repeat_interleave(r, dim=1)
    nbr_safe = torch.where(valid, nbr_ids, 0).long()
    aux = g[..., r:5 * r].view(torch.float32).reshape(
        q, expand_width, 4, r).permute(2, 0, 1, 3).reshape(4, q, er)
    planes = g[..., 5 * r:(5 + bits * c.words) * r].reshape(
        q, expand_width, bits, c.words, r).permute(0, 1, 4, 2, 3)
    u = pack.unpack_planes(planes, p).reshape(q, er, p)
    fs = estimate.fastscan_sums(u, c.q_u)
    ip_full = estimate.ip_from_fastscan(fs, aux[3], *c.coeff, k_scale)
    if bits >= 2:
        # planes 0-1 as 2*p0 + p1 (pack.unpack_msb) are the top two bits
        # of u
        u_msb = u >> (bits - 2)
        ip_bound = estimate.ip_from_fastscan(
            estimate.fastscan_sums(u_msb, c.q_u),
            pack.weighted_popcount(u_msb), *c.coeff, msb_scale)
    else:
        ip_bound = ip_full

    calib = estimate.CalibParams(
        affine_a=params.affine_a, affine_b=params.affine_b,
        ip_qo_floor=params.ip_qo_floor, dot_slack=pop.dot_slack[:, None])
    est, lower = estimate.distances_with_bounds(
        ip_full, ip_bound, aux[0], aux[1], aux[2],
        d_qp_sq.repeat_interleave(r, dim=1), calib)

    # ---- dedup + gates ----
    if h_size:
        slot = nbr_safe % h_size
        seen = visited.gather(1, slot) == nbr_safe
    else:
        seen = visited.gather(1, nbr_safe)
    # intra-step dedup: keep the first occurrence of a neighbour that two
    # popped nodes share
    dup_prior = ((nbr_ids[:, :, None] == nbr_ids[:, None, :])
                 & c.earlier & valid[:, None, :]).any(dim=-1)
    cand_ok = valid & ~seen & ~dup_prior
    if h_size:
        mark = _last_writers(slot, cand_ok)
        visited.scatter_(1, torch.where(mark, slot, h_size),
                         torch.where(mark, nbr_safe, -1).int())
    else:
        visited.scatter_(1, torch.where(cand_ok, nbr_safe, n), True)

    warmup = ~res_full
    cand_ok = cand_ok & (warmup[:, None] | (lower < d_k[:, None]))
    rerank = cand_ok & (warmup[:, None] | (est < d_k[:, None]))

    # ---- capped exact rerank: only the rw best estimates fetch raw
    # vectors; the rest keep their estimates ----
    if c.rw == er:
        return Expanded(nbr_ids, est, lower, cand_ok, rerank, None,
                        nbr_safe, rerank, est)
    rr_slots = top_k_smallest(torch.where(rerank, est, FLOAT_MAX),
                              c.rw)[1]                       # (Q, rw)
    return Expanded(nbr_ids, est, lower, cand_ok, rerank, rr_slots,
                    nbr_safe.gather(1, rr_slots), rerank.gather(1, rr_slots),
                    est.gather(1, rr_slots))


def _merge_plain(s: BeamState, c: _Consts, pop: Popped, d_qp_sq,
                 ex: Expanded, exact_rr, next_step) -> Merged:
    """Push the reranked candidates (exact_rr: (Q, rw) their exact
    distances) and the popped nodes into the results, enqueue the
    candidates under the DABS gate into the beam, and give each reranked
    candidate's est / exact ratio to the gamma adaptation."""
    k = c.k
    res_ids, res_d, res_step = s.res_ids, s.res_d, s.res_step
    active, expand, expand_e = pop.active, pop.expand, pop.expand_e
    pop_ids, beam_est = pop.pop_ids, pop.beam_est
    rr_ok, rr_node, est_rr = ex.rr_ok, ex.rr_node, ex.est_rr
    warmup = ~(res_d[:, k - 1] < FLOAT_MAX)

    # ---- result heap pushes: reranked candidates + popped nodes ----
    pop_in_res = ((pop_ids[:, :, None] == res_ids[:, None, :])
                  & (pop_ids >= 0)[:, :, None]).any(dim=-1)
    rr_in_res = ((rr_node[:, :, None] == res_ids[:, None, :])
                 & rr_ok[:, :, None]).any(dim=-1)
    push_ids = torch.cat([rr_node.int(), pop.cur_safe.int()], dim=1)
    push_d = torch.cat([
        torch.where(rr_ok & ~rr_in_res, exact_rr, FLOAT_MAX),
        torch.where(expand_e & ~pop_in_res, d_qp_sq, FLOAT_MAX),
    ], dim=1)
    new_ids, new_d, new_step = _merge_results(
        res_ids, res_d, res_step, push_ids, push_d, next_step, k)
    new_d = torch.where(expand[:, None], new_d, res_d)
    improved = expand & (new_d != res_d).any(dim=1)
    res_ids = torch.where(expand[:, None], new_ids, res_ids)
    res_d = new_d
    res_step = torch.where(expand[:, None], new_step, res_step)
    last_improve = torch.where(improved & active, next_step, s.last_improve)

    # ---- DABS enqueue gate ----
    d_k_new = res_d[:, k - 1]
    dabs_thresh = torch.where(d_k_new < FLOAT_MAX, s.gamma_q * d_k_new,
                              FLOAT_MAX)[:, None]
    # reranked entries carry exact distances as beam priority
    if ex.rr_slots is None:
        enq_val = torch.where(ex.rerank, exact_rr, ex.est)
    else:
        enq_val = ex.est.scatter(1, ex.rr_slots,
                                 torch.where(rr_ok, exact_rr, est_rr))
    enq_lower = torch.where(warmup[:, None], enq_val, ex.lower)
    enq = ex.cand_ok & (enq_val < dabs_thresh)
    all_est = torch.cat([beam_est, torch.where(enq, enq_val, FLOAT_MAX)],
                        dim=1)
    beam_cap = beam_est.shape[1]
    beam_est_new, slot_b = top_k_smallest(all_est, beam_cap)
    beam_ids_new = torch.cat([s.beam_ids, ex.nbr_ids], dim=1).gather(
        1, slot_b)
    beam_lower_new = torch.cat([s.beam_lower, enq_lower], dim=1).gather(
        1, slot_b)
    beam_est = torch.where(active[:, None], beam_est_new, beam_est)
    beam_ids = torch.where(active[:, None], beam_ids_new, s.beam_ids)
    beam_lower = torch.where(active[:, None], beam_lower_new, s.beam_lower)

    # ---- the gamma adaptation's terms ----
    contrib = rr_ok & ~warmup[:, None] & (exact_rr > EPS_SMALL)
    ratio = torch.where(contrib, est_rr / exact_rr.clamp_min(EPS_SMALL),
                        0.0)
    return Merged(res_ids, res_d, res_step, last_improve, beam_est,
                  beam_ids, beam_lower, ratio, contrib)


def _lane_sums(x: torch.Tensor) -> torch.Tensor:
    """The sum of each row of x (Q, w) in the order of the gamma kernel's
    warp: lane l adds the entries l, l + 32, l + 64, ... in turn onto +0.0
    (here w zero-padded to a multiple of 32: adding +0.0 to a sum that
    started at +0.0 changes no bit), then the lanes fold in halves at 16,
    8, 4, 2, 1.  Each op rounds once, on every device."""
    q, w = x.shape
    m = -(-w // 32)
    lanes = torch.nn.functional.pad(x, (0, 32 * m - w)).view(q, m, 32)
    acc = torch.zeros((q, 32), dtype=x.dtype, device=x.device)
    for i in range(m):
        acc = acc + lanes[:, i]
    for half in (16, 8, 4, 2, 1):
        acc = acc[:, :half] + acc[:, half:2 * half]
    return acc[:, 0]


def _gamma_plain(s: BeamState, c: _Consts, expand, ratio, contrib):
    """The online gamma_q adaptation from each query's ratios this step
    (ratio, contrib: (Q, rw), the merge's), summed with their squares by
    _lane_sums: (gamma_q, ratio_sum, ratio_sq, ratio_cnt)."""
    params = c.params
    row_sum, row_sq = _lane_sums(ratio), _lane_sums(ratio * ratio)
    ratio_sum = s.ratio_sum + torch.where(expand, row_sum, 0.0)
    ratio_sq = s.ratio_sq + torch.where(expand, row_sq, 0.0)
    ratio_cnt = s.ratio_cnt + torch.where(
        expand, contrib.sum(dim=1, dtype=torch.int32), 0)
    cnt_f = ratio_cnt.float().clamp_min(1.0)
    r_mean = ratio_sum / cnt_f
    r_std = torch.sqrt((ratio_sq / cnt_f - r_mean * r_mean).clamp_min(0.0))
    gamma_new = torch.clamp(
        params.gamma * (1.0 + params.gamma_beta * r_std),
        params.gamma, params.gamma_max)
    gamma_q = torch.where(expand & (ratio_cnt >= params.gamma_warmup),
                          gamma_new, s.gamma_q)
    return gamma_q, ratio_sum, ratio_sq, ratio_cnt


def _on_cpu(s: BeamState) -> bool:
    return s.done.device.type == "cpu"


def _pop(s: BeamState, c: _Consts) -> Popped:
    """``_pop_plain`` on the CPU; on CUDA ``beam_step.beam_pop``'s kernel,
    which writes beam_est, done and slack_cnt in place."""
    if _on_cpu(s):
        return _pop_plain(s, c)
    return Popped(s.beam_est, s.done, s.slack_cnt, *beam_step.beam_pop(
        s.beam_est, s.beam_ids, s.beam_lower, s.res_d, s.gamma_q, s.done,
        s.slack_cnt, c.params.slack_levels, s.steps, c.expand_width))


def _expand(s: BeamState, c: _Consts, pop: Popped, d_qp_sq) -> Expanded:
    """``_expand_plain`` on the CPU; on CUDA ``beam_step.beam_expand``'s
    kernel (which also writes the visited table in place)."""
    if _on_cpu(s):
        return _expand_plain(s, c, pop, d_qp_sq)
    p = c.params
    return Expanded(*beam_step.beam_expand(
        c.fused, c.q_u, *(t.squeeze(1) for t in c.coeff), s.res_d,
        pop.active, pop.expand_e, pop.cur_safe, pop.dot_slack, d_qp_sq,
        s.visited, r=c.r, bits=c.bits, words=c.words, rw=c.rw,
        affine_a=p.affine_a, affine_b=p.affine_b, ip_qo_floor=p.ip_qo_floor))


def _merge(s: BeamState, c: _Consts, pop: Popped, d_qp_sq, ex: Expanded,
           exact_rr, next_step) -> Merged:
    """``_merge_plain`` on the CPU; on CUDA ``beam_step.beam_merge``'s
    kernel, which writes the results, the beam and last_improve in
    place."""
    if _on_cpu(s):
        return _merge_plain(s, c, pop, d_qp_sq, ex, exact_rr, next_step)
    ratio, contrib = beam_step.beam_merge(
        s.res_ids, s.res_d, s.res_step, s.last_improve, pop.beam_est,
        s.beam_ids, s.beam_lower, s.gamma_q, next_step, pop.active,
        pop.expand, pop.expand_e, pop.pop_ids, pop.cur_safe, d_qp_sq, *ex,
        exact_rr)
    return Merged(s.res_ids, s.res_d, s.res_step, s.last_improve,
                  pop.beam_est, s.beam_ids, s.beam_lower, ratio, contrib)


def _gamma(s: BeamState, c: _Consts, expand, ratio, contrib):
    """``_gamma_plain`` on the CPU; on CUDA ``beam_step.beam_gamma``'s
    kernel, which writes gamma_q and the ratio terms in place."""
    if _on_cpu(s):
        return _gamma_plain(s, c, expand, ratio, contrib)
    p = c.params
    beam_step.beam_gamma(s.ratio_sum, s.ratio_sq, s.ratio_cnt, s.gamma_q,
                         expand, ratio, contrib, p.gamma, p.gamma_max,
                         p.gamma_beta, p.gamma_warmup)
    return s.gamma_q, s.ratio_sum, s.ratio_sq, s.ratio_cnt


def _step(s: BeamState, c: _Consts) -> BeamState:
    """One beam step for the whole batch.  Fixed shapes and no value read
    on the host, so a chunk of steps can be captured in a CUDA graph.  On
    CUDA its pop, expansion, merge and gamma update are the kernels of
    kernels/beam_step.py, which update the state in place; on the CPU
    their plain versions."""
    return _segments_step(s, c, _pop, _expand, _merge, _gamma)


def _plain_step(s: BeamState, c: _Consts) -> BeamState:
    """_step from the plain versions of its segments, on any device: the
    torch step that the kernels are held to."""
    return _segments_step(s, c, _pop_plain, _expand_plain, _merge_plain,
                          _gamma_plain)


def _segments_step(s: BeamState, c: _Consts, pop_fn, expand_fn, merge_fn,
                   gamma_fn) -> BeamState:
    pop = pop_fn(s, c)
    # exact distance to each popped node = d_qp^2
    d_qp_sq = estimate.exact_l2_sq(c.qpad, c.qnorm, c.raw[pop.cur_safe],
                                   c.norm_sq[pop.cur_safe])   # (Q, E)
    ex = expand_fn(s, c, pop, d_qp_sq)
    rr_vecs = c.raw[ex.rr_node]                               # (Q, rw, P)
    exact_rr = estimate.exact_l2_sq(c.qpad, c.qnorm, rr_vecs,
                                    (rr_vecs * rr_vecs).sum(dim=-1))
    m = merge_fn(s, c, pop, d_qp_sq, ex, exact_rr, pop.next_step)
    gamma_q, ratio_sum, ratio_sq, ratio_cnt = gamma_fn(
        s, c, pop.expand, m.ratio, m.contrib)
    return BeamState(
        beam_ids=m.beam_ids, beam_est=m.beam_est, beam_lower=m.beam_lower,
        res_ids=m.res_ids, res_d=m.res_d, visited=s.visited, gamma_q=gamma_q,
        ratio_sum=ratio_sum, ratio_sq=ratio_sq, ratio_cnt=ratio_cnt,
        slack_cnt=pop.slack_cnt, done=pop.done, steps=pop.next_step,
        last_improve=m.last_improve, res_step=m.res_step)
