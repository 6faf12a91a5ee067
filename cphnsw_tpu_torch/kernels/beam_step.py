"""Launchers of the graph beam step's hand-written CUDA kernels.

``search/beam.py``'s step runs, in order: the step counter and the pop
(``beam_pop``), the exact distance to each popped node (torch,
``estimate.exact_l2_sq``), the expansion of the popped nodes' E*R
neighbours (``beam_expand``), the exact distances of the candidates it
picked for the rerank (torch), the merge of results and beam
(``beam_merge``) and the gamma adaptation from the merge's ratios
(``beam_gamma``, which sums them itself). The exact distances stay torch
ops between the kernels: their dot products keep torch's order, and a
function patched into ``estimate.exact_l2_sq`` still reaches every exact
distance of the search.

Each launcher takes the tensors its kernel reads and writes, CUDA tensors
only (``csrc/beam_step.cu``: the expansion and the merge one block per
query, the pop and the gamma update a warp per query), and launches on the
current stream, so a CUDA graph captures it; it raises on any other
tensor, on a shape the plan refuses and on a CUDA error.  The pop and the
gamma update launch with programmatic stream serialization, so that their
blocks may start while the kernel before them ends.  The segments' plain
versions, which the CPU runs and the kernels are held to bit for bit, are
``search/beam.py``'s (``_pop`` and the like choose by the state's device).
The kernels update the state in place, and a query that is done returns at
once; where a query is not active they write what the next segments read
(no node to expand, node 0 to rerank, the gamma terms 0).

``launch_plan`` is each launch's shape in plain Python: the kernel's
variant, threads per block, and the bytes of each block's workspace, kept
in dynamic shared memory where it fits (``SMEM_PER_BLOCK``) and else in a
global scratch buffer of one slice per query.  The pop has one variant,
"warp" (a warp per query, no workspace, every beam_cap). The expansion and
the merge have two variants each.  The Hopper ones ("bulk": rows by bulk
copy, popcount fastscan, warp matches; "rank": warp sorts merged by rank)
work in shared memory, one thread an entry, and take E*R up to 1,024 and
the merge's sorts up to 768 entries; the generic ones (bitonic sorts, a
candidate loop) take every other shape, also from global scratch.  The
plan chooses by shape, never on error.  The CUDA source is compiled with
``nvcc`` at first use into ``build/cphnsw_tpu_torch/``
(``kernels/nvcc.py``) and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from cphnsw_tpu_torch.kernels import nvcc
from cphnsw_tpu_torch.ops import pack
from cphnsw_tpu_torch.ops.estimate import F32_EXACT_INT
from cphnsw_tpu_torch.ops.quantize import EPS_MEDIUM, EPS_SMALL, LUT_LEVELS

SOURCE = nvcc.CSRC / "beam_step.cu"
# Bit planes the expansion unpacks (the graph index takes 1, 2 or 4).
MAX_BITS = 4
# Workspace bytes a block keeps in dynamic shared memory: the H100's
# 227 KB opt-in less 1 KB for the merge's static flag; a larger workspace
# lives in global scratch.
SMEM_PER_BLOCK = 231_424
# threads per block of the pop and the gamma update (one warp per query)
WARP_THREADS = 256
# Entries a Hopper variant takes, one a thread: the threads its launch
# bounds allow (csrc/beam_step.cu).
MAX_BLOCK = {"bulk": 1024, "rank": 768}
# ints of a Hopper sort's per-warp counts (block_rank: 3 x 32 warps)
RANK_COUNTS = 96
# True: every plan names the generic expansion and merge, which take every
# shape (so that both variants can be held to the plain step and timed
# side by side at one shape); the pop has no generic variant.
GENERIC_ONLY = False
# the variant argument of the C launchers
_VARIANT_IDS = {"generic": 0, "bulk": 1, "rank": 1}

# Launches of each kernel (host calls that launch it, captured ones
# included: a CUDA graph's replays launch it again without a call); the
# plain versions do not count.
pop_launches = 0
expand_launches = 0
merge_launches = 0
gamma_launches = 0
# the launches of the expansion and the merge by variant (in the totals
# above too)
expand_variant_launches = {"bulk": 0, "generic": 0}
merge_variant_launches = {"rank": 0, "generic": 0}


class Plan(NamedTuple):
    threads: int      # per block (one block per query)
    workspace: int    # bytes per block
    smem: int         # dynamic shared bytes: the workspace, or 0 when it
                      # lives in global scratch
    variant: str = "generic"   # "bulk" / "rank" / "warp": the Hopper
                               # variants


class LaunchPlan(NamedTuple):
    pop: Plan
    expand: Plan
    merge: Plan


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _carve(*arrays: tuple[int, int]) -> int:
    """Bytes of a workspace of (count, item bytes) arrays, each rounded up
    to 16 bytes (the kernels' Carve)."""
    return sum(-(-count * size // 16) * 16 for count, size in arrays)


def _plan(threads: int, workspace: int) -> Plan:
    return Plan(threads, workspace,
                workspace if workspace <= SMEM_PER_BLOCK else 0)


def _hopper(variant: str, entries: int, workspace: int) -> Plan | None:
    """A Hopper variant's plan (one thread an entry, in warps; the
    workspace in shared memory), or None where it does not hold the
    shape."""
    threads = 32 * -(-entries // 32)
    if GENERIC_ONLY or threads > MAX_BLOCK[variant] or \
            workspace > SMEM_PER_BLOCK:
        return None
    return Plan(threads, workspace, workspace, variant)


def _refuse(checks):
    for ok, why in checks:
        if not ok:
            raise ValueError(f"beam_step kernels: {why}")


def pop_plan(q: int, beam_cap: int, expand_width: int) -> Plan:
    """The pop's launch: a warp per query, WARP_THREADS a block, selecting
    the E smallest beam entries in E rounds of a warp argmin; no
    workspace, any beam_cap."""
    _refuse(((q >= 1, f"q = {q}: no query to launch"),
             (1 <= expand_width <= beam_cap,
              f"expand_width {expand_width} outside 1..beam_cap "
              f"{beam_cap}")))
    return Plan(WARP_THREADS, 0, 0, "warp")


def expand_plan(q: int, expand_width: int, r: int, rw: int, p: int,
                bits: int, words: int, rows_aligned: bool = True) -> Plan:
    """The expansion's launch: the query's levels and E*R candidates per
    query, and a sort of them when rw < E*R.  P is refused where the plain
    step's float32 fastscan sums would lose exactness
    (``estimate.fastscan_sums``).  "bulk" where its workspace fits in
    shared memory (the popped rows' used spans, the query's level planes,
    two tables of 2 E*R slots, and the sort's runs, ranks and counts when
    rw < E*R) and the rows are 16-byte aligned (rows_aligned: the fused
    store's base and row stride), else "generic"."""
    er = expand_width * r
    _refuse(((q >= 1, f"q = {q}: no query to launch"),
             (expand_width >= 1 and r >= 1,
              f"E = {expand_width}, R = {r}: no candidate"),
             (1 <= rw <= er, f"rerank width {rw} outside 1..{er}"),
             (1 <= bits <= MAX_BITS, f"bits {bits} outside 1..{MAX_BITS}"),
             (p >= 1 and words == -(-p // pack.WORD_BITS),
              f"P = {p} in {words} words"),
             (LUT_LEVELS * LUT_LEVELS * p < F32_EXACT_INT,
              f"P = {p}: the plain step's fastscan sums would exceed 2^24")))
    threads = 32 * -(-er // 32)
    runs = threads if rw < er else 0
    row_words = -(-(5 + bits * words) * r // 4) * 4
    bulk = rows_aligned and _hopper("bulk", er, _carve(
        (1, 8), (expand_width * row_words, 4), (words * 4, 4),
        *[(_pow2(2 * er), 4)] * 4, (runs, 8), (runs, 4),
        (RANK_COUNTS if runs else 0, 4)))
    if bulk:
        return bulk
    sort = _pow2(er) if rw < er else 0
    return _plan(128 if er <= 128 else 256,
                 _carve((sort, 8), (p, 4), *[(er, 4)] * 5, (er, 1), (er, 1)))


def merge_plan(q: int, beam_cap: int, k: int, expand_width: int, r: int,
               rw: int) -> Plan:
    """The merge's launch: a sort of k + rw + E results and pushes and one
    of beam_cap + E*R beam entries per query.  "rank" where both sorts
    have at most MAX_BLOCK["rank"] entries and its workspace fits in
    shared memory (a run entry and a rank a thread, the per-warp counts,
    the old results' distances, a set of 2 k slots, the enqueue values),
    else "generic"."""
    er = expand_width * r
    _refuse(((q >= 1, f"q = {q}: no query to launch"),
             (k >= 1, f"k = {k}"),
             (1 <= expand_width <= beam_cap and r >= 1,
              f"E = {expand_width}, R = {r}, beam_cap {beam_cap}"),
             (1 <= rw <= er, f"rerank width {rw} outside 1..{er}")))
    m, nb = k + rw + expand_width, beam_cap + er
    threads = 32 * -(-max(m, nb) // 32)
    rank = _hopper("rank", max(m, nb), _carve(
        (threads, 8), (threads, 4), (RANK_COUNTS, 4), (k, 4),
        (_pow2(2 * k), 4), (er, 4)))
    if rank:
        return rank
    return _plan(256, _carve((_pow2(m), 8), (_pow2(nb), 8), *[(m, 4)] * 3,
                             *[(nb, 4)] * 3, (er, 4)))


def launch_plan(q: int, beam_cap: int, k: int, expand_width: int, r: int,
                rw: int, p: int, bits: int, words: int) -> LaunchPlan:
    """The pop, expand and merge launches for a batch of q queries (the
    pop a warp each, the others a block each; the fused rows 16-byte
    aligned, as the index stores them), or ValueError for a shape the
    kernels refuse.  The gamma update takes any shape: WARP_THREADS, a
    warp per query."""
    if k < 1:
        raise ValueError(f"beam_step kernels: k = {k}")
    return LaunchPlan(pop_plan(q, beam_cap, expand_width),
                      expand_plan(q, expand_width, r, rw, p, bits, words),
                      merge_plan(q, beam_cap, k, expand_width, r, rw))


def build_library(extra_flags=(),
                  build_dir: Path = nvcc.BUILD_DIR) -> tuple[Path, float]:
    """Compile csrc/beam_step.cu (``nvcc.build_library``); returns (path,
    seconds spent compiling), 0.0 when it was built already."""
    return nvcc.build_library(SOURCE, extra_flags, build_dir)


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


@functools.cache
def load_library(path: Path | None = None) -> ctypes.CDLL:
    """The ctypes handle of a build at `path`; None: the package's own
    build, compiled at first use."""
    lib = nvcc.load(build_library()[0] if path is None else path)
    lib.beam_pop_launch.argtypes = [_P] * 16 + [_I] * 6 + [_P]
    lib.beam_expand_launch.argtypes = (
        [_P, _L] + [_P] * 20 + [_I] * 9 + [_L] + [_F] * 7 + [_I] * 3
        + [_P, _L, _P])
    lib.beam_merge_launch.argtypes = [_P] * 27 + [_I] * 6 + [_F] + \
        [_I] * 3 + [_P, _L, _P]
    lib.beam_gamma_launch.argtypes = [_P] * 7 + [_I] * 2 + [_F] * 3 + \
        [_I] * 2 + [_P]
    for fn in (lib.beam_pop_launch, lib.beam_expand_launch,
               lib.beam_merge_launch, lib.beam_gamma_launch):
        fn.restype = ctypes.c_int
    return lib


def _cuda(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the beam step's kernels take CUDA tensors, not "
                         f"{t.device}: the plain step of search/beam.py "
                         f"runs there")
    return t.device


def _check(dev, **tensors):
    """Each name=(tensor, dtype, shape) lies on dev, contiguous, as
    given."""
    for name, (t, dtype, shape) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _scalars(*xs):
    if any(torch.is_tensor(x) for x in xs):
        raise TypeError("the beam step's scalars must be Python numbers "
                        "(a tensor would be read on the host)")


def _launch(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _ptrs(*tensors) -> list:
    return [None if t is None else t.data_ptr() for t in tensors]


def _scratch(plan: Plan, q: int, dev) -> tuple:
    """The global scratch of a workspace too large for shared memory (its
    pointer and the bytes of one query's slice), or (None, bytes)."""
    if plan.smem or not plan.workspace:
        return None, plan.workspace
    return torch.empty(q * plan.workspace, dtype=torch.uint8,
                       device=dev), plan.workspace


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def beam_pop(beam_est, beam_ids, beam_lower, res_d, gamma_q, done,
             slack_cnt, slack_levels, steps, expand_width: int):
    """Launch ``beam_pop_kernel``: the step counter (steps: the () int32
    steps run) and the pop of the best expand_width beam entries of each
    query.  Writes beam_est (popped entries of active queries to
    FLOAT_MAX), done and slack_cnt in place; returns (active, expand,
    expand_e, pop_ids, cur_safe, dot_slack, next_step)."""
    global pop_launches
    dev = _cuda(beam_est)
    q, beam_cap = beam_est.shape
    k = res_d.shape[1]
    plan = pop_plan(q, beam_cap, expand_width)
    ew = expand_width
    _check(dev, beam_est=(beam_est, torch.float32, (q, beam_cap)),
           beam_ids=(beam_ids, torch.int32, (q, beam_cap)),
           beam_lower=(beam_lower, torch.float32, (q, beam_cap)),
           res_d=(res_d, torch.float32, (q, k)),
           gamma_q=(gamma_q, torch.float32, (q,)),
           done=(done, torch.bool, (q,)),
           slack_cnt=(slack_cnt, torch.int32, (q,)),
           slack_levels=(slack_levels, torch.float32, slack_levels.shape[:1]),
           steps=(steps, torch.int32, ()))
    out = (torch.empty(q, dtype=torch.bool, device=dev),
           torch.empty(q, dtype=torch.bool, device=dev),
           torch.empty((q, ew), dtype=torch.bool, device=dev),
           torch.empty((q, ew), dtype=torch.int32, device=dev),
           torch.empty((q, ew), dtype=torch.int64, device=dev),
           torch.empty(q, dtype=torch.float32, device=dev),
           torch.empty((), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        _launch("beam_pop_kernel", load_library().beam_pop_launch(
            *_ptrs(beam_est, beam_ids, beam_lower, res_d, gamma_q, done,
                   slack_cnt, slack_levels, steps, *out),
            q, beam_cap, k, ew, slack_levels.shape[0], plan.threads,
            _stream(dev)))
    pop_launches += 1
    return out


def beam_expand(fused, q_u, coeff_a, coeff_b, coeff_c, res_d, active,
                expand_e, cur_safe, dot_slack, d_qp_sq, visited, *, r: int,
                bits: int, words: int, rw: int, affine_a: float,
                affine_b: float, ip_qo_floor: float):
    """Launch ``beam_expand_kernel``: score the E*R neighbours of the
    popped nodes (d_qp_sq: (Q, E) exact distances to them), drop the seen
    ones and the repeats, mark the new ones in visited (in place: (Q,
    2^b + 1) int32 hashed, or (Q, n + 1) bool), gate them and pick the rw
    to rerank.  Returns (nbr_ids, est, lower, cand_ok, rerank, rr_slots,
    rr_node, rr_ok, est_rr); rr_slots is None when rw = E*R (then rr_ok
    is rerank and est_rr is est)."""
    global expand_launches
    dev = _cuda(q_u)
    q, p = q_u.shape
    k, ew = res_d.shape[1], cur_safe.shape[1]
    er = ew * r
    plan = expand_plan(q, ew, r, rw, p, bits, words,
                       fused.data_ptr() % 16 == 0 and fused.shape[1] % 4 == 0)
    _scalars(affine_a, affine_b, ip_qo_floor)
    slots = visited.shape[1] - 1
    if visited.dtype == torch.int32:
        h_size, rows = slots, fused.shape[0]
        if h_size < 1 or h_size & (h_size - 1):
            raise ValueError(f"a hashed visited table has 2^b + 1 slots, "
                             f"not {slots + 1}")
    else:
        h_size, rows = 0, slots
    width = (5 + bits * words) * r
    if fused.shape[0] != rows or fused.shape[1] < width:
        raise ValueError(f"fused rows {tuple(fused.shape)} must be ({rows}, "
                         f">= {width})")
    _check(dev, fused=(fused, torch.int32, fused.shape),
           q_u=(q_u, torch.int32, (q, p)),
           coeff_a=(coeff_a, torch.float32, (q,)),
           coeff_b=(coeff_b, torch.float32, (q,)),
           coeff_c=(coeff_c, torch.float32, (q,)),
           res_d=(res_d, torch.float32, (q, k)),
           active=(active, torch.bool, (q,)),
           expand_e=(expand_e, torch.bool, (q, ew)),
           cur_safe=(cur_safe, torch.int64, (q, ew)),
           dot_slack=(dot_slack, torch.float32, (q,)),
           d_qp_sq=(d_qp_sq, torch.float32, (q, ew)),
           visited=(visited, visited.dtype, (q, slots + 1)))
    if visited.dtype not in (torch.int32, torch.bool):
        raise TypeError(f"visited must be int32 (hashed) or bool (dense), "
                        f"got {visited.dtype}")

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    nbr_ids, est, lower = (empty((q, er), torch.int32),
                           empty((q, er), torch.float32),
                           empty((q, er), torch.float32))
    cand_ok, rerank = empty((q, er), torch.bool), empty((q, er), torch.bool)
    rr_node = empty((q, rw), torch.int64)
    if rw == er:
        rr_slots, rr_ok, est_rr = None, rerank, est
    else:
        rr_slots, rr_ok, est_rr = (empty((q, rw), torch.int64),
                                   empty((q, rw), torch.bool),
                                   empty((q, rw), torch.float32))
    k_scale = float((1 << bits) - 1)
    msb_scale = 1.0 if bits < 2 else 3.0
    scratch, ws = _scratch(plan, q, dev)
    with torch.cuda.device(dev):
        _launch("beam_expand_kernel", load_library().beam_expand_launch(
            fused.data_ptr(), fused.shape[1],
            *_ptrs(q_u, coeff_a, coeff_b, coeff_c, res_d, active, expand_e,
                   cur_safe, dot_slack, d_qp_sq, visited, nbr_ids, est,
                   lower, cand_ok, rerank, rr_node, rr_ok, est_rr, rr_slots),
            q, k, ew, r, words, bits, p, rw, h_size, rows, float(affine_a),
            float(affine_b), float(ip_qo_floor), EPS_MEDIUM, EPS_SMALL,
            1.0 / k_scale, 1.0 / msb_scale, _VARIANT_IDS[plan.variant],
            plan.threads, plan.smem, *_ptrs(scratch), ws, _stream(dev)))
    expand_launches += 1
    expand_variant_launches[plan.variant] += 1
    return (nbr_ids, est, lower, cand_ok, rerank, rr_slots, rr_node, rr_ok,
            est_rr)


def beam_merge(res_ids, res_d, res_step, last_improve, beam_est, beam_ids,
               beam_lower, gamma_q, next_step, active, expand, expand_e,
               pop_ids, cur_safe, d_qp_sq, nbr_ids, est, lower, cand_ok,
               rerank, rr_slots, rr_node, rr_ok, est_rr, exact_rr):
    """Launch ``beam_merge_kernel``: push the reranked candidates (exact_rr:
    (Q, rw) their exact distances) and the popped nodes into the results,
    enqueue the candidates under the DABS gate into the beam, and give each
    reranked candidate's est / exact ratio to the gamma adaptation.  Writes
    the results, their push steps, last_improve and the beam in place;
    returns (ratio, contrib)."""
    global merge_launches
    dev = _cuda(res_d)
    q, k = res_d.shape
    beam_cap, ew = beam_est.shape[1], cur_safe.shape[1]
    er, rw = nbr_ids.shape[1], exact_rr.shape[1]
    if er % ew:
        raise ValueError(f"{er} candidates are not E = {ew} rows")
    plan = merge_plan(q, beam_cap, k, ew, er // ew, rw)
    _check(dev, res_ids=(res_ids, torch.int32, (q, k)),
           res_d=(res_d, torch.float32, (q, k)),
           res_step=(res_step, torch.int32, (q, k)),
           last_improve=(last_improve, torch.int32, (q,)),
           beam_est=(beam_est, torch.float32, (q, beam_cap)),
           beam_ids=(beam_ids, torch.int32, (q, beam_cap)),
           beam_lower=(beam_lower, torch.float32, (q, beam_cap)),
           gamma_q=(gamma_q, torch.float32, (q,)),
           next_step=(next_step, torch.int32, ()),
           active=(active, torch.bool, (q,)),
           expand=(expand, torch.bool, (q,)),
           expand_e=(expand_e, torch.bool, (q, ew)),
           pop_ids=(pop_ids, torch.int32, (q, ew)),
           cur_safe=(cur_safe, torch.int64, (q, ew)),
           d_qp_sq=(d_qp_sq, torch.float32, (q, ew)),
           nbr_ids=(nbr_ids, torch.int32, (q, er)),
           est=(est, torch.float32, (q, er)),
           lower=(lower, torch.float32, (q, er)),
           cand_ok=(cand_ok, torch.bool, (q, er)),
           rerank=(rerank, torch.bool, (q, er)),
           rr_node=(rr_node, torch.int64, (q, rw)),
           rr_ok=(rr_ok, torch.bool, (q, rw)),
           est_rr=(est_rr, torch.float32, (q, rw)),
           exact_rr=(exact_rr, torch.float32, (q, rw)))
    if (rr_slots is None) != (rw == er):
        raise ValueError("rr_slots must be given exactly when rw < E*R")
    if rr_slots is not None:
        _check(dev, rr_slots=(rr_slots, torch.int64, (q, rw)))
    ratio = torch.empty((q, rw), dtype=torch.float32, device=dev)
    contrib = torch.empty((q, rw), dtype=torch.bool, device=dev)
    scratch, ws = _scratch(plan, q, dev)
    with torch.cuda.device(dev):
        _launch("beam_merge_kernel", load_library().beam_merge_launch(
            *_ptrs(res_ids, res_d, res_step, last_improve, beam_est,
                   beam_ids, beam_lower, gamma_q, next_step, active, expand,
                   expand_e, pop_ids, cur_safe, d_qp_sq, nbr_ids, est, lower,
                   cand_ok, rerank, rr_node, rr_ok, est_rr, rr_slots,
                   exact_rr, ratio, contrib),
            q, beam_cap, k, ew, er, rw, EPS_SMALL, _VARIANT_IDS[plan.variant],
            plan.threads, plan.smem, *_ptrs(scratch), ws, _stream(dev)))
    merge_launches += 1
    merge_variant_launches[plan.variant] += 1
    return ratio, contrib


def beam_gamma(ratio_sum, ratio_sq, ratio_cnt, gamma_q, expand, ratio,
               contrib, gamma: float, gamma_max: float, gamma_beta: float,
               gamma_warmup: int):
    """Launch ``beam_gamma_kernel``: the online gamma_q adaptation from
    each query's ratios this step (ratio, contrib: (Q, rw), the merge's),
    summed in the plain segment's lane order.  Writes gamma_q, ratio_sum,
    ratio_sq and ratio_cnt in place."""
    global gamma_launches
    dev = _cuda(gamma_q)
    q, rw = contrib.shape
    _check(dev, ratio_sum=(ratio_sum, torch.float32, (q,)),
           ratio_sq=(ratio_sq, torch.float32, (q,)),
           ratio_cnt=(ratio_cnt, torch.int32, (q,)),
           gamma_q=(gamma_q, torch.float32, (q,)),
           expand=(expand, torch.bool, (q,)),
           ratio=(ratio, torch.float32, (q, rw)),
           contrib=(contrib, torch.bool, (q, rw)))
    _scalars(gamma, gamma_max, gamma_beta, gamma_warmup)
    if not -2**31 <= gamma_warmup < 2**31:
        raise ValueError("gamma_warmup must lie within int32")
    with torch.cuda.device(dev):
        _launch("beam_gamma_kernel", load_library().beam_gamma_launch(
            *_ptrs(ratio_sum, ratio_sq, ratio_cnt, gamma_q, expand, ratio,
                   contrib),
            q, rw, float(gamma), float(gamma_max), float(gamma_beta),
            int(gamma_warmup), WARP_THREADS, _stream(dev)))
    gamma_launches += 1
