"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:
  1. environment: a CUDA device, the toolchain (torch, CUDA, nvcc, triton);
  2. build: compile csrc/scan_keys.cu and csrc/beam_step.cu with nvcc from
     the checkout, one nvcc each, both started together, print ptxas's
     registers and spills per kernel (any spill fails); then
     fma_f32 (the one-rounding multiply-add under the kernel's plain
     version): the witness of a double rounding and a seeded sweep next
     to f32 midpoints, on the card against the CPU and against exact
     rational arithmetic, 0 mismatches, through both of its routes (the
     correction under the midpoint mask for small results, on the gathered
     hits for large ones), each route timed at a plain-version group's
     shape and a chunk's beside the float64 sum and cast;
  3. the scan_keys kernel against its plain PyTorch version at the main
     path's shapes (1M x 128d store, Q = 2048, bins = 1024): sketch mode
     (and 64- and 256-query batches, whose group axis is split over the
     card: timed against splits=1 too, merge_kernel launches counted) and
     estimate mode at bits 1/2/4; keys must be bit-equal; each with its
     bound (the larger of int8 operations at peak and bytes at the memory
     rate), roofline share and the product alone through torch._int_mm as
     a yardstick;
  4. the main drive: CPIndex(128, bits=1) on 1M x 128d synthetic data
     (seed 0, 256 clusters, 8192 queries, drawn on the card from JAX's
     Threefry stream as the JAX package draws it on its accelerator,
     ground truth on the card),
     build + finalize, one warm and 5 timed search_batch(k=10), recall@10
     >= 0.99 through the kernel; then a 100k x 128d 4-bit drive;
  5. save -> load round trip into a fresh CPIndex: equal ids; then the
     JAX package's other selections on the main index, one 2048-query
     sub-batch each: (a) the chunked selection (fused=False: int8
     products, per-bin top-2 keys; ms, recall@10, overlap with the kernel
     path, top_c, peak memory, a stage split), (b) exact_select (the
     recall ceiling), (c) the bf16 two-stage rerank of 4096 candidates
     (the branch that ran, against single-stage f32); (d) the Threefry
     recipe: seconds to draw 1M x 128d on the card, and the card against
     the CPU at 4096 x 64 (integer draws equal, max ulp of the normals);
     (e) BruteForceIndex(128, bits=1) on 100k x 128d: recall@10, QPS;
     (f) make_synthetic's disk cache at 100k x 128d in a directory under
     build/: the second call returns equal arrays from the file, both
     timed, the file removed afterwards (every other draw of this script
     passes cache_dir=None);
  6. the graph drive: CPIndex(128, bits=1, engine="graph") on the same 1M x
     128d data, build + finalize (seconds per stage), one warm and 5 timed
     search_batch(k=10) on the first 1024 queries, recall@10 >= 0.90 beside
     the seconds of NNDescent, the share of them its Threefry draws take
     on the card, and the build's peak device memory, the beam steps and
     ms per step (CUDA events), the memory the beam's kept graphs hold
     after the build (none added) and after the searches (within
     beam.KEPT_BYTES_PER_DEVICE), and each beam kernel's launches in this
     drive (the counters set to 0 just before it; none may be 0);
     (b) NNDescent's working graph of a 20k x
     32d store (R = 16) built on the card and on the CPU from the same
     Threefry keys: rows with equal edge sets >= 98% after the build and
     >= 99.9% after one round from the same init (a seed-4 build for
     scale), one round's priorities, sampling noise and reverse lists
     bit-equal;
  7. a 100k x 128d 4-bit graph drive (the MSB two-stage bound), recall@10
     >= 0.90 with the same NNDescent seconds and peak memory, each beam
     kernel's launches in it (none 0), the beam kernels against the plain
     torch step on its beam (hashed visited, 2^15 slots), state bit-equal
     after each of the first 16 steps and at the end, then save -> load
     into a fresh CPIndex: equal ids; (f) its beam with rerank_width = 8
     against 0 (rerank all): id overlap, each width warmed once and timed
     as the median of 5, the beam kernels' launches of the width-8 runs
     (none 0), and the kernels against the plain step at width 8 as in 7;
  8. torch.profiler over one warm 1M graph batch: device-busy share, the
     five kernels with the most device time, launches per beam step;
     (b) the beam replayed from its captured CUDA graph against the same
     step function launched eagerly: ids, distances, result steps and
     step count equal, also in the calls that replay a kept graph; the
     capture ms, ms per replay, the p50 batch of three routes (eager, a
     capture per call, the kept graph) and the memory the kept graph
     holds; (c) the beam step's four kernels (beam_pop, beam_expand,
     beam_merge, beam_gamma) against the plain torch step on the 1M graph
     index (1024 queries), step by step from the same seeded state: every
     state field bit-equal after each of the first 16 steps and at the end;
     ms per step of each segment (CUDA events: the kernels and the torch
     segments between them, on each path), each kernel's bound from the
     bytes its active queries need and its roofline share, device ops a
     step and launches per batch from the profile of phase 8; then the
     same check and timing with the expansion and the merge generic
     (beam_step.GENERIC_ONLY: their first design), so that each Hopper
     variant's ms stands beside the generic kernel's from the same run
     (the pop and the gamma update have no generic variant);
  9. the sharded scan: ShardedScanIndex(128, bits=1) on the same 1M x 128d
     data over a (1, 4) mesh of cuda:i % device_count (4 shards of
     250,112 rows on one card), shard-native build (seconds per stage),
     one warm and 5 timed search_batch(k=10) of 8192 queries with
     recall@10 >= 0.99, the kernel in estimate mode on every shard (at
     least one launch per shard per sub-batch), the kernel against its
     plain version on one shard's real operands (with its bound and
     yardstick), a per-shard stage split
     and the merge; (c) the same store and mesh through
     sharded_scan_search(fused=False), the JAX package's per-shard chunked
     selection on its local chunk plan, 2048 queries: recall@10 >= 0.99,
     id overlap with the kernel path >= 0.99, ms per batch, no kernel
     launch; (d) the JAX package's call form of sharded_scan_search (one
     signs tensor, CUDA queries): with fused=True, ids and distances equal
     search_batch's bit for bit; its default, the chunked selection,
     equals fused=False bit for bit and launches no kernel; then save ->
     load into a fresh single-device ScanIndex and a fresh
     ShardedScanIndex;
 10. the sharded graph: ShardedIndex(128, bits=1, r=32) on the same data
     and mesh, build stages, pooled params and step budget, one warm and
     3 timed searches of the first 1024 queries, recall@10 >= 0.90 beside
     the shards' NNDescent seconds and the build's peak memory, each beam
     kernel's launches in it (none 0), the beam kernels against the plain
     torch step on the first shard's beam (E = 1, beam_cap 128, dense
     visited) as in 7; (c) the
     JAX package's call form of sharded_search (one SearchParams, one
     signs tensor, n_real last, CUDA queries): ids and distances equal
     search_batch's bit for bit with n_real = n and with None (which
     masks nothing), and n_real = n - 10,000 masks the ids above; then a
     100k x 128d 4-bit sharded graph through save -> load: equal ids;
     (b) that graph through sharded_search(n_seeds=2) against n_seeds=4:
     k valid ids with exact distances from both, their overlap, the
     steps one shard's beam takes uncapped, and, with no step taken,
     n_seeds ids per shard in every merged list;
 11. the CLI: python -m cphnsw_tpu_torch --bits 1 --device cuda on
     synthetic-20k-64d as a subprocess, results and the data cache in a
     temporary directory;
 12. the JAX package's recorded scan workloads (WORKLOADS, as its
     results/<name>_results.json name them): synthetic-1m-128d,
     synthetic-1m-960d (P 1024), synthetic-100k-1536d-ip (inner product,
     1537 columns, P 2048: the streamed query tile) at 1 and 4 bits, and
     synthetic-10m-96d (10,240 bins, 977 groups) at k = 100 and 10.  Each
     is drawn by make_synthetic's default (the card, Threefry recipe, 1000
     queries, ground truth on the card, no cache) and run through
     eval.bench_one_case at k = 100 (build from the device store factory,
     one warm and 3 timed passes): build seconds per stage and the build's
     peak device memory, recall@1/10/100 beside the JAX record's, QPS,
     p50 batch latency, top_c and budget ranks beside the record's,
     launches per batch (at least one); then the kernel against its plain
     version on the first search's real sketch operands, bit-equal (at
     10M on the first 64 queries of the 1024-query launch), with its ms,
     bound and the torch._int_mm yardstick; (g) the JAX package's graph
     record (GRAPH_WORKLOADS, results/<name>_graph_results.json) on the
     same drawn data and ground truth as its scan workload: eval.
     bench_one_case(engine="graph") at k = 100 (NNDescent, alpha-CNG,
     calibration and the step budget from the host store, one warm and 3
     timed passes over the 1000 queries): recall@1/10/100 and ADR beside
     the record's, the step budget and the steps taken, the build's
     stages and peak, QPS, p50, the beam kernels' launches by variant,
     the kept graph's bytes and the captures of each call (a timed call
     that replays the kept graph captures none); then the four beam
     kernels against the plain torch step on all 1000 queries at
     beam_cap 400, state bit-equal after each of the first 16 steps and
     at the end, each segment timed as in 8c, and one profiled batch.
The graph path's step runs
four hand-written kernels (kernels/beam_step.py; the JAX package's Pallas
beam-step kernel was retired before the port, so they replace its XLA
step) around torch's exact distances.  The last lines are the kernels'
JSON (with every launch shape the scan kernel was checked at), the
card's name and power limit as nvidia-smi reports them, and the result
JSON.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

from cphnsw_tpu_torch import CPIndex, Index, ScanIndex
from cphnsw_tpu_torch.graph import nndescent
from cphnsw_tpu_torch.kernels import beam_step, nvcc, scan_keys
from cphnsw_tpu_torch.ops import hadamard, pack, quantize, rounding, threefry
from cphnsw_tpu_torch.ops.rounding import fma_f32
from cphnsw_tpu_torch.parallel import sharded
from cphnsw_tpu_torch.search import beam, bruteforce, scan
from cphnsw_tpu_torch.utils import datasets, native
from cphnsw_tpu_torch.utils.datasets import make_synthetic, synthetic_shape
from cphnsw_tpu_torch.utils.eval import bench_one_case, recall_at_k

N_MAIN, N_SMALL, DIM, N_QUERIES, K = 1_000_000, 100_000, 128, 8192, 10
SUB_BATCH = 2048
TIMED_RUNS = 5
MIN_RECALL = 0.99
# Graph drives: the lockstep beam's per-query cost does not depend on the
# batch size, so 1024 queries measure it.
GRAPH_QUERIES = 1024
GRAPH_MIN_RECALL = 0.90
# Sharded drives: model shards on a (1, N_SHARDS) mesh; the sharded graph
# runs 4 shard beams in turn per batch, so it takes fewer timed batches.
N_SHARDS = 4
SHARDED_GRAPH_RUNS = 3
# The JAX package's 1M x 128d 1-bit candidate budget (its results file,
# results/synthetic-1m-128d_results.json): ranks at k = 1, 10, 100.
JAX_1M_BUDGET_RANKS = [2251, 3121, 3612]
CLI_DATASET = "synthetic-20k-64d"
# Candidates per query of the two-stage rerank check (phase 5c): at
# TWO_STAGE_MIN_C, the least count that goes two-stage.
TWO_STAGE_CANDIDATES = scan.TWO_STAGE_MIN_C
# Brute-force drive (phase 5e): its (Q, N) estimate matrix is whole, so
# it takes one 2048-query batch; its recall is that of top_c = 4k
# estimate candidates, a sanity floor only.
BRUTE_QUERIES = 2048
BRUTE_MIN_RECALL = 0.5
# Graph rerank cap checked in phase 7 (of E * R = 128 candidates a step).
RERANK_WIDTH = 8
# Triples of the fma_f32 sweep (phase 2): each is checked against exact
# rational arithmetic on the host.
FMA_SWEEP = 4096
# Queries of the per-shard chunked selection (phase 9c): one sub-batch.
CHUNKED_QUERIES = 2048
# NNDescent card against CPU (phase 6b): a 20k x 32d store of 32 clusters,
# R = 16.  The card sums candidate distances in another order, which can
# flip a near tie at rank R: one round from the same graph flips about one
# row in 10^4, and over a build's ~10 rounds each flip changes the
# candidates of its neighbours, so the shares of rows with equal edge sets
# must reach 99.9% for one round and 98% for the whole build (this phase
# measured 99.2% for the build; a build from another seed shares about
# half of its rows).
NND_N, NND_DIM, NND_R = 20_000, 32, 16
NND_MIN_ROUND_ROWS = 0.999
NND_MIN_BUILD_ROWS = 0.98
# The kernel's plain version is held against it on at most this many
# (query, row) elements: above, on the first PLAIN_QUERIES queries of the
# launch (at 10M rows its group loop takes ~1000 groups of 10,240 bins).
PLAIN_MAX_ELEMENTS = 1 << 31
PLAIN_QUERIES = 64
# Phase 12: the JAX package's recorded scan workloads, as its results files
# (results/<name>_results.json) name them: the Threefry device recipe, 1000
# queries, ground truth on the card, WORKLOAD_RUNS timed passes; (name, the
# k of each timed run, bit widths).
WORKLOADS = [
    ("synthetic-1m-128d", (100,), (1,)),
    ("synthetic-1m-960d", (100,), (1,)),
    ("synthetic-100k-1536d-ip", (100,), (1, 4)),
    ("synthetic-10m-96d", (100, 10), (1,)),
]
WORKLOAD_RUNS = 3
# Phase 12g: the JAX package's graph records, run on the data of the scan
# workload of the same name (results/<name>_graph_results.json); (name,
# k, bit width).
GRAPH_WORKLOADS = [("synthetic-1m-128d", 100, 1)]
# A recall@10 more than this below the JAX package's record is flagged.
RECORD_GAP = 0.005
# The K step of an int8 wgmma: a launch's operations are counted over the
# store's columns that hold data, rounded up to it (the rest is zero pad).
MMA_K = 32
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W):
# int8 tensor-core operations and HBM3 bytes per second.
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"{cmd[0]} exited {proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout.strip()


def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median of `runs` CUDA-event timings of fn() after one warm-up."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_bound(rows, p, q, bins, cols):
    """(ms, roof): the least time the card could take for one launch, the
    larger of its int8 operations over the `cols` columns that hold data
    (rounded up to MMA_K) at the peak rate and its bytes (each padded input
    read once, the key planes written once) at the memory rate."""
    ops = 2 * q * rows * min(p, -(-cols // MMA_K) * MMA_K)
    nbytes = rows * p + 6 * rows * 4 + q * p + q * 4 + q * 5 * 4 + \
        q * scan_keys.FUSED_TOPM * bins * 4
    by_ops, by_bytes = ops / INT8_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else \
        (by_bytes, "bytes")


def int_mm_ms(codes, q8):
    """The product alone as one library call, torch._int_mm(q8, codes.T),
    its (Q, rows) int32 result written to device memory: a yardstick the
    port never calls.  None (and the reason printed) if it refuses."""
    try:
        ms = median_ms(lambda: torch._int_mm(q8, codes.t()))
    except RuntimeError as exc:
        log(f"  torch._int_mm refuses Q={q8.shape[0]} P={q8.shape[1]} "
            f"rows={codes.shape[0]}: {str(exc).splitlines()[0]}")
        return None
    torch.cuda.empty_cache()
    return ms


def check_kernel(name, operands, bins, card, results, yardstick=True,
                 time_plain=True, cols=None):
    """Kernel vs plain version on the same device tensors: bit-equal keys,
    both median times, the bound and the product-only yardstick.  A shape
    whose group axis is split is also timed unsplit (splits=1), and its
    merge kernel's launches are counted.  Where the plain version's
    (queries x rows) work exceeds PLAIN_MAX_ELEMENTS, it runs on the first
    PLAIN_QUERIES queries and the kernel's keys of those queries (from the
    whole launch) are held against it.  time_plain=False times the plain
    version's one comparison call instead of a median of TIMED_RUNS.
    cols: the store's columns that hold data (default: all P)."""
    (rows, p), q = operands[0].shape, operands[2].shape[0]
    cols = p if cols is None else cols
    plan = scan_keys.launch_plan(q, p, bins, rows // bins, torch.cuda.
                                 get_device_properties(0).
                                 multi_processor_count)
    plain_q = q if q * rows <= PLAIN_MAX_ELEMENTS else PLAIN_QUERIES
    plain_ops = operands[:2] + [t[:plain_q] for t in operands[2:]]
    merges = scan_keys.merge_launches
    got = scan_keys.fused_scan_keys(*operands, bins)[:plain_q]
    merges = scan_keys.merge_launches - merges
    ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
    ev[0].record()
    want = scan_keys.scan_keys_reference(*plain_ops, bins)
    ev[1].record()
    torch.cuda.synchronize()
    plain_once_ms = ev[0].elapsed_time(ev[1])
    equal = (got == want).double().mean().item()
    max_err = (got.long() - want.long()).abs().max().item()
    if plan.splits > 1 and not torch.equal(
            scan_keys.fused_scan_keys(*operands, bins, splits=1)[:plain_q],
            want):
        fail(f"{name}: the unsplit kernel's keys differ")
    del got, want
    ms = median_ms(lambda: scan_keys.fused_scan_keys(*operands, bins))
    plain_ms = median_ms(
        lambda: scan_keys.scan_keys_reference(*plain_ops, bins)) \
        if time_plain else plain_once_ms
    bound_ms, roof = kernel_bound(rows, p, q, bins, cols)
    mm_ms = int_mm_ms(operands[0], operands[2]) if yardstick else None
    unsplit_ms = None
    if plan.splits > 1:
        unsplit_ms = median_ms(
            lambda: scan_keys.fused_scan_keys(*operands, bins, splits=1))
        log(f"  {name}: split {plan.splits} ways, merge_kernel launches "
            f"{merges}, kernel_ms (both kernels) {ms:.4f} against "
            f"unsplit_ms {unsplit_ms:.4f} [{card}]")
        if merges != 1:
            fail(f"{name}: the split call launched merge_kernel {merges} "
                 f"times")
    compared = "all queries" if plain_q == q else \
        f"the first {plain_q} queries of the {q}-query launch"
    log(f"  {name}: rows={rows} P={p} Q={q} bins={bins} "
        f"splits={plan.splits} keys_equal={equal} ({compared}) "
        f"max_abs_err={max_err} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f}"
        f"{'' if time_plain else ' (one call)'} bound_ms="
        f"{bound_ms:.4f} ({roof}, {cols} of {p} columns) "
        f"roofline_share={bound_ms / ms:.4f} "
        f"int_mm_ms={mm_ms if mm_ms is None else round(mm_ms, 4)} [{card}]")
    if equal != 1.0:
        fail(f"{name}: kernel keys differ from the plain version "
             f"(equal fraction {equal})")
    results.append(dict(mode=name, rows=rows, p=p, cols=cols, q=q, bins=bins,
                        plain_queries=plain_q, ms=ms, plain_ms=plain_ms,
                        max_abs_err=max_err, bound_ms=bound_ms, bound_by=roof,
                        roofline_share=bound_ms / ms, int_mm_ms=mm_ms,
                        splits=plan.splits, unsplit_ms=unsplit_ms,
                        merge_launches=merges))


def ptxas_report(path):
    """Registers and spill bytes of each kernel in the library's ptxas
    log; fails on any spill."""
    report, name = [], None
    for ln in nvcc.build_log(path).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            kind = re.search(r"(scan_keys_kernel|beam_pop_kernel"
                             r"|beam_expand_kernel|beam_merge_kernel"
                             r"|beam_expand_bulk_kernel"
                             r"|beam_merge_rank_kernel"
                             r"|beam_gamma_kernel|merge_kernel)", name)
            tmpl = re.search(r"ILb([01])ELi(\d+)E", name)
            ws = re.search(r"beam_\w+_kernelILb([01])EE", name)
            bits = re.search(r"beam_expand_bulk_kernelILi(\d)EE", name)
            report.append(dict(kernel=kind.group(1) if kind else name))
            if tmpl:
                report[-1].update(fast_cvt=bool(int(tmpl.group(1))),
                                  k_chunks=int(tmpl.group(2)))
            if ws:
                report[-1]["workspace"] = ("shared" if ws.group(1) == "1"
                                           else "global")
            if bits:
                report[-1]["bits"] = int(bits.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and report:
            report[-1].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and report:
            report[-1]["registers"] = int(m.group(1))
    for r in report:
        log(f"  ptxas: {json.dumps(r)}")
    spilled = [r for r in report if r.get("spill_stores") or
               r.get("spill_loads")]
    if not report or spilled:
        fail(f"ptxas reports spills or no kernels: {spilled or report}")
    return report


def estimate_operands(raw, n, bits, signs, qpad, bins, rows_kpad):
    """Estimate-mode kernel operands for the store `raw` at `bits`."""
    centroid = quantize.compute_centroid(raw[:n])
    planes, nop, ip_qo, ip_cp, wpc = scan.encode_scan_store(
        raw, centroid, signs, bits)
    floor = float(torch.quantile(ip_qo[:n][:1 << 20], 0.02))
    aux = scan.fold_node_constants(nop, ip_qo, ip_cp, wpc, floor, n)
    codes, aux = scan.estimate_store_operands(planes, aux, rows_kpad,
                                              raw.shape[1])
    qc, w_fs, y_aux = scan._query_side(qpad, signs, 1.0, 0.0,
                                       float((1 << bits) - 1))
    return [codes, aux, qc.q_u.to(torch.int8), w_fs, y_aux]


def stage_split(index, queries, card, k=K, sub_batch=SUB_BATCH):
    """Median ms of each search stage on one sub-batch of at most
    sub_batch queries at k, measured with CUDA events around the stages of
    scan_search's sketch branch."""
    arrays, sketch, n = index._arrays, index._rerank_sketch(), index.size
    n_pad, p = arrays.raw.shape
    surv = scan._rerank_survivors(k, index._budget.top_c(k, n))
    bins, _, rows_kpad = scan_keys.fused_bin_plan(n_pad, surv)
    q16 = queries[:sub_batch].astype(np.float16)
    names = ["query_encode", "sketch_quantize", "store_operands", "kernel",
             "decode", "rerank"]
    samples = {k: [] for k in names}
    for it in range(TIMED_RUNS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        q_dev = torch.from_numpy(q16).cuda()
        qpad = hadamard.pad_to(q_dev.float(), p)
        qnorm = (qpad * qpad).sum(dim=-1)
        ev[1].record()
        q8, w_fs, y_aux = scan.sketch_query(qpad, sketch.scale)
        ev[2].record()
        codes, aux = scan.sketch_store_operands(sketch, n, rows_kpad)
        ev[3].record()
        keys = scan_keys.fused_scan_keys(codes, aux, q8, w_fs, y_aux, bins)
        ev[4].record()
        cand = scan._decode_keys(keys, surv, bins)
        ev[5].record()
        scan._rerank(arrays.raw, arrays.norm_sq, qpad, qnorm, cand, n, k)
        ev[6].record()
        torch.cuda.synchronize()
        if it:
            for i, name in enumerate(names):
                samples[name].append(ev[i].elapsed_time(ev[i + 1]))
    split = {s: round(statistics.median(v), 4) for s, v in samples.items()}
    log(f"  stage split, ms per {len(q16)}-query sub-batch at k={k}: "
        f"{json.dumps(split)} [{card}]")
    return split


def drive(name, data, bits, card):
    """Build + finalize + warm + timed searches; returns (index, ids)."""
    idx = CPIndex(DIM, bits=bits, device="cuda")
    t0 = time.perf_counter()
    idx.build(data["base"])
    idx.finalize()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"  {name}: build+finalize {build_s:.2f} s, stages "
        f"{json.dumps(idx._index.build_stages)}, budget ranks "
        f"{idx._index._budget.ranks.tolist()} [{card}]")
    queries = data["queries"]
    ids, _ = idx.search_batch(queries, k=K)          # warm
    lat = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        ids, dists = idx.search_batch(queries, k=K)  # ends on a host copy
        lat.append(time.perf_counter() - t0)
    p50 = statistics.median(lat)
    recall = recall_at_k(ids, data["groundtruth"], K)
    log(f"  {name}: recall@{K}={recall:.4f} QPS={len(queries) / p50:.1f} "
        f"p50 batch latency {p50 * 1e3:.2f} ms (Q={len(queries)}, "
        f"batches {[round(x * 1e3, 2) for x in lat]} ms) [{card}]")
    if ids.shape != (len(queries), K) or not np.isfinite(dists).all():
        fail(f"{name}: malformed result {ids.shape}")
    if recall < MIN_RECALL:
        fail(f"{name}: recall@{K} {recall} < {MIN_RECALL}")
    return idx, ids


class NNDescentClock:
    """Inside a `with` block: the wall seconds and calls of every
    nndescent.run_adaptive (layer 0, upper levels, shards), each ending on
    a device sync, and the device milliseconds of the Threefry draws made
    inside them (CUDA events around each outermost randint / random_bits
    call, summed once the block ends)."""

    def __enter__(self):
        self.seconds, self.calls, self._events = 0.0, 0, []
        self._real = (nndescent.run_adaptive, threefry.randint,
                      threefry.random_bits)
        run_adaptive, randint, random_bits = self._real
        depth = [0]

        def timed(*args, **kw):
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                out = run_adaptive(*args, **kw)
            finally:
                depth[0] -= 1
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        def drawn(fn):
            def call(*args, **kw):
                if depth[0] != 1:           # outside NNDescent, or nested
                    return fn(*args, **kw)
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                depth[0] += 1
                ev[0].record()
                try:
                    return fn(*args, **kw)
                finally:
                    ev[1].record()
                    depth[0] -= 1
                    self._events.append(ev)
            return call

        nndescent.run_adaptive = timed
        threefry.randint = drawn(randint)
        threefry.random_bits = drawn(random_bits)
        return self

    def __exit__(self, *exc):
        (nndescent.run_adaptive, threefry.randint,
         threefry.random_bits) = self._real
        torch.cuda.synchronize()
        self.draw_ms = sum(a.elapsed_time(b) for a, b in self._events)
        self.draws = len(self._events)

    def line(self) -> str:
        return (f"nndescent {self.seconds:.3f} s over {self.calls} "
                f"run_adaptive calls, its Threefry draws {self.draws} calls "
                f"{self.draw_ms / 1e3:.3f} s on the card, build peak device "
                f"memory {self.peak_gib:.2f} GiB")


def graph_drive(name, data, bits, card):
    """Graph engine: build + finalize + warm + timed searches on the first
    GRAPH_QUERIES queries; returns (index, queries, ids)."""
    idx = CPIndex(DIM, bits=bits, engine="graph", device="cuda")
    kept_before = beam.kept_bytes()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with NNDescentClock() as nnd:
        idx.build(data["base"])
        idx.finalize()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    nnd.peak_gib = peak_gib()
    g = idx._index
    kept_build = beam.kept_bytes() - kept_before
    log(f"  {name}: after the build the beam's kept graphs grew by "
        f"{kept_build} B; allocated / reserved "
        f"{' / '.join(f'{x:.4f}' for x in resident_gib())} GiB [{card}]")
    log(f"  {name}: build+finalize {build_s:.2f} s, stages "
        f"{json.dumps(g.build_stages)}, step budget {g._step_budget}, "
        f"graph stats {g._stats.to_dict()} [{card}]")
    queries = data["queries"][:GRAPH_QUERIES]
    ids, _ = idx.search_batch(queries, k=K)          # warm
    lat = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        ids, dists = idx.search_batch(queries, k=K)  # ends on a host copy
        lat.append(time.perf_counter() - t0)
    p50 = statistics.median(lat)
    log(f"  {name}: after the searches the beam's kept graphs hold "
        f"{beam.kept_bytes() / 2**30:.4f} GiB (at most "
        f"{beam.KEPT_BYTES_PER_DEVICE / 2**30:g}); allocated / reserved "
        f"{' / '.join(f'{x:.4f}' for x in resident_gib())} GiB [{card}]")
    if kept_build > 0 or beam.kept_bytes() > beam.KEPT_BYTES_PER_DEVICE:
        fail(f"{name}: the build kept {kept_build} B of beam graphs (the "
             f"step budgets keep none) or the searches left "
             f"{beam.kept_bytes()} B, above the budget")
    recall = recall_at_k(ids, data["groundtruth"][:GRAPH_QUERIES], K)
    log(f"  {name}: recall@{K}={recall:.4f} QPS={len(queries) / p50:.1f} "
        f"p50 batch latency {p50 * 1e3:.2f} ms (Q={len(queries)}, "
        f"batches {[round(x * 1e3, 2) for x in lat]} ms) [{card}]")
    log(f"  {name}: recall@{K}={recall:.4f}, build {build_s:.2f} s, "
        f"{nnd.line()} [{card}]")
    steps, ms = beam_steps(g, queries)
    log(f"  {name}: beam steps run {steps} (budget {g._max_steps(K)}), "
        f"{ms:.3f} ms per step, visited "
        f"{'hash 2^%d slots' % g._visited_hash_bits() if g._visited_hash_bits() else 'dense'}"
        f", sub-batch {g._sub_batch()} queries [{card}]")
    if ids.shape != (len(queries), K) or not np.isfinite(dists).all():
        fail(f"{name}: malformed result {ids.shape}")
    if recall < GRAPH_MIN_RECALL:
        fail(f"{name}: recall@{K} {recall} < {GRAPH_MIN_RECALL}")
    return idx, queries, ids, p50


def beam_steps(g, queries, k=K):
    """(loop steps, ms per step) of one beam search over `queries`, timed
    with CUDA events."""
    q_dev = torch.from_numpy(queries).cuda()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _, _, state = g._beam(q_dev, g._entry_candidates, k, g._max_steps(k),
                          debug_state=True)
    end.record()
    torch.cuda.synchronize()
    return state.steps, start.elapsed_time(end) / max(state.steps, 1)


def profile_graph_batch(g, queries, p50, card, k=K,
                        label="[8] profile of one warm 1M graph batch"):
    """torch.profiler over one warm search_batch: device-busy time (the
    union of kernel intervals) as a share of the profiled wall time and of
    the unprofiled p50 batch latency, the five kernels with the most
    device time, kernel launches per beam step; returns the steps, the
    device ops a step, the busy ms and the beam kernels' device ms and
    launches in the batch."""
    from torch.profiler import ProfilerActivity, profile

    steps, _ = beam_steps(g, queries, k)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        g.search_batch(queries, k=k)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name: dict[str, list] = {}
    for e in kernels:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += e.time_range.end - e.time_range.start
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    per_step = len(kernels) / max(steps, 1)
    # a kernel's instances by name: beam_expand_kernel<...> and
    # beam_expand_bulk_kernel<...> are both beam_expand
    beam_ms = {name: dict(ms=sum(us for e_name, (us, _) in by_name.items()
                                 if re.search(name + r"_(\w+_)?kernel",
                                              e_name)) / 1e3,
                          launches=sum(c for e_name, (_, c) in by_name.items()
                                       if re.search(name + r"_(\w+_)?kernel",
                                                    e_name)))
               for name in ("beam_pop", "beam_expand", "beam_merge",
                            "beam_gamma")}
    log(f"{label} (Q={len(queries)}, k={k}): device "
        f"busy {busy / 1e3:.2f} ms = {100 * busy / wall_us:.1f}% of the "
        f"{wall_us / 1e3:.2f} ms profiled wall, "
        f"{100 * busy / (p50 * 1e6):.1f}% of the {p50 * 1e3:.2f} ms "
        f"unprofiled p50 batch; {len(kernels)} kernel launches over {steps} "
        f"beam steps = {len(kernels) / max(steps, 1):.1f} per step [{card}]")
    for name, (us, count) in top:
        log(f"  {us / 1e3:9.3f} ms {count:6d} launches  {name[:110]}")
    log(f"  beam kernels in the profiled batch: {json.dumps(beam_ms)}")
    if not kernels:
        log("  the profiler recorded no device kernels")
    return dict(steps=steps, device_ops_per_step=per_step,
                busy_ms=busy / 1e3, beam=beam_ms)


def resident_gib():
    """(allocated, reserved) device memory in GiB, after a synchronize and
    torch.cuda.empty_cache()."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return (torch.cuda.memory_allocated() / 2**30,
            torch.cuda.memory_reserved() / 2**30)


def beam_graph_drive(g, queries, card):
    """Phase 8b: the 1M graph index's beam replayed from captured graphs
    against the same step function launched eagerly, op by op
    (beam._graphed swapped for the identity, no kept graph): ids,
    distances, result steps, last improving steps and step count must be
    equal in a debug_state call, which captures its own graph and keeps
    none, and ids and distances in every timed call.  TIMED_RUNS rounds of
    three routes in turns: eager; a capture per call (beam.drop_replays()
    first); the graph that call kept, replayed.  Prints each capture's
    host ms (record + instantiate, after a synchronize), the ms per
    replay (CUDA events), the p50 search_batch of each route, and the
    memory held by the kept graph (beam.kept_bytes) and on the device
    with and without it."""
    real = beam._graphed
    capture_ms, replays = [], []

    def timed(fn, stream):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay = real(fn, stream)
        capture_ms.append((time.perf_counter() - t0) * 1e3)

        def run():
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            replay()
            ev[1].record()
            replays.append(ev)

        return run

    def on(route, search):
        if route != "kept":
            beam.drop_replays()
        beam._graphed = (lambda fn, stream: fn) if route == "eager" else timed
        try:
            return search()
        finally:
            beam._graphed = real
            if route == "eager":
                beam.drop_replays()

    q_dev = torch.from_numpy(queries).cuda()

    def debug():
        return g._beam(q_dev, g._entry_candidates, K, g._max_steps(K),
                       debug_state=True)

    ids_g, d_g, s_g = on("per_call", debug)
    debug_captures, debug_kept = len(capture_ms), beam.kept_bytes()
    ids_e, d_e, s_e = on("eager", debug)
    equal = (torch.equal(ids_g, ids_e) and torch.equal(d_g, d_e)
             and torch.equal(s_g.res_step, s_e.res_step)
             and torch.equal(s_g.last_improve, s_e.last_improve)
             and s_g.steps == s_e.steps)
    index_gib = resident_gib()
    routes = ("eager", "per_call", "kept")
    lat = {route: [] for route in routes}
    captures = {route: 0 for route in routes}
    last = {}
    for _ in range(TIMED_RUNS):
        for route in routes:
            n0 = len(capture_ms)
            t0 = time.perf_counter()
            last[route] = on(route, lambda: g.search_batch(queries, k=K))
            lat[route].append(time.perf_counter() - t0)
            captures[route] += len(capture_ms) - n0
    kept_gib = beam.kept_bytes() / 2**30
    with_kept_gib = resident_gib()
    torch.cuda.synchronize()
    replay_ms = [a.elapsed_time(b) for a, b in replays]
    equal_timed = all(np.array_equal(x, y) for route in ("per_call", "kept")
                      for x, y in zip(last[route], last["eager"]))
    p50 = {route: statistics.median(v) * 1e3 for route, v in lat.items()}
    res = dict(equal=equal, equal_timed=equal_timed, steps=s_g.steps,
               captures=captures, capture_ms=capture_ms,
               replays=len(replay_ms),
               replay_ms_median=statistics.median(replay_ms)
               if replay_ms else None,
               p50_ms=p50, batches_ms={route: [x * 1e3 for x in v]
                                       for route, v in lat.items()},
               kept_gib=kept_gib, allocated_reserved_gib_without_kept=
               index_gib, allocated_reserved_gib_with_kept=with_kept_gib)
    log(f"[8b] graphed beam against eager on the 1M graph index "
        f"(Q={len(queries)}, {s_g.steps} steps): ids, distances, res_step, "
        f"last_improve and steps equal in a capturing debug_state call: "
        f"{equal}, ids and distances in the timed calls: {equal_timed}; "
        f"captures {', '.join(f'{x:.2f}' for x in capture_ms)} ms; "
        f"{len(replay_ms)} replays of {beam.DONE_CHECK_EVERY} steps at "
        f"{res['replay_ms_median']} ms median; search_batch p50 "
        + ", ".join(f"{route} {p50[route]:.2f} ms" for route in routes)
        + f" ({TIMED_RUNS} rounds in turns; captures per route "
        f"{captures}); kept graph {kept_gib:.4f} GiB; allocated / reserved "
        f"{index_gib[0]:.4f} / {index_gib[1]:.4f} GiB without it, "
        f"{with_kept_gib[0]:.4f} / {with_kept_gib[1]:.4f} GiB with it "
        f"[{card}]")
    if not (equal and equal_timed):
        fail("the graphed beam differs from the eager step function")
    if (debug_captures != 1 or debug_kept
            or captures != dict(eager=0, per_call=TIMED_RUNS, kept=0)
            or not replay_ms):
        fail(f"the 1M graph beam captured {debug_captures} graph(s) in its "
             f"debug_state call and kept {debug_kept} B, then {captures} "
             f"(one per per_call search, none to replay a kept graph)")
    if not 0 < kept_gib <= beam.KEPT_BYTES_PER_DEVICE / 2**30:
        fail(f"the kept graph holds {kept_gib} GiB, outside (0, "
             f"{beam.KEPT_BYTES_PER_DEVICE / 2**30}]")
    return res


# Phase 8c: spin cycles (torch.cuda._sleep) before each timed segment, so
# that the host has queued the whole segment before its first event fires
# and the events time the device alone: ~2 ms at the H100's ~1.98 GHz
# before a kernel path's segment, ~8 ms before a plain one (up to ~120
# torch ops queued from the host).
SEGMENT_SLEEP = {"kernels": 4_000_000, "plain": 16_000_000}
# Steps whose whole state phase 8c holds equal after each step (and at the
# end of the search).
EQUAL_EACH_STEP = 16


class SegmentClock:
    """CUDA events around the segments of each beam step: the four segment
    functions (the kernels' wrappers or their plain versions) are wrapped,
    and the torch segments are the spans between them: before the pop
    (`counter`, once the step counter's torch op, now in the pop), the
    exact distance to the popped nodes, the exact rerank, between the
    merge and the gamma update (`gamma_sums`, once the torch sums of the
    ratios, now in the gamma update) and the step's tail.  The last output
    of each wrapped function is kept (`last`)."""

    def __init__(self, cycles: int):
        self.cycles = cycles
        self.steps: list[list] = []
        self.last: dict = {}

    def _mark(self, label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1].append((label, ev))

    def begin(self):
        self.steps.append([])
        torch.cuda._sleep(self.cycles)
        self._mark("begin")

    def end(self):
        self._mark("end")

    def wrap(self, name, fn):
        def timed(*args):
            self._mark(name + "<")
            torch.cuda._sleep(self.cycles)
            self._mark(name + "[")
            out = self.last[name] = fn(*args)
            self._mark(name + "]")
            torch.cuda._sleep(self.cycles)
            self._mark(name + ">")
            return out

        return timed

    def segment_ms(self) -> list[dict]:
        torch.cuda.synchronize()
        spans = dict(counter=("begin", "pop<"), pop=("pop[", "pop]"),
                     exact_pop=("pop>", "expand<"),
                     expand=("expand[", "expand]"),
                     exact_rerank=("expand>", "merge<"),
                     merge=("merge[", "merge]"),
                     gamma_sums=("merge>", "gamma<"),
                     gamma=("gamma[", "gamma]"), tail=("gamma>", "end"))
        out = []
        for marks in self.steps:
            ev = dict(marks)
            out.append({seg: ev[a].elapsed_time(ev[b])
                        for seg, (a, b) in spans.items()})
        return out


def state_diff(a, b):
    """None when every BeamState field of a and b is equal bit for bit
    (floats by their bits), else the largest absolute difference."""
    worst, same = 0.0, True
    for x, y in zip(a, b):
        bits = (x.view(torch.int32), y.view(torch.int32)) \
            if x.dtype == torch.float32 else (x, y)
        if x.shape != y.shape or not torch.equal(*bits):
            same = False
            worst = max(worst, (x.double() - y.double()).abs().max().item()
                        if x.shape == y.shape else float("inf"))
    return None if same else worst


def beam_kernel_bytes(q, done_before, active, expanded, dims) -> dict:
    """Bytes each beam kernel must move in one step (each input read once,
    each output written once): every query's done or active flag; a query
    done before the step writes the pop's outputs the exact distances
    read, one not active this step the expansion's and merge's; an active
    query reads its beam, its popped nodes' fused rows, its query levels,
    one visited slot per candidate (and writes one), the candidates
    between the kernels, and writes its results and beam; the pop reads
    the step counter and writes the next; the gamma update reads and
    writes every query's terms and reads an expanding query's ratios and
    contributing flags.  dims: (beam_cap,
    k, E, E*R, rw, P, bytes of one fused row, bytes of one visited
    slot)."""
    b, k, e, er, rw, p, row, vis = dims
    capped = rw < er
    live = q - done_before
    return dict(
        beam_gamma=q * 25 + expanded * 5 * rw,
        beam_pop=8 + q + done_before * (13 * e + 6)
        + live * (4 * b + 25 * e + 27),
        beam_expand=q + (q - active) * (2 * er + 8 * rw + vis
                                        + (rw if capped else 0))
        + active * (4 * p + 20 + 13 * e + e * row + 2 * er * vis + 14 * er
                    + 8 * rw + (13 * rw if capped else 0)),
        beam_merge=q + (q - active) * 5 * rw
        + active * (24 * k + 13 + 17 * e + 17 * rw + 14 * er + 24 * b
                    + (13 * rw if capped else 0)))


# The step's segments in search/beam.py: (segment, the kernel's wrapper,
# its plain version).
BEAM_SEGMENTS = (("pop", "_pop", "_pop_plain"),
                 ("expand", "_expand", "_expand_plain"),
                 ("merge", "_merge", "_merge_plain"),
                 ("gamma", "_gamma", "_gamma_plain"))
BEAM_KERNELS = ("beam_pop", "beam_expand", "beam_merge", "beam_gamma")
# the kernels with a generic variant (beam_step.GENERIC_ONLY)
GENERIC_VARIANTS = ("beam_expand", "beam_merge")


def beam_launches() -> dict:
    return dict(beam_pop=beam_step.pop_launches,
                beam_expand=beam_step.expand_launches,
                beam_merge=beam_step.merge_launches,
                beam_gamma=beam_step.gamma_launches)


def beam_variant_launches() -> dict:
    return dict(beam_expand=dict(beam_step.expand_variant_launches),
                beam_merge=dict(beam_step.merge_variant_launches))


def zero_beam_launches():
    beam_step.pop_launches = beam_step.expand_launches = \
        beam_step.merge_launches = beam_step.gamma_launches = 0
    for counts in (beam_step.expand_variant_launches,
                   beam_step.merge_variant_launches):
        for variant in counts:
            counts[variant] = 0


def beam_path_launches(path: str, launches: dict, variants: dict) -> dict:
    """A path's beam kernel launches and the expansion's and merge's
    launches by variant, read just after its drive (the counters set to 0
    just before): fails unless every kernel launched and the Hopper
    variants did (every path's shapes fit them)."""
    log(f"  beam kernel launches in the {path} drive (host calls: a graph "
        f"replay launches its captured kernels again): "
        f"{json.dumps(launches)}; by variant {json.dumps(variants)}")
    if min(launches.values()) <= 0:
        fail(f"the {path} drive did not launch every beam kernel: "
             f"{launches}")
    if variants["beam_expand"]["bulk"] <= 0 or \
            variants["beam_merge"]["rank"] <= 0:
        fail(f"the {path} drive did not launch the Hopper variants: "
             f"{variants}")
    return dict(launches, variants=variants)


def beam_equal_drive(label, start, max_steps, card, clocks=None):
    """The beam step's four kernels against the plain torch step
    (beam._plain_step) from the state start() seeds (called twice), step
    by step: every state field bit-equal after each of the first
    EQUAL_EACH_STEP steps and at the end (all queries done, or
    max_steps run), or the run fails.  clocks: a SegmentClock for the
    kernels' route and, optionally, one for the plain route, wrapped
    around the segments (phase 8c).  Returns the comparison and, per step,
    (queries done before it, active after it, expanding)."""
    (sk, ck), (sp, cp) = start(), start()
    real = {fn: getattr(beam, fn) for _, kernel, plain in BEAM_SEGMENTS
            for fn in (kernel, plain)}
    clocks = clocks or {}
    for seg, kernel, plain in BEAM_SEGMENTS:
        for route, fn in (("kernels", kernel), ("plain", plain)):
            if route in clocks:
                setattr(beam, fn, clocks[route].wrap(seg, real[fn]))

    def timed(route, step_fn, s, c):
        if route in clocks:
            clocks[route].begin()
        s = step_fn(s, c)
        if route in clocks:
            clocks[route].end()
        return s

    counts, diffs = [], []
    try:
        for step in range(max_steps):
            done_before = int(sk.done.sum())
            sk = timed("kernels", beam._step, sk, ck)
            sp = timed("plain", beam._plain_step, sp, cp)
            if "kernels" in clocks:
                counts.append((done_before, int((~sk.done).sum()), int(
                    clocks["kernels"].last["pop"].expand.sum())))
            finished = bool(sk.done.all()) and bool(sp.done.all())
            if step < EQUAL_EACH_STEP or finished or step == max_steps - 1:
                diffs.append((step + 1, state_diff(sk, sp)))
            if finished:
                break
    finally:
        for fn, f in real.items():
            setattr(beam, fn, f)
    unequal = [(st, d) for st, d in diffs if d is not None]
    q, beam_cap = sk.beam_est.shape
    res = dict(steps=diffs[-1][0], max_steps=max_steps,
               finished=bool(sk.done.all()),
               shape=dict(q=q, beam_cap=beam_cap, k=ck.k,
                          expand_width=ck.expand_width, r=ck.r, rw=ck.rw,
                          p=ck.raw.shape[1], bits=ck.bits,
                          visited_hash_bits=ck.h_size.bit_length() - 1
                          if ck.h_size else 0),
               equal_after_steps=[st for st, d in diffs if d is None],
               unequal=unequal,
               max_abs_err=max((d for _, d in unequal), default=0.0))
    log(f"[{label}] beam kernels against the plain torch step "
        f"({json.dumps(res['shape'])}; {res['steps']} steps of at most "
        f"{max_steps}, all done: {res['finished']}; done read every "
        f"step): state bit-equal after steps {res['equal_after_steps']}; "
        f"unequal {unequal} [{card}]")
    if unequal:
        fail(f"[{label}] the beam kernels differ from the plain step: "
             f"{unequal}")
    return res, counts


def index_beam_start(g, q_dev, k, rerank_width=0):
    """A start() for beam_equal_drive: the seeded state and constants of
    Index g's own beam call on q_dev."""
    return lambda: beam._start(
        g._raw, g._norm_sq, g._neighbors, g._entry_candidates, g._signs,
        q_dev, g._params, g._bits, k, max(2 * g._r, 4 * k), 4,
        g._expand_width, rerank_width, g._visited_hash_bits())


def shard_beam_start(idx, queries, k):
    """A start() for beam_equal_drive: the seeded state and constants of
    ShardedIndex idx's beam on its first shard, as _sharded_search calls
    it (beam_cap 128, E = 1, dense visited, 4 seeds)."""
    dev = idx._mesh.devices[0, 0]
    sh = idx._store.shards[0][0]
    q_dev = torch.from_numpy(queries).to(dev)
    return lambda: beam._start(
        sh.raw, sh.norm_sq, sh.neighbors, sh.entry_candidates,
        idx._signs[dev], q_dev, idx._params_dev[dev], idx.bits, k, 128, 4,
        1, 0, 0)


def segment_times(clocks: dict) -> tuple[dict, dict]:
    """(median, mean) over the steps of each segment's ms per step, by
    route, from SegmentClocks.  The median of the steps is each kernel's
    ms: a host stall longer than the spins before a segment lands in that
    segment's span, and one such step moves the mean of a few hundred by
    tenths of a ms."""
    seg = {route: clock.segment_ms() for route, clock in clocks.items()}
    mean = {route: {name: statistics.fmean(t[name] for t in times)
                    for name in times[0]} for route, times in seg.items()}
    median = {route: {name: statistics.median(t[name] for t in times)
                      for name in times[0]} for route, times in seg.items()}
    return median, mean


def beam_step_bytes(g, k, q, counts) -> dict:
    """Each beam kernel's bytes a step (beam_kernel_bytes), the mean over
    the steps beam_equal_drive counted (counts), on Index g's beam at k
    over q queries (beam_cap max(2R, 4k), rerank every candidate)."""
    r, ew = g._r, g._expand_width
    row = (5 + g._bits * g._neighbors.words) * r * 4
    dims = (max(2 * r, 4 * k), k, ew, ew * r, ew * r, g._raw.shape[1], row,
            4 if g._visited_hash_bits() else 1)
    per_step = [beam_kernel_bytes(q, *n, dims) for n in counts]
    return {name: statistics.fmean(b[name] for b in per_step)
            for name in BEAM_KERNELS}


def log_segment_times(label, median, mean, steps, card, note=""):
    """One line per route: each segment's ms per step, median (mean) of
    the steps, and the step's sum."""
    for route in median:
        log(f"  {label}{route}: ms per step, median (mean) of {steps} "
            f"steps: "
            + ", ".join(f"{name} {ms:.4f} ({mean[route][name]:.4f})"
                        for name, ms in median[route].items())
            + f"; step {sum(median[route].values()):.4f} "
            f"({sum(mean[route].values()):.4f}) ms (device time of the "
            f"segments, CUDA events)"
            + (note if route == "generic" else "") + f" [{card}]")


def beam_kernel_row(kernel, segment, nbytes, median, mean, profiled, steps,
                    card, note="") -> dict:
    """A beam kernel's numbers at one shape: its ms per launch (the median
    of the steps' kernel segment) beside the plain segment's, its bound
    from the bytes a step needs (nbytes) and roofline share, and its
    launches and ms per launch in a profiled batch (profiled); logged."""
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ms = median["kernels"][segment]
    row = dict(ms=ms, mean_ms=mean["kernels"][segment],
               plain_ms=median["plain"][segment], bound_ms=bound_ms,
               bound_by="bytes", roofline_share=bound_ms / ms,
               bytes_per_launch=nbytes,
               launches_per_batch=profiled["launches"],
               profiled_ms_per_launch=profiled["ms"] / max(
                   profiled["launches"], 1))
    log(f"  {kernel}: {ms:.4f} ms per launch (median of {steps} steps; mean "
        f"{row['mean_ms']:.4f}), plain segment {row['plain_ms']:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({nbytes / 1e6:.3f} MB a step, bytes), "
        f"roofline share {bound_ms / ms:.4f}{note}; profiled batch "
        f"{profiled['launches']} launches at "
        f"{row['profiled_ms_per_launch']:.4f} ms [{card}]")
    return row


def beam_kernel_drive(g, queries, card, prof):
    """Phase 8c: beam_equal_drive on the 1M graph index (the search's own
    arguments), with ms per step of each segment on both paths (CUDA
    events, SegmentClock; the median of the steps, the mean beside it),
    each kernel's bound from the bytes its active
    queries need (beam_kernel_bytes) and its roofline share; device ops a
    step and launches per batch from phase 8's profile (prof).  Then the
    same with the expansion and the merge generic (beam_step.GENERIC_ONLY:
    their first design), held to the plain step and timed alike; the pop
    and the gamma update have no generic variant (their generic_ms is
    None).  Returns the kernels' entries for the kernels line."""
    q_dev = torch.from_numpy(queries).cuda()
    k = K
    start = index_beam_start(g, q_dev, k)
    clocks = {route: SegmentClock(c) for route, c in SEGMENT_SLEEP.items()}
    res, counts = beam_equal_drive("8c", start, g._max_steps(k), card,
                                   clocks)
    clocks["generic"] = SegmentClock(SEGMENT_SLEEP["kernels"])
    beam_step.GENERIC_ONLY = True
    try:
        res["generic"], _ = beam_equal_drive(
            "8c generic", start, g._max_steps(k), card,
            {"kernels": clocks["generic"]})
    finally:
        beam_step.GENERIC_ONLY = False
    steps = len(counts)
    median, mean = segment_times(clocks)
    step_bytes = beam_step_bytes(g, k, len(queries), counts)
    res.update(active_per_step=[a for _, a, _ in counts],
               segment_ms_per_step=median, segment_mean_ms_per_step=mean,
               step_ms={route: sum(m.values())
                        for route, m in median.items()},
               step_mean_ms={route: sum(m.values())
                             for route, m in mean.items()},
               device_ops_per_step=prof["device_ops_per_step"])
    log_segment_times("", median, mean, steps, card,
                      " (generic expansion and merge; the pop and the gamma "
                      "update have no generic variant)")
    log(f"  device ops a step in phase 8's profiled batch "
        f"{prof['device_ops_per_step']:.1f} ({prof['steps']} steps); beam "
        f"kernels there {json.dumps(prof['beam'])} [{card}]")
    entries = []
    for name, segment in zip(BEAM_KERNELS, ("pop", "expand", "merge",
                                            "gamma")):
        bound_ms = step_bytes[name] / HBM_BYTES_PER_S * 1e3
        generic_ms = (median["generic"][segment] if name in GENERIC_VARIANTS
                      else None)
        generic = ("no generic variant" if generic_ms is None else
                   f"generic kernel {generic_ms:.4f} ms, roofline share "
                   f"{bound_ms / generic_ms:.4f}")
        row = beam_kernel_row(name, segment, step_bytes[name], median, mean,
                              prof["beam"][name], steps, card,
                              f" ({generic})")
        entries.append(dict(
            name=name, route="cuda",
            source="cphnsw_tpu_torch/csrc/beam_step.cu",
            replaces="cphnsw_tpu/search/beam.py:244",
            max_abs_err=max(res["max_abs_err"],
                            res["generic"]["max_abs_err"]),
            library_ms=None, generic_ms=generic_ms,
            generic_roofline_share=None if generic_ms is None
            else bound_ms / generic_ms, **row))
    if min(p["launches"] for p in prof["beam"].values()) <= 0:
        fail(f"the profiled graph batch ran no beam kernel: {prof['beam']}")
    return entries, res


def timed_searches(search, queries, runs):
    """One warm and `runs` timed calls of search(queries), each ending on
    the host copy of its results; returns (ids, dists, seconds per call)."""
    ids, dists = search(queries)
    lat = []
    for _ in range(runs):
        t0 = time.perf_counter()
        ids, dists = search(queries)
        lat.append(time.perf_counter() - t0)
    return ids, dists, lat


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def sharded_scan_drive(data, mesh, card):
    """Phase 9's build + searches; returns (index, ids, top_c, launches,
    launches per batch)."""
    idx = sharded.ShardedScanIndex(DIM, bits=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx.build(data["base"], mesh)
    build_s = time.perf_counter() - t0
    n_local = idx._store.rows
    top_c = idx._top_c(K, N_QUERIES)
    jax_budget = scan.CandidateBudget(anchors=np.asarray([1, 10, 100]),
                                      ranks=np.asarray(JAX_1M_BUDGET_RANKS))
    log(f"  build {build_s:.2f} s, stages {json.dumps(idx.build_stages)}, "
        f"peak device memory {peak_gib():.2f} GiB [{card}]")
    log(f"  budget ranks {idx._inner._budget.ranks.tolist()} -> top_c "
        f"{top_c} at k={K} on each shard of {n_local} rows (for comparison: "
        f"the JAX package's ranks {JAX_1M_BUDGET_RANKS} on this data give "
        f"top_c {jax_budget.top_c(K, N_MAIN)} at k={K}, "
        f"{jax_budget.top_c(100, N_MAIN)} at k=100)")
    sub = scan_keys.derived_sub_batch(n_local, top_c)
    per_batch = N_SHARDS * -(-N_QUERIES // sub)
    queries = data["queries"]
    scan_keys.launches = 0
    ids, dists, lat = timed_searches(lambda q: idx.search_batch(q, k=K),
                                     queries, TIMED_RUNS)
    launches = scan_keys.launches
    p50 = statistics.median(lat)
    recall = recall_at_k(ids, data["groundtruth"], K)
    log(f"  recall@{K}={recall:.4f} QPS={len(queries) / p50:.1f} p50 batch "
        f"latency {p50 * 1e3:.2f} ms (Q={len(queries)}, batches "
        f"{[round(x * 1e3, 2) for x in lat]} ms), peak device memory "
        f"{peak_gib():.2f} GiB [{card}]")
    log(f"  scan_keys launches: {launches} over {TIMED_RUNS + 1} batches "
        f"({per_batch} per batch = {N_SHARDS} shards x "
        f"{-(-N_QUERIES // sub)} sub-batches of {sub} queries)")
    if launches < (TIMED_RUNS + 1) * per_batch:
        fail(f"sharded scan: {launches} kernel launches, fewer than one per "
             f"shard per sub-batch ({(TIMED_RUNS + 1) * per_batch})")
    if ids.shape != (len(queries), K) or not np.isfinite(dists).all():
        fail(f"sharded scan: malformed result {ids.shape}")
    if recall < MIN_RECALL:
        fail(f"sharded scan: recall@{K} {recall} < {MIN_RECALL}")
    return idx, ids, top_c, launches, per_batch


def shard_operands(idx, queries, top_c):
    """One shard's real estimate-mode kernel operands for its first
    sub-batch of queries: (operands, bins, qpad, signs)."""
    arrays = idx._store.shards[0][0]
    inner = idx._inner
    n_local, p = arrays.raw.shape
    sub = scan_keys.derived_sub_batch(n_local, top_c)
    bins, _, rows_kpad = scan_keys.fused_bin_plan(n_local, top_c)
    signs = idx._signs[arrays.raw.device]
    qpad = hadamard.pad_to(torch.from_numpy(
        queries[:sub].astype(np.float16)).cuda().float(), p)
    codes, aux = scan.estimate_store_operands(arrays.planes, arrays.node_aux,
                                              rows_kpad, p)
    qc, w_fs, y_aux = scan._query_side(qpad, signs, inner._affine_a,
                                       inner._affine_b, 1.0)
    return [codes, aux, qc.q_u.to(torch.int8), w_fs, y_aux], bins, qpad, \
        signs


def sharded_stage_split(idx, queries, top_c, card):
    """Median ms of each stage of one shard's estimate-mode search of one
    sub-batch (CUDA events around scan_search's estimate branch), and of
    the cross-shard merge of that sub-batch's four per-shard lists."""
    shards = idx._store.shards[0]
    inner = idx._inner
    arrays = shards[0]
    n_local, p = arrays.raw.shape
    _, bins, _, signs = shard_operands(idx, queries, top_c)
    sub = scan_keys.derived_sub_batch(n_local, top_c)
    rows_kpad = scan_keys.fused_bin_plan(n_local, top_c)[2]
    q16 = torch.from_numpy(queries[:sub].astype(np.float16))
    names = ["query_encode", "store_operands", "kernel", "decode", "rerank",
             "merge"]
    samples = {k: [] for k in names}
    n_s0 = min(N_MAIN, n_local)
    parts = [scan.scan_search(sh, q16.cuda(), signs, inner._affine_a,
                              inner._affine_b,
                              max(min(N_MAIN - s * n_local, n_local), 0),
                              kappa=1.0, k=K, top_c=top_c, fused=True)
             for s, sh in enumerate(shards)]
    for it in range(TIMED_RUNS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        qpad = hadamard.pad_to(q16.cuda().float(), p)
        qnorm = (qpad * qpad).sum(dim=-1)
        qc, w_fs, y_aux = scan._query_side(qpad, signs, inner._affine_a,
                                           inner._affine_b, 1.0)
        ev[1].record()
        codes, aux = scan.estimate_store_operands(
            arrays.planes, arrays.node_aux, rows_kpad, p)
        ev[2].record()
        keys = scan_keys.fused_scan_keys(codes, aux, qc.q_u.to(torch.int8),
                                         w_fs, y_aux, bins)
        ev[3].record()
        cand = scan._decode_keys(keys, top_c, bins)
        ev[4].record()
        scan._rerank(arrays.raw, arrays.norm_sq, qpad, qnorm, cand, n_s0, K)
        ev[5].record()
        sharded.merge_topk([i + s * n_local for s, (i, _) in
                            enumerate(parts)], [d for _, d in parts], K,
                           arrays.raw.device)
        ev[6].record()
        torch.cuda.synchronize()
        if it:
            for i, name in enumerate(names):
                samples[name].append(ev[i].elapsed_time(ev[i + 1]))
    split = {k: round(statistics.median(v), 4) for k, v in samples.items()}
    log(f"  stage split, ms per shard per {sub}-query sub-batch (rows "
        f"{n_local}, top_c {top_c}, bins {bins}); merge of {N_SHARDS} "
        f"shards: {json.dumps(split)} [{card}]")
    return split


def sharded_scan_round_trip(idx, ids, mesh, queries, gt):
    """Save -> load into a fresh single-device ScanIndex and a fresh
    ShardedScanIndex; the sharded reload must return equal ids."""
    with tempfile.TemporaryDirectory() as tmp:
        f = Path(tmp) / "sharded_scan.npz"
        t0 = time.perf_counter()
        idx.save(f)
        save_s = time.perf_counter() - t0
        size_mib = f.stat().st_size / 2**20
        single = ScanIndex(DIM, bits=1, device="cuda").load(f)
        ids_1, _ = single.search_batch(queries, k=K)
        del single
        torch.cuda.empty_cache()
        fresh = sharded.ShardedScanIndex(DIM, bits=1).load(f, mesh)
        ids_2, _ = fresh.search_batch(queries, k=K)
        del fresh
    total_s = time.perf_counter() - t0
    same_1 = float((ids_1 == ids).mean())
    over_1 = float((ids_1[:, :, None] == ids[:, None, :]).any(-1).mean())
    log(f"  save {save_s:.1f} s ({size_mib:.1f} MiB), save -> load -> "
        f"search both {total_s:.1f} s; fresh ShardedScanIndex ids equal: "
        f"{np.array_equal(ids, ids_2)}; fresh single-device ScanIndex "
        f"(sketch mode): recall@{K} {recall_at_k(ids_1, gt, K):.4f}, ids "
        f"equal at {same_1:.4f} of positions, overlap {over_1:.4f}")
    if not np.array_equal(ids, ids_2):
        fail("sharded scan ids after save -> load differ")
    if recall_at_k(ids_1, gt, K) < MIN_RECALL or over_1 < 0.99:
        fail("the sharded scan file does not search alike on one device")


def sharded_graph_drive(name, data, bits, mesh, card):
    """Build + one warm and SHARDED_GRAPH_RUNS timed searches of the first
    GRAPH_QUERIES queries; returns (index, queries, ids)."""
    idx = sharded.ShardedIndex(DIM, bits=bits, r=32)
    kept_before = beam.kept_bytes()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with NNDescentClock() as nnd:
        idx.build(data["base"], mesh)
    build_s = time.perf_counter() - t0
    nnd.peak_gib = peak_gib()
    kept_build = beam.kept_bytes() - kept_before
    log(f"  {name}: after the build the beam's kept graphs grew by "
        f"{kept_build} B [{card}]")
    p = idx._params
    log(f"  {name}: build {build_s:.2f} s, stages "
        f"{json.dumps(idx.build_stages)}, {idx._store.rows} rows per "
        f"shard, peak device memory {peak_gib():.2f} GiB [{card}]")
    log(f"  {name}: pooled params affine=({p.affine_a:.6g}, "
        f"{p.affine_b:.6g}) ip_qo_floor={p.ip_qo_floor:.6g} "
        f"gamma={p.gamma:.6g} gamma_max={p.gamma_max:.6g} "
        f"gamma_beta={p.gamma_beta:.6g} gamma_warmup={p.gamma_warmup} "
        f"slack_levels={[round(x, 6) for x in p.slack_levels.tolist()]}; "
        f"step budget {idx._step_budget} -> {idx._max_steps(K)} steps at "
        f"k={K}")
    queries = data["queries"][:GRAPH_QUERIES]
    ids, dists, lat = timed_searches(lambda q: idx.search_batch(q, k=K),
                                     queries, SHARDED_GRAPH_RUNS)
    p50 = statistics.median(lat)
    log(f"  {name}: after the searches the beam's kept graphs hold "
        f"{beam.kept_bytes() / 2**30:.4f} GiB (at most "
        f"{beam.KEPT_BYTES_PER_DEVICE / 2**30:g}); allocated / reserved "
        f"{' / '.join(f'{x:.4f}' for x in resident_gib())} GiB [{card}]")
    if kept_build > 0 or beam.kept_bytes() > beam.KEPT_BYTES_PER_DEVICE:
        fail(f"{name}: the build kept {kept_build} B of beam graphs (the "
             f"step budgets keep none) or the searches left "
             f"{beam.kept_bytes()} B, above the budget")
    recall = recall_at_k(ids, data["groundtruth"][:GRAPH_QUERIES], K)
    log(f"  {name}: recall@{K}={recall:.4f} QPS={len(queries) / p50:.1f} "
        f"p50 batch latency {p50 * 1e3:.2f} ms (Q={len(queries)}, batches "
        f"{[round(x * 1e3, 2) for x in lat]} ms), peak device memory "
        f"{peak_gib():.2f} GiB [{card}]")
    log(f"  {name}: recall@{K}={recall:.4f}, build {build_s:.2f} s, "
        f"{nnd.line()} [{card}]")
    if ids.shape != (len(queries), K) or not np.isfinite(dists).all():
        fail(f"{name}: malformed result {ids.shape}")
    if recall < GRAPH_MIN_RECALL:
        fail(f"{name}: recall@{K} {recall} < {GRAPH_MIN_RECALL}")
    return idx, queries, ids


def nndescent_drive(card):
    """Phase 6b: NNDescent on one NND_N x NND_DIM store (R = NND_R, seed
    3) on the card and on the CPU from the same Threefry keys: the share
    of rows whose edge sets are equal after the whole build and after its
    first round from the same random init (a build from seed 4 beside
    them, for scale); then the second probe round's draws (its
    reverse-list priorities, the first chunk's forward and reverse
    sampling bits) and its reverse lists on the CPU's graph, card against
    CPU bit for bit."""
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((32, NND_DIM)).astype(np.float32) * 3.0
    x = torch.from_numpy(centers[rng.integers(0, 32, NND_N)]
                         + rng.standard_normal((NND_N, NND_DIM))
                         .astype(np.float32))
    ns = (x * x).sum(1)
    xg, nsg = x.cuda(), ns.cuda()

    def rows_equal(a, b) -> float:
        return (a.cpu().sort(1).values == b.cpu().sort(1).values).all(
            1).double().mean().item()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wg_g = nndescent.run_adaptive(xg, nsg, NND_R, seed=3)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wg_c = nndescent.run_adaptive(x, ns, NND_R, seed=3)
    cpu_s = time.perf_counter() - t0
    build_same = rows_equal(wg_g.ids, wg_c.ids)
    other_seed = rows_equal(
        nndescent.run_adaptive(xg, nsg, NND_R, seed=4).ids, wg_c.ids)
    # the keys run_adaptive(seed=3) gives its two probe rounds
    _, k0, k1 = threefry.split(threefry.prng_key(3 + 1), 3)
    init = nndescent.init_random(x, ns, NND_R, seed=3)
    round_same = rows_equal(
        nndescent.join_round(xg, nsg, nndescent.WorkingGraph(
            *(a.cuda() for a in init)), NND_R, k0)[0].ids,
        nndescent.join_round(x, ns, init, NND_R, k0)[0].ids)
    k_rev, k_join = threefry.split(k1)
    k_fwd, k_bwd = threefry.split(threefry.split(k_join)[1], 2)
    count = NND_N * NND_R

    def draws(dev):
        return [threefry.randint(k_rev, count, 0, 1 << 20, dev),
                threefry.random_bits(k_fwd, 0, count, dev),
                threefry.random_bits(k_bwd, 0, count, dev),
                nndescent.reverse_lists(wg_c.ids.to(dev), k_rev, NND_R)]

    bits_equal = [torch.equal(a.cpu(), b)
                  for a, b in zip(draws("cuda"), draws("cpu"))]
    log(f"  [6b] NNDescent {NND_N // 1000}k x {NND_DIM}d R={NND_R}: card "
        f"{card_s:.3f} s, CPU {cpu_s:.3f} s; rows with equal edge sets, "
        f"card vs CPU: build {build_same:.6f} "
        f"({round((1 - build_same) * NND_N)} differ), first round from the "
        f"same init {round_same:.6f} "
        f"({round((1 - round_same) * NND_N)} differ); a seed-4 build "
        f"{other_seed:.6f}; priorities, forward noise, reverse noise, "
        f"reverse lists equal {bits_equal} [{card}]")
    if not all(bits_equal):
        fail(f"NNDescent's Threefry draws differ between the card and the "
             f"CPU: {bits_equal}")
    if round_same < NND_MIN_ROUND_ROWS or build_same < NND_MIN_BUILD_ROWS:
        fail(f"NNDescent on the card against the CPU: rows equal "
             f"{round_same} after a round (< {NND_MIN_ROUND_ROWS}?), "
             f"{build_same} after the build (< {NND_MIN_BUILD_ROWS}?)")
    return dict(card_s=card_s, cpu_s=cpu_s, build_equal_rows=build_same,
                round_equal_rows=round_same, seed4_equal_rows=other_seed,
                draws_equal=all(bits_equal))


def cli_drive(card):
    """python -m cphnsw_tpu_torch on CLI_DATASET (configs/smoke.yaml's
    dataset and eval settings) as a subprocess, results in a temporary
    directory; returns the summary events."""
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Path(tmp) / "cli.yaml"
        cfg.write_text(f"run:\n  output_dir: {tmp}/results\n\n"
                       f"data:\n  dataset: {CLI_DATASET}\n  base_dir: {tmp}\n"
                       f"\neval:\n  k: 100\n  n_runs: 3\n")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cphnsw_tpu_torch", "--config", str(cfg),
             "--bits", "1", "--device", "cuda"],
            capture_output=True, text=True, cwd=root, timeout=300,
            # the CLI caches its set under the temporary directory it is
            # given: this one, removed with the results
            env={**os.environ, "TMPDIR": tmp})
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"the CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        events = [json.loads(ln) for ln in proc.stdout.splitlines()
                  if ln.startswith("{")]
        report = json.loads(
            (Path(tmp) / "results" / f"{CLI_DATASET}_results.json")
            .read_text())
    summaries = [e for e in events if e["event"] == "summary"]
    for e in events:
        log(f"  {json.dumps(e)}")
    case = report["results"][0]
    jax_case = jax_record(CLI_DATASET).get(case["algorithm"], {})
    log(f"  CLI subprocess {secs:.1f} s; results file: build_time_s "
        f"{case['build_time_s']}, recall@10 {case['recall_at_10']}, "
        f"recall@100 {case['recall_at_100']} (JAX record "
        f"{jax_case.get('recall_at_10')} / {jax_case.get('recall_at_100')}),"
        f" qps {case['qps']}, device {report['metadata']['device']} "
        f"[{card}]")
    if [e["event"] for e in events] != ["benchmark_start", "summary"] or \
            not {"dataset", "algorithm", "build_time_min", "memory_gib",
                 "recall_at_10", "qps"} <= set(summaries[0]):
        fail(f"the CLI printed unexpected events: {events}")
    return summaries


def chunked_stage_split(index, q_dev, top_c, card):
    """Median ms of each stage of the chunked selection on one sub-batch
    (CUDA events around the stages of scan_search's chunked branch,
    summed over the chunks), and the chunk plan."""
    arrays, n = index._arrays, index.size
    n_pad, p = arrays.raw.shape
    chunk, n_eq, rem = scan.chunk_plan(n_pad, q_dev.shape[0])
    layout = scan.chunk_layout(scan.plan_slices(n_pad, chunk, n_eq, rem),
                               top_c)
    names = ["query_encode", "unpack", "int8_product", "epilogue",
             "binned_keys", "decode", "rerank"]
    samples = {k: [] for k in names}
    for it in range(TIMED_RUNS + 1):
        ms = dict.fromkeys(names, 0.0)
        events = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        mark(None)
        qpad = hadamard.pad_to(q_dev.float(), p)
        qnorm = (qpad * qpad).sum(dim=-1)
        qc, w_fs, y_aux = scan._query_side(qpad, index._signs,
                                           index._affine_a,
                                           index._affine_b, 1.0)
        q8 = qc.q_u.to(torch.int8)
        mark("query_encode")
        keys = []
        for start, size, g, bins in layout:
            codes = pack.unpack_codes_i8(
                arrays.planes[start:start + size], p)
            mark("unpack")
            fs = scan.int8_product(q8, codes)
            mark("int8_product")
            score = scan_keys.folded_scores(
                fs, arrays.node_aux[:, start:start + size], w_fs, y_aux)
            mark("epilogue")
            keys.append(scan._binned_keys(score, g, bins))
            mark("binned_keys")
        cand = scan.decode_chunk_keys(keys, layout, top_c)
        mark("decode")
        scan._rerank(arrays.raw, arrays.norm_sq, qpad, qnorm, cand, n, K)
        mark("rerank")
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(events, events[1:]):
            ms[name] += a.elapsed_time(b)
        if it:
            for name in names:
                samples[name].append(ms[name])
    split = {k: round(statistics.median(v), 4) for k, v in samples.items()}
    log(f"  chunked stage split, ms per {q_dev.shape[0]}-query sub-batch "
        f"(chunk plan {n_eq} x {chunk} + {rem} rows, top_c {top_c}; "
        f"(groups, bins) per chunk "
        f"{sorted({(g, bins) for _, _, g, bins in layout})}): "
        f"{json.dumps(split)} [{card}]")
    return split


def selection_drives(index, data, kernel_ids, card):
    """Phases 5a-5c on the main index: the chunked selection and the
    exact selection against the kernel path on one sub-batch, then the
    bf16 two-stage rerank of TWO_STAGE_CANDIDATES candidates."""
    arrays, n = index._arrays, index.size
    n_pad = arrays.raw.shape[0]
    q16 = data["queries"][:SUB_BATCH].astype(np.float16)
    q_dev = torch.from_numpy(q16).cuda()
    gt = data["groundtruth"][:SUB_BATCH]
    kernel_ids = kernel_ids[:SUB_BATCH]
    chunk = scan.chunk_plan(n_pad, SUB_BATCH)[0]
    top_c = max(min(index._budget.top_c(K, n), chunk), K)
    # the JAX package's off-TPU ScanIndex passes a sketch only from
    # TWO_STAGE_MIN_C candidates, bf16 at this store size
    sketch = None
    if top_c >= scan.TWO_STAGE_MIN_C:
        sketch = scan.make_rerank_sketch(arrays.raw, arrays.norm_sq)
    out = {}
    for name, kw in (("chunked", dict(fused=False)),
                     ("exact_select", dict(exact_select=True))):
        def search():
            return scan.scan_search(
                arrays, q_dev, index._signs, index._affine_a,
                index._affine_b, n, kappa=1.0, k=K, top_c=top_c,
                sketch=sketch, **kw)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launches = scan_keys.launches
        ms = median_ms(search)
        ids, dists = (t.cpu().numpy() for t in search())
        if scan_keys.launches != launches:
            fail(f"{name}: the selection launched the scan_keys kernel")
        recall = recall_at_k(ids, gt, K)
        over = float((ids[:, :, None] == kernel_ids[:, None, :]).any(-1)
                     .mean())
        out[name] = dict(ms=ms, recall=recall, overlap=over, top_c=top_c,
                         peak_gib=peak_gib())
        log(f"  [5{'a' if name == 'chunked' else 'b'}] {name} selection, "
            f"{SUB_BATCH} queries: {ms:.3f} ms per sub-batch (median of "
            f"{TIMED_RUNS}), recall@{K}={recall:.4f}, id overlap with the "
            f"kernel path {over:.4f}, top_c {top_c}, sketch "
            f"{'bf16' if sketch is not None else 'none'}, peak device "
            f"memory {peak_gib():.2f} GiB [{card}]")
        if ids.shape != (SUB_BATCH, K) or not np.isfinite(dists).all():
            fail(f"{name}: malformed result {ids.shape}")
        if recall < MIN_RECALL:
            fail(f"{name}: recall@{K} {recall} < {MIN_RECALL}")
    out["chunked_stage_ms"] = chunked_stage_split(index, q_dev, top_c, card)

    # 5c: the bf16 two-stage rerank, on the exact nearest candidates in a
    # shuffled order
    qpad = hadamard.pad_to(q_dev.float(), arrays.raw.shape[1])
    qnorm = (qpad * qpad).sum(dim=-1)
    cand, _ = scan._true_topk_chunked(arrays.raw, arrays.norm_sq, qpad,
                                      qnorm, n, TWO_STAGE_CANDIDATES)
    cand = cand.gather(1, torch.argsort(torch.rand(cand.shape,
                                                   device=cand.device)))
    bf16 = scan.make_rerank_sketch(arrays.raw, arrays.norm_sq)
    stages = []
    spied = scan._candidate_topk

    def spy(raw, *args):
        stages.append(str(raw.dtype).replace("torch.", ""))
        return spied(raw, *args)

    scan._candidate_topk = spy
    try:
        ids_2, d_2 = scan._rerank(arrays.raw, arrays.norm_sq, qpad, qnorm,
                                  cand, n, K, sketch=bf16)
    finally:
        scan._candidate_topk = spied
    ids_1, _ = scan._rerank(arrays.raw, arrays.norm_sq, qpad, qnorm, cand,
                            n, K)
    two_ms = median_ms(lambda: scan._rerank(
        arrays.raw, arrays.norm_sq, qpad, qnorm, cand, n, K, sketch=bf16))
    one_ms = median_ms(lambda: scan._rerank(
        arrays.raw, arrays.norm_sq, qpad, qnorm, cand, n, K))
    ids_2, ids_1 = ids_2.cpu().numpy(), ids_1.cpu().numpy()
    over = float((ids_2[:, :, None] == ids_1[:, None, :]).any(-1).mean())
    log(f"  [5c] rerank of {cand.shape[1]} candidates x {SUB_BATCH} "
        f"queries: branch ran = stages {stages} (two-stage: bf16 sketch "
        f"selects {scan._rerank_survivors(K, cand.shape[1])} survivors, "
        f"then f32), {two_ms:.3f} ms against single-stage f32 "
        f"{one_ms:.3f} ms, id overlap {over:.4f}, recall@{K} "
        f"{recall_at_k(ids_2, gt, K):.4f} [{card}]")
    if stages != ["bfloat16", "float32"] or bf16.scale is not None:
        fail(f"the bf16 two-stage rerank did not run: stages {stages}")
    if over < 0.99 or not torch.isfinite(d_2).all():
        fail(f"bf16 two-stage rerank overlap {over} < 0.99")
    out["two_stage"] = dict(candidates=cand.shape[1], stages=stages,
                            ms=two_ms, single_stage_ms=one_ms, overlap=over)
    return out


def threefry_drive(card):
    """Phase 5d: seconds to draw the 1M x 128d recipe on the card, and the
    same generator on the card against the CPU at 4096 x 64 (32
    clusters, 100 queries): integer draws equal, max ulp of the
    normals."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base, _ = datasets._device_synthetic(N_MAIN, DIM, N_QUERIES, 256, 0,
                                         "cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    del base
    torch.cuda.empty_cache()
    kc, ka, kn, kq, _ = threefry.split(threefry.prng_key(0), 5)
    equal = all(torch.equal(a.cpu(), b) for a, b in (
        (threefry.randint(ka, 4096, 0, 32, "cuda"),
         threefry.randint(ka, 4096, 0, 32, "cpu")),
        (threefry.permutation(kq, 4096, "cuda")[:100],
         threefry.permutation(kq, 4096, "cpu")[:100])))

    def ordinal(t):
        i = t.cpu().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    max_ulp = 0
    for key, shape in ((kc, (32, 64)), (kn, (4096, 64))):
        a = threefry.normal(key, shape, "cuda")
        b = threefry.normal(key, shape, "cpu")
        max_ulp = max(max_ulp, int((ordinal(a) - ordinal(b)).abs().max()))
    b_cuda, q_cuda = datasets._device_synthetic(4096, 64, 100, 32, 0, "cuda")
    b_cpu, q_cpu = datasets._device_synthetic(4096, 64, 100, 32, 0, "cpu")
    data_ulp = int((ordinal(b_cuda) - ordinal(b_cpu)).abs().max())
    log(f"  [5d] Threefry recipe: {N_MAIN // 1000}k x {DIM}d drawn on the "
        f"card in "
        f"{gen_s:.3f} s; card vs CPU at 4096 x 64: integer draws equal "
        f"{equal}, max ulp of the normals {max_ulp}, of the base "
        f"{data_ulp}, queries equal {np.array_equal(q_cuda, q_cpu)} "
        f"[{card}]")
    if not equal:
        fail("the Threefry integer draws differ between the card and CPU")
    if max_ulp or data_ulp or not np.array_equal(q_cuda, q_cpu):
        fail(f"the Threefry normals differ between the card and the CPU: "
             f"{max_ulp} ulps, base {data_ulp}")
    return dict(generate_s=gen_s, integers_equal=equal,
                normal_max_ulp=max_ulp)


def brute_force_drive(small, card):
    """Phase 5e: BruteForceIndex(128, bits=1) on the 100k x 128d data,
    one warm and TIMED_RUNS timed BRUTE_QUERIES-query batches."""
    queries = small["queries"][:BRUTE_QUERIES]
    gt = small["groundtruth"][:BRUTE_QUERIES]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = bruteforce.BruteForceIndex(DIM, bits=1, device="cuda").build(
        small["base"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids, dists, lat = timed_searches(lambda q: idx.search_batch(q, k=K),
                                     queries, TIMED_RUNS)
    p50 = statistics.median(lat)
    recall = recall_at_k(ids, gt, K)
    exact = ((queries[:, None, :] - small["base"][ids]) ** 2).sum(-1)
    log(f"  [5e] BruteForceIndex {N_SMALL // 1000}k x {DIM}d 1-bit: build "
        f"{build_s:.2f} s, "
        f"recall@{K}={recall:.4f} (top_c {max(4 * K, 100)}), "
        f"QPS={len(queries) / p50:.1f}, p50 batch {p50 * 1e3:.2f} ms "
        f"(Q={len(queries)}), peak device memory {peak_gib():.2f} GiB "
        f"[{card}]")
    if ids.shape != (len(queries), K) or not np.allclose(
            dists, exact, rtol=1e-3, atol=1e-3):
        fail("brute force: malformed result or inexact distances")
    # the same index with ten times the default candidates
    wide, _, wide_lat = timed_searches(
        lambda q: idx.search_batch(q, k=K, top_c=10 * max(4 * K, 100)),
        queries, TIMED_RUNS)
    wide_recall = recall_at_k(wide, gt, K)
    wide_qps = len(queries) / statistics.median(wide_lat)
    log(f"  [5e] top_c {10 * max(4 * K, 100)}: recall@{K}="
        f"{wide_recall:.4f}, QPS={wide_qps:.1f} [{card}]")
    if recall < BRUTE_MIN_RECALL:
        fail(f"brute force: recall@{K} {recall} < {BRUTE_MIN_RECALL}")
    return dict(recall=recall, qps=len(queries) / p50, build_s=build_s,
                recall_top_c_1000=wide_recall, qps_top_c_1000=wide_qps)


def rerank_width_drive(g, queries, card):
    """Phase 7f: the beam with rerank_width = RERANK_WIDTH against the
    default (rerank every candidate) on the same queries; each width is
    warmed once, then timed as the median of TIMED_RUNS runs.  The beam
    kernels' launches of the RERANK_WIDTH runs are counted alone (the
    counters set to 0 just before them), then its step is held to the
    plain step (beam_equal_drive)."""
    q_dev = torch.from_numpy(queries).cuda()
    runs = {}
    for width in (0, RERANK_WIDTH):
        out = []

        def search():
            out[:] = g._beam(q_dev, g._entry_candidates, K, g._max_steps(K),
                             rerank_width=width, debug_state=True)

        zero_beam_launches()
        ms = median_ms(search)
        launches, variants = beam_launches(), beam_variant_launches()
        ids, d, state = out
        runs[width] = (ids.cpu().numpy(), d.cpu().numpy(), state.steps, ms)
    launches = beam_path_launches(f"rerank_width={RERANK_WIDTH}", launches,
                                  variants)
    (ids0, _, s0, ms0), (ids8, d8, s8, ms8) = runs[0], runs[RERANK_WIDTH]
    over = float((ids8[:, :, None] == ids0[:, None, :]).any(-1).mean())
    raw = g._raw.cpu().numpy()
    qpad = np.pad(queries, ((0, 0), (0, raw.shape[1] - queries.shape[1])))
    exact = ((qpad[:, None, :] - raw[np.maximum(ids8, 0)]) ** 2).sum(-1)
    log(f"  [7f] beam rerank_width={RERANK_WIDTH} of "
        f"{g._expand_width * g._r} candidates a step: id overlap with "
        f"rerank_width=0 {over:.4f}; {s8} steps in {ms8:.2f} ms against "
        f"{s0} in {ms0:.2f} ms (Q={len(queries)}, each warmed once, median "
        f"of {TIMED_RUNS}) [{card}]")
    if (ids8 < 0).any() or not np.allclose(d8, exact, rtol=1e-3, atol=1e-3):
        fail("rerank_width beam: missing ids or inexact distances")
    equal, _ = beam_equal_drive(
        "7f", index_beam_start(g, q_dev, K, RERANK_WIDTH), g._max_steps(K),
        card)
    return launches, dict(overlap=over, steps=s8, ms=ms8, steps_full=s0,
                          ms_full=ms0, kernels_equal_plain=equal)


def round_f32(x: Fraction) -> float:
    """The f32 nearest to x, ties to even (|x| below the f32 maximum)."""
    if x == 0:
        return 0.0
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    n, rem = divmod(x, ulp)
    if rem * 2 > ulp or (rem * 2 == ulp and n % 2 == 1):
        n += 1
    return sign * float(n * ulp)


def fma_drive(card):
    """fma_f32 on the card against the CPU and against exact arithmetic:
    the witness of a double rounding (a float64 sum that lands on an f32
    midpoint) and FMA_SWEEP seeded triples whose exact a * b + c lies
    within a few float64 ulps of an f32 midpoint."""
    rng = np.random.default_rng(0)
    n = FMA_SWEEP
    m = rng.integers(1 << 23, 1 << 24, n).astype(np.float64)
    k = rng.integers(-40, 40, n)
    c = np.ldexp(m, k) * rng.choice([-1.0, 1.0], n)
    u = rng.integers(-200, 201, n).astype(np.float64) * 2.0 ** -23
    v = -u + rng.integers(-1, 2, n) * 2.0 ** -23
    sh = rng.integers(-30, 30, n)
    a = np.ldexp(1.0 + u, sh)
    b = np.ldexp(1.0 + v, k - 1 - sh) * rng.choice([-1.0, 1.0], n)
    # the witness first: exact result 1 + 2^-23, 1 + 2^-22 if rounded twice
    a = np.concatenate([[1 + 2.0 ** -18], a]).astype(np.float32)
    b = np.concatenate([[2.0 ** -24 * (1 - 2.0 ** -18)], b]).astype(
        np.float32)
    c = np.concatenate([[1 + 2.0 ** -23], c]).astype(np.float32)
    exact = np.array([round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                      for x, y, z in zip(a, b, c)], np.float32)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    on_cpu = fma_f32(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    on_card = fma_f32(*(torch.from_numpy(t).cuda() for t in (a, b, c)))
    # Python-float operands, as the Threefry polynomials pass them
    scalar = fma_f32(float(a[0]), torch.from_numpy(b[:1]).cuda(),
                     float(c[0])).cpu().numpy()
    on_card = on_card.cpu().numpy()
    # the sweep is small, so that was fma_f32's masked route; its other
    # route (large results: the hits gathered) must give the same bits
    gathered, route_ms = fma_routes(a, b, c)
    if (gathered != on_card).any():
        fail(f"fma_f32: its two routes differ on "
             f"{int((gathered != on_card).sum())} of {n + 1} triples")
    log(f"  fma_f32 routes, both exact (ms, median of {TIMED_RUNS}): a "
        f"chain of 5 on (2048, 1024), the plain version's group: masked "
        f"{route_ms['group_masked']:.4f} (the route taken), gathered "
        f"{route_ms['group_gathered']:.4f}; one on (2048, 131072), a "
        f"chunk of the chunked selection: gathered "
        f"{route_ms['chunk_gathered']:.4f} (the route taken), masked "
        f"{route_ms['chunk_masked']:.4f}; a float64 sum and cast "
        f"{route_ms['group_twice']:.4f} / {route_ms['chunk_twice']:.4f} "
        f"[{card}]")
    bad_card = int((on_card != exact).sum())
    bad_cpu = int((on_cpu != exact).sum())
    log(f"  fma_f32: witness on the card {on_card[0]!r} (exact "
        f"{exact[0]!r}, rounded twice {twice[0]!r}); sweep of {n} "
        f"near-midpoint triples: card != exact {bad_card}, CPU != exact "
        f"{bad_cpu}, card != CPU {int((on_card != on_cpu).sum())}; a float64 "
        f"sum cast to f32 gets {int((twice != exact).sum())} wrong [{card}]")
    if exact[0] != np.float32(1 + 2.0 ** -23) or scalar[0] != exact[0]:
        fail("fma_f32: the witness triple is not rounded once")
    if bad_card or bad_cpu:
        fail(f"fma_f32 differs from exact arithmetic: card {bad_card}, CPU "
             f"{bad_cpu} of {n + 1}")
    if not (twice != exact).any():
        fail("fma_f32: the sweep never reaches a double rounding")
    return dict(triples=n + 1, card_mismatches=bad_card,
                cpu_mismatches=bad_cpu,
                double_rounding_cases=int((twice != exact).sum()),
                route_ms=route_ms)


def fma_routes(a, b, c):
    """fma_f32's two routes on the card: the sweep through the gathered
    route, and each route's time at the two sizes the port calls it with
    (a group of the kernel's plain version, a chunk of the chunked
    selection), beside the float64 sum and cast it replaced."""
    dense_max = rounding._DENSE_MAX
    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(rows):
        return (torch.randn((2048, 1), device="cuda", generator=gen),
                torch.randn((1, rows), device="cuda", generator=gen),
                torch.randn((2048, rows), device="cuda", generator=gen))

    def chain(fma, x, y, z, links):
        for _ in range(links):
            z = fma(x, y, z)
        return z

    def twice(x, y, z):
        return (x.double() * y.double() + z.double()).float()

    ms = {}
    try:
        rounding._DENSE_MAX = 0
        gathered = fma_f32(*(torch.from_numpy(t).cuda()
                             for t in (a, b, c))).cpu().numpy()
        for name, rows, links in (("group", 1024, 5), ("chunk", 131072, 1)):
            ops = operands(rows)
            if (ops[2].numel() <= dense_max) != (name == "group"):
                fail(f"fma_f32: the {name} shape no longer takes the route "
                     f"this phase names (_DENSE_MAX = {dense_max})")
            for route, limit in (("gathered", 0), ("masked", 1 << 62)):
                rounding._DENSE_MAX = limit
                ms[f"{name}_{route}"] = median_ms(
                    lambda: chain(fma_f32, *ops, links))
            ms[f"{name}_twice"] = median_ms(lambda: chain(twice, *ops, links))
            del ops
            torch.cuda.empty_cache()
    finally:
        rounding._DENSE_MAX = dense_max
    return gathered, ms


def cache_drive(card):
    """Phase 5f: make_synthetic's disk cache at N_SMALL x DIM in a
    directory under the build directory; the second call must return
    equal arrays from the file."""
    cache = scan_keys.BUILD_DIR / "synth_cache"
    shutil.rmtree(cache, ignore_errors=True)
    kw = dict(n_queries=N_QUERIES, gt_k=K, n_clusters=256, seed=0,
              gt_device="cuda", cache_dir=cache)
    name = f"synthetic-{N_SMALL // 1000}k-{DIM}d"
    try:
        t0 = time.perf_counter()
        first = make_synthetic(name, **kw)
        first_s = time.perf_counter() - t0
        files = sorted(f.name for f in cache.iterdir())
        size_mib = sum(f.stat().st_size for f in cache.iterdir()) / 2**20
        t0 = time.perf_counter()
        second = make_synthetic(name, **kw)
        second_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    equal = all(np.array_equal(first[key], second[key])
                for key in ("base", "queries", "groundtruth"))
    log(f"  [5f] make_synthetic cache, {name}: first call {first_s:.3f} s "
        f"(drawn, ground truth on the card, written), second call "
        f"{second_s:.3f} s (read), file {files} {size_mib:.1f} MiB, arrays "
        f"equal {equal} [{card}]")
    if len(files) != 1 or not equal or second["dim"] != DIM:
        fail(f"make_synthetic cache: files {files}, arrays equal {equal}")
    if second_s >= first_s:
        fail(f"make_synthetic cache: the read ({second_s:.3f} s) is not "
             f"faster than the draw ({first_s:.3f} s)")
    return dict(first_s=first_s, second_s=second_s, file_mib=size_mib)


def sharded_chunked_drive(idx, data, mesh, kernel_ids, card):
    """Phase 9c: the sharded store through sharded_scan_search(fused=False)
    on the local chunk plan, CHUNKED_QUERIES queries: recall@10, id
    overlap with the kernel path, ms per batch (CUDA events, median of
    TIMED_RUNS after one warm call), and no kernel launch."""
    inner = idx._inner
    n_local = idx._store.rows
    queries = data["queries"][:CHUNKED_QUERIES]
    q16 = queries.astype(np.float16)
    plan = scan.chunk_plan(n_local, CHUNKED_QUERIES)
    top_c = idx._top_c(K, CHUNKED_QUERIES)
    out = []

    def search():
        out[:] = sharded.sharded_scan_search(
            idx._store, q16, idx._signs[mesh.devices[0, 0]], inner._affine_a,
            inner._affine_b, inner._n, mesh, kappa=1.0, k=K, top_c=top_c,
            fused=False)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches = scan_keys.launches
    ms = median_ms(search)
    launched = scan_keys.launches - launches
    ids, dists = (t.cpu().numpy() for t in out)
    recall = recall_at_k(ids, data["groundtruth"][:CHUNKED_QUERIES], K)
    kernel_ids = kernel_ids[:CHUNKED_QUERIES]
    over = float((ids[:, :, None] == kernel_ids[:, None, :]).any(-1).mean())
    log(f"  [9c] sharded_scan_search(fused=False), {CHUNKED_QUERIES} queries "
        f"over {N_SHARDS} shards of {n_local} rows, local chunk plan "
        f"{plan[1]} x {plan[0]} + {plan[2]} rows, top_c {top_c}: "
        f"{ms:.3f} ms per batch (median of {TIMED_RUNS}), recall@{K}="
        f"{recall:.4f}, id overlap with the kernel path {over:.4f}, "
        f"scan_keys launches {launched}, peak device memory "
        f"{peak_gib():.2f} GiB [{card}]")
    if launched:
        fail(f"the chunked sharded scan launched the kernel {launched} times")
    if ids.shape != (CHUNKED_QUERIES, K) or not np.isfinite(dists).all():
        fail(f"chunked sharded scan: malformed result {ids.shape}")
    if recall < MIN_RECALL or over < 0.99:
        fail(f"chunked sharded scan: recall@{K} {recall}, overlap {over}")
    return dict(ms=ms, recall=recall, overlap=over, top_c=top_c,
                chunk_plan=list(plan), peak_gib=peak_gib())


def sharded_seeds_drive(idx, queries, base, mesh, card):
    """Phase 10b: the sharded graph through sharded_search(n_seeds=2)
    against n_seeds=4 (the facade's): k valid ids with exact distances
    from both, their overlap, and the steps shard 0's beam takes to
    converge from each (under the generic 512-step cap: the index's derived
    budget cuts both off at the same step).  With no step taken the merged
    list is the shards' seeds alone, so it must hold n_seeds ids per shard:
    the proof that the argument reaches every beam."""
    out, steps = {}, {}
    n_model = mesh.shape["model"]
    signs = idx._signs[mesh.devices[0, 0]]
    for n_seeds in (1, 2, 4):
        ids0 = sharded.sharded_search(
            idx._store, queries, idx._params, signs, mesh, bits=idx.bits,
            k=K, max_steps=0, n_seeds=n_seeds, n_real=idx._n)[0].cpu().numpy()
        valid = (ids0 >= 0).sum(1)
        want = min(K, n_seeds * n_model)
        # a shard-padding duplicate among a shard's seeds is masked out
        if (valid > want).any() or (valid < want - n_model).any() or \
                (n_seeds * n_model < K and (valid >= K).any()):
            fail(f"sharded graph n_seeds={n_seeds}, no steps: "
                 f"{valid.min()}..{valid.max()} ids per query, want {want}")
    sh = idx._store.shards[0][0]
    dev = sh.raw.device
    for n_seeds in (4, 2):
        ids, d = sharded.sharded_search(
            idx._store, queries, idx._params, signs, mesh, bits=idx.bits,
            k=K, max_steps=idx._max_steps(K), n_seeds=n_seeds, n_real=idx._n)
        out[n_seeds] = (ids.cpu().numpy(), d.cpu().numpy())
        state = beam.search_batch(
            sh.raw, sh.norm_sq, sh.neighbors, sh.entry_candidates,
            idx._signs[dev], torch.from_numpy(queries).to(dev),
            idx._params_dev[dev], bits=idx.bits, k=K,
            max_steps=512, n_seeds=n_seeds, debug_state=True)[2]
        steps[n_seeds] = state.steps
    for n_seeds, (ids, d) in out.items():
        exact = ((queries[:, None, :] - base[np.maximum(ids, 0)]) ** 2
                 ).sum(-1)
        if ids.shape != (len(queries), K) or (ids < 0).any() or                 (ids >= idx._n).any() or                 not np.allclose(d, exact, rtol=1e-3, atol=1e-3):
            fail(f"sharded graph n_seeds={n_seeds}: missing ids or inexact "
                 f"distances")
    over = float((out[2][0][:, :, None] == out[4][0][:, None, :]).any(-1)
                 .mean())
    log(f"  [10b] sharded_search(n_seeds=2) against n_seeds=4 "
        f"(Q={len(queries)}): {K} valid ids with exact distances from both, "
        f"id overlap {over:.4f}; with no step taken each query holds n_seeds "
        f"ids per shard (1, 2, 4 checked); uncapped, shard 0's beam ran "
        f"{steps[2]} steps from 2 seeds, {steps[4]} from 4 (the index's "
        f"budget is {idx._max_steps(K)}) [{card}]")
    return dict(overlap=over, steps_2=steps[2], steps_4=steps[4])


def jax_form_scan_drive(idx, data, mesh, card):
    """Phase 9d: sharded_scan_search in the JAX package's call form on the
    phase 9 store: one signs tensor, the chunk plan left to its default,
    queries a CUDA tensor.  With fused=True (the facade's route) the ids
    and distances of all N_QUERIES queries equal ShardedScanIndex's
    search_batch bit for bit, through the same kernel launches; with
    `fused` left out (the JAX package's default, the chunked selection)
    CHUNKED_QUERIES queries equal an explicit fused=False call bit for bit
    and launch no kernel."""
    inner = idx._inner
    signs = idx._signs[mesh.devices[0, 0]]
    queries = data["queries"]
    q_dev = torch.from_numpy(queries.astype(np.float16)).cuda()
    top_c = idx._top_c(K, N_QUERIES)
    kappa = float((1 << idx.bits) - 1)
    launches = scan_keys.launches
    ids_f, d_f = idx.search_batch(queries, k=K)
    facade_launches = scan_keys.launches - launches
    ids, d = sharded.sharded_scan_search(
        idx._store, q_dev, signs, inner._affine_a, inner._affine_b,
        inner._n, mesh, kappa, K, top_c, fused=True)
    fused_launches = scan_keys.launches - launches - facade_launches
    ids, d = ids.cpu().numpy(), d.cpu().numpy()
    if not (np.array_equal(ids, ids_f) and np.array_equal(d, d_f)):
        fail("sharded_scan_search in the JAX call form (fused=True) differs "
             "from ShardedScanIndex.search_batch")
    if fused_launches != facade_launches:
        fail(f"sharded_scan_search in the JAX call form launched the kernel "
             f"{fused_launches} times, search_batch {facade_launches}")
    q_small = q_dev[:CHUNKED_QUERIES]
    top_c_small = idx._top_c(K, CHUNKED_QUERIES)
    launches = scan_keys.launches
    ids_d, d_d = (t.cpu().numpy() for t in sharded.sharded_scan_search(
        idx._store, q_small, signs, inner._affine_a, inner._affine_b,
        inner._n, mesh, kappa, K, top_c_small))
    default_launches = scan_keys.launches - launches
    ids_c, d_c = (t.cpu().numpy() for t in sharded.sharded_scan_search(
        idx._store, q_small, signs, inner._affine_a, inner._affine_b,
        inner._n, mesh, kappa, K, top_c_small, fused=False))
    if default_launches or not (np.array_equal(ids_d, ids_c)
                                and np.array_equal(d_d, d_c)):
        fail(f"sharded_scan_search's default is not the chunked selection "
             f"({default_launches} kernel launches)")
    log(f"  [9d] sharded_scan_search in the JAX call form, one signs tensor "
        f"and CUDA queries: fused=True equals search_batch bit for bit on "
        f"{N_QUERIES} queries ({fused_launches} kernel launches); the "
        f"default (chunked) equals fused=False bit for bit on "
        f"{CHUNKED_QUERIES} queries, 0 launches [{card}]")
    return dict(fused_equal=True, fused_launches=fused_launches,
                default_equal=True, default_launches=default_launches)


def jax_form_graph_drive(idx, queries, mesh, card):
    """Phase 10c: sharded_search in the JAX package's call form on the
    phase 10 index: one SearchParams, one signs tensor, n_real last,
    queries a CUDA tensor; ids and distances equal ShardedIndex's
    search_batch bit for bit.  n_real=None masks nothing (this store has
    no shard-padding rows, so it equals n_real=n), and n_real = n - 10,000
    masks every id from there up."""
    signs = idx._signs[mesh.devices[0, 0]]
    q_dev = torch.from_numpy(queries).cuda()
    steps = idx._max_steps(K)
    ids_f, d_f = idx.search_batch(queries, k=K)
    out = {}
    for n_real in (idx._n, None, idx._n - 10_000):
        ids, d = sharded.sharded_search(
            idx._store, q_dev, idx._params, signs, mesh, idx.bits, K, 128,
            steps, 4, n_real)
        out[n_real] = (ids.cpu().numpy(), d.cpu().numpy())
    for n_real in (idx._n, None):
        ids, d = out[n_real]
        if not (np.array_equal(ids, ids_f) and np.array_equal(d, d_f)):
            fail(f"sharded_search in the JAX call form (n_real={n_real}) "
                 f"differs from ShardedIndex.search_batch")
    cut = idx._n - 10_000
    above = int((out[None][0] >= cut).sum())
    if not above or (out[cut][0] >= cut).any():
        fail(f"sharded_search n_real={cut}: {above} ids >= {cut} without "
             f"the mask, or some left with it")
    log(f"  [10c] sharded_search in the JAX call form, one SearchParams, one "
        f"signs tensor, n_real last, CUDA queries: equals search_batch bit "
        f"for bit with n_real = n and None ({len(queries)} queries); "
        f"n_real = {cut} masks the {above} ids from there up [{card}]")
    return dict(equal=True, ids_masked=above)


class BuildSpy:
    """Inside a `with` block: the last CPIndex finalized (kept alive), the
    peak device memory of its build (build + finalize, read as finalize
    returns; the peak is reset on entry) and the operands of the first
    scan_keys launch that search.scan makes (a search's real kernel
    operands at the shape it launches)."""

    def __enter__(self):
        self.index = self.peak_gib = self.operands = None
        self._real = (CPIndex.finalize, scan.fused_scan_keys)
        finalize, launch = self._real

        def finalized(idx, *args, **kw):
            out = finalize(idx, *args, **kw)
            torch.cuda.synchronize()
            self.index, self.peak_gib = idx, peak_gib()
            return out

        def launched(*args, **kw):
            if self.operands is None:
                self.operands = args
            return launch(*args, **kw)

        CPIndex.finalize, scan.fused_scan_keys = finalized, launched
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return self

    def __exit__(self, *exc):
        CPIndex.finalize, scan.fused_scan_keys = self._real


def record_path(name, engine="auto") -> Path:
    """The JAX package's results file of a workload, named as its
    run_benchmark names it: suffixed _<engine> when the engine is forced."""
    suffix = "" if engine == "auto" else f"_{engine}"
    return Path(__file__).resolve().parent / "results" / \
        f"{name}{suffix}_results.json"


def jax_record(name, engine="auto") -> dict:
    """The JAX package's results file of a workload: {algorithm: case}."""
    return {c["algorithm"]: c for c in json.loads(
        record_path(name, engine).read_text())["results"]}


def recorded_runs() -> list[tuple[str, str, str]]:
    """(phase, dataset, engine) of every JAX record a phase reads through
    jax_record: phase 11's CLI run, phase 12's scan workloads and its
    graph records."""
    return ([("11", CLI_DATASET, "auto")]
            + [("12", name, "auto") for name, _, _ in WORKLOADS]
            + [("12g", name, "graph") for name, _, _ in GRAPH_WORKLOADS])


def workload_data(name) -> dict:
    """A workload's data as run_benchmark draws it: the card's Threefry
    recipe (make_synthetic's default at this size), ground truth on the
    card, no cache."""
    n, dim, metric = synthetic_shape(name)
    t0 = time.perf_counter()
    data = make_synthetic(name, cache_dir=None)     # the card, by default
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    if "base_dev_factory" not in data:
        fail(f"{name}: the store was not drawn on the card")
    log(f"  {name}: {n} x {dim}d {metric}, {len(data['queries'])} queries "
        f"drawn on the card with ground truth@"
        f"{data['groundtruth'].shape[1]} in {data_s:.2f} s")
    return data


def workload_drive(name, ks, bits_list, card, results, data=None):
    """Phase 12, one workload: its data (workload_data, drawn here unless
    given), then per bit width eval.bench_one_case at ks[0] (the build,
    one warm and WORKLOAD_RUNS timed passes), further timed passes at
    ks[1:] on the same index, and the kernel against its plain version on
    the first search's real sketch operands (once per workload: the sketch
    does not depend on the bit width)."""
    n, dim, metric = synthetic_shape(name)
    record = jax_record(name)
    if data is None:
        data = workload_data(name)
    queries, truth = data["queries"], data["groundtruth"].astype(np.int64)
    out = {}
    checked = False
    for bits in bits_list:
        label = f"{name} {bits}-bit"
        jax_case = record.get(f"cphnsw-tpu-{bits}bit", {})
        scan_keys.launches = 0
        with BuildSpy() as spy:
            case = bench_one_case(
                data["base"], queries, truth, dim=dim, bits=bits, k=ks[0],
                n_runs=WORKLOAD_RUNS, metric=metric,
                base_dev_factory=data["base_dev_factory"], device="cuda")
        launches = scan_keys.launches
        per_batch = launches / (WORKLOAD_RUNS + 1)
        p50_ms = len(queries) / case.qps * 1e3
        idx = spy.index._index
        budget = case.search_budget
        log(f"  {label}: build {case.build_time_s} s, stages "
            f"{json.dumps(case.build_stages_s)}, build peak device memory "
            f"{spy.peak_gib:.2f} GiB, case peak {peak_gib():.2f} GiB "
            f"[{card}]")
        log(f"  {label}: k={ks[0]} recall@1/10/100 {case.recall_at_1} / "
            f"{case.recall_at_10} / {case.recall_at_100} (JAX record "
            f"{jax_case.get('recall_at_1')} / {jax_case.get('recall_at_10')}"
            f" / {jax_case.get('recall_at_100')}), QPS {case.qps}, p50 batch "
            f"{p50_ms:.2f} ms (median of {WORKLOAD_RUNS}, Q={len(queries)}), "
            f"ADR {case.adr} [{card}]")
        log(f"  {label}: top_c@{ks[0]} {budget['top_c_at_k']}, ranks "
            f"{budget['ranks']} at anchors {budget['anchors']} (JAX record: "
            f"{jax_case.get('search_budget')}); survivors "
            f"{scan._rerank_survivors(ks[0], budget['top_c_at_k'])}; "
            f"scan_keys launches {launches} over {WORKLOAD_RUNS + 1} batches "
            f"= {per_batch:g} per batch")
        if per_batch < 1:
            fail(f"{label}: {launches} kernel launches, fewer than one per "
                 f"batch")
        if case.recall_at_10 < MIN_RECALL:
            fail(f"{label}: recall@10 {case.recall_at_10} < {MIN_RECALL}")
        if case.recall_at_10 < jax_case.get("recall_at_10", 0) - RECORD_GAP:
            log(f"  {label}: recall@10 more than {RECORD_GAP} below the JAX "
                f"record")
        out[f"{bits}bit"] = dict(
            build_s=case.build_time_s, build_stages_s=case.build_stages_s,
            build_peak_gib=spy.peak_gib, recall_at_1=case.recall_at_1,
            recall_at_10=case.recall_at_10, recall_at_100=case.recall_at_100,
            jax_recall_at_10=jax_case.get("recall_at_10"), qps=case.qps,
            p50_ms=p50_ms, top_c=budget["top_c_at_k"],
            ranks=budget["ranks"],
            jax_ranks=(jax_case.get("search_budget") or {}).get("ranks"),
            launches=launches, launches_per_batch=per_batch)
        for k in ks[1:]:
            scan_keys.launches = 0
            ids, _, secs = timed_searches(
                lambda q: idx.search_batch(q, k=k), queries, WORKLOAD_RUNS)
            p50 = statistics.median(secs)
            recall = recall_at_k(ids, truth, k)
            log(f"  {label}: k={k} recall@{k} {recall:.4f}, QPS "
                f"{len(queries) / p50:.1f}, p50 batch {p50 * 1e3:.2f} ms, "
                f"scan_keys launches {scan_keys.launches} over "
                f"{WORKLOAD_RUNS + 1} batches [{card}]")
            if recall < MIN_RECALL or scan_keys.launches < WORKLOAD_RUNS + 1:
                fail(f"{label}, k={k}: recall {recall}, launches "
                     f"{scan_keys.launches}")
            out[f"{bits}bit"][f"k{k}"] = dict(
                recall=recall, qps=len(queries) / p50, p50_ms=p50 * 1e3,
                launches=scan_keys.launches)
        if not checked:
            out[f"{bits}bit"]["stage_ms"] = stage_split(
                idx, queries, card, k=ks[0], sub_batch=len(queries))
            ops = list(spy.operands)
            check_kernel(f"workload-{name}", ops[:5], ops[5], card, results,
                         time_plain=False, cols=dim + (metric == "ip"))
            checked = True
            del ops
        del spy, idx
        torch.cuda.empty_cache()
    return out


class SearchSpy:
    """Inside a `with` block: for each Index.search_batch call, the CUDA
    graphs the beam captured in it (beam._graphed calls), its host seconds
    and the bytes the kept graphs hold after it (`calls`); `captures`
    counts every capture, the step budget's in finalize too."""

    def __enter__(self):
        self.calls, self.captures = [], 0
        self._real = (beam._graphed, Index.search_batch)
        graphed, search = self._real

        def counted(fn, stream):
            self.captures += 1
            return graphed(fn, stream)

        def searched(idx, *args, **kw):
            n0, t0 = self.captures, time.perf_counter()
            out = search(idx, *args, **kw)
            self.calls.append(dict(captures=self.captures - n0,
                                   seconds=time.perf_counter() - t0,
                                   kept_bytes=beam.kept_bytes()))
            return out

        beam._graphed, Index.search_batch = counted, searched
        return self

    def __exit__(self, *exc):
        beam._graphed, Index.search_batch = self._real


def graph_workload_drive(name, k, bits, data, card):
    """Phase 12g, one graph record: eval.bench_one_case(engine="graph") at
    k on the data and ground truth its scan workload drew (the graph
    engine builds from the host store, its upload counted in the build,
    as run_benchmark does), with the beam kernels' launches in it (the
    counters set to 0 just before) and each search call's captures and
    kept bytes; then the beam kernels against the plain step on the
    record's index over all its queries at the search's own shape, each
    segment timed as in 8c, and one profiled batch.  Returns (the drive's
    numbers, its beam launches for the kernels line, each beam kernel's
    row at this shape)."""
    _, dim, metric = synthetic_shape(name)
    label = f"{name} graph {bits}-bit"
    jax_case = jax_record(name, "graph").get(f"cphnsw-tpu-{bits}bit", {})
    queries, truth = data["queries"], data["groundtruth"].astype(np.int64)
    q = len(queries)
    log(f"  {label}: the beam's kept graphs hold {beam.kept_bytes()} B "
        f"before the build [{card}]")
    zero_beam_launches()
    with BuildSpy() as spy, SearchSpy() as searches:
        case = bench_one_case(data["base"], queries, truth, dim=dim,
                              bits=bits, k=k, n_runs=WORKLOAD_RUNS,
                              engine="graph", metric=metric, device="cuda")
    launches = beam_path_launches(f"{label} record", beam_launches(),
                                  beam_variant_launches())
    g = spy.index._index
    beam_cap, ew, r = max(2 * g._r, 4 * k), g._expand_width, g._r
    plan = beam_step.launch_plan(q, beam_cap, k, ew, r, ew * r,
                                 g._raw.shape[1], g._bits,
                                 g._neighbors.words)
    generic = {kern: v["generic"] for kern, v in launches["variants"].items()
               if v["generic"]}
    if generic:
        log(f"  {label}: FINDING: generic launches {generic} at this shape "
            f"(its launch plan {plan}): a shape of the build's step budget "
            f"or of the search that the Hopper variants do not take")
    calls = searches.calls
    captures = [c["captures"] for c in calls]
    replayed = len(calls) == WORKLOAD_RUNS + 1 and not any(captures[1:])
    kept = beam.kept_bytes()
    hash_bits = g._visited_hash_bits()
    visited_bytes = q * 4 * ((1 << hash_bits) + 1) if hash_bits else \
        q * (g._n + 1)
    p50_ms = case.median_latency_us * q / 1e3
    log(f"  {label}: build {case.build_time_s} s, stages "
        f"{json.dumps(case.build_stages_s)}, build peak device memory "
        f"{spy.peak_gib:.4f} GiB [{card}]")
    log(f"  {label}: k={k} recall@1/10/100 {case.recall_at_1} / "
        f"{case.recall_at_10} / {case.recall_at_100}, ADR {case.adr} (JAX "
        f"record {jax_case.get('recall_at_1')} / "
        f"{jax_case.get('recall_at_10')} / {jax_case.get('recall_at_100')},"
        f" ADR {jax_case.get('adr')}); QPS {case.qps}, p50 batch "
        f"{p50_ms:.2f} ms (median of {WORKLOAD_RUNS}, Q={q}; host seconds "
        f"of the warm and timed calls "
        f"{[round(c['seconds'], 4) for c in calls]}) [{card}]")
    log(f"  {label}: step budget {g._step_budget}, _max_steps({k}) "
        f"{g._max_steps(k)}; beam_cap {beam_cap}, E {ew}, R {r}, sub-batch "
        f"{g._sub_batch()} queries, visited "
        f"{'hash 2^%d slots' % hash_bits if hash_bits else 'dense'} "
        f"({visited_bytes / 2**30:.4f} GiB for the {q} queries)")
    log(f"  {label}: captures per search call (warm, then timed) "
        f"{captures}, {searches.captures - sum(captures)} in the build's "
        f"step budget; the timed calls replayed the kept graph without a "
        f"capture: {replayed}; kept graphs hold {kept / 2**30:.4f} GiB "
        f"after them (at most {beam.KEPT_BYTES_PER_DEVICE / 2**30:g}; after "
        f"each call {[c['kept_bytes'] for c in calls]} B) [{card}]")
    if not replayed:
        log(f"  {label}: the kept entry of a {q}-query call does not stay "
            f"within the budget: every call pays a capture")
    if case.recall_at_10 < GRAPH_MIN_RECALL or not np.isfinite(case.adr):
        fail(f"{label}: recall@10 {case.recall_at_10} < {GRAPH_MIN_RECALL} "
             f"or ADR {case.adr}")
    gap = jax_case.get("recall_at_10", 0) - case.recall_at_10
    if gap > RECORD_GAP:
        log(f"  {label}: recall@10 {gap:.4f} below the JAX record, more "
            f"than {RECORD_GAP}: a possible fault of the port against the "
            f"reference")

    # the four beam kernels against the plain step at the record's shape
    q_dev = torch.from_numpy(queries).cuda()
    clocks = {route: SegmentClock(c) for route, c in SEGMENT_SLEEP.items()}
    t0 = time.perf_counter()
    res, counts = beam_equal_drive("12g", index_beam_start(g, q_dev, k),
                                   g._max_steps(k), card, clocks)
    equal_s = time.perf_counter() - t0
    del q_dev
    never_done = 0 if res["finished"] else counts[-1][1]
    mean_steps = sum(q - d for d, _, _ in counts) / q
    median, mean = segment_times(clocks)
    step_bytes = beam_step_bytes(g, k, q, counts)
    prof = profile_graph_batch(
        g, queries, p50_ms / 1e3, card, k=k,
        label=f"  [12g] profile of one warm {name} graph batch")
    log(f"  {label}: steps per query mean {mean_steps:.2f}, max "
        f"{res['steps']} ({never_done} queries still searching at the "
        f"budget); the search's loop ran {prof['steps']} steps (chunks of "
        f"{beam.DONE_CHECK_EVERY}); the step-by-step comparison took "
        f"{equal_s:.1f} s with the spins of its segment clocks [{card}]")
    log_segment_times(f"{label} ", median, mean, len(counts), card)
    variants = dict(pop="warp", expand=plan.expand.variant,
                    merge=plan.merge.variant, gamma="warp")
    rows = {kern: dict(beam_kernel_row(
        f"{kern} at the record's shape ({variants[seg]})", seg,
        step_bytes[kern], median, mean, prof["beam"][kern], len(counts),
        card), variant=variants[seg], max_abs_err=res["max_abs_err"])
        for kern, seg in zip(BEAM_KERNELS, ("pop", "expand", "merge",
                                            "gamma"))}
    if min(p["launches"] for p in prof["beam"].values()) <= 0:
        fail(f"{label}: the profiled batch ran no beam kernel: "
             f"{prof['beam']}")
    out = dict(
        build_s=case.build_time_s, build_stages_s=case.build_stages_s,
        build_peak_gib=spy.peak_gib, recall_at_1=case.recall_at_1,
        recall_at_10=case.recall_at_10, recall_at_100=case.recall_at_100,
        adr=case.adr, jax_recall_at_1=jax_case.get("recall_at_1"),
        jax_recall_at_10=jax_case.get("recall_at_10"),
        jax_recall_at_100=jax_case.get("recall_at_100"),
        jax_adr=jax_case.get("adr"), qps=case.qps, p50_ms=p50_ms,
        call_seconds=[c["seconds"] for c in calls],
        step_budget=g._step_budget, max_steps=g._max_steps(k),
        loop_steps=prof["steps"], mean_steps=mean_steps,
        max_query_steps=res["steps"], never_done=never_done,
        captures=captures, replayed=replayed, kept_bytes=kept,
        visited_bytes=visited_bytes, sub_batch=g._sub_batch(),
        equal=res, equal_s=equal_s,
        step_ms={route: sum(m.values()) for route, m in median.items()},
        segment_ms_per_step=median, device_busy_ms=prof["busy_ms"],
        device_ops_per_step=prof["device_ops_per_step"])
    return out, launches, rows


def main():
    t_start = time.perf_counter()
    # 1. environment
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this drive needs a GPU")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    card = smi.strip()
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}")
    log(f"  nvidia-smi: {card}")
    log("  nvcc: " + run([scan_keys._nvcc(), "--version"]).splitlines()[-1])
    try:
        import triton
        log(f"  triton {triton.__version__} imports")
    except ImportError as exc:
        log(f"  triton does not import: {exc}")

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(m.build_library) for m in (scan_keys, beam_step)]
    (path, build_s), (beam_path, beam_build_s) = [j.result() for j in jobs]
    log(f"[2] built {Path(path).name} in {build_s:.2f} s and "
        f"{Path(beam_path).name} in {beam_build_s:.2f} s, "
        f"{time.perf_counter() - t0:.2f} s in all (0 = already built from "
        f"this source); dynamic shared memory per block at P = 128: "
        f"{scan_keys.load_library().scan_keys_smem_bytes(128)} bytes")
    ptxas = ptxas_report(path)
    beam_ptxas = ptxas_report(beam_path)
    beam_step.load_library()
    fma = fma_drive(card)

    # 3. kernel vs plain version at the main path's shapes
    data = make_synthetic(f"synthetic-{N_MAIN // 1000}k-{DIM}d",
                          n_queries=N_QUERIES,
                          gt_k=K, n_clusters=256, seed=0, gt_device="cuda",
                          cache_dir=None)
    if "base_dev_factory" not in data:
        fail("the 1M store was not drawn on the card")
    log(f"[3] data: base {data['base'].shape}, queries "
        f"{data['queries'].shape}, drawn on the card from the Threefry "
        f"stream, ground truth on the card, "
        f"{time.perf_counter() - t_start:.1f} s since start")
    n_pad = scan.store_pad(N_MAIN)
    raw, norm_sq = scan.pad_store_and_norms(
        torch.from_numpy(data["base"]).cuda(), n_pad, DIM)
    qpad = torch.from_numpy(
        data["queries"][:SUB_BATCH].astype(np.float16)).cuda().float()
    bins, groups, rows_kpad = scan_keys.fused_bin_plan(n_pad, 512)
    results = []
    sketch = scan.make_rerank_sketch(raw, norm_sq, force_int8=True)
    codes, aux = scan.sketch_store_operands(sketch, N_MAIN, rows_kpad)
    sketch_ops = [codes, aux, *scan.sketch_query(qpad, sketch.scale)]
    check_kernel("sketch", sketch_ops, bins, card, results)
    # 64- and 256-query tail batches: the group axis split over the card
    # (4 and 2 ways on 132 SMs), merged
    for q in (64, 256):
        check_kernel(f"sketch-q{q}", [codes, aux] + [t[:q] for t in
                                                      sketch_ops[2:]],
                     bins, card, results, yardstick=False)
    del sketch, codes, aux, sketch_ops
    signs = hadamard.rotation_signs(hadamard.DEFAULT_ROTATION_SEED,
                                    DIM).cuda()
    for bits in (1, 2, 4):
        ops = estimate_operands(raw, N_MAIN, bits, signs, qpad, bins,
                                rows_kpad)
        check_kernel(f"estimate-{bits}bit", ops, bins, card, results)
        del ops
    del raw
    torch.cuda.empty_cache()

    # 4. main drive
    log("[4] main drive: CPIndex(128, bits=1) on 1M x 128d")
    scan_keys.launches = 0
    idx, ids = drive("1M x 128d 1-bit", data, 1, card)
    launches = scan_keys.launches
    per_batch = launches / (TIMED_RUNS + 1)
    log(f"  scan_keys launches in the main drive: {launches} over "
        f"{TIMED_RUNS + 1} batches ({per_batch:g} per {N_QUERIES}-query "
        f"batch of {SUB_BATCH}-query sub-batches)")
    if launches <= 0:
        fail("the main drive never launched the scan_keys kernel")
    split = stage_split(idx._index, data["queries"], card)

    small = make_synthetic(f"synthetic-{N_SMALL // 1000}k-{DIM}d",
                           n_queries=N_QUERIES,
                           gt_k=K, n_clusters=256, seed=0, gt_device="cuda",
                           cache_dir=None)
    drive("100k x 128d 4-bit", small, 4, card)

    # 5. save -> load round trip
    with tempfile.TemporaryDirectory() as tmp:
        f = Path(tmp) / "index.npz"
        t0 = time.perf_counter()
        idx.save(str(f))
        fresh = CPIndex(DIM, bits=1, device="cuda")
        fresh.load(str(f))
        ids2, _ = fresh.search_batch(data["queries"], k=K)
        log(f"[5] save -> load -> search: {time.perf_counter() - t0:.1f} s, "
            f"file {f.stat().st_size / 2**20:.1f} MiB")
    if not np.array_equal(ids, ids2):
        fail("ids after save -> load differ")
    del fresh
    torch.cuda.empty_cache()

    # 5a-5e. the JAX package's other selections on the main index, its
    # Threefry data recipe, the brute-force index
    log("[5a-f] chunked and exact selection, bf16 two-stage rerank on the "
        "main index; Threefry recipe; BruteForceIndex; the data cache")
    phases = selection_drives(idx._index, data, ids, card)
    del idx
    torch.cuda.empty_cache()
    phases["threefry"] = threefry_drive(card)
    phases["brute_force"] = brute_force_drive(small, card)
    phases["data_cache"] = cache_drive(card)
    torch.cuda.empty_cache()

    # 6. graph main drive
    lib = native.load()
    log(f"[6] graph drive: CPIndex(128, bits=1, engine='graph') on 1M x "
        f"128d; host ops "
        f"{'native C library loaded' if lib is not None else 'numpy fallback (no C library)'}")
    scan_keys.launches = 0
    zero_beam_launches()
    gidx, gq, _, gp50 = graph_drive("graph 1M x 128d 1-bit", data, 1, card)
    graph_launches = scan_keys.launches
    beam_by_path = dict(graph=beam_path_launches(
        "1M graph", beam_launches(), beam_variant_launches()))
    log(f"  scan_keys launches in the graph drive: {graph_launches}")
    phases["nndescent"] = nndescent_drive(card)

    # 7. graph N-bit drive + save -> load
    log("[7] graph drive: CPIndex(128, bits=4, engine='graph') on 100k x 128d")
    scan_keys.launches = 0
    zero_beam_launches()
    sidx, sq, sids, _ = graph_drive("graph 100k x 128d 4-bit", small, 4,
                                    card)
    beam_by_path["graph_4bit"] = beam_path_launches(
        "100k 4-bit graph", beam_launches(), beam_variant_launches())
    log(f"  scan_keys launches in the graph drive: {scan_keys.launches}")
    phases["beam_kernels_4bit"], _ = beam_equal_drive(
        "7", index_beam_start(sidx._index, torch.from_numpy(sq).cuda(), K),
        sidx._index._max_steps(K), card)
    with tempfile.TemporaryDirectory() as tmp:
        f = Path(tmp) / "graph.npz"
        t0 = time.perf_counter()
        sidx.save(str(f))
        fresh = CPIndex(DIM, bits=4, device="cuda")
        fresh.load(str(f))
        sids2, _ = fresh.search_batch(sq, k=K)
        log(f"  save -> load -> search: {time.perf_counter() - t0:.1f} s, "
            f"file {f.stat().st_size / 2**20:.1f} MiB, engine "
            f"{fresh.engine}")
    if fresh.engine != "graph" or not np.array_equal(sids, sids2):
        fail("graph ids after save -> load differ")
    beam_by_path["rerank8"], phases["rerank_width"] = rerank_width_drive(
        sidx._index, sq, card)
    del sidx, fresh

    # 8. profile of the 1M graph batch; 8b. its graphed beam against eager
    prof = profile_graph_batch(gidx._index, gq, gp50, card)
    phases["beam_graph"] = beam_graph_drive(gidx._index, gq, card)
    beam_kernels, phases["beam_kernels"] = beam_kernel_drive(
        gidx._index, gq, card, prof)
    del gidx
    torch.cuda.empty_cache()

    # 9. sharded scan: 4 shards on a (1, 4) mesh
    count = torch.cuda.device_count()
    mesh = sharded.make_mesh(1, N_SHARDS, [torch.device("cuda", i % count)
                                           for i in range(N_SHARDS)])
    log(f"[9] sharded scan: ShardedScanIndex(128, bits=1) on 1M x 128d over "
        f"mesh {mesh.shape} of {[str(d) for d in mesh.devices.flat]}")
    sidx, s_ids, s_top_c, s_launches, s_per_batch = sharded_scan_drive(
        data, mesh, card)
    ops, s_bins, _, _ = shard_operands(sidx, data["queries"], s_top_c)
    check_kernel("estimate-shard", ops, s_bins, card, results)
    del ops
    s_split = sharded_stage_split(sidx, data["queries"], s_top_c, card)
    phases["sharded_chunked"] = sharded_chunked_drive(sidx, data, mesh,
                                                      s_ids, card)
    phases["jax_form_sharded_scan"] = jax_form_scan_drive(sidx, data, mesh,
                                                          card)
    sharded_scan_round_trip(sidx, s_ids, mesh, data["queries"],
                            data["groundtruth"])
    del sidx
    torch.cuda.empty_cache()

    # 10. sharded graph on the same mesh, then a 4-bit save -> load
    log(f"[10] sharded graph: ShardedIndex(128, bits=1, r=32) on 1M x 128d "
        f"over mesh {mesh.shape}")
    scan_keys.launches = 0
    zero_beam_launches()
    gsh, gq, _ = sharded_graph_drive("sharded graph 1M x 128d 1-bit", data,
                                     1, mesh, card)
    g_launches = scan_keys.launches
    beam_by_path["sharded_graph"] = beam_path_launches(
        "1M sharded graph", beam_launches(), beam_variant_launches())
    log(f"  scan_keys launches in the sharded graph drive: {g_launches}")
    phases["beam_kernels_shard"], _ = beam_equal_drive(
        "10", shard_beam_start(gsh, gq, K), gsh._max_steps(K), card)
    phases["jax_form_sharded_graph"] = jax_form_graph_drive(gsh, gq, mesh,
                                                            card)
    del gsh
    torch.cuda.empty_cache()
    gsh4, gq4, gids4 = sharded_graph_drive(
        "sharded graph 100k x 128d 4-bit", small, 4, mesh, card)
    with tempfile.TemporaryDirectory() as tmp:
        f = Path(tmp) / "sharded_graph.npz"
        t0 = time.perf_counter()
        gsh4.save(f)
        fresh = sharded.ShardedIndex(DIM, bits=4, r=32).load(f, mesh)
        gids4b, _ = fresh.search_batch(gq4, k=K)
        log(f"  save -> load -> search: {time.perf_counter() - t0:.1f} s, "
            f"file {f.stat().st_size / 2**20:.1f} MiB, ids equal "
            f"{np.array_equal(gids4, gids4b)}")
    if not np.array_equal(gids4, gids4b):
        fail("sharded graph ids after save -> load differ")
    phases["sharded_n_seeds"] = sharded_seeds_drive(gsh4, gq4, small["base"],
                                                    mesh, card)
    del gsh4, fresh
    torch.cuda.empty_cache()

    # 11. the CLI as a user runs it
    log(f"[11] CLI: python -m cphnsw_tpu_torch --bits 1 --device cuda on "
        f"{CLI_DATASET}")
    cli_drive(card)

    # 12. the JAX package's recorded workloads: the scan ones, and (12g)
    # each graph record on the data its scan workload drew
    log(f"[12] the JAX package's recorded workloads, "
        f"{time.perf_counter() - t_start:.1f} s since start")
    workloads, graph_records, record_rows = {}, {}, {}
    for name, ks, bits_list in WORKLOADS:
        t0 = time.perf_counter()
        data = workload_data(name)
        workloads[name] = workload_drive(name, ks, bits_list, card, results,
                                         data)
        log(f"  {name}: phase 12 drive {time.perf_counter() - t0:.1f} s")
        for g_name, g_k, g_bits in GRAPH_WORKLOADS:
            if g_name != name:
                continue
            t0 = time.perf_counter()
            (graph_records[name], beam_by_path[f"graph_record {name}"],
             record_rows[name]) = graph_workload_drive(name, g_k, g_bits,
                                                       data, card)
            log(f"  {name}: phase 12g drive {time.perf_counter() - t0:.1f} "
                f"s")
        del data
        torch.cuda.empty_cache()

    sk = results[0]
    kernels = [dict(
        name="scan_keys", route="cuda",
        source="cphnsw_tpu_torch/csrc/scan_keys.cu",
        replaces="cphnsw_tpu/search/scan.py:305",
        launches=launches,
        launches_by_path=dict(
            main=launches, sharded_scan=s_launches, graph=graph_launches,
            sharded_graph=g_launches,
            workloads={f"{name} {b}": w["launches"]
                       for name, cases in workloads.items()
                       for b, w in cases.items()}),
        launches_per_batch=dict(main=per_batch, sharded_scan=s_per_batch),
        max_abs_err=max(r["max_abs_err"] for r in results),
        ms=sk["ms"], plain_ms=sk["plain_ms"], bound_ms=sk["bound_ms"],
        bound_by=sk["bound_by"], library_ms=None,
        roofline_share=sk["roofline_share"], int_mm_ms=sk["int_mm_ms"],
        modes={r["mode"]: {k: v for k, v in r.items() if k != "mode"}
               for r in results},
        build_s=build_s, ptxas=ptxas,
        search_stage_ms=split,
        sharded_scan_stage_ms=s_split,
        sharded_scan_launches_per_batch=s_per_batch,
    )]
    for entry in beam_kernels:
        name = entry["name"]
        kernels.append(dict(
            entry, launches=beam_by_path["graph"][name],
            launches_by_path={path: n[name]
                              for path, n in beam_by_path.items()},
            **({"launches_by_variant": {
                path: n["variants"][name]
                for path, n in beam_by_path.items()}}
               if name in beam_by_path["graph"]["variants"] else {}),
            graph_record={rec: rows[name]
                          for rec, rows in record_rows.items()},
            build_s=beam_build_s,
            ptxas=[r for r in beam_ptxas
                   if r["kernel"].startswith(name + "_")]))
    phases["fma_f32"] = fma
    log(f"phases 2 (fma_f32), 5a-5f, 6b, 7, 7f, 8b, 8c, 9c, 9d, 10, 10b, "
        f"10c: "
        f"{json.dumps(phases)}")
    log(f"phase 12: {json.dumps(workloads)}")
    log(f"phase 12g: {json.dumps(graph_records)}")
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
