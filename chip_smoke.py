"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:
  1. environment: a CUDA device, the toolchain (torch, CUDA, nvcc, triton);
  2. build: compile csrc/scan_keys.cu with nvcc from the checkout;
  3. the scan_keys kernel against its plain PyTorch version at the main
     path's shapes (1M x 128d store, Q = 2048, bins = 1024): sketch mode
     and estimate mode at bits 1/2/4; keys must be bit-equal;
  4. the main drive: CPIndex(128, bits=1) on 1M x 128d synthetic data
     (seed 0, 256 clusters, 8192 queries, ground truth on the card),
     build + finalize, one warm and 5 timed search_batch(k=10), recall@10
     >= 0.99 through the kernel; then a 100k x 128d 4-bit drive;
  5. save -> load round trip into a fresh CPIndex: equal ids;
  6. the graph drive: CPIndex(128, bits=1, engine="graph") on the same 1M x
     128d data, build + finalize (seconds per stage), one warm and 5 timed
     search_batch(k=10) on the first 1024 queries, recall@10 >= 0.90, the
     beam steps and ms per step (CUDA events);
  7. a 100k x 128d 4-bit graph drive (the MSB two-stage bound), recall@10
     >= 0.90, then save -> load into a fresh CPIndex: equal ids;
  8. torch.profiler over one warm 1M graph batch: device-busy share, the
     five kernels with the most device time, launches per beam step.
The graph path has no hand-written kernel (the JAX package's Pallas
beam-step kernel was retired before the port); its device work is torch
ops.  The last lines are the kernels' JSON, the card's name and power
limit as nvidia-smi reports them, and the result JSON.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from cphnsw_tpu_torch import CPIndex
from cphnsw_tpu_torch.kernels import scan_keys
from cphnsw_tpu_torch.ops import hadamard, quantize
from cphnsw_tpu_torch.search import scan
from cphnsw_tpu_torch.utils import native
from cphnsw_tpu_torch.utils.datasets import make_synthetic
from cphnsw_tpu_torch.utils.eval import recall_at_k

N_MAIN, N_SMALL, DIM, N_QUERIES, K = 1_000_000, 100_000, 128, 8192, 10
SUB_BATCH = 2048
TIMED_RUNS = 5
MIN_RECALL = 0.99
# Graph drives: the lockstep beam's per-query cost does not depend on the
# batch size, so 1024 queries measure it.
GRAPH_QUERIES = 1024
GRAPH_MIN_RECALL = 0.90


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


def check_kernel(name, operands, bins, card, results):
    """Kernel vs plain version on the same device tensors: bit-equal keys,
    and both median times."""
    got = scan_keys.fused_scan_keys(*operands, bins)
    want = scan_keys.scan_keys_reference(*operands, bins)
    torch.cuda.synchronize()
    equal = (got == want).double().mean().item()
    max_err = (got.long() - want.long()).abs().max().item()
    ms = median_ms(lambda: scan_keys.fused_scan_keys(*operands, bins))
    plain_ms = median_ms(
        lambda: scan_keys.scan_keys_reference(*operands, bins))
    log(f"  {name}: rows={operands[0].shape[0]} P={operands[0].shape[1]} "
        f"Q={operands[2].shape[0]} bins={bins} keys_equal={equal} "
        f"max_abs_err={max_err} kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"[{card}]")
    if equal != 1.0:
        fail(f"{name}: kernel keys differ from the plain version "
             f"(equal fraction {equal})")
    results.append(dict(mode=name, ms=ms, plain_ms=plain_ms,
                        max_abs_err=max_err))


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


def stage_split(index, queries, card):
    """Median ms of each search stage on one sub-batch, measured with CUDA
    events around the stages of scan_search's sketch branch."""
    arrays, sketch, n = index._arrays, index._rerank_sketch(), index.size
    n_pad, p = arrays.raw.shape
    surv = scan._rerank_survivors(K, index._budget.top_c(K, n))
    bins, _, rows_kpad = scan_keys.fused_bin_plan(n_pad, surv)
    q16 = queries[:SUB_BATCH].astype(np.float16)
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
        scan._rerank(arrays.raw, arrays.norm_sq, qpad, qnorm, cand, n, K)
        ev[6].record()
        torch.cuda.synchronize()
        if it:
            for i, name in enumerate(names):
                samples[name].append(ev[i].elapsed_time(ev[i + 1]))
    split = {k: round(statistics.median(v), 4) for k, v in samples.items()}
    log(f"  stage split, ms per {SUB_BATCH}-query sub-batch: "
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


def graph_drive(name, data, bits, card):
    """Graph engine: build + finalize + warm + timed searches on the first
    GRAPH_QUERIES queries; returns (index, queries, ids)."""
    idx = CPIndex(DIM, bits=bits, engine="graph", device="cuda")
    t0 = time.perf_counter()
    idx.build(data["base"])
    idx.finalize()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    g = idx._index
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
    recall = recall_at_k(ids, data["groundtruth"][:GRAPH_QUERIES], K)
    log(f"  {name}: recall@{K}={recall:.4f} QPS={len(queries) / p50:.1f} "
        f"p50 batch latency {p50 * 1e3:.2f} ms (Q={len(queries)}, "
        f"batches {[round(x * 1e3, 2) for x in lat]} ms) [{card}]")
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


def beam_steps(g, queries):
    """(loop steps, ms per step) of one beam search over `queries`, timed
    with CUDA events."""
    q_dev = torch.from_numpy(queries).cuda()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _, _, state = g._beam(q_dev, g._entry_candidates, K, g._max_steps(K),
                          debug_state=True)
    end.record()
    torch.cuda.synchronize()
    return state.steps, start.elapsed_time(end) / max(state.steps, 1)


def profile_graph_batch(g, queries, p50, card):
    """torch.profiler over one warm search_batch: device-busy time (the
    union of kernel intervals) as a share of the profiled wall time and of
    the unprofiled p50 batch latency, the five kernels with the most
    device time, kernel launches per beam step."""
    from torch.profiler import ProfilerActivity, profile

    steps, _ = beam_steps(g, queries)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        g.search_batch(queries, k=K)
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
    log(f"[8] profile of one warm 1M graph batch (Q={len(queries)}): device "
        f"busy {busy / 1e3:.2f} ms = {100 * busy / wall_us:.1f}% of the "
        f"{wall_us / 1e3:.2f} ms profiled wall, "
        f"{100 * busy / (p50 * 1e6):.1f}% of the {p50 * 1e3:.2f} ms "
        f"unprofiled p50 batch; {len(kernels)} kernel launches over {steps} "
        f"beam steps = {len(kernels) / max(steps, 1):.1f} per step [{card}]")
    for name, (us, count) in top:
        log(f"  {us / 1e3:9.3f} ms {count:6d} launches  {name[:110]}")
    if not kernels:
        log("  the profiler recorded no device kernels")


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

    # 2. build
    path, secs = scan_keys.build_library()
    log(f"[2] built {Path(path).name} in {secs:.2f} s "
        f"(0 = already built from this source)")

    # 3. kernel vs plain version at the main path's shapes
    data = make_synthetic(f"synthetic-{N_MAIN // 1000}k-{DIM}d",
                          n_queries=N_QUERIES,
                          gt_k=K, n_clusters=256, seed=0, gt_device="cuda")
    log(f"[3] data: base {data['base'].shape}, queries "
        f"{data['queries'].shape}, ground truth on the card, "
        f"{time.perf_counter() - t_start:.1f} s since start")
    n_pad = scan.store_pad(N_MAIN)
    raw, _ = scan.pad_store_and_norms(
        torch.from_numpy(data["base"]).cuda(), n_pad, DIM)
    qpad = torch.from_numpy(
        data["queries"][:SUB_BATCH].astype(np.float16)).cuda().float()
    bins, groups, rows_kpad = scan_keys.fused_bin_plan(n_pad, 512)
    results = []
    sketch = scan.make_rerank_sketch(raw)
    codes, aux = scan.sketch_store_operands(sketch, N_MAIN, rows_kpad)
    check_kernel("sketch", [codes, aux, *scan.sketch_query(
        qpad, sketch.scale)], bins, card, results)
    del sketch, codes, aux
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
    log(f"  scan_keys launches in the main drive: {launches}")
    if launches <= 0:
        fail("the main drive never launched the scan_keys kernel")
    split = stage_split(idx._index, data["queries"], card)

    small = make_synthetic(f"synthetic-{N_SMALL // 1000}k-{DIM}d",
                           n_queries=N_QUERIES,
                           gt_k=K, n_clusters=256, seed=0, gt_device="cuda")
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
    del idx, fresh
    torch.cuda.empty_cache()

    # 6. graph main drive
    lib = native.load()
    log(f"[6] graph drive: CPIndex(128, bits=1, engine='graph') on 1M x "
        f"128d; host ops "
        f"{'native C library loaded' if lib is not None else 'numpy fallback (no C library)'}")
    scan_keys.launches = 0
    gidx, gq, _, gp50 = graph_drive("graph 1M x 128d 1-bit", data, 1, card)
    log(f"  scan_keys launches in the graph drive: {scan_keys.launches} "
        f"(the graph path runs torch ops only)")

    # 7. graph N-bit drive + save -> load
    log("[7] graph drive: CPIndex(128, bits=4, engine='graph') on 100k x 128d")
    scan_keys.launches = 0
    sidx, sq, sids, _ = graph_drive("graph 100k x 128d 4-bit", small, 4,
                                    card)
    log(f"  scan_keys launches in the graph drive: {scan_keys.launches}")
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
    del sidx, fresh

    # 8. profile of the 1M graph batch
    profile_graph_batch(gidx._index, gq, gp50, card)

    sk = results[0]
    kernels = [dict(
        name="scan_keys", route="cuda",
        source="cphnsw_tpu_torch/csrc/scan_keys.cu",
        replaces="cphnsw_tpu/search/scan.py:305",
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in results),
        ms=sk["ms"], plain_ms=sk["plain_ms"],
        modes={r["mode"]: dict(ms=r["ms"], plain_ms=r["plain_ms"])
               for r in results},
        search_stage_ms=split,
    )]
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
