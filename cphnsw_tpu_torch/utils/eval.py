"""Benchmark evaluation harness: metrics and the results JSON.

PyTorch counterpart of ``cphnsw_tpu/utils/eval.py``.  The metric
definitions and the results-JSON schema (``CaseResult``'s field names) are
the JAX package's, which keeps the reference harness's: recall@k over the
first k ids, ADR (average distance ratio at k = 10), QPS as the median of
n_runs timed full-batch passes after one untimed warm pass, median
per-query latency, wall-clock build time and the RSS memory delta.

Optional tracing: pass profile_dir (or set CPHNSW_PROFILE_DIR) to write a
``torch.profiler`` Chrome trace of one extra search pass, taken before the
timed passes so the trace overhead never enters the QPS.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import time
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np
import torch

from cphnsw_tpu_torch.utils.datasets import DEVICE_DATA_MIN_ELEMENTS

DEFAULT_BITS = (1, 2, 4)
ADR_AT = 10


@dataclass
class CaseResult:
    """One (dataset, bit-width) measurement: field names are the schema."""

    algorithm: str
    engine: str
    build_time_s: float
    memory_mb: float
    recall_at_1: float
    recall_at_10: float
    recall_at_100: float
    adr: float
    qps: float
    median_latency_us: float
    build_stages_s: dict | None = None
    # the derived search budget the case ran with: scan engine -> top_c at
    # the evaluated k and the anchor table; graph engine -> step budget
    search_budget: dict | None = None


def recall_at_k(found: np.ndarray, truth: np.ndarray, k: int) -> float:
    """Fraction of the true top-k present in the returned top-k
    (intersection size / k, averaged over queries)."""
    k = min(k, found.shape[1], truth.shape[1])
    overlap = (found[:, :k, None] == truth[:, None, :k]).any(axis=2)
    return float(overlap.mean())


def average_distance_ratio(
    base: np.ndarray, queries: np.ndarray, found: np.ndarray,
    truth: np.ndarray, k: int, metric: str = "l2",
) -> float:
    """Mean over (query, rank<=k) of d(q, found_i) / d(q, true_i); missing
    results (-1 ids) count as infinitely bad.  For metric='ip' the ratio
    is score(true)/score(found) (so 1.0 is perfect, larger is worse,
    matching the L2 orientation)."""
    k = min(k, found.shape[1], truth.shape[1])

    def sq_dists(ids):
        vecs = base[np.maximum(ids[:, :k], 0)]
        if metric == "ip":
            d = (vecs * queries[:, None, :]).sum(axis=2)
            return np.where(ids[:, :k] >= 0, d, -np.inf)
        d = ((vecs - queries[:, None, :]) ** 2).sum(axis=2)
        return np.where(ids[:, :k] >= 0, d, np.inf)

    if metric == "ip":
        # inner-product scores can be <= 0, where a clamped ratio would
        # report ~1.0 (perfect) for arbitrarily bad results.  Shift both
        # sides by a common positive offset derived from the observed score
        # range so the ratio stays orientation-correct (1.0 = perfect, > 1
        # worse) for any sign of the scores; missing (-inf) found scores
        # still blow the ratio up as intended.
        num = sq_dists(truth)
        den = sq_dists(found)
        lo = min(num.min(), den[np.isfinite(den)].min(initial=np.inf))
        span = num.max() - lo
        offset = -lo + max(span, 1.0) * 1e-3
        num = num + offset
        den = np.maximum(den + offset, np.finfo(np.float64).tiny)
        return float(np.mean(num / den))
    denom = np.maximum(sq_dists(truth), np.finfo(np.float64).tiny)
    return float(np.mean(sq_dists(found) / denom))


def resident_mb() -> float:
    """Process RSS in MB (psutil if present, /proc otherwise)."""
    try:
        import psutil

        return psutil.Process().memory_info().rss / 2**20
    except ImportError:
        pass
    try:
        with open("/proc/self/status") as fh:
            for ln in fh:
                if ln.startswith("VmRSS"):
                    return float(ln.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


@contextlib.contextmanager
def _profile(target, device: torch.device):
    """torch.profiler over the body; writes <target>/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(target)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


def _timed_passes(search, queries, n_runs, profile_dir=None,
                  device=torch.device("cpu")):
    """One untimed warm pass, then n_runs timed passes; returns (ids from
    the first timed pass, per-pass seconds).  Each pass ends on the host
    copy of its results, so it includes all device work.  A profiled pass,
    when asked for, runs separately before the timed ones."""
    search(queries)
    target = profile_dir or os.environ.get("CPHNSW_PROFILE_DIR")
    if target:
        with _profile(target, device):
            search(queries)
    seconds, first_ids = [], None
    for _ in range(max(n_runs, 1)):
        begin = time.perf_counter()
        ids = search(queries)
        seconds.append(time.perf_counter() - begin)
        if first_ids is None:
            first_ids = ids
    return first_ids, seconds


def bench_one_case(
    base, queries, truth, *, dim, bits, k, n_runs, profile_dir=None,
    engine="auto", metric="l2", base_dev_factory=None, device="cuda",
) -> CaseResult:
    """Build, finalize and time one CPIndex on `device`.
    base_dev_factory, if given, returns the store as a tensor on the
    device; the scan engine builds from it (skipping the host staging)."""
    from cphnsw_tpu_torch.api.index import CPIndex

    gc.collect()
    rss_at_start = resident_mb()
    build_begin = time.perf_counter()
    index = CPIndex(dim=dim, bits=bits, engine=engine, metric=metric,
                    device=device)
    dev = index._device
    if base_dev_factory is not None and engine != "graph":
        base_dev = base_dev_factory()
        stage_mark = time.perf_counter()
        index.build(base_dev)
        del base_dev
    else:
        stage_mark = time.perf_counter()
        index.build(base)
    stage_seconds = time.perf_counter() - stage_mark
    synth_seconds = stage_mark - build_begin  # device copy of the store
    index.finalize()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_seconds = time.perf_counter() - build_begin
    gc.collect()
    footprint = resident_mb() - rss_at_start

    def search(batch):
        return index.search_batch(batch, k=k)[0]

    ids, seconds = _timed_passes(search, queries, n_runs, profile_dir, dev)
    median_s = float(np.median(seconds))

    return CaseResult(
        algorithm=f"cphnsw-tpu-{bits}bit",
        engine=index.engine,
        build_time_s=round(build_seconds, 2),
        memory_mb=round(footprint, 1),
        recall_at_1=round(recall_at_k(ids, truth, 1), 4),
        recall_at_10=round(recall_at_k(ids, truth, min(k, 10)), 4),
        recall_at_100=round(recall_at_k(ids, truth, min(k, 100)), 4),
        adr=round(average_distance_ratio(
            base, queries, ids, truth, min(k, ADR_AT), metric=metric), 6),
        qps=round(len(queries) / median_s, 1),
        median_latency_us=round(median_s / len(queries) * 1e6, 2),
        build_stages_s=_full_build_stages(
            index, synth_seconds, stage_seconds, build_seconds),
        search_budget=_search_budget(index, k),
    )


def _full_build_stages(index, synth_s, stage_s, total_s) -> dict:
    """Whole-build stage table: the device copy of the store, build()
    staging, every finalize stage and the residual, so the stage sum
    reconciles with build_time_s."""
    stages = {"device_synthesis": round(synth_s, 2),
              "stage_vectors": round(stage_s, 2)}
    inner = getattr(index, "_index", index)
    stages.update(getattr(inner, "build_stages", None) or {})
    accounted = sum(stages.values())
    stages["unattributed"] = round(max(total_s - accounted, 0.0), 2)
    return stages


def _search_budget(index, k: int) -> dict | None:
    """The derived search budget the case actually ran with."""
    inner = getattr(index, "_index", index)
    budget = getattr(inner, "_budget", None)
    if budget is not None:  # scan engine: candidate budget
        n = inner.size
        return {
            "top_c_at_k": int(budget.top_c(min(k, n), n)),
            "anchors": budget.anchors.tolist(),
            "ranks": budget.ranks.tolist(),
        }
    sb = getattr(inner, "_step_budget", None)
    if sb:  # graph engine: beam step budget
        return {"step_budget": {str(a): int(v) for a, v in sb.items()}}
    return None


def run_benchmark(
    dataset_name: str,
    base_dir: Path,
    k: int,
    n_runs: int,
    output_dir: Path,
    bit_widths=None,
    profile_dir=None,
    engine="auto",
    device="cuda",
) -> dict:
    """Benchmark every bit width on one dataset on `device`; writes
    <output_dir>/<dataset>_results.json (suffixed _<engine> when the
    engine is forced) and returns its contents.  Synthetic stores of at
    least DEVICE_DATA_MIN_ELEMENTS on a CUDA device are drawn on the device
    from JAX's Threefry stream, get their ground truth there and build
    from a device tensor; on the CPU they take the host recipe
    (``make_synthetic``)."""
    from cphnsw_tpu_torch.api.scan_index import resolve_device
    from cphnsw_tpu_torch.utils.datasets import load_dataset, synthetic_shape

    dev = resolve_device(device)
    large = False
    if dataset_name.startswith("synthetic"):
        n, dim, _ = synthetic_shape(dataset_name)
        large = n * dim >= DEVICE_DATA_MIN_ELEMENTS
    # a large synthetic store is drawn on the benchmark's device: the card,
    # or the host recipe when the benchmark runs on the CPU
    ds = load_dataset(dataset_name, base_dir=base_dir,
                      gt_device=dev if large else None)
    truth = ds["groundtruth"].astype(np.int64)
    metric = ds.get("metric", "l2")

    cases = [
        bench_one_case(
            ds["base"], ds["queries"], truth,
            dim=ds["dim"], bits=bits, k=k, n_runs=n_runs,
            profile_dir=profile_dir, engine=engine, metric=metric,
            base_dev_factory=ds.get("base_dev_factory"), device=dev,
        )
        for bits in (bit_widths or DEFAULT_BITS)
    ]

    report = {
        "metadata": {
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "dataset": dataset_name,
            "n_base": len(ds["base"]),
            "n_queries": len(ds["queries"]),
            "dim": ds["dim"],
            "metric": metric,
            "k": k,
            "n_runs": n_runs,
            "package": "cphnsw_tpu_torch",
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
        },
        "results": [asdict(c) for c in cases],
    }

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    suffix = "" if engine == "auto" else f"_{engine}"
    (out / f"{dataset_name}{suffix}_results.json").write_text(
        json.dumps(report, indent=2))
    return report
