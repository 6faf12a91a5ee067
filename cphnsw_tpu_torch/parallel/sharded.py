"""Mesh-sharded search: database sharding + query data-parallelism.

PyTorch counterpart of ``cphnsw_tpu/parallel/sharded.py``.  The index
scales out over a (data x model) grid of devices:

  * queries split over "data"; the database (codes, graph, raw vectors)
    splits over "model" in contiguous row shards;
  * one search = per (data row, shard) a local search on that shard's
    device (the flat scan through the scan_keys kernel in estimate mode,
    or the DABS beam on the shard's own subgraph), local ids offset to
    global ones, then the per-shard top-k lists are gathered to the data
    row's first device and merged (``merge_topk``).

The JAX package runs this under ``shard_map``, which is single-controller:
one Python process drives every device of the mesh.  The port keeps that
model: one process over a grid of ``torch.device``s (``make_mesh``), not
one ``torch.distributed`` rank per shard.  A device may repeat in the
grid (several shards on one card, or on the CPU); blocks that land on the
same device are one tensor.  Every kernel runs on its shard's device: the
CUDA kernel on a CUDA device, its plain version on the CPU.

Deliberate differences from the JAX package (each held by a test):
  * each shard's query block is searched in ``derived_sub_batch`` slices,
    as ``ScanIndex.search_batch`` does, so the per-shard key planes stay
    bounded at any batch size (ids equal to one call);
  * the merge is a stable sort: ties go to the lower index, the order
    ``lax.top_k`` gives.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from cphnsw_tpu_torch.api import index as index_mod
from cphnsw_tpu_torch.api.scan_index import (
    SEARCH_SUB_BATCH, QUERY_WIRE_DTYPE, ScanIndex, _tensor, resolve_device,
    write_index)
from cphnsw_tpu_torch.calibration import calibrate as calib_mod
from cphnsw_tpu_torch.graph import build as gbuild
from cphnsw_tpu_torch.graph.build import NeighborStore
from cphnsw_tpu_torch.graph.nndescent import top_k_smallest
from cphnsw_tpu_torch.kernels.scan_keys import PAD_SCORE, derived_sub_batch
from cphnsw_tpu_torch.ops import hadamard
from cphnsw_tpu_torch.search import beam, scan

FLOAT_MAX = float(torch.finfo(torch.float32).max)
SHARDED_MAGIC = "CPHNSW-TPU-SHARDED"
SHARDED_VERSION = 1
STORE_FIELDS = ("raw", "norm_sq", "nbr_ids", "nbr_planes", "nbr_aux",
                "entry_candidates", "orig_ids")


# ------------------------------------------------------------------- mesh
class Mesh:
    """An (n_data, n_model) grid of torch devices: shard s of data row d
    lives on ``devices[d, s]``."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"data": devices.shape[0], "model": devices.shape[1]}

    def unique_devices(self) -> list[torch.device]:
        return list(dict.fromkeys(self.devices.flat))

    def synchronize(self):
        for dev in self.unique_devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def make_mesh(n_data: int, n_model: int, devices=None) -> Mesh:
    """The first n_data * n_model of `devices` (default: every CUDA
    device) as a (data, model) grid.  A device may repeat: one card can
    hold several shards (``[cuda:0] * 4``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh needs CUDA devices or an explicit "
                               "device list (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    # "cuda" names the current card: index it, as tensors' devices are
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    if len(devs) < n_data * n_model:
        raise ValueError(f"need {n_data * n_model} devices, have {len(devs)}")
    grid = np.empty((n_data, n_model), dtype=object)
    for i in range(n_data * n_model):
        grid[i // n_model, i % n_model] = devs[i]
    return Mesh(grid)


def _place(blocks: list, mesh: Mesh, fn) -> tuple:
    """Per (data row d, shard s): fn(blocks[s], mesh.devices[d, s]), made
    once per (shard, device), so one device never holds two copies of a
    shard."""
    placed = {}

    def put(s, dev):
        if (s, dev) not in placed:
            placed[(s, dev)] = fn(blocks[s], dev)
        return placed[(s, dev)]

    return tuple(tuple(put(s, mesh.devices[d, s]) for s in range(len(blocks)))
                 for d in range(mesh.shape["data"]))


def _on(tensor: torch.Tensor, mesh: Mesh) -> dict:
    """{device: tensor on it} for every device of the mesh."""
    return {dev: tensor.to(dev) for dev in mesh.unique_devices()}


def merge_topk(ids_parts: list, d_parts: list, k: int, device):
    """Cross-shard top-k: each shard's (Q, k_s) ids and distances are
    copied to `device` and concatenated shard-major (the all-gather along
    "model"); the k smallest distances win, the lower index first among
    equal ones, as ``lax.top_k`` orders them."""
    ids = torch.cat([i.to(device) for i in ids_parts], dim=1)
    dists = torch.cat([d.to(device) for d in d_parts], dim=1)
    top_d, sel = top_k_smallest(dists, k)
    return ids.gather(1, sel), top_d


def _data_blocks(queries: np.ndarray, n_data: int) -> np.ndarray:
    """Pad the batch to a multiple of the data axis by repeating its last
    query; trimmed again after the search."""
    pad = (-len(queries)) % n_data
    if pad:
        queries = np.concatenate(
            [queries, np.repeat(queries[-1:], pad, axis=0)])
    return queries


# ----------------------------------------------------------- sharded scan
class ShardedScanStore(NamedTuple):
    """Model-axis row slices of a ScanArrays store: ``shards[d][s]`` is
    shard s's ScanArrays on mesh.devices[d, s]."""

    shards: tuple

    @property
    def rows(self) -> int:
        """N_s, the padded row count of every shard."""
        return int(self.shards[0][0].raw.shape[0])


def shard_scan_arrays(arrays: scan.ScanArrays, n_shards: int) -> list:
    """Slice a single-device ScanArrays into n_shards contiguous row blocks
    (views).  Rows are padded to a multiple of n_shards * 256 so every
    shard has the same shape; the store's pad rows (node_aux row 0 =
    PAD_SCORE) land in the last shards and rank last there."""
    n_pad, p = arrays.raw.shape
    per = -(-n_pad // (n_shards * 256)) * 256
    extra = per * n_shards - n_pad
    planes, node_aux, raw, norm_sq = arrays
    if extra:
        planes = torch.nn.functional.pad(planes, (0, 0, 0, 0, 0, extra))
        node_aux = torch.nn.functional.pad(node_aux, (0, extra))
        node_aux[0, n_pad:] = PAD_SCORE
        raw = torch.nn.functional.pad(raw, (0, 0, 0, extra))
        norm_sq = torch.nn.functional.pad(norm_sq, (0, extra))
    return [scan.ScanArrays(planes=planes[s * per:(s + 1) * per],
                            node_aux=node_aux[:, s * per:(s + 1) * per],
                            raw=raw[s * per:(s + 1) * per],
                            norm_sq=norm_sq[s * per:(s + 1) * per])
            for s in range(n_shards)]


def shard_scan_store(shards: list, mesh: Mesh) -> ShardedScanStore:
    """Place shard s on every mesh.devices[d, s]."""
    return ShardedScanStore(shards=_place(
        shards, mesh, lambda a, dev: scan.ScanArrays(*(t.to(dev) for t in a))))


def sharded_scan_search(store: ShardedScanStore, queries: np.ndarray, signs,
                        affine_a: float, affine_b: float, n: int, mesh: Mesh,
                        kappa: float, k: int, top_c: int,
                        chunk: int | None = None, n_eq: int = 1, rem: int = 0,
                        fused: bool = True):
    """Global top-k over all scan shards.

    queries: (Q, dim <= P) host array with Q a multiple of the data axis;
    signs: {device: rotation signs}.  Returns (ids (Q, k) int64 global
    store rows, -1 for none, dists (Q, k) f32) on mesh.devices[0, 0].
    Each shard scans its own rows in estimate mode (no sketch), top_c
    clamped to its row count, in derived_sub_batch(N_s, top_c) query
    slices; n is the global count of genuine rows, shard s holding
    clamp(n - s*N_s, 0, N_s) of them.  fused (the default): the scan_keys
    kernel on a CUDA shard, its plain version on a CPU one.  fused=False:
    scan.scan_search's chunked selection on every shard, over the local
    chunk plan (chunk, n_eq, rem), by default scan.chunk_plan(N_s, queries
    per data block); every slice of a block uses that one plan, so a
    sliced call returns the ids of one call."""
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    n_local = store.rows
    # a shard contributes at most its own rows; the merged width
    # n_model * k_local >= k because k <= n <= n_model * n_local
    k_local = min(k, n_local)
    tc = max(min(top_c, n_local), k_local)
    sub = derived_sub_batch(n_local, tc, cap=SEARCH_SUB_BATCH)
    qd = len(queries) // n_data
    if not fused and chunk is None:
        chunk, n_eq, rem = scan.chunk_plan(n_local, qd)
    out_ids, out_d = [], []
    for d in range(n_data):
        block = torch.from_numpy(queries[d * qd:(d + 1) * qd])
        q_on = {}
        parts_i, parts_d = [], []
        for s in range(n_model):
            dev = mesh.devices[d, s]
            if dev not in q_on:
                q_on[dev] = block.to(dev)
            base = s * n_local
            n_s = max(min(n - base, n_local), 0)
            ids_l, d_l = [], []
            for start in range(0, qd, sub):
                ids_s, d_s = scan.scan_search(
                    store.shards[d][s], q_on[dev][start:start + sub],
                    signs[dev], affine_a, affine_b, n_s, kappa=kappa,
                    k=k_local, top_c=tc, chunk=chunk, n_eq=n_eq, rem=rem,
                    fused=fused)
                ids_l.append(ids_s)
                d_l.append(d_s)
            ids_s = torch.cat(ids_l)
            parts_i.append(torch.where(ids_s >= 0, ids_s + base, -1))
            parts_d.append(torch.cat(d_l))
        ids, dists = merge_topk(parts_i, parts_d, k, mesh.devices[d, 0])
        out_ids.append(torch.where(dists < FLOAT_MAX, ids, -1))
        out_d.append(dists)
    home = mesh.devices[0, 0]
    return (torch.cat([i.to(home) for i in out_ids]),
            torch.cat([x.to(home) for x in out_d]))


def _shard_per_rows(n: int, n_shards: int) -> int:
    """Per-shard padded row count: ceil(n / S) rounded up to 256."""
    return -(-(-(-n // n_shards)) // 256) * 256


def _derive_sharded_scan_budget(shard_arrays: list, shard_n: list, per: int,
                                n: int, signs: dict, affine_a: float,
                                affine_b: float, kappa: float, seed: int,
                                n_queries: int = 256) -> scan.CandidateBudget:
    """derive_candidate_budget decomposed over shards: every device step
    runs on one shard's arrays, on that shard's device.

    Phase A: per-shard exact top-k of the sample queries, merged on the
    host to the global true top-k.  Phase B: each true neighbour's
    estimate score, computed on its home shard (scan.est_scores_of).
    Phase C: per-shard counts of rows scoring <= each true neighbour
    (scan.count_leq), summed across shards = global estimate ranks.  The
    rank-quantile -> top_c math is the single-device one."""
    rng = np.random.default_rng(seed)
    m = int(min(n_queries, n))
    ids = rng.choice(n, size=m, replace=False)
    p = int(shard_arrays[0].raw.shape[1])
    db_rows = np.empty((m, p), np.float32)
    for s, arrays in enumerate(shard_arrays):
        sel = (ids // per) == s
        if sel.any():
            loc = torch.from_numpy(ids[sel] - s * per).to(arrays.raw.device)
            db_rows[sel] = arrays.raw[loc].cpu().numpy()

    def on(arrays, x):
        # float64 host values (numpy's noise arithmetic) go to the device
        # as f32, as the JAX package's device transfer casts them
        if x.dtype == np.float64:
            x = x.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(x)).to(arrays.raw.device)

    def global_topk(queries_np: np.ndarray, k: int):
        """Host merge of per-shard exact top-k -> (m, k) global ids+d."""
        parts_i, parts_d = [], []
        for s, arrays in enumerate(shard_arrays):
            k_loc = min(k, max(int(shard_n[s]), 1))
            q = on(arrays, queries_np)
            ids_s, d_s = scan._true_topk_chunked(
                arrays.raw, arrays.norm_sq, q, (q * q).sum(dim=-1),
                int(shard_n[s]), k_loc)
            parts_i.append(ids_s.cpu().numpy() + s * per)
            parts_d.append(d_s.cpu().numpy())
        cat_i = np.concatenate(parts_i, axis=1)
        cat_d = np.concatenate(parts_d, axis=1)
        order = np.argsort(cat_d, axis=1)[:, :k]
        return (np.take_along_axis(cat_i, order, axis=1),
                np.take_along_axis(cat_d, order, axis=1))

    _, d2 = global_topk(db_rows, min(2, n))
    nn_dist = np.sqrt(np.maximum(d2[:, -1], 0.0))  # excl. self

    anchors = sorted({min(a, n) for a in scan.RANK_ANCHORS})
    k_max = anchors[-1]
    per_cohort = []
    for scale in (1.0, 3.0):
        noise = rng.standard_normal((m, p)).astype(np.float32) / np.sqrt(p)
        queries = db_rows + noise * (scale * nn_dist)[:, None]
        true_ids, _ = global_topk(queries, k_max)
        home = true_ids // per
        # Phase B: score each true neighbour on its home shard
        est_t = np.zeros((m, k_max), np.float32)
        for s, arrays in enumerate(shard_arrays):
            sel = home == s
            if not sel.any():
                continue
            loc = np.where(sel, true_ids - s * per, 0)
            dev = arrays.raw.device
            est_s = scan.est_scores_of(
                arrays, on(arrays, queries), on(arrays, loc),
                signs[dev], affine_a, affine_b, float(kappa)).cpu().numpy()
            est_t[sel] = est_s[sel]
        # Phase C: global rank = sum of per-shard counts
        counts = np.zeros((m, k_max), np.int64)
        for arrays in shard_arrays:
            dev = arrays.raw.device
            counts += scan.count_leq(
                arrays, on(arrays, queries), on(arrays, est_t), signs[dev],
                affine_a, affine_b, float(kappa)).cpu().numpy()
        per_cohort.append(scan.ranks_from_counts(counts, anchors))
    return scan.budget_from_cohorts(per_cohort, anchors)


class ShardedScanIndex:
    """ScanIndex semantics with the store split over the mesh's "model"
    axis and queries split over "data".

    The build is shard-native: each shard's rows are staged, encoded and
    folded on that shard's own device, so no stage holds more than one
    shard's store on one device.  Global statistics come from cross-shard
    reductions: the centroid from per-shard sums, the affine fit from
    pooled per-shard sample pairs (scan.fit_scan_affine), the candidate
    budget from per-shard rank counts (_derive_sharded_scan_budget), each
    in law the single-device statistic over the union of the data.  A
    search runs the per-shard scans and one cross-shard top-k merge.
    Files are plain ScanIndex files, loadable by either package."""

    def __init__(self, dim: int, bits: int = 1, seed: int = 42,
                 metric: str = "l2"):
        # the inner index holds the host-side state (header scalars,
        # per-node constants for save, centroid); the store is per shard
        self._inner = ScanIndex(dim, bits=bits, rotation_seed=seed,
                                metric=metric, device="cpu")
        self.dim = dim
        self.bits = bits
        self._mesh: Mesh | None = None
        self._store: ShardedScanStore | None = None
        self._signs: dict = {}
        self.build_stages: dict[str, float] = {}

    def build(self, vectors, mesh: Mesh):
        """Shard-native build.  `vectors` is an (n, dim) numpy array or
        torch tensor, or a callable provider(shard, start_row, rows) ->
        (rows, dim) block for stores too large to hold anywhere at once,
        with n given as its ``n_rows`` attribute."""
        inner = self._inner
        n_model = mesh.shape["model"]
        build_devs = [mesh.devices[0, s] for s in range(n_model)]
        inner_dim = inner._dim + (1 if inner._metric == "ip" else 0)

        if callable(vectors):
            n = int(vectors.n_rows)
            source = vectors
        else:
            if vectors.ndim != 2 or vectors.shape[1] != inner._dim:
                raise ValueError(f"expected (n, {inner._dim}) array, got "
                                 f"{tuple(vectors.shape)}")
            n = int(vectors.shape[0])

            def source(s, start, rows):
                return vectors[start:start + rows]

        def get_block(s, start, rows, dev):
            blk = source(s, start, rows)
            if not isinstance(blk, torch.Tensor):
                blk = torch.from_numpy(
                    np.ascontiguousarray(blk, dtype=np.float32))
            return blk.to(dev, torch.float32)

        if n == 0:
            raise ValueError("build requires at least one vector.")
        stages: dict[str, float] = {}
        t_last = time.perf_counter()

        def mark(name):
            nonlocal t_last
            mesh.synchronize()
            now = time.perf_counter()
            stages[name] = round(now - t_last, 3)
            t_last = now

        per = _shard_per_rows(n, n_model)
        shard_src = [(s * per, max(0, min(n - s * per, per)))
                     for s in range(n_model)]
        signs = _on(inner._signs, mesh)

        # ---- pass 1: global centroid (+ ip norm bound) from shard sums
        total = np.zeros(inner._dim, np.float64)
        bound_sq = 0.0
        norm_sums = []  # per-shard (rows,) squared norms (ip only)
        for s, (start, rows) in enumerate(shard_src):
            if rows == 0:
                continue
            blk = get_block(s, start, rows, build_devs[s])
            total += blk.sum(dim=0).cpu().numpy().astype(np.float64)
            if inner._metric == "ip":
                nsq = (blk * blk).sum(dim=1).cpu().numpy()
                norm_sums.append(nsq)
                bound_sq = max(bound_sq, float(nsq.max()))
            del blk
        centroid_h = (total / n).astype(np.float32)
        if inner._metric == "ip":
            inner._ip_norm_bound = bound_sq
            # exact mean of the augmentation column sqrt(bound - |x|^2),
            # from the pass-1 norms once the global bound is known
            aug_mean = float(np.mean(np.concatenate(
                [np.sqrt(np.maximum(bound_sq - nsq, 0.0))
                 for nsq in norm_sums])))
            centroid_h = np.concatenate(
                [centroid_h, [aug_mean]]).astype(np.float32)
        centroid_pad = np.zeros(inner._padded, np.float32)
        centroid_pad[:len(centroid_h)] = centroid_h
        mark("centroid")

        # ---- pass 2: per-shard stage -> encode -> calibration samples
        kappa = float((1 << self.bits) - 1)
        parts, samples = [], []
        node_host = {key: [] for key in ("nop", "ip_qo", "ip_cp", "wpc")}
        for s, (start, rows) in enumerate(shard_src):
            dev = build_devs[s]
            if rows:
                blk = get_block(s, start, rows, dev)
                if inner._metric == "ip":
                    norms_sq = (blk * blk).sum(dim=1)
                    aug = (bound_sq - norms_sq).clamp_min(0.0).sqrt()
                    blk = torch.cat([blk, aug[:, None]], dim=1)
            else:
                blk = torch.zeros((1, inner_dim), dtype=torch.float32,
                                  device=dev)[:0]
            raw_s, norm_sq_s = scan.pad_store_and_norms(
                blk, rows=per, cols=inner._padded)
            del blk
            cen_dev = torch.from_numpy(centroid_pad).to(dev)
            planes_s, nop_s, qo_s, cp_s, wpc_s = scan.encode_scan_store(
                raw_s, cen_dev, signs[dev], self.bits)
            if rows:
                samples.append(scan.calibration_samples(
                    raw_s, planes_s, nop_s, qo_s, cp_s, wpc_s, cen_dev,
                    signs[dev], rows, self.bits,
                    num_samples=max(256, 2000 // n_model),
                    seed=inner._seed + 99999 + s))
            for key, t in zip(node_host, (nop_s, qo_s, cp_s, wpc_s)):
                node_host[key].append(t[:rows].cpu().numpy())
            parts.append(dict(planes=planes_s, nop=nop_s, ip_qo=qo_s,
                              ip_cp=cp_s, wpc=wpc_s, raw=raw_s,
                              norm_sq=norm_sq_s, rows=rows))
        mark("encode")

        # ---- global affine fit from pooled shard samples, then fold the
        # node constants per shard (local genuine-row counts)
        a, b, floor = scan.fit_scan_affine(samples)
        inner._affine_a, inner._affine_b, inner._ip_qo_floor = a, b, floor
        shard_arrays = [scan.ScanArrays(
            planes=part["planes"],
            node_aux=scan.fold_node_constants(
                part["nop"], part["ip_qo"], part["ip_cp"], part["wpc"],
                floor, part["rows"]),
            raw=part["raw"], norm_sq=part["norm_sq"]) for part in parts]
        shard_n = [part["rows"] for part in parts]
        del parts
        mark("calibrate")

        # ---- candidate budget from cross-shard rank counts
        inner._budget = _derive_sharded_scan_budget(
            shard_arrays, shard_n, per, n, signs, a, b, kappa,
            seed=inner._seed + 4242)
        mark("candidate_budget")

        self._store = shard_scan_store(shard_arrays, mesh)
        mark("place")
        inner._n = n
        inner._node_host = {key: np.concatenate(v)
                            for key, v in node_host.items()}
        inner._centroid = torch.from_numpy(centroid_pad)
        inner._arrays = None
        inner._staged = None
        inner._finalized = True
        self._mesh = mesh
        self._signs = signs
        self.build_stages = stages
        return self

    def _attach(self, mesh: Mesh):
        """Shard the inner single-device index's arrays over `mesh` and
        release the single-device copy."""
        self._store = shard_scan_store(
            shard_scan_arrays(self._inner._arrays, mesh.shape["model"]),
            mesh)
        self._inner._arrays = None
        self._inner._sketch = None
        self._mesh = mesh
        self._signs = _on(self._inner._signs, mesh)
        return self

    @property
    def size(self) -> int:
        return self._inner.size

    def _top_c(self, k_eff: int, q_per_device: int) -> int:
        """The candidate budget at k_eff, clamped as the JAX facade clamps
        it (by the chunk plan of the per-device query block)."""
        inner = self._inner
        chunk = scan.chunk_plan(self._store.rows, q_per_device)[0]
        return max(min(inner._budget.top_c(k_eff, inner._n), chunk), k_eff)

    def search_batch(self, queries: np.ndarray, k: int = 10):
        """Batch search; returns (ids (Q, k) int64 store rows, dists (Q, k)
        f32 squared L2, or inner-product scores for metric='ip')."""
        inner = self._inner
        if self._store is None:
            raise RuntimeError("ShardedScanIndex must be built or loaded "
                               "before searching.")
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != inner._dim:
            raise ValueError(f"expected (q, {inner._dim}) float32 queries, "
                             f"got {queries.shape}")
        k = max(int(k), 1)
        k_eff = min(k, inner._n)
        if inner._metric == "ip":
            queries = np.concatenate(
                [queries, np.zeros((len(queries), 1), np.float32)], axis=1)
        nq = len(queries)
        q_in = _data_blocks(queries, self._mesh.shape["data"])
        top_c = self._top_c(k_eff, len(q_in) // self._mesh.shape["data"])
        # the single-device facade's query rounding, so sharded and
        # single-device results agree
        ids, dists = sharded_scan_search(
            self._store, q_in.astype(QUERY_WIRE_DTYPE), self._signs,
            inner._affine_a, inner._affine_b, inner._n, self._mesh,
            kappa=float((1 << self.bits) - 1), k=k_eff, top_c=top_c)
        ids = ids.cpu().numpy()[:nq].astype(np.int64)
        dists = dists.cpu().numpy()[:nq]
        if inner._metric == "ip":
            qn = (queries[:nq, :inner._dim] ** 2).sum(1, keepdims=True)
            dists = np.where(dists < np.finfo(np.float32).max,
                             (qn + inner._ip_norm_bound - dists) / 2.0,
                             -np.inf).astype(np.float32)
        if k_eff < k:
            pad_val = (-np.inf if inner._metric == "ip"
                       else np.finfo(np.float32).max)
            ids = np.concatenate(
                [ids, np.full((nq, k - k_eff), -1, np.int64)], axis=1)
            dists = np.concatenate(
                [dists, np.full((nq, k - k_eff), pad_val, np.float32)],
                axis=1)
        return ids, dists

    # ------------------------------------------------------------ persist
    def save(self, path):
        """A plain ScanIndex file (the store's slicing is runtime state,
        re-made at load for whatever mesh), assembled on the host."""
        inner = self._inner
        if self._store is None:
            raise RuntimeError("ShardedScanIndex must be built before save.")
        n_pad = scan.store_pad(inner._n)
        shards = self._store.shards[0]

        def host_rows(arr: np.ndarray) -> np.ndarray:
            if len(arr) < n_pad:
                arr = np.concatenate([arr, np.zeros(
                    (n_pad - len(arr), *arr.shape[1:]), arr.dtype)])
            return arr[:n_pad]

        raw = np.concatenate([a.raw.cpu().numpy() for a in shards])
        planes = np.concatenate([a.planes.cpu().numpy() for a in shards])
        node_host = {key: host_rows(inner._node_host[key])
                     for key in ("nop", "ip_qo", "ip_cp", "wpc")}
        node_host["planes"] = planes[:n_pad].view(np.uint32)
        write_index(path, inner._header(), raw[:n_pad],
                    inner._centroid.cpu().numpy(), node_host)

    def load(self, path, mesh: Mesh):
        """Parse a ScanIndex file on the host, slice it per shard and place
        each slice on its own device: the full store never lands on one
        device."""
        return self.load_state(*self._inner._load_host(path), mesh)

    def load_state(self, header: dict, arrays: dict, mesh: Mesh):
        """Install an index from a ScanIndex header and host numpy arrays
        (raw, centroid, nop, ip_qo, ip_cp, wpc, planes as uint32), each
        with at least n rows: the state of a file, or of a JAX-package
        index."""
        inner = self._inner
        inner._check_header(header)
        inner._apply_header(header)
        node = {key: np.asarray(arrays[key])
                for key in ("nop", "ip_qo", "ip_cp", "wpc", "planes")}
        node["planes"] = np.ascontiguousarray(node["planes"], np.uint32)
        n_model = mesh.shape["model"]
        n = inner._n
        per = _shard_per_rows(n, n_model)
        raw_h = np.asarray(arrays["raw"], np.float32)

        def host_slice(arr, s):
            blk = arr[s * per:(s + 1) * per]
            if len(blk) < per:
                blk = np.concatenate([blk, np.zeros(
                    (per - len(blk), *arr.shape[1:]), arr.dtype)])
            return blk

        shards = []
        for s in range(n_model):
            dev = mesh.devices[0, s]
            rows = max(0, min(n - s * per, per))
            t = {key: _tensor(host_slice(node[key], s), dev)
                 for key in ("nop", "ip_qo", "ip_cp", "wpc")}
            raw_s = _tensor(host_slice(raw_h, s), dev)
            shards.append(scan.ScanArrays(
                planes=_tensor(host_slice(node["planes"], s).view(np.int32),
                               dev),
                node_aux=scan.fold_node_constants(
                    t["nop"], t["ip_qo"], t["ip_cp"], t["wpc"],
                    inner._ip_qo_floor, rows),
                raw=raw_s,
                norm_sq=(raw_s * raw_s).sum(dim=-1)))
        self._store = shard_scan_store(shards, mesh)
        inner._node_host = node
        inner._centroid = _tensor(arrays["centroid"], "cpu", np.float32)
        inner._arrays = None
        inner._staged = None
        inner._sketch = None
        inner._finalized = True
        self._mesh = mesh
        self._signs = _on(inner._signs, mesh)
        return self


# ---------------------------------------------------------- sharded graph
class GraphShard(NamedTuple):
    """One shard's subgraph on one device (the fields of the JAX package's
    stacked ShardedStore, with nbr_ids/planes/aux in a NeighborStore)."""

    raw: torch.Tensor               # (N_s, P) f32, BFS order
    norm_sq: torch.Tensor           # (N_s,)
    neighbors: NeighborStore
    entry_candidates: torch.Tensor  # (M,) int32
    orig_ids: torch.Tensor          # (N_s,) int32: caller's row per node
    #                                 (>= n for shard-padding rows)


class ShardedStore(NamedTuple):
    """``shards[d][s]`` is shard s's GraphShard on mesh.devices[d, s]."""

    shards: tuple

    @property
    def rows(self) -> int:
        return int(self.shards[0][0].raw.shape[0])


def _graph_shard_to(sh: GraphShard, dev) -> GraphShard:
    nb = sh.neighbors
    return GraphShard(
        raw=sh.raw.to(dev), norm_sq=sh.norm_sq.to(dev),
        neighbors=NeighborStore(ids=nb.ids.to(dev), fused=nb.fused.to(dev),
                                r=nb.r, bits=nb.bits, words=nb.words),
        entry_candidates=sh.entry_candidates.to(dev),
        orig_ids=sh.orig_ids.to(dev))


def shard_store(shards: list, mesh: Mesh) -> ShardedStore:
    """Place shard s on every mesh.devices[d, s]."""
    return ShardedStore(shards=_place(shards, mesh, _graph_shard_to))


def build_sharded_store(vectors: np.ndarray, bits: int, r: int,
                        n_shards: int, signs: torch.Tensor, seed: int = 42,
                        devices=None) -> list:
    """Partition the dataset into contiguous shards and build one subgraph
    per shard, shard s on devices[s] (default: every shard on the current
    CUDA device, as the JAX package builds on its default device; without
    CUDA that default raises).  Returns the
    GraphShards; each maps its local ids to the caller's rows through
    ``orig_ids``."""
    n = len(vectors)
    per = -(-n // n_shards)
    # pad so every shard has the same size (duplicates of the last vector;
    # their original ids are >= n and the search masks them out)
    pad = per * n_shards - n
    if pad:
        vectors = np.concatenate([vectors, vectors[-1:].repeat(pad, 0)], 0)
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", torch.cuda.current_device())
                   ] * n_shards
    p = signs.shape[-1]
    shards = []
    for s in range(n_shards):
        dev = devices[s]
        chunk = np.ascontiguousarray(vectors[s * per:(s + 1) * per],
                                     dtype=np.float32)
        raw = hadamard.pad_to(torch.from_numpy(chunk).to(dev), p)
        norm_sq = (raw * raw).sum(dim=-1)
        centroid = raw.mean(dim=0)
        node_nop = torch.linalg.vector_norm(raw - centroid, dim=-1)
        res = gbuild.build_graph(raw, norm_sq, node_nop, signs.to(dev),
                                 bits=bits, r=r, seed=seed + s)
        n2o = np.empty(per, np.int64)
        n2o[res.old_to_new] = np.arange(per)

        m = int(min(per, max(16, 4 * np.sqrt(per))))
        rng = np.random.default_rng(seed + 7 + s)
        cand = np.unique(np.concatenate(
            [[res.entry_point], rng.choice(per, size=m, replace=False)]))
        # fixed-size candidate list across shards (pad with the entry)
        m_fixed = int(max(16, 4 * np.sqrt(per)))
        if len(cand) < m_fixed:
            cand = np.concatenate(
                [cand, np.full(m_fixed - len(cand), res.entry_point)])
        cand = cand[:m_fixed]
        shards.append(GraphShard(
            raw=res.raw, norm_sq=res.norm_sq, neighbors=res.neighbors,
            entry_candidates=torch.from_numpy(cand.astype(np.int32)).to(dev),
            orig_ids=torch.from_numpy(
                (n2o + s * per).astype(np.int32)).to(dev)))
    return shards


def _params_on(params: beam.SearchParams, mesh: Mesh) -> dict:
    """{device: params with the slack ladder on that device}."""
    return {dev: params._replace(slack_levels=params.slack_levels.to(dev))
            for dev in mesh.unique_devices()}


def _pooled_params(shards: list, signs: torch.Tensor, bits: int, r: int,
                   padded: int, max_shards: int = 3) -> beam.SearchParams:
    """EVT-CRC calibration pooled over up to max_shards shard subgraphs:
    each is calibrated on its own and the per-field median is taken
    (robust to one unlucky partition; i.i.d. partitions make the shards
    near-exchangeable).  The slack ladder lands on the first shard's
    device."""
    profile = calib_mod.IndexProfile.derive(int(shards[0].raw.shape[0]),
                                            padded, r, bits)
    per_shard = []
    for sh in shards[:max_shards]:
        dev = sh.raw.device
        snap = calib_mod.calibrate(sh.raw, sh.norm_sq, sh.neighbors,
                                   signs.to(dev), bits, profile)
        per_shard.append(calib_mod.to_search_params(snap, dev))
    if len(per_shard) == 1:
        return per_shard[0]

    def median(field):
        vals = [getattr(p, field) for p in per_shard]
        if isinstance(vals[0], torch.Tensor):
            vals = [v.cpu().numpy() for v in vals]
        return np.median(np.stack(vals).astype(np.float32), axis=0)

    dev = shards[0].raw.device
    return beam.SearchParams(
        affine_a=float(np.float32(median("affine_a"))),
        affine_b=float(np.float32(median("affine_b"))),
        ip_qo_floor=float(np.float32(median("ip_qo_floor"))),
        slack_levels=torch.from_numpy(
            median("slack_levels").astype(np.float32)).to(dev),
        gamma=float(np.float32(median("gamma"))),
        gamma_max=float(np.float32(median("gamma_max"))),
        gamma_beta=float(np.float32(median("gamma_beta"))),
        gamma_warmup=int(median("gamma_warmup")),
    )


def _derive_shard_step_budget(shards: list, params: beam.SearchParams,
                              signs: torch.Tensor, bits: int, r: int,
                              seed: int, max_shards: int = 2) -> dict:
    """Recall-sufficient step budget of the sharded beam, measured on up to
    max_shards shard subgraphs (Index._derive_step_budget's derivation:
    one generously capped k=100 run over jittered database rows; budget =
    p99 of the first step at which the final top-k' was present); the
    per-anchor max over shards bounds the straggler."""
    rng = np.random.default_rng(seed + 4242)
    budgets = {10: 16, 100: 16}
    for sh in shards[:max_shards]:
        dev = sh.raw.device
        n_local = int(sh.raw.shape[0])
        m = int(min(128, n_local))
        ids = rng.choice(n_local, size=m, replace=False)
        db_q = sh.raw[torch.from_numpy(ids).to(dev)].cpu().numpy()
        sigma = db_q.std(axis=0, keepdims=True)
        half = m // 2
        synth = db_q[:half] + rng.standard_normal(
            (half, db_q.shape[1])).astype(np.float32) * sigma
        queries = np.concatenate([db_q[half:], synth], axis=0)
        bucket = 1 << max(6, (len(queries) - 1).bit_length())
        if bucket != len(queries):
            queries = np.concatenate(
                [queries, queries[-1:].repeat(bucket - len(queries), 0)])
        k_max = min(100, n_local)
        out = beam.search_batch(
            sh.raw, sh.norm_sq, sh.neighbors, sh.entry_candidates,
            signs.to(dev), torch.from_numpy(queries).to(dev),
            params._replace(slack_levels=params.slack_levels.to(dev)),
            bits=bits, k=k_max, beam_cap=max(2 * r, 4 * k_max),
            max_steps=512, debug_state=True)
        res_step = out[2].res_step.cpu().numpy()
        for k_anchor in (10, 100):
            present = res_step[:, :min(k_anchor, k_max)].max(axis=1)
            b = int(np.clip(np.ceil(np.quantile(present, 0.99)), 16, 512))
            budgets[k_anchor] = max(budgets[k_anchor], b)
    return budgets


def sharded_search(store: ShardedStore, queries: np.ndarray, params: dict,
                   signs: dict, mesh: Mesh, bits: int, k: int,
                   n_real: int, beam_cap: int = 128,
                   max_steps: int = 512, n_seeds: int = 4):
    """Global top-k over all graph shards.

    queries: (Q, dim) host array with Q a multiple of the data axis;
    params and signs: {device: ...}.  Returns (ids (Q, k) in the caller's
    original row order, -1 for none, dists (Q, k)) on mesh.devices[0, 0].
    Rows whose original id is >= n_real are shard-padding duplicates and
    are masked before the merge.  n_seeds: the entry candidates every
    shard's beam starts from.  Each shard searches in sub-batches whose
    dense visited table stays within VISITED_BYTES_BUDGET, as
    Index.search_batch does."""
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    sub = max(1, index_mod.VISITED_BYTES_BUDGET // (store.rows + 1))
    qd = len(queries) // n_data
    out_ids, out_d = [], []
    for d in range(n_data):
        block = torch.from_numpy(
            np.ascontiguousarray(queries[d * qd:(d + 1) * qd]))
        q_on = {}
        parts_i, parts_d = [], []
        for s in range(n_model):
            dev = mesh.devices[d, s]
            if dev not in q_on:
                q_on[dev] = block.to(dev)
            sh = store.shards[d][s]
            ids_l, d_l = [], []
            for start in range(0, qd, sub):
                ids_s, d_s = beam.search_batch(
                    sh.raw, sh.norm_sq, sh.neighbors, sh.entry_candidates,
                    signs[dev], q_on[dev][start:start + sub], params[dev],
                    bits=bits, k=k, beam_cap=beam_cap, max_steps=max_steps,
                    n_seeds=n_seeds)
                ids_l.append(ids_s)
                d_l.append(d_s)
            local_ids, local_d = torch.cat(ids_l), torch.cat(d_l)
            global_ids = torch.where(
                local_ids >= 0, sh.orig_ids[local_ids.clamp_min(0).long()],
                -1)
            pad_row = global_ids >= n_real
            global_ids = torch.where(pad_row, -1, global_ids)
            local_d = torch.where(pad_row, FLOAT_MAX, local_d)
            parts_i.append(global_ids)
            parts_d.append(local_d)
        ids, dists = merge_topk(parts_i, parts_d, k, mesh.devices[d, 0])
        out_ids.append(ids)
        out_d.append(dists)
    home = mesh.devices[0, 0]
    return (torch.cat([i.to(home) for i in out_ids]),
            torch.cat([x.to(home) for x in out_d]))


class ShardedIndex:
    """The graph engine with the database split over the mesh's "model"
    axis: each shard builds an independent CP-HNSW subgraph; EVT-CRC
    calibration is pooled (median) over several shard subgraphs; a search
    runs the per-shard DABS beams and one cross-shard top-k merge and
    returns ids in the caller's row order.  Files are the JAX package's
    ``CPHNSW-TPU-SHARDED`` v1 format."""

    def __init__(self, dim: int, bits: int = 1, r: int = 32, seed: int = 42):
        self.dim = dim
        self.bits = bits
        self.r = r
        self.seed = seed
        self._padded = hadamard.next_pow2(dim)
        self._signs_h = hadamard.rotation_signs(seed, self._padded)
        self._store: ShardedStore | None = None
        self._mesh: Mesh | None = None
        self._params: beam.SearchParams | None = None
        self._step_budget: dict | None = None
        self._n = 0
        self.build_stages: dict[str, float] = {}

    def build(self, vectors, mesh: Mesh):
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.detach().cpu().numpy()
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) float32 array, got "
                             f"{vectors.shape}")
        stages: dict[str, float] = {}
        t_last = time.perf_counter()

        def mark(name):
            nonlocal t_last
            mesh.synchronize()
            now = time.perf_counter()
            stages[name] = round(now - t_last, 3)
            t_last = now

        self._n = len(vectors)
        n_model = mesh.shape["model"]
        shards = build_sharded_store(
            vectors, self.bits, self.r, n_model, self._signs_h, self.seed,
            devices=[mesh.devices[0, s] for s in range(n_model)])
        mark("shard_graphs")
        self._params = _pooled_params(shards, self._signs_h, self.bits,
                                      self.r, self._padded)
        mark("calibrate")
        self._step_budget = _derive_shard_step_budget(
            shards, self._params, self._signs_h, self.bits, self.r,
            self.seed)
        mark("step_budget")
        self._attach(shards, mesh)
        mark("place")
        self.build_stages = stages
        return self

    def _attach(self, shards: list, mesh: Mesh):
        self._store = shard_store(shards, mesh)
        self._mesh = mesh
        self._signs = _on(self._signs_h, mesh)
        self._params_dev = _params_on(self._params, mesh)

    def _max_steps(self, k: int) -> int:
        """The measured step budget, log-k interpolated between the k=10
        and k=100 anchors (512 for a file without one)."""
        sb = self._step_budget
        if not sb:
            return 512
        s10, s100 = sb[10], sb[100]
        if k <= 10:
            need = s10
        elif k >= 100:
            need = s100
        else:
            need = s10 + (s100 - s10) * (np.log10(k) - 1.0)
        return int(np.clip(8 * np.ceil(need / 8.0), 16, 512))

    def search_batch(self, queries, k: int = 10):
        """Batch search; returns (ids (Q, k) int64 in the caller's row
        order, dists (Q, k) f32 squared L2)."""
        if self._store is None:
            raise RuntimeError("ShardedIndex must be built or loaded before "
                               "searching.")
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        nq = len(queries)
        q_in = _data_blocks(queries, self._mesh.shape["data"])
        ids, dists = sharded_search(
            self._store, q_in, self._params_dev, self._signs, self._mesh,
            bits=self.bits, k=k, max_steps=self._max_steps(k),
            n_real=self._n)
        return (ids.cpu().numpy()[:nq].astype(np.int64),
                dists.cpu().numpy()[:nq])

    # ------------------------------------------------------------ persist
    def save(self, path):
        """The sharded store + pooled calibration in one npz (the mesh is
        runtime state, given again at load)."""
        if self._store is None:
            raise RuntimeError("ShardedIndex must be built before saving.")
        p = self._params
        header = {
            "magic": SHARDED_MAGIC,
            "version": SHARDED_VERSION,
            "dim": self.dim,
            "bits": self.bits,
            "r": self.r,
            "seed": self.seed,
            "n": self._n,
            "step_budget": self._step_budget,
            "params": {
                "affine_a": p.affine_a, "affine_b": p.affine_b,
                "ip_qo_floor": p.ip_qo_floor,
                "slack_levels": p.slack_levels.cpu().numpy().tolist(),
                "gamma": p.gamma, "gamma_max": p.gamma_max,
                "gamma_beta": p.gamma_beta, "gamma_warmup": p.gamma_warmup,
            },
        }
        shards = self._store.shards[0]

        def stack(fn):
            return np.stack([fn(sh).cpu().numpy() for sh in shards])

        arrays = dict(
            raw=stack(lambda sh: sh.raw),
            norm_sq=stack(lambda sh: sh.norm_sq),
            nbr_ids=stack(lambda sh: sh.neighbors.ids),
            nbr_planes=stack(
                lambda sh: sh.neighbors.planes.contiguous()).view(np.uint32),
            nbr_aux=stack(lambda sh: sh.neighbors.aux),
            entry_candidates=stack(lambda sh: sh.entry_candidates),
            orig_ids=stack(lambda sh: sh.orig_ids),
        )
        np.savez_compressed(
            path, header=np.frombuffer(json.dumps(header).encode(),
                                       dtype=np.uint8), **arrays)

    def _check_header(self, header: dict, n_shards: int, mesh: Mesh):
        if header.get("magic") != SHARDED_MAGIC:
            raise ValueError("Not a sharded CPHNSW-TPU index file.")
        if (header["dim"], header["bits"], header["r"]) != (
                self.dim, self.bits, self.r):
            raise ValueError("Index file dim/bits/R mismatch.")
        if header["seed"] != self.seed:
            raise ValueError("Index file rotation seed mismatch.")
        if n_shards != mesh.shape["model"]:
            raise ValueError(f"Index file has {n_shards} shards; mesh model "
                             f"axis is {mesh.shape['model']}.")

    def load(self, path: str | Path, mesh: Mesh):
        with np.load(path) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            arrays = {f: np.asarray(z[f]) for f in STORE_FIELDS}
        return self.load_state(header, arrays, mesh)

    def load_state(self, header: dict, arrays: dict, mesh: Mesh):
        """Install an index from its header (n, step_budget, params) and
        the stacked (S, ...) host arrays of STORE_FIELDS: the state of a
        file, or of a JAX-package ShardedIndex."""
        self._check_header(header, len(arrays["raw"]), mesh)
        shards = []
        for s in range(len(arrays["raw"])):
            dev = mesh.devices[0, s]
            shards.append(GraphShard(
                raw=_tensor(arrays["raw"][s], dev, np.float32),
                norm_sq=_tensor(arrays["norm_sq"][s], dev, np.float32),
                neighbors=NeighborStore.pack(
                    _tensor(arrays["nbr_ids"][s], dev, np.int32),
                    _tensor(np.ascontiguousarray(
                        arrays["nbr_planes"][s], np.uint32).view(np.int32),
                        dev),
                    _tensor(arrays["nbr_aux"][s], dev, np.float32)),
                entry_candidates=_tensor(arrays["entry_candidates"][s], dev,
                                         np.int32),
                orig_ids=_tensor(arrays["orig_ids"][s], dev, np.int32)))
        self._n = int(header["n"])
        sb = header.get("step_budget")
        self._step_budget = ({int(kk): int(vv) for kk, vv in sb.items()}
                             if sb else None)
        pf = header["params"]

        def f32(x) -> float:
            return float(np.float32(x))

        self._params = beam.SearchParams(
            affine_a=f32(pf["affine_a"]), affine_b=f32(pf["affine_b"]),
            ip_qo_floor=f32(pf["ip_qo_floor"]),
            slack_levels=torch.tensor(pf["slack_levels"],
                                      dtype=torch.float32),
            gamma=f32(pf["gamma"]), gamma_max=f32(pf["gamma_max"]),
            gamma_beta=f32(pf["gamma_beta"]),
            gamma_warmup=int(pf["gamma_warmup"]))
        self._attach(shards, mesh)
        return self
