"""ScanIndex: the flat calibrated-scan index on one device.

PyTorch counterpart of ``cphnsw_tpu/api/scan_index.py`` with the same
public contract (build / finalize / search / search_batch / save / load /
size / dim / is_finalized, no search-tuning knobs) and the same ``.npz``
index file, plus an explicit ``device``.  Search always takes the fused
path in sketch mode: the int8 sketch of the store streams through the
scan+select kernel and ``max(4k, 512)`` survivors get the exact f32
rerank.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from cphnsw_tpu_torch.kernels.scan_keys import derived_sub_batch
from cphnsw_tpu_torch.ops import hadamard, quantize
from cphnsw_tpu_torch.search import scan

MAGIC = "CPHNSW-TPU-SCAN"
VERSION = 2  # v2: codes stored as packed uint32 bit-planes (bits*P/8 B/vec)
ENCODE_CHUNK = 1 << 17
SEARCH_SUB_BATCH = 2048
# Queries are rounded to f16 before they reach the device and searched as
# f32 from there on, exactly as the JAX package does (its host-device link
# carried f16); the rounding moves squared distances by ~0.3% of the
# nearest-neighbour scale, far below top-k gaps.
QUERY_WIRE_DTYPE = np.float16
NODE_KEYS = ("nop", "ip_qo", "ip_cp", "wpc", "planes")


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without CUDA raises (the
    index never moves to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on `device` (copied if read-only)."""
    a = np.require(a, dtype=dtype, requirements=["C", "W"])
    return torch.from_numpy(a).to(device)


def write_index(path, header: dict, raw: np.ndarray, centroid: np.ndarray,
                node_host: dict):
    """One scan index file: header JSON + host arrays in one npz, the JAX
    package's format."""
    np.savez_compressed(
        path,
        header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        raw=raw, centroid=centroid, **node_host)


class ScanIndex:
    """Flat calibrated-scan index on `device` (default "cuda")."""

    def __init__(self, dim: int, bits: int = 1,
                 rotation_seed: int = hadamard.DEFAULT_ROTATION_SEED,
                 metric: str = "l2", device="cuda"):
        if dim <= 0:
            raise ValueError("dim must be > 0")
        if bits not in (1, 2, 4):
            raise ValueError("bits must be one of {1, 2, 4}")
        if metric not in ("l2", "ip"):
            raise ValueError("metric must be 'l2' or 'ip'")
        self._device = resolve_device(device)
        self._dim = dim
        self._bits = bits
        self._seed = rotation_seed
        self._metric = metric
        self._ip_norm_bound = None
        self._padded = hadamard.next_pow2(dim + 1 if metric == "ip" else dim)
        self._signs = hadamard.rotation_signs(rotation_seed, self._padded).to(
            self._device)

        self._n = 0
        self._finalized = False
        self._staged = None          # (n, d') f32 tensor awaiting finalize

        # populated by finalize / load
        self._arrays: scan.ScanArrays | None = None
        self._centroid = None
        self._node_host = None       # per-node numpy arrays (for save)
        self._affine_a = 1.0
        self._affine_b = 0.0
        self._ip_qo_floor = 0.0
        self._budget: scan.CandidateBudget | None = None
        self._sketch: scan.RerankSketch | None = None
        self.build_stages: dict[str, float] = {}

    # ------------------------------------------------------------- build
    def build(self, vectors):
        """Stage vectors (encoding happens in finalize).  Accepts a numpy
        array or a torch tensor, e.g. one already on the device."""
        if isinstance(vectors, torch.Tensor):
            if vectors.ndim != 2 or vectors.shape[1] != self._dim:
                raise ValueError(f"expected (n, {self._dim}) tensor, got "
                                 f"{tuple(vectors.shape)}")
            if vectors.shape[0] == 0:
                raise ValueError("build requires at least one vector.")
            vecs = vectors.to(self._device, torch.float32)
            if self._metric == "ip":
                # f32 on the device, so the bound is inflated by a relative
                # epsilon: f32 rounding of the largest row must not clip a
                # genuine row's augmentation to zero
                norms_sq = (vecs * vecs).sum(dim=1)
                bound_sq = float(norms_sq.max()) * (1.0 + 1e-6)
                self._ip_norm_bound = bound_sq
                aug = (bound_sq - norms_sq).clamp_min(0.0).sqrt()
                vecs = torch.cat([vecs, aug[:, None]], dim=1)
        else:
            vectors = np.ascontiguousarray(vectors, dtype=np.float32)
            if vectors.ndim != 2 or vectors.shape[1] != self._dim:
                raise ValueError(f"expected (n, {self._dim}) float32 array, "
                                 f"got {vectors.shape}")
            if len(vectors) == 0:
                raise ValueError("build requires at least one vector.")
            if self._metric == "ip":
                norms_sq = (vectors.astype(np.float64) ** 2).sum(1)
                bound_sq = float(norms_sq.max())
                self._ip_norm_bound = bound_sq
                aug = np.sqrt(np.maximum(bound_sq - norms_sq, 0.0))
                vectors = np.concatenate(
                    [vectors, aug[:, None].astype(np.float32)], axis=1)
            vecs = torch.from_numpy(vectors).to(self._device)
        self._n = int(vecs.shape[0])
        self._staged = vecs
        self._finalized = False
        return self

    def _sync(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def finalize(self, verbose: bool = False):
        """Encode + calibrate + derive the candidate budget; per-stage wall
        seconds land in self.build_stages."""
        if self._n == 0:
            raise RuntimeError("Cannot finalize an empty index.")
        if self._staged is None:
            raise RuntimeError("Finalize called without a pending build.")
        stages: dict[str, float] = {}
        t_last = time.perf_counter()

        def mark(name):
            nonlocal t_last
            self._sync()
            now = time.perf_counter()
            stages[name] = round(now - t_last, 2)
            t_last = now

        n = self._n
        raw, norm_sq = scan.pad_store_and_norms(
            self._staged, rows=scan.store_pad(n), cols=self._padded)
        self._staged = None
        centroid = quantize.compute_centroid(raw[:n])
        kappa = float((1 << self._bits) - 1)
        planes, nop, ip_qo, ip_cp, wpc = scan.encode_scan_store(
            raw, centroid, self._signs, self._bits, chunk=ENCODE_CHUNK)
        mark("encode")

        a, b, floor = scan.calibrate_scan_affine(
            raw, planes, nop, ip_qo, ip_cp, wpc, centroid, self._signs, n,
            self._bits, seed=self._seed + 99999)
        node_aux = scan.fold_node_constants(nop, ip_qo, ip_cp, wpc, floor, n)
        mark("calibrate")
        arrays = scan.ScanArrays(planes=planes, node_aux=node_aux, raw=raw,
                                 norm_sq=norm_sq)
        budget = scan.derive_candidate_budget(
            arrays, self._signs, a, b, n, kappa, seed=self._seed + 4242)
        mark("candidate_budget")
        if verbose:
            print(f"scan budget anchors={budget.anchors.tolist()} "
                  f"ranks={budget.ranks.tolist()} affine=({a:.4f},{b:.4f})",
                  flush=True)

        self._node_host = dict(
            nop=nop.cpu().numpy(), ip_qo=ip_qo.cpu().numpy(),
            ip_cp=ip_cp.cpu().numpy(), wpc=wpc.cpu().numpy(),
            planes=planes.cpu().numpy().view(np.uint32),
        )
        self._arrays = arrays
        self._centroid = centroid
        self._affine_a, self._affine_b, self._ip_qo_floor = a, b, floor
        self._budget = budget
        self._sketch = None
        self._finalized = True
        mark("stage_host_copies")
        self.build_stages = stages
        return self

    def _rerank_sketch(self) -> scan.RerankSketch:
        if self._sketch is None:
            self._sketch = scan.make_rerank_sketch(self._arrays.raw)
        return self._sketch

    # ------------------------------------------------------------ search
    def search_batch(self, queries: np.ndarray, k: int = 10):
        """Batch search; returns (ids (Q, k) int64, dists (Q, k) f32
        squared L2, or inner-product scores for metric='ip')."""
        if not self._finalized:
            raise RuntimeError("Index must be finalized before searching.")
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != self._dim:
            raise ValueError(f"expected (q, {self._dim}) float32 queries, "
                             f"got {queries.shape}")
        k = max(int(k), 1)
        k_eff = min(k, self._n)
        if self._metric == "ip":
            queries = np.concatenate(
                [queries, np.zeros((len(queries), 1), np.float32)], axis=1)

        nq = len(queries)
        n_pad = self._arrays.raw.shape[0]
        top_c_k = self._budget.top_c(k_eff, self._n)
        sketch = self._rerank_sketch()
        # sketch mode selects only the survivors, so the sub-batch follows
        # the survivor count, not the candidate budget
        sub_batch = derived_sub_batch(
            n_pad, scan._rerank_survivors(k_eff, top_c_k),
            cap=SEARCH_SUB_BATCH)
        # full sub-batches, then the tail in its own power-of-two bucket
        # (>= 64) padded by repeating its last query
        plan = []  # (start, rows, padded_rows)
        s = 0
        while s < nq:
            rem_q = nq - s
            if rem_q >= sub_batch:
                plan.append((s, sub_batch, sub_batch))
                s += sub_batch
            else:
                bucket = min(1 << max(6, (rem_q - 1).bit_length()), sub_batch)
                plan.append((s, rem_q, bucket))
                s = nq
        ids_l, dists_l = [], []
        for start, rows, padded in plan:
            q_sub = queries[start:start + rows]
            if padded != rows:
                q_sub = np.concatenate(
                    [q_sub, np.repeat(q_sub[-1:], padded - rows, axis=0)])
            chunk = scan.chunk_plan(n_pad, padded)[0]
            top_c = max(min(top_c_k, chunk), k_eff)
            q_dev = torch.from_numpy(q_sub.astype(QUERY_WIRE_DTYPE)).to(
                self._device)
            ids_d, d_d = scan.scan_search(
                self._arrays, q_dev, self._signs, self._affine_a,
                self._affine_b, self._n,
                kappa=float((1 << self._bits) - 1), k=k_eff, top_c=top_c,
                sketch=sketch)
            ids_l.append(ids_d[:rows])
            dists_l.append(d_d[:rows])
        ids = torch.cat(ids_l).cpu().numpy().astype(np.int64)
        dists = torch.cat(dists_l).cpu().numpy().astype(np.float32)
        if self._metric == "ip":
            qn = (queries[:nq, : self._dim] ** 2).sum(1, keepdims=True)
            dists = np.where(
                dists < np.finfo(np.float32).max,
                (qn + self._ip_norm_bound - dists) / 2.0,
                -np.inf,
            ).astype(np.float32)
        if k_eff < k:
            pad_val = (-np.inf if self._metric == "ip"
                       else np.finfo(np.float32).max)
            ids = np.concatenate(
                [ids, np.full((nq, k - k_eff), -1, np.int64)], axis=1)
            dists = np.concatenate(
                [dists, np.full((nq, k - k_eff), pad_val, np.float32)], axis=1)
        return ids, dists

    def search(self, query: np.ndarray, k: int = 10):
        query = np.ascontiguousarray(query, dtype=np.float32)
        ids, dists = self.search_batch(query[None, :], k)
        return ids[0], dists[0]

    # ------------------------------------------------------------- state
    @property
    def size(self) -> int:
        return self._n

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def is_finalized(self) -> bool:
        return self._finalized

    # ------------------------------------------------------------ persist
    def _header(self) -> dict:
        return {
            "magic": MAGIC,
            "version": VERSION,
            "dim": self._dim,
            "padded": self._padded,
            "bits": self._bits,
            "n": self._n,
            "rotation_seed": self._seed,
            "metric": self._metric,
            "ip_norm_bound": self._ip_norm_bound,
            "affine_a": self._affine_a,
            "affine_b": self._affine_b,
            "ip_qo_floor": self._ip_qo_floor,
            "budget_anchors": self._budget.anchors.tolist(),
            "budget_ranks": self._budget.ranks.tolist(),
        }

    def save(self, path: str | Path):
        """Header JSON + arrays in one npz, the JAX package's format."""
        if not self._finalized:
            raise RuntimeError("Index must be finalized before saving.")
        write_index(path, self._header(), self._arrays.raw.cpu().numpy(),
                    self._centroid.cpu().numpy(), self._node_host)

    def load(self, path: str | Path):
        """Restore a saved index (validates magic/version/dim/bits/seed/
        metric before committing anything)."""
        return self.load_state(*self._load_host(path))

    def _load_host(self, path: str | Path) -> tuple[dict, dict]:
        """Parse and validate a saved index on the host only: (header, host
        numpy arrays).  The sharded load slices these per shard, so the
        full store never lands on one device."""
        with np.load(path) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            self._check_header(header)
            arrays = {key: np.asarray(z[key])
                      for key in ("raw", "centroid", *NODE_KEYS)}
        return header, arrays

    def _check_header(self, header: dict):
        if header.get("magic") != MAGIC:
            raise ValueError("Not a CPHNSW-TPU scan index file.")
        if header.get("version") != VERSION:
            raise ValueError(
                f"Unsupported scan index version {header.get('version')}")
        if header["dim"] != self._dim:
            raise ValueError(f"Index file dim={header['dim']} mismatches "
                             f"dim={self._dim}")
        if header["bits"] != self._bits:
            raise ValueError("Index file bits parameter mismatch.")
        if header["rotation_seed"] != self._seed:
            raise ValueError("Index file rotation seed mismatch.")
        if header["metric"] != self._metric:
            raise ValueError(f"Index file metric={header['metric']!r} "
                             f"mismatches constructor metric="
                             f"{self._metric!r}")

    def _apply_header(self, header: dict):
        """Commit the scalar fields of a validated header."""
        self._n = int(header["n"])
        if header["padded"] != self._padded:
            self._padded = int(header["padded"])
            self._signs = hadamard.rotation_signs(
                self._seed, self._padded).to(self._device)
        self._ip_norm_bound = header.get("ip_norm_bound")
        self._affine_a = float(header["affine_a"])
        self._affine_b = float(header["affine_b"])
        self._ip_qo_floor = float(header["ip_qo_floor"])
        self._budget = scan.CandidateBudget(
            anchors=np.asarray(header["budget_anchors"], np.int64),
            ranks=np.asarray(header["budget_ranks"], np.int64),
        )

    def load_state(self, header: dict, arrays: dict):
        """Install an index from its header fields and host numpy arrays
        (raw, centroid, nop, ip_qo, ip_cp, wpc, planes as uint32): the
        state of a saved file, or of a JAX-package index."""
        self._check_header(header)
        self._apply_header(header)
        dev = self._device
        node = {key: np.asarray(arrays[key]) for key in NODE_KEYS}
        node["planes"] = np.ascontiguousarray(node["planes"], dtype=np.uint32)
        self._node_host = node
        t = {key: _tensor(v, dev) for key, v in node.items()
             if key != "planes"}
        raw = _tensor(arrays["raw"], dev, np.float32)
        self._arrays = scan.ScanArrays(
            planes=_tensor(node["planes"].view(np.int32), dev),
            node_aux=scan.fold_node_constants(
                t["nop"], t["ip_qo"], t["ip_cp"], t["wpc"],
                self._ip_qo_floor, self._n),
            raw=raw,
            norm_sq=(raw * raw).sum(dim=-1),
        )
        self._centroid = _tensor(arrays["centroid"], dev, np.float32)
        self._staged = None
        self._sketch = None
        self._finalized = True
        return self
