"""Index (the graph engine) and CPIndex, the one public index class.

PyTorch counterpart of ``cphnsw_tpu/api/index.py``.  ``Index`` builds the
CP-HNSW graph (NNDescent + alpha-CNG + edge-residual codes), calibrates it
with EVT-CRC and searches it with the DABS beam, with no search-tuning
knobs: the step budget, visited-table size and every search constant are
derived at ``finalize()``.  Search results map back to the caller's
original row ids.  ``CPIndex`` derives the engine: ``"auto"`` resolves to
the flat scan (``ScanIndex``) at every single-device scale, ``"graph"``
selects ``Index``, and ``load()`` detects the engine from the file header.
Index files are the JAX package's ``.npz`` format in both directions.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from cphnsw_tpu_torch.api import scan_index, upper_layers as ul
from cphnsw_tpu_torch.api.scan_index import ScanIndex, _tensor
from cphnsw_tpu_torch.calibration import calibrate as calib_mod
from cphnsw_tpu_torch.graph import build as gbuild
from cphnsw_tpu_torch.graph import stats as gstats
from cphnsw_tpu_torch.graph.build import NeighborStore
from cphnsw_tpu_torch.ops import hadamard
from cphnsw_tpu_torch.search import beam

MAGIC = "CPHNSW-TPU"
VERSION = 3
DEFAULT_R = 32
# Device-memory bound of one search sub-batch's visited table; queries are
# independent in the beam, so splitting the batch changes no result.
VISITED_BYTES_BUDGET = 2 << 30


def _jsonable(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not jsonable: {type(o)}")


class Index:
    """The graph index of one dataset on `device` (default "cuda"): build,
    finalize, search, save, load; see the module docstring."""

    def __init__(self, dim: int, bits: int = 1, r: int = DEFAULT_R,
                 rotation_seed: int = hadamard.DEFAULT_ROTATION_SEED,
                 entry_strategy: str = "seed", metric: str = "l2",
                 device="cuda"):
        if dim <= 0:
            raise ValueError("dim must be > 0")
        if bits not in (1, 2, 4):
            raise ValueError("bits must be one of {1, 2, 4}")
        if entry_strategy not in ("seed", "hnsw"):
            raise ValueError("entry_strategy must be 'seed' or 'hnsw'")
        if metric not in ("l2", "ip"):
            raise ValueError("metric must be 'l2' or 'ip'")
        self._device = scan_index.resolve_device(device)
        # inner product reduces to L2 by the augmentation
        # x' = [x, sqrt(M^2 - |x|^2)], q' = [q, 0]
        self._metric = metric
        self._ip_norm_bound = None
        self._entry_strategy = entry_strategy
        self._upper: ul.UpperLayers | None = None
        # beam entries expanded per search step
        self._expand_width = 4
        self._dim = dim
        self._bits = bits
        self._r = r
        self._seed = rotation_seed
        self._padded = hadamard.next_pow2(dim + 1 if metric == "ip" else dim)
        self._signs = hadamard.rotation_signs(rotation_seed, self._padded).to(
            self._device)

        self._finalized = False
        self._needs_build = False
        self._n = 0
        # populated by build / finalize / load
        self._raw = None          # (N, P) f32, BFS order after finalize
        self._norm_sq = None
        self._node_nop = None
        self._centroid = None
        self._neighbors: NeighborStore | None = None
        self._entry = 0
        self._entry_candidates = None
        self._new_to_old = None   # (N,) int64 numpy
        self._profile: calib_mod.IndexProfile | None = None
        self._snapshot: calib_mod.CalibrationSnapshot | None = None
        self._params: beam.SearchParams | None = None
        self._stats: gstats.GraphStats | None = None
        self._step_budget: dict | None = None
        self.build_stages: dict[str, float] = {}

    # ------------------------------------------------------------- build
    def build(self, vectors):
        """Stage vectors (the graph is built in finalize).  A torch tensor
        is staged through the host, as the JAX package stages the graph
        build."""
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.detach().cpu().numpy()
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self._dim:
            raise ValueError(f"expected (n, {self._dim}) float32 array, got "
                             f"{vectors.shape}")
        if len(vectors) == 0:
            raise ValueError("build requires at least one vector.")
        self._n = len(vectors)
        if self._metric == "ip":
            norms_sq = (vectors.astype(np.float64) ** 2).sum(1)
            bound_sq = float(norms_sq.max())
            self._ip_norm_bound = bound_sq
            aug = np.sqrt(np.maximum(bound_sq - norms_sq, 0.0))
            vectors = np.concatenate(
                [vectors, aug[:, None].astype(np.float32)], axis=1)
        raw = hadamard.pad_to(torch.from_numpy(vectors).to(self._device),
                              self._padded)
        self._raw = raw
        self._norm_sq = (raw * raw).sum(dim=-1)
        self._centroid = raw.mean(dim=0)
        self._node_nop = torch.linalg.vector_norm(raw - self._centroid,
                                                  dim=-1)
        self._finalized = False
        self._needs_build = True
        return self

    def _sync(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def finalize(self, verbose: bool = False):
        """Graph construction + calibration + step budget; per-stage wall
        seconds land in self.build_stages."""
        if self._n == 0:
            raise RuntimeError("Cannot finalize an empty index.")
        if not self._needs_build:
            raise RuntimeError("Finalize called without a pending build.")
        self._profile = calib_mod.IndexProfile.derive(
            self._n, self._padded, self._r, self._bits)
        res = gbuild.build_graph(
            self._raw, self._norm_sq, self._node_nop, self._signs,
            bits=self._bits, r=self._r, seed=self._seed, verbose=verbose)
        stages = dict(res.stages)
        t0 = time.perf_counter()

        def mark(name):
            nonlocal t0
            self._sync()
            now = time.perf_counter()
            stages[name] = round(now - t0, 3)
            t0 = now

        self._raw, self._norm_sq = res.raw, res.norm_sq
        self._node_nop = res.node_nop
        self._neighbors = res.neighbors
        self._entry = res.entry_point
        self._stats = res.stats
        self._entry_candidates = self._make_entry_candidates()
        self._upper = None
        if self._entry_strategy == "hnsw":
            self._upper = ul.build_upper_layers(self._raw, self._norm_sq,
                                                self._r, seed=self._seed)
            mark("upper_layers")
        n2o = np.empty(self._n, np.int64)
        n2o[res.old_to_new] = np.arange(self._n)
        self._new_to_old = n2o

        self._snapshot = calib_mod.calibrate(
            self._raw, self._norm_sq, self._neighbors, self._signs,
            self._bits, self._profile, seed=self._seed + 99999,
            verbose=verbose)
        self._params = calib_mod.to_search_params(self._snapshot,
                                                  self._device)
        mark("calibrate")
        self._derive_step_budget(verbose=verbose)
        mark("step_budget")
        self.build_stages = stages
        self._needs_build = False
        self._finalized = True
        return self

    # ------------------------------------------------------------ search
    def _require_finalized(self):
        if not self._finalized:
            raise RuntimeError("Index must be finalized before searching.")

    def _visited_hash_bits(self) -> int:
        # hash-table visited dedup above 50k nodes, table size scaling
        # with n (clamp(n/4, 2^13, 2^18) slots); dense mask below
        if self._n < 50_000:
            return 0
        return int(np.clip(np.ceil(np.log2(self._n / 4)), 13, 18))

    def _sub_batch(self) -> int:
        """Queries per beam call: the visited table ((Q, N+1) bool, or
        (Q, 2^b+1) int32 hashed) of one call stays within
        VISITED_BYTES_BUDGET."""
        hb = self._visited_hash_bits()
        per_query = 4 * ((1 << hb) + 1) if hb else self._n + 1
        return max(1, VISITED_BYTES_BUDGET // per_query)

    def _beam(self, q_dev, entry, k: int, max_steps: int, **kw):
        return beam.search_batch(
            self._raw, self._norm_sq, self._neighbors, entry, self._signs,
            q_dev, self._params, bits=self._bits, k=k,
            beam_cap=max(2 * self._r, 4 * k), max_steps=max_steps,
            expand_width=self._expand_width,
            visited_hash_bits=self._visited_hash_bits(), **kw)

    def search_batch(self, queries, k: int = 10):
        """Batch search; returns (ids (Q, k) int64 in the caller's original
        row order, dists (Q, k) f32 squared L2, or inner-product scores
        for metric='ip')."""
        self._require_finalized()
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
        max_steps = self._max_steps(k_eff)
        sub = self._sub_batch()
        ids_l, dists_l = [], []
        for s in range(0, nq, sub):
            q_dev = hadamard.pad_to(
                torch.from_numpy(queries[s:s + sub]).to(self._device),
                self._padded)
            entry = self._entry_candidates
            if self._upper is not None:
                entry = ul.greedy_descend(self._upper, self._raw,
                                          self._norm_sq, q_dev,
                                          (q_dev * q_dev).sum(dim=-1))
            ids_d, d_d = self._beam(q_dev, entry, k_eff, max_steps)
            ids_l.append(ids_d)
            dists_l.append(d_d)
        ids = torch.cat(ids_l).cpu().numpy()
        dists = torch.cat(dists_l).cpu().numpy()
        if self._metric == "ip":
            # |q'-x'|^2 = |q|^2 + M^2 - 2<q,x>  ->  <q,x>
            qn = (queries[:, :self._dim] ** 2).sum(1, keepdims=True)
            dists = np.where(dists < np.finfo(np.float32).max,
                             (qn + self._ip_norm_bound - dists) / 2.0,
                             -np.inf).astype(np.float32)
        mapped = np.where(ids >= 0, self._new_to_old[np.maximum(ids, 0)], -1)
        if k_eff < k:
            # pad with -1 / FLT_MAX (-inf for ip scores: ranked last)
            pad_val = (-np.inf if self._metric == "ip"
                       else np.finfo(np.float32).max)
            mapped = np.concatenate(
                [mapped, np.full((nq, k - k_eff), -1, np.int64)], axis=1)
            dists = np.concatenate(
                [dists, np.full((nq, k - k_eff), pad_val, np.float32)],
                axis=1)
        return mapped.astype(np.int64), dists.astype(np.float32)

    def search(self, query, k: int = 10):
        query = np.ascontiguousarray(query, dtype=np.float32)
        ids, dists = self.search_batch(query[None, :], k)
        return ids[0], dists[0]

    def _make_entry_candidates(self) -> torch.Tensor:
        """Hub entry + a fixed uniform sample: the seed-scan pool."""
        m = int(min(self._n, max(64, 4 * np.sqrt(self._n))))
        rng = np.random.default_rng(self._seed + 7)
        cand = rng.choice(self._n, size=m, replace=False)
        cand = np.unique(np.concatenate([[self._entry], cand]))
        return torch.from_numpy(cand.astype(np.int32)).to(self._device)

    def _derive_step_budget(self, verbose: bool = False):
        """Measure the step budget on this index's own data: one
        generously capped k=100 run over database rows + jittered
        synthetics, whose per-result insertion steps (BeamState.res_step)
        give, for each anchor k' in (10, 100), the first step at which a
        query's final top-k' was present; the budget is that step's 99th
        percentile."""
        rng = np.random.default_rng(self._seed + 4242)
        m = int(min(256, self._n))
        ids = rng.choice(self._n, size=m, replace=False)
        db_q = self._raw[torch.from_numpy(ids).to(self._device)].cpu().numpy()
        sigma = db_q.std(axis=0, keepdims=True)
        half = m // 2
        synth = db_q[:half] + rng.standard_normal(
            (half, db_q.shape[1])).astype(np.float32) * sigma
        queries = np.concatenate([db_q[half:], synth], axis=0)
        # the JAX package measures over its power-of-two (>= 64) query
        # bucket, padded with the last query; kept so that the budget is
        # the same number for every n
        bucket = 1 << max(6, (len(queries) - 1).bit_length())
        if bucket != len(queries):
            queries = np.concatenate(
                [queries, queries[-1:].repeat(bucket - len(queries), 0)])

        cap = 512
        k_max = min(100, self._n)
        out = self._beam(torch.from_numpy(queries).to(self._device),
                         self._entry_candidates, k_max, cap,
                         debug_state=True)
        res_step = out[2].res_step.cpu().numpy()
        budgets = {}
        for k_anchor in (10, 100):
            present = res_step[:, :min(k_anchor, k_max)].max(axis=1)
            budget = int(np.ceil(np.quantile(present, 0.99)))
            budgets[k_anchor] = int(np.clip(budget, 16, cap))
            if verbose:
                print(f"step budget k={k_anchor}: topk-present "
                      f"p50={np.quantile(present, .5):.0f} "
                      f"p99={np.quantile(present, .99):.0f} -> "
                      f"{budgets[k_anchor]}", flush=True)
        self._step_budget = budgets

    def _max_steps(self, k: int = 10) -> int:
        """Step budget for a k-NN search: log-k interpolation between the
        two measured anchors, rounded up to a multiple of 8; a
        dimension-free heuristic for files without measured budgets."""
        sb = self._step_budget
        if not sb:
            ew = max(self._expand_width, 1)
            coef = 12.0 if self._n < 300_000 else 20.0
            need = coef * np.log2(max(self._n, 2)) * (4.0 / ew) / 4.0
            return int(np.clip(need, 40, 512))
        s10, s100 = sb[10], sb[100]
        if k <= 10:
            need = s10
        elif k >= 100:
            need = s100
        else:
            need = s10 + (s100 - s10) * (np.log10(k) - 1.0)
        return int(np.clip(8 * np.ceil(need / 8.0), 16, 512))

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
            "r": self._r,
            "n": self._n,
            "rotation_seed": self._seed,
            "entry_point": self._entry,
            "metric": self._metric,
            "ip_norm_bound": self._ip_norm_bound,
            "entry_strategy": self._entry_strategy,
            "upper_levels": 0 if self._upper is None
            else len(self._upper.node_ids),
            "upper_entry": None if self._upper is None
            else int(self._upper.entry_global),
            "step_budget": self._step_budget,
            "calibration": self._snapshot.to_dict(),
            "profile": self._profile.to_dict(),
            "graph_stats": self._stats.to_dict() if self._stats else None,
        }

    def save(self, path: str | Path):
        """Header JSON + arrays in one npz, the JAX package's format."""
        self._require_finalized()
        arrays = dict(
            raw=self._raw.cpu().numpy(),
            norm_sq=self._norm_sq.cpu().numpy(),
            node_nop=self._node_nop.cpu().numpy(),
            centroid=self._centroid.cpu().numpy(),
            new_to_old=self._new_to_old,
            entry_candidates=self._entry_candidates.cpu().numpy(),
            nbr_ids=self._neighbors.ids.cpu().numpy(),
            nbr_planes=self._neighbors.planes.contiguous().cpu().numpy()
            .view(np.uint32),
            nbr_aux=self._neighbors.aux.cpu().numpy(),
        )
        if self._upper is not None:
            for i in range(len(self._upper.node_ids)):
                arrays[f"upper_ids_{i}"] = self._upper.node_ids[i].cpu().numpy()
                arrays[f"upper_nbr_{i}"] = self._upper.nbr_idx[i].cpu().numpy()
                arrays[f"upper_lm_{i}"] = \
                    self._upper.local_of_global[i].cpu().numpy()
        np.savez_compressed(
            path,
            header=np.frombuffer(
                json.dumps(self._header(), default=_jsonable).encode(),
                dtype=np.uint8),
            **arrays,
        )

    def _check_header(self, header: dict):
        if header.get("magic") != MAGIC:
            raise ValueError("Not a CPHNSW-TPU index file.")
        if header.get("version") != VERSION:
            raise ValueError(
                f"Unsupported index file version {header.get('version')}")
        if header["dim"] != self._dim:
            raise ValueError(f"Index file dim={header['dim']} mismatches "
                             f"dim={self._dim}")
        if header["bits"] != self._bits or header["r"] != self._r:
            raise ValueError("Index file bits/R parameters mismatch.")
        if header["rotation_seed"] != self._seed:
            raise ValueError("Index file rotation seed mismatch.")
        if header["metric"] != self._metric:
            raise ValueError(f"Index file metric={header['metric']!r} "
                             f"mismatches constructor metric="
                             f"{self._metric!r}")

    def load(self, path: str | Path):
        """Restore a saved index; validates magic/version/dim/bits/R, the
        rotation seed and the metric before committing anything."""
        with np.load(path) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            self._check_header(header)
            arrays = {key: np.asarray(z[key]) for key in z.files
                      if key != "header"}
        return self.load_state(header, arrays)

    def load_state(self, header: dict, arrays: dict):
        """Install an index from its header fields and host numpy arrays
        (the keys ``save`` writes): the state of a saved file, or of a
        JAX-package index."""
        self._check_header(header)
        dev = self._device
        neighbors = NeighborStore.pack(
            _tensor(arrays["nbr_ids"], dev, np.int32),
            _tensor(np.ascontiguousarray(arrays["nbr_planes"],
                                         np.uint32).view(np.int32), dev),
            _tensor(arrays["nbr_aux"], dev, np.float32))
        upper = None
        levels = header.get("upper_levels", 0)
        if levels > 0:
            upper = ul.UpperLayers(
                node_ids=tuple(_tensor(arrays[f"upper_ids_{i}"], dev,
                                       np.int32) for i in range(levels)),
                nbr_idx=tuple(_tensor(arrays[f"upper_nbr_{i}"], dev,
                                      np.int32) for i in range(levels)),
                local_of_global=tuple(_tensor(arrays[f"upper_lm_{i}"], dev,
                                              np.int32)
                                      for i in range(levels)),
                entry_global=int(header["upper_entry"]),
            )
        self._n = int(header["n"])
        if header["padded"] != self._padded:
            # regenerate the rotation for the file's padded dim (same seed)
            self._padded = int(header["padded"])
            self._signs = hadamard.rotation_signs(self._seed,
                                                  self._padded).to(dev)
        self._entry = int(header["entry_point"])
        self._ip_norm_bound = header.get("ip_norm_bound")
        self._entry_strategy = header.get("entry_strategy", "seed")
        sb = header.get("step_budget")
        self._step_budget = ({int(kk): int(vv) for kk, vv in sb.items()}
                             if sb else None)
        self._upper = upper
        gs = header.get("graph_stats")
        self._stats = gstats.GraphStats.from_dict(gs) if gs else None
        self._neighbors = neighbors
        self._raw = _tensor(arrays["raw"], dev, np.float32)
        self._norm_sq = _tensor(arrays["norm_sq"], dev, np.float32)
        self._node_nop = _tensor(arrays["node_nop"], dev, np.float32)
        self._centroid = _tensor(arrays["centroid"], dev, np.float32)
        self._new_to_old = np.asarray(arrays["new_to_old"], np.int64)
        self._entry_candidates = _tensor(arrays["entry_candidates"], dev,
                                         np.int32)
        self._snapshot = calib_mod.CalibrationSnapshot.from_dict(
            header["calibration"])
        self._profile = calib_mod.IndexProfile.from_dict(header["profile"])
        self._params = calib_mod.to_search_params(self._snapshot, dev)
        self._finalized = True
        self._needs_build = False
        return self


class CPIndex:
    """Index facade: build / finalize / search / search_batch / save /
    load / size / dim / is_finalized on `device` (default "cuda")."""

    _ENGINES = ("auto", "scan", "graph")

    def __init__(self, dim: int, bits: int = 1, engine: str = "auto",
                 metric: str = "l2", device="cuda"):
        if dim <= 0:
            raise ValueError("dim must be > 0")
        if bits not in (1, 2, 4):
            raise ValueError("bits must be one of {1, 2, 4}")
        if engine not in self._ENGINES:
            raise ValueError(f"engine must be one of {self._ENGINES}")
        if metric not in ("l2", "ip"):
            raise ValueError("metric must be 'l2' or 'ip'")
        self._dim = dim
        self._bits = bits
        self._engine_req = engine
        self._metric = metric
        self._device = scan_index.resolve_device(device)
        self._index: ScanIndex | Index | None = None

    def _make_engine(self, name: str):
        cls = ScanIndex if name == "scan" else Index
        return cls(self._dim, self._bits, metric=self._metric,
                   device=self._device)

    @property
    def engine(self) -> str | None:
        """The resolved engine name ('scan' or 'graph'), None before
        build/load."""
        if self._index is None:
            return None
        return "graph" if isinstance(self._index, Index) else "scan"

    def build(self, vectors):
        # auto: the scan at every single-device scale
        name = "scan" if self._engine_req == "auto" else self._engine_req
        if self.engine != name:
            self._index = self._make_engine(name)
        self._index.build(vectors)

    def finalize(self):
        if self._index is None:
            raise RuntimeError("Finalize called without a pending build.")
        self._index.finalize()

    def search(self, query, k: int = 10):
        self._require_index()
        ids, dists = self._index.search(np.asarray(query), k)
        return ids.astype(np.int64), dists.astype(np.float32)

    def search_batch(self, queries, k: int = 10):
        self._require_index()
        ids, dists = self._index.search_batch(np.asarray(queries), k)
        return ids.astype(np.int64), dists.astype(np.float32)

    def save(self, path: str):
        self._require_index()
        self._index.save(path)

    def load(self, path: str):
        magic = _peek_header(path).get("magic")
        if magic == scan_index.MAGIC:
            name = "scan"
        elif magic == MAGIC:
            name = "graph"
        else:
            raise ValueError("Not a CPHNSW-TPU index file.")
        if self._engine_req != "auto" and name != self._engine_req:
            raise ValueError(f"Index file engine={name!r} mismatches "
                             f"requested engine={self._engine_req!r}")
        if self.engine != name:
            self._index = self._make_engine(name)
        self._index.load(path)

    def _require_index(self):
        if self._index is None:
            raise RuntimeError("Index must be finalized before searching.")

    @property
    def size(self) -> int:
        return 0 if self._index is None else self._index.size

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def is_finalized(self) -> bool:
        return self._index is not None and self._index.is_finalized


def _peek_header(path) -> dict:
    """Read just the header JSON of a saved index npz."""
    with np.load(path) as z:
        if "header" not in z:
            raise ValueError("Not a CPHNSW-TPU index file.")
        return json.loads(bytes(z["header"].tobytes()).decode())
