"""Dataset loaders (fvecs/ivecs, npy sets) and the synthetic generator.

PyTorch-side counterpart of ``cphnsw_tpu/utils/datasets.py``.  The
synthetic data follow the JAX package's host numpy recipe, so the same
seed gives bit-identical base and query vectors.  Ground truth is the
same host numpy computation by default; ``gt_device`` computes it on a
torch device instead, by chunked fp32 products with TF32 off (the host
computation does not scale to a million rows and thousands of queries).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from cphnsw_tpu_torch.ops.estimate import full_fp32

FVECS_DATASETS = {
    "sift1m": {
        "base": "sift_base.fvecs",
        "queries": "sift_query.fvecs",
        "groundtruth": "sift_groundtruth.ivecs",
    },
    "gist1m": {
        "base": "gist_base.fvecs",
        "queries": "gist_query.fvecs",
        "groundtruth": "gist_groundtruth.ivecs",
    },
}

NPY_DATASETS = {"openai1536", "msmarco10m", "deep10m"}

ALL_DATASETS = list(FVECS_DATASETS.keys()) + sorted(NPY_DATASETS)


def read_fvecs(path: Path) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.float32)
    dim = raw[:1].view(np.int32)[0]
    return raw.reshape(-1, dim + 1)[:, 1:].copy()


def read_ivecs(path: Path) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    k = int(raw[0])
    return raw.reshape(-1, k + 1)[:, 1:].copy()


def load_dataset(name: str, base_dir: Path, gt_device=None) -> dict:
    """A dataset by name: fvecs or npy files under base_dir/name, or a
    synthetic set (ground truth on `gt_device` if given)."""
    base_path = Path(base_dir) / name
    if name in FVECS_DATASETS:
        files = FVECS_DATASETS[name]
        base = read_fvecs(base_path / files["base"])
        queries = read_fvecs(base_path / files["queries"])
        groundtruth = read_ivecs(base_path / files["groundtruth"])
    elif name in NPY_DATASETS:
        base = np.load(base_path / "base.npy").astype(np.float32)
        queries = np.load(base_path / "queries.npy").astype(np.float32)
        groundtruth = np.load(base_path / "groundtruth.npy").astype(np.int32)
    elif name.startswith("synthetic"):
        return make_synthetic(name, gt_device=gt_device)
    else:
        raise ValueError(f"Unknown dataset: {name}")
    return {
        "base": base,
        "queries": queries,
        "groundtruth": groundtruth,
        "dim": base.shape[1],
    }


def _host_groundtruth(base, queries, gt_k: int, metric: str) -> np.ndarray:
    gt = np.empty((len(queries), gt_k), dtype=np.int32)
    bs = 256
    for s in range(0, len(queries), bs):
        q = queries[s : s + bs]
        if metric == "ip":
            d = -(q @ base.T)
        else:
            d = (
                (q**2).sum(1)[:, None]
                - 2.0 * q @ base.T
                + (base**2).sum(1)[None, :]
            )
        part = np.argpartition(d, gt_k, axis=1)[:, :gt_k]
        order = np.argsort(np.take_along_axis(d, part, axis=1), axis=1)
        gt[s : s + bs] = part[np.arange(len(q))[:, None], order]
    return gt


def device_groundtruth(base, queries, gt_k: int, metric: str = "l2",
                       device="cuda", row_chunk: int = 1 << 19,
                       q_block: int = 1024) -> np.ndarray:
    """Exact top-gt_k ids by chunked fp32 products on `device` (TF32 off),
    with a running top-k merge across row chunks."""
    base_d = torch.as_tensor(base, dtype=torch.float32).to(device)
    n = base_d.shape[0]
    norms = (base_d * base_d).sum(dim=1)
    gt = np.empty((len(queries), gt_k), dtype=np.int32)
    for s in range(0, len(queries), q_block):
        qb = torch.as_tensor(queries[s:s + q_block],
                             dtype=torch.float32).to(device)
        qn = (qb * qb).sum(dim=1)
        best_neg = best_ids = None
        for c in range(0, n, row_chunk):
            with full_fp32():
                dots = qb @ base_d[c:c + row_chunk].T
            if metric == "ip":
                d = -dots
            else:
                d = qn[:, None] + norms[None, c:c + row_chunk] - 2.0 * dots
            neg, idx = torch.topk(-d, min(gt_k, d.shape[1]), dim=1)
            ids = idx + c
            if best_neg is not None:
                neg = torch.cat([best_neg, neg], dim=1)
                ids = torch.cat([best_ids, ids], dim=1)
                neg, keep = torch.topk(neg, gt_k, dim=1)
                ids = ids.gather(1, keep)
            best_neg, best_ids = neg, ids
        gt[s:s + q_block] = best_ids.cpu().numpy()
    return gt


def synthetic_shape(name: str, n: int = 100_000,
                    dim: int = 128) -> tuple[int, int, str]:
    """(n, dim, metric) a synthetic dataset name encodes, e.g.
    "synthetic-1m-128d" or "synthetic-100k-1536d-ip"; n and dim default
    to the given values where the name leaves them out."""
    metric = "l2"
    for p in name.split("-")[1:]:
        if p == "ip":
            metric = "ip"
        elif p.endswith("k"):
            n = int(float(p[:-1]) * 1000)
        elif p.endswith("m"):
            n = int(float(p[:-1]) * 1_000_000)
        elif p.endswith("d"):
            dim = int(p[:-1])
    return n, dim, metric


def make_synthetic(name: str = "synthetic", n: int = 100_000,
                   dim: int = 128, n_queries: int = 1000, gt_k: int = 100,
                   n_clusters: int = 256, seed: int = 0,
                   gt_device=None) -> dict:
    """Clustered gaussian data with exact ground truth.

    `name` may encode size (``synthetic_shape``).  Base and queries come
    from the JAX package's host numpy recipe (bit-identical for the same
    seed); the ground truth is computed on the host, or on `gt_device` if
    given."""
    n, dim, metric = synthetic_shape(name, n, dim)
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3.0
    base = centers[rng.integers(0, n_clusters, n)] + rng.standard_normal(
        (n, dim)
    ).astype(np.float32)
    qi = rng.choice(n, n_queries, replace=False)
    queries = base[qi] + 0.1 * rng.standard_normal((n_queries, dim)).astype(
        np.float32
    )
    if gt_device is None:
        gt = _host_groundtruth(base, queries, gt_k, metric)
    else:
        gt = device_groundtruth(base, queries, gt_k, metric, gt_device)
    return {
        "base": base,
        "queries": queries,
        "groundtruth": gt,
        "dim": dim,
        "metric": metric,
    }
