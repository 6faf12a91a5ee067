"""Dataset loaders (fvecs/ivecs, npy sets) and the synthetic generator.

PyTorch-side counterpart of ``cphnsw_tpu/utils/datasets.py``.  Synthetic
data follow the JAX package's two recipes, so the same seed gives the same
base and query vectors: the host numpy recipe (bit-identical), and, for a
store of at least DEVICE_DATA_MIN_ELEMENTS elements on a CUDA device, the
JAX package's accelerator recipe drawn from JAX's Threefry stream on the
card (``_device_synthetic``: integer draws equal, normals within a few
ulps of ``jax.random`` on the CPU).  Ground truth is the host numpy
computation by default; ``gt_device`` computes it on a torch device
instead, by chunked fp32 products with TF32 off (the host computation does
not scale to a million rows and thousands of queries).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from cphnsw_tpu_torch.ops import threefry
from cphnsw_tpu_torch.ops.estimate import full_fp32

# Synthetic stores from this many elements (n * dim) up are generated on a
# CUDA device from JAX's Threefry stream, as the JAX package generates them
# on its accelerator: the JAX package's threshold.
DEVICE_DATA_MIN_ELEMENTS = 64 << 20

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


def _device_synthetic(n: int, dim: int, n_queries: int, n_clusters: int,
                      seed: int, device):
    """The JAX package's accelerator recipe (``_device_synthetic`` there) on
    `device`: from ``split(PRNGKey(seed), 5)``, normal centres * 3, a
    randint cluster per row, base = centre + normal noise, queries = the
    rows of a permutation's first n_queries + 0.1 * normal noise.  Returns
    (base (n, dim) f32 tensor on `device`, queries (n_queries, dim) numpy
    f32)."""
    kc, ka, kn, kq, kqn = threefry.split(threefry.prng_key(seed), 5)
    centers = threefry.normal(kc, (n_clusters, dim), device) * 3.0
    base = centers[threefry.randint(ka, n, 0, n_clusters, device)]
    base += threefry.normal(kn, (n, dim), device)
    qi = threefry.permutation(kq, n, device)[:n_queries]
    queries = base[qi] + 0.1 * threefry.normal(kqn, (n_queries, dim), device)
    return base, queries.cpu().numpy()


def make_synthetic(name: str = "synthetic", n: int = 100_000,
                   dim: int = 128, n_queries: int = 1000, gt_k: int = 100,
                   n_clusters: int = 256, seed: int = 0,
                   gt_device=None) -> dict:
    """Clustered gaussian data with exact ground truth.

    `name` may encode size (``synthetic_shape``).  On a CUDA `gt_device`,
    a store of at least DEVICE_DATA_MIN_ELEMENTS elements is drawn there
    from JAX's Threefry stream (``_device_synthetic``), its ground truth
    computed there, and the result also holds ``base_dev_factory``, which
    draws the store on the device again (a store kept alive beside a built
    index would double its footprint).  Otherwise base and queries come
    from the host numpy recipe (bit-identical for the same seed) and the
    ground truth is computed on the host, or on `gt_device` if given."""
    n, dim, metric = synthetic_shape(name, n, dim)
    dev = None if gt_device is None else torch.device(gt_device)
    if (dev is not None and dev.type == "cuda"
            and n * dim >= DEVICE_DATA_MIN_ELEMENTS):
        base_dev, queries = _device_synthetic(n, dim, n_queries, n_clusters,
                                              seed, dev)
        gt = device_groundtruth(base_dev, queries, gt_k, metric, dev)

        def base_dev_factory():
            return _device_synthetic(n, dim, n_queries, n_clusters, seed,
                                     dev)[0]

        return {
            "base": base_dev.cpu().numpy(),
            "queries": queries,
            "groundtruth": gt,
            "dim": dim,
            "metric": metric,
            "base_dev_factory": base_dev_factory,
        }
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
