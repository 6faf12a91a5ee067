"""Dataset loaders (fvecs/ivecs, npy sets) and the synthetic generator.

PyTorch-side counterpart of ``cphnsw_tpu/utils/datasets.py``.  Synthetic
data follow the JAX package's two recipes, so the same seed gives the same
base and query vectors: the host numpy recipe (bit-identical), and, for a
store of at least DEVICE_DATA_MIN_ELEMENTS elements, the JAX package's
accelerator recipe drawn from JAX's Threefry stream on the card
(``_device_synthetic``: bit-equal to ``jax.random`` on the CPU), as the
JAX package draws such a store on its accelerator.  Ground truth of a
smaller store is the host numpy computation by default; ``gt_device``
computes it on a torch device instead, by chunked fp32 products with TF32
off (the host computation does not scale to a million rows and thousands
of queries).  ``make_synthetic`` keeps each set in a file on disk, as the
JAX package does and, for the host recipe, in the same file.
"""

from __future__ import annotations

import os
import tempfile
import zipfile
from pathlib import Path

import numpy as np
import torch

from cphnsw_tpu_torch.api.scan_index import resolve_device
from cphnsw_tpu_torch.ops import threefry
from cphnsw_tpu_torch.ops.estimate import full_fp32

# Synthetic stores from this many elements (n * dim) up are generated on a
# CUDA device from JAX's Threefry stream, as the JAX package generates them
# on its accelerator: the JAX package's threshold.
DEVICE_DATA_MIN_ELEMENTS = 64 << 20
# Where make_synthetic keeps its sets by default: the JAX package's
# directory name under the system's temporary directory (TMPDIR is honoured),
# so that the host recipe's files are shared where both packages run with
# the same temporary directory, and two runs given their own stay apart.
DEFAULT_CACHE_DIR = str(Path(tempfile.gettempdir()) / "cphnsw_synth_cache")
# Part of the device recipe's cache key: raise it whenever a change to
# ops/threefry.py or ops/rounding.py changes a bit of what that recipe draws.
DEVICE_GENERATOR_VERSION = 2

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
    synthetic set through ``make_synthetic`` with its defaults (a store of
    at least DEVICE_DATA_MIN_ELEMENTS on the card unless `gt_device` says
    otherwise; cached under its default directory, as in the JAX
    package)."""
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


def _read_cache(cpath: Path | None) -> dict | None:
    """The four arrays of a cache file, or None where there is no file or
    it cannot be read (another process may be writing one in place)."""
    if cpath is None or not cpath.exists():
        return None
    try:
        with np.load(cpath) as z:
            return {"base": z["base"], "queries": z["queries"],
                    "groundtruth": z["groundtruth"], "dim": int(z["dim"])}
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def _write_cache(cpath: Path | None, data: dict) -> None:
    """Write the cache file under a temporary name in its directory, then
    rename it: a reader sees the whole file or none, also when two
    processes draw the same set."""
    if cpath is None:
        return
    cpath.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cpath.parent, prefix=cpath.stem,
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, base=data["base"], queries=data["queries"],
                     groundtruth=data["groundtruth"], dim=data["dim"])
        os.replace(tmp, cpath)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def make_synthetic(name: str = "synthetic", n: int = 100_000,
                   dim: int = 128, n_queries: int = 1000, gt_k: int = 100,
                   n_clusters: int = 256, seed: int = 0,
                   cache_dir: str | None = DEFAULT_CACHE_DIR,
                   gt_device=None) -> dict:
    """Clustered gaussian data with exact ground truth.

    `name` may encode size (``synthetic_shape``).  A store of at least
    DEVICE_DATA_MIN_ELEMENTS elements goes by default (`gt_device` None)
    to the card, "cuda", as the JAX package draws it on its accelerator;
    without CUDA that default raises before anything is drawn, and
    ``gt_device="cpu"`` asks for the host recipe instead.  On a CUDA
    `gt_device` such a store is drawn there from JAX's Threefry stream
    (``_device_synthetic``), its ground truth computed there, and the
    result also holds ``base_dev_factory``, which draws the store on the
    device again (a store kept alive beside a built index would double its
    footprint).  Otherwise base and queries come from the host numpy
    recipe (bit-identical for the same seed) and the ground truth is
    computed on the host, or on `gt_device` if given.

    The four arrays (base, queries, groundtruth, dim) are cached in one
    ``.npz`` under `cache_dir`, keyed by every parameter; None turns the
    cache off.  The host recipe's key and file are the JAX package's own,
    so each package reads the other's.  The device recipe's key ends in
    ``-dev-torch<DEVICE_GENERATOR_VERSION>``: the JAX package's ``-dev``
    files hold what its own accelerator drew, which this generator is not
    proven to reproduce bit for bit, so they are never read, and neither
    is a file that an earlier version of this generator wrote."""
    n, dim, metric = synthetic_shape(name, n, dim)
    key = f"{name}-{n}-{dim}-{n_queries}-{gt_k}-{n_clusters}-{seed}"
    if gt_device is None and n * dim >= DEVICE_DATA_MIN_ELEMENTS:
        gt_device = resolve_device("cuda")
    dev = None if gt_device is None else torch.device(gt_device)
    use_device = (dev is not None and dev.type == "cuda"
                  and n * dim >= DEVICE_DATA_MIN_ELEMENTS)
    if use_device:
        key += f"-dev-torch{DEVICE_GENERATOR_VERSION}"
    cpath = Path(cache_dir) / f"{key}.npz" if cache_dir else None
    data = _read_cache(cpath)
    if data is None:
        if use_device:
            base_dev, queries = _device_synthetic(n, dim, n_queries,
                                                  n_clusters, seed, dev)
            gt = device_groundtruth(base_dev, queries, gt_k, metric, dev)
            base = base_dev.cpu().numpy()
            del base_dev
        else:
            rng = np.random.default_rng(seed)
            centers = rng.standard_normal((n_clusters, dim)).astype(
                np.float32) * 3.0
            base = centers[rng.integers(0, n_clusters, n)] + \
                rng.standard_normal((n, dim)).astype(np.float32)
            qi = rng.choice(n, n_queries, replace=False)
            queries = base[qi] + 0.1 * rng.standard_normal(
                (n_queries, dim)).astype(np.float32)
            if gt_device is None:
                gt = _host_groundtruth(base, queries, gt_k, metric)
            else:
                gt = device_groundtruth(base, queries, gt_k, metric,
                                        gt_device)
        data = {"base": base, "queries": queries, "groundtruth": gt,
                "dim": dim}
        _write_cache(cpath, data)
    data["metric"] = metric
    if use_device:
        def base_dev_factory():
            return _device_synthetic(n, dim, n_queries, n_clusters, seed,
                                     dev)[0]

        data["base_dev_factory"] = base_dev_factory
    return data
