"""Graph-free RaBitQ brute-force scan: the minimum end-to-end slice.

PyTorch counterpart of ``cphnsw_tpu/search/bruteforce.py``.  Every
query's calibrated RaBitQ estimate to ALL database codes comes from one
exact int8 product (``scan.int8_product``), the top_c candidates by
estimate get the exact L2 rerank of their gathered rows.  Every node's
parent is the dataset centroid, so the per-node constants are the global
code (nop, ip_qo) plus ip_cp against the rotated centroid.  Unlike
``ScanIndex`` it keeps the (Q, N) estimate matrix whole: a small,
parameter-free reference path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cphnsw_tpu_torch.api.scan_index import resolve_device
from cphnsw_tpu_torch.calibration import huber
from cphnsw_tpu_torch.ops import estimate, hadamard, quantize
from cphnsw_tpu_torch.ops.estimate import full_fp32
from cphnsw_tpu_torch.search import scan


class BruteForceStore(NamedTuple):
    """Device-resident state of the graph-free scan."""

    raw: torch.Tensor        # (N, P) zero-padded raw vectors
    norm_sq: torch.Tensor    # (N,)
    codes_u: torch.Tensor    # (N, P) int8 code levels
    nop: torch.Tensor        # (N,)
    ip_qo: torch.Tensor      # (N,)
    ip_cp: torch.Tensor      # (N,) <c_bar, rot(centroid)> / sqrt(P)
    wpc: torch.Tensor        # (N,) int32 weighted popcounts
    centroid: torch.Tensor   # (P,)
    signs: torch.Tensor      # (3, P)


def build_store(vectors, bits: int,
                seed: int = hadamard.DEFAULT_ROTATION_SEED,
                device="cuda") -> BruteForceStore:
    """Encode (N, dim) vectors (numpy or tensor) on `device`."""
    dev = resolve_device(device)
    raw = torch.as_tensor(vectors, dtype=torch.float32).to(dev)
    p = hadamard.next_pow2(raw.shape[1])
    signs = hadamard.rotation_signs(seed, p).to(dev)
    raw = hadamard.pad_to(raw, p)
    centroid = quantize.compute_centroid(raw)
    enc = quantize.encode_vectors(raw, centroid, signs, bits)
    kappa = float((1 << bits) - 1)
    cbar = (2.0 * enc.u.float() - kappa) / kappa
    with full_fp32():
        ip_cp = (cbar @ hadamard.rotate(centroid, signs)) / scan._sqrt_f32(p)
    return BruteForceStore(
        raw=raw, norm_sq=(raw * raw).sum(dim=-1),
        codes_u=enc.u.to(torch.int8), nop=enc.nop, ip_qo=enc.ip_qo,
        ip_cp=ip_cp, wpc=enc.u.sum(dim=-1, dtype=torch.int32),
        centroid=centroid, signs=signs)


def store_from_arrays(arrays, device="cuda") -> BruteForceStore:
    """A store from host arrays with the BruteForceStore fields, e.g. the
    JAX package's ``BruteForceStore`` converted field by field with
    ``np.asarray``."""
    dev = resolve_device(device)
    return BruteForceStore(*(
        torch.from_numpy(np.array(a)).to(dev) for a in arrays))


def search(store: BruteForceStore, queries: torch.Tensor,
           calib: estimate.CalibParams, bits: int, k: int, top_c: int):
    """Scan + rerank of (Q, dim) queries on the store's device; returns
    (ids (Q, k) int64, squared L2 dists (Q, k) f32), ascending."""
    p = store.signs.shape[-1]
    qpad = hadamard.pad_to(queries.to(store.raw.device, torch.float32), p)
    qc = quantize.encode_queries(qpad, store.signs)
    fs = scan.int8_product(qc.q_u.to(torch.int8), store.codes_u)  # (Q, N)
    ip_approx = estimate.ip_from_fastscan(
        fs, store.wpc[None, :], qc.coeff_a[:, None], qc.coeff_b[:, None],
        qc.coeff_c[:, None], float((1 << bits) - 1))
    dist_qc_sq = ((qpad - store.centroid) ** 2).sum(dim=-1)
    est, _ = estimate.distances_with_bounds(
        ip_approx, ip_approx, store.nop[None, :], store.ip_qo[None, :],
        store.ip_cp[None, :], dist_qc_sq[:, None], calib)
    cand_ids = torch.topk(est, top_c, dim=1, largest=False)[1]
    exact = estimate.exact_l2_sq(qpad, (qpad * qpad).sum(dim=-1),
                                 store.raw[cand_ids], store.norm_sq[cand_ids])
    d, idx = torch.topk(exact, k, dim=1, largest=False)
    return cand_ids.gather(1, idx), d


def calibrate_affine(store: BruteForceStore, bits: int,
                     num_samples: int = 2000,
                     seed: int = 99999) -> estimate.CalibParams:
    """Affine estimator correction: database rows as queries against
    random rows, the raw estimator ratio Huber-fitted to the true
    <q - c, (x - c) / |x - c|>, and ip_qo_floor from the MAD lower
    fence."""
    n = store.raw.shape[0]
    rng = np.random.default_rng(seed)
    n_s = min(num_samples, n)
    q_ids = rng.choice(n, size=n_s, replace=False)
    x_ids = rng.integers(0, n, size=n_s)
    dev = store.raw.device
    q_t = torch.from_numpy(q_ids).to(dev)
    x_t = torch.from_numpy(x_ids).to(dev)

    qvecs = store.raw[q_t]
    qc = quantize.encode_queries(qvecs, store.signs)
    fs = (qc.q_u * store.codes_u[x_t].int()).sum(dim=-1, dtype=torch.int32)
    ip_approx = estimate.ip_from_fastscan(
        fs, store.wpc[x_t], qc.coeff_a, qc.coeff_b, qc.coeff_c,
        float((1 << bits) - 1)).cpu().numpy()
    ip_qo = store.ip_qo[x_t].cpu().numpy()
    ip_cp = store.ip_cp[x_t].cpu().numpy()
    nop = store.nop[x_t].cpu().numpy()

    centroid = store.centroid.cpu().numpy()
    xvecs = store.raw[x_t].cpu().numpy()
    qv = qvecs.cpu().numpy()
    true_ip = ((qv - centroid) * (xvecs - centroid)).sum(-1) / np.maximum(
        nop, 1e-12)

    ip_qo_floor = huber.mad_lower_fence(np.abs(ip_qo))
    denom = np.maximum(np.abs(ip_qo), ip_qo_floor)
    raw_est = (ip_approx - ip_cp) / denom
    good = nop > 1e-6
    a, b, _ = huber.fit_affine_huber(raw_est[good], true_ip[good])
    return estimate.CalibParams(affine_a=float(a), affine_b=float(b),
                                ip_qo_floor=float(ip_qo_floor),
                                dot_slack=0.0)


class BruteForceIndex:
    """Facade of the graph-free slice on `device` (default "cuda")."""

    def __init__(self, dim: int, bits: int = 1, device="cuda"):
        self.dim = dim
        self.bits = bits
        self.device = resolve_device(device)
        self.store: BruteForceStore | None = None
        self.calib: estimate.CalibParams | None = None

    def build(self, vectors):
        self.store = build_store(vectors, self.bits, device=self.device)
        self.calib = calibrate_affine(self.store, self.bits)
        return self

    def search_batch(self, queries: np.ndarray, k: int = 10,
                     top_c: int | None = None):
        """(ids (Q, k) int64, squared L2 dists (Q, k) f32) as numpy;
        top_c candidates by estimate (default max(4k, 100)) are
        reranked."""
        if top_c is None:
            top_c = max(4 * k, 100)
        top_c = min(top_c, self.store.raw.shape[0])
        k = min(k, top_c)
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
        ids, dists = search(self.store, q, self.calib, self.bits, k, top_c)
        return ids.cpu().numpy(), dists.cpu().numpy()
