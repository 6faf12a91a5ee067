"""Full-database scan: store layout, calibration, candidate budget, search.

PyTorch counterpart of ``cphnsw_tpu/search/scan.py``.  The estimator
algebra is unchanged: per query, the calibrated distance estimate is an
affine function of fs = <codes_u, q_u>, folded into

    score = (w_fs * g) * fs + sum_{a<5} y_aux[a] * node_aux[a]

so one int8 contraction plus a rank-5 node-constant term ranks every row
(``fold_node_constants`` / ``_query_side``).  ``scan_search`` has the JAX
package's three selections:

  * fused (the default, and what every index runs): the fused scan+select
    kernel (``kernels/scan_keys.py``) streams either the int8 rerank sketch
    (sketch mode: ``SKETCH_SCAN_MIN_C = 0``) or the unpacked RaBitQ codes
    (estimate mode) and keeps each bin's four smallest keys;
  * chunked (``fused=False``, the JAX package's path off the TPU): per
    chunk of rows, an int8 product, the score in the kernel's rounding
    order and each bin's two smallest keys (``_binned_keys``), decoded
    through per-bin base and stride tables;
  * exact (``exact_select=True``): the exact top_c of every chunk.

Each decodes its keys to row ids and reranks them with exact f32
distances, two-stage through a bf16 or int8 sketch above
``TWO_STAGE_MIN_C`` candidates.  Keys stay signed int32 throughout (the
JAX package's chunked path maps them to u32; the order is the same).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cphnsw_tpu_torch.calibration import huber
from cphnsw_tpu_torch.kernels.scan_keys import (
    GROUP_MASK, I32_MAX, NOT_GROUP, PAD_SCORE, folded_scores, fused_bin_plan,
    fused_scan_keys, signed_keys)
from cphnsw_tpu_torch.ops import estimate, hadamard, pack, quantize
from cphnsw_tpu_torch.ops.estimate import full_fp32
from cphnsw_tpu_torch.ops.quantize import EPS_MEDIUM

FLOAT_MAX = float(torch.finfo(torch.float32).max)
# Score-buffer budget (Q * rows) per chunk of the chunked and exact
# selections, of the top_c clamp and of the budget derivation's exact top-k.
CHUNK_ELEMENTS = 1 << 28
MIN_CHUNK = 1 << 15
# rows per encode step (bounds the CAQ intermediates during build)
ENCODE_CHUNK = 1 << 17
# Chunked selection: each chunk's bins keep their two smallest keys, over
# BIN_FACTOR * top_c bins in all (at least BINS_MIN), so a candidate at the
# deepest needed rank is lost with ~(1/BIN_FACTOR)^2 / 2 ~ 0.8%.
BIN_FACTOR = 8
BINS_MIN = 2048
# Gathered-candidate f32 elements per rerank piece (Q * piece * P).
RERANK_ELEMENTS = 1 << 28
# Candidate count above which the rerank goes two-stage through a sketch.
TWO_STAGE_MIN_C = 4096
# The sketch is bf16 while the raw store is at most this large, else int8.
BF16_SKETCH_MAX_RAW_BYTES = 3 << 30
# Candidate budget from which search streams the int8 sketch through the
# kernel instead of the packed codes: 0 = always (the sketch scan costs
# the same kernel pass and its near-exact stage 1 keeps recall).
SKETCH_SCAN_MIN_C = 0


class ScanArrays(NamedTuple):
    """Device-resident folded constants for the scan."""

    planes: torch.Tensor     # (N_pad, B, W) int32 packed code bit-planes
    node_aux: torch.Tensor   # (6, N_pad) f32: [nop^2(+pad), nop, g*wpc, g, g*ip_cp, g]
    raw: torch.Tensor        # (N_pad, P) f32 zero-padded raw vectors
    norm_sq: torch.Tensor    # (N_pad,)


class RerankSketch(NamedTuple):
    """Reduced-precision stage-1 rerank store: (N_pad, P) bf16 with the raw
    store's squared norms and scale None, or int8 codes with per-dimension
    scales (P,) f32 and the squared norms of the sketch points."""

    store: torch.Tensor
    norm_sq: torch.Tensor
    scale: torch.Tensor | None


def _sqrt_f32(p: int) -> float:
    """sqrt(P) rounded to f32, as the JAX package divides by it."""
    return float(np.sqrt(np.float32(p)))


# --------------------------------------------------------------- store
def pad_store_and_norms(v: torch.Tensor, rows: int, cols: int):
    """Zero-pad (n, d) -> (rows, cols) f32 and compute row norms."""
    raw = torch.nn.functional.pad(
        v.float(), (0, cols - v.shape[1], 0, rows - v.shape[0]))
    return raw, (raw * raw).sum(dim=-1)


def store_pad(n: int) -> int:
    """Rows the store is padded to: next multiple of 256 (a small dead
    region keeps the binned selection's winners spread over all bins)."""
    return -(-n // 256) * 256


def encode_scan_store(raw, centroid, signs, bits: int,
                      chunk: int = ENCODE_CHUNK):
    """Encode a padded raw store: (planes, nop, ip_qo, ip_cp, wpc) for all
    raw.shape[0] rows (pad rows are priced out by fold_node_constants)."""
    rot_centroid = hadamard.rotate(centroid, signs)
    kappa = float((1 << bits) - 1)
    sqrt_p = _sqrt_f32(raw.shape[1])
    planes_l, nops, qos, cps, wpcs = [], [], [], [], []
    for s in range(0, raw.shape[0], chunk):
        enc = quantize.encode_vectors(raw[s:s + chunk], centroid, signs, bits)
        cbar = (2.0 * enc.u.float() - kappa) / kappa
        with full_fp32():
            ip_cp = (cbar @ rot_centroid) / sqrt_p
        planes_l.append(pack.pack_planes(enc.u, bits))
        nops.append(enc.nop)
        qos.append(enc.ip_qo)
        cps.append(ip_cp)
        wpcs.append(enc.u.sum(dim=-1, dtype=torch.int32))
    return (torch.cat(planes_l), torch.cat(nops), torch.cat(qos),
            torch.cat(cps), torch.cat(wpcs))


def chunk_plan(n_pad: int, q: int) -> tuple[int, int, int]:
    """(chunk_rows, n_equal, remainder_rows) of the chunked and exact
    selections: chunk_rows keeps the (Q, chunk) score buffer under
    CHUNK_ELEMENTS; ``ScanIndex`` also clamps top_c to it, as the JAX
    package does."""
    if n_pad <= MIN_CHUNK:
        return n_pad, 1, 0
    chunk = max(MIN_CHUNK, (CHUNK_ELEMENTS // max(q, 1)) // 256 * 256)
    chunk = min(chunk, n_pad)
    n_eq = n_pad // chunk
    return chunk, n_eq, n_pad - n_eq * chunk


def _chunk_slices(n_pad: int, max_rows: int) -> list[tuple[int, int]]:
    """(start, size) slices of at most max_rows (a multiple of 256)
    covering n_pad rows."""
    chunk = min(n_pad, max(256, max_rows // 256 * 256))
    return [(s, min(chunk, n_pad - s)) for s in range(0, n_pad, chunk)]


def fold_node_constants(nop, ip_qo, ip_cp, wpc, ip_qo_floor: float, n: int):
    """Fold per-node estimator constants into the (6, N_pad) rank-5(+g)
    form; rows >= n are padding and score PAD_SCORE."""
    n_pad = nop.shape[0]
    floor = torch.tensor(ip_qo_floor, dtype=torch.float32, device=nop.device)
    qo = torch.maximum(ip_qo, floor)
    good = qo > EPS_MEDIUM
    g = torch.where(good, nop / qo.clamp_min(EPS_MEDIUM), 0.0)
    valid = torch.arange(n_pad, device=nop.device) < n
    row0 = torch.where(valid, nop * nop, PAD_SCORE)
    return torch.stack([
        row0,                    # x 1
        nop,                     # x -2b
        g * wpc.float(),         # x -2a*B/kappa
        g,                       # x -2a*C
        g * ip_cp,               # x +2a
        g,                       # fs scale
    ])


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _query_side(qpad, signs, affine_a, affine_b, kappa: float):
    """Encode queries; build the rank-5 coefficient rows + fs weight."""
    qc = quantize.encode_queries(qpad, signs)
    a = _f32(affine_a, qpad.device)
    b = _f32(affine_b, qpad.device)
    w_fs = -2.0 * a * qc.coeff_a / kappa                       # (Q,)
    ones = torch.ones_like(qc.coeff_a)
    y_aux = torch.stack([
        ones,
        -2.0 * b * ones,
        -2.0 * a * qc.coeff_b / kappa,
        -2.0 * a * qc.coeff_c,
        2.0 * a * ones,
    ], dim=1)                                                   # (Q, 5)
    return qc, w_fs, y_aux


def int8_product(q_i8: torch.Tensor, codes_i8: torch.Tensor):
    """(Q, rows) f32 fs = q_i8 @ codes_i8.T, exact (|fs| < 2^24 for
    levels <= 15 and P < 74,565): ``torch._int_mm`` on CUDA, with Q padded
    to a multiple of 8 above 16 and P to a multiple of 8 (zeros change no
    sum); an fp32 product with TF32 off elsewhere."""
    q, p = q_i8.shape
    if q_i8.device.type != "cuda":
        with full_fp32():
            return q_i8.float() @ codes_i8.float().T
    q_mm = max(24, -(-q // 8) * 8)
    p_mm = -(-p // 8) * 8
    q_pad = torch.nn.functional.pad(q_i8, (0, p_mm - p, 0, q_mm - q))
    codes = torch.nn.functional.pad(codes_i8, (0, p_mm - p))
    return torch._int_mm(q_pad, codes.T)[:q].float()


def _chunk_scores(planes_c, aux_c, q_u, w_fs, y_aux, p: int):
    """(Q, chunk) folded ranking scores for one packed code chunk: the
    exact int8 product, then the kernel's rounding order, which is the
    order XLA-CPU gives the JAX package's jitted ``_chunk_scores``."""
    codes_c = pack.unpack_codes_i8(planes_c, p)
    return folded_scores(int8_product(q_u.to(torch.int8), codes_c), aux_c,
                         w_fs, y_aux)


# ----------------------------------------------------------- calibration
def calibration_samples(raw, planes, nop, ip_qo, ip_cp, wpc, centroid,
                        signs, n: int, bits: int, num_samples: int = 2000,
                        seed: int = 99999) -> dict:
    """Estimator calibration pairs from one store: database rows as
    queries, random rows as targets; returns host numpy
    {ip_approx, ip_qo, ip_cp, nop, true_ip}."""
    rng = np.random.default_rng(seed)
    n_s = min(num_samples, n)
    q_ids = rng.choice(n, size=n_s, replace=False)
    x_ids = rng.integers(0, n, size=n_s)
    dev = raw.device
    q_t = torch.from_numpy(q_ids).to(dev)
    x_t = torch.from_numpy(x_ids).to(dev)

    qvecs = raw[q_t]
    qc = quantize.encode_queries(qvecs, signs)
    codes = pack.unpack_planes(planes[x_t], raw.shape[1])
    fs = (qc.q_u * codes).sum(dim=-1, dtype=torch.int32)
    kappa = float((1 << bits) - 1)
    ip_approx = estimate.ip_from_fastscan(
        fs, wpc[x_t], qc.coeff_a, qc.coeff_b, qc.coeff_c, kappa)
    ip_qo_s = ip_qo[x_t].cpu().numpy()
    ip_cp_s = ip_cp[x_t].cpu().numpy()
    nop_s = nop[x_t].cpu().numpy()

    centroid_h = centroid.cpu().numpy()
    xvecs = raw[x_t].cpu().numpy()
    qv = qvecs.cpu().numpy()
    true_ip = ((qv - centroid_h) * (xvecs - centroid_h)).sum(-1) / np.maximum(
        nop_s, 1e-12)
    return dict(ip_approx=ip_approx.cpu().numpy(), ip_qo=ip_qo_s,
                ip_cp=ip_cp_s, nop=nop_s, true_ip=true_ip)


def fit_scan_affine(samples: list[dict]) -> tuple[float, float, float]:
    """Huber-fit the affine correction (a, b) and the MAD-fence
    ip_qo_floor from pooled calibration samples."""
    pool = {k: np.concatenate([s[k] for s in samples]) for k in samples[0]}
    ip_qo_floor = huber.mad_lower_fence(np.abs(pool["ip_qo"]))
    denom = np.maximum(np.abs(pool["ip_qo"]), max(ip_qo_floor, 1e-12))
    raw_est = (pool["ip_approx"] - pool["ip_cp"]) / denom
    good = pool["nop"] > 1e-6
    a, b, _ = huber.fit_affine_huber(raw_est[good], pool["true_ip"][good])
    return float(a), float(b), float(ip_qo_floor)


def calibrate_scan_affine(raw, planes, nop, ip_qo, ip_cp, wpc, centroid,
                          signs, n: int, bits: int, num_samples: int = 2000,
                          seed: int = 99999):
    """(affine_a, affine_b, ip_qo_floor) for one store."""
    s = calibration_samples(raw, planes, nop, ip_qo, ip_cp, wpc, centroid,
                            signs, n, bits, num_samples=num_samples,
                            seed=seed)
    return fit_scan_affine([s])


# ------------------------------------------------------ candidate budget
RANK_QUANTILE = 0.99
RANK_SAFETY = 1.1
RANK_ANCHORS = (1, 10, 100)


class CandidateBudget(NamedTuple):
    anchors: np.ndarray   # (A,) k values
    ranks: np.ndarray     # (A,) derived top_c at each anchor

    def top_c(self, k: int, n: int) -> int:
        """Log-log interpolate/extrapolate the derived budget to k."""
        la = np.log(self.anchors.astype(np.float64))
        lr = np.log(np.maximum(self.ranks.astype(np.float64), 1.0))
        c = float(np.exp(np.interp(np.log(max(k, 1)), la, lr)))
        if k > self.anchors[-1]:
            if len(self.anchors) > 1:
                slope = (lr[-1] - lr[-2]) / max(la[-1] - la[-2], 1e-9)
            else:
                slope = 1.0
            c = float(np.exp(lr[-1] + slope * (np.log(k) - la[-1])))
        c = int(np.ceil(c / 32.0) * 32)
        return int(np.clip(c, min(4 * k, n), n))


def _true_topk_chunked(raw, norm_sq, qpad, qnorm, n: int, k: int):
    """Exact top-k (ids, squared distances) over the padded store."""
    n_pad = raw.shape[0]
    q = qpad.shape[0]
    max_rows = max(MIN_CHUNK, CHUNK_ELEMENTS // max(q, 1))
    best_neg = best_ids = None
    for start, size in _chunk_slices(n_pad, max_rows):
        vecs = raw[start:start + size]
        with full_fp32():
            d = qnorm[:, None] + norm_sq[None, start:start + size] - 2.0 * (
                qpad @ vecs.T)
        ids_local = torch.arange(start, start + size, dtype=torch.int64,
                                 device=raw.device)
        d = torch.where(ids_local[None, :] < n, d, FLOAT_MAX)
        neg, idx = torch.topk(-d, min(k, size), dim=1)
        ids = ids_local[idx]
        if best_neg is not None:
            neg = torch.cat([best_neg, neg], dim=1)
            ids = torch.cat([best_ids, ids], dim=1)
            neg, keep = torch.topk(neg, min(k, neg.shape[1]), dim=1)
            ids = ids.gather(1, keep)
        best_neg, best_ids = neg, ids
    return best_ids, -best_neg


def est_scores_of(arrays: ScanArrays, qpad, ids, signs, affine_a, affine_b,
                  kappa: float):
    """Folded ranking score (Q, T) of specific store rows per query."""
    p = arrays.raw.shape[1]
    qc, w_fs, y_aux = _query_side(qpad, signs, affine_a, affine_b, kappa)
    codes_t = pack.unpack_planes(arrays.planes[ids], p)       # (Q, T, P)
    fs_t = estimate.fastscan_sums(codes_t, qc.q_u)
    aux_t = arrays.node_aux[:, ids]                           # (6, Q, T)
    with full_fp32():
        const_t = torch.einsum("qa,aqt->qt", y_aux, aux_t[:5])
    return const_t + w_fs[:, None] * aux_t[5] * fs_t


def count_leq(arrays: ScanArrays, qpad, est_t, signs, affine_a, affine_b,
              kappa: float):
    """Per (query, threshold): the number of store rows whose folded score
    is <= est_t, i.e. the estimate rank of each threshold row.  The
    (Q, T, rows) comparison buffer is bounded at ~1 GB per chunk."""
    n_pad, p = arrays.raw.shape
    qc, w_fs, y_aux = _query_side(qpad, signs, affine_a, affine_b, kappa)
    q, t = est_t.shape
    max_rows = max(256, (1 << 30) // max(q * t, 1))
    cs = min(n_pad, max_rows // 256 * 256)
    counts = torch.zeros((q, t), dtype=torch.int64, device=est_t.device)
    for s in range(0, n_pad, cs):
        score = _chunk_scores(arrays.planes[s:s + cs],
                              arrays.node_aux[:, s:s + cs], qc.q_u, w_fs,
                              y_aux, p)
        counts += (score[:, None, :] <= est_t[:, :, None]).sum(dim=2)
    return counts


def derive_candidate_budget(arrays: ScanArrays, signs, affine_a: float,
                            affine_b: float, n: int, kappa: float,
                            seed: int, n_queries: int = 256
                            ) -> CandidateBudget:
    """Measure the estimate rank of true neighbours on two calibration
    cohorts (database rows jittered at 1x and 3x their nearest-neighbour
    distance) and set top_c(k) at the RANK_QUANTILE tail times
    RANK_SAFETY, the per-anchor max over cohorts."""
    rng = np.random.default_rng(seed)
    m = int(min(n_queries, n))
    ids = rng.choice(n, size=m, replace=False)
    dev = arrays.raw.device
    rows_t = arrays.raw[torch.from_numpy(ids).to(dev)]
    db_rows = rows_t.cpu().numpy()
    rows_norm = (rows_t * rows_t).sum(dim=-1)
    _, d2 = _true_topk_chunked(arrays.raw, arrays.norm_sq, rows_t, rows_norm,
                               n, min(2, n))
    nn_dist = np.sqrt(np.maximum(d2.cpu().numpy()[:, -1], 0.0))
    p = db_rows.shape[1]

    anchors = sorted({min(a, n) for a in RANK_ANCHORS})
    k_max = anchors[-1]
    a_dev = _f32(affine_a, dev)
    b_dev = _f32(affine_b, dev)
    per_cohort = []
    for scale in (1.0, 3.0):
        noise = rng.standard_normal((m, p)).astype(np.float32) / np.sqrt(p)
        queries = db_rows + noise * (scale * nn_dist)[:, None]
        qpad = torch.from_numpy(queries).float().to(dev)
        qnorm = (qpad * qpad).sum(dim=-1)
        true_ids, _ = _true_topk_chunked(arrays.raw, arrays.norm_sq, qpad,
                                         qnorm, n, k_max)
        est_t = est_scores_of(arrays, qpad, true_ids, signs, a_dev, b_dev,
                              float(kappa))
        counts = count_leq(arrays, qpad, est_t, signs, a_dev, b_dev,
                           float(kappa)).cpu().numpy()
        per_cohort.append(ranks_from_counts(counts, anchors))
    return budget_from_cohorts(per_cohort, anchors)


def ranks_from_counts(counts: np.ndarray, anchors) -> np.ndarray:
    """Per-anchor top_c: the RANK_QUANTILE tail of per-neighbour ranks
    times RANK_SAFETY."""
    return np.asarray(
        [np.ceil(np.quantile(counts[:, :a], RANK_QUANTILE) * RANK_SAFETY)
         for a in anchors],
        np.int64,
    )


def budget_from_cohorts(per_cohort: list, anchors) -> CandidateBudget:
    """Per-anchor max over cohorts, floored at the anchor, monotone in k."""
    ranks = (np.maximum.reduce(per_cohort) if len(per_cohort) > 1
             else per_cohort[0])
    ranks = np.maximum.accumulate(np.maximum(ranks, np.asarray(anchors)))
    return CandidateBudget(anchors=np.asarray(anchors, np.int64), ranks=ranks)


# ---------------------------------------------------------------- search
def make_rerank_sketch(raw: torch.Tensor, norm_sq: torch.Tensor,
                       force_int8: bool = False) -> RerankSketch:
    """Stage-1 sketch of a raw store: bf16 rows with the raw norms while
    the store holds at most BF16_SKETCH_MAX_RAW_BYTES (and int8 is not
    forced), else int8 codes round(x / scale) clipped to [-127, 127] with
    per-dimension scales max|x| / 127 and the norms of the sketch points.
    The sketch scan needs the int8 form.  Row-chunked so no f32
    store-sized transient exists."""
    if not force_int8 and \
            raw.numel() * raw.element_size() <= BF16_SKETCH_MAX_RAW_BYTES:
        return RerankSketch(raw.to(torch.bfloat16), norm_sq, None)
    scale = raw.abs().amax(dim=0).clamp_min(1e-12) / 127.0
    step = 1 << 20
    codes = torch.empty(raw.shape, dtype=torch.int8, device=raw.device)
    norms = torch.empty(raw.shape[0], dtype=torch.float32, device=raw.device)
    for s in range(0, raw.shape[0], step):
        c = torch.round(raw[s:s + step] / scale[None, :]).clamp(-127, 127)
        xhat = c * scale[None, :]
        codes[s:s + step] = c.to(torch.int8)
        norms[s:s + step] = (xhat * xhat).sum(dim=-1)
    return RerankSketch(codes, norms, scale)


def _rerank_survivors(k: int, c: int) -> int:
    # floor 512: the int8 sketch's query-side rounding can push a true
    # top-10 neighbour to sketch rank ~300 on clustered data
    return min(max(4 * k, 512), c)


def _candidate_topk(raw, norm_sq, qeff, qnorm, cand_ids, n: int, kk: int,
                    elems: int):
    """Top-kk of gathered-candidate L2 distances in pieces of at most
    `elems` gathered elements; returns (neg_dists (Q, kk), ids (Q, kk)).
    Low-precision rows (a sketch) are upcast to f32 after the gather, so
    distances accumulate in f32 whatever the gather's precision."""
    q, c = cand_ids.shape
    p = raw.shape[1]
    piece = max(kk, elems // max(q * p, 1))
    last = raw.shape[0] - 1

    def neg_dist(ids_blk):
        # ids past the store (kernel pad rows, empty bins) are clamped for
        # the gather and priced out by the n mask
        safe = ids_blk.clamp(0, last)
        vecs = raw[safe]
        if vecs.dtype != qeff.dtype:
            vecs = vecs.to(qeff.dtype)
        exact = estimate.exact_l2_sq(qeff, qnorm, vecs, norm_sq[safe])
        return -torch.where(ids_blk < n, exact, FLOAT_MAX)

    best_neg = best_ids = None
    for s in range(0, c, piece):
        blk = cand_ids[:, s:s + piece]
        neg = neg_dist(blk)
        if best_neg is not None:
            neg = torch.cat([best_neg, neg], dim=1)
            blk = torch.cat([best_ids, blk], dim=1)
        best_neg, sel = torch.topk(neg, kk, dim=1)
        best_ids = blk.gather(1, sel)
    return best_neg, best_ids


def _rerank(raw, norm_sq, qpad, qnorm, cand_ids, n: int, k: int,
            sketch: RerankSketch | None = None):
    """Exact-L2 rerank of candidates; pad candidates map to id -1 and
    FLOAT_MAX.  With a sketch and at least TWO_STAGE_MIN_C candidates, the
    sketch's distances first select _rerank_survivors(k, C) survivors: a
    bf16 sketch against the query rounded to bf16 (pieces of
    2 * RERANK_ELEMENTS), an int8 one against the query times its scales
    (pieces of 4 * RERANK_ELEMENTS)."""
    c = cand_ids.shape[1]
    if sketch is not None and c >= TWO_STAGE_MIN_C:
        surv = _rerank_survivors(k, c)
        if sketch.scale is None:
            qeff = qpad.to(torch.bfloat16).float()
            elems = 2 * RERANK_ELEMENTS
        else:
            qeff = qpad * sketch.scale[None, :]
            elems = 4 * RERANK_ELEMENTS
        _, cand_ids = _candidate_topk(sketch.store, sketch.norm_sq, qeff,
                                      qnorm, cand_ids, n, surv, elems)
    neg_d, ids = _candidate_topk(raw, norm_sq, qpad, qnorm, cand_ids, n, k,
                                 RERANK_ELEMENTS)
    ids = torch.where(neg_d > -FLOAT_MAX, ids, -1)
    return ids, -neg_d


def _decode_keys(cat_key: torch.Tensor, top_c: int, bins: int | None = None,
                 bin_base: torch.Tensor | None = None,
                 bin_stride: torch.Tensor | None = None):
    """The smallest top_c signed keys across all key columns, decoded to
    row ids, id = group * stride + base with the group in the key's low
    GROUP_BITS bits: stride = bins and base = column % bins for the
    kernel's uniform layout, else the column's entries of bin_stride and
    bin_base (stride 0 for a chunk of one key per row)."""
    w = cat_key.shape[1]
    tc = min(top_c, w)
    if tc < w:
        kept, keep = torch.topk(cat_key, tc, dim=1, largest=False)
    else:
        keep = torch.arange(w, device=cat_key.device).expand_as(cat_key)
        kept = cat_key
    gi = (kept & GROUP_MASK).to(torch.int64)
    if bins is not None:
        return gi * bins + keep % bins
    return gi * bin_stride[keep] + bin_base[keep]


def _select(score: torch.Tensor, top_c: int):
    """Exact per-chunk selection (the reference path): (negated scores,
    column indices) of the top_c smallest scores."""
    return torch.topk(-score, min(top_c, score.shape[1]), dim=1)


def _bin_plan(size: int, want_bins: int) -> tuple[int, int]:
    """(group, bins) of the chunked selection over a `size`-row chunk:
    bins >= want_bins (capture), group <= 2^GROUP_BITS (the group index
    packs into the low key bits) and a power of two dividing size."""
    if want_bins >= size:
        return 1, size
    g = min(size // want_bins, GROUP_MASK + 1)
    g = 1 << (g.bit_length() - 1)
    while size % g:
        g >>= 1
    return g, size // g


def plan_slices(n_pad: int, chunk: int, n_eq: int, rem: int):
    """(start, size) of the chunks of a chunk plan: n_eq chunks of `chunk`
    rows, then `rem` rows; the plan must cover n_pad rows."""
    if n_eq * chunk + rem != n_pad:
        raise ValueError(f"chunk plan {n_eq} x {chunk} + {rem} does not "
                         f"cover {n_pad} rows")
    return [(c * chunk, chunk) for c in range(n_eq)] + (
        [(n_eq * chunk, rem)] if rem else [])


def chunk_layout(slices, top_c: int):
    """(start, size, group, bins) of each chunk of the chunked selection:
    capture depends on the total bin count, so BIN_FACTOR * top_c wanted
    bins (at least BINS_MIN) split over the chunks."""
    want_c = -(-max(BINS_MIN, BIN_FACTOR * top_c) // len(slices))
    return [(start, size, *_bin_plan(size, want_c)) for start, size in slices]


def decode_chunk_keys(keys_parts, layout, top_c: int) -> torch.Tensor:
    """Row ids of the smallest top_c of the chunks' binned keys: lane b of
    a chunk at `start` decodes to start + group * bins + b (stride 0 where
    the chunk has one group: a full key per row)."""
    base, stride = [], []
    for start, _, g, bins in layout:
        lane = np.tile(np.arange(bins), 1 if g == 1 else 2)
        base.append(start + lane)
        stride.append(np.full(lane.shape, 0 if g == 1 else bins))
    dev = keys_parts[0].device
    return _decode_keys(
        torch.cat(keys_parts, dim=1), top_c,
        bin_base=torch.from_numpy(np.concatenate(base)).to(dev),
        bin_stride=torch.from_numpy(np.concatenate(stride)).to(dev))


def _binned_keys(score: torch.Tensor, g: int, bins: int) -> torch.Tensor:
    """Signed keys of one chunk's scores, row r in bin r % bins and group
    r // bins: with g == 1 the full key of every row (no group bits, so no
    ties the exact per-shard merge would see); else (Q, 2 * bins), each
    bin's two smallest keys with the group index in the low GROUP_BITS
    (unique within a bin, so masking the minimum out yields the second)."""
    keys = signed_keys(score)
    if g == 1:
        return keys
    q = score.shape[0]
    gidx = torch.arange(g, dtype=torch.int32, device=score.device)
    keys = (keys & NOT_GROUP).reshape(q, g, bins) | gidx[None, :, None]
    m1 = keys.amin(dim=1)
    if g == 2:
        m2 = keys.amax(dim=1)
    else:
        m2 = torch.where(keys == m1[:, None, :], I32_MAX, keys).amin(dim=1)
    return torch.cat([m1, m2], dim=1)


def sketch_store_operands(sketch: RerankSketch, n: int, rows_kpad: int):
    """Kernel operands of the sketch store: int8 codes padded to
    rows_kpad, aux = [norms (PAD_SCORE past n), 0, 0, 0, 0, 1]."""
    n_pad = sketch.store.shape[0]
    dev = sketch.store.device
    norm_s = torch.full((rows_kpad,), PAD_SCORE, dtype=torch.float32,
                        device=dev)
    norm_s[:n] = sketch.norm_sq[:n]
    codes = sketch.store
    if rows_kpad != n_pad:
        codes = torch.nn.functional.pad(codes, (0, 0, 0, rows_kpad - n_pad))
    aux = torch.zeros((6, rows_kpad), dtype=torch.float32, device=dev)
    aux[0] = norm_s
    aux[5] = 1.0
    return codes, aux


def estimate_store_operands(planes, node_aux, rows_kpad: int, p: int):
    """Kernel operands of the packed RaBitQ store: int8 codes (rows_kpad,
    P) and aux (6, rows_kpad); kernel pad rows score PAD_SCORE."""
    padr = rows_kpad - planes.shape[0]
    if padr:
        # pad the packed planes before unpacking: one int8 store copy only
        planes = torch.nn.functional.pad(planes, (0, 0, 0, 0, 0, padr))
        node_aux = torch.nn.functional.pad(node_aux, (0, padr))
        node_aux[0, rows_kpad - padr:] = PAD_SCORE
    return pack.unpack_codes_i8(planes, p), node_aux.contiguous()


def sketch_query(qpad: torch.Tensor, scale: torch.Tensor):
    """Query operands of the sketch scan: score = |x_hat|^2 -
    2 sigma_q <q8, codes> with q8 = round(q * scale / sigma_q)."""
    q_scaled = qpad * scale[None, :]
    sigma_q = q_scaled.abs().amax(dim=1).clamp_min(1e-12) / 127.0
    q8 = torch.round(q_scaled / sigma_q[:, None]).clamp(-127, 127).to(
        torch.int8)
    w_fs = -2.0 * sigma_q
    y_aux = torch.zeros((qpad.shape[0], 5), dtype=torch.float32,
                        device=qpad.device)
    y_aux[:, 0] = 1.0
    return q8, w_fs, y_aux


def scan_search(arrays: ScanArrays, queries, signs, affine_a, affine_b,
                n: int, kappa: float, k: int, top_c: int,
                chunk: int | None = None, n_eq: int = 1, rem: int = 0,
                exact_select: bool = False, fused: bool = True,
                sketch: RerankSketch | None = None):
    """Scan all rows, select candidates, exact-rerank them.

    queries: (Q, dim <= P); returns (ids (Q, k) int64, dists (Q, k) f32).
    fused: the kernel scans the whole store.  With an int8 sketch (and
    top_c >= SKETCH_SCAN_MIN_C) it streams the sketch and only
    _rerank_survivors(k, top_c) survivors are reranked; otherwise it
    streams the unpacked RaBitQ codes (estimate mode) and top_c candidates
    are reranked, two-stage through a bf16 sketch if one is given.
    fused=False: the chunked selection over the chunk plan (chunk, n_eq,
    rem) (default ``chunk_plan(N_pad, Q)``); exact_select: the exact top_c
    of every chunk."""
    n_pad, p = arrays.raw.shape
    qpad = hadamard.pad_to(queries.float(), p)
    qnorm = (qpad * qpad).sum(dim=-1)

    def rerank(cand_ids, sketch=sketch):
        return _rerank(arrays.raw, arrays.norm_sq, qpad, qnorm, cand_ids, n,
                       k, sketch=sketch)

    if (fused and not exact_select and sketch is not None
            and sketch.scale is not None and top_c >= SKETCH_SCAN_MIN_C):
        surv = _rerank_survivors(k, top_c)
        bins, _, rows_kpad = fused_bin_plan(n_pad, surv)
        codes_s, aux_s = sketch_store_operands(sketch, n, rows_kpad)
        q8, w_fs_s, y_aux_s = sketch_query(qpad, sketch.scale)
        cat_key = fused_scan_keys(codes_s, aux_s, q8, w_fs_s, y_aux_s, bins)
        return rerank(_decode_keys(cat_key, surv, bins), sketch=None)

    qc, w_fs, y_aux = _query_side(qpad, signs, affine_a, affine_b, kappa)
    if fused and not exact_select:
        bins, _, rows_kpad = fused_bin_plan(n_pad, top_c)
        codes_i8, aux_k = estimate_store_operands(
            arrays.planes, arrays.node_aux, rows_kpad, p)
        cat_key = fused_scan_keys(codes_i8, aux_k, qc.q_u.to(torch.int8),
                                  w_fs, y_aux, bins)
        return rerank(_decode_keys(cat_key, top_c, bins))

    if chunk is None:
        chunk, n_eq, rem = chunk_plan(n_pad, qpad.shape[0])
    slices = plan_slices(n_pad, chunk, n_eq, rem)

    def chunk_score(start, size):
        return _chunk_scores(arrays.planes[start:start + size],
                             arrays.node_aux[:, start:start + size], qc.q_u,
                             w_fs, y_aux, p)

    if exact_select:
        parts_neg, parts_ids = [], []
        for start, size in slices:
            neg, idx = _select(chunk_score(start, size), top_c)
            parts_neg.append(neg)
            parts_ids.append(idx + start)
        cat_neg = torch.cat(parts_neg, dim=1)
        cand_ids = torch.cat(parts_ids, dim=1)
        if cat_neg.shape[1] > top_c:
            keep = torch.topk(cat_neg, top_c, dim=1)[1]
            cand_ids = cand_ids.gather(1, keep)
        return rerank(cand_ids)

    # chunked: per chunk each bin's two smallest keys
    layout = chunk_layout(slices, top_c)
    keys = [_binned_keys(chunk_score(start, size), g, bins)
            for start, size, g, bins in layout]
    return rerank(decode_chunk_keys(keys, layout, top_c))
