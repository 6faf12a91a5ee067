"""Full-database scan: store layout, calibration, candidate budget, search.

PyTorch counterpart of ``cphnsw_tpu/search/scan.py`` for the fused path.
The estimator algebra is unchanged: per query, the calibrated distance
estimate is an affine function of fs = <codes_u, q_u>, folded into

    score = (w_fs * g) * fs + sum_{a<5} y_aux[a] * node_aux[a]

so one int8 contraction plus a rank-5 node-constant term ranks every row
(``fold_node_constants`` / ``_query_side``).  Search streams either the
int8 rerank sketch (sketch mode, the default: ``SKETCH_SCAN_MIN_C = 0``)
or the unpacked RaBitQ codes (estimate mode) through the fused scan+select
kernel (``kernels/scan_keys.py``), decodes the per-bin top-4 keys to row
ids and reranks the survivors with exact f32 distances.

The JAX package's chunked XLA selection (``_bin_plan``, ``_binned_keys``,
``exact_select``, the non-uniform decode) and the bf16 sketch are not
ported; ``chunk_plan`` is kept only for the ``top_c`` clamp in
``ScanIndex.search_batch``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cphnsw_tpu_torch.calibration import huber
from cphnsw_tpu_torch.kernels.scan_keys import (
    GROUP_MASK, PAD_SCORE, fused_bin_plan, fused_scan_keys)
from cphnsw_tpu_torch.ops import estimate, hadamard, pack, quantize
from cphnsw_tpu_torch.ops.estimate import full_fp32
from cphnsw_tpu_torch.ops.quantize import EPS_MEDIUM

FLOAT_MAX = float(torch.finfo(torch.float32).max)
# Score-buffer budget (Q * rows) of the chunk plan kept for the top_c clamp
# and of the exact top-k used by the budget derivation.
CHUNK_ELEMENTS = 1 << 28
MIN_CHUNK = 1 << 15
# rows per encode step (bounds the CAQ intermediates during build)
ENCODE_CHUNK = 1 << 17
# Gathered-candidate f32 elements per rerank piece (Q * piece * P).
RERANK_ELEMENTS = 1 << 28
# Candidate count above which an estimate-mode rerank goes two-stage
# through the int8 sketch.
TWO_STAGE_MIN_C = 4096
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
    """int8 stage-1 store: codes (N_pad, P) int8 with per-dimension
    scales (P,) f32 and the squared norms of the sketch points."""

    store: torch.Tensor
    norm_sq: torch.Tensor
    scale: torch.Tensor


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
    """(chunk_rows, n_equal, remainder_rows) of the JAX package's chunked
    scan; search uses chunk_rows only to clamp top_c as that package
    does."""
    if n_pad <= MIN_CHUNK:
        return n_pad, 1, 0
    chunk = max(MIN_CHUNK, (CHUNK_ELEMENTS // max(q, 1)) // 256 * 256)
    chunk = min(chunk, n_pad)
    n_eq = n_pad // chunk
    return chunk, n_eq, n_pad - n_eq * chunk


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


def _chunk_scores(planes_c, aux_c, q_u, w_fs, y_aux, p: int):
    """(Q, chunk) folded ranking scores for one packed code chunk (plain
    torch; only the budget derivation uses it).  fs is an fp32 product of
    integers below 15 * 15 * P < 2^24, hence exact."""
    codes_c = pack.unpack_codes_i8(planes_c, p)
    with full_fp32():
        fs = q_u.float() @ codes_c.float().T
    score = (w_fs[:, None] * aux_c[5][None, :]) * fs
    for a in range(5):
        score = score + y_aux[:, a, None] * aux_c[a][None, :]
    return score


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
    step = min(n_pad, max(256, max_rows // 256 * 256))
    best_neg = best_ids = None
    for start in range(0, n_pad, step):
        vecs = raw[start:start + step]
        with full_fp32():
            d = qnorm[:, None] + norm_sq[None, start:start + step] - 2.0 * (
                qpad @ vecs.T)
        ids_local = torch.arange(start, start + vecs.shape[0],
                                 dtype=torch.int64, device=raw.device)
        d = torch.where(ids_local[None, :] < n, d, FLOAT_MAX)
        neg, idx = torch.topk(-d, min(k, vecs.shape[0]), dim=1)
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
def make_rerank_sketch(raw: torch.Tensor) -> RerankSketch:
    """int8 sketch of a raw store: per-dimension scales max|x|/127, codes
    round(x/scale) clipped to [-127, 127], norms of the sketch points.
    Row-chunked so no f32 store-sized transient exists."""
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
    Low-precision rows (the int8 sketch) are upcast after the gather."""
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
    FLOAT_MAX.  With a sketch and many candidates the int8 sketch first
    selects _rerank_survivors(k, C) survivors."""
    c = cand_ids.shape[1]
    if sketch is not None and c >= TWO_STAGE_MIN_C:
        surv = _rerank_survivors(k, c)
        qeff = qpad * sketch.scale[None, :]
        _, cand_ids = _candidate_topk(sketch.store, sketch.norm_sq, qeff,
                                      qnorm, cand_ids, n, surv,
                                      4 * RERANK_ELEMENTS)
    neg_d, ids = _candidate_topk(raw, norm_sq, qpad, qnorm, cand_ids, n, k,
                                 RERANK_ELEMENTS)
    ids = torch.where(neg_d > -FLOAT_MAX, ids, -1)
    return ids, -neg_d


def _decode_keys(cat_key: torch.Tensor, top_c: int, bins: int):
    """The smallest top_c signed keys across all bins, decoded to row ids:
    id = group * bins + bin, group in the key's low GROUP_BITS bits."""
    w = cat_key.shape[1]
    tc = min(top_c, w)
    if tc < w:
        kept, keep = torch.topk(cat_key, tc, dim=1, largest=False)
    else:
        keep = torch.arange(w, device=cat_key.device).expand_as(cat_key)
        kept = cat_key
    gi = (kept & GROUP_MASK).to(torch.int64)
    return gi * bins + keep % bins


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
                sketch: RerankSketch | None = None):
    """Scan all rows through the fused kernel, select, exact-rerank.

    queries: (Q, dim <= P); returns (ids (Q, k) int64, dists (Q, k) f32).
    With a sketch (and top_c >= SKETCH_SCAN_MIN_C) the kernel streams the
    int8 sketch store and only _rerank_survivors(k, top_c) survivors are
    reranked; otherwise it streams the unpacked RaBitQ codes (estimate
    mode) and top_c candidates are reranked."""
    n_pad, p = arrays.raw.shape
    qpad = hadamard.pad_to(queries.float(), p)
    qnorm = (qpad * qpad).sum(dim=-1)

    if sketch is not None and top_c >= SKETCH_SCAN_MIN_C:
        surv = _rerank_survivors(k, top_c)
        bins, _, rows_kpad = fused_bin_plan(n_pad, surv)
        codes_s, aux_s = sketch_store_operands(sketch, n, rows_kpad)
        q8, w_fs_s, y_aux_s = sketch_query(qpad, sketch.scale)
        cat_key = fused_scan_keys(codes_s, aux_s, q8, w_fs_s, y_aux_s, bins)
        cand_ids = _decode_keys(cat_key, surv, bins)
        return _rerank(arrays.raw, arrays.norm_sq, qpad, qnorm, cand_ids, n,
                       k)

    qc, w_fs, y_aux = _query_side(qpad, signs, affine_a, affine_b, kappa)
    bins, _, rows_kpad = fused_bin_plan(n_pad, top_c)
    codes_i8, aux_k = estimate_store_operands(arrays.planes, arrays.node_aux,
                                              rows_kpad, p)
    cat_key = fused_scan_keys(codes_i8, aux_k, qc.q_u.to(torch.int8), w_fs,
                              y_aux, bins)
    cand_ids = _decode_keys(cat_key, top_c, bins)
    return _rerank(arrays.raw, arrays.norm_sq, qpad, qnorm, cand_ids, n, k,
                   sketch=sketch)
