"""The EVT-CRC calibration pipeline: data-derived search parameters.

PyTorch counterpart of ``cphnsw_tpu/calibration/calibrate.py``: every
search-time constant of the graph engine (affine correction, ip_qo floor,
gamma bounds and adaptation, the EVT slack ladder, the termination gamma)
is derived from the built index itself.  One device pass collects the
estimator samples for all calibration queries (``_collect_samples``); the
scalar statistics (Huber fit, MAD and Tukey fences, Grimshaw GPD) run on
the host in numpy, as in the JAX package.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from cphnsw_tpu_torch.calibration import evt, huber
from cphnsw_tpu_torch.ops import estimate, pack, quantize
from cphnsw_tpu_torch.ops.estimate import full_fp32

EPS_SMALL = 1e-12
EPS_MEDIUM = 1e-10
BASEL_K = 6.0 / (math.pi * math.pi)
MIN_CALIBRATE_NODES = 50
MAX_SLACK_ARRAY = 32
SEARCH_DELTA = 1e-4


@dataclass
class IndexProfile:
    """Metadata-derived parameters."""

    n: int = 0
    padded_dim: int = 0
    r: int = 0
    bits: int = 0
    evt_min_tail: int = 64
    min_calib_samples: int = 200
    slack_levels: int = 4

    @classmethod
    def derive(cls, n: int, padded_dim: int, r: int, bits: int):
        log_n = math.log2(max(n, 64))
        return cls(
            n=n, padded_dim=padded_dim, r=r, bits=bits,
            evt_min_tail=max(64, int(math.isqrt(n))),
            min_calib_samples=int(np.clip(10.0 * math.sqrt(n), 200, n)),
            slack_levels=int(np.clip(
                math.ceil(math.log2(max(10.0 * log_n, 4.0))), 4,
                MAX_SLACK_ARRAY)),
        )

    def to_dict(self):
        return self.__dict__.copy()

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


@dataclass
class CalibrationSnapshot:
    affine_a: float = 1.0
    affine_b: float = 0.0
    ip_qo_floor: float = 0.0
    median_nn_dist_sq: float = 0.0
    min_slack_sq: float = 0.0
    median_nop: float = 0.0
    evt: evt.EVTState = field(default_factory=evt.EVTState)
    gamma_min: float = 1.0
    gamma_max: float = 2.0
    gamma_beta: float = 1.0
    gamma_warmup: int = 16
    slack_levels: int = 4
    search_ip_slack_levels: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_SLACK_ARRAY))
    search_num_slack_levels: int = 4
    search_gamma: float = 1.0

    def to_dict(self):
        d = self.__dict__.copy()
        d["evt"] = self.evt.to_dict()
        d["search_ip_slack_levels"] = [
            float(x) for x in self.search_ip_slack_levels]
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        d["evt"] = evt.EVTState.from_dict(d["evt"])
        d["search_ip_slack_levels"] = np.asarray(d["search_ip_slack_levels"])
        return cls(**d)


def _collect_samples(raw, norm_sq, neighbors, signs, bits: int, query_vecs,
                     parent0):
    """Device pass: greedy one-hop parent selection plus per-edge
    estimator samples for a batch of calibration queries.

    Returns host arrays: nn_dist_sq (Qc,), and per edge (Qc, R):
    ip_corrected, ip_qo, nop, dist_qp_sq (Qc,), true_ip, true_dist, valid.
    """
    p = signs.shape[-1]
    k_scale = float((1 << bits) - 1)
    qnorm = (query_vecs * query_vecs).sum(dim=-1)

    def dist_to(rows):                     # rows (Qc,) -> (Qc,)
        return estimate.exact_l2_sq(query_vecs, qnorm, raw[rows][:, None, :],
                                    norm_sq[rows][:, None])[:, 0]

    # one-hop greedy: parent0 vs its neighbours
    nbr0 = neighbors.ids[parent0]                           # (Qc, R)
    nbr0_safe = nbr0.clamp_min(0).long()
    d_par = dist_to(parent0)
    d_nbr = estimate.exact_l2_sq(query_vecs, qnorm, raw[nbr0_safe],
                                 norm_sq[nbr0_safe])
    d_nbr = torch.where(nbr0 >= 0, d_nbr, torch.inf)
    best_d, best_j = d_nbr.min(dim=1)
    take_nbr = best_d < d_par
    parent = torch.where(take_nbr,
                         nbr0.gather(1, best_j[:, None])[:, 0].long(),
                         parent0)
    nn_dist_sq = torch.minimum(best_d, d_par)

    # estimator samples over the chosen parent's edges
    qc = quantize.encode_queries(query_vecs, signs)
    ids = neighbors.ids[parent]
    valid = ids >= 0
    ids_safe = ids.clamp_min(0).long()
    u = pack.unpack_planes(neighbors.planes[parent], p)
    fs = estimate.fastscan_sums(u, qc.q_u)
    aux = neighbors.aux[parent]                              # (Qc, R, 4)
    ip_approx = estimate.ip_from_fastscan(
        fs, aux[..., 3], qc.coeff_a[:, None], qc.coeff_b[:, None],
        qc.coeff_c[:, None], k_scale)
    ip_corrected = ip_approx - aux[..., 2]
    nop = aux[..., 0].clamp_min(EPS_SMALL)
    dist_qp_sq = dist_to(parent)

    pvec = raw[parent]                                       # (Qc, P)
    nvec = raw[ids_safe]                                     # (Qc, R, P)
    with full_fp32():
        true_ip = torch.bmm(nvec - pvec[:, None, :],
                            (query_vecs - pvec)[:, :, None])[..., 0] / nop
    true_dist = estimate.exact_l2_sq(query_vecs, qnorm, nvec,
                                     norm_sq[ids_safe])
    out = (nn_dist_sq, ip_corrected, aux[..., 1], nop, dist_qp_sq, true_ip,
           true_dist, valid)
    return [t.cpu().numpy() for t in out]


def calibrate(raw, norm_sq, neighbors, signs, bits: int,
              profile: IndexProfile, seed: int = 42 + 99999,
              verbose: bool = False) -> CalibrationSnapshot:
    """Full calibration: query sampling on the host, one device pass for
    the samples, then the host statistics (a copy of the JAX package's)."""
    t0 = time.perf_counter()

    def tick(label):
        nonlocal t0
        if verbose:
            print(f"calibrate/{label}: {time.perf_counter() - t0:.1f}s",
                  flush=True)
        t0 = time.perf_counter()

    n, p = raw.shape
    if n < MIN_CALIBRATE_NODES:
        raise RuntimeError("Calibration requires at least 50 nodes.")
    dev = raw.device

    def rows(idx):
        return raw[torch.from_numpy(np.asarray(idx)).to(dev)].cpu().numpy()

    num_samples = min(profile.min_calib_samples, n)
    rng = np.random.default_rng(seed)
    sample_ids = rng.permutation(n)

    n_db = min(num_samples, n)
    n_synth = min(num_samples // 2, n)

    # per-dim variance for synthetic query jitter
    var_sample = max(min(n, num_samples // 4), 2)
    dim_var = np.maximum(rows(sample_ids[:var_sample]).var(axis=0),
                         EPS_SMALL)

    # queries: database vectors + jittered synthetics
    db_q = rows(sample_ids[:n_db])
    synth_base = rows(sample_ids[np.arange(n_synth) % n])
    synth_q = synth_base + rng.standard_normal(
        synth_base.shape).astype(np.float32) * np.sqrt(dim_var).astype(
            np.float32)
    queries = np.concatenate([db_q, synth_q], axis=0).astype(np.float32)
    # parent cursor offset by one, so a database query never starts on its
    # own node (whose zero nn-distance would collapse median_nn_dist_sq)
    parent0 = sample_ids[(np.arange(len(queries)) + 1) % n]

    tick("prep")
    (nn_dist_sq, ip_corrected, ip_qo, nop, dist_qp_sq, true_ip, true_dist,
     valid) = _collect_samples(
        raw, norm_sq, neighbors, signs, bits,
        torch.from_numpy(queries).to(dev), torch.from_numpy(parent0).to(dev))
    tick("device_samples")

    v = valid.ravel()
    ip_corrected_f = ip_corrected.ravel()[v]
    ip_qo_f = ip_qo.ravel()[v]
    nop_f = nop.ravel()[v]
    true_ip_f = true_ip.ravel()[v]
    true_dist_f = true_dist.ravel()[v]
    dqp_f = np.repeat(dist_qp_sq, valid.shape[1])[v]

    if ip_qo_f.size == 0:
        raise RuntimeError("Calibration failed: no ip_qo samples.")

    snap = CalibrationSnapshot()

    # ip_qo_floor: MAD lower fence
    snap.ip_qo_floor = float(
        max(huber.mad_lower_fence(ip_qo_f, 3.0, EPS_MEDIUM), EPS_MEDIUM))

    ip_qo_denom = np.maximum(np.abs(ip_qo_f), EPS_MEDIUM)
    floored_qo = np.maximum(ip_qo_denom, snap.ip_qo_floor)
    floored_estimates = ip_corrected_f / floored_qo

    if floored_estimates.size < 20:
        raise RuntimeError(
            "Calibration failed: too few estimator/target pairs.")

    a, b, _ = huber.fit_affine_huber(floored_estimates, true_ip_f)
    snap.affine_a, snap.affine_b = float(a), float(b)

    if nn_dist_sq.size == 0:
        raise RuntimeError(
            "Calibration failed: no nearest-neighbor distance samples.")
    snap.median_nn_dist_sq = float(np.median(nn_dist_sq))
    snap.min_slack_sq = max(EPS_SMALL, snap.median_nn_dist_sq * 1e-4)

    # distance residuals with the fitted affine
    ip_est = np.where(floored_qo > EPS_MEDIUM, ip_corrected_f / floored_qo,
                      0.0)
    ip_est = snap.affine_a * ip_est + snap.affine_b
    est_dist = np.maximum(nop_f * nop_f + dqp_f - 2.0 * nop_f * ip_est, 0.0)
    dist_residuals = np.abs(est_dist - true_dist_f)

    n_resid = dist_residuals.size
    evt_thresh_min = max(1.0 - 1.0 / math.sqrt(max(n_resid, 4)), 0.5)
    evt_thresh_max = 1.0 - profile.evt_min_tail / max(n_resid, 1)
    tick("huber+floor")
    snap.evt = evt.fit_gpd_stable(dist_residuals, profile.evt_min_tail,
                                  evt_thresh_min, evt_thresh_max)
    tick("evt_fit")

    if nop_f.size == 0:
        raise RuntimeError("Calibration failed: no nop samples.")
    snap.median_nop = float(np.median(nop_f))
    if snap.median_nop <= 0.0:
        raise RuntimeError("Calibration failed: degenerate nop samples.")

    if not snap.evt.fitted:
        # too small a tail for a GPD fit: empirical quantile checkpoints
        srt = np.sort(dist_residuals)
        st = evt.EVTState()
        st.u = float(srt[n_resid // 2])
        st.p_u = 0.5
        st.n_tail = n_resid - n_resid // 2
        st.fitted = True
        st.use_empirical = True
        cps = np.zeros(evt.N_CHECKPOINTS)
        for j, alpha in enumerate(evt.CHECKPOINT_ALPHAS):
            cps[j] = srt[min(int((1.0 - alpha) * n_resid), n_resid - 1)]
        st.empirical_checkpoints = cps
        snap.evt = st

    # gamma bounds via Tukey fences on normalized residuals
    ref = math.sqrt(max(snap.median_nn_dist_sq, snap.min_slack_sq))
    norm_resid = np.sort(dist_residuals) / ref
    nr_q1 = norm_resid[n_resid // 4]
    nr_median = norm_resid[n_resid // 2]
    nr_q3 = norm_resid[3 * n_resid // 4]
    nr_iqr = nr_q3 - nr_q1

    gamma_min_floor = 1.0 + 1.0 / math.sqrt(p)
    gamma_min_data = 1.0 + norm_resid[max(1, n_resid // 100)]
    snap.gamma_min = max(gamma_min_data, gamma_min_floor)

    gamma_max_fence = 1.0 + nr_q3 + 1.5 * nr_iqr
    min_offset = max(nr_iqr, nr_median)
    snap.gamma_max = max(gamma_max_fence, snap.gamma_min + min_offset)

    # gamma beta = 1/CV
    rmean = float(dist_residuals.mean())
    rstd = float(dist_residuals.std())
    resid_cv = rstd / max(rmean, EPS_SMALL)
    cv_floor = 1.0 / math.sqrt(2.0 * (max(n_resid, 2) - 1))
    snap.gamma_beta = 1.0 / max(resid_cv, cv_floor)
    snap.gamma_warmup = max(4, int(math.ceil(math.sqrt(snap.evt.n_tail))))

    # EVT slack ladder + termination gamma
    snap.slack_levels = profile.slack_levels
    delta_prune = 0.5 * SEARCH_DELTA
    delta_term = 0.5 * SEARCH_DELTA
    evt_l = int(np.clip(profile.slack_levels, 1, MAX_SLACK_ARRAY))
    snap.search_num_slack_levels = evt_l
    levels = np.zeros(MAX_SLACK_ARRAY)
    for i in range(1, evt_l + 1):
        alpha_i = delta_prune * BASEL_K / (i * i)
        levels[i - 1] = evt.evt_quantile(alpha_i, snap.evt) / (
            2.0 * snap.median_nop)
    snap.search_ip_slack_levels = levels

    dist_slack_term = evt.evt_quantile(delta_term, snap.evt)
    snap.search_gamma = float(np.clip(1.0 + dist_slack_term / ref,
                                      snap.gamma_min, snap.gamma_max))
    return snap


def to_search_params(snap: CalibrationSnapshot, device):
    """SearchParams for the beam from a host snapshot: scalars rounded to
    f32 (the JAX package holds them as f32 device scalars), the slack
    ladder as an f32 tensor on `device`."""
    from cphnsw_tpu_torch.search.beam import SearchParams

    def f32(x) -> float:
        return float(np.float32(x))

    levels = max(snap.search_num_slack_levels, 1)
    return SearchParams(
        affine_a=f32(snap.affine_a),
        affine_b=f32(snap.affine_b),
        ip_qo_floor=f32(snap.ip_qo_floor),
        slack_levels=torch.as_tensor(
            snap.search_ip_slack_levels[:levels], dtype=torch.float32,
            device=device),
        gamma=f32(snap.search_gamma),
        gamma_max=f32(snap.gamma_max),
        gamma_beta=f32(snap.gamma_beta),
        gamma_warmup=int(snap.gamma_warmup),
    )
