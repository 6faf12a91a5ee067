"""EVT-CRC tail statistics: Grimshaw GPD fit, KS validation, stable selection.

A copy of ``cphnsw_tpu/calibration/evt.py``: that package's ``__init__``
imports JAX, so even its numpy-only modules cannot be imported here.

Host-side numpy re-implementation of the reference's extreme-value machinery
(reference core/evt_crc.hpp):

  * fit_gpd            <- method-of-moments init + Grimshaw MLE Newton on xi
                          with a fixed-point inner solve for beta (:74-188)
  * ks_test_gpd        <- one-sided KS statistic against the fitted GPD
                          (:191-208), with the 1.25x Lilliefors inflation of
                          the critical value (:210-213)
  * fit_gpd_stable     <- threshold-grid stability selection + KS-gated
                          empirical-checkpoint fallback (:216-354)
  * evt_quantile       <- GPD inverse CDF / empirical checkpoint
                          interpolation with log-linear extrapolation (:34-71)

These produce a dozen scalars consumed at query time; the heavy lifting
stays on host by design.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Reference core/constants.hpp:21-35 and evt_crc.hpp:12-18
GPD_BETA_MIN = 1e-8
EVT_ALPHA_MIN = 1e-12
EVT_ALPHA_MAX = 0.5
GPD_XI_MIN = -0.2
GPD_XI_MAX = 0.5
GRIMSHAW_MAX_ITER = 50
GRIMSHAW_BETA_ITER = 5
GRIMSHAW_TOL = 1e-6
KS_INFLATION = 1.25
EPS_TINY = 1e-20
EPS_SMALL = 1e-12
EPS_XI_ZERO = 1e-6

CHECKPOINT_ALPHAS = np.array([0.5, 0.1, 0.05, 0.01, 0.005, 0.001, 5e-4, 1e-4])
N_CHECKPOINTS = len(CHECKPOINT_ALPHAS)


@dataclass
class EVTState:
    u: float = 0.0
    p_u: float = 0.0
    xi: float = 0.0
    beta: float = 0.0
    n_tail: int = 0
    fitted: bool = False
    use_empirical: bool = False
    empirical_checkpoints: np.ndarray = field(
        default_factory=lambda: np.zeros(N_CHECKPOINTS)
    )

    def to_dict(self) -> dict:
        return {
            "u": float(self.u),
            "p_u": float(self.p_u),
            "xi": float(self.xi),
            "beta": float(self.beta),
            "n_tail": int(self.n_tail),
            "fitted": bool(self.fitted),
            "use_empirical": bool(self.use_empirical),
            "empirical_checkpoints": [
                float(x) for x in self.empirical_checkpoints
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EVTState":
        return cls(
            u=d["u"], p_u=d["p_u"], xi=d["xi"], beta=d["beta"],
            n_tail=d["n_tail"], fitted=d["fitted"],
            use_empirical=d["use_empirical"],
            empirical_checkpoints=np.asarray(d["empirical_checkpoints"]),
        )


def evt_quantile(alpha: float, evt: EVTState) -> float:
    """Residual magnitude exceeded with probability alpha (evt_crc.hpp:34-71)."""
    alpha = float(np.clip(alpha, EVT_ALPHA_MIN, EVT_ALPHA_MAX))
    if alpha >= evt.p_u:
        return float(evt.u)

    if evt.use_empirical:
        a = CHECKPOINT_ALPHAS
        q = evt.empirical_checkpoints
        for j in range(N_CHECKPOINTS - 1):
            if alpha >= a[j + 1]:
                t = (alpha - a[j + 1]) / (a[j] - a[j + 1])
                return float(q[j + 1] * (1.0 - t) + q[j] * t)
        log_ratio = np.log(a[-2] / a[-1])
        slope = (q[-1] - q[-2]) / log_ratio if log_ratio > EPS_SMALL else 0.0
        return float(q[-1] + slope * np.log(a[-1] / alpha))

    ratio = evt.p_u / alpha
    if abs(evt.xi) < EPS_XI_ZERO:
        return float(evt.u + evt.beta * np.log(ratio))
    return float(evt.u + (evt.beta / evt.xi) * (ratio**evt.xi - 1.0))


def fit_gpd(
    sorted_abs_resid: np.ndarray,
    threshold_quantile: float,
    min_tail: int,
) -> EVTState:
    """Fit a GPD to exceedances over the threshold_quantile empirical
    quantile (evt_crc.hpp:74-188)."""
    state = EVTState()
    x = np.asarray(sorted_abs_resid, dtype=np.float64)
    n = x.size
    if n < min_tail * 2:
        return state

    u_idx = min(int(n * threshold_quantile), n - 1)
    state.u = float(x[u_idx])
    y = x[u_idx + 1:] - state.u
    y = y[y > 0.0]
    m = y.size
    state.n_tail = int(m)
    state.p_u = m / n
    if m < min_tail:
        return state

    mean_y = y.mean()
    var_y = (y * y).mean() - mean_y * mean_y
    if var_y < EPS_TINY:
        xi_mom, beta_mom = 0.0, max(mean_y, GPD_BETA_MIN)
    else:
        xi_mom = 0.5 * (1.0 - mean_y * mean_y / var_y)
        beta_mom = mean_y * (1.0 - xi_mom)

    xi = xi_mom
    beta = max(beta_mom, GPD_BETA_MIN)
    mle_converged = False

    for _ in range(GRIMSHAW_MAX_ITER):
        if abs(xi) < EPS_XI_ZERO:
            beta = mean_y
            xi = 0.0
            mle_converged = True
            break
        if np.any(1.0 + xi * y / beta <= 0.0):
            break

        beta_new = beta
        for _ in range(GRIMSHAW_BETA_ITER):
            z = 1.0 + xi * y / beta_new
            if np.any(z <= 0.0):
                break
            beta_new = max((1.0 + xi) * (y / z).sum() / m, GPD_BETA_MIN)
        beta = beta_new

        z = 1.0 + xi * y / beta
        if np.any(z <= 0.0):
            break
        lz = np.log(z)
        w = y / (beta * z)
        score = (-lz / (xi * xi) + (1.0 + 1.0 / xi) * w).sum()
        info = (
            2.0 * lz / (xi**3) - 2.0 * w / (xi * xi) - (1.0 + 1.0 / xi) * w * w
        ).sum()
        if abs(info) < EPS_TINY:
            break
        xi_new = float(np.clip(xi - score / info, GPD_XI_MIN, GPD_XI_MAX))
        if abs(xi_new - xi) < GRIMSHAW_TOL:
            xi = xi_new
            mle_converged = True
            break
        xi = xi_new

    if not mle_converged:
        xi, beta = xi_mom, beta_mom

    state.xi = float(np.clip(xi, GPD_XI_MIN, GPD_XI_MAX))
    state.beta = float(max(beta, GPD_BETA_MIN))
    state.fitted = True
    return state


def ks_test_gpd(sorted_tail: np.ndarray, xi: float, beta: float) -> float:
    """Max |F_emp - F_gpd| over the sorted tail (evt_crc.hpp:191-208)."""
    y = np.asarray(sorted_tail, dtype=np.float64)
    m = y.size
    f_emp = np.arange(1, m + 1) / m
    if abs(xi) < EPS_XI_ZERO:
        f_gpd = 1.0 - np.exp(-y / beta)
    else:
        z = 1.0 + xi * y / beta
        f_gpd = np.where(z > 0.0, 1.0 - np.power(np.maximum(z, EPS_TINY), -1.0 / xi), 1.0)
    return float(np.abs(f_emp - f_gpd).max())


def ks_critical(n: int) -> float:
    """Lilliefors-inflated KS critical value (evt_crc.hpp:210-213)."""
    return KS_INFLATION * 1.358 / np.sqrt(max(n, 1))


def fit_gpd_stable(
    abs_resid: np.ndarray,
    min_tail: int,
    thresh_min: float = 0.0,
    thresh_max_hint: float = 0.0,
) -> EVTState:
    """Threshold-grid stability selection with KS-gated empirical fallback
    (evt_crc.hpp:216-354).  abs_resid need not be pre-sorted."""
    x = np.sort(np.asarray(abs_resid, dtype=np.float64))
    n = x.size

    if thresh_min <= 0.0:
        thresh_min = max(1.0 - 1.0 / np.sqrt(max(n, 4)), 0.5)
    max_thresh = (
        thresh_max_hint
        if thresh_max_hint > 0.0
        else 1.0 - min_tail / max(n, 1)
    )

    if max_thresh <= thresh_min:
        return fit_gpd(x, thresh_min, min_tail)

    n_thresh = int(
        np.clip(np.ceil(np.sqrt(np.log2(max(float(n), 64.0)))), 3, 8)
    )
    thresholds = thresh_min + (max_thresh - thresh_min) * np.arange(
        n_thresh
    ) / (n_thresh - 1)

    fits = [fit_gpd(x, t, min_tail) for t in thresholds]
    valid = [f.fitted for f in fits]
    if sum(valid) < 2:
        for f in fits:
            if f.fitted:
                return f
        return EVTState()

    # Neighbor-stability score over (xi, beta) differences
    best_idx, best_score, found = 0, np.inf, False
    for t in range(n_thresh):
        if not valid[t]:
            continue
        score, neighbors = 0.0, 0
        for p in range(t - 1, -1, -1):
            if valid[p]:
                dxi = fits[t].xi - fits[p].xi
                beta_avg = 0.5 * (fits[t].beta + fits[p].beta)
                dbeta = (fits[t].beta - fits[p].beta) / max(beta_avg, GPD_BETA_MIN)
                score += dxi * dxi + dbeta * dbeta
                neighbors += 1
                break
        for nx in range(t + 1, n_thresh):
            if valid[nx]:
                dxi = fits[t].xi - fits[nx].xi
                beta_avg = 0.5 * (fits[t].beta + fits[nx].beta)
                dbeta = (fits[t].beta - fits[nx].beta) / max(beta_avg, GPD_BETA_MIN)
                score += dxi * dxi + dbeta * dbeta
                neighbors += 1
                break
        if neighbors > 0:
            score /= neighbors
            if score < best_score:
                best_score, best_idx, found = score, t, True

    if not found:
        for t in range(n_thresh):
            if valid[t]:
                best_idx, found = t, True
                break
        if not found:
            return EVTState()

    best = fits[best_idx]
    # KS validation; fall back to empirical quantile checkpoints if rejected
    if best.fitted and best.n_tail >= 20:
        u_idx = min(int(n * thresholds[best_idx]), n - 1)
        tail = x[u_idx + 1:] - best.u
        tail = np.sort(tail[tail > 0.0])
        if tail.size:
            ks_stat = ks_test_gpd(tail, best.xi, best.beta)
            if ks_stat > ks_critical(tail.size):
                best.use_empirical = True
                cps = np.zeros(N_CHECKPOINTS)
                for j, alpha in enumerate(CHECKPOINT_ALPHAS):
                    tq = float(np.clip(1.0 - alpha / best.p_u, 0.0, 1.0))
                    idx = min(int(tq * tail.size), tail.size - 1)
                    cps[j] = best.u + tail[idx]
                best.empirical_checkpoints = cps
    return best
