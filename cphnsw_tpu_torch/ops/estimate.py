"""Distance estimation: fastscan sums, decode, bounds and exact L2.

PyTorch counterpart of ``cphnsw_tpu/ops/estimate.py``.  The JAX package
runs the exact L2 dot at ``Precision.HIGHEST``; here it runs in true fp32
with TF32 switched off for the duration of the product (``full_fp32``).
The fastscan contraction, an int32 matmul there, is an fp32 product here
(CUDA has no integer matmul) and stays exact: see ``fastscan_sums``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from cphnsw_tpu_torch.ops.quantize import EPS_MEDIUM, EPS_SMALL, LUT_LEVELS

# fp32 represents every integer below 2^24 exactly.
F32_EXACT_INT = 1 << 24


class CalibParams(NamedTuple):
    """Query-time calibration constants (scalars, or tensors that
    broadcast against the estimates)."""

    affine_a: torch.Tensor | float = 1.0
    affine_b: torch.Tensor | float = 0.0
    ip_qo_floor: torch.Tensor | float = 0.0
    dot_slack: torch.Tensor | float = 0.0


@contextlib.contextmanager
def full_fp32():
    """Run fp32 matrix products in full fp32 (no TF32) inside the block,
    restoring the caller's settings afterwards."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def fastscan_sums(codes_u: torch.Tensor, q_u: torch.Tensor) -> torch.Tensor:
    """fs[..., c] = sum_d codes_u[..., c, d] * q_u[..., d] as exact f32.

    codes_u: (B, C, P) code levels, q_u: (B, P) query levels, both in
    [0, LUT_LEVELS].  Every partial sum is an integer of at most
    15 * 15 * P, below 2^24 for P < 74,565, so an fp32 product with TF32
    off sums it exactly in any order: it equals the JAX package's int32
    contraction."""
    p = codes_u.shape[-1]
    if LUT_LEVELS * LUT_LEVELS * p >= F32_EXACT_INT:
        raise ValueError(f"P={p}: fastscan sums would exceed 2^24 and "
                         "lose exactness in fp32")
    with full_fp32():
        return torch.bmm(codes_u.float(), q_u.float()[..., None])[..., 0]


def ip_from_fastscan(fs, wpc, coeff_a, coeff_b, coeff_c, k_scale: float):
    """ip_approx = (A/k)*fs + (B/k)*wpc + C (coeff_* broadcast per query)."""
    inv_k = 1.0 / k_scale
    return (coeff_a * inv_k * fs.float() + coeff_b * inv_k * wpc.float()
            + coeff_c)


def estimate_ip(ip_approx, ip_qo, ip_cp, calib: CalibParams):
    """Calibrated inner-product estimate; returns (ip_est, mask_good).
    Where the floored ip_qo is degenerate the ratio is zeroed, so ip_est
    is affine_b there."""
    ip_qo_p = torch.clamp_min(ip_qo, calib.ip_qo_floor)
    mask_good = ip_qo_p > EPS_MEDIUM
    ratio = torch.where(mask_good,
                        (ip_approx - ip_cp) / ip_qo_p.clamp_min(EPS_MEDIUM),
                        0.0)
    return calib.affine_a * ratio + calib.affine_b, mask_good


def distances_with_bounds(ip_approx, ip_approx_bound, nop, ip_qo, ip_cp,
                          dist_qp_sq, calib: CalibParams):
    """Estimated distance and lower bound, elementwise:

      est   = max(nop^2 + d_qp^2 - 2*nop*ip_est, 0)
      cos+  = clamp((ip_est_bound + dot_slack)/sqrt(d_qp^2), -1, 1)
      lower = max(nop^2 + d_qp^2 - 2*nop*sqrt(d_qp^2)*cos+, 0)

    ip_approx_bound is ip_approx itself at 1 bit and the MSB partial
    decode at N bits; d_qp^2 ~ 0 (query on the parent) takes est =
    nop^2 + d_qp^2 and lower = 0."""
    sqrt_dqp = torch.sqrt(dist_qp_sq.clamp_min(0.0))
    ip_est, mask_good = estimate_ip(ip_approx, ip_qo, ip_cp, calib)
    est = (nop * nop + dist_qp_sq - 2.0 * nop * ip_est).clamp_min(0.0)

    ip_est_b, _ = estimate_ip(ip_approx_bound, ip_qo, ip_cp, calib)
    cos_upper = torch.clamp(
        (ip_est_b + calib.dot_slack) / sqrt_dqp.clamp_min(EPS_MEDIUM),
        -1.0, 1.0)
    lower = (nop * nop + dist_qp_sq
             - 2.0 * nop * sqrt_dqp * cos_upper).clamp_min(0.0)
    lower = torch.where(mask_good, lower, 0.0)

    degenerate = dist_qp_sq < EPS_SMALL
    est = torch.where(degenerate, nop * nop + dist_qp_sq, est)
    lower = torch.where(degenerate, 0.0, lower)
    return est, lower


def exact_l2_sq(queries, query_norm_sq, vectors, vec_norm_sq):
    """max(|q|^2 + |v|^2 - 2<q,v>, 0) for q (Q, P) against gathered
    candidates v (Q, C, P), in full fp32."""
    with full_fp32():
        dots = torch.bmm(vectors, queries[..., None])[..., 0]
    return (query_norm_sq[..., None] + vec_norm_sq - 2.0 * dots).clamp_min(0.0)
