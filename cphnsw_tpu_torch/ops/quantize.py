"""RaBitQ / CAQ quantization: database codes, edge residuals, queries.

PyTorch counterpart of ``cphnsw_tpu/ops/quantize.py`` (``compute_centroid``,
``caq_quantize``, ``encode_vectors``, ``encode_residuals``,
``encode_queries``).  The CAQ
coordinate descent stays sequential over the P coordinates and parallel
over the vector batch; its Python loop over coordinates replaces the JAX
``lax.scan``/``while_loop`` pair with the same update rule, the same
strict-improvement test and the same early exit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cphnsw_tpu_torch.ops import hadamard

# Numerical-stability tiers (reference core/constants.hpp:10-15).
EPS_TINY = 1e-20
EPS_SMALL = 1e-12
EPS_MEDIUM = 1e-10

# 4-bit query quantization levels (reference constants.hpp:61).
LUT_LEVELS = 15.0

CAQ_MAX_ITERS = 10
CAQ_EARLY_EXIT_TOL = 1e-4  # reference constants.hpp:58


def norm_epsilon(padded_dim: int) -> float:
    """Dimension-scaled zero-norm guard (reference constants.hpp:84-86)."""
    return 1e-8 / float(padded_dim)


def coordinate_epsilon(padded_dim: int) -> float:
    return 1e-10 / float(padded_dim)


class EncodedVectors(NamedTuple):
    u: torch.Tensor       # (N, P) int32 code levels in [0, 2^bits - 1]
    nop: torch.Tensor     # (N,)  ||x - centroid||
    ip_qo: torch.Tensor   # (N,)  <c_bar, rotated>/sqrt(P)


class EncodedResiduals(NamedTuple):
    u: torch.Tensor       # (E, P) int32
    nop: torch.Tensor     # (E,)  ||n - p||
    ip_qo: torch.Tensor   # (E,)
    ip_cp: torch.Tensor   # (E,)  <c_bar, rotated_parent>/sqrt(P)


class QueryCode(NamedTuple):
    q_u: torch.Tensor      # (Q, P) int32 quantized query levels in [0, 15]
    coeff_a: torch.Tensor  # (Q,) 2*delta/sqrt(P)
    coeff_b: torch.Tensor  # (Q,) 2*vmin/sqrt(P)
    coeff_c: torch.Tensor  # (Q,) -(P*vmin + delta*sum_u)/sqrt(P)
    q_rot: torch.Tensor    # (Q, P) rotated query


def compute_centroid(vectors: torch.Tensor) -> torch.Tensor:
    """Dataset mean."""
    return vectors.mean(dim=0)


def _inv_sqrt(p: int) -> float:
    """1/sqrt(P) rounded as the JAX package rounds it (two f32 steps)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(p)))


def _c_bar(u: torch.Tensor, bits: int) -> torch.Tensor:
    k = float((1 << bits) - 1)
    return (2.0 * u.float() - k) / k


def _center_normalize_rotate(vectors, centroid, signs):
    """Shared front half of encode: center, norm, normalize, rotate."""
    p = signs.shape[-1]
    centered = vectors - centroid
    nop = torch.linalg.vector_norm(centered, dim=-1)
    eps = norm_epsilon(p)
    safe = nop >= eps
    inv = torch.where(safe, 1.0 / nop.clamp_min(eps), 0.0)
    normalized = centered * inv[..., None]
    rotated = hadamard.rotate(hadamard.pad_to(normalized, p), signs)
    return rotated, nop, safe


def caq_quantize(rotated: torch.Tensor, bits: int,
                 rotated_parent: torch.Tensor | None = None):
    """CAQ coordinate-descent quantization, batched over vectors.

    rotated: (V, P) rotated unit vectors.  Returns (u (V, P) int32,
    ip_qo (V,), ip_cp (V,) or None): ip_cp = <c_bar, rotated_parent>/sqrt(P)
    when the rotated parents (V, P) of edge residuals are given.  bits == 1
    is exactly the sign code; bits 2-3 sweep all K+1 levels per
    coordinate; bits >= 4 try +/-1 moves.
    """
    v, p = rotated.shape
    k_int = (1 << bits) - 1
    k = float(k_int)
    inv_sqrt_p = _inv_sqrt(p)

    def parent_ip(u):
        if rotated_parent is None:
            return None
        return (_c_bar(u, bits) * rotated_parent).sum(dim=-1) * inv_sqrt_p

    if bits == 1:
        u = (rotated >= 0.0).to(torch.int32)
        ip_qo = (_c_bar(u, 1) * rotated).sum(dim=-1) * inv_sqrt_p
        return u, ip_qo, parent_ip(u)

    # LVQ uniform init
    vmin = rotated.amin(dim=-1, keepdim=True)
    vmax = rotated.amax(dim=-1, keepdim=True)
    delta = ((vmax - vmin) / k).clamp_min(coordinate_epsilon(p))
    u = torch.round((rotated - vmin) / delta).to(torch.int32).clamp(0, k_int)
    c0 = _c_bar(u, bits)
    dot = (c0 * rotated).sum(dim=-1)
    norm = (c0 * c0).sum(dim=-1)

    rot_t = rotated.T.contiguous()       # (P, V) coordinate-contiguous
    codes_t = u.T.contiguous()
    dev = rotated.device
    if bits >= 4:
        deltas = torch.tensor([-1, 1], dtype=torch.int32, device=dev)

        def candidates_for(u_old):
            return u_old[None, :] + deltas[:, None]            # (2, V)
    else:
        all_u = torch.arange(k_int + 1, dtype=torch.int32, device=dev)

        def candidates_for(u_old):
            return all_u[:, None].expand(k_int + 1, v)

    prev_cos = torch.zeros(v, device=dev)
    for it in range(CAQ_MAX_ITERS):
        nchanged = torch.zeros(v, dtype=torch.int32, device=dev)
        for i in range(p):
            r_i = rot_t[i]
            u_old = codes_t[i]
            c_old = (2.0 * u_old.float() - k) / k
            dot_wo = dot - c_old * r_i
            norm_wo = norm - c_old * c_old
            cand_u = candidates_for(u_old)                       # (C, V)
            valid = (cand_u >= 0) & (cand_u <= k_int)
            c_new = (2.0 * cand_u.float() - k) / k
            new_dot = dot_wo[None] + c_new * r_i[None]
            new_norm = norm_wo[None] + c_new * c_new
            score = new_dot * new_dot / new_norm.clamp_min(EPS_TINY)
            score = torch.where(valid, score, -torch.inf)
            score_old = dot * dot / norm.clamp_min(EPS_TINY)
            best_score, best_idx = score.max(dim=0)
            improved = best_score > score_old  # strict, like the reference
            u_best = cand_u.gather(0, best_idx[None])[0]
            u_next = torch.where(improved, u_best, u_old)
            c_next = (2.0 * u_next.float() - k) / k
            dot = torch.where(improved, dot_wo + c_next * r_i, dot)
            norm = torch.where(improved, norm_wo + c_next * c_next, norm)
            nchanged += improved.to(torch.int32)
            codes_t[i] = u_next
        cos_sq = dot * dot / norm.clamp_min(EPS_TINY)
        any_changed = bool((nchanged > 0).any())
        improving = it == 0 or bool(
            ((cos_sq - prev_cos) >= CAQ_EARLY_EXIT_TOL).any()
        )
        prev_cos = cos_sq
        if not (any_changed and improving):
            break

    u = codes_t.T.contiguous()
    return u, dot * inv_sqrt_p, parent_ip(u)


def encode_vectors(vectors, centroid, signs, bits: int) -> EncodedVectors:
    """Encode database vectors against the dataset centroid."""
    rotated, nop, safe = _center_normalize_rotate(vectors, centroid, signs)
    u, ip_qo, _ = caq_quantize(rotated, bits)
    u = torch.where(safe[:, None], u, 0)
    ip_qo = torch.where(safe, ip_qo, 0.0)
    return EncodedVectors(u=u, nop=nop, ip_qo=ip_qo)


def encode_residuals(parent_vecs, neighbor_vecs, rotated_parents, signs,
                     bits: int) -> EncodedResiduals:
    """Encode edge residuals (n - p)/||n - p|| relative to their parent
    vertices (SymphonyQG-style edge codes).  rotated_parents: the
    orthonormally rotated raw parent vectors (``hadamard.rotate_raw``)."""
    p = signs.shape[-1]
    diff = neighbor_vecs - parent_vecs
    nop = torch.linalg.vector_norm(diff, dim=-1)
    eps = norm_epsilon(p)
    safe = nop >= eps
    inv = torch.where(safe, 1.0 / nop.clamp_min(eps), 0.0)
    rotated = hadamard.rotate(hadamard.pad_to(diff * inv[:, None], p), signs)
    u, ip_qo, ip_cp = caq_quantize(rotated, bits, rotated_parents)
    return EncodedResiduals(
        u=torch.where(safe[:, None], u, 0),
        nop=nop,
        ip_qo=torch.where(safe, ip_qo, 0.0),
        ip_cp=torch.where(safe, ip_cp, 0.0),
    )


def encode_queries(queries: torch.Tensor, signs: torch.Tensor) -> QueryCode:
    """Rotate + 4-bit uniform-quantize a batch of raw queries (queries are
    not centered; the estimator subtracts ip_cp downstream)."""
    p = signs.shape[-1]
    inv_sqrt_p = _inv_sqrt(p)
    q_rot = hadamard.rotate(hadamard.pad_to(queries, p), signs)
    vmin = q_rot.amin(dim=-1)
    vmax = q_rot.amax(dim=-1)
    delta = ((vmax - vmin) / LUT_LEVELS).clamp_min(EPS_TINY)
    q_u = torch.round((q_rot - vmin[:, None]) / delta[:, None]).to(
        torch.int32).clamp(0, int(LUT_LEVELS))
    sum_u = q_u.sum(dim=-1).float()
    coeff_a = 2.0 * delta * inv_sqrt_p
    coeff_b = 2.0 * vmin * inv_sqrt_p
    coeff_c = -(float(p) * vmin + delta * sum_u) * inv_sqrt_p
    return QueryCode(q_u=q_u, coeff_a=coeff_a, coeff_b=coeff_b,
                     coeff_c=coeff_c, q_rot=q_rot)
