"""Batched alpha-CNG neighbour selection.

PyTorch counterpart of ``cphnsw_tpu/graph/pruning.py``.  The per-node
greedy scan over distance-sorted candidates is sequential in the candidate
axis (each admission depends on the already-selected set): the JAX
package's vmapped ``fori_loop`` becomes a Python loop over that axis,
vectorised over a chunk of nodes, with the candidate-pairwise distance
matrix precomputed as one batched product.

Semantics:
  * dedup by id, sort by distance;
  * local_alpha = clamp(alpha * sqrt(n_cands / R), 1, alpha_max);
  * reject candidate c if some selected e has
      d(c, e) < local_alpha * d(c, q) + err_c + err_e - (local_alpha-1)*tau;
  * backfill remaining slots with the nearest unselected candidates.
"""

from __future__ import annotations

import torch

from cphnsw_tpu_torch.graph.nndescent import (
    FLOAT_MAX, INVALID, _dedup_sort_pairs, top_k_smallest)
from cphnsw_tpu_torch.ops.estimate import full_fp32


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def select_alpha_cng(cand_ids, cand_dists, pair_dists, cand_err, alpha, tau,
                     alpha_max, r: int):
    """Returns (sel_ids (N, R), sel_dists (N, R)): pruned + backfilled,
    distance-sorted.  pair_dists (N, C, C) must follow the given candidate
    order (callers run ``prepare_candidates`` first)."""
    n, c = cand_ids.shape
    dev = cand_ids.device
    alpha, tau, alpha_max = (_f32(v, dev) for v in (alpha, tau, alpha_max))
    valid = cand_ids >= 0
    n_valid = valid.sum(dim=1)
    local_alpha = alpha * torch.sqrt(n_valid.float().clamp_min(1.0) / float(r))
    local_alpha = torch.minimum(local_alpha.clamp_min(1.0),
                                alpha_max.clamp_min(1.0))
    la = local_alpha[:, None]
    slack = (local_alpha - 1.0)[:, None] * tau

    selected = torch.zeros((n, c), dtype=torch.bool, device=dev)
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    for i in range(c):
        thresholds = (la * cand_dists[:, i, None] + cand_err[:, i, None]
                      + cand_err - slack)
        conflict = selected & (pair_dists[:, i, :] < thresholds)
        ok = valid[:, i] & ~conflict.any(dim=1) & (count < r)
        selected[:, i] = ok
        count += ok.to(torch.int32)
    # if n_valid <= R everything valid is kept
    selected = torch.where((n_valid <= r)[:, None], valid, selected)

    # backfill: order by (selected desc, dist asc), take the first R; the
    # +1e18 keys of unselected candidates saturate, so among them the
    # (distance-sorted) candidate order decides
    sort_key = torch.where(~valid, FLOAT_MAX,
                           torch.where(selected, cand_dists, cand_dists + 1e18))
    top, order = top_k_smallest(sort_key, r)
    sel_ids = torch.gather(cand_ids, 1, order)
    sel_dists = torch.gather(cand_dists, 1, order)
    sel_ids = torch.where(top >= FLOAT_MAX, INVALID, sel_ids)
    sel_dists = torch.where(sel_ids < 0, FLOAT_MAX, sel_dists)
    return sel_ids, sel_dists


def candidate_pair_dists(raw, norm_sq, cand_ids):
    """(N, C, C) pairwise squared distances among each node's candidates,
    one batched fp32 product over the gathered vectors; pairs with an
    invalid candidate -> FLOAT_MAX."""
    safe = cand_ids.clamp_min(0).long()
    v = raw[safe]                                    # (N, C, P)
    ns = norm_sq[safe]                               # (N, C)
    with full_fp32():
        dots = torch.bmm(v, v.transpose(1, 2))
    d = (ns[:, :, None] + ns[:, None, :] - 2.0 * dots).clamp_min(0.0)
    invalid = (cand_ids < 0)[:, :, None] | (cand_ids < 0)[:, None, :]
    return torch.where(invalid, FLOAT_MAX, d)


def prepare_candidates(cand_ids, cand_dists):
    """Dedup by id keeping the best distance, then distance-sort."""
    ids_s, dists_s = _dedup_sort_pairs(cand_ids, cand_dists)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = (ids_s[:, 1:] == ids_s[:, :-1]) & (ids_s[:, 1:] >= 0)
    ids_s = torch.where(dup, INVALID, ids_s)
    dists_s = torch.where(ids_s < 0, FLOAT_MAX, dists_s)
    dists_o, order = torch.sort(dists_s, dim=1, stable=True)
    return torch.gather(ids_s, 1, order), dists_o
