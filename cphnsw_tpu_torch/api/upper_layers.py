"""HNSW upper layers: hierarchical entry-point selection.

PyTorch counterpart of ``cphnsw_tpu/api/upper_layers.py``: exponential
level assignment (level = floor(-ln(U) * mL), mL = 1/ln(M_UPPER)); one
navigable graph per level, built with the same batched NNDescent +
alpha-CNG machinery as layer 0 plus a reverse-edge pass, and made
reachable from the level's entry by bridging unreached regions on the
host; a batched beam descent from the top level at query time.

The levels come from the same numpy seed as the JAX package, so the level
subsets are equal; each level's NNDescent draws from the JAX package's
Threefry keys (seed + 100 + level), so the level graphs equal the JAX
package's up to a near tie that distances summed in another order flip.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from cphnsw_tpu_torch.graph import build as gbuild
from cphnsw_tpu_torch.graph import nndescent, pruning
from cphnsw_tpu_torch.graph.nndescent import top_k_smallest
from cphnsw_tpu_torch.ops.estimate import full_fp32

MIN_LAYER_RANDOM = 1e-15


def upper_layer_degree(r: int, padded_dim: int) -> int:
    """M_UPPER = R/2 + min(isqrt(P)/4, R/4)."""
    return r // 2 + min(math.isqrt(padded_dim) // 4, r // 4)


def assign_levels(n: int, m_upper: int, seed: int = 42) -> np.ndarray:
    """Exponentially decaying level assignment."""
    ml = 1.0 / math.log(max(m_upper, 2))
    rng = np.random.default_rng(seed)
    u = np.maximum(rng.uniform(size=n), MIN_LAYER_RANDOM)
    return np.floor(-np.log(u) * ml).astype(np.int32)


class UpperLayers(NamedTuple):
    node_ids: tuple          # per level: (n_l,) int32 global ids
    nbr_idx: tuple           # per level: (n_l, M) int32 local indices, -1
    local_of_global: tuple   # per level: (n,) int32 local index or -1
    entry_global: int        # global id of the single top-level entry


def _reached_from(sel: np.ndarray, entry: int) -> np.ndarray:
    """Directed BFS reachability from entry over out-edges."""
    reached = np.zeros(sel.shape[0], bool)
    reached[entry] = True
    frontier = np.array([entry])
    while frontier.size:
        out = sel[frontier].ravel()
        nxt = np.unique(out[out >= 0])
        nxt = nxt[~reached[nxt]]
        reached[nxt] = True
        frontier = nxt
    return reached


def _bridge_components(sub_raw: np.ndarray, sub_norm: np.ndarray,
                       sel: np.ndarray, entry_local: int) -> np.ndarray:
    """Make every node of a level graph reachable from the level entry by
    directed out-edges (what descent follows): each weakly-connected
    component of the unreached nodes is bridged, both ways, through its
    nearest pair to the reached set.  A bridge goes into the first free
    (-1) slot, else rotates through the last slots.  Host numpy."""
    sel = sel.copy()
    n_l, deg = sel.shape
    bridged = np.zeros(n_l, np.int64)

    def place(a: int, b: int):
        row = sel[a]
        if (row == b).any():
            return
        free = np.where(row < 0)[0]
        if free.size:
            row[free[0]] = b
        else:
            row[deg - 1 - (bridged[a] % deg)] = b
        bridged[a] += 1

    for _ in range(n_l):  # each pass strictly shrinks the unreached set
        reached = _reached_from(sel, entry_local)
        if reached.all():
            return sel
        comp = np.full(n_l, -1, np.int64)
        n_comp = 0
        for start in np.where(~reached)[0]:
            if comp[start] >= 0:
                continue
            comp[start] = n_comp
            frontier = np.array([start])
            while frontier.size:
                out = sel[frontier].ravel()
                out = out[out >= 0]
                out = out[~reached[out]]
                inc = np.where(~reached & np.isin(sel, frontier).any(axis=1))[0]
                nxt = np.unique(np.concatenate([out, inc]))
                nxt = nxt[comp[nxt] < 0]
                comp[nxt] = n_comp
                frontier = nxt
            n_comp += 1
        r_idx = np.where(reached)[0]
        for c in range(n_comp):
            idx = np.where(comp == c)[0]
            d = (sub_norm[idx][:, None] + sub_norm[r_idx][None, :]
                 - 2.0 * sub_raw[idx] @ sub_raw[r_idx].T)
            i, j = np.unravel_index(np.argmin(d), d.shape)
            a, b = int(idx[i]), int(r_idx[j])
            place(b, a)  # reached -> unreached makes the region reachable
            place(a, b)  # back edge keeps descent able to leave again
    # budget exhausted (slot rotation can undo an earlier bridge): force
    # direct entry -> node edges, up to the entry row's degree
    for _ in range(deg):
        missing = np.where(~_reached_from(sel, entry_local))[0]
        if missing.size == 0:
            return sel
        place(entry_local, int(missing[0]))
    warnings.warn("upper-layer bridging exhausted its budget with nodes "
                  "still unreachable from the entry; descent may start "
                  "suboptimally on this layer", RuntimeWarning)
    return sel


def build_upper_layers(raw, norm_sq, r: int, seed: int = 42
                       ) -> UpperLayers | None:
    """Build the hierarchy on raw's device; None when no level above 0
    holds two nodes."""
    n, p = raw.shape
    dev = raw.device
    m_up = upper_layer_degree(r, p)
    levels = assign_levels(n, m_up, seed)
    max_level = int(levels.max()) if n else 0
    # the query-time entry (first node of the highest level with >= 2
    # nodes) is known before any graph is built; every level bridges
    # towards it
    top_lvl = max((lv for lv in range(1, max_level + 1)
                   if (levels >= lv).sum() >= 2), default=0)
    if top_lvl == 0:
        return None
    entry_global = int(np.where(levels >= top_lvl)[0][0])

    node_ids, nbr_idx, local_maps = [], [], []
    for lvl in range(1, top_lvl + 1):
        subset = np.where(levels >= lvl)[0].astype(np.int32)
        n_l = len(subset)
        sub_t = torch.from_numpy(subset).to(dev).long()
        sub_raw, sub_norm = raw[sub_t], norm_sq[sub_t]
        deg = min(m_up, n_l - 1)
        if n_l <= deg + 1:
            # tiny level: fully connected
            sel = np.full((n_l, deg), -1, np.int32)
            for i in range(n_l):
                others = np.delete(np.arange(n_l, dtype=np.int32), i)[:deg]
                sel[i, :len(others)] = others
        else:
            wg = nndescent.run_adaptive(sub_raw, sub_norm, deg,
                                        seed=seed + 100 + lvl)

            def prune(ids, dists):
                ci, cd = pruning.prepare_candidates(ids, dists)
                pd = pruning.candidate_pair_dists(sub_raw, sub_norm, ci)
                return pruning.select_alpha_cng(
                    ci, cd, pd, torch.zeros_like(cd), 1.2, 0.0, 2.4, deg)

            sel_t, sel_d = prune(wg.ids, wg.dists)
            # bidirectional pass: merge reverse edges, re-prune
            rev_i, rev_d = gbuild._reverse_candidates(sel_t, sel_d, 2 * deg)
            sel_t, _ = prune(torch.cat([sel_t, rev_i], dim=1),
                             torch.cat([sel_d, rev_d], dim=1))
            sel = _bridge_components(
                sub_raw.cpu().numpy(), sub_norm.cpu().numpy(),
                sel_t.cpu().numpy(),
                int(np.searchsorted(subset, entry_global)))
        lm = np.full(n, -1, np.int32)
        lm[subset] = np.arange(n_l, dtype=np.int32)
        node_ids.append(sub_t.int())
        nbr_idx.append(torch.from_numpy(sel).to(dev))
        local_maps.append(torch.from_numpy(lm).to(dev))
    return UpperLayers(node_ids=tuple(node_ids), nbr_idx=tuple(nbr_idx),
                       local_of_global=tuple(local_maps),
                       entry_global=entry_global)


def _dists(qpad, qnorm, raw, norm_sq, ids):
    """|q|^2 + |x|^2 - 2<q, x> for ids (Q, M), full fp32, unclamped."""
    with full_fp32():
        dots = torch.bmm(raw[ids], qpad[:, :, None])[..., 0]
    return qnorm[:, None] + norm_sq[ids] - 2.0 * dots


def greedy_descend(upper: UpperLayers, raw, norm_sq, qpad, qnorm,
                   max_iters: int = 32, ef: int = 8) -> torch.Tensor:
    """Beam descent through all levels; returns (Q, ef) global entry ids
    for layer 0 (-1 for slots never filled with a real node).  ef > 1
    carries the ef best nodes per level instead of one greedy walker,
    which keeps descent from stranding in the entry's cluster."""
    q = qpad.shape[0]
    dev = raw.device
    cur_global = torch.full((q, 1), upper.entry_global, dtype=torch.int64,
                            device=dev)
    cur_d = _dists(qpad, qnorm, raw, norm_sq, cur_global)

    for lvl in range(len(upper.node_ids) - 1, -1, -1):
        ids_l = upper.node_ids[lvl].long()
        nbrs_l = upper.nbr_idx[lvl]
        cur_local = upper.local_of_global[lvl][cur_global].long()
        width = min(ef, ids_l.shape[0])
        if cur_local.shape[1] < width:
            pad = width - cur_local.shape[1]
            cur_local = torch.cat(
                [cur_local, cur_local[:, :1].expand(q, pad)], dim=1)
            cur_d = torch.cat(
                [cur_d, torch.full((q, pad), torch.inf, device=dev)], dim=1)
        e = cur_local.shape[1]
        earlier = None
        for _ in range(max_iters):
            nb = nbrs_l[cur_local].reshape(q, -1).long()         # (Q, e*M)
            nb_safe = nb.clamp_min(0)
            d = _dists(qpad, qnorm, raw, norm_sq, ids_l[nb_safe])
            d = torch.where(nb < 0, torch.inf, d)
            # dedup within the union (keep the first occurrence)
            cat_l = torch.cat([cur_local, nb_safe], dim=1)
            cat_d = torch.cat([cur_d, d], dim=1)
            if earlier is None:
                m = torch.arange(cat_l.shape[1], device=dev)
                earlier = m[:, None] > m[None, :]
            dup = ((cat_l[:, :, None] == cat_l[:, None, :])
                   & earlier).any(dim=-1)
            new_d, sel = top_k_smallest(torch.where(dup, torch.inf, cat_d), e)
            better = new_d[:, 0] < cur_d[:, 0]
            cur_local, cur_d = cat_l.gather(1, sel), new_d
            if not bool(better.any()):
                break
        cur_global = ids_l[cur_local]
    return torch.where(torch.isinf(cur_d), -1, cur_global).to(torch.int32)
