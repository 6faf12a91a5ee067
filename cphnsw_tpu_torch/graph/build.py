"""Graph construction orchestrator: NNDescent -> alpha-CNG -> edge codes.

PyTorch counterpart of ``cphnsw_tpu/graph/build.py``:

  1. adaptive NNDescent (graph/nndescent.py);
  2. data-derived alpha/tau/alpha_max (graph/stats.py);
  3. alpha-CNG prune of every node's working list (graph/pruning.py);
  4. reverse-edge pass: re-prune with capped reverse candidates merged in;
  5. hub entry point (max degree among the sqrt(n) nodes nearest the
     centroid) + BFS renumbering for locality;
  6. edge-residual codes: every selected neighbour quantized relative to
     its parent vertex, batched over node chunks.

The result is a ``NeighborStore`` whose fused per-node row layout is the
JAX package's, so index files cross over between the packages.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from cphnsw_tpu_torch.graph import nndescent, pruning, stats as gstats
from cphnsw_tpu_torch.ops import hadamard, pack, quantize
from cphnsw_tpu_torch.utils import native

# Node-chunk caps (the 2 GB gather budget of nndescent._chunk_for binds
# first at R = 32, P = 128).
PRUNE_CHUNK = 1 << 16
ENCODE_CHUNK = 1 << 17


class NeighborStore:
    """Per-edge search data in a FUSED per-node int32 row:
    [ids (R)] [nop (R)] [ip_qo (R)] [ip_cp (R)] [wpc (R)] [planes
    (R*bits*W), plane-major (MSB plane first), words inner] [zero pad to a
    multiple of 128].  Aux channels are f32 bit patterns and planes the
    u32 words' bits, both held in int32 (``Tensor.view``); one row gather
    per popped node serves the whole search step.  ``ids`` is also kept
    standalone."""

    def __init__(self, ids, fused, r: int, bits: int, words: int):
        self.ids = ids      # (N, R) int32, -1 = none
        self.fused = fused  # (N, F) int32
        self.r = r
        self.bits = bits
        self.words = words

    @property
    def aux(self) -> torch.Tensor:
        """(N, R, 4) f32: nop, ip_qo, ip_cp, wpc."""
        r = self.r
        chans = [self.fused[:, (1 + c) * r:(2 + c) * r].view(torch.float32)
                 for c in range(4)]
        return torch.stack(chans, dim=-1)

    @property
    def planes(self) -> torch.Tensor:
        """(N, R, bits, W) int32 words."""
        n = self.fused.shape[0]
        end = (5 + self.bits * self.words) * self.r
        pw = self.fused[:, 5 * self.r:end].reshape(
            n, self.bits, self.words, self.r)
        return pw.permute(0, 3, 1, 2)

    @property
    def nop(self) -> torch.Tensor:
        """(N, R) f32 residual norms ||neighbour - parent||."""
        return self.aux[..., 0]

    @property
    def ip_qo(self) -> torch.Tensor:
        return self.aux[..., 1]

    @property
    def ip_cp(self) -> torch.Tensor:
        return self.aux[..., 2]

    @property
    def wpc(self) -> torch.Tensor:
        """(N, R) f32 weighted popcounts of the edge codes."""
        return self.aux[..., 3]

    @staticmethod
    def pack(ids, planes, aux) -> "NeighborStore":
        """Fused layout from ids (N, R) int32, planes (N, R, bits, W)
        int32 and aux (N, R, 4) f32."""
        n, r = ids.shape
        bits, w = planes.shape[-2], planes.shape[-1]
        aux_i = aux.float().contiguous().view(torch.int32)
        chans = [aux_i[:, :, c] for c in range(4)]
        planes_i = planes.permute(0, 2, 3, 1).reshape(n, bits * w * r)
        fused = torch.cat([ids.to(torch.int32), *chans, planes_i], dim=1)
        if fused.shape[1] % 128:
            fused = torch.nn.functional.pad(
                fused, (0, 128 - fused.shape[1] % 128))
        return NeighborStore(ids=ids.to(torch.int32), fused=fused, r=r,
                             bits=bits, words=w)


@dataclass
class BuildResult:
    neighbors: NeighborStore
    entry_point: int
    stats: gstats.GraphStats
    old_to_new: np.ndarray   # BFS permutation applied to all arrays
    raw: torch.Tensor        # permuted
    norm_sq: torch.Tensor
    node_nop: torch.Tensor   # permuted ||x - centroid||
    stages: dict             # seconds per build stage


def _chunked_prune(raw, norm_sq, cand_ids, cand_dists, node_nop, alpha, tau,
                   alpha_max, r: int, error_tolerance: float,
                   chunk: int | None = None):
    """alpha-CNG prune of every node's candidate list, `chunk` nodes at a
    time (default: what the gather budget allows); the chunk size changes
    no result."""
    n, c = cand_ids.shape
    if chunk is None:
        chunk = nndescent._chunk_for(n, c, raw.shape[1], PRUNE_CHUNK)
    sel_ids = torch.empty((n, r), dtype=torch.int32, device=raw.device)
    sel_dists = torch.empty((n, r), dtype=torch.float32, device=raw.device)
    for s in range(0, n, chunk):
        ci, cd = pruning.prepare_candidates(cand_ids[s:s + chunk],
                                            cand_dists[s:s + chunk])
        pd = pruning.candidate_pair_dists(raw, norm_sq, ci)
        err = torch.where(
            ci >= 0, error_tolerance * node_nop[ci.clamp_min(0).long()], 0.0)
        si, sd = pruning.select_alpha_cng(ci, cd, pd, err, alpha, tau,
                                          alpha_max, r)
        sel_ids[s:s + chunk] = si
        sel_dists[s:s + chunk] = sd
    return sel_ids, sel_dists


def _reverse_candidates(sel_ids, sel_dists, r_rev: int):
    """Reverse edges capped at r_rev per target, keeping the closest
    sources: the native host op, else a numpy lexsort."""
    ids_h = sel_ids.cpu().numpy()
    dists_h = sel_dists.cpu().numpy()
    dev = sel_ids.device
    nat = native.reverse_topk(ids_h, dists_h, r_rev)
    if nat is not None:
        return torch.from_numpy(nat[0]).to(dev), torch.from_numpy(
            nat[1]).to(dev)

    n, r = ids_h.shape
    src = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], (n, r)).ravel()
    tgt = ids_h.astype(np.int64).ravel()
    d = dists_h.ravel()
    valid = tgt >= 0
    src, tgt, d = src[valid], tgt[valid], d[valid]
    order = np.lexsort((d, tgt))
    src, tgt, d = src[order], tgt[order], d[order]
    rank = np.arange(tgt.size) - np.searchsorted(tgt, tgt, side="left")
    keep = rank < r_rev
    rev_ids = np.full((n, r_rev), -1, dtype=np.int32)
    rev_dists = np.full((n, r_rev), np.finfo(np.float32).max,
                        dtype=np.float32)
    rev_ids[tgt[keep], rank[keep]] = src[keep]
    rev_dists[tgt[keep], rank[keep]] = d[keep]
    return torch.from_numpy(rev_ids).to(dev), torch.from_numpy(
        rev_dists).to(dev)


def encode_neighbor_blocks(raw, sel_ids, signs, bits: int,
                           chunk: int | None = None) -> NeighborStore:
    """Edge-residual encoding of all selected edges, node-chunked: each
    chunk rotates and quantizes chunk*R residual vectors at once (`chunk`
    overrides the derived node count per chunk and changes no result)."""
    n, r = sel_ids.shape
    p = signs.shape[-1]
    if chunk is None:
        chunk = nndescent._chunk_for(n, r, p, ENCODE_CHUNK)
    w = pack.num_words(p)
    dev = raw.device
    planes = torch.empty((n, r, bits, w), dtype=torch.int32, device=dev)
    aux = torch.empty((n, r, 4), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        ids_c = sel_ids[s:s + chunk]
        b = ids_c.shape[0]
        parents = raw[s:s + chunk]
        nbr_vecs = raw[ids_c.clamp_min(0).long()].reshape(b * r, p)
        rot_parents = hadamard.rotate(parents, signs)
        enc = quantize.encode_residuals(
            parents.repeat_interleave(r, dim=0), nbr_vecs,
            rot_parents.repeat_interleave(r, dim=0), signs, bits)
        invalid = ids_c < 0
        u = torch.where(invalid[:, :, None], 0, enc.u.reshape(b, r, p))
        planes[s:s + chunk] = pack.pack_planes(u, bits)
        aux[s:s + chunk] = torch.stack([
            torch.where(invalid, 0.0, enc.nop.reshape(b, r)),
            torch.where(invalid, 0.0, enc.ip_qo.reshape(b, r)),
            torch.where(invalid, 0.0, enc.ip_cp.reshape(b, r)),
            pack.weighted_popcount(u).float(),
        ], dim=-1)
    return NeighborStore.pack(sel_ids, planes, aux)


def find_hub_entry(raw, centroid, sel_ids) -> int:
    """Max-degree node among the sqrt(n) nearest to the centroid (the
    nearest of them on a degree tie)."""
    n = raw.shape[0]
    top_k = max(1, int(math.isqrt(n)))
    d = ((raw - centroid) ** 2).sum(dim=-1)
    _, near = nndescent.top_k_smallest(d[None], top_k)
    near = near[0]
    degrees = (sel_ids[near] >= 0).sum(dim=-1).cpu().numpy()
    return int(near[int(np.argmax(degrees))])


def bfs_order(sel_ids: np.ndarray, entry: int) -> np.ndarray:
    """BFS permutation old_to_new: the native host op, else a numpy
    per-level BFS (unreached components follow in index order)."""
    nat = native.bfs_order(sel_ids, entry)
    if nat is not None:
        return nat

    n, _ = sel_ids.shape
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0

    def run(start):
        nonlocal pos
        if visited[start]:
            return
        frontier = np.array([start], dtype=np.int64)
        visited[start] = True
        while frontier.size:
            order[pos:pos + frontier.size] = frontier
            pos += frontier.size
            nxt = sel_ids[frontier].ravel()
            nxt = np.unique(nxt[nxt >= 0])
            nxt = nxt[~visited[nxt]]
            visited[nxt] = True
            frontier = nxt

    run(entry)
    for i in range(n):
        if not visited[i]:
            run(i)
    old_to_new = np.empty(n, dtype=np.int64)
    old_to_new[order] = np.arange(n)
    return old_to_new


def build_graph(raw, norm_sq, node_nop, signs, bits: int, r: int,
                seed: int = 42, verbose: bool = False) -> BuildResult:
    """The whole build on raw's device; per-stage wall seconds (device
    synchronized at each stage end) land in BuildResult.stages and are
    printed as ``build_graph/<stage>: <s>s`` when verbose."""
    n, p = raw.shape
    error_tolerance = 1.0 / math.sqrt(float(p))
    stages: dict[str, float] = {}
    t_last = time.perf_counter()

    def mark(label):
        nonlocal t_last
        if raw.device.type == "cuda":
            torch.cuda.synchronize(raw.device)
        now = time.perf_counter()
        stages[label] = round(now - t_last, 3)
        t_last = now
        if verbose:
            print(f"build_graph/{label}: {stages[label]:.1f}s", flush=True)

    centroid = raw.mean(dim=0)
    wg = nndescent.run_adaptive(raw, norm_sq, r, seed=seed, verbose=verbose)
    mark("nndescent")

    st = gstats.derive_graph_stats(raw, norm_sq, wg.ids, wg.dists,
                                   sample_size=max(int(math.isqrt(n)), 16))
    mark("stats")

    prune = dict(alpha=st.alpha, tau=st.tau, alpha_max=st.alpha_max, r=r,
                 error_tolerance=error_tolerance)
    sel_ids, sel_dists = _chunked_prune(raw, norm_sq, wg.ids, wg.dists,
                                        node_nop, **prune)
    del wg
    mark("prune")

    rev_ids, rev_dists = _reverse_candidates(sel_ids, sel_dists, r_rev=2 * r)
    sel_ids, sel_dists = _chunked_prune(
        raw, norm_sq, torch.cat([sel_ids, rev_ids], dim=1),
        torch.cat([sel_dists, rev_dists], dim=1), node_nop, **prune)
    mark("reverse+prune")

    hub = find_hub_entry(raw, centroid, sel_ids)
    sel_np = sel_ids.cpu().numpy()
    old_to_new = bfs_order(sel_np, hub)
    new_to_old = np.empty_like(old_to_new)
    new_to_old[old_to_new] = np.arange(n)
    remapped = np.where(sel_np >= 0, old_to_new[np.maximum(sel_np, 0)], -1)
    sel_ids_perm = torch.from_numpy(
        remapped[new_to_old].astype(np.int32)).to(raw.device)
    perm = torch.from_numpy(new_to_old).to(raw.device)
    raw_perm, norm_perm, nop_perm = raw[perm], norm_sq[perm], node_nop[perm]
    mark("reorder")

    neighbors = encode_neighbor_blocks(raw_perm, sel_ids_perm, signs, bits)
    mark("encode_blocks")
    return BuildResult(
        neighbors=neighbors,
        entry_point=int(old_to_new[hub]),
        stats=st,
        old_to_new=old_to_new,
        raw=raw_perm,
        norm_sq=norm_perm,
        node_nop=nop_perm,
        stages=stages,
    )
