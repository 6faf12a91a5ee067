"""Graph topology statistics: data-derived alpha / tau / alpha_max.

PyTorch counterpart of ``cphnsw_tpu/graph/stats.py``: a sqrt(n)-sample
estimate of the neighbour-distance distribution.  The sample is drawn with
the same numpy seed as the JAX package; the inter-neighbour distances come
from the device, the quantile/MAD scalar math runs on the host.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np
import torch

from cphnsw_tpu_torch.calibration.huber import MAD_NORM_FACTOR
from cphnsw_tpu_torch.graph.pruning import candidate_pair_dists


@dataclass
class GraphStats:
    avg_degree: float = 0.0
    alpha: float = 1.0
    tau: float = 0.0
    alpha_max: float = 4.0

    def to_dict(self):
        return asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


def derive_graph_stats(raw, norm_sq, work_ids, work_dists, sample_size: int,
                       seed: int = 43) -> GraphStats:
    """alpha = median neighbour dist / Q1 inter-neighbour dist, clamped to
    [1, min(Q3/Q1, 5)]; tau = MAD-sigma of NN distances; alpha_max =
    max(clamp, 2*alpha).  Inter-neighbour pairs are limited to the first
    2*sqrt(R) neighbours per sampled node."""
    ids = work_ids.cpu().numpy()
    dists = work_dists.cpu().numpy()
    n, r = ids.shape
    stats = GraphStats()
    if n == 0:
        return stats

    valid = ids >= 0
    stats.avg_degree = float(valid.sum(1).mean())

    rng = np.random.default_rng(seed)
    sample = rng.permutation(n)[: min(sample_size, n)]

    neighbor_dists = dists[sample][valid[sample]]
    nn_mask = valid[sample][:, 0]
    nn_dists = dists[sample][:, 0][nn_mask]

    inter_limit = int(np.clip(2.0 * np.sqrt(r), 4, r))
    sub_ids = torch.from_numpy(
        np.ascontiguousarray(ids[sample][:, :inter_limit])).to(raw.device)
    pd = candidate_pair_dists(raw, norm_sq, sub_ids).cpu().numpy()
    iu = np.triu_indices(inter_limit, k=1)
    inter = pd[:, iu[0], iu[1]].ravel()
    inter = inter[np.isfinite(inter) & (inter < 1e30)]

    if neighbor_dists.size == 0 or inter.size == 0 or nn_dists.size == 0:
        stats.alpha, stats.tau, stats.alpha_max = 1.0, 0.0, 4.0
        return stats

    # squared L2 throughout, as in the working graph
    nd_median = float(np.median(neighbor_dists))
    nd_q1 = float(np.quantile(neighbor_dists, 0.25))
    nd_q3 = float(np.quantile(neighbor_dists, 0.75))
    q3_over_q1 = nd_q3 / nd_q1 if nd_q1 > 1e-12 else 2.0

    nd_mean = float(neighbor_dists.mean())
    nd_cv = (float(neighbor_dists.std() / nd_mean) if nd_mean > 1e-12
             else 0.2)

    nn_median = float(np.median(nn_dists))
    nn_mad = float(np.median(np.abs(nn_dists - nn_median)))
    tau = MAD_NORM_FACTOR * nn_mad

    d_inter = float(np.quantile(inter, 0.25))
    alpha = 1.0 + nd_cv if d_inter < 1e-12 else nd_median / d_inter

    alpha_max = min(q3_over_q1, 5.0)
    alpha = float(np.clip(alpha, 1.0, alpha_max))
    alpha_max = max(alpha_max, 2.0 * alpha)

    stats.alpha, stats.tau, stats.alpha_max = alpha, tau, float(alpha_max)
    return stats
