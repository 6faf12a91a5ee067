"""Build the 1M x 128d 1-bit graph indexes of each given checkout on one GPU.

    python3 graph_build_compare.py DIR [DIR ...]

Each DIR is a checkout of this repository (for instance one unpacked with
``git archive`` into a directory that .gitignore lists); a DIR may repeat,
so that "old new new old" puts two versions side by side in one call.  For
each DIR in turn, in a process of its own that imports that checkout's
``cphnsw_tpu_torch``: the 1M x 128d store drawn on the card from the
Threefry recipe (seed 0, 256 clusters, 8192 queries, ground truth on the
card); CPIndex(128, bits=1, engine="graph") built and finalized, then
ShardedIndex(128, bits=1, r=32) built on a (1, 4) mesh of the card; for
each build its stages, the wall seconds of its NNDescent calls (each ending
on a device sync) and its peak device memory, and recall@10 of the first
1024 queries on the single-device index.  Prints one JSON line per
checkout, then the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

N, DIM, QUERIES, K = 1_000_000, 128, 1024, 10


def worker():
    sys.path.insert(0, os.getcwd())         # the checkout, not this file's
    import numpy as np
    import torch

    from cphnsw_tpu_torch import CPIndex
    from cphnsw_tpu_torch.graph import nndescent
    from cphnsw_tpu_torch.parallel import sharded
    from cphnsw_tpu_torch.utils.datasets import make_synthetic
    from cphnsw_tpu_torch.utils.eval import recall_at_k

    spent = [0.0]
    run_adaptive = nndescent.run_adaptive

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = run_adaptive(*args, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    nndescent.run_adaptive = timed

    def build(fn, index):
        """Stages etc. of fn(); `index` gives the built index afterwards."""
        spent[0] = 0.0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return dict(build_s=round(time.perf_counter() - t0, 3),
                    stages=index().build_stages,
                    nndescent_s=round(spent[0], 3),
                    peak_gib=round(torch.cuda.max_memory_allocated() / 2**30,
                                   3))

    data = make_synthetic(f"synthetic-{N // 1000}k-{DIM}d", n_queries=8192,
                          gt_k=K, n_clusters=256, seed=0, gt_device="cuda",
                          cache_dir=None)
    idx = CPIndex(DIM, bits=1, engine="graph", device="cuda")
    graph = build(lambda: (idx.build(data["base"]), idx.finalize()),
                  lambda: idx._index)
    ids, dists = idx.search_batch(data["queries"][:QUERIES], k=K)
    if not np.isfinite(dists).all():
        raise SystemExit("non-finite distances")
    graph["recall_at_10"] = recall_at_k(ids, data["groundtruth"][:QUERIES],
                                        K)
    del idx
    torch.cuda.empty_cache()
    mesh = sharded.make_mesh(1, 4, [torch.device("cuda", 0)] * 4)
    sidx = sharded.ShardedIndex(DIM, bits=1, r=32)
    shard = build(lambda: sidx.build(data["base"], mesh), lambda: sidx)
    print(json.dumps(dict(tree=os.getcwd(), graph=graph,
                          sharded_graph=shard)), flush=True)


def main(dirs):
    if not dirs:
        raise SystemExit(__doc__)
    for d in dirs:
        d = str(Path(d).resolve())
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker"],
            cwd=d, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"{d}: exit {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        worker()
    else:
        main(sys.argv[1:])
