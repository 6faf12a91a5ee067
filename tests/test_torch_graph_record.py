"""The JAX package's graph record (results/synthetic-1m-128d_graph_results.json:
the graph engine at k = 100) at a small size, through both packages' eval
harness, and the records that chip_smoke.py drives on the card.

Both packages run ``utils.eval.bench_one_case(engine="graph", k=100)`` on the
same seed-made data (the record's recipe: clustered Gaussian rows, queries a
stored row plus noise).  R = 32 and k = 100 give the record's beam shape,
beam_cap = max(2R, 4k) = 400.  The index each harness built is caught as
it is finalized, so its step budget and its ids are read from the very
index whose recall the harness measured.  Each tolerance is stated where
it is checked.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from cphnsw_tpu.api.index import CPIndex as JCPIndex
from cphnsw_tpu.utils import eval as jeval
from cphnsw_tpu_torch import CPIndex
from cphnsw_tpu_torch.utils import eval as teval
from cphnsw_tpu_torch.utils.datasets import make_synthetic

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
N, DIM, N_QUERIES, K, BITS = 3072, 32, 64, 100, 1
# 48 clusters of ~64 rows: a query's top 100 spans clusters, so recall@100
# stays well below 1 and the comparison has something to hold.
N_CLUSTERS = 48
# Recall@1/10/100 of the port within this of the JAX package's (absolute).
RECALL_TOL = 0.005
# Share of the k = 100 ids the two packages' indexes both return.
MIN_OVERLAP = 0.99


def _caught(cls):
    """Patch cls.finalize to keep the last instance finalized; returns
    (the list it appends to, the original finalize)."""
    seen, real = [], cls.finalize

    def finalize(self, *args, **kw):
        out = real(self, *args, **kw)
        seen.append(self)
        return out

    cls.finalize = finalize
    return seen, real


@pytest.fixture(scope="module")
def cases():
    """{package: (CaseResult, the index it built, its ids at k = 100)}."""
    data = make_synthetic("synthetic", n=N, dim=DIM, n_queries=N_QUERIES,
                          gt_k=K, n_clusters=N_CLUSTERS, seed=0,
                          cache_dir=None, gt_device="cpu")
    base, queries = data["base"], data["queries"]
    truth = data["groundtruth"].astype(np.int64)
    out = {}
    for name, harness, cls, kw in (("jax", jeval, JCPIndex, {}),
                                   ("torch", teval, CPIndex,
                                    {"device": "cpu"})):
        seen, real = _caught(cls)
        try:
            case = harness.bench_one_case(
                base, queries, truth, dim=DIM, bits=BITS, k=K, n_runs=1,
                engine="graph", **kw)
        finally:
            cls.finalize = real
        index = seen[-1]
        ids = np.asarray(index.search_batch(queries, k=K)[0])
        out[name] = (case, index, ids)
    return out


def test_record_shape(cases):
    """The search runs at the record's beam shape: beam_cap 400."""
    g = cases["torch"][1]._index
    assert g._r == 32 and max(2 * g._r, 4 * K) == 400
    assert cases["torch"][0].engine == cases["jax"][0].engine == "graph"


def test_step_budget_equals_jax(cases):
    (jcase, jidx, _), (tcase, tidx, _) = cases["jax"], cases["torch"]
    assert tidx._index._step_budget == jidx._index._step_budget
    assert tidx._index._max_steps(K) == jidx._index._max_steps(K)
    assert tcase.search_budget == jcase.search_budget


def test_ids_overlap_jax(cases):
    a, b = cases["jax"][2], cases["torch"][2]
    assert a.shape == b.shape == (N_QUERIES, K)
    overlap = float((a[:, :, None] == b[:, None, :]).any(-1).mean())
    assert overlap >= MIN_OVERLAP, overlap


@pytest.mark.parametrize("field", ["recall_at_1", "recall_at_10",
                                   "recall_at_100"])
def test_recall_within_tolerance_of_jax(cases, field):
    jax_value = getattr(cases["jax"][0], field)
    port_value = getattr(cases["torch"][0], field)
    assert abs(port_value - jax_value) <= RECALL_TOL, (port_value, jax_value)


RECORDS = sorted(p.name for p in (REPO / "results").glob("*_results.json"))


def test_records_exist():
    assert "synthetic-1m-128d_graph_results.json" in RECORDS
    assert len(RECORDS) == len(chip_smoke.recorded_runs())


@pytest.mark.parametrize("record", RECORDS)
def test_every_record_has_a_phase(record):
    """Each JAX record is read by a phase of chip_smoke.py through
    jax_record, under the engine suffix run_benchmark gives it."""
    runs = {chip_smoke.record_path(name, engine).name: (phase, name, engine)
            for phase, name, engine in chip_smoke.recorded_runs()}
    assert record in runs, f"{record}: no phase of chip_smoke.py runs it"
    phase, name, engine = runs[record]
    meta = json.loads((REPO / "results" / record).read_text())["metadata"]
    assert meta["dataset"] == name
    assert meta.get("engine", "auto") == engine
    cases_ = chip_smoke.jax_record(name, engine)
    assert cases_ and all(c.startswith("cphnsw-tpu-") for c in cases_)
    if phase == "12g":
        # a graph record runs on the data its scan workload drew
        assert name in {w for w, _, _ in chip_smoke.WORKLOADS}
        assert (name, meta["k"]) in {(w, k) for w, k, _ in
                                     chip_smoke.GRAPH_WORKLOADS}


def test_chip_smoke_needs_a_card(monkeypatch):
    """chip_smoke imports without a card and exits non-zero, before
    printing a result, when CUDA is not available."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code != 0
