"""The port's benchmark harness and CLI against the JAX package's contract:
the same results-JSON schema (CaseResult's field names) and the same
JSON-lines events."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cphnsw_tpu.utils import eval as jeval
from cphnsw_tpu_torch import __main__ as cli
from cphnsw_tpu_torch.utils import eval as teval

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SUMMARY_KEYS = {"dataset", "algorithm", "build_time_min", "memory_gib",
                "recall_at_10", "qps"}


def write_config(tmp_path, dataset="synthetic-2k-16d"):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"""run:
  output_dir: {tmp_path / 'results'}

data:
  dataset: {dataset}
  base_dir: {tmp_path}

eval:
  k: 10
  n_runs: 1
""")
    return cfg


def test_case_result_schema_is_the_jax_one():
    names = [f.name for f in dataclasses.fields(teval.CaseResult)]
    assert names == [f.name for f in dataclasses.fields(jeval.CaseResult)]
    assert teval.DEFAULT_BITS == jeval.DEFAULT_BITS
    assert teval.ADR_AT == jeval.ADR_AT


def test_run_benchmark_on_cpu(tmp_path):
    out = teval.run_benchmark(
        "synthetic-2k-16d", tmp_path, k=10, n_runs=2, output_dir=tmp_path,
        bit_widths=[1], device="cpu")
    case = out["results"][0]
    assert set(case) == {f.name for f in
                         dataclasses.fields(jeval.CaseResult)}
    assert case["algorithm"] == "cphnsw-tpu-1bit"
    assert case["engine"] == "scan"
    assert case["recall_at_10"] > 0.8 and case["qps"] > 0
    # ADR >= 1 by definition (found dists cannot beat ground truth)
    assert case["adr"] >= 0.999
    stages = case["build_stages_s"]
    assert {"encode", "calibrate", "candidate_budget",
            "unattributed"} <= set(stages)
    assert case["search_budget"]["top_c_at_k"] >= 10
    saved = json.loads(
        (tmp_path / "synthetic-2k-16d_results.json").read_text())
    assert saved["metadata"]["device"] == "cpu"
    assert saved["metadata"]["n_base"] == 2000
    assert saved["results"] == out["results"]


def test_run_benchmark_graph_engine(tmp_path):
    out = teval.run_benchmark(
        "synthetic-2k-16d", tmp_path, k=10, n_runs=1, output_dir=tmp_path,
        bit_widths=[1], engine="graph", device="cpu")
    case = out["results"][0]
    assert case["engine"] == "graph" and case["recall_at_10"] > 0.8
    assert set(case["search_budget"]["step_budget"]) == {"10", "100"}
    assert (tmp_path / "synthetic-2k-16d_graph_results.json").exists()


def test_cli_json_lines(tmp_path):
    cfg = write_config(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "cphnsw_tpu_torch", "--config", str(cfg),
         "--bits", "1", "--device", "cpu", "--profile-dir",
         str(tmp_path / "prof")],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    events = [json.loads(ln) for ln in proc.stdout.splitlines()
              if ln.startswith("{")]
    assert [e["event"] for e in events] == ["benchmark_start", "summary"]
    assert SUMMARY_KEYS <= set(events[1])
    assert events[1]["algorithm"] == "cphnsw-tpu-1bit"
    assert (tmp_path / "results" / "synthetic-2k-16d_results.json").exists()
    # the profiled pass writes a torch.profiler Chrome trace
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_cli_never_falls_back_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--config", str(write_config(tmp_path))])


def test_config_parsers_agree():
    text = (REPO / "configs" / "smoke.yaml").read_text()
    yaml = pytest.importorskip("yaml")
    assert cli._parse_two_level(text) == yaml.safe_load(text)
    assert cli.read_config(REPO / "configs" / "smoke.yaml")["eval"]["k"] == 100


def test_synthetic_shape_matches_the_generator():
    from cphnsw_tpu_torch.utils import datasets as tdata

    assert tdata.synthetic_shape("synthetic-1m-128d") == (1_000_000, 128,
                                                           "l2")
    assert tdata.synthetic_shape("synthetic-100k-1536d-ip") == (100_000, 1536,
                                                                "ip")
    ds = tdata.make_synthetic("synthetic-3k-8d", n_queries=5, gt_k=3,
                              cache_dir=None)
    assert ds["base"].shape == (3000, 8) and ds["groundtruth"].shape == (5, 3)
    # the on-device ground-truth threshold is the JAX package's
    assert teval.DEVICE_DATA_MIN_ELEMENTS == 64 << 20
    assert np.issubdtype(ds["groundtruth"].dtype, np.integer)
