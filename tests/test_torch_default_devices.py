"""The port's entry points that place data on a device default to the card,
as the JAX package's land on its default device, and raise without CUDA:
none of them moves to the CPU by itself.  A CPU caller says so.
"""

import numpy as np
import pytest
import torch

from cphnsw_tpu.utils import datasets as jdata
from cphnsw_tpu_torch.ops import hadamard
from cphnsw_tpu_torch.parallel import sharded
from cphnsw_tpu_torch.search import beam
from cphnsw_tpu_torch.utils import datasets as tdata
from cphnsw_tpu_torch.utils import eval as teval

torch.set_num_threads(2)

# n * dim = 128M, above DEVICE_DATA_MIN_ELEMENTS
LARGE = "synthetic-1m-128d"
SMALL = "synthetic-2k-16d"
KW = dict(n_queries=20, gt_k=5, n_clusters=8, seed=3)


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def forbid_drawing(monkeypatch):
    """Make any draw or ground-truth computation fail."""
    def boom(*a, **kw):
        raise AssertionError("drew before checking the device")
    monkeypatch.setattr(tdata, "_device_synthetic", boom)
    monkeypatch.setattr(tdata, "_host_groundtruth", boom)
    monkeypatch.setattr(tdata, "device_groundtruth", boom)
    monkeypatch.setattr(tdata.np.random, "default_rng", boom)


def test_make_synthetic_large_store_defaults_to_cuda(no_cuda, monkeypatch,
                                                     tmp_path):
    assert np.prod(tdata.synthetic_shape(LARGE)[:2]) >= \
        tdata.DEVICE_DATA_MIN_ELEMENTS
    forbid_drawing(monkeypatch)
    with pytest.raises(RuntimeError, match="cuda"):
        tdata.make_synthetic(LARGE, cache_dir=None)
    with pytest.raises(RuntimeError, match="cuda"):
        tdata.load_dataset(LARGE, tmp_path)


def test_make_synthetic_small_store_keeps_the_host_recipe(no_cuda):
    """Below the threshold the default needs no CUDA, as in the JAX
    package: its host recipe and host ground truth."""
    got = tdata.make_synthetic(SMALL, cache_dir=None, **KW)
    want = jdata.make_synthetic(SMALL, cache_dir=None, **KW)
    for name in ("base", "queries", "groundtruth"):
        np.testing.assert_array_equal(got[name], want[name])
    assert "base_dev_factory" not in got


def test_make_synthetic_cpu_takes_the_host_recipe(no_cuda, monkeypatch):
    """With the threshold below the store, gt_device="cpu" gives the host
    recipe (the JAX package's arrays off its accelerator) and its ground
    truth by fp32 products on the CPU."""
    monkeypatch.setattr(tdata, "DEVICE_DATA_MIN_ELEMENTS", 1)
    with pytest.raises(RuntimeError, match="cuda"):
        tdata.make_synthetic(SMALL, cache_dir=None, **KW)
    got = tdata.make_synthetic(SMALL, cache_dir=None, gt_device="cpu", **KW)
    want = jdata.make_synthetic(SMALL, cache_dir=None, **KW)
    np.testing.assert_array_equal(got["base"], want["base"])
    np.testing.assert_array_equal(got["queries"], want["queries"])
    # the same exact neighbours (distances far apart on continuous data)
    np.testing.assert_array_equal(np.sort(got["groundtruth"], 1),
                                  np.sort(want["groundtruth"], 1))
    assert "base_dev_factory" not in got


def test_run_benchmark_on_cpu_draws_the_host_recipe(monkeypatch, tmp_path):
    """A benchmark on the CPU passes the CPU on to the data of a large
    store: the host recipe, no CUDA needed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdata, "DEVICE_DATA_MIN_ELEMENTS", 1)
    monkeypatch.setattr(teval, "DEVICE_DATA_MIN_ELEMENTS", 1)
    monkeypatch.setattr(tdata, "_read_cache", lambda path: None)
    monkeypatch.setattr(tdata, "_write_cache", lambda path, data: None)
    report = teval.run_benchmark(SMALL, tmp_path, k=5, n_runs=1,
                                 output_dir=tmp_path, bit_widths=[1],
                                 device="cpu")
    assert report["metadata"]["device"] == "cpu"
    assert report["results"][0]["recall_at_10"] >= 0.9


def test_build_sharded_store_defaults_to_cuda(no_cuda):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((200, 8)).astype(np.float32)
    signs = hadamard.rotation_signs(hadamard.DEFAULT_ROTATION_SEED, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        sharded.build_sharded_store(x, 1, 8, 2, signs)
    shards = sharded.build_sharded_store(
        x, 1, 8, 2, signs, devices=[torch.device("cpu")] * 2)
    assert len(shards) == 2
    assert all(s.raw.device.type == "cpu" for s in shards)
    ids = np.sort(np.concatenate([s.orig_ids.numpy() for s in shards]))
    np.testing.assert_array_equal(ids, np.arange(200))


def test_search_params_default_defaults_to_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="cuda"):
        beam.SearchParams.default()
    with pytest.raises(RuntimeError, match="cuda"):
        beam.SearchParams.default(7)
    got = beam.SearchParams.default(device="cpu")
    assert got.slack_levels.device.type == "cpu"
