"""The PyTorch port's dataset and metric utilities against the JAX
package's: the synthetic data must be bit-identical for the same seed."""

import numpy as np
import pytest
import torch

from cphnsw_tpu.utils import datasets as jdata
from cphnsw_tpu.utils import eval as jeval
from cphnsw_tpu_torch.utils import datasets as tdata
from cphnsw_tpu_torch.utils import eval as teval

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["synthetic-3k-24d", "synthetic-2k-16d-ip"])
def test_make_synthetic_bit_identical(name):
    kw = dict(n_queries=50, gt_k=10, n_clusters=8, seed=3)
    want = jdata.make_synthetic(name, cache_dir=None, **kw)
    got = tdata.make_synthetic(name, cache_dir=None, **kw)
    assert got["metric"] == want["metric"] and got["dim"] == want["dim"]
    for key in ("base", "queries", "groundtruth"):
        assert got[key].dtype == want[key].dtype, key
        assert got[key].tobytes() == want[key].tobytes(), key


def test_device_groundtruth_matches_host():
    data = tdata.make_synthetic("synthetic-3k-24d", n_queries=40, gt_k=10,
                                n_clusters=8, seed=5, cache_dir=None)
    # exact top-10 by chunked fp32 products (small chunks force the merge);
    # the same ids as the host computation (continuous data: no ties)
    gt = tdata.device_groundtruth(data["base"], data["queries"], 10,
                                  device="cpu", row_chunk=700, q_block=16)
    np.testing.assert_array_equal(gt, data["groundtruth"])


def test_fvecs_ivecs_round_trip(tmp_path):
    x = np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32)
    ids = np.arange(21, dtype=np.int32).reshape(7, 3)
    fv, iv = tmp_path / "x.fvecs", tmp_path / "x.ivecs"
    np.concatenate([np.full((7, 1), 5, np.int32).view(np.float32), x],
                   axis=1).tofile(fv)
    np.concatenate([np.full((7, 1), 3, np.int32), ids], axis=1).tofile(iv)
    np.testing.assert_array_equal(tdata.read_fvecs(fv), jdata.read_fvecs(fv))
    np.testing.assert_array_equal(tdata.read_fvecs(fv), x)
    np.testing.assert_array_equal(tdata.read_ivecs(iv), ids)
    with pytest.raises(ValueError):
        tdata.load_dataset("no-such-set", tmp_path)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_metrics_equal(metric):
    rng = np.random.default_rng(2)
    base = rng.standard_normal((200, 8)).astype(np.float32)
    queries = rng.standard_normal((20, 8)).astype(np.float32)
    truth = rng.permutation(200)[:100].reshape(20, 5)
    found = truth.copy()
    found[::3, 1] = rng.integers(0, 200, 7)
    found[::4, 4] = -1
    # the port's metrics are the same numpy code: equal results
    assert teval.recall_at_k(found, truth, 5) == jeval.recall_at_k(
        found, truth, 5)
    assert teval.average_distance_ratio(
        base, queries, found, truth, 5, metric) == \
        jeval.average_distance_ratio(base, queries, found, truth, 5, metric)
