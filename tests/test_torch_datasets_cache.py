"""``make_synthetic``'s on-disk cache in the port, against the JAX
package's: the same key and file for the host recipe, so each package
reads what the other wrote; a key of its own for the device recipe.
"""

import numpy as np
import pytest
import torch

from cphnsw_tpu.utils import datasets as jdata
from cphnsw_tpu_torch.utils import datasets as tdata

torch.set_num_threads(2)

NAME = "synthetic-2k-16d"
KW = dict(n_queries=20, gt_k=5, n_clusters=8, seed=3)
KEY = "synthetic-2k-16d-2000-16-20-5-8-3"
ARRAYS = ("base", "queries", "groundtruth")


def assert_same_set(got, want):
    for name in ARRAYS:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["dim"] == want["dim"] == 16
    assert got["metric"] == want["metric"] == "l2"


def forbid_drawing(monkeypatch):
    """Make any fresh draw or ground-truth computation fail."""
    def boom(*a, **kw):
        raise AssertionError("not served from the cache")
    monkeypatch.setattr(tdata, "_host_groundtruth", boom)
    monkeypatch.setattr(tdata, "device_groundtruth", boom)
    monkeypatch.setattr(tdata, "_device_synthetic", boom)


def test_default_directory_is_the_jax_packages():
    """The JAX package's directory name, under the temporary directory the
    process was given (the JAX package's own path where that is /tmp)."""
    import inspect
    import tempfile
    from pathlib import Path
    want = inspect.signature(jdata.make_synthetic).parameters["cache_dir"]
    got = inspect.signature(tdata.make_synthetic).parameters["cache_dir"]
    assert got.default == tdata.DEFAULT_CACHE_DIR
    assert Path(got.default).name == Path(want.default).name
    assert Path(got.default).parent == Path(tempfile.gettempdir())


def test_default_directory_follows_tmpdir(tmp_path):
    """A process started with its own TMPDIR keeps its sets under it."""
    import os
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "-c",
         "from cphnsw_tpu_torch.utils import datasets as d; "
         "print(d.DEFAULT_CACHE_DIR)"],
        env={**os.environ, "TMPDIR": str(tmp_path)}, check=True,
        capture_output=True, text=True).stdout.strip()
    assert out == str(tmp_path / "cphnsw_synth_cache")


def test_second_call_is_served_from_the_file(tmp_path, monkeypatch):
    first = tdata.make_synthetic(NAME, cache_dir=tmp_path, **KW)
    assert [f.name for f in tmp_path.iterdir()] == [f"{KEY}.npz"]
    forbid_drawing(monkeypatch)
    second = tdata.make_synthetic(NAME, cache_dir=str(tmp_path), **KW)
    assert_same_set(second, first)
    assert "base_dev_factory" not in second
    # another parameter is another key
    monkeypatch.undo()
    tdata.make_synthetic(NAME, cache_dir=tmp_path, **{**KW, "seed": 4})
    assert len(list(tmp_path.iterdir())) == 2


def test_cache_dir_none_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tdata, "DEFAULT_CACHE_DIR", str(tmp_path / "never"))
    got = tdata.make_synthetic(NAME, cache_dir=None, **KW)
    assert list(tmp_path.iterdir()) == []
    want = jdata.make_synthetic(NAME, cache_dir=None, **KW)
    assert_same_set(got, want)


def test_port_reads_the_jax_packages_file(tmp_path, monkeypatch):
    want = jdata.make_synthetic(NAME, cache_dir=str(tmp_path), **KW)
    assert (tmp_path / f"{KEY}.npz").exists()
    forbid_drawing(monkeypatch)
    got = tdata.make_synthetic(NAME, cache_dir=tmp_path, **KW)
    assert_same_set(got, want)


def test_jax_package_reads_the_ports_file(tmp_path, monkeypatch):
    want = tdata.make_synthetic(NAME, cache_dir=tmp_path, **KW)
    # a marked file: the JAX package must return it, not draw again
    path = tmp_path / f"{KEY}.npz"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    assert sorted(arrays) == ["base", "dim", "groundtruth", "queries"]
    arrays["queries"] = arrays["queries"] + 1.0
    np.savez(path, **arrays)
    got = jdata.make_synthetic(NAME, cache_dir=str(tmp_path), **KW)
    np.testing.assert_array_equal(got["queries"], want["queries"] + 1.0)
    np.testing.assert_array_equal(got["base"], want["base"])
    np.testing.assert_array_equal(got["groundtruth"], want["groundtruth"])
    assert got["dim"] == 16


def test_unreadable_file_is_drawn_again(tmp_path):
    """A file cut short (another process writing it in place) counts as no
    file: the set is drawn and the file replaced whole."""
    path = tmp_path / f"{KEY}.npz"
    path.write_bytes(b"PK\x03\x04 not a whole archive")
    got = tdata.make_synthetic(NAME, cache_dir=tmp_path, **KW)
    want = jdata.make_synthetic(NAME, cache_dir=None, **KW)
    assert_same_set(got, want)
    with np.load(path) as z:
        np.testing.assert_array_equal(z["base"], want["base"])
    # no temporary file is left behind
    assert [f.name for f in tmp_path.iterdir()] == [f"{KEY}.npz"]


def test_device_recipe_has_its_own_key(tmp_path, monkeypatch):
    """On a CUDA gt_device at n * dim >= the threshold the key names the
    port's generator: a ``-dev`` file of the JAX package is never read,
    and the port's own file also serves the store factory."""
    monkeypatch.setattr(tdata, "DEVICE_DATA_MIN_ELEMENTS", 1)
    host = tdata.make_synthetic(NAME, cache_dir=None, gt_device="cpu",
                                **KW)
    # what the JAX package would have cached from its accelerator
    np.savez(tmp_path / f"{KEY}-dev.npz", base=host["base"] + 7.0,
             queries=host["queries"], groundtruth=host["groundtruth"],
             dim=16)
    # ... and what an earlier version of the port's generator cached
    np.savez(tmp_path / f"{KEY}-dev-torch.npz", base=host["base"] + 7.0,
             queries=host["queries"], groundtruth=host["groundtruth"],
             dim=16)
    drawn = []
    cpu = torch.device("cpu")

    class FakeCuda:
        """A device that reports CUDA and computes on the CPU."""
        type = "cuda"

    def fake_device(spec):
        return FakeCuda() if spec == "cuda" else cpu

    def draw(n, dim, n_queries, n_clusters, seed, device):
        drawn.append(device)
        return _real_device_synthetic(n, dim, n_queries, n_clusters, seed,
                                      "cpu")

    monkeypatch.setattr(tdata, "_device_synthetic", draw)
    monkeypatch.setattr(tdata.torch, "device", fake_device)
    monkeypatch.setattr(
        tdata, "device_groundtruth",
        lambda base, q, k, metric, dev: _real_groundtruth(
            base, q, k, metric, "cpu"))
    first = tdata.make_synthetic(NAME, cache_dir=tmp_path, gt_device="cuda",
                                 **KW)
    assert len(drawn) == 1
    assert (tmp_path / f"{KEY}-dev-torch"
            f"{tdata.DEVICE_GENERATOR_VERSION}.npz").exists()
    assert not np.array_equal(first["base"], host["base"] + 7.0)
    second = tdata.make_synthetic(NAME, cache_dir=tmp_path, gt_device="cuda",
                                  **KW)
    assert len(drawn) == 1                      # served from the file
    assert_same_set(second, first)
    # the factory draws the store again on the device
    np.testing.assert_array_equal(second["base_dev_factory"]().numpy(),
                                  first["base"])
    assert len(drawn) == 2


_real_device_synthetic = tdata._device_synthetic
_real_groundtruth = tdata.device_groundtruth
