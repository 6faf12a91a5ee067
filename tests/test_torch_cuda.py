"""Tests of the PyTorch port that need an NVIDIA GPU.

They skip without one.  This file imports torch and the port only (no
JAX), so it also runs on a machine whose Python has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cphnsw_tpu_torch import Index, ScanIndex
from cphnsw_tpu_torch.kernels import scan_keys

torch.set_num_threads(2)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,p,q,bins", [
    (4096, 16, 100, 512), (8192, 40, 64, 1024), (100_352, 128, 2048, 1024)])
def test_kernel_equals_plain_version(cuda_device, rows, p, q, bins):
    g = torch.Generator(device=cuda_device).manual_seed(rows + p)
    kw = dict(device=cuda_device, generator=g)
    ops = [torch.randint(-127, 128, (rows, p), dtype=torch.int8, **kw),
           torch.randn((6, rows), **kw),
           torch.randint(-127, 128, (q, p), dtype=torch.int8, **kw),
           torch.randn(q, **kw), torch.randn((q, 5), **kw)]
    before = scan_keys.launches
    got = scan_keys.fused_scan_keys(*ops, bins)
    assert scan_keys.launches == before + 1
    want = scan_keys.scan_keys_reference(*ops, bins)
    # the same fused multiply-add order on both sides: bit-equal keys
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_index_matches_cpu_index(cuda_device):
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((16, 32)).astype(np.float32) * 3.0
    base = centers[rng.integers(0, 16, 3000)] + rng.standard_normal(
        (3000, 32)).astype(np.float32)
    queries = base[:64] + 0.05
    cpu = ScanIndex(32, bits=1, device="cpu").build(base).finalize()
    before = scan_keys.launches
    gpu = ScanIndex(32, bits=1, device=cuda_device).build(base).finalize()
    ids_g, d_g = gpu.search_batch(queries, k=10)
    assert scan_keys.launches > before
    ids_c, d_c = cpu.search_batch(queries, k=10)
    # selection is approximate: >= 0.99 of the returned ids agree
    assert (ids_g[:, :, None] == ids_c[:, None, :]).any(-1).mean() >= 0.99


@pytest.mark.cuda
def test_cuda_graph_index_matches_cpu_index(cuda_device, tmp_path):
    """A graph Index built on the card, and the same index (its saved
    state) searched on the CPU."""
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((32, 32)).astype(np.float32) * 3.0
    base = centers[rng.integers(0, 32, 20_000)] + rng.standard_normal(
        (20_000, 32)).astype(np.float32)
    queries = base[rng.choice(20_000, 128, replace=False)] + 0.05
    gpu = Index(32, bits=1, device=cuda_device).build(base).finalize()
    gpu.save(tmp_path / "g.npz")
    cpu = Index(32, bits=1, device="cpu").load(tmp_path / "g.npz")
    ids_g, d_g = gpu.search_batch(queries, k=10)
    ids_c, d_c = cpu.search_batch(queries, k=10)
    # tie order and hash-visited winners may differ: >= 0.99 of the ids
    assert (ids_g[:, :, None] == ids_c[:, None, :]).any(-1).mean() >= 0.99
    d = ((queries[:, None, :] - base[None]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]
    assert (ids_g[:, :, None] == gt[:, None, :]).any(-1).mean() >= 0.9


def _mesh(device, n_model=4):
    from cphnsw_tpu_torch.parallel.sharded import make_mesh

    return make_mesh(1, n_model, [device] * n_model)


@pytest.mark.cuda
def test_cuda_sharded_scan_matches_cpu(cuda_device, tmp_path):
    """Four scan shards on one card (the kernel in estimate mode on every
    shard) against the same sharded index searched on the CPU."""
    from cphnsw_tpu_torch import ShardedScanIndex

    rng = np.random.default_rng(2)
    centers = rng.standard_normal((16, 32)).astype(np.float32) * 3.0
    base = centers[rng.integers(0, 16, 6000)] + rng.standard_normal(
        (6000, 32)).astype(np.float32)
    queries = base[rng.choice(6000, 96, replace=False)] + 0.05
    gpu = ShardedScanIndex(32, bits=1).build(base, _mesh(cuda_device))
    before = scan_keys.launches
    ids_g, d_g = gpu.search_batch(queries, k=10)
    # one launch per shard per sub-batch at least
    assert scan_keys.launches - before >= 4
    gpu.save(tmp_path / "s.npz")
    cpu = ShardedScanIndex(32, bits=1).load(tmp_path / "s.npz",
                                            _mesh(torch.device("cpu")))
    ids_c, d_c = cpu.search_batch(queries, k=10)
    # the kernel and its plain version give bit-equal keys; the rerank
    # sums in another order: >= 0.99 of the ids agree
    assert (ids_g[:, :, None] == ids_c[:, None, :]).any(-1).mean() >= 0.99
    d = ((queries[:, None, :] - base[None]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]
    assert (ids_g[:, :, None] == gt[:, None, :]).any(-1).mean() >= 0.99


@pytest.mark.cuda
def test_cuda_sharded_graph_matches_cpu(cuda_device, tmp_path):
    """Four graph shards built on one card, then the same file searched on
    a CPU mesh."""
    from cphnsw_tpu_torch import ShardedIndex

    rng = np.random.default_rng(3)
    centers = rng.standard_normal((32, 32)).astype(np.float32) * 3.0
    base = centers[rng.integers(0, 32, 8000)] + rng.standard_normal(
        (8000, 32)).astype(np.float32)
    queries = base[rng.choice(8000, 64, replace=False)] + 0.05
    gpu = ShardedIndex(32, bits=1, r=16).build(base, _mesh(cuda_device))
    ids_g, _ = gpu.search_batch(queries, k=10)
    gpu.save(tmp_path / "g.npz")
    cpu = ShardedIndex(32, bits=1, r=16).load(tmp_path / "g.npz",
                                              _mesh(torch.device("cpu")))
    ids_c, _ = cpu.search_batch(queries, k=10)
    assert (ids_g[:, :, None] == ids_c[:, None, :]).any(-1).mean() >= 0.99
    d = ((queries[:, None, :] - base[None]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]
    assert (ids_g[:, :, None] == gt[:, None, :]).any(-1).mean() >= 0.9
