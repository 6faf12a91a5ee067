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


def _kernel_operands(device, rows, p, q, seed, extreme=False):
    """Random operands with scores of both signs and the last tenth of the
    rows at the pad sentinel; `extreme` sets every code and query byte to
    -128, the largest |fs| the int8 product can reach."""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, generator=g)
    ops = [torch.randint(-128, 128, (rows, p), dtype=torch.int8, **kw),
           torch.randn((6, rows), **kw),
           torch.randint(-128, 128, (q, p), dtype=torch.int8, **kw),
           torch.randn(q, **kw), torch.randn((q, 5), **kw)]
    if extreme:
        ops[0].fill_(-128)
        ops[2].fill_(-128)
    ops[1][0, rows - rows // 10:] = scan_keys.PAD_SCORE
    return ops


# (rows, p, q, bins): K widths 16 .. 2048 (zero K tails in the 128-byte
# TMA boxes, the resident and the streamed query tile), Q off the 128-query
# tile, groups 1 .. 1024, the main path's and one sharded-scan shard's
# shapes, small batches whose group axis is split over the card, and the
# launch of the 100k x 1536d inner-product workload (1537 columns padded
# to P 2048: the streamed query tile over 98 groups)
@pytest.mark.cuda
@pytest.mark.parametrize("rows,p,q,bins", [
    (4096, 16, 100, 512), (8192, 40, 64, 1024), (100_352, 128, 2048, 1024),
    (512, 16, 100, 512), (38 * 512, 128, 300, 512),
    (1_000_448, 128, 2048, 1024), (1_000_448, 128, 100, 1024),
    (1024 * 512, 16, 200, 512), (40 * 512, 1024, 200, 512),
    (20 * 512, 2048, 130, 512), (252_928, 128, 2048, 6656),
    (100_352, 2048, 1024, 1024)])
def test_kernel_equals_plain_version(cuda_device, rows, p, q, bins):
    ops = _kernel_operands(cuda_device, rows, p, q, rows + p)
    before = scan_keys.launches
    got = scan_keys.fused_scan_keys(*ops, bins)
    assert scan_keys.launches == before + 1
    want = scan_keys.scan_keys_reference(*ops, bins)
    # the same fused multiply-add order on both sides: bit-equal keys
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [256, 272])
def test_kernel_extreme_products(cuda_device, p):
    """|fs| = 128 * 128 * p: exactly 2^22 at p = 256, the last width whose
    int -> float conversion takes the magic-number path, and beyond it at
    p = 272."""
    ops = _kernel_operands(cuda_device, 4 * 512, p, 130, p, extreme=True)
    got = scan_keys.fused_scan_keys(*ops, 512)
    assert torch.equal(got, scan_keys.scan_keys_reference(*ops, 512))


@pytest.mark.cuda
def test_group_split_merges_exactly(cuda_device):
    """A small batch over many groups runs split over the card's SMs (one
    scan and one merge launch); the merged planes, and those of forced
    splits, equal the plain version's single pass."""
    rows, p, q, bins = 977 * 1024, 128, 64, 1024
    plan = scan_keys.launch_plan(q, p, bins, rows // bins, torch.cuda.
                                 get_device_properties(cuda_device).
                                 multi_processor_count)
    assert plan.splits > 1
    ops = _kernel_operands(cuda_device, rows, p, q, 7)
    want = scan_keys.scan_keys_reference(*ops, bins)
    before = scan_keys.launches, scan_keys.merge_launches
    assert torch.equal(scan_keys.fused_scan_keys(*ops, bins), want)
    assert (scan_keys.launches, scan_keys.merge_launches) == (
        before[0] + 1, before[1] + 1)
    for splits in (1, 3, 977):
        assert torch.equal(
            scan_keys.fused_scan_keys(*ops, bins, splits=splits), want)
    assert scan_keys.merge_launches == before[1] + 3


@pytest.mark.cuda
def test_kernel_on_every_device(cuda_device):
    """One process launches the same kernel instances on every card in
    turn, above 48 KB of shared memory (P 256, 1024): each card needs its
    own opt-in.  Skips on a one-card machine."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more GPUs")
    for p in (256, 1024):
        assert scan_keys.load_library().scan_keys_smem_bytes(p) > 48 << 10
        for i in range(count):
            dev = torch.device("cuda", i)
            ops = _kernel_operands(dev, 8 * 512, p, 130, i + p)
            got = scan_keys.fused_scan_keys(*ops, 512)
            assert got.device == dev
            assert torch.equal(got, scan_keys.scan_keys_reference(*ops, 512))


@pytest.mark.cuda
def test_scan_index_launches_once_per_sub_batch(cuda_device):
    from cphnsw_tpu_torch.api import scan_index
    from cphnsw_tpu_torch.search import scan

    rng = np.random.default_rng(4)
    base = rng.standard_normal((3000, 32)).astype(np.float32)
    idx = ScanIndex(32, bits=1, device=cuda_device).build(base).finalize()
    sub = scan_keys.derived_sub_batch(
        idx._arrays.raw.shape[0],
        scan._rerank_survivors(10, idx._budget.top_c(10, idx._n)),
        cap=scan_index.SEARCH_SUB_BATCH)
    queries = base[rng.integers(0, 3000, 2 * sub + 100)] + 0.05
    before = scan_keys.launches
    ids, dists = idx.search_batch(queries, k=10)
    assert scan_keys.launches - before == 3
    assert ids.shape == (len(queries), 10) and np.isfinite(dists).all()


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
@pytest.mark.parametrize("dim,metric", [(1536, "ip"), (960, "l2")])
def test_cuda_wide_index_matches_cpu_index(cuda_device, dim, metric):
    """The widths of the JAX package's 1536d inner-product and 960d
    workloads (P 2048 and 1024) at k = 100, card against CPU."""
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((16, dim)).astype(np.float32) * 3.0
    base = centers[rng.integers(0, 16, 3000)] + rng.standard_normal(
        (3000, dim)).astype(np.float32)
    queries = base[:64] + 0.05
    cpu = ScanIndex(dim, bits=1, metric=metric, device="cpu").build(
        base).finalize()
    before = scan_keys.launches
    gpu = ScanIndex(dim, bits=1, metric=metric, device=cuda_device).build(
        base).finalize()
    ids_g, d_g = gpu.search_batch(queries, k=100)
    assert scan_keys.launches > before
    ids_c, d_c = cpu.search_batch(queries, k=100)
    assert ids_g.shape == (64, 100) and np.isfinite(d_g).all()
    # selection is approximate: >= 0.99 of the returned ids agree
    assert (ids_g[:, :, None] == ids_c[:, None, :]).any(-1).mean() >= 0.99


@pytest.mark.cuda
def test_cuda_graph_index_matches_cpu_index(cuda_device, tmp_path):
    """A graph Index built on the card, and the same index (its saved
    state) searched on the CPU; NNDescent on its store on the card and on
    the CPU from the same Threefry keys (the whole build, one round from
    the same init, one reverse_lists call)."""
    from cphnsw_tpu_torch.graph import nndescent
    from cphnsw_tpu_torch.ops import threefry

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

    x = torch.from_numpy(base)
    ns = (x * x).sum(1)
    xg, nsg = x.to(cuda_device), ns.to(cuda_device)

    def differ(a, b) -> int:
        return int((a.cpu().sort(1).values != b.sort(1).values).any(1).sum())

    # the same draws on both devices; the card sums candidate distances in
    # another order, which can flip a near tie at rank R: one round from
    # the same init differs in <= 0.1% of rows, and the flips spread over
    # the build's rounds, so a build differs in <= 2% (about 0.8% measured
    # on an H100; a build from another seed differs in about half)
    wg_c = nndescent.run_adaptive(x, ns, 16, seed=3)
    wg_g = nndescent.run_adaptive(xg, nsg, 16, seed=3)
    assert differ(wg_g.ids, wg_c.ids) <= 0.02 * len(base)
    init = nndescent.init_random(x, ns, 16, seed=3)
    key = threefry.split(threefry.prng_key(3))[1]
    one_c, upd_c = nndescent.join_round(x, ns, init, 16, key)
    one_g, upd_g = nndescent.join_round(xg, nsg, nndescent.WorkingGraph(
        *(a.to(cuda_device) for a in init)), 16, key)
    assert differ(one_g.ids, one_c.ids) <= 0.001 * len(base)
    rev_c = nndescent.reverse_lists(wg_c.ids, key, 16)
    rev_g = nndescent.reverse_lists(wg_c.ids.to(cuda_device), key, 16)
    assert torch.equal(rev_g.cpu(), rev_c)


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
def test_cuda_sharded_chunked_scan_matches_kernel_path(cuda_device):
    """sharded_scan_search(fused=False), the per-shard chunked selection,
    on a (1, 2) mesh of the one card against the kernel path on the same
    store and budget; the chunked selection launches no kernel."""
    from cphnsw_tpu_torch import ShardedScanIndex
    from cphnsw_tpu_torch.parallel import sharded

    rng = np.random.default_rng(8)
    centers = rng.standard_normal((16, 32)).astype(np.float32) * 3.0
    base = centers[rng.integers(0, 16, 40_000)] + rng.standard_normal(
        (40_000, 32)).astype(np.float32)
    queries = (base[rng.choice(40_000, 96, replace=False)] + 0.05).astype(
        np.float16)
    mesh = _mesh(cuda_device, n_model=2)
    idx = ShardedScanIndex(32, bits=1).build(base, mesh)
    inner = idx._inner
    top_c = idx._top_c(10, len(queries))

    def search(**kw):
        before = scan_keys.launches
        ids, d = sharded.sharded_scan_search(
            idx._store, queries, inner._signs, inner._affine_a,
            inner._affine_b, inner._n, mesh, kappa=1.0, k=10, top_c=top_c,
            **kw)
        return ids.cpu().numpy(), d.cpu().numpy(), scan_keys.launches - before

    ids_k, _, launched_k = search(fused=True)
    assert launched_k >= 2                    # one per shard at least
    ids_c, d_c, launched_c = search(fused=False)
    assert launched_c == 0
    assert (ids_c[:, :, None] == ids_k[:, None, :]).any(-1).mean() >= 0.99
    # an explicit plan of several binned chunks per shard
    rows = idx._store.rows
    assert rows % 4 == 0
    ids_p, _, launched_p = search(fused=False, chunk=rows // 4, n_eq=4, rem=0)
    assert launched_p == 0
    assert (ids_p[:, :, None] == ids_k[:, None, :]).any(-1).mean() >= 0.99
    d = ((queries.astype(np.float32)[:, None, :] - base[None]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]
    assert (ids_c[:, :, None] == gt[:, None, :]).any(-1).mean() >= 0.99
    assert np.isfinite(d_c).all()


@pytest.mark.cuda
def test_fma_f32_cuda_matches_cpu(cuda_device):
    """The one-rounding multiply-add gives the same bits on the card as on
    the CPU, on triples next to f32 midpoints and with scalar operands."""
    from cphnsw_tpu_torch.ops.rounding import fma_f32

    rng = np.random.default_rng(9)
    n = 50_000
    c = np.ldexp(rng.integers(1 << 23, 1 << 24, n).astype(np.float64),
                 rng.integers(-20, 20, n)).astype(np.float32)
    u = rng.integers(-200, 201, n) * 2.0 ** -23
    a = (1.0 + u).astype(np.float32)
    b = (np.spacing(np.abs(c)).astype(np.float64) / 2 * (1.0 - u)).astype(
        np.float32)
    t = [torch.from_numpy(x) for x in (a, b, c)]
    want = fma_f32(*t)
    got = fma_f32(*(x.to(cuda_device) for x in t)).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    twice = (t[0].double() * t[1].double() + t[2].double()).float()
    assert (twice != want).sum() > 100      # the sweep reaches the fault
    assert want[0] == fma_f32(float(a[0]), t[1][:1].to(cuda_device),
                              float(c[0])).cpu()[0]


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


@pytest.mark.cuda
def test_threefry_recipe_cuda_matches_cpu(cuda_device, monkeypatch):
    """The Threefry recipe drawn on the card against the CPU: equal integer
    draws and data; make_synthetic on a CUDA device takes it (threshold
    lowered to this size) and hands out a device factory."""
    from cphnsw_tpu_torch.ops import threefry
    from cphnsw_tpu_torch.utils import datasets

    _, ka, kn, kq, _ = threefry.split(threefry.prng_key(5), 5)
    assert torch.equal(threefry.randint(ka, 4096, 0, 100, "cuda").cpu(),
                       threefry.randint(ka, 4096, 0, 100, "cpu"))
    assert torch.equal(threefry.permutation(kq, 4096, "cuda").cpu(),
                       threefry.permutation(kq, 4096, "cpu"))
    # the normals bit for bit: every operation of the stream is rounded
    # the same way on both devices
    got = threefry.normal(kn, (4096, 64), "cuda").cpu()
    want = threefry.normal(kn, (4096, 64), "cpu")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    monkeypatch.setattr(datasets, "DEVICE_DATA_MIN_ELEMENTS", 4096 * 64)
    ds = datasets.make_synthetic("synthetic-4096-64d", n=4096, n_queries=50,
                                 gt_k=10, n_clusters=32, seed=2,
                                 gt_device=cuda_device, cache_dir=None)
    base, queries = datasets._device_synthetic(4096, 64, 50, 32, 2, "cpu")
    # within 1e-5, a few ulps at the rows' magnitudes (|x| < 16)
    np.testing.assert_allclose(ds["base"], base.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ds["queries"], queries, rtol=0, atol=1e-5)
    assert torch.equal(ds["base_dev_factory"]().cpu(),
                       torch.from_numpy(ds["base"]))
    np.testing.assert_array_equal(
        ds["groundtruth"],
        datasets.device_groundtruth(ds["base"], ds["queries"], 10,
                                    device="cpu"))


@pytest.mark.cuda
def test_chunked_and_exact_selection_cuda_matches_cpu(cuda_device):
    """scan_search(fused=False) and exact_select on the card (torch._int_mm
    products) against the same index on the CPU; neither launches the
    kernel."""
    from cphnsw_tpu_torch.search import scan

    rng = np.random.default_rng(6)
    centers = rng.standard_normal((16, 32)).astype(np.float32) * 3.0
    base = centers[rng.integers(0, 16, 20_000)] + rng.standard_normal(
        (20_000, 32)).astype(np.float32)
    queries = torch.from_numpy(base[:100] + 0.05)
    cpu = ScanIndex(32, bits=1, device="cpu").build(base).finalize()
    gpu = ScanIndex(32, bits=1, device=cuda_device).load_state(
        cpu._header(), dict(cpu._node_host, raw=cpu._arrays.raw.numpy(),
                            centroid=cpu._centroid.numpy()))
    for kw in (dict(fused=False, top_c=300), dict(fused=False, top_c=1500),
               dict(exact_select=True, top_c=300),
               dict(fused=False, top_c=4096, sketch="bf16")):
        out = []
        for idx in (cpu, gpu):
            sketch = None
            if kw.get("sketch"):
                sketch = scan.make_rerank_sketch(idx._arrays.raw,
                                                 idx._arrays.norm_sq)
            before = scan_keys.launches
            ids, _ = scan.scan_search(
                idx._arrays, queries.to(idx._device), idx._signs,
                idx._affine_a, idx._affine_b, idx._n, kappa=1.0, k=10,
                **{**kw, "sketch": sketch})
            assert scan_keys.launches == before
            out.append(ids.cpu().numpy())
        assert (out[0][:, :, None] == out[1][:, None, :]).any(-1).mean() \
            >= 0.99, kw


@pytest.mark.cuda
def test_bruteforce_cuda_matches_cpu(cuda_device):
    from cphnsw_tpu_torch.search import bruteforce

    rng = np.random.default_rng(7)
    centers = rng.standard_normal((32, 48)).astype(np.float32) * 3.0
    base = centers[rng.integers(0, 32, 4000)] + rng.standard_normal(
        (4000, 48)).astype(np.float32)
    queries = base[rng.choice(4000, 50, replace=False)] + 0.1
    ids = [bruteforce.BruteForceIndex(48, bits=1, device=dev).build(
        base).search_batch(queries, k=10)[0] for dev in ("cpu", cuda_device)]
    assert (ids[0][:, :, None] == ids[1][:, None, :]).any(-1).mean() >= 0.99


def _both_routes(monkeypatch, run):
    """(run() through the beam's captured graphs, run() with every chunk
    launched eagerly op by op, the streams the first captured on); no
    kept graph before, between or after."""
    from cphnsw_tpu_torch.search import beam

    real = beam._graphed
    captured = []

    def counting(fn, stream):
        captured.append(stream)
        return real(fn, stream)

    beam.drop_replays()
    monkeypatch.setattr(beam, "_graphed", counting)
    graphed = run()
    beam.drop_replays()
    monkeypatch.setattr(beam, "_graphed", lambda fn, stream: fn)
    eager = run()
    beam.drop_replays()
    monkeypatch.setattr(beam, "_graphed", real)
    return graphed, eager, captured


def _assert_same_search(a, b):
    """Two beam results (ids, dists[, BeamState]) equal bit for bit."""
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    if len(a) > 2:
        assert a[2].steps == b[2].steps
        for name in ("res_step", "last_improve", "visited", "beam_est"):
            assert torch.equal(getattr(a[2], name), getattr(b[2], name)), name


@pytest.mark.cuda
def test_graphed_beam_equals_eager(cuda_device, monkeypatch):
    """The beam replayed from its captured graph against the same step
    function launched op by op, on the card: Index.search_batch, the step
    budget's k = 100 run (debug_state), the hash-visited table with
    expand_width 4 and rerank_width 8."""
    from cphnsw_tpu_torch.search import beam

    rng = np.random.default_rng(11)
    centers = rng.standard_normal((32, 32)).astype(np.float32) * 3.0
    base = centers[rng.integers(0, 32, 20_000)] + rng.standard_normal(
        (20_000, 32)).astype(np.float32)
    queries = base[rng.choice(20_000, 200, replace=False)] + 0.05
    idx = Index(32, bits=1, device=cuda_device).build(base).finalize()
    g, e, captured = _both_routes(
        monkeypatch, lambda: idx.search_batch(queries, k=10))
    assert {s.device for s in captured} == {idx._raw.device}
    np.testing.assert_array_equal(g[0], e[0])
    np.testing.assert_array_equal(g[1], e[1])

    q_dev = torch.from_numpy(queries).to(cuda_device)

    def budget_run():
        idx._derive_step_budget()
        return idx._step_budget, idx._beam(q_dev, idx._entry_candidates,
                                           100, 512, debug_state=True)

    (bg, g), (be, e), captured = _both_routes(monkeypatch, budget_run)
    assert captured and bg == be
    _assert_same_search(g, e)
    assert g[2].steps > 2 * beam.DONE_CHECK_EVERY

    def hashed():
        return beam.search_batch(
            idx._raw, idx._norm_sq, idx._neighbors, idx._entry_candidates,
            idx._signs, q_dev, idx._params, bits=1, k=10, beam_cap=64,
            max_steps=61, expand_width=4, rerank_width=8,
            visited_hash_bits=13, debug_state=True)

    g, e, captured = _both_routes(monkeypatch, hashed)
    assert captured
    _assert_same_search(g, e)


@pytest.mark.cuda
def test_graphed_sharded_beam_equals_eager(cuda_device, monkeypatch):
    """Four graph shards on cuda:i % device_count: the sharded search and
    the step-budget runs of every shard through the captured graphs and
    again eagerly, equal bit for bit, each shard's graphs captured on its
    own card.  Run it with four cards too: one card cannot show a
    per-device fault."""
    from cphnsw_tpu_torch import ShardedIndex
    from cphnsw_tpu_torch.parallel import sharded

    count = torch.cuda.device_count()
    devices = [torch.device("cuda", i % count) for i in range(4)]
    rng = np.random.default_rng(12)
    centers = rng.standard_normal((32, 32)).astype(np.float32) * 3.0
    base = centers[rng.integers(0, 32, 8000)] + rng.standard_normal(
        (8000, 32)).astype(np.float32)
    queries = base[rng.choice(8000, 64, replace=False)] + 0.05
    idx = ShardedIndex(32, bits=1, r=16).build(
        base, sharded.make_mesh(1, 4, devices))
    g, e, captured = _both_routes(
        monkeypatch, lambda: idx.search_batch(queries, k=10))
    np.testing.assert_array_equal(g[0], e[0])
    np.testing.assert_array_equal(g[1], e[1])
    assert {s.device for s in captured} == set(devices)

    shards = list(idx._store.shards[0])
    g, e, captured = _both_routes(
        monkeypatch, lambda: sharded._derive_shard_step_budget(
            shards, idx._params, idx._signs_h, 1, 16, idx.seed,
            max_shards=4))
    assert g == e
    assert {s.device for s in captured} == set(devices)


@pytest.mark.cuda
def test_kept_graph_replays_across_calls(cuda_device, monkeypatch):
    """A second search of the same shapes replays the graph the first
    captured, on other queries, with the results of a fresh capture; the
    results are copies that a later call leaves alone; a debug_state
    search keeps no graph it captures; after drop_replays() a search
    captures anew and runs a function patched since."""
    from cphnsw_tpu_torch.ops import estimate
    from cphnsw_tpu_torch.search import beam

    rng = np.random.default_rng(14)
    base = rng.standard_normal((6000, 32)).astype(np.float32)
    idx = Index(32, bits=1, device=cuda_device).build(base).finalize()
    real = beam._graphed
    captured = []

    def counting(fn, stream):
        captured.append(stream)
        return real(fn, stream)

    def search(q, debug_state=False):
        return beam.search_batch(
            idx._raw, idx._norm_sq, idx._neighbors, idx._entry_candidates,
            idx._signs, torch.from_numpy(q).to(cuda_device), idx._params,
            bits=1, k=10, beam_cap=32, max_steps=100,
            debug_state=debug_state)

    q1, q2 = base[:96] + 0.4, base[96:192] - 0.4
    beam.drop_replays()
    monkeypatch.setattr(beam, "_graphed", counting)
    assert search(q1, True)[2].steps > beam.DONE_CHECK_EVERY
    assert len(captured) == 1 and beam.kept_bytes() == 0
    first = search(q1)
    assert len(captured) == 2 and beam.kept_bytes(cuda_device) > 0
    again = search(q2, True)
    assert len(captured) == 2
    assert torch.equal(search(q1)[0], first[0]) and len(captured) == 2
    beam.drop_replays()
    fresh = search(q2, True)
    assert len(captured) == 3
    _assert_same_search(again, fresh)
    held = first[1].clone()
    search(q2)
    assert torch.equal(first[1], held)
    exact = estimate.exact_l2_sq
    monkeypatch.setattr(estimate, "exact_l2_sq",
                        lambda *a: exact(*a) * 2.0)
    beam.drop_replays()
    doubled = search(q1)
    assert len(captured) == 5
    assert not torch.equal(doubled[1], first[1])
    beam.drop_replays()


@pytest.mark.cuda
def test_kept_graphs_free_their_memory(cuda_device, monkeypatch):
    """Searches of two shapes under a byte budget that holds one kept
    graph: the second drops the first and the memory held stays within
    the budget; under a budget of 0 a search keeps nothing, and the
    allocated and (after empty_cache) reserved memory go back to what
    they were before any graph was kept (reserved at most)."""
    import gc

    from cphnsw_tpu_torch.search import beam

    rng = np.random.default_rng(15)
    base = rng.standard_normal((20_000, 32)).astype(np.float32)
    idx = Index(32, bits=1, device=cuda_device).build(base).finalize()
    qa, qb = base[:256] + 0.3, base[256:384] - 0.3

    def resident():
        gc.collect()
        torch.cuda.synchronize(cuda_device)
        torch.cuda.empty_cache()
        return (torch.cuda.memory_allocated(cuda_device),
                torch.cuda.memory_reserved(cuda_device))

    beam.drop_replays()
    monkeypatch.setattr(beam, "KEPT_BYTES_PER_DEVICE", 0)
    ids = idx.search_batch(qa, k=10)[0]      # warm, nothing kept
    assert beam.kept_bytes() == 0
    allocated, reserved = resident()
    monkeypatch.setattr(beam, "KEPT_BYTES_PER_DEVICE", 2 << 30)
    assert np.array_equal(idx.search_batch(qa, k=10)[0], ids)
    a_bytes = beam.kept_bytes(cuda_device)
    # the visited table alone: (256, 2^b + 1) int32 or (256, N + 1) bool
    assert a_bytes > 256 * 20_000
    assert resident()[0] > allocated
    idx.search_batch(qb, k=10)
    assert beam.kept_bytes(cuda_device) > a_bytes      # both kept
    monkeypatch.setattr(beam, "KEPT_BYTES_PER_DEVICE", a_bytes)
    assert np.array_equal(idx.search_batch(qa, k=10)[0], ids)
    assert beam.kept_bytes(cuda_device) == a_bytes     # b dropped
    idx.search_batch(qb, k=10)
    assert 0 < beam.kept_bytes(cuda_device) < a_bytes  # a dropped
    monkeypatch.setattr(beam, "KEPT_BYTES_PER_DEVICE", 0)
    assert np.array_equal(idx.search_batch(qa, k=10)[0], ids)
    assert beam.kept_bytes() == 0
    beam.drop_replays()
    now = resident()
    assert now[0] == allocated and now[1] <= reserved


@pytest.mark.cuda
def test_graph_capture_failure_raises(cuda_device, monkeypatch):
    """A step that reads a value on the host cannot be captured: the
    search raises and does not fall back to the eager loop."""
    from cphnsw_tpu_torch.search import beam

    rng = np.random.default_rng(13)
    base = rng.standard_normal((3000, 32)).astype(np.float32)
    idx = Index(32, bits=1, device=cuda_device).build(base).finalize()
    real = beam._step

    def syncing(s, c):
        bool(s.done.any())          # a device -> host read
        return real(s, c)

    q_dev = torch.from_numpy(base[:64] + 0.5).to(cuda_device)

    def search():
        return beam.search_batch(
            idx._raw, idx._norm_sq, idx._neighbors, idx._entry_candidates,
            idx._signs, q_dev, idx._params, bits=1, k=10, beam_cap=32,
            max_steps=512, debug_state=True)

    # the search runs past its first chunk, so it captures one
    assert search()[2].steps > beam.DONE_CHECK_EVERY
    beam.drop_replays()
    monkeypatch.setattr(beam, "_step", syncing)
    with pytest.raises(RuntimeError):
        search()


# The beam step's kernels (kernels/beam_step.py) against the plain torch
# step (search/beam.py's plain segments) on the card: (bits, R, expand_width, visited_hash_bits,
# rerank_width, k), beam_cap = max(2R, 4k) as Index sets it
BEAM_CASES = {
    "1bit-r16-e1-dense-rw0-k10": (1, 16, 1, 0, 0, 10),
    "1bit-r32-e4-hash-rw0-k10": (1, 32, 4, 13, 0, 10),
    "1bit-r32-e4-hash-rw8-k100": (1, 32, 4, 13, 8, 100),
    "2bit-r16-e4-dense-rw8-k10": (2, 16, 4, 0, 8, 10),
    "2bit-r32-e1-hash-rw0-k100": (2, 32, 1, 13, 0, 100),
    "4bit-r16-e4-hash-rw8-k100": (4, 16, 4, 13, 8, 100),
    "4bit-r32-e1-dense-rw0-k10": (4, 32, 1, 0, 0, 10),
    "4bit-r32-e4-dense-rw0-k100": (4, 32, 4, 0, 0, 100),
}
_BEAM_INDEXES: dict = {}


def _beam_index(device, bits, r):
    """A 6000 x 32d graph Index built on the card, one per (bits, R)."""
    if (bits, r) not in _BEAM_INDEXES:
        rng = np.random.default_rng(20 + bits + r)
        centers = rng.standard_normal((24, 32)).astype(np.float32) * 3.0
        base = centers[rng.integers(0, 24, 6000)] + rng.standard_normal(
            (6000, 32)).astype(np.float32)
        queries = base[rng.choice(6000, 96, replace=False)] + 0.05
        _BEAM_INDEXES[bits, r] = (Index(32, bits=bits, r=r, device=device)
                                  .build(base).finalize(), queries)
    return _BEAM_INDEXES[bits, r]


def _beam_start(idx, queries, bits, r, ew, hash_bits, rw, k):
    from cphnsw_tpu_torch.search import beam

    return beam._start(
        idx._raw, idx._norm_sq, idx._neighbors, idx._entry_candidates,
        idx._signs, torch.from_numpy(queries).to(idx._raw.device),
        idx._params, bits, k, max(2 * r, 4 * k), 4, ew, rw, hash_bits)


def _same_bits(a, b) -> bool:
    """Equal bit for bit (floats by their bits: -0 and NaN count)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _assert_same_state(a, b, where=""):
    from cphnsw_tpu_torch.search import beam

    for name in beam.BeamState._fields:
        x, y = getattr(a, name), getattr(b, name)
        if torch.is_tensor(x):
            assert _same_bits(x, y), f"{name} differs {where}"
        else:
            assert x == y, f"{name} differs {where}"


def _after_step(s, pop, merged, gamma, steps):
    """The state a step leaves from its segments' outputs."""
    from cphnsw_tpu_torch.search import beam

    return beam.BeamState(
        beam_ids=merged.beam_ids, beam_est=merged.beam_est,
        beam_lower=merged.beam_lower, res_ids=merged.res_ids,
        res_d=merged.res_d, visited=s.visited, gamma_q=gamma[0],
        ratio_sum=gamma[1], ratio_sq=gamma[2], ratio_cnt=gamma[3],
        slack_cnt=pop.slack_cnt, done=pop.done, steps=steps,
        last_improve=merged.last_improve, res_step=merged.res_step)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_segments_equal_plain_segments(cuda_device, case):
    """Each kernel against its plain version, step by step for 24 steps
    from the same seeded state: every output of a query that is active
    bit for bit, the outputs the next segments read for every query (the
    step counter among them), the exact distances between them, the gamma
    update with its row sums, and the whole state after each step."""
    from cphnsw_tpu_torch.ops import estimate
    from cphnsw_tpu_torch.search import beam

    bits, r, ew, hash_bits, rw, k = BEAM_CASES[case]
    idx, queries = _beam_index(cuda_device, bits, r)
    s, c = _beam_start(idx, queries, bits, r, ew, hash_bits, rw, k)
    t = beam.BeamState(*(x.clone() for x in s))
    # read on every query; the rest only where the query is active
    every_row = ("active", "expand", "expand_e", "cur_safe", "done",
                 "slack_cnt", "beam_est", "cand_ok", "rerank", "rr_node",
                 "rr_ok")

    def compare(got, want, act, what):
        for name in want._fields:
            x, y = getattr(got, name), getattr(want, name)
            if x is None or y is None:
                assert x is None and y is None, f"{what} {name}"
                continue
            rows = slice(None) if name in every_row else act
            if x.dim() == 0:                    # the step counter
                rows = ()
            assert _same_bits(x[rows], y[rows]), f"{what} {name}"

    def exact(rows_of):
        v = c.raw[rows_of]
        return estimate.exact_l2_sq(c.qpad, c.qnorm, v, (v * v).sum(dim=-1))

    for step in range(24):
        _assert_same_state(s, t, f"before step {step}")
        pw, pk = beam._pop_plain(t, c), beam._pop(s, c)
        act = pw.active
        compare(pk, pw, act, f"pop, step {step}")
        dw, dk = (estimate.exact_l2_sq(c.qpad, c.qnorm, c.raw[p.cur_safe],
                                       c.norm_sq[p.cur_safe])
                  for p in (pw, pk))
        assert _same_bits(dk, dw)
        xw = beam._expand_plain(t, c, pw, dw)
        xk = beam._expand(s, c, pk, dk)
        assert _same_bits(s.visited, t.visited), f"visited, step {step}"
        compare(xk, xw, act, f"expand, step {step}")
        ew_, ek = exact(xw.rr_node), exact(xk.rr_node)
        assert _same_bits(ek, ew_)
        mw = beam._merge_plain(t, c, pw, dw, xw, ew_, pw.next_step)
        mk = beam._merge(s, c, pk, dk, xk, ek, pk.next_step)
        compare(mk, mw, slice(None), f"merge, step {step}")
        gw = beam._gamma_plain(t, c, pw.expand, mw.ratio, mw.contrib)
        gk = beam._gamma(s, c, pk.expand, mk.ratio, mk.contrib)
        for name, x, y in zip(("gamma_q", "ratio_sum", "ratio_sq",
                               "ratio_cnt"), gk, gw):
            assert _same_bits(x, y), f"gamma {name}, step {step}"
        t = _after_step(t, pw, mw, gw, pw.next_step)
        s = _after_step(s, pk, mk, gk, pk.next_step)
    _assert_same_state(s, t, "after 24 steps")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_kernels_equal_plain_step(cuda_device, case, monkeypatch):
    """The search through the kernels against the same search through the
    plain torch step on the card, with the done flags read every 1 and 8
    steps: ids, distances, steps and every field of the final state bit
    for bit; the kernels launched, the plain step launched none."""
    from cphnsw_tpu_torch.kernels import beam_step
    from cphnsw_tpu_torch.search import beam

    bits, r, ew, hash_bits, rw, k = BEAM_CASES[case]
    idx, queries = _beam_index(cuda_device, bits, r)
    q_dev = torch.from_numpy(queries).to(cuda_device)

    def search():
        return beam.search_batch(
            idx._raw, idx._norm_sq, idx._neighbors, idx._entry_candidates,
            idx._signs, q_dev, idx._params, bits=bits, k=k,
            beam_cap=max(2 * r, 4 * k), max_steps=300, expand_width=ew,
            visited_hash_bits=hash_bits, rerank_width=rw, debug_state=True)

    real = beam._step
    for check in (1, 8):
        monkeypatch.setattr(beam, "DONE_CHECK_EVERY", check)
        beam.drop_replays()
        before = beam_step.merge_launches
        kernels = search()
        assert beam_step.merge_launches > before
        monkeypatch.setattr(beam, "_step", beam._plain_step)
        beam.drop_replays()
        before = (beam_step.pop_launches, beam_step.expand_launches,
                  beam_step.merge_launches, beam_step.gamma_launches)
        plain = search()
        assert (beam_step.pop_launches, beam_step.expand_launches,
                beam_step.merge_launches, beam_step.gamma_launches) == before
        monkeypatch.setattr(beam, "_step", real)
        beam.drop_replays()
        assert _same_bits(kernels[0], plain[0])
        assert _same_bits(kernels[1], plain[1])
        _assert_same_state(kernels[2], plain[2], f"(every {check})")
        assert bool(kernels[2].done.all()) and kernels[2].steps < 300


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_generic_beam_segments_equal_plain_segments(cuda_device, case,
                                                    monkeypatch):
    """test_beam_segments_equal_plain_segments with every kernel generic
    (beam_step.GENERIC_ONLY): the kernels that take every shape, at the
    shapes where the plan now names the Hopper variants."""
    from cphnsw_tpu_torch.kernels import beam_step

    monkeypatch.setattr(beam_step, "GENERIC_ONLY", True)
    before = dict(beam_step.expand_variant_launches)
    test_beam_segments_equal_plain_segments(cuda_device, case)
    assert beam_step.expand_variant_launches["generic"] > before["generic"]
    assert beam_step.expand_variant_launches["bulk"] == before["bulk"]


def _pop_gamma_state(device, q, beam_cap, k, rw, seed):
    """A seeded batch for the pop and the gamma update alone: beam values
    from a pool of four (ties) with a third of the slots FLOAT_MAX holes
    (one row all holes), the results full in half the rows, a quarter of
    the queries done, the step counter at 41; and the gamma update's
    inputs: ratios of both signs over six decades with +0.0 and -0.0
    entries (one row all -0.0), a NaN in one row, contributing flags, an
    expanding flag per query.  Returns (state, constants, ratio, contrib,
    expand)."""
    from cphnsw_tpu_torch.search import beam

    rng = np.random.default_rng(seed)
    pool = np.array([0.25, 1.0, 1.5, 4.0], np.float32)
    est = rng.choice(pool, (q, beam_cap)).astype(np.float32)
    est[rng.random((q, beam_cap)) < 1 / 3] = beam.FLOAT_MAX
    est[5] = beam.FLOAT_MAX
    res_d = np.full((q, k), beam.FLOAT_MAX, np.float32)
    res_d[::2] = rng.choice(pool, (q // 2, k))
    ratio = (rng.standard_normal((q, rw)) * 10.0 ** rng.integers(
        -3, 3, (q, rw))).astype(np.float32)
    ratio[0] = -0.0
    ratio[1, ::3] = 0.0
    ratio[2, ::2] = -0.0
    ratio[3, rw // 2] = np.nan

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    s = beam.BeamState(
        beam_ids=t(rng.integers(0, 10_000, (q, beam_cap)).astype(np.int32)),
        beam_est=t(est), beam_lower=t(rng.choice(pool, (q, beam_cap))),
        res_ids=None, res_d=t(res_d), visited=None,
        gamma_q=t(rng.choice(np.float32([1.0, 1.2, 2.0]), q)),
        ratio_sum=t(rng.random(q).astype(np.float32) * 50),
        ratio_sq=t(rng.random(q).astype(np.float32) * 80),
        ratio_cnt=t(rng.integers(0, 60, q).astype(np.int32)),
        slack_cnt=t(rng.integers(0, 6, q).astype(np.int32)),
        done=t(rng.random(q) < 0.25),
        steps=torch.tensor(41, dtype=torch.int32, device=device),
        last_improve=None, res_step=None)
    params = beam.SearchParams(
        affine_a=1.0, affine_b=0.0, ip_qo_floor=0.0,
        slack_levels=t(np.float32([0.0, 0.5, 1.0, 2.0])), gamma=1.0,
        gamma_max=1.5, gamma_beta=0.3, gamma_warmup=40)
    return (s, params, t(ratio), t(rng.random((q, rw)) < 0.6),
            t(rng.random(q) < 0.8))


# (beam_cap, E) of the pop: the graph cell's 64 at E 4, a shard's 128 at
# E 1, beam_cap 100 (not a multiple of 32) at E 1, 33 and 100, the
# k = 100 beam's 400 at E 4 (past the slots a lane keeps in registers),
# k = 250's 1,000 and k = 600's 2,400 at E 4 and 64
POP_SHAPES = [(64, 4), (128, 1), (100, 1), (100, 33), (100, 100), (400, 4),
              (1000, 4), (2400, 4), (2400, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("beam_cap, ew", POP_SHAPES,
                         ids=[f"b{b}-e{e}" for b, e in POP_SHAPES])
def test_pop_kernel_equals_plain_pop(cuda_device, beam_cap, ew):
    """The warp pop against _pop_plain on one seeded state with holes,
    ties, done queries and results full or not: beam_est, done, slack_cnt,
    active, expand, expand_e, cur_safe and the step counter bit for bit
    for every query, pop_ids and dot_slack where the query is active."""
    from cphnsw_tpu_torch.kernels import beam_step
    from cphnsw_tpu_torch.search import beam

    s, params, *_ = _pop_gamma_state(cuda_device, 40, beam_cap, 10, 8,
                                     beam_cap + ew)
    c = beam._Consts(*[None] * 8, params=params, bits=1, k=10, r=1,
                     words=1, expand_width=ew, rw=1, h_size=0)
    t = s._replace(beam_est=s.beam_est.clone(), done=s.done.clone(),
                   slack_cnt=s.slack_cnt.clone())
    want = beam._pop_plain(t, c)
    before = beam_step.pop_launches
    got = beam._pop(s, c)
    assert beam_step.pop_launches == before + 1
    act = want.active
    assert bool(act.any()) and bool((~act).any())
    for name in beam.Popped._fields:
        x, y = getattr(got, name), getattr(want, name)
        rows = act if name in ("pop_ids", "dot_slack") else slice(None)
        if x.dim() == 0:
            rows = ()
        assert _same_bits(x[rows], y[rows]), name
    assert int(got.next_step) == 42 and int(s.steps) == 41


@pytest.mark.cuda
@pytest.mark.parametrize("rw", [8, 32, 100, 128, 512])
def test_gamma_kernel_equals_plain_gamma(cuda_device, rw):
    """The gamma update, which sums its ratios itself, against
    _gamma_plain's lane-order sums in torch ops on the card: gamma_q and
    the three running terms bit for bit (rw 8 at rerank_width 8, 128 at
    the graph cell, 100 off the warp, 512 at R = 128), with +0.0, -0.0 and
    NaN ratios and queries that do not expand."""
    from cphnsw_tpu_torch.kernels import beam_step
    from cphnsw_tpu_torch.search import beam

    s, params, ratio, contrib, expand = _pop_gamma_state(
        cuda_device, 40, 64, 10, rw, rw)
    c = beam._Consts(*[None] * 8, params=params, bits=1, k=10, r=1,
                     words=1, expand_width=1, rw=rw, h_size=0)
    t = s._replace(**{f: getattr(s, f).clone() for f in (
        "gamma_q", "ratio_sum", "ratio_sq", "ratio_cnt")})
    want = beam._gamma_plain(t, c, expand, ratio, contrib)
    before = beam_step.gamma_launches
    got = beam._gamma(s, c, expand, ratio, contrib)
    assert beam_step.gamma_launches == before + 1
    for name, x, y in zip(("gamma_q", "ratio_sum", "ratio_sq", "ratio_cnt"),
                          got, want):
        assert _same_bits(x, y), name
    moved = want[0] != t.gamma_q
    assert bool(moved.any())                # the update took effect


# Step-by-step cases for both variants: (bits, R, expand_width,
# visited_hash_bits, rerank_width, k, beam_cap or 0 for max(2R, 4k),
# scrambled): E*R not a multiple of 32 (R = 24, E = 3), a graph shard's
# E = 1 with dense visited and beam_cap 128, rw < E*R, 1, 2 and 4 bits,
# and seeded states whose beam and results are shuffled per query with a
# quarter of the beam set to FLOAT_MAX holes (no order of the state is
# taken on trust)
EACH_STEP_CASES = {
    "2bit-r24-e3-hash-rw0-k10": (2, 24, 3, 13, 0, 10, 0, False),
    "4bit-r24-e3-dense-rw8-k10": (4, 24, 3, 0, 8, 10, 0, False),
    "1bit-r32-e1-dense-rw0-k10-shard": (1, 32, 1, 0, 0, 10, 128, False),
    "1bit-r32-e4-hash-rw8-k10-holes": (1, 32, 4, 13, 8, 10, 0, True),
    "2bit-r16-e4-dense-rw0-k100-holes": (2, 16, 4, 0, 0, 100, 0, True),
    "4bit-r16-e1-hash-rw8-k10-holes": (4, 16, 1, 13, 8, 10, 0, True),
}


def _scrambled(s, seed):
    """s with each query's beam and results in a random order and a
    quarter of its beam entries emptied (FLOAT_MAX)."""
    from cphnsw_tpu_torch.search import beam

    g = torch.Generator().manual_seed(seed)
    q, b = s.beam_est.shape
    k = s.res_d.shape[1]
    dev = s.beam_est.device
    pb = torch.stack([torch.randperm(b, generator=g) for _ in range(q)])
    pk = torch.stack([torch.randperm(k, generator=g) for _ in range(q)])
    holes = (torch.rand((q, b), generator=g) < 0.25).to(dev)
    pb, pk = pb.to(dev), pk.to(dev)
    return s._replace(
        beam_est=torch.where(holes, beam.FLOAT_MAX, s.beam_est.gather(1, pb)),
        beam_ids=s.beam_ids.gather(1, pb),
        beam_lower=s.beam_lower.gather(1, pb),
        res_ids=s.res_ids.gather(1, pk), res_d=s.res_d.gather(1, pk),
        res_step=s.res_step.gather(1, pk))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["hopper", "generic"])
@pytest.mark.parametrize("case", list(EACH_STEP_CASES))
def test_beam_variants_equal_plain_step_each_step(cuda_device, case,
                                                  variant, monkeypatch):
    """beam._step through each variant of the expansion and the merge
    against beam._plain_step from the same state: every field bit-equal
    after every step until every query is done; the variant the plan
    names is the one that launched."""
    from cphnsw_tpu_torch.kernels import beam_step
    from cphnsw_tpu_torch.search import beam

    bits, r, ew, hash_bits, rw, k, cap, scramble = EACH_STEP_CASES[case]
    monkeypatch.setattr(beam_step, "GENERIC_ONLY", variant == "generic")
    idx, queries = _beam_index(cuda_device, bits, r)
    s, c = beam._start(
        idx._raw, idx._norm_sq, idx._neighbors, idx._entry_candidates,
        idx._signs, torch.from_numpy(queries).to(cuda_device), idx._params,
        bits, k, cap or max(2 * r, 4 * k), 4, ew, rw, hash_bits)
    if scramble:
        s = _scrambled(s, 7 + bits + r)
    plan = beam_step.launch_plan(len(queries), s.beam_est.shape[1], k, ew, r,
                                 c.rw, idx._padded, bits, c.words)
    want = (("bulk", "rank") if variant == "hopper"
            else ("generic", "generic"))
    assert (plan.expand.variant, plan.merge.variant) == want
    before = (dict(beam_step.expand_variant_launches),
              dict(beam_step.merge_variant_launches))
    t = beam.BeamState(*(x.clone() for x in s))
    for step in range(300):
        s, t = beam._step(s, c), beam._plain_step(t, c)
        _assert_same_state(s, t, f"after step {step + 1}")
        if bool(t.done.all()):
            break
    assert bool(s.done.all())
    assert beam_step.expand_variant_launches[want[0]] == \
        before[0][want[0]] + step + 1
    assert beam_step.merge_variant_launches[want[1]] == \
        before[1][want[1]] + step + 1


def _index_searches(idx, queries, k, monkeypatch):
    """Index.search_batch(queries, k) through the kernels and through the
    plain torch step, and the merge kernel's launches in the first."""
    from cphnsw_tpu_torch.kernels import beam_step
    from cphnsw_tpu_torch.search import beam

    real = beam._step
    beam.drop_replays()
    before = beam_step.merge_launches
    kernels = idx.search_batch(queries, k=k)
    launched = beam_step.merge_launches - before
    monkeypatch.setattr(beam, "_step", beam._plain_step)
    beam.drop_replays()
    plain = idx.search_batch(queries, k=k)
    monkeypatch.setattr(beam, "_step", real)
    beam.drop_replays()
    return kernels, plain, launched


@pytest.mark.cuda
@pytest.mark.parametrize("k", [250, 600])
def test_index_search_at_large_k_equals_plain_step(cuda_device, k,
                                                   monkeypatch):
    """Index.search_batch at k = 250 and 600 (beam_cap 1,000 and 2,400:
    sorts of 1,128 and 2,528 entries a step) through the kernels equals
    the plain torch step bit for bit, ids and distances."""
    idx, queries = _beam_index(cuda_device, 1, 32)
    kernels, plain, launched = _index_searches(idx, queries[:32], k,
                                               monkeypatch)
    assert launched > 0
    assert kernels[0].shape == (32, k)
    np.testing.assert_array_equal(kernels[0], plain[0])
    np.testing.assert_array_equal(kernels[1].view(np.int32),
                                  plain[1].view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dim, r", [(32, 128), (5000, 16)],
                         ids=["r128", "p8192"])
def test_index_search_at_wide_shapes_equals_plain_step(cuda_device, dim, r,
                                                       monkeypatch):
    """Index.search_batch with R = 128 (E*R = 512 candidates a step) and
    at 5,000 dimensions (P = 8,192: the query's levels take 32 KB)
    through the kernels equals the plain torch step bit for bit."""
    rng = np.random.default_rng(dim + r)
    base = rng.standard_normal((3000, dim)).astype(np.float32)
    idx = Index(dim, bits=2, r=r, device=cuda_device).build(base).finalize()
    kernels, plain, launched = _index_searches(
        idx, base[:24] + 0.05, 10, monkeypatch)
    assert launched > 0
    np.testing.assert_array_equal(kernels[0], plain[0])
    np.testing.assert_array_equal(kernels[1].view(np.int32),
                                  plain[1].view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["1bit-r32-e4-hash-rw8-k100",
                                  "4bit-r32-e4-dense-rw0-k100"])
def test_beam_kernels_from_global_scratch_equal_plain_step(
        cuda_device, case, monkeypatch):
    """With no workspace allowed in shared memory, every kernel works from
    global scratch (the route of a beam or query too large for shared
    memory): the search equals the plain torch step bit for bit."""
    from cphnsw_tpu_torch.kernels import beam_step
    from cphnsw_tpu_torch.search import beam

    bits, r, ew, hash_bits, rw, k = BEAM_CASES[case]
    idx, queries = _beam_index(cuda_device, bits, r)
    q_dev = torch.from_numpy(queries).to(cuda_device)

    def search():
        beam.drop_replays()
        return beam.search_batch(
            idx._raw, idx._norm_sq, idx._neighbors, idx._entry_candidates,
            idx._signs, q_dev, idx._params, bits=bits, k=k,
            beam_cap=max(2 * r, 4 * k), max_steps=300, expand_width=ew,
            visited_hash_bits=hash_bits, rerank_width=rw, debug_state=True)

    monkeypatch.setattr(beam_step, "SMEM_PER_BLOCK", 0)
    plan = beam_step.launch_plan(len(queries), max(2 * r, 4 * k), k, ew, r,
                                 rw or ew * r, idx._padded, bits,
                                 idx._neighbors.words)
    assert all(p.smem == 0 and p.workspace > 0 for p in plan[1:])
    assert plan.pop.workspace == 0          # the warp pop needs none
    scratch = search()
    monkeypatch.setattr(beam, "_step", beam._plain_step)
    plain = search()
    assert _same_bits(scratch[0], plain[0])
    assert _same_bits(scratch[1], plain[1])
    _assert_same_state(scratch[2], plain[2])


@pytest.mark.cuda
def test_beam_kernels_graphed_equal_eager_and_repeat(cuda_device,
                                                    monkeypatch):
    """The kernels replayed from the kept CUDA graph against the same
    steps launched eagerly, and a second run of each: ids, distances and
    the final state bit for bit (the hash-visited table at E = 4, and the
    dense table with the rerank cap)."""
    from cphnsw_tpu_torch.search import beam

    for bits, r, ew, hash_bits, rw, k in ((1, 32, 4, 13, 0, 10),
                                          (2, 16, 4, 0, 8, 100)):
        idx, queries = _beam_index(cuda_device, bits, r)
        q_dev = torch.from_numpy(queries).to(cuda_device)

        def run():
            return [beam.search_batch(
                idx._raw, idx._norm_sq, idx._neighbors,
                idx._entry_candidates, idx._signs, q_dev, idx._params,
                bits=bits, k=k, beam_cap=max(2 * r, 4 * k), max_steps=300,
                expand_width=ew, visited_hash_bits=hash_bits,
                rerank_width=rw, debug_state=True) for _ in range(2)]

        graphed, eager, captured = _both_routes(monkeypatch, run)
        assert len(captured) == 2
        for a in graphed[1:] + eager:
            assert _same_bits(a[0], graphed[0][0])
            assert _same_bits(a[1], graphed[0][1])
            _assert_same_state(a[2], graphed[0][2])


@pytest.mark.cuda
def test_index_and_sharded_index_launch_the_beam_kernels(cuda_device):
    """Index.search_batch, its step budget (the build) and ShardedIndex's
    shards go through the four kernels: their launch counts grow."""
    from cphnsw_tpu_torch import ShardedIndex
    from cphnsw_tpu_torch.kernels import beam_step
    from cphnsw_tpu_torch.parallel import sharded

    def counts():
        return (beam_step.pop_launches, beam_step.expand_launches,
                beam_step.merge_launches, beam_step.gamma_launches)

    rng = np.random.default_rng(16)
    base = rng.standard_normal((5000, 32)).astype(np.float32)
    before = counts()
    idx = Index(32, bits=1, device=cuda_device).build(base).finalize()
    built = counts()
    assert all(b > a for a, b in zip(before, built))
    idx.search_batch(base[:64] + 0.1, k=10)
    searched = counts()
    assert all(b > a for a, b in zip(built, searched))
    count = torch.cuda.device_count()
    sh = ShardedIndex(32, bits=1, r=16).build(base, sharded.make_mesh(
        1, 2, [torch.device("cuda", i % count) for i in range(2)]))
    sh_built = counts()
    sh.search_batch(base[:64] + 0.1, k=10)
    assert all(b > a for a, b in zip(sh_built, counts()))
    assert all(b > a for a, b in zip(searched, sh_built))
