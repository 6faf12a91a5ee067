"""The scan_keys kernel's launch plan and the exactness its group split
relies on, in plain Python and the kernel's plain PyTorch version (the
CUDA kernel itself is held against them in tests/test_torch_cuda.py)."""

import pytest
import torch

from cphnsw_tpu_torch.kernels import scan_keys

torch.set_num_threads(2)

H100_SMS = 132


# (q, p, bins, groups, sms) -> (q_pad, p_k, tiles, splits)
@pytest.mark.parametrize("shape,want", [
    # main path: 1M x 128d sketch mode, one 2048-query sub-batch
    ((2048, 128, 1024, 977, H100_SMS), (2048, 128, 512, 1)),
    # one sharded-scan shard (252,928 rows, estimate mode)
    ((2048, 128, 6656, 38, H100_SMS), (2048, 128, 3328, 1)),
    # 100k x 128d
    ((2048, 128, 1024, 98, H100_SMS), (2048, 128, 512, 1)),
    # the CLI's synthetic-20k-64d: 1000 queries in a 1024 bucket
    ((1024, 64, 1024, 20, H100_SMS), (1024, 64, 256, 1)),
    # a 64-query tail bucket on the 1M store: split to fill the card
    ((64, 128, 1024, 977, H100_SMS), (128, 128, 32, 4)),
    # an H100 PCIe (114 SMs)
    ((100, 128, 1024, 977, 114), (128, 128, 32, 3)),
    # split capped by the groups, K padded to 16 bytes
    ((100, 40, 512, 2, H100_SMS), (128, 48, 16, 2)),
    # tiles far fewer than the SMs: one block per SM
    ((100, 16, 64, 1024, H100_SMS), (128, 16, 2, 66)),
])
def test_launch_plan(shape, want):
    q, p, bins, groups, sms = shape
    plan = scan_keys.launch_plan(*shape)
    assert (plan.q_pad, plan.p_k, plan.tiles, plan.splits) == want
    assert plan.q_pad % scan_keys.Q_TILE == 0 and plan.q_pad >= q
    assert plan.p_k % scan_keys.K_ALIGN == 0 and plan.p_k >= p
    assert plan.splits <= groups
    if plan.splits > 1:
        assert plan.scratch == (plan.splits, plan.q_pad,
                                scan_keys.FUSED_TOPM * bins)
        assert plan.tiles * plan.splits <= sms
    else:
        assert plan.scratch is None


def test_launch_plan_rejects_bins_off_the_tile():
    with pytest.raises(ValueError):
        scan_keys.launch_plan(64, 128, scan_keys.BIN_TILE + 16, 4, H100_SMS)


@pytest.mark.parametrize("splits", [1, 2, 977])
def test_launch_plan_takes_forced_splits(splits):
    plan = scan_keys.launch_plan(64, 128, 1024, 977, H100_SMS, splits)
    assert plan.splits == splits
    assert plan.scratch == (None if splits == 1 else
                            (splits, 128, scan_keys.FUSED_TOPM * 1024))


@pytest.mark.parametrize("splits", [0, 978])
def test_launch_plan_rejects_splits_off_the_groups(splits):
    with pytest.raises(ValueError):
        scan_keys.launch_plan(64, 128, 1024, 977, H100_SMS, splits)


def test_library_path_hashes_source_and_flags(tmp_path):
    """Builds with other nvcc flags never share a library file."""
    base = scan_keys.library_path()
    assert base == scan_keys.library_path(())
    assert base.parent == scan_keys.BUILD_DIR
    other = scan_keys.library_path(["-DX=1"], tmp_path)
    assert other.parent == tmp_path and other.name != base.name
    assert scan_keys.build_log(other) == other.with_suffix(".log")


def _operands(groups, bins=64, p=16, q=20, seed=0):
    g = torch.Generator().manual_seed(seed)
    rows = groups * bins
    aux = torch.randn((6, rows), generator=g)
    aux[0, rows - bins // 2:] = scan_keys.PAD_SCORE
    return [torch.randint(-128, 128, (rows, p), dtype=torch.int8,
                          generator=g), aux,
            torch.randint(-128, 128, (q, p), dtype=torch.int8, generator=g),
            torch.randn(q, generator=g), torch.randn((q, 5), generator=g)]


def _range_planes(ops, bins, lo, hi):
    """The plain version over groups [lo, hi), keyed by the global group."""
    rows = slice(lo * bins, hi * bins)
    return scan_keys.scan_keys_reference(
        ops[0][rows].contiguous(), ops[1][:, rows].contiguous(), *ops[2:],
        bins, first_group=lo)


@pytest.mark.parametrize("cuts", [(6,), (1, 2, 11), (4, 8), (3, 5, 7, 9),
                                  tuple(range(1, 12))])
def test_split_merge_equals_one_pass(cuts):
    groups, bins = 12, 64
    ops = _operands(groups, bins)
    edges = [0, *cuts, groups]
    parts = [_range_planes(ops, bins, lo, hi)
             for lo, hi in zip(edges[:-1], edges[1:])]
    want = scan_keys.scan_keys_reference(*ops, bins)
    assert torch.equal(scan_keys.merge_key_planes(parts), want)
    # the merge is order-free: keys of one bin carry distinct group bits
    assert torch.equal(scan_keys.merge_key_planes(parts[::-1]), want)


@pytest.mark.parametrize("splits", [2, 3, 7, 12])
def test_kernel_ranges_merge_to_one_pass(splits):
    """The kernel's own ranges: block z scans groups
    [z * groups // splits, (z + 1) * groups // splits)."""
    groups, bins = 12, 64
    ops = _operands(groups, bins, seed=splits)
    parts = [_range_planes(ops, bins, z * groups // splits,
                           (z + 1) * groups // splits)
             for z in range(splits)]
    assert torch.equal(scan_keys.merge_key_planes(parts),
                       scan_keys.scan_keys_reference(*ops, bins))


def test_first_group_sets_the_key_group_bits():
    ops = _operands(3, seed=5)
    keys = scan_keys.scan_keys_reference(*ops, 64, first_group=1000)
    # 3 groups fill 3 planes; the 4th keeps the I32_MAX sentinel
    low = keys[keys != scan_keys.I32_MAX] & scan_keys.GROUP_MASK
    assert set(low.unique().tolist()) == {1000, 1001, 1002}
    with pytest.raises(ValueError):
        scan_keys.scan_keys_reference(*ops, 64, first_group=1022)
