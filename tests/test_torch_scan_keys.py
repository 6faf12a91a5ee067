"""The fused scan+select kernel of the PyTorch port against the JAX
package's Pallas kernel (run in interpret mode on the CPU).

On a CPU tensor the port's wrapper runs the kernel's plain PyTorch
version; the CUDA kernel itself is held against that plain version in
tests/test_torch_cuda.py, which runs only on a machine with a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cphnsw_tpu.ops import hadamard as jhad
from cphnsw_tpu.ops import pack as jpack
from cphnsw_tpu.ops import quantize as jquant
from cphnsw_tpu.search import scan as jscan
from cphnsw_tpu_torch.kernels import scan_keys
from cphnsw_tpu_torch.search import scan as tscan

torch.set_num_threads(2)

# Keys from the two packages agree on >= 99.9% of entries.  The port
# rounds the score in the fused multiply-add order XLA uses here, so they
# are expected to be equal; an XLA that contracted differently would move
# scores by a few ulps and reorder a few near-equal keys of one bin.
MIN_KEY_EQUAL = 0.999
N, DIM, Q = 4800, 32, 64  # n_pad 4864: kernel pad rows in both modes


def clustered(seed, n, dim, n_clusters=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3.0
    assign = rng.integers(0, n_clusters, size=n)
    return centers[assign] + rng.standard_normal((n, dim)).astype(np.float32)


def to_u32(keys: torch.Tensor) -> np.ndarray:
    """The port's signed keys in the JAX package's u32 convention."""
    return keys.numpy().view(np.uint32) ^ np.uint32(0x80000000)


def both(operands, bins):
    """(JAX u32 keys, port u32 keys) on the same numpy operands."""
    want = np.asarray(jscan.fused_scan_keys(
        *(jnp.asarray(o) for o in operands), bins, interpret=True))
    before = scan_keys.launches
    got = scan_keys.fused_scan_keys(
        *(torch.from_numpy(np.array(o)) for o in operands), bins)
    assert scan_keys.launches == before  # the plain version is not a launch
    return want, to_u32(got)


def test_sketch_mode_keys_match():
    x = clustered(0, N, DIM)
    n_pad = jscan.store_pad(N)
    bins, groups, rows_kpad = scan_keys.fused_bin_plan(n_pad, 512)
    assert groups > scan_keys.FUSED_TOPM  # the top-4 lattice really merges
    raw = torch.nn.functional.pad(torch.from_numpy(x), (0, 0, 0, n_pad - N))
    sk = tscan.make_rerank_sketch(raw, (raw * raw).sum(-1), force_int8=True)
    codes, aux = tscan.sketch_store_operands(sk, N, rows_kpad)
    q = x[np.random.default_rng(1).choice(N, Q, replace=False)] + 0.05
    q8, w_fs, y_aux = tscan.sketch_query(torch.from_numpy(q), sk.scale)
    ops = [t.numpy() for t in (codes, aux, q8, w_fs, y_aux)]
    want, got = both(ops, bins)
    assert got.shape == want.shape == (Q, scan_keys.FUSED_TOPM * bins)
    assert (got == want).mean() >= MIN_KEY_EQUAL


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_estimate_mode_keys_match(bits):
    x = clustered(bits, N, DIM)
    p = jhad.next_pow2(DIM)
    n_pad = jscan.store_pad(N)
    signs = jhad.rotation_signs(42, p)
    raw, _ = jscan.pad_store_and_norms(jnp.asarray(x), rows=n_pad, cols=p)
    centroid = jquant.compute_centroid(raw[:N])
    planes, nop, ip_qo, ip_cp, wpc = jscan.encode_scan_store(
        raw, centroid, signs, bits)
    floor = float(np.quantile(np.asarray(ip_qo), 0.02))
    aux_j = np.asarray(jscan.fold_node_constants(
        nop, ip_qo, ip_cp, wpc, jnp.asarray(floor, jnp.float32),
        jnp.asarray(N)))
    aux_t = tscan.fold_node_constants(
        *(torch.tensor(np.asarray(a)) for a in (nop, ip_qo, ip_cp, wpc)),
        floor, N).numpy()
    # the folded constants: rtol 1e-6 (elementwise f32, same op order)
    np.testing.assert_allclose(aux_t, aux_j, rtol=1e-6)

    bins, groups, rows_kpad = scan_keys.fused_bin_plan(n_pad, 256)
    assert groups > scan_keys.FUSED_TOPM and rows_kpad > n_pad
    codes_t, aux_kt = tscan.estimate_store_operands(
        torch.from_numpy(np.array(planes).view(np.int32)),
        torch.tensor(aux_j), rows_kpad, p)
    planes = jnp.pad(planes, ((0, rows_kpad - n_pad), (0, 0), (0, 0)))
    aux_j = np.pad(aux_j, ((0, 0), (0, rows_kpad - n_pad)))
    aux_j[0, n_pad:] = scan_keys.PAD_SCORE
    codes = np.asarray(jpack.unpack_codes_i8(planes, p))
    # the port's operand prep: the same padded codes and aux, exactly
    np.testing.assert_array_equal(codes_t.numpy(), codes)
    np.testing.assert_array_equal(aux_kt.numpy(), aux_j)
    q = x[np.random.default_rng(7).choice(N, Q, replace=False)] + 0.05
    qc, w_fs, y_aux = jscan._query_side(jnp.asarray(q), signs, 1.05, -0.02,
                                        float((1 << bits) - 1))
    ops = [codes, aux_j, np.asarray(qc.q_u).astype(np.int8),
           np.asarray(w_fs), np.asarray(y_aux)]
    want, got = both(ops, bins)
    assert (got == want).mean() >= MIN_KEY_EQUAL


@pytest.mark.parametrize("n_pad,top_c", [
    (4096, 64), (4096, 512), (100_096, 512), (102_400, 384),
    (1_000_192, 512), (1_000_192, 26_080), (10_000_128, 26_080)])
def test_bin_plan_and_sub_batch_equal(n_pad, top_c):
    assert scan_keys.fused_bin_plan(n_pad, top_c) == jscan.fused_bin_plan(
        n_pad, top_c)
    assert scan_keys.derived_sub_batch(n_pad, top_c) == \
        jscan.derived_sub_batch(n_pad, top_c)


def test_main_path_shapes():
    # 100k and 1M x 128d in sketch mode (k = 10 -> 512 survivors)
    assert scan_keys.fused_bin_plan(100_096, 512) == (1024, 98, 100_352)
    assert scan_keys.fused_bin_plan(1_000_192, 512) == (1024, 977, 1_000_448)
    assert scan_keys.derived_sub_batch(1_000_192, 512) == 2048


def test_wrapper_rejects_bad_operands():
    rows, p, q, bins = 1024, 16, 8, 512
    ok = [torch.zeros((rows, p), dtype=torch.int8),
          torch.zeros((6, rows)), torch.zeros((q, p), dtype=torch.int8),
          torch.zeros(q), torch.zeros((q, 5))]
    assert scan_keys.fused_scan_keys(*ok, bins).shape == (q, 4 * bins)
    bad_dtype = list(ok)
    bad_dtype[0] = ok[0].to(torch.int32)
    with pytest.raises(TypeError):
        scan_keys.fused_scan_keys(*bad_dtype, bins)
    bad_shape = list(ok)
    bad_shape[4] = torch.zeros((q, 4))
    with pytest.raises(ValueError):
        scan_keys.fused_scan_keys(*bad_shape, bins)
    with pytest.raises(ValueError):
        scan_keys.fused_scan_keys(*ok, 384)      # rows not a multiple of bins
    strided = list(ok)
    strided[1] = torch.zeros((rows, 6)).T
    with pytest.raises(ValueError):
        scan_keys.fused_scan_keys(*strided, bins)
