"""Fused int8 scan + per-bin top-4 key selection: the search kernel.

Replaces the JAX package's Pallas kernel ``cphnsw_tpu/search/scan.py::
_fused_kernel``, launched by ``fused_scan_keys`` (``scan.py:387``).  Per
query q and kernel-padded store row r it computes

    fs    = <q[q], codes[r]>                                   (int32)
    score = (w_fs[q] * aux[5, r]) * fs + sum_{a<5} y_aux[q, a] * aux[a, r]
    key   = signed-monotone int32 of score, low GROUP_BITS bits := r // bins

and keeps, per (q, bin = r % bins), the FUSED_TOPM smallest keys over all
groups.  The output is the four key planes side by side, (Q, 4 * bins)
int32, kept SIGNED all through the port (the JAX package maps them to its
u32 convention with ``^ 0x80000000``; the order is the same).

The score is rounded in the order XLA gives the JAX kernel on the CPU:
s = fma(w_fs * aux5, fs, y_aux0 * aux0), then s = fma(y_aux_a, aux_a, s)
for a = 1..4, each fma rounded once.  The CUDA kernel writes this order
out with __fmaf_rn / __fmul_rn and the plain version below emulates it,
so the three agree bit for bit.  (Estimate-mode scores cancel large terms,
so another rounding order would reorder ~1% of the keys.)

``fused_scan_keys`` launches the hand-written CUDA kernel
(``csrc/scan_keys.cu``) for CUDA tensors and runs the plain PyTorch
version ``scan_keys_reference`` for CPU tensors; it never falls back from
one to the other.  The CUDA source is compiled with ``nvcc`` at first use
into ``build/cphnsw_tpu_torch/`` beside the package and loaded with
ctypes (``kernels/nvcc.py``).  ``launch_plan`` is the launch's shape in
plain Python: queries padded to the kernel's 128-query tile, K to 16
bytes, and the number of group ranges (``split_count``) that a small
batch's tiles are spread over to fill the card, merged exactly on the
card afterwards.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from cphnsw_tpu_torch.kernels import nvcc
from cphnsw_tpu_torch.ops.rounding import fma_f32

GROUP_BITS = 10
GROUP_MASK = (1 << GROUP_BITS) - 1
NOT_GROUP = ~GROUP_MASK                # int32 -1024
I32_MAX = 0x7FFFFFFF
FUSED_TOPM = 4
# Bins per search: FUSED_BIN_FACTOR * top_c keeps lambda = top_c / bins
# <= 0.5, so a candidate at the deepest needed rank is lost only when four
# better rows share its bin: P(Poisson(0.5) >= 4) ~ 0.2%.
FUSED_BIN_FACTOR = 2
FUSED_BINS_MIN = 512
BIN_BLOCK = 512
# Pad-row sentinel added to scores via the node-constant channel: large
# enough to rank last, small enough that the score stays finite.
PAD_SCORE = 1e30

# Tiles of the CUDA kernel (csrc/scan_keys.cu): BQ queries x BN bins per
# block; TMA needs row strides that are multiples of 16 bytes (it fills
# the K tail of each 128-byte box with zeros itself).
Q_TILE = 128
BIN_TILE = 32
K_ALIGN = 16

SOURCE = nvcc.CSRC / "scan_keys.cu"
BUILD_DIR = nvcc.BUILD_DIR
NVCC_FLAGS = nvcc.NVCC_FLAGS

# Number of CUDA scan kernel launches, and of merge kernel launches (one
# more per split call); the plain version does not count.
launches = 0
merge_launches = 0


def fused_bin_plan(n_pad: int, top_c: int) -> tuple[int, int, int]:
    """(bins, groups, rows_kpad) over the whole store.

    bins is a multiple of BIN_BLOCK, at least FUSED_BIN_FACTOR * top_c
    (capture) and at least n_pad / 2^GROUP_BITS (the group index must pack
    into the low key bits).  These two numbers are the kernel's contract:
    they fix which rows compete for a bin."""
    want = max(FUSED_BINS_MIN, FUSED_BIN_FACTOR * top_c,
               -(-n_pad // (1 << GROUP_BITS)))
    bins = -(-want // BIN_BLOCK) * BIN_BLOCK
    bins = min(bins, -(-n_pad // BIN_BLOCK) * BIN_BLOCK)
    groups = -(-n_pad // bins)
    return bins, groups, groups * bins


def derived_sub_batch(n_pad: int, top_c: int, cap: int = 2048) -> int:
    """Search sub-batch size: halve from ``cap`` until the selection's
    per-sub-batch transients (~24 B per (query, bin) key element: the key
    planes, the decode top-k scratch) fit in ~1 GB."""
    bins = fused_bin_plan(n_pad, top_c)[0]
    sub = cap
    while sub > 256 and sub * bins * 24 > (1 << 30):
        sub //= 2
    return sub


def split_count(tiles: int, groups: int, sms: int) -> int:
    """Ranges to split the group axis into, so that a block per (tile,
    range) fills the `sms` multiprocessors in one wave when the tiles
    alone do not (small query batches); at most one range per group.
    Each extra range costs a partial plane set and the merge, so a card
    the tiles already fill gets none.  The scratch stays within
    sms * Q_TILE * BIN_TILE * 4 keys (8.6 MB on 132 SMs)."""
    return max(1, min(sms // tiles, groups))


class LaunchPlan(NamedTuple):
    q_pad: int                  # queries padded to Q_TILE
    p_k: int                    # K width padded to K_ALIGN
    tiles: int                  # (q_pad / Q_TILE) * (bins / BIN_TILE)
    splits: int                 # group ranges, one block each per tile
    scratch: tuple | None       # partial key planes when splits > 1


def launch_plan(q: int, p: int, bins: int, groups: int, sms: int,
                splits: int | None = None) -> LaunchPlan:
    """How the CUDA kernel covers a (q, p) query block against groups x
    bins rows on a card with `sms` multiprocessors; `splits` overrides
    the split count (1 <= splits <= groups)."""
    if bins % BIN_TILE:
        raise ValueError(f"bins {bins} is not a multiple of {BIN_TILE}")
    q_pad = -(-q // Q_TILE) * Q_TILE
    tiles = q_pad // Q_TILE * (bins // BIN_TILE)
    if splits is None:
        splits = split_count(tiles, groups, sms)
    elif not 1 <= splits <= groups:
        raise ValueError(f"splits {splits} must lie in 1..groups {groups}")
    scratch = (splits, q_pad, FUSED_TOPM * bins) if splits > 1 else None
    return LaunchPlan(q_pad, -(-p // K_ALIGN) * K_ALIGN, tiles, splits,
                      scratch)


def _check_operands(codes_i8, node_aux_k, q_u_i8, w_fs, y_aux, bins,
                    first_group=0):
    rows_kpad, p = codes_i8.shape
    q = q_u_i8.shape[0]
    dev = codes_i8.device
    want = {
        "codes_i8": (codes_i8, torch.int8, (rows_kpad, p)),
        "node_aux_k": (node_aux_k, torch.float32, (6, rows_kpad)),
        "q_u_i8": (q_u_i8, torch.int8, (q, p)),
        "w_fs": (w_fs, torch.float32, (q,)),
        "y_aux": (y_aux, torch.float32, (q, 5)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, codes_i8 on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bins <= 0 or rows_kpad % bins:
        raise ValueError(f"rows {rows_kpad} are not a multiple of bins {bins}")
    if first_group < 0 or first_group + rows_kpad // bins > (1 << GROUP_BITS):
        raise ValueError(f"groups {first_group}..{first_group + rows_kpad // bins}"
                         f" exceed the {1 << GROUP_BITS} that pack into the "
                         f"key")


def folded_scores(fs, aux, w_fs, y_aux) -> torch.Tensor:
    """(Q, rows) f32 scores from f32 products fs (Q, rows) and the rows'
    aux (6, rows), rounded in the kernel's operation order."""
    score = fma_f32(w_fs[:, None] * aux[5][None, :], fs,
                    y_aux[:, 0, None] * aux[0][None, :])
    for a in range(1, 5):
        score = fma_f32(y_aux[:, a, None], aux[a][None, :], score)
    return score


def signed_keys(score: torch.Tensor) -> torch.Tensor:
    """Signed-monotone int32 keys of f32 scores: the order of the keys is
    the order of the scores."""
    i = score.view(torch.int32)
    return torch.where(i >= 0, i, i ^ I32_MAX)


def scan_keys_reference(codes_i8, node_aux_k, q_u_i8, w_fs, y_aux,
                        bins: int, first_group: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same signature and output.
    ``first_group`` numbers the rows' groups from there (a range of a
    larger store), as one split of the kernel's group axis does.

    Loops over groups keeping the four key planes, so memory stays at
    O(Q * bins).  fs is a float64 product: exact for |fs| < 2^53, and it
    runs on CPU and CUDA alike (an int32 matmul does not run on CUDA and
    fp32 is not exact at P = 2048).  The epilogue uses the kernel's
    operation order; each fused multiply-add is emulated in float64 (the
    f32 x f32 product is exact there)."""
    _check_operands(codes_i8, node_aux_k, q_u_i8, w_fs, y_aux, bins,
                    first_group)
    rows_kpad = codes_i8.shape[0]
    q = q_u_i8.shape[0]
    dev = codes_i8.device
    q64 = q_u_i8.to(torch.float64)
    planes = [torch.full((q, bins), I32_MAX, dtype=torch.int32, device=dev)
              for _ in range(FUSED_TOPM)]
    for g in range(rows_kpad // bins):
        rows = slice(g * bins, (g + 1) * bins)
        fs = (q64 @ codes_i8[rows].to(torch.float64).T).to(torch.float32)
        score = folded_scores(fs, node_aux_k[:, rows], w_fs, y_aux)
        carry = (signed_keys(score) & NOT_GROUP) | (first_group + g)
        for m in range(FUSED_TOPM - 1):
            old = planes[m]
            planes[m] = torch.minimum(old, carry)
            carry = torch.maximum(old, carry)
        planes[-1] = torch.minimum(planes[-1], carry)
    return torch.cat(planes, dim=1)


def merge_key_planes(parts: list[torch.Tensor]) -> torch.Tensor:
    """The 4 smallest keys per (query, bin) over several (Q, 4 * bins) key
    plane sets, e.g. the kernel's group ranges: keys of one bin carry
    distinct group bits, so this equals one pass over all the groups."""
    q, width = parts[0].shape
    bins = width // FUSED_TOPM
    keys = torch.cat([t.view(q, FUSED_TOPM, bins) for t in parts], dim=1)
    best = keys.sort(dim=1).values[:, :FUSED_TOPM]
    return best.reshape(q, width).contiguous()


def _nvcc() -> str:
    return nvcc.nvcc(SOURCE)


def library_path(extra_flags=(), build_dir: Path = BUILD_DIR) -> Path:
    """Where ``build_library`` puts the build with NVCC_FLAGS plus
    `extra_flags`: named by the hash of the source and all the flags."""
    return nvcc.library_path(SOURCE, extra_flags, build_dir)


def build_library(extra_flags=(),
                  build_dir: Path = BUILD_DIR) -> tuple[Path, float]:
    """Compile csrc/scan_keys.cu with NVCC_FLAGS plus `extra_flags` (e.g.
    a preprocessor switch) into ``library_path``; returns (path, seconds
    spent compiling), 0.0 seconds when that library already exists.
    ptxas's report (registers, shared memory, spills) is kept beside it
    (``build_log``)."""
    return nvcc.build_library(SOURCE, extra_flags, build_dir)


build_log = nvcc.build_log


@functools.cache
def load_library(path: Path | None = None) -> ctypes.CDLL:
    """The ctypes handle of a build from ``build_library`` at `path`;
    None: the package's own build, compiled at first use."""
    if path is None:
        path = build_library()[0]
    lib = nvcc.load(path)
    fn = lib.scan_keys_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.scan_keys_smem_bytes.argtypes = [ctypes.c_int]
    lib.scan_keys_smem_bytes.restype = ctypes.c_int
    return lib


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    pad = t.new_zeros((rows - t.shape[0], *t.shape[1:]))
    return torch.cat([t, pad])


def _launch_error(err: int) -> str:
    if err == 2000:
        return "the driver has no cuTensorMapEncodeTiled"
    if err > 1000:
        return f"cuTensorMapEncodeTiled failed: CUresult {err - 1000}"
    return f"CUDA error {err}"


def fused_scan_keys(codes_i8, node_aux_k, q_u_i8, w_fs, y_aux, bins: int,
                    *, splits: int | None = None,
                    library: Path | None = None) -> torch.Tensor:
    """(Q, FUSED_TOPM * bins) signed int32 packed top-4 bin keys over the
    kernel-padded store (rows_kpad = groups * bins rows).

    CPU tensors run ``scan_keys_reference``; CUDA tensors launch the CUDA
    kernel on the current stream (no synchronization); anything else
    raises.  `splits` overrides the planned split of the group axis and
    `library` names another build (``build_library``) of the kernel: both
    are for timing the kernel against itself, and the CPU ignores them."""
    global launches, merge_launches
    dev = codes_i8.device
    if dev.type == "cpu":
        return scan_keys_reference(codes_i8, node_aux_k, q_u_i8, w_fs,
                                   y_aux, bins)
    if dev.type != "cuda":
        raise ValueError(f"fused_scan_keys runs on cpu or cuda, not {dev}")
    _check_operands(codes_i8, node_aux_k, q_u_i8, w_fs, y_aux, bins)
    rows_kpad, p = codes_i8.shape
    q = q_u_i8.shape[0]
    groups = rows_kpad // bins
    plan = launch_plan(q, p, bins, groups, torch.cuda.get_device_properties(
        dev).multi_processor_count, splits)
    # zero K padding leaves every dot product unchanged
    if plan.p_k != p:
        codes_i8 = torch.nn.functional.pad(codes_i8, (0, plan.p_k - p))
        q_u_i8 = torch.nn.functional.pad(q_u_i8, (0, plan.p_k - p))
    q_u_i8 = _pad_rows(q_u_i8, plan.q_pad)
    w_fs = _pad_rows(w_fs, plan.q_pad)
    y_aux = _pad_rows(y_aux, plan.q_pad)
    # TMA reads from 16-byte aligned bases
    for name, t in (("codes_i8", codes_i8), ("node_aux_k", node_aux_k),
                    ("q_u_i8", q_u_i8)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((plan.q_pad, FUSED_TOPM * bins), dtype=torch.int32,
                      device=dev)
    partial = (torch.empty(plan.scratch, dtype=torch.int32, device=dev)
               if plan.scratch else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = load_library(library).scan_keys_launch(
            codes_i8.data_ptr(), node_aux_k.data_ptr(), q_u_i8.data_ptr(),
            w_fs.data_ptr(), y_aux.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            plan.q_pad, plan.p_k, bins, groups, plan.splits, stream,
        )
    if err != 0:
        raise RuntimeError(f"scan_keys kernel launch failed: "
                           f"{_launch_error(err)}")
    launches += 1
    if plan.splits > 1:
        merge_launches += 1
    return out[:q]
