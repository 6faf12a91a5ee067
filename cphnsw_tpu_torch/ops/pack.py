"""Bit-plane packing of N-bit RaBitQ codes.

PyTorch counterpart of ``cphnsw_tpu/ops/pack.py``: codes u in [0, 2^B-1]
are stored as B bit-planes, MSB first, each plane packed 32 coordinates per
32-bit word (coordinate j*32+i is bit i of word j).  The planes are the
index file format, so they are byte-identical to the JAX package's.

torch has little uint32 support (no shifts or ``minimum`` on CPU), so the
planes live in ``int32`` tensors holding the same bits; the packing math
runs in int64.  Convert with ``.numpy().view(np.uint32)`` only at
save/load.
"""

from __future__ import annotations

import torch

WORD_BITS = 32
# Rows per unpack step for store-sized inputs: the (rows, bits, W, 32)
# intermediate is 32x the packed input, so whole-store unpacks go in steps
# while only the int8 output exists at full size.
UNPACK_CHUNK = 1 << 18


def num_words(padded_dim: int) -> int:
    return (padded_dim + WORD_BITS - 1) // WORD_BITS


def pack_planes(u: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack integer codes (..., P) -> int32 planes (..., bits, P//32)."""
    p = u.shape[-1]
    w = num_words(p)
    u = u.to(torch.int64)
    if p != w * WORD_BITS:
        u = torch.nn.functional.pad(u, (0, w * WORD_BITS - p))
    shifts = torch.arange(bits - 1, -1, -1, dtype=torch.int64,
                          device=u.device)                  # MSB first
    plane_bits = (u[..., None, :] >> shifts[:, None]) & 1   # (..., bits, P)
    plane_bits = plane_bits.reshape(*plane_bits.shape[:-1], w, WORD_BITS)
    weights = torch.ones((), dtype=torch.int64, device=u.device) << torch.arange(
        WORD_BITS, dtype=torch.int64, device=u.device)
    words = (plane_bits * weights).sum(dim=-1)              # [0, 2^32)
    # reinterpret the low 32 bits as int32 (two's complement)
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(
        torch.int32)


def _plane_bits(planes: torch.Tensor, padded_dim: int) -> torch.Tensor:
    """(..., bits, W) int32 words -> (..., bits, P) 0/1 int32 bits."""
    bit_idx = torch.arange(WORD_BITS, dtype=torch.int32, device=planes.device)
    # arithmetic right shift keeps the low bits right for negative words
    expanded = (planes[..., None] >> bit_idx) & 1
    return expanded.reshape(*planes.shape[:-1], -1)[..., :padded_dim]


def unpack_planes(planes: torch.Tensor, padded_dim: int) -> torch.Tensor:
    """Unpack planes (..., bits, W) -> integer codes (..., P) int32:
    u = sum_b 2^(bits-1-b) * plane_b."""
    bits = planes.shape[-2]
    weights = 1 << torch.arange(bits - 1, -1, -1, dtype=torch.int32,
                                device=planes.device)
    return (_plane_bits(planes, padded_dim) * weights[:, None]).sum(
        dim=-2, dtype=torch.int32)


def unpack_msb(planes: torch.Tensor, padded_dim: int,
               bits: int) -> torch.Tensor:
    """The MSB part of the codes for the two-stage N-bit bound: plane 0
    alone (values 0/1) for bits < 2, else planes 0-1 as 2*p0 + p1 (values
    0..3)."""
    n_planes = 1 if bits < 2 else 2
    return unpack_planes(planes[..., :n_planes, :], padded_dim)


def weighted_popcount(u: torch.Tensor) -> torch.Tensor:
    """sum_d u_d over the last axis, int32."""
    return u.sum(dim=-1, dtype=torch.int32)


def _unpack_codes_i8_flat(planes: torch.Tensor, padded_dim: int):
    bits = planes.shape[-2]
    x = _plane_bits(planes, padded_dim).to(torch.int8)
    weights = torch.tensor([1 << (bits - 1 - b) for b in range(bits)],
                           dtype=torch.int8, device=planes.device)
    return (x * weights[:, None]).sum(dim=-2, dtype=torch.int8)


def unpack_codes_i8(planes: torch.Tensor, padded_dim: int) -> torch.Tensor:
    """Unpack planes (..., bits, W) -> combined codes (..., P) int8 (code
    values are <= 15, so int8 is exact).  A 3-D input with more than
    UNPACK_CHUNK rows unpacks in row steps."""
    if planes.ndim != 3 or planes.shape[0] <= UNPACK_CHUNK:
        return _unpack_codes_i8_flat(planes, padded_dim)
    out = torch.empty((planes.shape[0], padded_dim), dtype=torch.int8,
                      device=planes.device)
    for s in range(0, planes.shape[0], UNPACK_CHUNK):
        out[s:s + UNPACK_CHUNK] = _unpack_codes_i8_flat(
            planes[s:s + UNPACK_CHUNK], padded_dim)
    return out
