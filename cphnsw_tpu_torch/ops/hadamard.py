"""Batched fast Walsh-Hadamard transform and random Hadamard rotation.

PyTorch counterpart of ``cphnsw_tpu/ops/hadamard.py``: the same
unnormalized butterfly stages, the same 3-layer random sign rotation with
the combined ``P**-1.5`` normalization, and sign layers that reproduce the
JAX package's ``jax.random.rademacher(PRNGKey(seed), (3, P))`` bit for bit.
An index file stores only the rotation seed, so the signs must regenerate
identically without JAX: ``rotation_signs`` draws them from the port's
copy of the Threefry-2x32 stream (``ops/threefry.py``).
"""

from __future__ import annotations

import torch

from cphnsw_tpu_torch.ops import threefry

NUM_ROTATION_LAYERS = 3
DEFAULT_ROTATION_SEED = 42


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p *= 2
    return p


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized fast Walsh-Hadamard transform along the last axis.

    Last-axis length must be a power of two.  Batched over leading axes.
    """
    d = x.shape[-1]
    if d & (d - 1):
        raise ValueError(f"FWHT length must be a power of two, got {d}")
    batch_shape = x.shape[:-1]
    h = 1
    while h < d:
        x = x.reshape(*batch_shape, d // (2 * h), 2, h)
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(*batch_shape, d)
        h *= 2
    return x


def rotation_signs(seed: int, padded_dim: int) -> torch.Tensor:
    """(NUM_LAYERS, padded_dim) Rademacher sign layers from a seed.

    Bit-equal to ``jax.random.rademacher(jax.random.PRNGKey(seed),
    (3, padded_dim), float32)``: the sign is +1 where the uniform of the
    element's Threefry bits (``ops/threefry.py``) is below 0.5 (JAX's
    ``bernoulli(key, 0.5)``).
    """
    bits = threefry.random_bits(threefry.prng_key(seed), 0,
                                NUM_ROTATION_LAYERS * padded_dim, "cpu")
    u = threefry.uniform_from_bits(bits)
    signs = torch.where(u < 0.5, 1.0, -1.0)
    return signs.reshape(NUM_ROTATION_LAYERS, padded_dim)


def rotate(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """Apply the 3-layer random Hadamard rotation with combined
    normalization: x (..., P) already padded to P == signs.shape[1];
    returns the rotated vectors scaled by P**-1.5 (orthonormal overall)."""
    p = signs.shape[-1]
    signs = signs.to(x.device)
    for layer in range(NUM_ROTATION_LAYERS):
        x = fwht(x * signs[layer])
    return x * (float(p) ** -1.5)


def pad_to(x: torch.Tensor, padded_dim: int) -> torch.Tensor:
    """Zero-pad the last axis to padded_dim."""
    d = x.shape[-1]
    if d == padded_dim:
        return x
    return torch.nn.functional.pad(x, (0, padded_dim - d))


def rotate_raw(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """Pad + rotate raw (unnormalized) vectors: no centering, no
    normalization, just the orthonormal rotation of the padded vector."""
    return rotate(pad_to(x, signs.shape[-1]), signs)
