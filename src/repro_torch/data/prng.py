"""Threefry-2x32 counter-based random numbers, bit-identical to ``jax.random``.

The WAN model draws its per-window loss, duplication and jitter from
``jax.random.uniform(fold_in(PRNGKey(seed), window), (4, m), float32)`` in
the JAX package. A run of the port is comparable with a run of the reference
only if it draws the very same numbers, so this module re-implements that
path: ``threefry2x32`` (the Threefry-2x32 hash with 20 rounds, as in
``jax._src.prng``), ``prng_key``, ``fold_in`` and float32 ``uniform`` under
JAX's partitionable counter layout (``jax_threefry_partitionable``, the
default since jax 0.5): element i of the output hashes the 64-bit counter i
split as (hi, lo), and its 32 random bits are the XOR of the two hash words.

PyTorch has no unsigned shifts on 32-bit integers, so every word is an int64
holding the u32 value and every add is masked back to 32 bits. Keys are
Python ints (hashing them costs nothing); only the counter block is a tensor,
on whatever device the caller names.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter words (x1, x2) under key (k1, k2).

    Works elementwise on int64 tensors holding u32 values, or on Python
    ints. Returns the two output words.
    """
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    y0 = (x1 + ks[0]) & MASK
    y1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0 = (y0 + y1) & MASK
            y1 = _rotl(y1, r) ^ y0
        y0 = (y0 + ks[(i + 1) % 3]) & MASK
        y1 = (y1 + ks[(i + 2) % 3] + i + 1) & MASK
    return y0, y1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed mod 2^32).

    JAX (without x64) holds the seed as int32, so its high key word is the
    logical shift of a 32-bit value by 32, which is 0.
    """
    if not -(2**31) <= seed < 2**32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return 0, seed & MASK


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in``: hash the counter pair (0, data) under key."""
    return threefry2x32(key[0], key[1], 0, data & MASK)


def random_bits(key: tuple[int, int], shape, device) -> torch.Tensor:
    """32 random bits per element (int64 holding the u32 value)."""
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError("random_bits: more than 2^32 elements")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    hi = torch.zeros_like(lo)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key: tuple[int, int], shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1): ``jax.random.uniform(key, shape)``.

    The 23 high random bits become the mantissa of a float in [1, 2), less 1.
    """
    bits = random_bits(key, shape, device)
    one_bits = (bits >> 9) | 0x3F800000
    return one_bits.to(torch.int32).view(torch.float32) - 1.0
