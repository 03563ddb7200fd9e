"""Counter-based sampling noise that reproduces ``jax.random`` bit for bit.

The JAX engine derives one key per slot as
``fold_in(PRNGKey(seed), position)`` and samples with
``jax.random.categorical`` (``engine.py::_sampling_keys`` and
``_rowwise_categorical``). This module is the same arithmetic in tensor
code, so a seeded request samples the same tokens on both engines:

- keys are threefry2x32 pairs ``(k0, k1)``; ``PRNGKey(seed)`` of a 32-bit
  seed is ``(0, seed)`` and ``fold_in(key, data)`` is
  ``threefry2x32(key, (0, data))``;
- random bits follow ``jax_threefry_partitionable=True`` (the default
  since jax 0.5): element ``i`` of a ``[V]`` draw hashes the counter pair
  ``(0, i)`` and keeps ``y0 ^ y1``;
- uniforms keep the top 23 bits as a mantissa in [1, 2), minus 1, then
  ``max(tiny, u * 1 + tiny)``; gumbel is ``-log(-log(u))``; categorical
  is ``argmax(gumbel + logits)``.

Unsigned 32-bit words are held in int64 tensors and masked after every
addition. This is plain tensor code, not a kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny

Key = Tuple[torch.Tensor, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1) -> Key:
    """The Threefry-2x32 block cipher (20 rounds), broadcasting over its
    int64 operands (each holding a uint32 value)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK32
    return x0, x1


def prng_key(seeds: torch.Tensor) -> Key:
    """``jax.random.PRNGKey`` of 32-bit seeds: ``(0, seed)``."""
    seeds = seeds.to(torch.int64) & MASK32
    return torch.zeros_like(seeds), seeds


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """``jax.random.fold_in`` with 32-bit data, elementwise over a batch
    of keys."""
    k0, k1 = key
    data = data.to(torch.int64) & MASK32
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def sampling_keys(seeds: torch.Tensor, positions: torch.Tensor) -> Key:
    """One key per slot from (seed, cache position), as the JAX engine's
    ``_sampling_keys``."""
    return fold_in(prng_key(seeds), positions)


def random_bits(key: Key, width: int) -> torch.Tensor:
    """[S, width] uint32 words (in int64) per key, partitionable layout."""
    k0, k1 = key
    counters = torch.arange(width, dtype=torch.int64, device=k0.device)[None, :]
    y0, y1 = threefry2x32(
        k0[:, None], k1[:, None], torch.zeros_like(counters), counters
    )
    return y0 ^ y1


def uniform(key: Key, width: int) -> torch.Tensor:
    """``jax.random.uniform(key, (width,), minval=tiny, maxval=1)`` per key."""
    bits = random_bits(key, width)
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mantissa.view(torch.float32) - 1.0
    # maxval - minval rounds to 1.0 in f32, so the scale is exact
    return torch.clamp_min(floats * 1.0 + _F32_TINY, _F32_TINY)


def unit_uniform(key: Key) -> torch.Tensor:
    """``jax.random.uniform(key)`` (one value in [0, 1), minval 0) per
    key: word 0 of the key's draw, with no ``tiny`` floor."""
    bits = random_bits(key, 1)[:, 0]
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(mantissa.view(torch.float32) - 1.0, 0.0)


def gumbel(key: Key, width: int) -> torch.Tensor:
    return -torch.log(-torch.log(uniform(key, width)))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """Row-wise ``jax.random.categorical``: argmax of gumbel noise plus
    the [S, V] f32 logits."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
