"""Counter-based random numbers: the threefry2x32 draws that GOSS takes.

The JAX package draws GOSS's uniform numbers with `jax.random`
(lightgbm_tpu/boosting/goss.py): `PRNGKey(seed)`, `split(key)` and
`uniform(key, (N,))` under threefry2x32 with partitionable counters
(`jax_threefry_partitionable`, the default of the JAX releases this port
is held against).  This module computes the same bits with torch integer
ops, so a GOSS run draws the same rows on the CPU and on the GPU as the
JAX package does, and does not need JAX to run:

- a key is two 32-bit words, held as an int64 tensor of shape [2] (on
  the host: the words are read as Python ints, and only the draws run
  on the device);
- `split(key, n)[i]` is threefry2x32(key, (0, i));
- `uniform(key, (N,))` hashes the counters (hi, lo) of 0 .. N-1 and
  keeps bits1 ^ bits2; the float is (bits >> 9) | 0x3F800000 read as a
  float32, minus 1 (an exact float in [0, 1)).

Every word is an int64 masked to 32 bits, so the ops run the same on any
device.  tests/test_torch_boosting_variants.py pins the bits against
`jax.random`.
"""
from __future__ import annotations

from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The threefry2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2): 20 rounds, the key injected every 4.  x1, x2 are int64
    tensors holding 32-bit words; returns two such tensors."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ 0x1BD11BDA) & _MASK)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def PRNGKey(seed: int) -> torch.Tensor:
    """The key of an integer seed, as `jax.random.PRNGKey` makes it: a
    seed that fits 32 bits (JAX's default integer width) is the pair
    (0, seed mod 2^32); a wider one is its two 32-bit halves."""
    seed = int(seed)
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & _MASK
    return torch.tensor([hi, seed & _MASK], dtype=torch.int64)


def _words(key: torch.Tensor):
    k = key.tolist()
    return int(k[0]), int(k[1])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`num` new keys [num, 2]: key i is the hash of the counter (0, i)."""
    k1, k2 = _words(key)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=1)


def random_bits(key: torch.Tensor, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)) on `device` (the
    key's by default): bits1 ^ bits2 of the hash of the element's flat
    index as a (hi, lo) counter pair."""
    n = 1
    for d in shape:
        n *= int(d)
    if n >= 1 << 32:
        raise ValueError("random_bits takes fewer than 2^32 elements")
    k1, k2 = _words(key)
    lo = torch.arange(n, dtype=torch.int64,
                      device=key.device if device is None else device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int],
            device=None) -> torch.Tensor:
    """float32 uniform in [0, 1) on `device`: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
