"""``jax.random``'s threefry2x32 key split and float32 uniforms as plain
torch functions, so a seed gives the JAX package's jitter bit for bit
(the megakernel's stratified sample positions at spp > 1).

The sequence is the JAX package's default PRNG as ``jax 0.9`` runs it,
with ``jax_threefry_partitionable`` on: ``PRNGKey(seed)`` is the word
pair (0, seed); ``split(key)`` hashes the counters (0, 0) and (0, 1)
into two new keys; ``uniform(key, shape)`` hashes the 64-bit index of
every element, split in (high, low) words, XORs the two output words,
keeps the top 23 bits as the mantissa of a float in [1, 2) and
subtracts 1.

uint32 arithmetic is carried in int64 tensors masked to 32 bits, as
``utils/sampling.py`` does (torch's uint32 tensors lack ``+`` and
``>>``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words ``x0``, ``x1``
    (int64 tensors in [0, 2^32)) under ``key``."""
    ks = (key[0] & _MASK, key[1] & _MASK,
          (key[0] ^ key[1] ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2^31."""
    if not 0 <= int(seed) < 2**31:
        raise ValueError(f"seed must be in [0, 2^31), got {seed}")
    return (0, int(seed))


def split(key: Key) -> Tuple[Key, Key]:
    """``jax.random.split(key)``: two new keys."""
    y0, y1 = threefry2x32(key, torch.zeros(2, dtype=torch.int64),
                          torch.arange(2, dtype=torch.int64))
    return (int(y0[0]), int(y1[0])), (int(y0[1]), int(y1[1]))


def uniform(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1), computed on
    ``device``."""
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError("more than 2^32 elements")
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, torch.zeros_like(idx), idx)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(
        tuple(shape))
