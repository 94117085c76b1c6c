"""The counter-based sampler the frames draw their randoms from: a frozen
copy of the PCG-style integer hash of (pixel, sample, bounce, dim, seed)
that the port's ``utils/sampling.py`` and the JAX package share.

uint32 arithmetic is carried in int64 tensors masked to 32 bits, products
split in 16-bit halves so no int64 product overflows.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_M1 = 747796405
_M2 = 2891336453
_M3 = 277803737
_GOLD = 0x9E3779B9
_MIX = 0x85EBCA6B


def _u32(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return (v.to(torch.int64) & MASK) + torch.zeros_like(like)
    return torch.full_like(like, int(v) & MASK)


def _mul32(v: torch.Tensor, k: int) -> torch.Tensor:
    lo = v & 0xFFFF
    hi = v >> 16
    return (lo * k + (((hi * k) & 0xFFFF) << 16)) & MASK


def pcg(v: torch.Tensor) -> torch.Tensor:
    state = (_mul32(v & MASK, _M1) + _M2) & MASK
    word = _mul32((state >> ((state >> 28) + 4)) ^ state, _M3)
    return (word >> 22) ^ word


def hash3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    h = pcg(a ^ _GOLD)
    h = pcg((h + _mul32(b, _MIX)) & MASK)
    return pcg((h + _mul32(c, _GOLD)) & MASK)


def u01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 in [0, 1): the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def sample2(pixel: torch.Tensor, sample, bounce, seed, dim: int):
    """Two uniforms in [0, 1) per (pixel, sample, bounce, dim, seed)."""
    pixel = pixel.to(torch.int64) & MASK
    dim_mix = (int(dim) * 0x632BE59B) & MASK
    sample = _u32(sample, pixel)
    seed = _u32(seed, pixel)
    base = hash3(pixel, (sample + dim_mix) & MASK,
                 _u32(bounce, pixel) ^ pcg(seed))
    return u01(base), u01(pcg(base ^ _GOLD))


def stratified_jitter(pixel: torch.Tensor, sample, total_spp: int):
    """Sub-pixel (jx, jy): sample s in cell s of a ceil(sqrt(total_spp))^2
    grid, jittered inside it (seed 0); pixel centres at total_spp 1."""
    if total_spp == 1:
        half = torch.full(pixel.shape, 0.5, dtype=torch.float32,
                          device=pixel.device)
        return half, half.clone()
    g = int(math.ceil(math.sqrt(total_spp)))
    s = _u32(sample, pixel.to(torch.int64)) % total_spp
    cx = (s % g).to(torch.float32)
    cy = (s // g).to(torch.float32)
    u, v = sample2(pixel, sample, 0, 0, dim=7)
    inv_g = 1.0 / g
    return (cx + u) * inv_g, (cy + v) * inv_g
