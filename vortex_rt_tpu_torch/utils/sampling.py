"""Deterministic counter-based sampler on torch tensors (port of
``vortex_rt_tpu/utils/sampling.py``).

The streams are bit-identical to the JAX package's ``np``/``jnp`` path:
the same PCG-style integer hash of (pixel, sample, bounce, dim, seed).
No ``torch.Generator`` is involved; seeds are explicit integers.

uint32 arithmetic is carried in int64 tensors masked to 32 bits: torch's
uint32 tensors implement ``*`` and ``^`` but not ``+``, ``>>``, ``%`` or
``//``.  Products are split in 16-bit halves so no int64 product
overflows.  Every function takes int64 tensors (or Python ints) holding
u32 values and returns int64 tensors in [0, 2^32) or float32 uniforms.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_MASK = 0xFFFFFFFF
_M1 = 747796405
_M2 = 2891336453
_M3 = 277803737
_GOLD = 0x9E3779B9    # 2^32 / phi
_MIX = 0x85EBCA6B


def _u32(v, like: torch.Tensor = None) -> torch.Tensor:
    """u32 value(s) as an int64 tensor in [0, 2^32)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & _MASK
    dev = None if like is None else like.device
    return torch.tensor(int(v) & _MASK, dtype=torch.int64, device=dev)


def _mul32(v: torch.Tensor, k: int) -> torch.Tensor:
    """(v * k) mod 2^32 for v in [0, 2^32) and a constant k < 2^32, with
    every intermediate below 2^49."""
    lo = v & 0xFFFF
    hi = v >> 16
    return (lo * k + (((hi * k) & 0xFFFF) << 16)) & _MASK


def pcg(v) -> torch.Tensor:
    """PCG output permutation: uint32 -> well-mixed uint32."""
    v = _u32(v)
    state = (_mul32(v, _M1) + _M2) & _MASK
    word = _mul32((state >> ((state >> 28) + 4)) ^ state, _M3)
    return (word >> 22) ^ word


def hash3(a, b, c) -> torch.Tensor:
    """Mix three uint32 streams into one (order-sensitive); scalars are
    broadcast to ``a``'s shape."""
    a = _u32(a)
    z = torch.zeros_like(a)
    b = _u32(b, a) + z
    c = _u32(c, a) + z
    h = pcg(a ^ _GOLD)
    h = pcg((h + _mul32(b, _MIX)) & _MASK)
    return pcg((h + _mul32(c, _GOLD)) & _MASK)


def u01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 in [0, 1): top 24 bits scaled (fp32-exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def sample2(pixel, sample, bounce, seed, dim: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independent uniforms in [0,1) per (pixel, sample, bounce, dim).
    ``pixel`` is a tensor; the others broadcast against it."""
    dim_mix = (int(dim) * 0x632BE59B) & _MASK
    pixel = _u32(pixel)
    z = torch.zeros_like(pixel)
    sample = _u32(sample, pixel) + z
    seed = _u32(seed, pixel) + z
    base = hash3(pixel, (sample + dim_mix) & _MASK,
                 (_u32(bounce, pixel) + z) ^ pcg(seed))
    return u01(base), u01(pcg(base ^ _GOLD))


def stratified_jitter(pixel, sample, total_spp: int, seed
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sub-pixel (jx, jy) in [0,1)^2: sample s lands in cell s of a
    ceil(sqrt(total_spp))^2 stratum grid, jittered inside the cell.
    total_spp == 1 returns exact pixel centers."""
    pixel = _u32(pixel)
    if total_spp == 1:
        half = torch.full(pixel.shape, 0.5, dtype=torch.float32,
                          device=pixel.device)
        return half, half.clone()
    g = int(math.ceil(math.sqrt(total_spp)))
    s = (_u32(sample, pixel) + torch.zeros_like(pixel)) % total_spp
    cx = (s % g).to(torch.float32)
    cy = (s // g).to(torch.float32)
    u, v = sample2(pixel, sample, 0, seed, dim=7)
    inv_g = 1.0 / g
    return (cx + u) * inv_g, (cy + v) * inv_g


def cosine_hemisphere(nx, ny, nz, u1, u2
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cosine-weighted direction about the (unit) normal.

    Branch-free Frisvad-style orthonormal basis; returns (dx, dy, dz).
    pdf = cos(theta)/pi, so Lambertian throughput weight is exactly the
    albedo (BRDF * cos / pdf = albedo).  The JAX function's order of
    operations, in float32; sin and cos are the device's (they differ
    from XLA's in the last bits)."""
    # ONB (handles nz ~ -1 via the sign trick)
    sign = torch.where(nz >= 0.0, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t1x = 1.0 + sign * nx * nx * a
    t1y = sign * b
    t1z = -sign * nx
    t2x = b
    t2y = sign + ny * ny * a
    t2z = -ny
    r = torch.sqrt(u1)
    # float32(2 pi), as the JAX package rounds it
    phi = 6.2831854820251465 * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    return (x * t1x + y * t2x + z * nx,
            x * t1y + y * t2y + z * ny,
            x * t1z + y * t2z + z * nz)
