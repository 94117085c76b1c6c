"""The closest-hit shader body over a batch of hits (port of
``vortex_rt_tpu/ops/shade.py``), as plain torch functions:

* normal and uv interpolation, and the inverse-transpose normal transform;
* a point-sampled, wrap-addressed texel fetch from one texel pool;
* attenuated diffuse lighting (att = 1 / (1 + 0.1 dist), N.L clamped);
* the reflectivity split: the caller adds T * (1 - r) * diffuse and
  carries T * r into the bounce.

It reads the scene's arrays as device tensors (``SceneTensors``); the
wavefront engine's row-packed tables (``ops/shade_lanes.py``) are another
layout.  The arithmetic keeps the JAX functions' order (every 3-term dot
product through ``ops/intersect.dot``), so both give the same floats where
neither compiler contracts a product into an FMA.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vortex_rt_tpu_torch.models.scene import SceneBuffers
from vortex_rt_tpu_torch.ops.intersect import dot, sqrt_rn


class SceneTensors(NamedTuple):
    """The arrays of ``SceneBuffers`` that shading reads, on a device."""

    n0: torch.Tensor; n1: torch.Tensor; n2: torch.Tensor     # (T, 3) f32
    uv0: torch.Tensor; uv1: torch.Tensor; uv2: torch.Tensor  # (T, 2) f32
    mat_id: torch.Tensor             # (T,) i32
    mat_diffuse: torch.Tensor        # (M, 3) f32
    mat_tex_offset: torch.Tensor     # (M,) i32, -1 = no texture
    mat_tex_w: torch.Tensor          # (M,) i32
    mat_tex_h: torch.Tensor          # (M,) i32
    texels: torch.Tensor             # (X,) i32 0xRRGGBB (u32 bits)
    inst_inv_transpose: torch.Tensor  # (I, 4, 4) f32
    inst_reflectivity: torch.Tensor  # (I,) f32

    @staticmethod
    def from_scene(sb: SceneBuffers, device) -> "SceneTensors":
        def t(name):
            a = np.ascontiguousarray(getattr(sb, name))
            if a.dtype.kind in "ui":
                a = a.astype(np.uint32 if a.dtype.kind == "u" else np.int32)
                a = a.view(np.int32)
            return torch.from_numpy(a.copy()).to(device)

        return SceneTensors(*(t(f) for f in SceneTensors._fields))

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self)


class ShadeResult(NamedTuple):
    diffuse: torch.Tensor       # (R, 3) local diffuse contribution
    reflectivity: torch.Tensor  # (R,) instance reflectivity
    new_o: torch.Tensor         # (R, 3) bounce ray origin
    new_d: torch.Tensor         # (R, 3) bounce ray direction
    normal: torch.Tensor        # (R, 3) shading normal


def _normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v * (1.0 / sqrt_rn(dot(v, v) + eps)).unsqueeze(-1)


def rgb8_to_rgb32f(texel: torch.Tensor) -> torch.Tensor:
    """0xRRGGBB words -> float3 with the reference's 1/256 scale."""
    t = texel.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([((t >> 16) & 255).to(torch.float32),
                        ((t >> 8) & 255).to(torch.float32),
                        (t & 255).to(torch.float32)], dim=-1) * (1.0 / 256.0)


def tex_sample(uv, mat, texels, tex_offset, tex_w, tex_h, mat_diffuse):
    """Point sample with wrap addressing (floored modulo, as ``jnp``'s
    ``%``: ROADMAP H10); a material without a texture gives its diffuse
    colour."""
    mat = mat.to(torch.int64)
    w = tex_w[mat]
    h = tex_h[mat]
    off = tex_offset[mat]
    has = off >= 0
    ws = w.clamp_min(1)
    hs = h.clamp_min(1)
    iu = torch.floor(uv[..., 0] * ws).to(torch.int32) % ws
    iv = torch.floor(uv[..., 1] * hs).to(torch.int32) % hs
    idx = torch.where(has, off + iu + iv * ws, 0).to(torch.int64)
    color = rgb8_to_rgb32f(texels[idx])
    return torch.where(has.unsqueeze(-1), color, mat_diffuse[mat])


def diffuse_lighting(p, n, diffuse_color, ambient, light_color, light_pos):
    """att = 1 / (1 + 0.1 dist), N.L clamped at 0."""
    l = light_pos - p
    dist = sqrt_rn(dot(l, l) + 1e-20)
    l = l / dist.unsqueeze(-1)
    att = 1.0 / (1.0 + dist * 0.1)
    ndotl = torch.clamp_min(dot(n, l), 0.0)
    return diffuse_color * (ambient + att.unsqueeze(-1) * light_color
                            * ndotl.unsqueeze(-1))


def closest_hit_shade(st: SceneTensors, o, d, dist, bx, by, bz, tri, inst,
                      ambient, light_color, light_pos) -> ShadeResult:
    """The closest-hit shader body over a batch.  Lanes that missed give
    values the caller masks out (``dist`` should be clamped to something
    finite first)."""
    tri = tri.to(torch.int64)
    inst = inst.to(torch.int64)
    bx, by, bz = bx.unsqueeze(-1), by.unsqueeze(-1), bz.unsqueeze(-1)
    p = o + d * dist.unsqueeze(-1)
    n = st.n1[tri] * bx + st.n2[tri] * by + st.n0[tri] * bz
    rot = st.inst_inv_transpose[inst][..., :3, :3]
    n = _normalize(dot(rot, n.unsqueeze(-2)))
    uv = st.uv1[tri] * bx + st.uv2[tri] * by + st.uv0[tri] * bz
    mat = st.mat_id[tri]
    color = tex_sample(uv, mat, st.texels, st.mat_tex_offset, st.mat_tex_w,
                       st.mat_tex_h, st.mat_diffuse)
    diffuse = diffuse_lighting(p, n, color, ambient, light_color, light_pos)
    refl = st.inst_reflectivity[inst]
    r = _normalize(d - (2.0 * dot(n, d)).unsqueeze(-1) * n)
    return ShadeResult(diffuse=diffuse, reflectivity=refl, new_o=p + r * 1e-3,
                       new_d=r, normal=n)
