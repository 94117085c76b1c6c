"""Lane-form shading: packed shade tables + the reference's shader bodies
(port of ``vortex_rt_tpu/ops/shade_lanes.py``).

Everything is (R,) component lanes; per-ray data is packed into 16-float
rows so one shaded ray costs three row gathers (triangle attributes,
material, instance) plus texel gathers:

* ``shade_rows``   (T, 16): n0, n1, n2 (9) + uv0, uv1, uv2 (6) + mat(bits)
* ``mat_rows``     (M, 16): diffuse rgb, tex_offset(bits), tex_w(bits),
  tex_h(bits), ambient rgb, specular rgb, emissive rgb, shininess
* ``inst_shade``   (I, 16): inverse-transpose 3x3 (9) + reflectivity

Integer fields are bit-cast into the float rows and read back through
``.view(torch.int32)``.  The arithmetic order matches the JAX functions
so both give the same floats.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from vortex_rt_tpu_torch.models.scene import SceneBuffers


def _bits_f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.astype(np.int32)).view(np.float32)


@dataclasses.dataclass
class ShadeArrays:
    """Shading tables."""

    shade_rows: torch.Tensor  # (T, 16) f32, global triangle id order
    mat_rows: torch.Tensor    # (M, 16) f32
    inst_shade: torch.Tensor  # (I, 16) f32
    texels: torch.Tensor      # (X,) i32 0xRRGGBB pool

    def to(self, device) -> "ShadeArrays":
        return ShadeArrays(*(getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)))

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f.name).numel()
                   * getattr(self, f.name).element_size()
                   for f in dataclasses.fields(self))

    @staticmethod
    def from_scene(sb: SceneBuffers) -> "ShadeArrays":
        """Build the tables on the CPU (move them with ``.to(device)``)."""
        t = sb.v0.shape[0]
        rows = np.zeros((t, 16), np.float32)
        rows[:, 0:3] = sb.n0
        rows[:, 3:6] = sb.n1
        rows[:, 6:9] = sb.n2
        rows[:, 9:11] = sb.uv0
        rows[:, 11:13] = sb.uv1
        rows[:, 13:15] = sb.uv2
        rows[:, 15] = _bits_f32(sb.mat_id)

        m = sb.mat_diffuse.shape[0]
        mat = np.zeros((m, 16), np.float32)
        mat[:, 0:3] = sb.mat_diffuse
        mat[:, 3] = _bits_f32(sb.mat_tex_offset)
        mat[:, 4] = _bits_f32(sb.mat_tex_w)
        mat[:, 5] = _bits_f32(sb.mat_tex_h)
        mat[:, 6:9] = sb.mat_ambient
        mat[:, 9:12] = sb.mat_specular
        mat[:, 12:15] = sb.mat_emissive
        mat[:, 15] = sb.mat_shininess

        i = sb.inst_inv_transpose.shape[0]
        ins = np.zeros((i, 16), np.float32)
        ins[:, 0:9] = sb.inst_inv_transpose[:, :3, :3].reshape(i, 9)
        ins[:, 9] = sb.inst_reflectivity

        return ShadeArrays(
            shade_rows=torch.from_numpy(rows),
            mat_rows=torch.from_numpy(mat),
            inst_shade=torch.from_numpy(ins),
            texels=torch.from_numpy(
                np.ascontiguousarray(sb.texels.astype(np.uint32))
                .view(np.int32)),
        )


def _normalize(x, y, z, eps=1e-20):
    # exact sqrt and division (an approximate rsqrt would cost parity)
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z + eps)
    return x * inv, y * inv, z * inv


class ShadePoint(NamedTuple):
    """Everything the closest-hit shader can read at a hit."""

    px: torch.Tensor; py: torch.Tensor; pz: torch.Tensor   # hit point
    nx: torch.Tensor; ny: torch.Tensor; nz: torch.Tensor   # shading normal
    u: torch.Tensor; v: torch.Tensor                       # interpolated uv
    color_r: torch.Tensor; color_g: torch.Tensor; color_b: torch.Tensor
    reflectivity: torch.Tensor
    mat: torch.Tensor
    tri: torch.Tensor
    inst: torch.Tensor
    lit: torch.Tensor  # 1.0 = light visible, 0.0 = shadowed (shadow rays)


def _tex_fetch(sa: ShadeArrays, idx):
    """(R,) texel-pool index -> RGB f32 lanes."""
    texel = sa.texels[idx.clamp(0, sa.texels.shape[0] - 1)]
    s = 1.0 / 256.0
    return (((texel >> 16) & 255).to(torch.float32) * s,
            ((texel >> 8) & 255).to(torch.float32) * s,
            (texel & 255).to(torch.float32) * s)


def shade_point(sa: ShadeArrays,
                ox, oy, oz, dx, dy, dz,
                dist, bx, by, bz, tri, inst,
                bilinear: bool = False) -> ShadePoint:
    """Fetch + interpolate everything at a hit.

    ``bilinear=True`` switches the texel fetch from point sampling to the
    reference's bilinear filter (floor first, wrap each of the four taps
    independently)."""
    t = torch.clamp_max(dist, 1e18)
    px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t

    row = sa.shade_rows[tri]
    # N = N1*bx + N2*by + N0*bz
    nx = row[:, 3] * bx + row[:, 6] * by + row[:, 0] * bz
    ny = row[:, 4] * bx + row[:, 7] * by + row[:, 1] * bz
    nz = row[:, 5] * bx + row[:, 8] * by + row[:, 2] * bz
    irow = sa.inst_shade[inst]
    # normals transform by the instance's inverse-transpose
    tnx = irow[:, 0] * nx + irow[:, 1] * ny + irow[:, 2] * nz
    tny = irow[:, 3] * nx + irow[:, 4] * ny + irow[:, 5] * nz
    tnz = irow[:, 6] * nx + irow[:, 7] * ny + irow[:, 8] * nz
    nx, ny, nz = _normalize(tnx, tny, tnz)

    # uv = uv1*bx + uv2*by + uv0*bz
    u = row[:, 11] * bx + row[:, 13] * by + row[:, 9] * bz
    v = row[:, 12] * bx + row[:, 14] * by + row[:, 10] * bz

    mat = row.view(torch.int32)[:, 15]
    mrow = sa.mat_rows[mat]
    mrow_i = mrow.view(torch.int32)
    toff = mrow_i[:, 3]
    tw = mrow_i[:, 4].clamp_min(1)
    th = mrow_i[:, 5].clamp_min(1)
    has_tex = toff >= 0
    zero = torch.zeros_like(toff)
    if not bilinear:
        iu = torch.floor(u * tw).to(torch.int32) % tw
        iv = torch.floor(v * th).to(torch.int32) % th
        tex_idx = torch.where(has_tex, toff + iu + iv * tw, zero)
        tr, tg, tb = _tex_fetch(sa, tex_idx)
    else:
        uu = u * tw
        vv = v * th
        x0 = torch.floor(uu)
        y0 = torch.floor(vv)
        fu = uu - x0
        fv = vv - y0
        x0i = x0.to(torch.int32) % tw
        y0i = y0.to(torch.int32) % th
        x1i = (x0.to(torch.int32) + 1) % tw
        y1i = (y0.to(torch.int32) + 1) % th

        def tap(xi, yi):
            return _tex_fetch(sa, torch.where(has_tex, toff + xi + yi * tw,
                                              zero))

        c00 = tap(x0i, y0i)
        c10 = tap(x1i, y0i)
        c01 = tap(x0i, y1i)
        c11 = tap(x1i, y1i)
        tr, tg, tb = (
            (c00[k] * (1 - fu) + c10[k] * fu) * (1 - fv)
            + (c01[k] * (1 - fu) + c11[k] * fu) * fv
            for k in range(3))
    cr = torch.where(has_tex, tr, mrow[:, 0])
    cg = torch.where(has_tex, tg, mrow[:, 1])
    cb = torch.where(has_tex, tb, mrow[:, 2])

    return ShadePoint(px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz, u=u, v=v,
                      color_r=cr, color_g=cg, color_b=cb,
                      reflectivity=irow[:, 9], mat=mat, tri=tri, inst=inst,
                      lit=torch.ones_like(px))


def diffuse_lighting_lanes(sp: ShadePoint, light_pos, light_color, ambient):
    """Diffuse lighting on lanes: att = 1/(1 + 0.1*dist).  ``sp.lit``
    gates the direct term (shadow rays); ambient is unshadowed."""
    lx = light_pos[0] - sp.px
    ly = light_pos[1] - sp.py
    lz = light_pos[2] - sp.pz
    dist = torch.sqrt(lx * lx + ly * ly + lz * lz + 1e-20)
    inv = 1.0 / dist
    ndotl = torch.clamp_min((sp.nx * lx + sp.ny * ly + sp.nz * lz) * inv, 0.0)
    att = 1.0 / (1.0 + dist * 0.1)
    f = att * ndotl * sp.lit
    return (sp.color_r * (ambient[0] + light_color[0] * f),
            sp.color_g * (ambient[1] + light_color[1] * f),
            sp.color_b * (ambient[2] + light_color[2] * f))


def reflect_lanes(dx, dy, dz, nx, ny, nz):
    """R = normalize(d - 2 n (n.d))."""
    nd = nx * dx + ny * dy + nz * dz
    rx = dx - 2.0 * nd * nx
    ry = dy - 2.0 * nd * ny
    rz = dz - 2.0 * nd * nz
    return _normalize(rx, ry, rz)
