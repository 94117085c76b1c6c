"""The plain reference the benchmark holds the program's frames to.

Plain PyTorch, on whatever device it is given, in the precision it is
given: it imports nothing of the program.  It renders chosen pixels of a
frame from the meshes, camera, light and seed the benchmark hands both
sides, with the frame's semantics as the program's wavefront engine
defines them (``frame_body``: ``spp`` passes, one sample a pixel a pass,
the pass's sample index ``seed * spp + pass``):

- camera rays through the stratified jitter of the counter-based sampler;
- closest hits by brute force over every triangle (Moller-Trumbore with
  the reference renderer's conventions: EPSILON 1e-6, ``|a| < eps``
  rejects, ``w1`` in [0, 1], ``w1 + w2 <= 1``, ``t > eps``; ties go to
  the lower triangle id), a stronger oracle than any tree walk;
- shadow rays from the hit point to the light: occluded where a hit lies
  closer than 0.999 of the light's distance;
- Whitted shading (attenuated N.L, ambient unshadowed, mirror bounces)
  or path tracing (next-event light gated by the shadow ray, ambient at
  the first hit, cosine-weighted diffuse bounces, Russian roulette from
  the second bounce), point-sampled textures.

It returns each pixel's radiance and the rays it traced (a closest-hit
ray for every live lane of every bounce, a shadow ray for every hit), so
a frame's ray count can be checked against the pixels' mean.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from rtbench.reference import sampler

LARGE = 1e30
EPS = 1e-6


@dataclasses.dataclass
class Tables:
    """The triangle soup and its per-triangle shading, on one device in
    one float type (``dtype``)."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor
    uv1: torch.Tensor
    uv2: torch.Tensor
    diffuse: torch.Tensor      # (T, 3)
    tex_off: torch.Tensor      # (T,) int64, -1 = untextured
    tex_w: torch.Tensor        # (T,) int64
    tex_h: torch.Tensor
    texels: torch.Tensor       # (X,) int64 0xRRGGBB
    refl: torch.Tensor         # (T,)

    @staticmethod
    def from_meshes(meshes, device, dtype=torch.float32,
                    verts: Optional[Sequence[torch.Tensor]] = None
                    ) -> "Tables":
        """Concatenate ``meshes`` (``rtbench.scenes.Mesh``) in order;
        ``verts`` replaces their (T, 3) positions (a moved frame's), the
        normals and uvs staying the meshes'."""
        def cat(name, shape):
            a = np.concatenate([getattr(m, name).reshape(-1, shape)
                                for m in meshes])
            return torch.from_numpy(np.ascontiguousarray(a, np.float32))

        counts = [m.num_tris for m in meshes]
        if verts is None:
            verts = [cat(k, 3) for k in ("v0", "v1", "v2")]
        v0, v1, v2 = (v.to(device=device, dtype=torch.float32) for v in verts)
        # the edges in float32, as the program's tables and the reference
        # renderer store them; then everything in the given precision
        e1, e2 = v1 - v0, v2 - v0
        off, texels, toff, tw, th = 0, [], [], [], []
        for m in meshes:
            if m.tex is None:
                toff.append(-1), tw.append(0), th.append(0)
            else:
                h, w = m.tex.shape
                toff.append(off), tw.append(w), th.append(h)
                texels.append(np.asarray(m.tex, np.int64).ravel())
                off += w * h

        def per_tri(vals, dt):
            return torch.repeat_interleave(
                torch.tensor(vals, dtype=dt), torch.tensor(counts)).to(device)

        def f(x):
            return x.to(device=device, dtype=dtype)

        return Tables(
            v0=f(v0), e1=f(e1), e2=f(e2),
            n0=f(cat("n0", 3)), n1=f(cat("n1", 3)), n2=f(cat("n2", 3)),
            uv0=f(cat("uv0", 2)), uv1=f(cat("uv1", 2)), uv2=f(cat("uv2", 2)),
            diffuse=f(torch.repeat_interleave(
                torch.tensor([list(m.diffuse) for m in meshes],
                             dtype=torch.float32), torch.tensor(counts), 0)),
            tex_off=per_tri(toff, torch.int64),
            tex_w=per_tri(tw, torch.int64), tex_h=per_tri(th, torch.int64),
            texels=torch.from_numpy(np.concatenate(texels) if texels
                                    else np.zeros(1, np.int64)).to(device),
            refl=f(per_tri([m.reflectivity for m in meshes], torch.float32)))

    @property
    def dtype(self):
        return self.v0.dtype


@dataclasses.dataclass(frozen=True)
class Light:
    pos: Tuple[float, float, float] = (0.0, 100.0, 0.0)
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    ambient: Tuple[float, float, float] = (0.2, 0.2, 0.2)
    background: Tuple[float, float, float] = (0.2, 0.3, 0.5)


def closest_hits(tb: Tables, o: torch.Tensor, d: torch.Tensor,
                 ray_chunk: int = 4096, tri_chunk: int = 8192):
    """Brute-force closest hits of (R, 3) rays: (dist, w1, w2, tri), dist
    ``LARGE`` where nothing is hit."""
    r = o.shape[0]
    dt = tb.dtype
    dev = o.device
    dist = torch.full((r,), LARGE, dtype=dt, device=dev)
    bw1 = torch.zeros(r, dtype=dt, device=dev)
    bw2 = torch.zeros_like(bw1)
    btri = torch.zeros(r, dtype=torch.int64, device=dev)
    n = tb.v0.shape[0]
    for r0 in range(0, r, ray_chunk):
        rs = slice(r0, min(r0 + ray_chunk, r))
        ox, oy, oz = (o[rs, k, None] for k in range(3))
        dx, dy, dz = (d[rs, k, None] for k in range(3))
        best = dist[rs].clone()
        w1b, w2b, tb_ = bw1[rs].clone(), bw2[rs].clone(), btri[rs].clone()
        for c0 in range(0, n, tri_chunk):
            cs = slice(c0, min(c0 + tri_chunk, n))
            ax, ay, az = (tb.e1[cs, k][None] for k in range(3))
            bx, by, bz = (tb.e2[cs, k][None] for k in range(3))
            # h = d x e2; a = e1 . h
            hx = dy * bz - dz * by
            hy = dz * bx - dx * bz
            hz = dx * by - dy * bx
            a = ax * hx + ay * hy + az * hz
            small = torch.abs(a) < EPS
            f = 1.0 / torch.where(small, torch.ones_like(a), a)
            sx = ox - tb.v0[cs, 0][None]
            sy = oy - tb.v0[cs, 1][None]
            sz = oz - tb.v0[cs, 2][None]
            w1 = f * (sx * hx + sy * hy + sz * hz)
            del hx, hy, hz
            # q = s x e1
            qx = sy * az - sz * ay
            qy = sz * ax - sx * az
            qz = sx * ay - sy * ax
            del sx, sy, sz
            w2 = f * (dx * qx + dy * qy + dz * qz)
            t = f * (bx * qx + by * qy + bz * qz)
            del qx, qy, qz, f
            ok = (~small & (w1 >= 0.0) & (w1 <= 1.0) & (w2 >= 0.0)
                  & (w1 + w2 <= 1.0) & (t > EPS))
            t = torch.where(ok, t, torch.full_like(t, LARGE))
            tmin, k = t.min(1)
            upd = tmin < best
            best = torch.where(upd, tmin, best)
            w1b = torch.where(upd, w1.gather(1, k[:, None])[:, 0], w1b)
            w2b = torch.where(upd, w2.gather(1, k[:, None])[:, 0], w2b)
            tb_ = torch.where(upd, k + c0, tb_)
            del t, w1, w2, ok
        dist[rs], bw1[rs], bw2[rs], btri[rs] = best, w1b, w2b, tb_
    return dist, bw1, bw2, btri


def _trace(tb: Tables, o, d, live, **kw):
    """Closest hits of the live rays; the others miss."""
    dt = tb.dtype
    r = o.shape[0]
    dist = torch.full((r,), LARGE, dtype=dt, device=o.device)
    w1 = torch.zeros(r, dtype=dt, device=o.device)
    w2 = torch.zeros_like(w1)
    tri = torch.zeros(r, dtype=torch.int64, device=o.device)
    idx = torch.nonzero(live).squeeze(1)
    if idx.numel():
        hd, h1, h2, ht = closest_hits(tb, o[idx], d[idx], **kw)
        dist[idx], w1[idx], w2[idx], tri[idx] = hd, h1, h2, ht
    return dist, w1, w2, tri


def _normalize(x, y, z):
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z + 1e-20)
    return x * inv, y * inv, z * inv


def _shade(tb: Tables, o, d, dist, w1, w2, tri):
    """Hit point, shading normal, surface colour and reflectivity."""
    t = torch.clamp_max(dist, 1e18)
    p = o + d * t[:, None]
    bz = 1.0 - w1 - w2
    n = tb.n1[tri] * w1[:, None] + tb.n2[tri] * w2[:, None] \
        + tb.n0[tri] * bz[:, None]
    nx, ny, nz = _normalize(n[:, 0], n[:, 1], n[:, 2])
    uv = tb.uv1[tri] * w1[:, None] + tb.uv2[tri] * w2[:, None] \
        + tb.uv0[tri] * bz[:, None]
    off, tw, th = tb.tex_off[tri], tb.tex_w[tri].clamp_min(1), \
        tb.tex_h[tri].clamp_min(1)
    iu = torch.floor(uv[:, 0] * tw.to(tb.dtype)).to(torch.int64) % tw
    iv = torch.floor(uv[:, 1] * th.to(tb.dtype)).to(torch.int64) % th
    has = off >= 0
    idx = torch.where(has, off + iu + iv * tw, torch.zeros_like(off))
    texel = tb.texels[idx.clamp(0, tb.texels.shape[0] - 1)]
    rgb = torch.stack([((texel >> s) & 255).to(tb.dtype) * (1.0 / 256.0)
                       for s in (16, 8, 0)], 1)
    color = torch.where(has[:, None], rgb, tb.diffuse[tri])
    return p, torch.stack([nx, ny, nz], 1), color, tb.refl[tri]


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def render_pixels(tb: Tables, cam, light: Light, width: int, height: int,
                  seed: int, spp: int, max_depth: int, pixels: np.ndarray,
                  shadow: bool = True, pathtrace: bool = False,
                  **chunks) -> Tuple[np.ndarray, np.ndarray]:
    """The frame of ``seed`` at ``pixels`` (K,) row-major pixel ids ->
    ((K, 3) float32 radiance, (K,) rays traced for each pixel).  ``cam``
    is ``rtbench.reference.camera.Cam``."""
    dev, dt = tb.v0.device, tb.dtype
    k = len(pixels)
    pix = torch.as_tensor(np.asarray(pixels, np.int64), device=dev)
    pix = pix.repeat_interleave(spp)                    # lane: pixel, pass
    p_idx = torch.arange(spp, device=dev).repeat(k)
    samp = (((int(seed) & sampler.MASK) * spp) + p_idx) & sampler.MASK
    r = pix.shape[0]

    def vec(v):
        return torch.tensor(np.asarray(v, np.float32), device=dev).to(dt)

    # camera rays (float32 jitter, then the given precision)
    jx, jy = sampler.stratified_jitter(pix, samp, spp)
    px = (pix % width).to(torch.float32)
    py = (pix // width).to(torch.float32)
    x_ndc = ((px + jx) / torch.tensor(float(width), device=dev)
             - 0.5).to(dt)
    y_ndc = ((py + jy) / torch.tensor(float(height), device=dev)
             - 0.5).to(dt)
    vp, right, up, fwd = vec(cam.viewplane), vec(cam.right), vec(cam.up), \
        vec(cam.forward)
    vx, vy = x_ndc * vp[0], y_ndc * vp[1]
    dx, dy, dz = (vx * right[i] + vy * up[i] + fwd[i] for i in range(3))
    d = torch.stack(_normalize(dx, dy, dz), 1)
    o = vec(cam.pos)[None].expand(r, 3).clone()

    lpos, lcol, amb, bg = (vec(x) for x in (light.pos, light.color,
                                            light.ambient, light.background))
    zero = torch.zeros(r, dtype=dt, device=dev)
    rad = torch.zeros(r, 3, dtype=dt, device=dev)
    thr = torch.ones(r, 3, dtype=dt, device=dev)
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    bounce = torch.zeros(r, dtype=torch.int64, device=dev)
    rays = torch.zeros(r, dtype=torch.int64, device=dev)
    for _ in range(max_depth):
        rays += alive
        dist, w1, w2, tri = _trace(tb, o, d, alive, **chunks)
        hit = alive & (dist < LARGE)
        miss = alive & ~hit
        p, n, color, refl = _shade(tb, o, d, dist, w1, w2, tri)
        lit = torch.ones(r, dtype=dt, device=dev)
        if shadow:
            rays += hit
            sl = lpos[None] - p
            dl = torch.sqrt(_dot(sl, sl) + 1e-20)
            sd = sl / dl[:, None]
            clamp = dl * (1.0 - 1e-3)
            sh, _, _, _ = _trace(tb, p + sd * 1e-3, sd, hit, **chunks)
            lit = torch.where(hit & (sh < clamp), zero, lit)
        # attenuated N.L, gated by the shadow ray
        lv = lpos[None] - p
        ld = torch.sqrt(_dot(lv, lv) + 1e-20)
        ndotl = torch.clamp_min(_dot(n, lv) * (1.0 / ld), 0.0)
        f = (1.0 / (1.0 + ld * 0.1)) * ndotl * lit
        mirror = refl > 0.0
        nd = _dot(n, d)
        rdir = torch.stack(_normalize(*(d[:, i] - 2.0 * nd * n[:, i]
                                        for i in range(3))), 1)
        if pathtrace:
            first = (bounce == 0).to(dt)
            add = color * (lcol[None] * f[:, None]) \
                + first[:, None] * amb[None] * color
            u1, u2 = sampler.sample2(pix, samp, bounce, 0, dim=1)
            hemi = _hemisphere(n, u1.to(dt), u2.to(dt))
            ndir = torch.where(mirror[:, None], rdir, hemi)
            mul = torch.where(mirror[:, None], refl[:, None].expand(r, 3),
                              color)
            u3, _ = sampler.sample2(pix, samp, bounce, 0, dim=2)
            p_srv = torch.clamp(mul.max(1).values, 0.1, 0.95)
            rr = bounce >= 1
            survive = ~rr | (u3.to(dt) < p_srv)
            mul = mul * torch.where(rr, 1.0 / p_srv,
                                    torch.ones_like(p_srv))[:, None]
            spawn = hit & (bounce + 1 < max_depth) & survive
            add = (1.0 - refl)[:, None] * add
        else:
            add = color * (amb[None] + lcol[None] * f[:, None])
            spawn = hit & mirror & (bounce + 1 < max_depth)
            keep_bg = torch.where(spawn, zero, refl)
            add = (1.0 - refl)[:, None] * add + keep_bg[:, None] * bg[None]
            mul = refl[:, None].expand(r, 3)
            ndir = rdir
        rad = rad + torch.where(hit[:, None], thr * add,
                                torch.where(miss[:, None], thr * bg[None],
                                            torch.zeros_like(rad)))
        thr = torch.where(hit[:, None], thr * mul, thr)
        o = torch.where(spawn[:, None], p + ndir * 1e-3, o)
        d = torch.where(spawn[:, None], ndir, d)
        bounce = torch.where(spawn, bounce + 1, bounce)
        alive = spawn
    img = (rad.float().reshape(k, spp, 3).sum(1) * (1.0 / spp))
    return (img.cpu().numpy().astype(np.float32),
            rays.reshape(k, spp).sum(1).cpu().numpy())


def _hemisphere(n, u1, u2):
    """Cosine-weighted directions about unit normals (Frisvad's basis)."""
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    sign = torch.where(nz >= 0.0, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t1 = (1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    t2 = (b, sign + ny * ny * a, -ny)
    rr = torch.sqrt(u1)
    phi = 6.2831854820251465 * u2
    x, y = rr * torch.cos(phi), rr * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    return torch.stack([x * t1[i] + y * t2[i] + z * n[:, i]
                        for i in range(3)], 1)


def frame_pixels(meshes, cam, light: Light, traffic: dict, seed: int,
                 pixels: np.ndarray, device, dtype=torch.float32,
                 verts: Optional[List[torch.Tensor]] = None, **chunks):
    """``render_pixels`` of one frame of a traffic mix (its ``width``,
    ``height``, ``spp``, ``depth``, ``shadow``, ``pathtrace``)."""
    tb = Tables.from_meshes(meshes, device, dtype, verts)
    return render_pixels(tb, cam, light, traffic["width"], traffic["height"],
                         seed, traffic["spp"], traffic["depth"], pixels,
                         shadow=traffic["shadow"],
                         pathtrace=traffic["pathtrace"], **chunks)
