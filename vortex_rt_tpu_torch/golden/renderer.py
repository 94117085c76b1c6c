"""Golden CPU renderer (NumPy), the fidelity oracle (port of
``vortex_rt_tpu/golden/renderer.py``; host-only, NumPy, unchanged in
arithmetic).

It reproduces, vectorized over all rays at once:

* the GenerateRay pixel -> viewplane -> world mapping;
* closest-hit search by brute force over every (instance, triangle) pair,
  a stronger oracle than any BVH walk: a disagreement is a traversal bug;
* Moller-Trumbore with the reference's conventions (EPSILON = 1e-6,
  |a| < eps reject, w1 in [0, 1], w1 + w2 <= 1, t > eps; bx = w1,
  by = w2, bz = 1 - w1 - w2);
* the Trace() bounce loop with diffuse lighting, point-sampled textures
  and reflectivity bounces (``render_golden``), and the replay of the path
  tracer's light paths (``render_golden_pt``).

The counter-based streams come from the port's ``utils/sampling.py`` (its
integer hash, bit for bit the JAX package's on CPU tensors); the cosine
lobe is computed here in NumPy, as the JAX module does it, because the
port's sampler takes sin and cos from torch.
"""

from __future__ import annotations

import numpy as np
import torch

from vortex_rt_tpu_torch.models.scene import (
    Camera, RenderParams, SceneBuffers,
)
from vortex_rt_tpu_torch.utils import sampling
from vortex_rt_tpu_torch.utils import vecmath as vm
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT, MT_EPSILON


def _u32_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _stratified_jitter(pixels, samp, total_spp: int, seed: int):
    jx, jy = sampling.stratified_jitter(_u32_tensor(pixels),
                                        _u32_tensor(samp), total_spp, seed)
    return jx.numpy(), jy.numpy()


def _sample2(pixels, samp, bounce, seed: int, dim: int):
    u1, u2 = sampling.sample2(_u32_tensor(pixels), _u32_tensor(samp),
                              _u32_tensor(bounce), seed, dim=dim)
    return u1.numpy(), u2.numpy()


def _cosine_hemisphere(nx, ny, nz, u1, u2):
    """Cosine-weighted direction about the (unit) normal, in NumPy
    float32 (the JAX ``sampling.cosine_hemisphere`` with ``xp=np``)."""
    sign = np.where(nz >= 0.0, np.float32(1.0), np.float32(-1.0))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t1x = 1.0 + sign * nx * nx * a
    t1y = sign * b
    t1z = -sign * nx
    t2x = b
    t2y = sign + ny * ny * a
    t2z = -ny
    two_pi = np.float32(2.0 * np.pi)
    r = np.sqrt(u1)
    phi = two_pi * u2
    x = r * np.cos(phi)
    y = r * np.sin(phi)
    z = np.sqrt(np.maximum(np.float32(0.0), 1.0 - u1))
    return (x * t1x + y * t2x + z * nx,
            x * t1y + y * t2y + z * ny,
            x * t1z + y * t2z + z * nz)


def moller_trumbore_np(o, d, v0, v1, v2, eps: float = MT_EPSILON):
    """Vectorized MT over broadcastable ray (..., 3) x tri (..., 3) arrays.

    Returns (t, w1, w2) with t = LARGE_FLOAT where there is no hit.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    h = vm.cross(d, e2)
    a = vm.dot(e1, h)
    f = 1.0 / np.where(np.abs(a) < eps, 1.0, a)  # guarded reciprocal
    s = o - v0
    w1 = f * vm.dot(s, h)
    q = vm.cross(s, e1)
    w2 = f * vm.dot(d, q)
    t = f * vm.dot(e2, q)
    ok = (
        (np.abs(a) >= eps)
        & (w1 >= 0.0) & (w1 <= 1.0)
        & (w2 >= 0.0) & (w1 + w2 <= 1.0)
        & (t > eps)
    )
    return np.where(ok, t, LARGE_FLOAT), w1, w2


def brute_force_hits(o: np.ndarray, d: np.ndarray, sb: SceneBuffers,
                     chunk: int = 4096):
    """Closest hit per ray over every instance x triangle.

    o, d: (R, 3).  Returns dict of (R,) arrays:
    dist, bx, by, bz, tri (global id), inst.  Matches ray_hit_t fields
    (common.h:48-54).  Ties break toward the earlier (instance, triangle),
    matching the strict '<' update in the reference traversal.
    """
    r = o.shape[0]
    best_t = np.full(r, LARGE_FLOAT, np.float32)
    best = {
        "bx": np.zeros(r, np.float32), "by": np.zeros(r, np.float32),
        "tri": np.zeros(r, np.int32), "inst": np.zeros(r, np.int32),
    }
    for inst in range(sb.num_instances):
        inv = sb.inst_inv_transform[inst]
        lo = vm.transform_point(inv, o)  # (R, 3) local-space origin
        ld = vm.transform_vector(inv, d)  # unnormalized: preserves t parameter
        if getattr(sb, "flat", False):
            # flattened build: every inst_bvh_root is the shared tree;
            # the instance's triangles come from the tri_inst map
            tri_ids = np.nonzero(sb.tri_inst == inst)[0]
        else:
            root = int(sb.inst_bvh_root[inst])
            tri_ids = np.sort(_tris_under(sb, root))
        for s in range(0, tri_ids.size, chunk):
            ids = tri_ids[s : s + chunk]
            t, w1, w2 = moller_trumbore_np(
                lo[:, None, :], ld[:, None, :],
                sb.v0[ids][None], sb.v1[ids][None], sb.v2[ids][None],
            )
            k = np.argmin(t, axis=1)
            tk = t[np.arange(r), k]
            upd = tk < best_t
            best_t = np.where(upd, tk, best_t)
            best["bx"] = np.where(upd, w1[np.arange(r), k], best["bx"])
            best["by"] = np.where(upd, w2[np.arange(r), k], best["by"])
            best["tri"] = np.where(upd, ids[k].astype(np.int32), best["tri"])
            best["inst"] = np.where(upd, np.int32(inst), best["inst"])
    return {
        "dist": best_t,
        "bx": best["bx"],
        "by": best["by"],
        "bz": 1.0 - best["bx"] - best["by"],
        "tri": best["tri"],
        "inst": best["inst"],
    }


def _tris_under(sb: SceneBuffers, root: int) -> np.ndarray:
    """All global triangle ids in the BVH rooted at ``root``."""
    out, stack = [], [root]
    while stack:
        n = stack.pop()
        if sb.bvh_count[n] > 0:
            lo = int(sb.bvh_left[n])
            out.append(sb.bvh_tri_idx[lo : lo + int(sb.bvh_count[n])])
        else:
            stack += [int(sb.bvh_left[n]), int(sb.bvh_left[n]) + 1]
    return np.concatenate(out) if out else np.zeros(0, np.int32)


# ---------------------------------------------------------------------------
# Shading (raycast/render.h + rtx_shading.h semantics)
# ---------------------------------------------------------------------------

def rgb8_to_rgb32f(texel: np.ndarray) -> np.ndarray:
    """0xRRGGBB uint32 -> float3, scale 1/256 (common.h RGB8toRGB32F)."""
    s = 1.0 / 256.0
    r = ((texel >> 16) & 255).astype(np.float32)
    g = ((texel >> 8) & 255).astype(np.float32)
    b = (texel & 255).astype(np.float32)
    return np.stack([r, g, b], axis=-1) * s


def tex_sample_np(uv: np.ndarray, sb: SceneBuffers, mat: np.ndarray) -> np.ndarray:
    """Point-sampled, wrap-addressed texel fetch (rtx_shading.h texSample)."""
    w = sb.mat_tex_w[mat]
    h = sb.mat_tex_h[mat]
    off = sb.mat_tex_offset[mat]
    has = off >= 0
    ws = np.maximum(w, 1)
    hs = np.maximum(h, 1)
    iu = np.floor(uv[..., 0] * ws).astype(np.int64) % ws
    iv = np.floor(uv[..., 1] * hs).astype(np.int64) % hs
    idx = np.where(has, off + iu + iv * ws, 0)
    tex = rgb8_to_rgb32f(sb.texels[idx])
    return np.where(has[..., None], tex, sb.mat_diffuse[mat])


def tex_sample_bi_np(uv: np.ndarray, sb: SceneBuffers,
                     mat: np.ndarray) -> np.ndarray:
    """Bilinear texel fetch (rtx_shading.h texSampleBi /
    raycast/render.h:24-56): floor first, wrap each tap independently."""
    w = sb.mat_tex_w[mat]
    h = sb.mat_tex_h[mat]
    off = sb.mat_tex_offset[mat]
    has = off >= 0
    ws = np.maximum(w, 1).astype(np.int64)
    hs = np.maximum(h, 1).astype(np.int64)
    u = uv[..., 0] * ws
    v = uv[..., 1] * hs
    x0 = np.floor(u)
    y0 = np.floor(v)
    fu = (u - x0).astype(np.float32)[..., None]
    fv = (v - y0).astype(np.float32)[..., None]
    x0i = x0.astype(np.int64) % ws
    y0i = y0.astype(np.int64) % hs
    x1i = (x0.astype(np.int64) + 1) % ws
    y1i = (y0.astype(np.int64) + 1) % hs

    def tap(xi, yi):
        return rgb8_to_rgb32f(sb.texels[np.where(has, off + xi + yi * ws, 0)])

    cx0 = tap(x0i, y0i) * (1 - fu) + tap(x1i, y0i) * fu
    cx1 = tap(x0i, y1i) * (1 - fu) + tap(x1i, y1i) * fu
    tex = cx0 * (1 - fv) + cx1 * fv
    return np.where(has[..., None], tex, sb.mat_diffuse[mat])


def diffuse_lighting_np(p, n, diffuse_color, ambient, light_color, light_pos):
    """rtx_shading.h diffuseLighting: attenuated N.L with ambient term."""
    l = light_pos - p
    dist = vm.length(l)
    l = l / np.maximum(dist, 1e-20)[..., None]
    att = 1.0 / (1.0 + dist * 0.1)
    ndotl = np.maximum(0.0, vm.dot(n, l))
    return diffuse_color * (ambient + att[..., None] * light_color * ndotl[..., None])


def generate_rays(cam: Camera, width: int, height: int):
    """Per-pixel primary rays (raycast/render.h:190-208 GenerateRay)."""
    x = np.arange(width, dtype=np.float32)
    y = np.arange(height, dtype=np.float32)
    xx, yy = np.meshgrid(x, y)  # (H, W)
    x_ndc = (xx + 0.5) / width - 0.5
    y_ndc = (yy + 0.5) / height - 0.5
    pt_cam = (
        (x_ndc * cam.viewplane[0])[..., None] * cam.right
        + (y_ndc * cam.viewplane[1])[..., None] * cam.up
        + cam.forward
    )
    d = np.asarray(vm.normalize(pt_cam), np.float32)
    o = np.broadcast_to(cam.pos, d.shape).astype(np.float32)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def occlusion_np(p, sb: SceneBuffers, light_pos, eps: float = 1e-3):
    """Shadow test: is the light visible from p?  Brute force (oracle)."""
    l = light_pos - p
    dist = np.asarray(vm.length(l))
    d = l / np.maximum(dist, 1e-20)[..., None]
    o = p + d * eps
    sh = brute_force_hits(o.astype(np.float32), d.astype(np.float32), sb)
    return sh["dist"] < dist * (1.0 - 1e-3)


def shade_hits(o, d, hits, sb: SceneBuffers, params: RenderParams,
               bilinear: bool = False):
    """One bounce of the Trace() loop body on arrays of rays with hit info.

    Returns (diffuse_contrib (R,3), reflectivity (R,), hit_mask (R,),
    new_o, new_d) — the caller owns radiance/throughput accumulation.
    """
    hit = hits["dist"] < LARGE_FLOAT
    tri = hits["tri"]
    inst = hits["inst"]
    bx, by, bz = hits["bx"], hits["by"], hits["bz"]

    # clamp miss-lane distances: their results are discarded, avoid inf/nan
    p = o + d * np.minimum(hits["dist"], 1e18)[..., None]
    # N = N1*bx + N2*by + N0*bz (closest.cpp / render.h convention)
    n = (sb.n1[tri] * bx[..., None] + sb.n2[tri] * by[..., None]
         + sb.n0[tri] * bz[..., None])
    # normals transform by inverse-transpose of the instance transform
    inv_t = sb.inst_inv_transpose[inst]  # (R, 4, 4)
    n = np.einsum("rij,rj->ri", inv_t[:, :3, :3], n)
    n = np.asarray(vm.normalize(n), np.float32)

    uv = (sb.uv1[tri] * bx[..., None] + sb.uv2[tri] * by[..., None]
          + sb.uv0[tri] * bz[..., None])
    mat = sb.mat_id[tri]
    tex_color = (tex_sample_bi_np if bilinear else tex_sample_np)(uv, sb, mat)
    diffuse = diffuse_lighting_np(
        p, n, tex_color,
        np.asarray(params.ambient_color, np.float32),
        np.asarray(params.light_color, np.float32),
        np.asarray(params.light_pos, np.float32),
    )
    if getattr(params, "shadow", False):
        occluded = occlusion_np(p, sb, np.asarray(params.light_pos,
                                                  np.float32))
        # remove the direct (attenuated N.L) term where shadowed
        lit_diffuse = diffuse_lighting_np(
            p, n, tex_color,
            np.asarray(params.ambient_color, np.float32),
            np.zeros(3, np.float32),
            np.asarray(params.light_pos, np.float32))
        diffuse = np.where(occluded[..., None], lit_diffuse, diffuse)
    refl = sb.inst_reflectivity[inst]
    r = np.asarray(vm.normalize(vm.reflect(d, n)), np.float32)
    new_o = p + r * 1e-3
    return diffuse, refl, hit, new_o, r


def render_golden_pt(sb: SceneBuffers, cam: Camera, params: RenderParams,
                     width: int, height: int, spp: int = None,
                     total_spp: int = None, seed: int = 0,
                     pixels=None) -> np.ndarray:
    """Golden PATH-TRACED render: replays the device integrator's exact
    light paths.

    The device path tracer (engine.shaders.pathtrace_closest) draws every
    random from the counter-based sampler (utils.sampling) keyed on
    (pixel, sample, bounce, seed); this oracle draws the SAME streams
    (bit-identical on CPU tensors), so the
    two images agree to fp tolerance at ANY spp — no comparison "in
    expectation" needed.  Brute-force closest hits, like render_golden.

    ``pixels``: optional (K,) flat pixel ids to render only a sample of
    pixels (the scale-capable gate); returns (K, 3) then.
    """
    spp = params.spp if spp is None else spp
    total_spp = spp if total_spp is None else total_spp
    if pixels is None:
        pixels = np.arange(width * height, dtype=np.uint32)
    else:
        pixels = np.asarray(pixels, np.uint32)
    k = pixels.size
    out = np.zeros((k, 3), np.float32)
    light_pos = np.asarray(params.light_pos, np.float32)
    light_color = np.asarray(params.light_color, np.float32)
    ambient = np.asarray(params.ambient_color, np.float32)
    background = np.asarray(params.background_color, np.float32)

    for s in range(spp):
        samp = np.full(k, np.uint32(seed) * np.uint32(spp) + np.uint32(s),
                       np.uint32)
        jx, jy = _stratified_jitter(pixels, samp, total_spp, 0)
        px = (pixels % width).astype(np.float32)
        py = (pixels // width).astype(np.float32)
        x_ndc = (px + jx) / width - 0.5
        y_ndc = (py + jy) / height - 0.5
        pt = (x_ndc[:, None] * cam.viewplane[0] * cam.right
              + y_ndc[:, None] * cam.viewplane[1] * cam.up + cam.forward)
        d = np.asarray(vm.normalize(pt), np.float32)
        o = np.broadcast_to(cam.pos, d.shape).astype(np.float32).copy()

        radiance = np.zeros((k, 3), np.float32)
        thr = np.ones((k, 3), np.float32)
        active = np.ones(k, bool)
        for bounce in range(params.max_depth):
            if not active.any():
                break
            hits = brute_force_hits(o, d, sb)
            hit = hits["dist"] < LARGE_FLOAT
            tri, inst = hits["tri"], hits["inst"]
            bx, by, bz = hits["bx"], hits["by"], hits["bz"]
            p = o + d * np.minimum(hits["dist"], 1e18)[..., None]
            n = (sb.n1[tri] * bx[..., None] + sb.n2[tri] * by[..., None]
                 + sb.n0[tri] * bz[..., None])
            inv_t = sb.inst_inv_transpose[inst]
            n = np.einsum("rij,rj->ri", inv_t[:, :3, :3], n)
            n = np.asarray(vm.normalize(n), np.float32)
            uv = (sb.uv1[tri] * bx[..., None] + sb.uv2[tri] * by[..., None]
                  + sb.uv0[tri] * bz[..., None])
            mat = sb.mat_id[tri]
            albedo = tex_sample_np(uv, sb, mat)

            # NEE direct light, shadow-gated like the device's shadow pass
            lit = np.ones(k, np.float32)
            if params.shadow:
                lit = np.where(occlusion_np(p, sb, light_pos), 0.0, 1.0)
            lvec = light_pos - p
            dist_l = np.asarray(vm.length(lvec))
            ldir = lvec / np.maximum(dist_l, 1e-20)[..., None]
            att = 1.0 / (1.0 + dist_l * 0.1)
            ndotl = np.maximum(0.0, vm.dot(n, ldir))
            direct = albedo * (att * ndotl * lit)[..., None] * light_color
            if bounce == 0:
                direct = direct + albedo * ambient

            miss_now = active & ~hit
            radiance[miss_now] += thr[miss_now] * background

            refl = sb.inst_reflectivity[inst]
            mirror = refl > 0.0
            h = active & hit
            radiance[h] += thr[h] * ((1.0 - refl[h])[:, None] * direct[h])

            # stream key is the global sample index (see
            # engine.shaders.pathtrace_closest) — seed folds into samp
            u1, u2 = _sample2(pixels, samp, np.full(k, bounce, np.uint32),
                              0, dim=1)
            hx, hy, hz = _cosine_hemisphere(
                n[:, 0], n[:, 1], n[:, 2],
                u1.astype(np.float32), u2.astype(np.float32))
            rdir = np.asarray(vm.normalize(vm.reflect(d, n)), np.float32)
            nd = np.where(mirror[:, None], rdir,
                          np.stack([hx, hy, hz], -1)).astype(np.float32)
            mulv = np.where(mirror[:, None], refl[:, None],
                            albedo).astype(np.float32)
            # Russian roulette replay (engine.shaders.pathtrace_closest):
            # same counter stream (dim=2), same survival p, same 1/p
            # compensation — kill decisions are bit-identical
            u3, _ = _sample2(pixels, samp, np.full(k, bounce, np.uint32), 0,
                             dim=2)
            p_srv = np.clip(mulv.max(axis=1), 0.1, 0.95).astype(np.float32)
            if bounce >= 1:
                survive = u3.astype(np.float32) < p_srv
                mulv = mulv * (np.float32(1.0) / p_srv)[:, None]
            else:
                survive = np.ones(k, bool)
            thr[h] *= mulv[h]
            spawn = h & (bounce + 1 < params.max_depth) & survive
            o = np.where(spawn[:, None], p + nd * 1e-3, o).astype(np.float32)
            d = np.where(spawn[:, None], nd, d).astype(np.float32)
            active = spawn
        out += radiance
    return out / spp


def sample_pixel_parity(sb: SceneBuffers, cam: Camera, params: RenderParams,
                        width: int, height: int, img: np.ndarray,
                        n: int = 1024, seed: int = 0):
    """Scale-capable fidelity gate: brute-force-render ``n`` randomly
    sampled pixels and compare against the device image ``img`` (H, W, 3).

    The full golden render is O(R*T) and cannot run at 1080p over a
    260k-tri scene (~5e11 ray-tri tests); sampling keeps the oracle's
    strictly-stronger-than-BVH property per sampled pixel while bounding
    cost at O(n*T).  Only valid for spp == 1 (pixel-center rays — the
    device's stratified jitter is stochastic at spp > 1).

    Returns (rmse_over_samples, worst_abs_err, (py, px) of the worst
    pixel).  Mirrors the reference's host-vs-device image comparison
    fidelity strategy (raycast/tracer.cpp:226-263) at sampled-pixel
    granularity.
    """
    rng = np.random.default_rng(seed)
    pix = rng.choice(width * height, size=min(n, width * height),
                     replace=False)
    px = (pix % width).astype(np.int64)
    py = (pix // width).astype(np.int64)
    x_ndc = (px + 0.5).astype(np.float32) / width - 0.5
    y_ndc = (py + 0.5).astype(np.float32) / height - 0.5
    pt = (x_ndc[:, None] * cam.viewplane[0] * cam.right
          + y_ndc[:, None] * cam.viewplane[1] * cam.up + cam.forward)
    d = np.asarray(vm.normalize(pt), np.float32)
    o = np.broadcast_to(cam.pos, d.shape).astype(np.float32)
    ref = render_golden(sb, cam, params, pix.size, 1, rays=(o, d))
    ref = ref.reshape(-1, 3)
    dev = np.asarray(img, np.float32)[py, px]
    err = dev - ref
    rmse = float(np.sqrt((err ** 2).mean()))
    worst = int(np.abs(err).max(axis=1).argmax())
    return rmse, float(np.abs(err[worst]).max()), (int(py[worst]),
                                                   int(px[worst]))


def render_golden(sb: SceneBuffers, cam: Camera, params: RenderParams,
                  width: int, height: int, rays=None,
                  bilinear: bool = False) -> np.ndarray:
    """Full golden render: (H, W, 3) float32 radiance in [0, inf).

    ``rays``: optional (o, d) override so callers can compare against a
    device render on bit-identical ray inputs (exact-tie seam pixels flip
    with last-ULP direction changes).
    """
    if rays is None:
        o, d = generate_rays(cam, width, height)
    else:
        o, d = (np.asarray(a, np.float32) for a in rays)
    r = o.shape[0]
    radiance = np.zeros((r, 3), np.float32)
    throughput = np.ones(r, np.float32)
    active = np.ones(r, bool)
    background = np.asarray(params.background_color, np.float32)

    for bounce in range(params.max_depth):
        if not active.any():
            break
        hits = brute_force_hits(o, d, sb)
        diffuse, refl, hit, new_o, new_d = shade_hits(o, d, hits, sb, params,
                                                      bilinear=bilinear)

        miss_now = active & ~hit
        radiance[miss_now] += throughput[miss_now, None] * background

        h = active & hit
        radiance[h] += (throughput[h] * (1.0 - refl[h]))[:, None] * diffuse[h]
        throughput[h] *= refl[h]

        bounce_more = h & (refl > 0.0) & (bounce + 1 < params.max_depth)
        stop = h & ~bounce_more
        radiance[stop] += throughput[stop, None] * background

        active = bounce_more
        o = np.where(active[:, None], new_o, o)
        d = np.where(active[:, None], new_d, d)

    return radiance.reshape(height, width, 3)
