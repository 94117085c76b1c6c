"""Wavefront render engine (port of ``vortex_rt_tpu/engine/wavefront.py``).

A frame is ``spp`` passes over the pixels, one sample per pixel per pass,
accumulated into three O(n_pix) radiance planes.  Each pass generates
camera rays in tile-major lane order and runs the bounce pipeline
(``_wave_pipeline``); every bounce runs, in order:

1. the closest-hit trace of the live rays;
2. the shadow occlusion trace from the hit points to the light;
3. shading (``shade_point`` + the closest / miss shaders) with the
   occlusion result as ``lit``;
4. spawn of the continuation rays.

Both traces go through ``walk``, chosen by the table width unless given:
8-wide fused tables (the default for flattened builds, as in the JAX
package) go to ``ops.traverse_packet.trace_packets`` (K1), 4-wide tables
to ``ops.packet_walk.trace_packets_walk`` (K2).  Each launches its CUDA
walk on the card and runs its plain PyTorch version on CPU tensors.

On the K1 route the frame also runs the JAX package's merged wave: from
bounce 1 on, when a further bounce follows, the shadow occlusion query
and the next bounce's closest-hit trace run as ONE mixed walk
(``occl_split``), the closest shader is evaluated at lit=1 and lit=0,
and the occlusion result selects per lane.  The JAX package does not
merge at bounce 0 (its shadow packet differs from its bounce packet
there), so neither does the port.  The 4-wide route keeps the
sequential pipeline, as the JAX package does on its Pallas route.

Pass ``n`` of a frame uses the global sample index ``seed * spp + n``,
the index the JAX package gives that sample in both of its frame
layouts, so the port renders the same rays.

``RenderParams(pathtrace=True)`` swaps the Whitted closest shader for
``pathtrace_closest`` (sampled diffuse bounces, Russian roulette); its
continuation does not read ``lit``, so the merged wave applies.
``render_accum`` averages ``n_passes`` frames stratified over
``spp * n_passes`` samples per pixel.

Not ported yet, and refused rather than ignored: any-hit shaders,
per-wave statistics and staged profiling, and multi-device rendering.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from vortex_rt_tpu_torch.engine.megakernel import CameraArrays, LightArrays
from vortex_rt_tpu_torch.engine.shaders import (
    PayloadLanes, RayLanes, ShaderContext, ShaderTable, pathtrace_closest,
)
from vortex_rt_tpu_torch.models.scene import (
    Camera, RenderParams, Scene, SceneBuffers,
)
from vortex_rt_tpu_torch.ops.packet_walk import trace_packets_walk
from vortex_rt_tpu_torch.ops.shade_lanes import ShadeArrays, shade_point
from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets
from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays
from vortex_rt_tpu_torch.utils import sampling
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT, RTConfig

_U32 = 0xFFFFFFFF


def _tile_pixel_ids(q: torch.Tensor, width: int, tile_w: int, tile_h: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-major lane index ``q`` -> (px, py) image coordinates, pure
    integer arithmetic."""
    lane_n = tile_w * tile_h
    t = q // lane_n
    l = q % lane_n
    ntx = width // tile_w
    tx = t % ntx
    ty = t // ntx
    px = tx * tile_w + l % tile_w
    py = ty * tile_h + l // tile_w
    return px, py


def _jitter(pix, samp, total_spp: int):
    """Per-sample sub-pixel offsets (stratified, counter-based);
    total_spp == 1 keeps exact pixel centers."""
    if total_spp == 1:
        return 0.5, 0.5
    return sampling.stratified_jitter(pix, samp, total_spp, 0)


def _camera_from_pix(cam: CameraArrays, width: int, height: int,
                     pxi, pyi, pix, samp, total_spp: int):
    """Integer pixel coords + sample ids -> camera ray lanes."""
    dev = pxi.device
    px = pxi.to(torch.float32)
    py = pyi.to(torch.float32)
    jx, jy = _jitter(pix, samp, total_spp)
    # divide by 0-dim tensors: true division on every device (a Python
    # scalar divisor becomes a reciprocal multiply on CUDA)
    w_t = torch.tensor(float(width), dtype=torch.float32, device=dev)
    h_t = torch.tensor(float(height), dtype=torch.float32, device=dev)
    x_ndc = (px + jx) / w_t - 0.5
    y_ndc = (py + jy) / h_t - 0.5
    vx = x_ndc * cam.viewplane[0]
    vy = y_ndc * cam.viewplane[1]
    dx = vx * cam.right[0] + vy * cam.up[0] + cam.forward[0]
    dy = vx * cam.right[1] + vy * cam.up[1] + cam.forward[1]
    dz = vx * cam.right[2] + vy * cam.up[2] + cam.forward[2]
    inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    r = px.shape[0]
    ox = cam.pos[0].expand(r).clone()
    oy = cam.pos[1].expand(r).clone()
    oz = cam.pos[2].expand(r).clone()
    return ox, oy, oz, dx, dy, dz


def default_walk(wa: WideArrays) -> Callable:
    """The trace function for a table: K1 for 8-wide, K2 for 4-wide."""
    return trace_packets if wa.width == 8 else trace_packets_walk


def _resolve_tiled(lanes: torch.Tensor, width: int, rows: int,
                   tile_w: int, tile_h: int) -> torch.Tensor:
    """(n_pix,) tile-major lanes -> (rows, width) image."""
    nty, ntx = rows // tile_h, width // tile_w
    a = lanes.reshape(nty, ntx, tile_h, tile_w)
    return a.permute(0, 2, 1, 3).reshape(rows, width)


def _wave_pipeline(wa: WideArrays, sa: ShadeArrays, ctx: ShaderContext,
                   table: ShaderTable, light: LightArrays, lanes, pix, samp,
                   alive, max_depth: int, shadow: bool, walk: Callable):
    """The bounce pipeline over one lane set: trace, shadow occlusion,
    shade, spawn — ``max_depth`` waves, with the merged shadow+bounce
    wave on the 8-wide route.  Returns (rad_r, rad_g, rad_b, rays traced,
    walk steps), the counts as 0-dim int64 tensors."""
    ox, oy, oz, dx, dy, dz = lanes
    r = ox.shape[0]
    dev = ox.device
    rad_r = torch.zeros(r, dtype=torch.float32, device=dev)
    rad_g = torch.zeros_like(rad_r)
    rad_b = torch.zeros_like(rad_r)
    thr_r = torch.ones_like(rad_r)
    thr_g = torch.ones_like(rad_r)
    thr_b = torch.ones_like(rad_r)
    zero = torch.zeros_like(rad_r)
    one = torch.ones_like(rad_r)
    bounce_ct = torch.zeros(r, dtype=torch.int32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    n_tri = sa.shade_rows.shape[0]
    n_inst = sa.inst_shade.shape[0]
    pending = None  # this bounce's hits, traced by the previous merged wave

    for bounce in range(max_depth):
        rays = rays + alive.sum()
        if pending is None:
            h, st = walk(wa, torch.stack([ox, oy, oz], 1),
                         torch.stack([dx, dy, dz], 1), active=alive)
            steps = steps + st.sum()
        else:
            h, pending = pending, None
        dist, bx, by = h.dist, h.bx, h.by
        hit = alive & (dist < LARGE_FLOAT)
        miss = alive & ~hit
        tri_c = h.tri.clamp(0, n_tri - 1).to(torch.int64)
        inst_c = h.inst.clamp(0, n_inst - 1).to(torch.int64)
        # the JAX package's merged-wave rule under its default packets
        # (engine/wavefront.py:572-579): never at bounce 0
        merge = (shadow and bounce >= 1 and bounce + 1 < max_depth
                 and table.lit_independent_spawn and wa.width == 8)
        if shadow:
            # shadow rays need the hit point only; full shading follows
            # the occlusion result
            t_hit = torch.clamp_max(dist, 1e18)
            hpx, hpy, hpz = (ox + dx * t_hit, oy + dy * t_hit,
                             oz + dz * t_hit)
            slx = light.light_pos[0] - hpx
            sly = light.light_pos[1] - hpy
            slz = light.light_pos[2] - hpz
            dist_l = torch.sqrt(slx * slx + sly * sly + slz * slz + 1e-20)
            sdx, sdy, sdz = slx / dist_l, sly / dist_l, slz / dist_l
            sh_act = hit
            rays = rays + sh_act.sum()
            clamp = dist_l * (1.0 - 1e-3)
            sh_o = torch.stack([hpx + sdx * 1e-3, hpy + sdy * 1e-3,
                                hpz + sdz * 1e-3], 1)
            sh_d = torch.stack([sdx, sdy, sdz], 1)
            if not merge:
                sh, sh_st = walk(wa, sh_o, sh_d, active=sh_act, t_max=clamp,
                                 occlusion=True)
                steps = steps + sh_st.sum()
                occluded = sh_act & (sh.dist < clamp)
        sp = shade_point(sa, ox, oy, oz, dx, dy, dz,
                         dist, bx, by, 1.0 - bx - by, tri_c, inst_c)
        ray = RayLanes(ox, oy, oz, dx, dy, dz)
        pl = PayloadLanes((thr_r + thr_g + thr_b) * (1.0 / 3.0),
                          bounce_ct, pix, samp)
        if merge:
            # shade at lit=1 and lit=0; the continuation is lit-independent,
            # so the next bounce's rays are known before the occlusion
            # result, and both traces run as one mixed wave of 2r lanes
            co1 = table.closest(ctx, sp._replace(lit=one), ray, pl)
            co0 = table.closest(ctx, sp._replace(lit=zero), ray, pl)
            spawn = hit & co1.spawn
            n_o = torch.stack([torch.where(spawn, co1.sox, ox),
                               torch.where(spawn, co1.soy, oy),
                               torch.where(spawn, co1.soz, oz)], 1)
            n_d = torch.stack([torch.where(spawn, co1.sdx, dx),
                               torch.where(spawn, co1.sdy, dy),
                               torch.where(spawn, co1.sdz, dz)], 1)
            hm, m_st = walk(
                wa, torch.cat([sh_o, n_o]), torch.cat([sh_d, n_d]),
                active=torch.cat([sh_act, spawn]),
                t_max=torch.cat([clamp, torch.full_like(clamp, LARGE_FLOAT)]),
                occl_split=r)
            steps = steps + m_st.sum()
            occluded = sh_act & (hm.dist[:r] < clamp)
            # the next bounce takes its hits from here (its rays are
            # counted at the top of the loop, as in the sequential one)
            pending = type(hm)(*(f[r:] for f in hm))

            def blend(a0, a1):
                return torch.where(occluded, a0, a1)

            co = co1._replace(
                add_r=blend(co0.add_r, co1.add_r),
                add_g=blend(co0.add_g, co1.add_g),
                add_b=blend(co0.add_b, co1.add_b),
                mul_r=blend(co0.mul_r, co1.mul_r),
                mul_g=blend(co0.mul_g, co1.mul_g),
                mul_b=blend(co0.mul_b, co1.mul_b))
        else:
            if shadow:
                sp = sp._replace(lit=torch.where(occluded, zero, one))
            co = table.closest(ctx, sp, ray, pl)
            spawn = hit & co.spawn
        mr, mg, mb = table.miss(ctx, ray, pl)

        rad_r = rad_r + torch.where(hit, thr_r * co.add_r,
                                    torch.where(miss, thr_r * mr, zero))
        rad_g = rad_g + torch.where(hit, thr_g * co.add_g,
                                    torch.where(miss, thr_g * mg, zero))
        rad_b = rad_b + torch.where(hit, thr_b * co.add_b,
                                    torch.where(miss, thr_b * mb, zero))
        thr_r = torch.where(hit, thr_r * co.mul_r, thr_r)
        thr_g = torch.where(hit, thr_g * co.mul_g, thr_g)
        thr_b = torch.where(hit, thr_b * co.mul_b, thr_b)

        ox = torch.where(spawn, co.sox, ox)
        oy = torch.where(spawn, co.soy, oy)
        oz = torch.where(spawn, co.soz, oz)
        dx = torch.where(spawn, co.sdx, dx)
        dy = torch.where(spawn, co.sdy, dy)
        dz = torch.where(spawn, co.sdz, dz)
        alive = spawn
        bounce_ct = torch.where(spawn, bounce_ct + 1, bounce_ct)

    return rad_r, rad_g, rad_b, rays, steps


def frame_body(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
               light: LightArrays, width: int, height: int,
               max_depth: int = 2, spp: int = 1,
               table: Optional[ShaderTable] = None, seed: int = 0,
               shadow: bool = False, tile_w: int = 16, tile_h: int = 16,
               walk: Optional[Callable] = None,
               collect_stats: bool = False,
               stage_limit: Optional[int] = None,
               total_spp: Optional[int] = None):
    """One frame -> ((3, H*W) radiance planes in row-major pixel order,
    rays traced, walk steps), the counts as 0-dim int64 tensors on the
    tables' device.  ``walk`` defaults to ``default_walk(wa)``.
    ``total_spp`` is the stratification denominator, ``spp`` unless
    given: accumulation passes (``render_accum``) spread ``spp`` samples
    per pass over ``spp * n_passes`` strata.  Nothing here waits for the
    device."""
    if collect_stats or stage_limit is not None:
        raise NotImplementedError(
            "collect_stats/stage_limit: per-wave statistics and staged "
            "profiling are not ported yet (ROADMAP Queue 1, item 10)")
    table = table or ShaderTable()
    if table.anyhit is not None:
        raise NotImplementedError(
            "any-hit shaders are not ported yet (ROADMAP Queue 1, item 8)")
    walk = walk or default_walk(wa)
    dev = wa.device
    ctx = ShaderContext(
        shade=sa, light_pos=light.light_pos, light_color=light.light_color,
        ambient=light.ambient, background=light.background,
        max_depth=max_depth)

    total_spp = spp if total_spp is None else total_spp
    n_pix = width * height
    rows = height
    # adaptive tile height: fall back through 8/4/2 so odd frame heights
    # (1080) still get the tile-major lane order
    if width % tile_w == 0:
        for th in (tile_h, 8, 4, 2):
            if rows % th == 0:
                tile_h = th
                break
    tiled = width % tile_w == 0 and rows % tile_h == 0
    lane = torch.arange(n_pix, dtype=torch.int64, device=dev)
    if tiled:
        pxi, pyi = _tile_pixel_ids(lane, width, tile_w, tile_h)
        pix = pyi * width + pxi
    else:
        pxi, pyi, pix = lane % width, lane // width, lane
    alive = torch.ones(n_pix, dtype=torch.bool, device=dev)

    acc = [torch.zeros(n_pix, dtype=torch.float32, device=dev)
           for _ in range(3)]
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    for p in range(spp):
        # global sample index of this pass (u32 arithmetic)
        samp_val = (((int(seed) & _U32) * spp) + p) & _U32
        samp = torch.full((n_pix,), samp_val, dtype=torch.int64, device=dev)
        lanes6 = _camera_from_pix(cam, width, height, pxi, pyi, pix, samp,
                                  total_spp)
        rr, rg, rb, n_rays, n_steps = _wave_pipeline(
            wa, sa, ctx, table, light, lanes6, pix, samp, alive,
            max_depth, shadow, walk)
        acc = [acc[0] + rr, acc[1] + rg, acc[2] + rb]
        rays = rays + n_rays
        steps = steps + n_steps

    inv_spp = 1.0 / spp
    if tiled:
        img = torch.stack([
            _resolve_tiled(c * inv_spp, width, rows, tile_w, tile_h)
            .reshape(n_pix) for c in acc])
    else:
        img = torch.stack(acc) * inv_spp
    return img, rays, steps


def render_accum(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
                 light: LightArrays, width: int, height: int,
                 n_passes: int = 4, seed0: int = 0, max_depth: int = 2,
                 spp: int = 1, table: Optional[ShaderTable] = None,
                 shadow: bool = False, tile_w: int = 16, tile_h: int = 16,
                 walk: Optional[Callable] = None):
    """Progressive accumulation: the average of ``n_passes`` frames with
    seeds ``seed0 + i``, stratified over ``spp * n_passes`` samples per
    pixel.  Returns ((H, W, 3) image tensor, total rays, total steps).
    Each pass keeps one sample per pixel in flight, so memory stays that
    of one frame.  Nothing here waits for the device."""
    dev = wa.device
    img = torch.zeros((3, width * height), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(n_passes):
        f_img, f_rays, f_steps = frame_body(
            wa, sa, cam, light, width, height, max_depth=max_depth, spp=spp,
            table=table, seed=seed0 + i, shadow=shadow, tile_w=tile_w,
            tile_h=tile_h, walk=walk, total_spp=spp * n_passes)
        img, rays, steps = img + f_img, rays + f_rays, steps + f_steps
    out = (img * (1.0 / n_passes)).reshape(3, height, width)
    return out.permute(1, 2, 0), rays, steps


@dataclasses.dataclass
class WavefrontRenderer:
    """Host-facing renderer over tables that live on one device."""

    sb: SceneBuffers
    wa: WideArrays
    sa: ShadeArrays
    config: RTConfig
    table: ShaderTable
    walk: Optional[Callable] = None  # None: default_walk(wa)

    @property
    def device(self) -> torch.device:
        return self.wa.device

    @staticmethod
    def from_scene(scene: Scene, config: Optional[RTConfig] = None,
                   table: Optional[ShaderTable] = None, *,
                   device) -> "WavefrontRenderer":
        cfg = config or RTConfig()
        return WavefrontRenderer.from_buffers(scene.build(cfg), cfg, table,
                                              device=device)

    @staticmethod
    def from_buffers(sb_host: SceneBuffers, config: Optional[RTConfig] = None,
                     table: Optional[ShaderTable] = None, *, device,
                     walk: Optional[Callable] = None
                     ) -> "WavefrontRenderer":
        """Build the tables on the host and move them to ``device``:
        8-wide builds are fused (the JAX package's default).  ``walk`` is
        the trace function, ``default_walk`` of the tables when None; a
        plain PyTorch version (``trace_packets_ref`` for 8-wide,
        ``trace_packets_walk_ref`` for 4-wide) forces the plain route on
        a card."""
        if isinstance(device, (list, tuple)):
            raise NotImplementedError(
                "multi-device rendering is not ported yet (ROADMAP Queue "
                "1, item 11)")
        device = torch.device(device)
        cfg = config or RTConfig()
        table = table or ShaderTable()
        if table.anyhit is not None:
            raise NotImplementedError(
                "any-hit shaders and their alpha tables are not ported yet "
                "(ROADMAP Queue 1, item 8)")
        wa = WideArrays.from_scene(sb_host, width=cfg.bvh_width)
        if wa.width == 8:
            wa = wa.fuse()
        return WavefrontRenderer(
            sb=sb_host,
            wa=wa.to(device),
            sa=ShadeArrays.from_scene(sb_host).to(device),
            config=cfg,
            table=table,
            walk=walk or default_walk(wa),
        )

    def _table_for(self, params: RenderParams) -> ShaderTable:
        """``params.pathtrace`` swaps the Whitted closest shader for the
        path-traced one unless the user installed a custom table."""
        if params.pathtrace and self.table == ShaderTable():
            return ShaderTable(closest=pathtrace_closest)
        return self.table

    def _frame(self, cam: Camera, params: RenderParams, w: int, h: int,
               seed: int):
        return frame_body(
            self.wa, self.sa, CameraArrays.from_camera(cam, self.device),
            LightArrays.from_params(params, self.device), w, h,
            max_depth=params.max_depth, spp=params.spp,
            table=self._table_for(params), seed=seed, shadow=params.shadow,
            tile_w=self.config.tile_w, tile_h=self.config.tile_h,
            walk=self.walk)

    @staticmethod
    def _to_image(img: torch.Tensor, w: int, h: int) -> np.ndarray:
        return img.reshape(3, h, w).permute(1, 2, 0).cpu().numpy()

    def render(self, cam: Camera, params: RenderParams,
               width: Optional[int] = None, height: Optional[int] = None
               ) -> Tuple[np.ndarray, int]:
        """One frame (seed 0) -> ((H, W, 3) float32 image, rays traced)."""
        w = width or self.config.width
        h = height or self.config.height
        img, rays, _ = self._frame(cam, params, w, h, 0)
        return self._to_image(img, w, h), int(rays.item())

    def render_burst(self, cam: Camera, params: RenderParams,
                     width: Optional[int] = None,
                     height: Optional[int] = None,
                     n_frames: int = 16, seed0: int = 0,
                     rays_only: bool = False):
        """Render ``n_frames`` frames (seeds seed0..seed0+n-1) and return
        (image, total rays), or only the total ray count with
        ``rays_only=True``.  The image is the seed-0 frame of ``render``,
        whatever ``seed0`` and ``n_frames`` are, as the JAX package's
        method returns it.  The burst waits for the device once, at the
        end."""
        w = width or self.config.width
        h = height or self.config.height
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(n_frames):
            _, rays, _ = self._frame(cam, params, w, h, seed0 + i)
            total = total + rays
        n = int(total.item())
        if rays_only:
            return n
        return self.render(cam, params, w, h)[0], n

    def render_accum(self, cam: Camera, params: RenderParams,
                     width: Optional[int] = None,
                     height: Optional[int] = None,
                     n_passes: int = 4, seed0: int = 0
                     ) -> Tuple[np.ndarray, int]:
        """Progressive high-spp render: averages ``n_passes`` frames of
        ``params.spp`` samples each (stratified over the product) without
        multiplying the lanes in flight.  Returns (image, rays); waits
        for the device once, at the end."""
        w = width or self.config.width
        h = height or self.config.height
        img, rays, _ = render_accum(
            self.wa, self.sa, CameraArrays.from_camera(cam, self.device),
            LightArrays.from_params(params, self.device), w, h,
            n_passes=n_passes, seed0=seed0, max_depth=params.max_depth,
            spp=params.spp, table=self._table_for(params),
            shadow=params.shadow, tile_w=self.config.tile_w,
            tile_h=self.config.tile_h, walk=self.walk)
        return img.cpu().numpy(), int(rays.item())
