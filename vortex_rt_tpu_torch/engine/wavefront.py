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
package) and 16-wide ones (``RTConfig(bvh_width=16, flatten=True)``, built
on the host) go to ``ops.traverse_packet.trace_packets`` (K1, at the
table's width), 4-wide tables to ``ops.packet_walk.trace_packets_walk``
(K2).  Each launches its CUDA
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

Any-hit shaders (``ShaderTable.anyhit``) take one of two routes:

* ``alpha_test_anyhit`` (marked ``alpha_threshold``) and
  ``stateless_anyhit`` (marked ``inline_predicate``) stay on the route
  above, as the JAX package's ``_inline_anyhit`` keeps them:
  ``from_buffers`` builds the ``with_alpha`` tables and every wave runs
  K1 or K2 in alpha mode (``alpha_ref``) or in predicate mode
  (``anyhit_pred``: the predicate compiled by ``ops/anyhit_pred.py``,
  its ``sqrt`` and transcendentals correctly rounded, which raises
  ``NotImplementedError`` at ``from_buffers`` for an op outside its
  set: a non-elementwise or random op, a captured tensor that is not
  0-dim), shadow rays and the merged wave included, flat or TLAS;
* every other any-hit shader, and every frame with
  ``RTConfig(packet_size=0)``, takes the pool path, the JAX monolithic
  frame: all samples of all pixels in one pool of lanes, each wave traced
  by the per-ray walk (``ops/traverse_wide.walk_lanes``, K3), with a
  host loop of suspension rounds when an any-hit shader is bound (walk to
  the next candidate, ``shade_point`` at it, the shader, ``commit``),
  shadow rays as closest-hit traces clamped at the light.  The suspension
  protocol needs the TLAS build.

``render(mode="chunked")`` is the JAX host-orchestrated frame: the pool
compacted live-first before each bounce and only its live prefix traced
(K3), default shaders without shadows.

Observability (the RT unit's PerfStats and the scope, as in the JAX
package): ``frame_body(collect_stats=True)`` also returns each wave's
``PacketStats`` (keys ``trace<k>`` and ``shadow<k>``; the counters'
definitions over the port's per-ray walk are in ``PacketStats``'s
docstring), traced by the walks' counting instantiations on a card;
``stage_limit=s`` stops the frame after stage ``s`` (0 camera only,
1 + 3k bounce k's trace, 2 + 3k its shadow wave, 3 + 3k its shade and
spawn).  Either one runs the sequential pipeline (no merged wave), as
the JAX frame does.  The pool path collects no statistics, as in the JAX
package.  ``render_stats``, ``render_profile_burst`` and the renderer's
``perf_trace``, ``frame_profile`` and ``scope_trace`` are built on them.
The JAX frame adds a checksum of the truncated waves to its image so
that XLA keeps them; PyTorch runs every operation it is given, so the
port adds none.

``RTConfig(tex_filter="bilinear")`` filters textures bilinearly in
``WavefrontRenderer.render`` only: the JAX package passes it nowhere
else (``render_burst``'s frames, ``render_accum`` and the statistics
frames sample texels by point; ``render_burst``'s image is ``render``'s).

``frame_body(n_pix=, pix_offset=)`` renders a block of rows of the frame
with the frame's global pixel ids, the block one device renders in
``parallel.tiles`` and ``parallel.shards``; a ``walk`` given to it may
combine its hits across devices (``parallel.shards``).
``render_wavefront``, ``render_frame`` and ``render_burst`` are the JAX
package's functional entry points over the whole frame, and
``tile_pixel_perm`` its table of the tile-major lane order.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vortex_rt_tpu_torch.engine.megakernel import CameraArrays, LightArrays
from vortex_rt_tpu_torch.engine.shaders import (
    PayloadLanes, RayLanes, ShaderContext, ShaderTable, pathtrace_closest,
)
from vortex_rt_tpu_torch.models.scene import (
    Camera, RenderParams, Scene, SceneBuffers,
)
from vortex_rt_tpu_torch.ops.anyhit_pred import (
    CompiledPredicate, compile_predicate,
)
from vortex_rt_tpu_torch.ops.packet_walk import trace_packets_walk
from vortex_rt_tpu_torch.ops.shade_lanes import ShadeArrays, shade_point
from vortex_rt_tpu_torch.ops.traverse2 import Hits
from vortex_rt_tpu_torch.ops.traverse_packet import (
    WARP, PacketStats, packet_stats, trace_packets,
)
from vortex_rt_tpu_torch.ops.traverse_wide import (
    WideArrays, commit, init_state_lanes, lanes_hits, walk_lanes,
)
from vortex_rt_tpu_torch.utils import sampling
from vortex_rt_tpu_torch.utils.config import COMMIT_CONT, LARGE_FLOAT, RTConfig
from vortex_rt_tpu_torch.utils.trace import Tracer, maybe_span

_U32 = 0xFFFFFFFF


def tile_pixel_perm(width: int, height: int, tile_w: int = 16,
                    tile_h: int = 8) -> Optional[np.ndarray]:
    """Lane -> image pixel id of the tile-major lane order, as an (H*W,)
    int32 table (the JAX package's ``tile_pixel_perm``); None when the
    frame does not divide into tiles.  The frame computes the same
    mapping per lane (``_tile_pixel_ids``); the table is for tests and
    host-side tools."""
    if width % tile_w or height % tile_h:
        return None
    ty, tx = np.meshgrid(np.arange(height // tile_h),
                         np.arange(width // tile_w), indexing="ij")
    py, px = np.meshgrid(np.arange(tile_h), np.arange(tile_w), indexing="ij")
    yy = ty[:, :, None, None] * tile_h + py[None, None]
    xx = tx[:, :, None, None] * tile_w + px[None, None]
    return (yy * width + xx).reshape(-1).astype(np.int32)


def _tile_pixel_ids(q: torch.Tensor, width: int, tile_w: int, tile_h: int,
                    row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-major lane index ``q`` -> (px, py) image coordinates, pure
    integer arithmetic; ``row0`` is the first image row of the block."""
    lane_n = tile_w * tile_h
    t = q // lane_n
    l = q % lane_n
    ntx = width // tile_w
    tx = t % ntx
    ty = t // ntx
    px = tx * tile_w + l % tile_w
    py = row0 + ty * tile_h + l // tile_w
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
    """The trace function for a table: K1 for 8- and 16-wide, K2 for
    4-wide."""
    return trace_packets_walk if wa.width == 4 else trace_packets


def _resolve_tiled(lanes: torch.Tensor, width: int, rows: int,
                   tile_w: int, tile_h: int, spp: int = 1) -> torch.Tensor:
    """(n_pix * spp,) tile-major lanes (a pixel's samples adjacent) ->
    (rows, width) image, the samples averaged."""
    nty, ntx = rows // tile_h, width // tile_w
    if spp > 1:
        a = lanes.reshape(nty, ntx, tile_h, tile_w, spp).mean(-1)
    else:
        a = lanes.reshape(nty, ntx, tile_h, tile_w)
    return a.permute(0, 2, 1, 3).reshape(rows, width)


def _inline_anyhit(table: ShaderTable, wa: WideArrays):
    """The any-hit test the walks run inside K1 or K2 (the JAX
    ``_inline_anyhit``): the compiled predicate of a ``stateless_anyhit``
    (``inline_predicate``; it wins over a threshold), the threshold of an
    ``alpha_test_anyhit`` (``alpha_threshold``), or None: unmarked
    shaders, and tables without the ``with_alpha`` fields.  Compiling
    raises ``NotImplementedError`` for an op outside the compiler's set
    (its correctly rounded ``sqrt`` and transcendentals are inside
    it)."""
    if getattr(wa, "alpha_rows", None) is None:
        return None
    pred = getattr(table.anyhit, "inline_predicate", None)
    if pred is not None:
        return compile_predicate(pred)
    thr = getattr(table.anyhit, "alpha_threshold", None)
    return None if thr is None else float(thr)


def _walk_anyhit(anyhit) -> dict:
    """The walk's keyword for the in-walk any-hit test."""
    if anyhit is None:
        return {}
    if isinstance(anyhit, CompiledPredicate):
        return {"anyhit_pred": anyhit}
    return {"alpha_ref": anyhit}


def _route(table: ShaderTable, wa: WideArrays, packet: int):
    """('walk', in-walk any-hit) for the wave route through K1 / K2 (the
    threshold, the compiled predicate, or None), or ('pool', None) for
    the per-ray walk (K3); raises for what no route runs."""
    if packet != 0:
        inline = _inline_anyhit(table, wa)
        if table.anyhit is None or inline is not None:
            return "walk", inline
    if wa.width != 4:
        raise ValueError("the per-ray walk (packet_size=0, or an "
                         "any-hit shader without an in-walk marker) needs "
                         "4-wide tables: RTConfig(bvh_width=4)")
    if table.anyhit is not None and wa.tri_bits:
        raise ValueError("any-hit suspension needs the TLAS build "
                         "(RTConfig(flatten=False)): flattened builds "
                         "pack instance ids into leaf ids")
    return "pool", None


def _trace_pool(wa: WideArrays, sa: ShadeArrays, ctx: ShaderContext,
                table: ShaderTable, lanes, alive: torch.Tensor, payload,
                t_clamp: Optional[torch.Tensor] = None
                ) -> Tuple[Hits, torch.Tensor]:
    """Trace every pool ray with the per-ray walk (K3).  Dead lanes start
    done (a search limit of -1).  ``t_clamp`` bounds each ray's search
    (shadow rays).  With an any-hit shader the walk runs in rounds: K3
    to each ray's next candidate, ``shade_point`` there, the shader's
    actions, ``commit``, until no ray is suspended (one 1-byte read a
    round).  The walk updates the pool's own state in place (on a card, a
    lane that is done or suspended passes a round by reading its two
    flags).  Returns (Hits, total steps as a 0-dim tensor); a dead lane's
    ``dist`` is -1."""
    ox, oy, oz, dx, dy, dz = lanes
    clamp = (torch.full_like(ox, LARGE_FLOAT) if t_clamp is None
             else t_clamp)
    st = init_state_lanes(ox, oy, oz, dx, dy, dz)
    st = st._replace(best_t=torch.where(alive, clamp,
                                        torch.full_like(clamp, -1.0)),
                     done=~alive)
    visited0 = st.nodes_visited.clone()   # (the walks write the state)
    if table.anyhit is None:
        st = walk_lanes(wa, ox, oy, oz, dx, dy, dz, state=st)
        return lanes_hits(wa, st), (st.nodes_visited - visited0).sum()
    n_tri = sa.shade_rows.shape[0]
    n_inst = sa.inst_shade.shape[0]
    ray = RayLanes(ox, oy, oz, dx, dy, dz)
    pl = PayloadLanes(*payload)
    while True:
        st = walk_lanes(wa, ox, oy, oz, dx, dy, dz, state=st,
                        suspend=True)
        if not bool(st.suspended.any()):
            break
        sp = shade_point(
            sa, ox, oy, oz, dx, dy, dz, st.pend_t, st.pend_bx, st.pend_by,
            1.0 - st.pend_bx - st.pend_by,
            st.pend_tri.clamp(0, n_tri - 1).to(torch.int64),
            st.pend_inst.clamp(0, n_inst - 1).to(torch.int64))
        action = table.anyhit(ctx, sp, ray, pl)
        st = commit(st, torch.where(st.suspended, action.to(torch.int32),
                                    COMMIT_CONT))
    if not bool(st.done.all()):
        raise RuntimeError("the per-ray walk stopped at its step cap")
    return lanes_hits(wa, st), (st.nodes_visited - visited0).sum()


def _wave_pipeline(wa: WideArrays, sa: ShadeArrays, ctx: ShaderContext,
                   table: ShaderTable, light: LightArrays, lanes, pix, samp,
                   alive, max_depth: int, shadow: bool,
                   walk: Optional[Callable],
                   anyhit=None, pool: bool = False,
                   bilinear: bool = False, stage_limit: Optional[int] = None,
                   collect_stats: bool = False):
    """The bounce pipeline over one lane set: trace, shadow occlusion,
    shade, spawn — ``max_depth`` waves, with the merged shadow+bounce
    wave on the 8-wide route.  Traces go through ``walk`` (with the
    in-walk any-hit test ``anyhit`` of ``_route``: a threshold or a
    compiled predicate), or through ``_trace_pool`` (the per-ray
    walk, any-hit by suspension) when ``pool``.  ``collect_stats`` has
    every walk wave count (``PacketStats`` by wave name; the pool
    counts none); ``stage_limit`` stops after that stage (the module
    docstring).  Returns (rad_r, rad_g, rad_b, rays traced, walk steps,
    {wave: PacketStats}), the counts as 0-dim int64 tensors."""
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
    akw = _walk_anyhit(anyhit)
    wave_stats = {}

    def run(stage):
        return stage_limit is None or stage <= stage_limit

    def trace(name, o, d, act, t_max=None, **kw):
        """One wave through the walk, or through the pool; the pool's
        payload is this bounce's (read when called).  A counted walk
        wave's stats go under ``name``."""
        if pool:
            payload = ((thr_r + thr_g + thr_b) * (1.0 / 3.0), bounce_ct,
                        pix, samp)
            lanes6 = tuple(c.contiguous() for c in (*o.unbind(1),
                                                    *d.unbind(1)))
            return _trace_pool(wa, sa, ctx, table, lanes6, act, payload,
                               t_clamp=t_max)
        if collect_stats:
            h, st, kinds = walk(wa, o, d, active=act, t_max=t_max,
                                stats=True, **kw, **akw)
            wave_stats[name] = packet_stats(st, kinds)
        else:
            h, st = walk(wa, o, d, active=act, t_max=t_max, **kw, **akw)
        return h, st.sum()

    for bounce in range(max_depth):
        if not run(1 + 3 * bounce):
            break
        rays = rays + alive.sum()
        if pending is None:
            h, n_steps = trace(f"trace{bounce}", torch.stack([ox, oy, oz], 1),
                               torch.stack([dx, dy, dz], 1), alive)
            steps = steps + n_steps
        else:
            h, pending = pending, None
        dist, bx, by = h.dist, h.bx, h.by
        if shadow and not run(2 + 3 * bounce):
            break
        hit = alive & (dist < LARGE_FLOAT)
        miss = alive & ~hit
        tri_c = h.tri.clamp(0, n_tri - 1).to(torch.int64)
        inst_c = h.inst.clamp(0, n_inst - 1).to(torch.int64)
        # the JAX package's merged-wave rule under its default packets
        # (engine/wavefront.py:572-579): never at bounce 0
        merge = (shadow and bounce >= 1 and bounce + 1 < max_depth
                 and table.lit_independent_spawn and wa.width != 4
                 and not pool and stage_limit is None and not collect_stats)
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
                # (the pool traces them closest-hit, clamped: any hit
                # inside the clamp occludes)
                sh, sh_steps = trace(f"shadow{bounce}", sh_o, sh_d, sh_act,
                                     t_max=clamp, occlusion=True)
                steps = steps + sh_steps
                occluded = sh_act & (sh.dist < clamp)
        if not run(3 + 3 * bounce):
            break
        sp = shade_point(sa, ox, oy, oz, dx, dy, dz,
                         dist, bx, by, 1.0 - bx - by, tri_c, inst_c,
                         bilinear=bilinear)
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
            hm, m_steps = trace(
                None, torch.cat([sh_o, n_o]), torch.cat([sh_d, n_d]),
                torch.cat([sh_act, spawn]),
                t_max=torch.cat([clamp, torch.full_like(clamp, LARGE_FLOAT)]),
                occl_split=r)
            steps = steps + m_steps
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

    return rad_r, rad_g, rad_b, rays, steps, wave_stats


def _add_stats(acc: dict, ws: dict) -> dict:
    """Wave stats of two passes added wave by wave."""
    out = dict(acc)
    for k, v in ws.items():
        out[k] = out[k] + v if k in out else v
    return out


def frame_body(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
               light: LightArrays, width: int, height: int,
               max_depth: int = 2, spp: int = 1,
               table: Optional[ShaderTable] = None, seed: int = 0,
               shadow: bool = False, tile_w: int = 16, tile_h: int = 16,
               walk: Optional[Callable] = None,
               collect_stats: bool = False,
               stage_limit: Optional[int] = None,
               total_spp: Optional[int] = None, packet: int = 256,
               bilinear: bool = False, n_pix: Optional[int] = None,
               pix_offset: int = 0):
    """One frame, or the block of ``n_pix`` pixels from pixel
    ``pix_offset`` (the whole frame by default) -> ((3, n_pix) radiance
    planes in row-major pixel order, rays traced, walk steps), the counts
    as 0-dim int64 tensors on the tables' device, and with
    ``collect_stats`` a fourth item, the {wave: PacketStats} of the frame
    (summed over its sample passes).  A block keeps the frame's global
    pixel ids, jitter, sampler streams and camera rows, so a block of
    whole rows gives exactly the whole frame's pixels there (a block that
    is not whole rows takes the row-major lane order).
    ``walk`` defaults to ``default_walk(wa)`` (with ``collect_stats`` it
    must take ``stats=True``, as ``trace_packets`` and
    ``trace_packets_walk`` do).  ``stage_limit`` stops each pass after
    that stage (the module docstring).  ``total_spp`` is the
    stratification denominator, ``spp`` unless given: accumulation
    passes (``render_accum``) spread ``spp`` samples per pass over
    ``spp * n_passes`` strata.  ``packet=0``, or an any-hit shader the
    walks cannot run inside, takes the pool path (see the module
    docstring).  ``bilinear`` filters textures bilinearly.  Nothing here
    waits for the device, except the pool path's suspension rounds (one
    read a round)."""
    table = table or ShaderTable()
    route, anyhit = _route(table, wa, packet)
    walk = walk or default_walk(wa)
    dev = wa.device
    ctx = ShaderContext(
        shade=sa, light_pos=light.light_pos, light_color=light.light_color,
        ambient=light.ambient, background=light.background,
        max_depth=max_depth)

    total_spp = spp if total_spp is None else total_spp
    n_pix = width * height if n_pix is None else int(n_pix)
    rows = n_pix // width
    whole_rows = n_pix % width == 0 and pix_offset % width == 0
    # adaptive tile height: fall back through 8/4/2 so odd block heights
    # (1080) still get the tile-major lane order
    if width % tile_w == 0 and whole_rows:
        for th in (tile_h, 8, 4, 2):
            if rows % th == 0:
                tile_h = th
                break
    tiled = width % tile_w == 0 and whole_rows and rows % tile_h == 0
    opts = dict(bilinear=bilinear, stage_limit=stage_limit,
                collect_stats=collect_stats)
    if route == "pool":
        return _pool_frame(wa, sa, ctx, table, cam, light, width, height,
                           max_depth, spp, seed, shadow, tile_w, tile_h,
                           tiled, total_spp, opts, n_pix, pix_offset)
    lane = torch.arange(n_pix, dtype=torch.int64, device=dev)
    pxi, pyi, pix = _block_pixels(lane, width, tile_w, tile_h, tiled,
                                  pix_offset)
    alive = torch.ones(n_pix, dtype=torch.bool, device=dev)

    acc = [torch.zeros(n_pix, dtype=torch.float32, device=dev)
           for _ in range(3)]
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    wstats = {}
    for p in range(spp):
        # global sample index of this pass (u32 arithmetic)
        samp_val = (((int(seed) & _U32) * spp) + p) & _U32
        samp = torch.full((n_pix,), samp_val, dtype=torch.int64, device=dev)
        lanes6 = _camera_from_pix(cam, width, height, pxi, pyi, pix, samp,
                                  total_spp)
        rr, rg, rb, n_rays, n_steps, ws = _wave_pipeline(
            wa, sa, ctx, table, light, lanes6, pix, samp, alive,
            max_depth, shadow, walk, anyhit=anyhit, **opts)
        acc = [acc[0] + rr, acc[1] + rg, acc[2] + rb]
        rays = rays + n_rays
        steps = steps + n_steps
        wstats = _add_stats(wstats, ws)

    inv_spp = 1.0 / spp
    if tiled:
        img = torch.stack([
            _resolve_tiled(c * inv_spp, width, rows, tile_w, tile_h)
            .reshape(n_pix) for c in acc])
    else:
        img = torch.stack(acc) * inv_spp
    if collect_stats:
        return img, rays, steps, wstats
    return img, rays, steps


def _block_pixels(q: torch.Tensor, width: int, tile_w: int, tile_h: int,
                  tiled: bool, pix_offset: int):
    """Block lane (pixel) index ``q`` -> (px, py, global pixel id):
    tile-major from the block's first row, or row-major from
    ``pix_offset``."""
    if tiled:
        pxi, pyi = _tile_pixel_ids(q, width, tile_w, tile_h,
                                   pix_offset // width)
        return pxi, pyi, pyi * width + pxi
    p = pix_offset + q
    return p % width, p // width, p


def _pool_frame(wa: WideArrays, sa: ShadeArrays, ctx: ShaderContext,
                table: ShaderTable, cam: CameraArrays, light: LightArrays,
                width: int, height: int, max_depth: int, spp: int,
                seed: int, shadow: bool, tile_w: int, tile_h: int,
                tiled: bool, total_spp: int, opts: dict, n_pix: int,
                pix_offset: int):
    """The monolithic pool frame (the JAX ``frame_body``'s pool branch):
    the ``spp`` samples of every pixel of the block folded into one pool
    of lanes, a pixel's samples adjacent, lane k's sample index ``seed *
    spp + k % spp``; one bounce pipeline over the pool, every wave
    through the per-ray walk; the samples averaged per pixel."""
    dev = wa.device
    n_real = n_pix * spp
    lane = torch.arange(n_real, dtype=torch.int64, device=dev)
    samp = ((int(seed) & _U32) * spp + lane % spp) & _U32
    pxi, pyi, pix = _block_pixels(lane // spp, width, tile_w, tile_h, tiled,
                                  pix_offset)
    lanes6 = _camera_from_pix(cam, width, height, pxi, pyi, pix, samp,
                              total_spp)
    alive = torch.ones(n_real, dtype=torch.bool, device=dev)
    rr, rg, rb, rays, steps, ws = _wave_pipeline(
        wa, sa, ctx, table, light, lanes6, pix, samp, alive, max_depth,
        shadow, None, pool=True, **opts)
    if tiled:
        img = torch.stack([
            _resolve_tiled(c, width, n_pix // width, tile_w, tile_h, spp)
            .reshape(n_pix) for c in (rr, rg, rb)])
    else:
        img = torch.stack([c.reshape(n_pix, spp).mean(1)
                           for c in (rr, rg, rb)])
    if opts["collect_stats"]:
        return img, rays, steps, ws
    return img, rays, steps


def render_wavefront(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
                     light: LightArrays, width: int, height: int,
                     max_depth: int = 2, spp: int = 1,
                     table: Optional[ShaderTable] = None, seed: int = 0,
                     packet: int = 256, shadow: bool = False,
                     tile_w: int = 16, tile_h: int = 16,
                     bilinear: bool = False,
                     walk: Optional[Callable] = None):
    """The whole frame -> ((H, W, 3) radiance, rays traced, walk steps),
    on the tables' device; nothing here waits for it."""
    img, rays, steps = frame_body(
        wa, sa, cam, light, width, height, max_depth=max_depth, spp=spp,
        table=table, seed=seed, shadow=shadow, tile_w=tile_w, tile_h=tile_h,
        walk=walk, packet=packet, bilinear=bilinear)
    return img.reshape(3, height, width).permute(1, 2, 0), rays, steps


def render_frame(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
                 light: LightArrays, width: int, height: int,
                 max_depth: int = 2, spp: int = 1,
                 table: Optional[ShaderTable] = None, seed: int = 0,
                 packet: int = 256, tile_w: int = 16, tile_h: int = 16,
                 shadow: bool = False, bilinear: bool = False,
                 walk: Optional[Callable] = None):
    """``render_wavefront`` under the JAX package's stable name."""
    return render_wavefront(
        wa, sa, cam, light, width, height, max_depth=max_depth, spp=spp,
        table=table, seed=seed, packet=packet, shadow=shadow, tile_w=tile_w,
        tile_h=tile_h, bilinear=bilinear, walk=walk)


def render_burst(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
                 light: LightArrays, width: int, height: int,
                 n_frames: int = 16, seed0: int = 0, max_depth: int = 2,
                 spp: int = 1, table: Optional[ShaderTable] = None,
                 packet: int = 256, shadow: bool = False, tile_w: int = 16,
                 tile_h: int = 16, walk: Optional[Callable] = None
                 ) -> torch.Tensor:
    """``n_frames`` frames (seeds ``seed0``..) -> the exact total of rays
    traced, a 0-dim int64 tensor on the tables' device; no image.  The
    JAX function also folds a zero made from the radiance into its count
    so that XLA keeps the shading; PyTorch runs every operation it is
    given, so the port adds none.  Nothing here waits for the device."""
    total = torch.zeros((), dtype=torch.int64, device=wa.device)
    for i in range(n_frames):
        _, rays, _ = frame_body(
            wa, sa, cam, light, width, height, max_depth=max_depth, spp=spp,
            table=table, seed=seed0 + i, shadow=shadow, tile_w=tile_w,
            tile_h=tile_h, walk=walk, packet=packet)
        total = total + rays
    return total


def render_accum(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
                 light: LightArrays, width: int, height: int,
                 n_passes: int = 4, seed0: int = 0, max_depth: int = 2,
                 spp: int = 1, table: Optional[ShaderTable] = None,
                 shadow: bool = False, tile_w: int = 16, tile_h: int = 16,
                 walk: Optional[Callable] = None, packet: int = 256):
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
            tile_h=tile_h, walk=walk, total_spp=spp * n_passes,
            packet=packet)
        img, rays, steps = img + f_img, rays + f_rays, steps + f_steps
    out = (img * (1.0 / n_passes)).reshape(3, height, width)
    return out.permute(1, 2, 0), rays, steps


def render_profile_burst(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
                         light: LightArrays, width: int, height: int,
                         n_frames: int = 8, seed0: int = 0,
                         max_depth: int = 2, spp: int = 1,
                         table: Optional[ShaderTable] = None,
                         shadow: bool = False, tile_w: int = 16,
                         tile_h: int = 16, walk: Optional[Callable] = None,
                         stage_limit: int = 0, packet: int = 256
                         ) -> torch.Tensor:
    """``n_frames`` frames (seeds ``seed0``..) each stopped after
    ``stage_limit`` (0 = camera only; 1 + 3k / 2 + 3k / 3 + 3k = bounce
    k's trace / shadow / shade): the total rays as a 0-dim int64 tensor.
    Timing consecutive limits attributes the frame's time to its stages
    (``WavefrontRenderer.frame_profile``).  Nothing here waits for the
    device."""
    total = torch.zeros((), dtype=torch.int64, device=wa.device)
    for i in range(n_frames):
        _, rays, _ = frame_body(
            wa, sa, cam, light, width, height, max_depth=max_depth, spp=spp,
            table=table, seed=seed0 + i, shadow=shadow, tile_w=tile_w,
            tile_h=tile_h, walk=walk, stage_limit=stage_limit, packet=packet)
        total = total + rays
    return total


def render_stats(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
                 light: LightArrays, width: int, height: int,
                 max_depth: int = 2, spp: int = 1,
                 table: Optional[ShaderTable] = None, seed: int = 0,
                 shadow: bool = False, tile_w: int = 16, tile_h: int = 16,
                 walk: Optional[Callable] = None, packet: int = 256):
    """One frame with per-wave statistics: (rays, steps, {wave:
    PacketStats}), on the tables' device (the whole-frame PerfStats of
    the RT unit, per wave: primary, shadow and bounce k)."""
    _, rays, steps, wstats = frame_body(
        wa, sa, cam, light, width, height, max_depth=max_depth, spp=spp,
        table=table, seed=seed, shadow=shadow, tile_w=tile_w, tile_h=tile_h,
        walk=walk, collect_stats=True, packet=packet)
    return rays, steps, wstats


class _Pool(NamedTuple):
    """The chunked frame's pool: rays, liveness, radiance, throughput,
    bounce, pixel and the lane's slot in the pixel-major order."""

    ox: torch.Tensor; oy: torch.Tensor; oz: torch.Tensor
    dx: torch.Tensor; dy: torch.Tensor; dz: torch.Tensor
    alive: torch.Tensor
    rad_r: torch.Tensor; rad_g: torch.Tensor; rad_b: torch.Tensor
    thr: torch.Tensor
    bounce: torch.Tensor
    pix: torch.Tensor
    slot: torch.Tensor


def _gen_pool(cam: CameraArrays, width: int, height: int, spp: int
              ) -> _Pool:
    """Pixel-major camera rays of every sample (lane k: pixel k // spp,
    sample index k % spp), all live."""
    n_real = width * height * spp
    dev = cam.pos.device
    lane = torch.arange(n_real, dtype=torch.int64, device=dev)
    samp = lane % spp
    pix = lane // spp
    ox, oy, oz, dx, dy, dz = _camera_from_pix(
        cam, width, height, pix % width, pix // width, pix, samp, spp)
    zero = torch.zeros(n_real, dtype=torch.float32, device=dev)
    return _Pool(ox, oy, oz, dx, dy, dz,
                 torch.ones(n_real, dtype=torch.bool, device=dev),
                 zero, zero.clone(), zero.clone(), torch.ones_like(zero),
                 torch.zeros(n_real, dtype=torch.int32, device=dev), pix,
                 lane)


def _compact_pool(pool: _Pool) -> _Pool:
    """Live lanes first, in order (a stable sort on liveness)."""
    order = torch.argsort((~pool.alive).to(torch.int8), stable=True)
    return _Pool(*(a[order] for a in pool))


def _split_pool(pool: _Pool, n_alive: int):
    """The live prefix's ray lanes, the part of the pool a wave traces."""
    return tuple(a[:n_alive].contiguous() for a in pool[:6]), \
        pool.alive[:n_alive]


def _trace_prefix(wa: WideArrays, pool: _Pool, n_alive: int) -> Hits:
    """Closest hits of the live prefix by the per-ray walk; the rest of
    the pool reports a miss."""
    lanes, alive = _split_pool(pool, n_alive)
    st = init_state_lanes(*lanes)
    st = st._replace(best_t=torch.where(alive, st.best_t,
                                        torch.full_like(st.best_t, -1.0)),
                     done=~alive)
    h = lanes_hits(wa, walk_lanes(wa, *lanes, state=st))
    r = pool.ox.shape[0]

    def pad(a, fill):
        return torch.cat([a, torch.full((r - n_alive,), fill, dtype=a.dtype,
                                        device=a.device)])

    return Hits(dist=pad(h.dist, LARGE_FLOAT), bx=pad(h.bx, 0.0),
                by=pad(h.by, 0.0), bz=pad(h.bz, 1.0), tri=pad(h.tri, 0),
                inst=pad(h.inst, 0))


def _shade_pool_default(sa: ShadeArrays, light: LightArrays,
                        max_depth: int, pool: _Pool, h: Hits) -> _Pool:
    """Default-table shading of the whole pool (as the JAX program: one
    luminance throughput, the pixel id as the sample index)."""
    ctx = ShaderContext(
        shade=sa, light_pos=light.light_pos, light_color=light.light_color,
        ambient=light.ambient, background=light.background,
        max_depth=max_depth)
    table = ShaderTable()
    hit = pool.alive & (h.dist < LARGE_FLOAT)
    miss = pool.alive & ~hit
    n_tri, n_inst = sa.shade_rows.shape[0], sa.inst_shade.shape[0]
    sp = shade_point(sa, pool.ox, pool.oy, pool.oz, pool.dx, pool.dy,
                     pool.dz, h.dist, h.bx, h.by, 1.0 - h.bx - h.by,
                     h.tri.clamp(0, n_tri - 1).to(torch.int64),
                     h.inst.clamp(0, n_inst - 1).to(torch.int64))
    ray = RayLanes(pool.ox, pool.oy, pool.oz, pool.dx, pool.dy, pool.dz)
    thr = pool.thr
    pl = PayloadLanes(thr, pool.bounce, pool.pix, pool.pix)
    co = table.closest(ctx, sp, ray, pl)
    mr, mg, mb = table.miss(ctx, ray, pl)
    zero = torch.zeros_like(thr)
    rad = [c + torch.where(hit, thr * a, torch.where(miss, thr * m, zero))
           for c, a, m in ((pool.rad_r, co.add_r, mr),
                           (pool.rad_g, co.add_g, mg),
                           (pool.rad_b, co.add_b, mb))]
    spawn = hit & co.spawn
    return _Pool(
        torch.where(spawn, co.sox, pool.ox), torch.where(spawn, co.soy, pool.oy),
        torch.where(spawn, co.soz, pool.oz), torch.where(spawn, co.sdx, pool.dx),
        torch.where(spawn, co.sdy, pool.dy), torch.where(spawn, co.sdz, pool.dz),
        spawn, *rad, torch.where(hit, thr * co.mul_r, thr),
        torch.where(spawn, pool.bounce + 1, pool.bounce), pool.pix,
        pool.slot)


def _resolve(pool: _Pool, n_pix: int, spp: int) -> torch.Tensor:
    """(n_pix, 3) image: lanes back to slot order, samples averaged."""
    inv = torch.argsort(pool.slot, stable=True)
    return torch.stack([c[inv].reshape(n_pix, spp).mean(1)
                        for c in (pool.rad_r, pool.rad_g, pool.rad_b)], -1)


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
        8- and 16-wide builds are fused (the JAX package's default), and
        a marked any-hit shader (``alpha_test_anyhit``,
        ``stateless_anyhit``) gets the ``with_alpha`` tables.  ``walk`` is
        the trace function, ``default_walk`` of the tables when None; a
        plain PyTorch version (``trace_packets_ref`` for 8- and 16-wide,
        ``trace_packets_walk_ref`` for 4-wide) forces the plain route on a
        card.  A shader and build no
        route runs (``frame_body``'s routing) raise here."""
        if isinstance(device, (list, tuple)):
            raise NotImplementedError(
                "a renderer lives on one device, as the JAX class does: "
                "render over several devices with parallel.tiles (image row "
                "blocks: render_tiled_wavefront) or parallel.shards (scene "
                "shards: render_sharded), one process per device")
        device = torch.device(device)
        cfg = config or RTConfig()
        table = table or ShaderTable()
        wa = WideArrays.from_scene(sb_host, width=cfg.bvh_width)
        if wa.width != 4:
            wa = wa.fuse()
        if (getattr(table.anyhit, "alpha_threshold", None) is not None
                or getattr(table.anyhit, "inline_predicate", None)
                is not None):
            wa = wa.with_alpha(sb_host)
        _route(table, wa, cfg.packet_size)
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
               seed: int, bilinear: bool = False):
        return frame_body(
            self.wa, self.sa, CameraArrays.from_camera(cam, self.device),
            LightArrays.from_params(params, self.device), w, h,
            max_depth=params.max_depth, spp=params.spp,
            table=self._table_for(params), seed=seed, shadow=params.shadow,
            tile_w=self.config.tile_w, tile_h=self.config.tile_h,
            walk=self.walk, packet=self.config.packet_size,
            bilinear=bilinear)

    @staticmethod
    def _to_image(img: torch.Tensor, w: int, h: int) -> np.ndarray:
        return img.reshape(3, h, w).permute(1, 2, 0).cpu().numpy()

    def render(self, cam: Camera, params: RenderParams,
               width: Optional[int] = None, height: Optional[int] = None,
               mode: str = "auto") -> Tuple[np.ndarray, int]:
        """One frame (seed 0) -> ((H, W, 3) float32 image, rays traced).

        ``mode``: "fused" (= "auto") is ``frame_body``; "chunked" is the
        JAX host-orchestrated frame (``_render_chunked``), which shades
        with the default table and no shadows only: other tables or
        shadows warn and render fused, as the JAX method does."""
        w = width or self.config.width
        h = height or self.config.height
        if mode not in ("auto", "fused", "chunked"):
            raise ValueError(f"unknown render mode {mode!r}")
        if mode == "chunked":
            if self._table_for(params) != ShaderTable() or params.shadow:
                warnings.warn(
                    "mode='chunked' supports only the default shader table "
                    "without shadows; falling back to mode='fused'",
                    stacklevel=2)
            else:
                return self._render_chunked(cam, params, w, h)
        img, rays, _ = self._frame(
            cam, params, w, h, 0,
            bilinear=self.config.tex_filter == "bilinear")
        return self._to_image(img, w, h), int(rays.item())

    def _render_chunked(self, cam: Camera, params: RenderParams, w: int,
                        h: int) -> Tuple[np.ndarray, int]:
        """The JAX ``_render_chunked``: a pixel-major pool of every sample,
        compacted live-first before each bounce (carrying each lane's
        slot), the live prefix traced by the per-ray walk (auto-accept),
        shaded with the default table, and resolved by slot.  The JAX
        method traces the prefix in 4096-lane chunks; the port's pool
        runs whole.  Waits for the device once a bounce (the live
        count)."""
        light = LightArrays.from_params(params, self.device)
        pool = _gen_pool(CameraArrays.from_camera(cam, self.device), w, h,
                         params.spp)
        n_alive = w * h * params.spp
        nrays = 0
        for bounce in range(params.max_depth):
            if bounce > 0:
                with maybe_span("compact", bounce=bounce, alive=n_alive):
                    pool = _compact_pool(pool)
            nrays += n_alive
            if n_alive == 0:
                break
            with maybe_span("trace", bounce=bounce, alive=n_alive):
                hits = _trace_prefix(self.wa, pool, n_alive)
            with maybe_span("shade", bounce=bounce):
                pool = _shade_pool_default(self.sa, light, params.max_depth,
                                           pool, hits)
            if bounce + 1 < params.max_depth:
                n_alive = int(pool.alive.sum().item())
        img = _resolve(pool, w * h, params.spp)
        return img.reshape(h, w, 3).cpu().numpy(), nrays

    def perf_trace(self, cam: Camera, params: RenderParams,
                   width: Optional[int] = None,
                   height: Optional[int] = None) -> dict:
        """Whole-frame walk statistics (the RT unit's PerfStats): one
        frame (seed 0) with ``PacketStats`` counted in every walk wave —
        primary, bounce and shadow waves — as a dict with the JAX
        method's keys: ``rays``, ``steps``, ``packet_size`` (``WARP``:
        the port's packets are warps) and per wave ``steps``,
        ``packet_steps``, ``ray_steps``, ``rays_per_live_packet``,
        ``int_steps``, ``tri_steps``, ``ins_steps``.  Reads the device
        once, at the end."""
        w = width or self.config.width
        h = height or self.config.height
        rays, steps, wstats = render_stats(
            self.wa, self.sa, CameraArrays.from_camera(cam, self.device),
            LightArrays.from_params(params, self.device), w, h,
            max_depth=params.max_depth, spp=params.spp,
            table=self._table_for(params), shadow=params.shadow,
            tile_w=self.config.tile_w, tile_h=self.config.tile_h,
            walk=self.walk, packet=self.config.packet_size)
        names = sorted(wstats)
        vals = torch.stack([rays, steps] + [
            f for n in names for f in wstats[n]]).tolist()
        out = dict(rays=vals[0], steps=vals[1], packet_size=WARP)
        k = len(PacketStats._fields)
        for i, name in enumerate(names):
            st = PacketStats(*vals[2 + k * i: 2 + k * (i + 1)])
            out[name] = dict(
                steps=st.steps, packet_steps=st.packet_steps,
                ray_steps=st.ray_steps,
                rays_per_live_packet=round(
                    st.ray_steps / max(st.packet_steps, 1), 2),
                int_steps=st.int_steps, tri_steps=st.tri_steps,
                ins_steps=st.ins_steps)
        return out

    def frame_profile(self, cam: Camera, params: RenderParams,
                      width: Optional[int] = None,
                      height: Optional[int] = None,
                      n_frames: int = 8) -> list:
        """Wall-clock ms per stage: times bursts of ``n_frames`` frames
        stopped after each stage in turn (camera -> +trace0 -> +shadow0
        -> +shade0 -> +trace1 ...), each after a warm-up burst, by the
        host clock around work that ends in a read of the device, and
        reports the deltas: [{stage, cum_ms, ms}], the JAX method's
        labels and keys."""
        w = width or self.config.width
        h = height or self.config.height
        ca = CameraArrays.from_camera(cam, self.device)
        light = LightArrays.from_params(params, self.device)
        table = self._table_for(params)
        labels = ["camera"]
        for k in range(params.max_depth):
            labels.append(f"trace{k}")
            if params.shadow:
                labels.append(f"shadow{k}")
            labels.append(f"shade{k}")

        def run(limit, seed0):
            return int(render_profile_burst(
                self.wa, self.sa, ca, light, w, h, n_frames=n_frames,
                seed0=seed0, max_depth=params.max_depth, spp=params.spp,
                table=table, shadow=params.shadow,
                tile_w=self.config.tile_w, tile_h=self.config.tile_h,
                walk=self.walk, stage_limit=limit,
                packet=self.config.packet_size).item())

        stage_ids = []
        for lab in labels:
            if lab == "camera":
                stage_ids.append(0)
            else:
                k = int(lab[-1])
                op = {"trace": 1, "shadow": 2, "shade": 3}[lab[:-1]]
                stage_ids.append(op + 3 * k)
        out = []
        prev_ms = 0.0
        for lab, sid in zip(labels, stage_ids):
            run(sid, 0)  # warm-up
            t0 = time.perf_counter()
            run(sid, n_frames)
            ms = (time.perf_counter() - t0) * 1e3 / n_frames
            out.append(dict(stage=lab, cum_ms=round(ms, 2),
                            ms=round(ms - prev_ms, 2)))
            prev_ms = ms
        return out

    def scope_trace(self, cam: Camera, params: RenderParams,
                    width: Optional[int] = None,
                    height: Optional[int] = None,
                    n_frames: int = 4) -> Tracer:
        """One Perfetto timeline of ``frame_profile``'s stage ms (spans
        laid end to end on a synthetic frame timeline) and
        ``perf_trace``'s per-wave counters (counter tracks stepped at
        each wave's span, the wave's stats in its span's args).  Returns
        a ``Tracer``; ``.save(path)`` writes it."""
        tr = Tracer()
        prof = self.frame_profile(cam, params, width, height,
                                  n_frames=n_frames)
        stats = self.perf_trace(cam, params, width, height)
        tr.instant("frame", rays=stats.get("rays"),
                   steps=stats.get("steps"),
                   packet_size=stats.get("packet_size"))
        t = 0.0
        for row in prof:
            dur = max(float(row["ms"]), 0.0) * 1e3  # us
            st = stats.get(row["stage"])
            tr.complete_at(row["stage"], t, dur, **(st or {}))
            if st:
                # counter tracks step at the wave's start
                tr.counter_at("loop_iterations", t, value=st["steps"])
                tr.counter_at("live_packet_steps", t,
                              value=st["packet_steps"])
                tr.counter_at("live_ray_steps", t, value=st["ray_steps"])
                tr.counter_at("rays_per_live_packet", t,
                              value=st["rays_per_live_packet"])
                tr.counter_at("node_kind_mix", t,
                              internal=st["int_steps"],
                              triangle=st["tri_steps"],
                              instance=st["ins_steps"])
            t += dur
        return tr

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
        n = int(render_burst(
            self.wa, self.sa, CameraArrays.from_camera(cam, self.device),
            LightArrays.from_params(params, self.device), w, h,
            n_frames=n_frames, seed0=seed0, max_depth=params.max_depth,
            spp=params.spp, table=self._table_for(params),
            packet=self.config.packet_size, shadow=params.shadow,
            tile_w=self.config.tile_w, tile_h=self.config.tile_h,
            walk=self.walk).item())
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
            tile_h=self.config.tile_h, walk=self.walk,
            packet=self.config.packet_size)
        return img.cpu().numpy(), int(rays.item())
