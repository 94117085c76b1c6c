"""Shader binding table: batch shaders over (R,) lanes (port of
``vortex_rt_tpu/engine/shaders.py``: the Whitted shaders, the
path-traced closest shader and the any-hit shaders).

Shader signatures (all inputs/outputs are (R,) lanes):

closest(ctx, sp, ray, payload) -> ClosestOut
miss(ctx, ray, payload) -> (add_r, add_g, add_b)   [terminates the ray]
anyhit(ctx, sp, ray, payload) -> (R,) int32 commit action
    (COMMIT_CONT / COMMIT_ACCEPT / COMMIT_TERM at the candidate hit
    ``sp``; None in the table means every hit is accepted)

``alpha_test_anyhit(thr)`` and ``stateless_anyhit(pred)`` carry markers
(``alpha_threshold``, ``inline_predicate``) that tell the renderer the
decision is a pure function of the candidate: the alpha test then runs
inside K1 / K2 (``alpha_ref``), and the predicate, compiled by
``ops/anyhit_pred.py``, inside their predicate modes (``anyhit_pred``).
Every any-hit shader also runs through
the suspension protocol of the per-ray walk (K3), which is what an
unmarked (possibly stateful) shader always takes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from vortex_rt_tpu_torch.ops.shade_lanes import (
    ShadeArrays, ShadePoint, diffuse_lighting_lanes, reflect_lanes,
)
from vortex_rt_tpu_torch.utils import sampling
from vortex_rt_tpu_torch.utils.config import COMMIT_ACCEPT, COMMIT_CONT


class ShaderContext(NamedTuple):
    """Scene tables + lighting constants handed to every shader."""

    shade: ShadeArrays
    light_pos: torch.Tensor      # (3,)
    light_color: torch.Tensor    # (3,)
    ambient: torch.Tensor        # (3,)
    background: torch.Tensor     # (3,)
    max_depth: int


class RayLanes(NamedTuple):
    ox: torch.Tensor; oy: torch.Tensor; oz: torch.Tensor
    dx: torch.Tensor; dy: torch.Tensor; dz: torch.Tensor


class PayloadLanes(NamedTuple):
    """Per-ray payload: throughput, bounce, pixel and global sample index."""

    throughput: torch.Tensor  # (R,) luminance throughput (RGB in engine)
    bounce: torch.Tensor      # (R,) i32
    pixel: torch.Tensor       # (R,) i64 pixel id
    sample: torch.Tensor      # (R,) i64 global sample index (u32 value)


class ClosestOut(NamedTuple):
    """What a closest-hit shader contributes back to the engine."""

    add_r: torch.Tensor; add_g: torch.Tensor; add_b: torch.Tensor
    mul_r: torch.Tensor; mul_g: torch.Tensor; mul_b: torch.Tensor
    spawn: torch.Tensor            # (R,) bool: emit a secondary ray
    sox: torch.Tensor; soy: torch.Tensor; soz: torch.Tensor
    sdx: torch.Tensor; sdy: torch.Tensor; sdz: torch.Tensor


def default_closest(ctx: ShaderContext, sp: ShadePoint, ray: RayLanes,
                    payload: PayloadLanes) -> ClosestOut:
    """Attenuated diffuse + reflective bounce; remaining throughput goes
    to the environment when not bouncing."""
    dr, dg, db = diffuse_lighting_lanes(
        sp, ctx.light_pos, ctx.light_color, ctx.ambient)
    refl = sp.reflectivity
    one_m = 1.0 - refl
    spawn = (refl > 0.0) & (payload.bounce + 1 < ctx.max_depth)
    zero = torch.zeros_like(refl)
    bg_r = torch.where(spawn, zero, refl * ctx.background[0])
    bg_g = torch.where(spawn, zero, refl * ctx.background[1])
    bg_b = torch.where(spawn, zero, refl * ctx.background[2])
    rx, ry, rz = reflect_lanes(ray.dx, ray.dy, ray.dz, sp.nx, sp.ny, sp.nz)
    return ClosestOut(
        add_r=one_m * dr + bg_r,
        add_g=one_m * dg + bg_g,
        add_b=one_m * db + bg_b,
        mul_r=refl, mul_g=refl, mul_b=refl,
        spawn=spawn,
        sox=sp.px + rx * 1e-3, soy=sp.py + ry * 1e-3, soz=sp.pz + rz * 1e-3,
        sdx=rx, sdy=ry, sdz=rz,
    )


def pathtrace_closest(ctx: ShaderContext, sp: ShadePoint, ray: RayLanes,
                      payload: PayloadLanes) -> ClosestOut:
    """Path-traced closest hit: next-event-estimated direct light
    (shadow-gated via sp.lit, same as the Whitted shader), then a sampled
    continuation — a mirror ray where reflectivity > 0, else a
    cosine-weighted diffuse bounce with the albedo as throughput weight
    (BRDF*cos/pdf == albedo for Lambertian).

    Randoms are counter-based (utils.sampling) on (pixel, global sample
    index, bounce): frame seeds fold into ``payload.sample``, so
    ``render_accum`` (k passes x s spp) draws the sample set of one
    spp = k*s frame.  The ambient term fires only at the primary hit (it
    approximates the indirect light the later bounces compute).  The
    continuation does not read ``sp.lit``."""
    zero3 = torch.zeros(3, dtype=torch.float32, device=sp.px.device)
    dr, dg, db = diffuse_lighting_lanes(sp, ctx.light_pos, ctx.light_color,
                                        zero3)
    one = torch.ones_like(sp.px)
    zero = torch.zeros_like(sp.px)
    amb = torch.where(payload.bounce == 0, one, zero)
    dr = dr + amb * ctx.ambient[0] * sp.color_r
    dg = dg + amb * ctx.ambient[1] * sp.color_g
    db = db + amb * ctx.ambient[2] * sp.color_b

    refl = sp.reflectivity
    mirror = refl > 0.0
    u1, u2 = sampling.sample2(payload.pixel, payload.sample, payload.bounce,
                              0, dim=1)
    hx, hy, hz = sampling.cosine_hemisphere(sp.nx, sp.ny, sp.nz, u1, u2)
    rx, ry, rz = reflect_lanes(ray.dx, ray.dy, ray.dz, sp.nx, sp.ny, sp.nz)
    sdx = torch.where(mirror, rx, hx)
    sdy = torch.where(mirror, ry, hy)
    sdz = torch.where(mirror, rz, hz)
    mul_r = torch.where(mirror, refl, sp.color_r)
    mul_g = torch.where(mirror, refl, sp.color_g)
    mul_b = torch.where(mirror, refl, sp.color_b)
    spawn = payload.bounce + 1 < ctx.max_depth
    # Russian roulette from the second bounce on: survive with p = max
    # throughput component (clipped), compensate by 1/p.  Counter-based
    # draw (dim=2), so every route replays the same kill decisions.
    u3, _ = sampling.sample2(payload.pixel, payload.sample, payload.bounce,
                             0, dim=2)
    p_srv = torch.clamp(torch.maximum(mul_r, torch.maximum(mul_g, mul_b)),
                        0.1, 0.95)
    rr = payload.bounce >= 1
    survive = ~rr | (u3 < p_srv)
    inv_p = torch.where(rr, 1.0 / p_srv, one)
    one_m = 1.0 - refl
    return ClosestOut(
        add_r=one_m * dr, add_g=one_m * dg, add_b=one_m * db,
        mul_r=mul_r * inv_p, mul_g=mul_g * inv_p, mul_b=mul_b * inv_p,
        spawn=spawn & survive,
        sox=sp.px + sdx * 1e-3, soy=sp.py + sdy * 1e-3,
        soz=sp.pz + sdz * 1e-3,
        sdx=sdx, sdy=sdy, sdz=sdz,
    )


def default_miss(ctx: ShaderContext, ray: RayLanes, payload: PayloadLanes):
    """Payload color = background, terminate."""
    r = torch.ones_like(ray.dx)
    return (ctx.background[0] * r, ctx.background[1] * r,
            ctx.background[2] * r)


def _luminance(sp: ShadePoint) -> torch.Tensor:
    return 0.2126 * sp.color_r + 0.7152 * sp.color_g + 0.0722 * sp.color_b


def alpha_test_anyhit(threshold: float = 0.5):
    """Texture alpha cutout: the candidate hit's alpha is the luminance of
    its surface colour (``sp.color_*``, the point-sampled texel at the
    candidate's uv, or the material's diffuse colour); below
    ``threshold`` the hit is rejected (COMMIT_CONT: the walk goes on past
    the surface), else accepted.

    Marked with ``alpha_threshold``: the renderer evaluates this exact
    test inside K1 or K2 (``alpha_ref``) over the ``with_alpha`` tables,
    with the same accepted hits; through the per-ray engine
    (``RTConfig(packet_size=0)``) it runs this callable by suspension."""

    def shader(ctx: ShaderContext, sp: ShadePoint, ray: RayLanes,
               payload: PayloadLanes) -> torch.Tensor:
        keep = ~(_luminance(sp) < threshold)
        return torch.where(keep, COMMIT_ACCEPT, COMMIT_CONT).to(torch.int32)

    shader.alpha_threshold = float(threshold)
    return shader


def stateless_anyhit(pred: Callable, name: str = "stateless"):
    """Any-hit shader from a stateless per-candidate predicate
    ``pred(u, v, alpha) -> keep`` over the candidate's interpolated uv
    (``uv1*bx + uv2*by + uv0*bz``) and surface alpha (the luminance
    ``alpha_test_anyhit`` reads): keep=False rejects the candidate
    (COMMIT_CONT), keep=True accepts it.  ``pred`` takes and returns
    torch tensors, elementwise.

    Marked with ``inline_predicate``.  As the JAX package inlines the
    predicate into its traversal loop, the renderer compiles it
    (``ops.anyhit_pred.compile_predicate``, which raises
    ``NotImplementedError`` for an op outside its set) and runs it inside
    K1's or K2's predicate mode over the ``with_alpha`` tables, flat or
    TLAS; through the per-ray engine (``RTConfig(packet_size=0)``, TLAS
    builds) this callable runs by suspension, with the same hits."""

    def shader(ctx: ShaderContext, sp: ShadePoint, ray: RayLanes,
               payload: PayloadLanes) -> torch.Tensor:
        keep = pred(sp.u, sp.v, _luminance(sp))
        return torch.where(keep, COMMIT_ACCEPT, COMMIT_CONT).to(torch.int32)

    shader.inline_predicate = pred
    shader.__name__ = f"stateless_anyhit_{name}"
    return shader


@dataclasses.dataclass(frozen=True)
class ShaderTable:
    """The shader binding table.  ``anyhit=None`` accepts every hit (the
    reference's shipped any-hit shader) and keeps the walk free of
    suspension."""

    closest: Callable = default_closest
    miss: Callable = default_miss
    anyhit: Optional[Callable] = None
    # the closest shader's continuation (spawn, sox..sdz, mul) must not
    # depend on sp.lit for the merged shadow+bounce wave (the occlusion
    # result then only selects between lit=0/1 terms); set False for a
    # shader whose spawn reads sp.lit and the frame keeps sequential
    # shadow -> shade -> bounce waves
    lit_independent_spawn: bool = True
