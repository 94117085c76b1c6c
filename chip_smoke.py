#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vortex_rt_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's three CUDA kernels from the sources in this checkout
(one nvcc per source, all started together), holds each against its
plain PyTorch version on the card (hits and per-ray steps identical),
drives the port's entry points through them, and measures them: kernel
times are device times from CUDA events, beside each kernel's bound
(``vortex_rt_tpu_torch/tools/walk_bounds.py``).  Phases (each raises,
and so exits non-zero, on failure):

1. device: a CUDA device is required; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: ``csrc/packet_walk.cu`` (K2), ``csrc/traverse_packet.cu`` (K1)
   and ``csrc/hbm_walk.cu`` (K7), with their build times;
3. K2 against its plain version: config-2 camera rays at 64x64 on the
   flat 4-wide build and on a TLAS build (two instances), in four modes
   (closest, 1/3 inactive, half t_max-clamped, shadow-ray occlusion);
4. one config-2 frame at 64x64 through K2 and through the plain version
   (4-wide route): equal ray counts, images within 1e-5;
5. K1 against its plain version: config-2 camera rays at 64x64 on the
   8-wide fused build, in five modes (the four above and a mixed
   ``occl_split`` wave of shadow and camera rays);
6. a 64x64 spp-2 frame at depth 3 (reflective sphere) through K1 and
   through the plain version: equal ray counts, images within 1e-5, K1
   launched 5 times per sample pass, one of them the mixed wave;
7. config 2 as ``bench.py`` renders it (8-wide fused, 512x512, spp 2,
   depth 2, shadow rays): the main path's run (launch counts reset
   before it), checked against the plain version; 3 x 16-frame bursts
   timed after a warm-up (Mrays/s as bench.py defines it); one primary
   wave timed through K1 (bare kernel call, CUDA events) and plain, with
   its bound.  Then one frame at depth 3 with a reflective sphere
   (merged wave with live bounce lanes) against the plain route;
8. config 2 at 512x512 through the 4-wide route (K2's path, launch counts
   reset before it), against the plain route; one primary wave timed
   through K2 (the bare kernel call, CUDA events) and plain, with its
   bound;
8b. the native host builder: compiles ``csrc/builder.cpp``, builds the
   blob and the atrium with it, prints build seconds beside the NumPy
   build's for the blob, and checks the native-built blob against the
   NumPy-built one by K1's hits on a crop of camera rays (same hit mask,
   same ``tri``, ``dist`` within 2e-4 relative).  The phases below use
   the native builds;
9. the scale scene, ``blob(n=187)`` at 1920x1080, spp 2, depth 2, shadow
   rays, Whitted, 8-wide: one frame timed after a warm-up, table bytes, peak
   memory; then the frame's four waves of one sample pass (primary,
   shadow 0, bounce 1, shadow 1) captured, K1 checked against the plain
   version on each and timed per wave (CUDA events), with steps per ray
   (mean, warp maximum) and the bound;
9b. K1 against its plain version on the scale scene's depth-9 tree: a
   crop of ``SCALE_CROP`` camera rays (not a multiple of 32; 4,225
   blocks of 128, over four times what 132 SMs hold at once at 8 blocks
   each) and their shadow rays, in four modes (closest, 1/3 inactive,
   occlusion, mixed);
9c. ladder config 3's render: ``blob(n=187)``, 1920x1080, spp 4, depth 3,
   shadow rays, path traced, 8-wide fused, host-built (the ladder's
   on-device LBVH build is not ported): launch counts reset, one frame
   after a warm-up through ``render_burst(n_frames=1)``; finite image,
   rays, ms, Mrays/s, peak bytes, 5 K1 launches per sample pass; then
   the kernel route against the plain route at ``PT_SMALL`` and spp 2
   (equal ray counts, images within 1e-5); then the five waves of its
   first sample pass as in 9e;
9d. ladder config 4: ``atrium()`` (259,594 triangles), 1920x1080, spp 8,
   depth 3, shadow rays, path traced; the same readings and checks;
9e. the five waves of one sample pass of config 4 (closest 0, shadow 0,
   closest 1, merged shadow 1 + closest 2, shadow 2) captured from a
   frame: K1 against the plain version on each (hits and per-ray steps
   exact), its device time (CUDA events around the bare launch), live
   lanes, steps per ray (mean, warp maximum), SIMT efficiency, bound;
9f. ``render_accum(n_passes=2, spp=2)`` of config 4 at ``PT_SMALL``
   against the mean of two ``frame_body(total_spp=4)`` frames (1e-6);
10. K7: ``run_walks`` against ``run_walks_ref`` at 29,140 rows (sums
    equal) for 16-, 96- and 512-byte row fetches, then the probe's entry
    point (launch counts reset before it) at 29,140 rows (14.2 MiB,
    L2-resident) and 1,048,576 rows (512 MiB, beyond L2): ns/step and
    ns/step/walk for k in {1, 4, 8, 16, 32} at each fetch width;
11. prints the kernels' JSON line (per kernel: launches on its main-path
    run and per frame, K1's being config 4's frame with the other paths'
    counts beside it; device time, plain time, bound, what bounds it and
    the share of the bound) and, last, the device JSON line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

SOURCES = {
    "packet_walk": ("vortex_rt_tpu_torch/csrc/packet_walk.cu",
                    "vortex_rt_tpu/ops/pallas/packet_walk.py:66"),
    "traverse_packet": ("vortex_rt_tpu_torch/csrc/traverse_packet.cu",
                        "vortex_rt_tpu/ops/traverse_packet.py:202"),
    "hbm_walk": ("vortex_rt_tpu_torch/csrc/hbm_walk.cu",
                 "tools/exp_pallas_hbm.py:57"),
}
EYE2 = ([0.05, 0.02, -3.2], [0.0, -0.05, 0.0], [0, 1, 0], 45.0, 1.0)
LIGHT2 = (0.0, 0.8, -0.5)
REL_TOL = 1e-6
IMG_ATOL = 1e-5
K7_ROWS = (29140, 1048576)
K7_STEPS = 2000
K7_KS = "1,4,8,16,32"
K7_WORDS = "4,24,128"  # 16 B, 96 B (K1's internal step), 512 B (TPU row)
SCALE_CROP = 4 * 132 * 8 * 128 + 17  # rays of phase 9b
NATIVE_CROP = 512 * 512              # rays of phase 8b's hit comparison
PT_SMALL = (256, 144)                # frame of the path-traced plain route
PT_WAVES = ("closest0", "shadow0", "closest1", "merged1", "shadow2")


def _check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _elapsed_ms(fn, reps: int, device) -> float:
    """Mean wall time of ``fn`` over ``reps`` calls, device-synchronised."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3 / reps


def _device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` from CUDA events around ``reps`` calls,
    after a warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _kind(kw) -> str:
    if kw.get("occl_split", 0):
        return "mixed"
    return "occlusion" if kw.get("occlusion", False) else "closest"


# ---------------------------------------------------------------- scenes

def config2_scene(width: int = 0, sphere_refl: float = 0.0):
    """BASELINE config 2: Cornell box + sphere (bench.py's bench_scene
    without the reference teapot asset), flattened; width 0 is the
    default (8-wide, as bench.py builds it)."""
    from vortex_rt_tpu_torch import RTConfig, Scene
    from vortex_rt_tpu_torch.models.procedural import cornell_box, uv_sphere

    sc = Scene()
    for mesh, refl in cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sc.add_instance(sc.add_mesh(uv_sphere((0, -0.3, 0), 0.35, 24, 48)),
                    reflectivity=sphere_refl)
    cfg = RTConfig(flatten=True, bvh_width=width)
    return sc.build(cfg), cfg


def tlas_scene():
    """Two meshes, two instances: a TLAS over BLASes with instance nodes."""
    from vortex_rt_tpu_torch import RTConfig, Scene
    from vortex_rt_tpu_torch.models.procedural import box, uv_sphere

    sc = Scene()
    sc.add_mesh(uv_sphere((0, 0, 0), 1.0, 12, 16))
    sc.add_mesh(box((0.5, 0.3, 0.5), 0.4))
    cfg = RTConfig()
    return sc.build(cfg), cfg


def scale_scene(native: bool = True):
    """The ladder's config-3 scene: blob(n=187), 69,938 triangles."""
    from vortex_rt_tpu_torch import RTConfig, Scene
    from vortex_rt_tpu_torch.models.bigscenes import blob

    sc = Scene()
    sc.add_instance(sc.add_mesh(blob(n=187)))
    cfg = RTConfig(flatten=True, use_native_build=native)
    return sc.build(cfg), cfg


def atrium_scene():
    """The ladder's config-4 scene: atrium(), 259,594 triangles in 29
    meshes (native build)."""
    from vortex_rt_tpu_torch import RTConfig, Scene
    from vortex_rt_tpu_torch.models.bigscenes import atrium

    sc = Scene()
    for mesh, refl in atrium():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    cfg = RTConfig(flatten=True)
    return sc.build(cfg), cfg


def config2_camera():
    """bench.py's camera."""
    from vortex_rt_tpu_torch import Camera

    return Camera.look_at(*EYE2)


def camera_rays(cam, w: int, h: int, device):
    """Pixel-center camera rays of the frame's tile-major lane order."""
    import torch

    from vortex_rt_tpu_torch.engine import wavefront as wf
    from vortex_rt_tpu_torch.engine.megakernel import CameraArrays

    lane = torch.arange(w * h, dtype=torch.int64, device=device)
    pxi, pyi = wf._tile_pixel_ids(lane, w, 16, 8 if h % 16 else 16)
    pix = pyi * w + pxi
    ox, oy, oz, dx, dy, dz = wf._camera_from_pix(
        CameraArrays.from_camera(cam, device), w, h, pxi, pyi, pix,
        torch.zeros_like(pix), 1)
    return torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1)


# ---------------------------------------------------------------- phases

def compare_hits(label: str, got, want, steps_got, steps_want) -> float:
    """Kernel hits and per-ray steps against the plain version's (ids,
    hit split and steps exact, dist/bx/by within REL_TOL); returns the
    max abs error over dist (hit lanes), bx and by."""
    import torch

    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    _check(torch.equal(got.tri, want.tri), f"{label}: tri differs")
    _check(torch.equal(got.inst, want.inst), f"{label}: inst differs")
    _check(torch.equal(got.dist < LARGE_FLOAT, want.dist < LARGE_FLOAT),
           f"{label}: hit/miss (or occluded) split differs")
    hit = want.dist < LARGE_FLOAT
    err = 0.0
    for name, a, b in (("dist", got.dist[hit], want.dist[hit]),
                       ("bx", got.bx, want.bx), ("by", got.by, want.by)):
        _check(torch.allclose(a, b, rtol=REL_TOL, atol=0.0),
               f"{label}: {name} differs beyond rel {REL_TOL}")
        if a.numel():
            err = max(err, float((a - b).abs().max()))
    _check(torch.equal(steps_got, steps_want),
           f"{label}: per-ray steps differ from the plain version")
    print(f"  {label}: rays {hit.numel()} hit/occluded {int(hit.sum())} "
          f"max_abs_err {err:.3g} same_steps True")
    return err


def walk_cases(wa, device, size: int, mixed: bool):
    """(mode, o, d, kwargs) of the walk comparisons: camera rays in the
    closest, 1/3 inactive and half t_max-clamped modes, shadow rays from
    their hit points in occlusion mode, and (``mixed``) one wave of the
    shadow rays (occlusion) followed by the camera rays (closest)."""
    import torch

    from vortex_rt_tpu_torch.engine.wavefront import default_walk
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    walk = default_walk(wa)
    cam = config2_camera()
    light = torch.tensor(LIGHT2, dtype=torch.float32, device=device)
    o, d = camera_rays(cam, size, size, device)
    n = o.shape[0]
    base, _ = walk(wa, o, d)
    hit = base.dist < LARGE_FLOAT
    _check(bool(hit.any()), "no camera ray hit the scene")
    lane = torch.arange(n, device=device)
    t_max = torch.where(hit & (lane % 2 == 0), base.dist * 0.5,
                        torch.full_like(base.dist, LARGE_FLOAT))
    hp = o + d * base.dist.clamp_max(1e18).unsqueeze(1)
    sl = light - hp
    dist_l = torch.sqrt((sl * sl).sum(1) + 1e-20)
    sd = sl / dist_l.unsqueeze(1)
    so, clamp = hp + sd * 1e-3, dist_l * (1.0 - 1e-3)
    cases = [
        ("closest", o, d, dict()),
        ("active", o, d, dict(active=lane % 3 != 0)),
        ("t_max", o, d, dict(t_max=t_max)),
        ("shadow", so, sd, dict(active=hit, t_max=clamp, occlusion=True)),
    ]
    if mixed:
        cases.append(("mixed", torch.cat([so, o]), torch.cat([sd, d]), dict(
            active=torch.cat([hit, lane % 3 != 0]),
            t_max=torch.cat([clamp, torch.full_like(clamp, LARGE_FLOAT)]),
            occl_split=n)))
    return cases


def phase_walk_vs_plain(device, scenes, walk, ref, size: int = 64,
                        mixed: bool = False) -> float:
    from vortex_rt_tpu_torch import WavefrontRenderer

    err = 0.0
    for label, (sb, cfg) in scenes:
        wa = WavefrontRenderer.from_buffers(sb, cfg, device=device).wa
        for mode, co, cd, kw in walk_cases(wa, device, size, mixed):
            k, ks = walk(wa, co, cd, **kw)
            _sync(device)
            p, ps = ref(wa, co, cd, **kw)
            _sync(device)
            err = max(err, compare_hits(f"{label}/{mode}", k, p, ks, ps))
    return err


def renderer_pair(device, scene, ref):
    """(kernel-route renderer, plain-route renderer) of a build."""
    from vortex_rt_tpu_torch import WavefrontRenderer

    sb, cfg = scene
    rk = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    return rk, dataclasses.replace(rk, walk=ref)


def frame_vs_plain(label, rk, rp, params, size, device, cam=None):
    """Render one frame through both routes; returns (image, rays).
    ``size`` is the side of a square frame or (w, h); the camera is
    config 2's unless given."""
    import numpy as np

    w, h = (size, size) if isinstance(size, int) else size
    cam = cam or config2_camera()
    img_k, rays_k = rk.render(cam, params, w, h)
    _sync(device)
    img_p, rays_p = rp.render(cam, params, w, h)
    _sync(device)
    _check(rays_k == rays_p, f"{label}: ray counts differ: {rays_k} vs "
           f"{rays_p}")
    _check(img_k.shape == (h, w, 3) and np.isfinite(img_k).all(),
           f"{label}: kernel-route image is not a finite (H, W, 3) image")
    diff = float(np.abs(img_k - img_p).max())
    _check(diff <= IMG_ATOL, f"{label}: images differ by {diff} > {IMG_ATOL}")
    print(f"  {label}: rays {rays_k} image max diff vs plain {diff:.3g}")
    return img_k, rays_k


def phase_small_frame_k2(device, size: int = 64) -> None:
    from vortex_rt_tpu_torch import RenderParams
    from vortex_rt_tpu_torch.ops.packet_walk import trace_packets_walk_ref
    from vortex_rt_tpu_torch.runtime import kernels

    rk, rp = renderer_pair(device, config2_scene(width=4),
                           trace_packets_walk_ref)
    p = RenderParams(light_pos=LIGHT2, max_depth=2, shadow=True, spp=2)
    before = kernels.LAUNCHES["packet_walk"]
    frame_vs_plain(f"4-wide {size}x{size} spp2 d2", rk, rp, p, size, device)
    launched = kernels.LAUNCHES["packet_walk"] - before
    if device.type == "cuda":
        # primary, shadow-0, bounce-1, shadow-1 per sample pass
        _check(launched == 4 * p.spp, f"{launched} K2 launches per frame")
    print(f"  K2 launches per frame {launched}")


def phase_small_frame_k1(device, size: int = 64) -> None:
    from vortex_rt_tpu_torch import RenderParams
    from vortex_rt_tpu_torch.ops.traverse_packet import (
        trace_packets, trace_packets_ref,
    )
    from vortex_rt_tpu_torch.runtime import kernels

    rk, rp = renderer_pair(device, config2_scene(sphere_refl=0.5),
                           trace_packets_ref)
    waves = []

    def walk(*a, **kw):
        waves.append(_kind(kw))
        return trace_packets(*a, **kw)

    rk = dataclasses.replace(rk, walk=walk)
    p = RenderParams(light_pos=LIGHT2, max_depth=3, shadow=True, spp=2)
    before = kernels.LAUNCHES["traverse_packet"]
    frame_vs_plain(f"8-wide {size}x{size} spp2 d3", rk, rp, p, size, device)
    launched = kernels.LAUNCHES["traverse_packet"] - before
    _check(waves == ["closest", "occlusion", "closest", "mixed",
                     "occlusion"] * p.spp, f"unexpected waves {waves}")
    if device.type == "cuda":
        _check(launched == 5 * p.spp, f"{launched} K1 launches per frame")
    print(f"  K1 launches per frame {launched}, waves per pass "
          f"{waves[:5]}")


def primary_wave(device, wa, timed, ref, work, bound, size, reps) -> dict:
    """One primary wave: the kernel against its plain version ``ref``
    (``work`` returns the plain hits, steps and work), timed with CUDA
    events (``timed`` makes a function of no arguments that launches it)
    and beside its bound."""
    o, d = camera_rays(config2_camera(), size, size, device)
    call = timed(wa, o, d)
    k, ks = call()
    pp, ps, wk = work(wa, o, d)
    err = compare_hits(f"primary {size}x{size}", k, pp, ks, ps)
    b = bound(wk)
    # (a CPU rehearsal has no device time)
    ms = _device_ms(call, reps) if device.type == "cuda" else float("nan")
    plain_ms = _elapsed_ms(lambda: ref(wa, o, d), 3, device)
    print(f"  primary wave {size}x{size}: kernel {ms:.4f} ms (device), "
          f"plain {plain_ms:.4f} ms, mean steps per ray "
          f"{float(ks.float().mean()):.2f}, bound {b.ms:.4f} ms "
          f"({b.bound_by}: {b.ops} ops, {b.bytes} B) = {b.ms / ms:.1%}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b.ms,
                bound_by=b.bound_by)


def main_path_run(label, rk, rp, params, size, device, name) -> int:
    """The path's run with launch counts reset just before and read just
    after; checked against the plain route.  Returns the launches."""
    import numpy as np

    from vortex_rt_tpu_torch.runtime import kernels

    kernels.reset_launches()
    img, rays = rk.render(config2_camera(), params, size, size)
    _sync(device)
    launches = dict(kernels.LAUNCHES)
    if device.type == "cuda":
        _check(launches[name] > 0, f"{label}: the path launched no {name}")
    _check(img.shape == (size, size, 3) and np.isfinite(img).all(),
           f"{label}: image is not a finite (H, W, 3) image")
    _check(rays >= size * size * params.spp,
           f"{label}: ray count {rays} below primaries")
    img_p, rays_p = rp.render(config2_camera(), params, size, size)
    _check(rays_p == rays, f"{label}: ray count {rays} vs plain {rays_p}")
    diff = float(np.abs(img - img_p).max())
    _check(diff <= IMG_ATOL, f"{label}: images differ by {diff}")
    print(f"  {label}: rays {rays} launches {launches} image max diff vs "
          f"plain {diff:.3g}")
    return launches[name]


def phase_config2(device, size: int = 512, burst: int = 16, reps: int = 3,
                  wave_reps: int = 20) -> dict:
    from vortex_rt_tpu_torch import RenderParams
    from vortex_rt_tpu_torch.ops.traverse_packet import (
        kernel_call, trace_packets, trace_packets_ref, walk_work,
    )
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    rk, rp = renderer_pair(device, config2_scene(), trace_packets_ref)
    _check(rk.wa.width == 8 and rk.wa.fused is not None
           and rk.walk is trace_packets,
           "config 2 is not on bench.py's 8-wide fused route")
    p = RenderParams(light_pos=LIGHT2, max_depth=2, shadow=True, spp=2)
    launches = main_path_run(f"config 2 {size}x{size} spp2 d2", rk, rp, p,
                             size, device, "traverse_packet")

    # ---- sustained throughput: 3 x 16-frame bursts after a warm-up
    cam = config2_camera()
    rk.render_burst(cam, p, size, size, n_frames=burst, seed0=0,
                    rays_only=True)
    _sync(device)
    total = 0
    t0 = time.perf_counter()
    for i in range(reps):
        total += rk.render_burst(cam, p, size, size, n_frames=burst,
                                 seed0=(i + 1) * burst, rays_only=True)
    dt = time.perf_counter() - t0
    mrays = total / dt / 1e6
    print(f"  config 2 {size}x{size} spp2 d2 shadow: {total} rays in "
          f"{dt:.4f} s = {mrays:.3f} Mrays/s ({dt * 1e3 / (reps * burst):.3f}"
          f" ms/frame)")
    timed = (kernel_call if device.type == "cuda"
             else lambda wa, o, d: lambda: trace_packets(wa, o, d))
    wave = primary_wave(device, rk.wa, timed, trace_packets_ref, walk_work,
                        wb.k1_bound, size, wave_reps)

    # ---- depth 3, reflective sphere: the merged wave with live lanes
    rk3, rp3 = renderer_pair(device, config2_scene(sphere_refl=0.5),
                             trace_packets_ref)
    p3 = dataclasses.replace(p, max_depth=3)
    _, rays3 = frame_vs_plain(f"config 2 reflective {size}x{size} spp2 d3",
                              rk3, rp3, p3, size, device)
    ms3 = _elapsed_ms(lambda: rk3.render(cam, p3, size, size), 3, device)
    print(f"  depth-3 frame {ms3:.3f} ms ({rays3} rays)")
    return dict(launches=launches, launches_per_frame=launches, mrays=mrays,
                **wave)


def phase_config2_k2(device, size: int = 512, wave_reps: int = 20) -> dict:
    from vortex_rt_tpu_torch import RenderParams
    from vortex_rt_tpu_torch.ops.packet_walk import (
        kernel_call, trace_packets_walk, trace_packets_walk_ref, walk_work_4,
    )
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    rk, rp = renderer_pair(device, config2_scene(width=4),
                           trace_packets_walk_ref)
    _check(rk.walk is trace_packets_walk, "4-wide build is not on K2")
    p = RenderParams(light_pos=LIGHT2, max_depth=2, shadow=True, spp=2)
    launches = main_path_run(f"config 2 4-wide {size}x{size} spp2 d2", rk,
                             rp, p, size, device, "packet_walk")
    ms = _elapsed_ms(lambda: rk.render(config2_camera(), p, size, size), 3, device)
    print(f"  4-wide frame {ms:.3f} ms")
    timed = (kernel_call if device.type == "cuda"
             else lambda wa, o, d: lambda: trace_packets_walk(wa, o, d))
    wave = primary_wave(device, rk.wa, timed, trace_packets_walk_ref,
                        walk_work_4, wb.k2_bound, size, wave_reps)
    return dict(launches=launches, launches_per_frame=launches, **wave)


def phase_scale(device, scene, w: int = 1920, h: int = 1080) -> dict:
    import numpy as np
    import torch

    from vortex_rt_tpu_torch import RenderParams, Scene, WavefrontRenderer

    sb, cfg = scene
    t0 = time.perf_counter()
    r = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    tables_s = time.perf_counter() - t0
    cam = Scene.framing_camera(sb, 45.0, w / h)
    p = RenderParams(max_depth=2, spp=2, shadow=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    img, _ = r.render_burst(cam, p, w, h, n_frames=1, seed0=0)
    _check(img.shape == (h, w, 3) and np.isfinite(img).all(),
           "scale-scene image is not a finite (H, W, 3) image")
    _sync(device)
    t0 = time.perf_counter()
    rays = r.render_burst(cam, p, w, h, n_frames=1, seed0=1, rays_only=True)
    dt = time.perf_counter() - t0
    _check(rays >= w * h * p.spp, f"ray count {rays} below primaries")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out = dict(tris=sb.num_tris, width=r.wa.width,
               nodes=int(r.wa.nodes.shape[0]), depth=r.wa.depth,
               fused_bytes=r.wa.fused.numel() * 4,
               table_bytes=r.wa.nbytes + r.sa.nbytes, rays=rays,
               frame_ms=dt * 1e3, mrays=rays / dt / 1e6,
               peak_bytes=int(peak), tables_s=tables_s)
    print(f"  scale scene {w}x{h} spp2 d2 shadow: {json.dumps(out)}")
    if device.type == "cuda":
        out["waves"] = scale_waves(device, r, cam, p, w, h)
    return out, r


def scale_waves(device, r, cam, p, w: int, h: int, reps: int = 10,
                names=None, label: str = "scale") -> dict:
    """The waves of the first sample pass of a frame (``names``; the
    Whitted scale frame's four unless given): K1 against the plain
    version on each (hits and steps), and its device time per wave beside
    the bound."""
    import torch

    from vortex_rt_tpu_torch.ops.traverse_packet import kernel_call
    from vortex_rt_tpu_torch.tools import k1_timing

    names = names or k1_timing.SCALE_WAVES
    waves = []

    def capture(wa, o, d, **kw):
        if len(waves) < len(names):
            waves.append((o.clone(), d.clone(), {
                k: (v.clone() if torch.is_tensor(v) else v)
                for k, v in kw.items()}))
        return r.walk(wa, o, d, **kw)

    dataclasses.replace(r, walk=capture).render_burst(cam, p, w, h,
                                                      n_frames=1)
    _check(len(waves) == len(names),
           f"a {label} pass made {len(waves)} waves")
    out = {}
    for name, (o, d, kw) in zip(names, waves):
        want = ("mixed" if name.startswith("merged") else "occlusion"
                if name.startswith("shadow") else "closest")
        _check(_kind(kw) == want, f"{label} {name} is a {_kind(kw)} wave")
        res = k1_timing.time_wave(r.wa, o, d, kw, {"k1": kernel_call}, reps)
        v = res.pop("versions")["k1"]
        res.update(ms=v["ms"], bound_share=v["bound_share"],
                   live=int(kw["active"].sum()) if "active" in kw
                   else o.shape[0])
        out[name] = res
        print(f"  {label} {name}: {res['rays']} lanes ({res['live']} live, "
              f"{res['walking_rays']} walking), steps mean "
              f"{res['mean_steps']:.3f} warp-max "
              f"{res['warp_max_steps']:.3f} (SIMT {res['simt_efficiency']:.1%})"
              f"; K1 {res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}) = {res['bound_share']:.1%}; hits and "
              f"steps equal the plain version")
    total = sum(v["ms"] for v in out.values())
    print(f"  K1 device time per sample pass {total:.4f} ms, per frame "
          f"{total * p.spp:.4f} ms")
    return out


def phase_scale_k1(device, r, w: int = 1920, h: int = 1080) -> float:
    """K1 against its plain version on the scale scene's tree (renderer
    ``r``), on a crop of camera rays and their shadow rays."""
    import torch

    from vortex_rt_tpu_torch import RenderParams, Scene
    from vortex_rt_tpu_torch.ops.traverse_packet import (
        trace_packets, trace_packets_ref,
    )
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    sb, wa = r.sb, r.wa
    _check(wa.depth >= 9, f"scale tree depth {wa.depth} < 9")
    n = SCALE_CROP if device.type == "cuda" else 4113
    o, d = camera_rays(Scene.framing_camera(sb, 45.0, w / h), w, h, device)
    _check(o.shape[0] >= n, f"crop of {n} rays exceeds the frame")
    a = (o.shape[0] - n) // 2
    o, d = o[a:a + n].contiguous(), d[a:a + n].contiguous()
    base, _ = trace_packets_ref(wa, o, d)
    hit = base.dist < LARGE_FLOAT
    light = torch.tensor(RenderParams().light_pos, dtype=torch.float32,
                         device=device)
    hp = o + d * base.dist.clamp_max(1e18).unsqueeze(1)
    sl = light - hp
    dist_l = torch.sqrt((sl * sl).sum(1) + 1e-20)
    sd = sl / dist_l.unsqueeze(1)
    so, clamp = hp + sd * 1e-3, dist_l * (1.0 - 1e-3)
    lane = torch.arange(n, device=device)
    print(f"  depth {wa.depth}, {n} rays, {int(hit.sum())} camera hits")
    err = 0.0
    for mode, co, cd, kw in (
            ("closest", o, d, dict()),
            ("active", o, d, dict(active=lane % 3 != 0)),
            ("shadow", so, sd, dict(active=hit, t_max=clamp,
                                    occlusion=True)),
            ("mixed", torch.cat([so, o]), torch.cat([sd, d]), dict(
                active=torch.cat([hit, lane % 3 != 0]),
                t_max=torch.cat([clamp, torch.full_like(clamp, LARGE_FLOAT)]),
                occl_split=n))):
        k, ks = trace_packets(wa, co, cd, **kw)
        _sync(device)
        pp, ps = trace_packets_ref(wa, co, cd, **kw)
        err = max(err, compare_hits(f"scale/{mode}", k, pp, ks, ps))
    return err


def phase_native_build(device, w: int = 1920, h: int = 1080):
    """Build the native host builder and the two scale scenes with it;
    returns ((blob buffers, config), (atrium buffers, config))."""
    import torch

    from vortex_rt_tpu_torch import Scene, WavefrontRenderer
    from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets
    from vortex_rt_tpu_torch.runtime import native
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    native.load()
    print(f"  csrc/builder.cpp: {native.cxx_path()} "
          f"{' '.join(native.CXX_FLAGS)} in {native.build_seconds:.2f} s")
    timed = {}
    for name, make in (("blob native", scale_scene),
                       ("blob numpy", lambda: scale_scene(native=False)),
                       ("atrium native", atrium_scene)):
        t0 = time.perf_counter()
        timed[name] = make()
        sb = timed[name][0]
        print(f"  {name}: {sb.num_tris} triangles, "
              f"{sb.bvh_left.shape[0]} binary nodes, scene assembly and "
              f"build {time.perf_counter() - t0:.3f} s")
    # the native tree against the NumPy tree, by what camera rays hit
    sb = timed["blob native"][0]
    o, d = camera_rays(Scene.framing_camera(sb, 45.0, w / h), w, h, device)
    n = min(NATIVE_CROP, o.shape[0])
    a0 = (o.shape[0] - n) // 2
    o, d = o[a0:a0 + n].contiguous(), d[a0:a0 + n].contiguous()
    hits = [trace_packets(WavefrontRenderer.from_buffers(
        *timed[name], device=device).wa, o, d)[0]
        for name in ("blob native", "blob numpy")]
    a, b = hits
    hit = b.dist < LARGE_FLOAT
    _check(bool(hit.any()) and not bool(hit.all()),
           "the crop does not hold both hits and misses")
    _check(torch.equal(a.dist < LARGE_FLOAT, hit),
           "native and NumPy builds: hit masks differ")
    _check(torch.equal(a.tri[hit], b.tri[hit]),
           "native and NumPy builds: hit triangles differ")
    _check(torch.allclose(a.dist[hit], b.dist[hit], rtol=2e-4, atol=0.0),
           "native and NumPy builds: dist differs beyond 2e-4 relative")
    rel = float(((a.dist[hit] - b.dist[hit]).abs() / b.dist[hit]).max())
    print(f"  native vs NumPy build of the blob: {n} camera rays, "
          f"{int(hit.sum())} hits, same mask and tri, dist max rel diff "
          f"{rel:.3g}")
    return timed["blob native"], timed["atrium native"]


def phase_pathtraced(device, label: str, scene, spp: int, w: int = 1920,
                     h: int = 1080):
    """A ladder path-traced config at full width through K1, then the
    kernel route against the plain route at ``PT_SMALL``.  Returns
    (readings, renderer, camera, params)."""
    import numpy as np
    import torch

    from vortex_rt_tpu_torch import RenderParams, Scene, WavefrontRenderer
    from vortex_rt_tpu_torch.ops.traverse_packet import (
        trace_packets, trace_packets_ref,
    )
    from vortex_rt_tpu_torch.runtime import kernels

    sb, cfg = scene
    t0 = time.perf_counter()
    r = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    tables_s = time.perf_counter() - t0
    _check(r.wa.width == 8 and r.wa.fused is not None
           and r.walk is trace_packets, f"{label} is not on the K1 route")
    cam = Scene.framing_camera(sb, 45.0, w / h)
    p = RenderParams(max_depth=3, spp=spp, shadow=True, pathtrace=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # warm-up frame; its image is the one checked
    img, _ = r.render_burst(cam, p, w, h, n_frames=1, seed0=100)
    _check(img.shape == (h, w, 3) and np.isfinite(img).all()
           and float(img.std()) > 0.0,
           f"{label}: image is not a finite, non-constant (H, W, 3) image")
    _sync(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    rays = r.render_burst(cam, p, w, h, n_frames=1, seed0=200, rays_only=True)
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    _check(rays >= 2 * w * h * spp, f"{label}: {rays} rays, under two per "
           f"sample")
    if device.type == "cuda":
        # closest 0, shadow 0, closest 1, merged shadow 1 + closest 2,
        # shadow 2 per sample pass
        _check(launches == {**{k: 0 for k in launches},
                            "traverse_packet": 5 * spp},
               f"{label}: launches {launches}, expected {5 * spp} of K1")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out = dict(tris=sb.num_tris, nodes=int(r.wa.nodes.shape[0]),
               depth=r.wa.depth, fused_bytes=r.wa.fused.numel() * 4,
               table_bytes=r.wa.nbytes + r.sa.nbytes, tables_s=tables_s,
               rays=rays, rays_per_sample=rays / (w * h * spp),
               frame_ms=dt * 1e3, mrays=rays / dt / 1e6,
               peak_bytes=int(peak),
               k1_launches=launches["traverse_packet"])
    print(f"  {label} {w}x{h} spp{spp} d3 shadow pathtrace: "
          f"{json.dumps(out)}")
    sw, sh = PT_SMALL if device.type == "cuda" else (32, 18)
    frame_vs_plain(
        f"{label} {sw}x{sh} spp2 d3", r,
        dataclasses.replace(r, walk=trace_packets_ref),
        dataclasses.replace(p, spp=2), (sw, sh), device, cam=cam)
    return out, r, cam, p


def phase_render_accum(device, r, cam, p, size=PT_SMALL) -> None:
    """``render_accum(n_passes=2, spp=2)`` is the mean of the two passes'
    ``frame_body(total_spp=4)`` frames."""
    import numpy as np

    from vortex_rt_tpu_torch.engine import wavefront as wf
    from vortex_rt_tpu_torch.engine.megakernel import (
        CameraArrays, LightArrays,
    )

    w, h = size
    p = dataclasses.replace(p, spp=2)
    acc, rays = r.render_accum(cam, p, w, h, n_passes=2, seed0=5)
    frames = [wf.frame_body(
        r.wa, r.sa, CameraArrays.from_camera(cam, device),
        LightArrays.from_params(p, device), w, h, max_depth=p.max_depth,
        spp=p.spp, table=r._table_for(p), seed=5 + i, shadow=p.shadow,
        tile_w=r.config.tile_w, tile_h=r.config.tile_h, walk=r.walk,
        total_spp=2 * p.spp) for i in range(2)]
    mean = ((frames[0][0] + frames[1][0]) * 0.5).reshape(3, h, w)
    diff = float(np.abs(acc - mean.permute(1, 2, 0).cpu().numpy()).max())
    _check(acc.shape == (h, w, 3) and np.isfinite(acc).all(),
           "render_accum: not a finite (H, W, 3) image")
    _check(diff <= 1e-6, f"render_accum differs from the mean of its "
           f"passes' frames by {diff}")
    _check(rays == int(frames[0][1] + frames[1][1]),
           "render_accum: ray count is not the sum of its passes'")
    print(f"  render_accum {w}x{h} n_passes 2 spp 2: rays {rays}, max diff "
          f"vs the mean of two frame_body(total_spp=4) frames {diff:.3g}")


def phase_k7(device, check_rows: int = K7_ROWS[0], check_steps: int = 500
             ) -> dict:
    import torch

    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import exp_hbm_walk as hw
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    tab = hw.make_table(check_rows, device)
    err = 0
    for words in (int(x) for x in K7_WORDS.split(",")):
        for k in (int(x) for x in K7_KS.split(",")):
            got = hw.run_walks(tab, check_steps, k, words)
            want = hw.run_walks_ref(tab, check_steps, k, words)
            err = max(err, abs(int(got[0]) - int(want[0])))
            _check(torch.equal(got, want), f"K7 k={k} words={words}: sum "
                   f"{int(got[0])} vs plain {int(want[0])}")
    print(f"  run_walks == run_walks_ref at {check_rows} rows, "
          f"{check_steps} steps, k in {K7_KS}, words in {K7_WORDS}")
    ms = _device_ms(lambda: hw.run_walks(tab, K7_STEPS, 1), 5)
    plain_ms = _elapsed_ms(lambda: hw.run_walks_ref(tab, K7_STEPS, 1), 2,
                           device)
    b = wb.k7_bound(check_rows, K7_STEPS, 1, hw.W)
    print(f"  {K7_STEPS} steps k=1, 512-B rows: kernel {ms:.4f} ms "
          f"(device), plain {plain_ms:.4f} ms, bound {b.ms:.6f} ms "
          f"({b.bound_by}; the probe measures latency, not this)")
    del tab

    # ---- the probe's entry point: counts reset just before, read after
    kernels.reset_launches()
    curves = {}
    for rows in K7_ROWS:
        curves[rows] = hw.main(["--rows", str(rows), "--steps",
                                str(K7_STEPS), "--ks", K7_KS, "--words",
                                K7_WORDS])
    _sync(device)
    launches = kernels.LAUNCHES["hbm_walk"]
    _check(launches > 0, "the probe launched no hbm_walk")
    return dict(launches=launches, launches_per_frame=None,
                max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=b.ms, bound_by=b.bound_by, curves=curves)


def main() -> int:
    import torch

    # 1. device
    _check(torch.cuda.is_available(), "no CUDA device: this smoke run "
           "needs the GPU and has no CPU path")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    _check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print("phase 1 device:", torch.cuda.get_device_name(0),
          "torch", torch.__version__, "cuda", torch.version.cuda)
    print(smi.stdout.strip())

    from vortex_rt_tpu_torch.ops.packet_walk import (
        trace_packets_walk, trace_packets_walk_ref,
    )
    from vortex_rt_tpu_torch.ops.traverse_packet import (
        trace_packets, trace_packets_ref,
    )
    from vortex_rt_tpu_torch.runtime import kernels

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = kernels.load_all(list(SOURCES))
    print(f"phase 2 build: {len(libs)} kernels in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"  {lib.path.name}: nvcc {lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())

    print("phase 3 K2 vs plain version (64x64 rays)")
    err3 = phase_walk_vs_plain(device, (("flat4", config2_scene(width=4)),
                                        ("tlas", tlas_scene())),
                               trace_packets_walk, trace_packets_walk_ref)
    print("phase 4 4-wide frame, K2 vs plain (64x64)")
    phase_small_frame_k2(device)
    print("phase 5 K1 vs plain version (64x64 rays, 8-wide fused)")
    err5 = phase_walk_vs_plain(device, (("flat8", config2_scene()),),
                               trace_packets, trace_packets_ref, mixed=True)
    print("phase 6 8-wide frame at depth 3, K1 vs plain (64x64)")
    phase_small_frame_k1(device)
    print("phase 7 config 2 as bench.py renders it (512x512, 8-wide fused)")
    c2 = phase_config2(device)
    print("phase 8 config 2 through the 4-wide route (512x512)")
    c2k2 = phase_config2_k2(device)
    print("phase 8b native host builder (csrc/builder.cpp)")
    blob_scene, atr_scene = phase_native_build(device)
    print("phase 9 scale scene (blob n=187, 1920x1080, Whitted, 8-wide fused)")
    sc, scale_r = phase_scale(device, blob_scene)
    print("phase 9b K1 vs plain version on the scale scene's tree")
    err9 = phase_scale_k1(device, scale_r)
    del scale_r
    print("phase 9c ladder config 3's render (blob n=187, host-built: the "
          "ladder's on-device LBVH build is not ported)")
    c3, r3, cam3, p3 = phase_pathtraced(device, "config 3", blob_scene, 4)
    c3["waves"] = scale_waves(device, r3, cam3, p3, 1920, 1080,
                              names=PT_WAVES, label="config 3")
    del r3
    print("phase 9d ladder config 4 (atrium)")
    c4, r4, cam4, p4 = phase_pathtraced(device, "config 4", atr_scene, 8)
    print("phase 9e the five waves of one sample pass of config 4")
    c4["waves"] = scale_waves(device, r4, cam4, p4, 1920, 1080,
                              names=PT_WAVES, label="config 4")
    print("phase 9f render_accum (config 4's scene)")
    phase_render_accum(device, r4, cam4, p4)
    del r4
    print("phase 10 K7 chained row-fetch probe")
    k7 = phase_k7(device)
    print(f"  summary: config2 {c2['mrays']:.3f} Mrays/s, scale "
          f"{sc['mrays']:.3f} Mrays/s, peak {sc['peak_bytes']} B; config 3 "
          f"{c3['frame_ms']:.3f} ms/frame {c3['mrays']:.3f} Mrays/s, config "
          f"4 {c4['frame_ms']:.3f} ms/frame {c4['mrays']:.3f} Mrays/s, peak "
          f"{c4['peak_bytes']} B")

    # 11. results.  K1's launches are config 4's frame (this slice's
    # main path); the earlier paths' counts stand beside it
    c2.update(launches=c4["k1_launches"],
              launches_per_frame=c4["k1_launches"], launches_by_path={
        "config2": c2["launches"], "config3": c3["k1_launches"],
        "config4": c4["k1_launches"]})
    rows = []
    for name, res, err in (
            ("packet_walk", c2k2, max(err3, c2k2["max_abs_err"])),
            ("traverse_packet", c2, max(err5, err9, c2["max_abs_err"])),
            ("hbm_walk", k7, k7["max_abs_err"])):
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": res["launches"],
                     "launches_per_frame": res["launches_per_frame"],
                     "launches_by_path": res.get("launches_by_path"),
                     "max_abs_err": err,
                     "ms": res["ms"], "plain_ms": res["plain_ms"],
                     "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"],
                     "bound_share": res["bound_ms"] / res["ms"],
                     "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
