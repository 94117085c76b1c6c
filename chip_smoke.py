#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vortex_rt_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version on the card, renders the wavefront main
path through the kernel, and measures it.  Phases (each raises, and so
exits non-zero, on failure):

1. device: a CUDA device is required; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: builds ``csrc/packet_walk.cu`` and prints the build time;
3. kernel against plain version: config-2 camera rays at 64x64 on the
   flat 4-wide build and on a TLAS build (two instances), in four modes
   (closest, 1/3 inactive, half t_max-clamped, shadow-ray occlusion);
4. one config-2 frame at 64x64 through the kernel and through the plain
   version: equal ray counts, images within 1e-5, every wave launched;
5. config 2 at 512x512, spp 2, depth 2, shadow rays: the main path's run
   (launch counts reset before it), checked against the plain version,
   then 3 x 16-frame bursts timed after a warm-up (Mrays/s as bench.py
   defines it) and one primary wave timed through kernel and plain;
6. the scale scene, ``blob(n=187)`` at 1920x1080, spp 2, depth 2, shadow
   rays: one frame timed after a warm-up, table bytes, peak memory;
7. prints the kernels' JSON line and, last, the device JSON line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

KERNEL_SOURCE = "vortex_rt_tpu_torch/csrc/packet_walk.cu"
REPLACES = "vortex_rt_tpu/ops/pallas/packet_walk.py:66"
EYE2 = ([0.05, 0.02, -3.2], [0.0, -0.05, 0.0], [0, 1, 0], 45.0, 1.0)
LIGHT2 = (0.0, 0.8, -0.5)
REL_TOL = 1e-6
IMG_ATOL = 1e-5


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


# ---------------------------------------------------------------- scenes

def config2_scene(flatten: bool = True):
    """BASELINE config 2: Cornell box + sphere (bench.py's bench_scene
    without the reference teapot asset)."""
    from vortex_rt_tpu_torch import RTConfig, Scene
    from vortex_rt_tpu_torch.models.procedural import cornell_box, uv_sphere

    sc = Scene()
    for mesh, refl in cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sc.add_instance(sc.add_mesh(uv_sphere((0, -0.3, 0), 0.35, 24, 48)))
    cfg = RTConfig(flatten=flatten)
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


def scale_scene():
    """The ladder's config-3 scene: blob(n=187), 69,938 triangles."""
    from vortex_rt_tpu_torch import RTConfig, Scene
    from vortex_rt_tpu_torch.models.bigscenes import blob

    sc = Scene()
    sc.add_instance(sc.add_mesh(blob(n=187)))
    cfg = RTConfig(flatten=True)
    return sc.build(cfg), cfg


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

def compare_hits(label: str, got, want, steps_got, steps_want,
                 occlusion: bool) -> float:
    """Kernel hits against plain-version hits; returns the max abs error
    over dist (hit lanes), bx and by."""
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
    same_steps = torch.equal(steps_got, steps_want)
    n_hit = int(hit.sum())
    print(f"  {label}: rays {hit.numel()} {'occluded' if occlusion else 'hit'}"
          f" {n_hit} max_abs_err {err:.3g} same_steps {same_steps}")
    return err


def phase_kernel_vs_plain(device, size: int = 64) -> float:
    import torch

    from vortex_rt_tpu_torch import Camera
    from vortex_rt_tpu_torch.ops.packet_walk import (
        trace_packets_walk, trace_packets_walk_ref,
    )
    from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    cam = Camera.look_at(*EYE2)
    light = torch.tensor(LIGHT2, dtype=torch.float32, device=device)
    err = 0.0
    for label, (sb, cfg) in (("flat", config2_scene()),
                             ("tlas", tlas_scene())):
        wa = WideArrays.from_scene(sb, cfg.bvh_width).to(device)
        o, d = camera_rays(cam, size, size, device)
        n = o.shape[0]
        base, base_steps = trace_packets_walk_ref(wa, o, d)
        hit = base.dist < LARGE_FLOAT
        _check(bool(hit.any()), f"{label}: no camera ray hit the scene")
        lane = torch.arange(n, device=device)
        t_max = torch.where(hit & (lane % 2 == 0), base.dist * 0.5,
                            torch.full_like(base.dist, LARGE_FLOAT))
        hp = o + d * base.dist.clamp_max(1e18).unsqueeze(1)
        sl = light - hp
        dist_l = torch.sqrt((sl * sl).sum(1) + 1e-20)
        sd = sl / dist_l.unsqueeze(1)
        cases = (
            ("closest", o, d, dict()),
            ("active", o, d, dict(active=lane % 3 != 0)),
            ("t_max", o, d, dict(t_max=t_max)),
            ("shadow", hp + sd * 1e-3, sd,
             dict(active=hit, t_max=dist_l * (1.0 - 1e-3), occlusion=True)),
        )
        for mode, co, cd, kw in cases:
            k, ks = trace_packets_walk(wa, co, cd, **kw)
            _sync(device)
            p, ps = trace_packets_walk_ref(wa, co, cd, **kw)
            _sync(device)
            err = max(err, compare_hits(f"{label}/{mode}", k, p, ks, ps,
                                        kw.get("occlusion", False)))
    return err


def phase_small_frame(device, size: int = 64) -> None:
    import numpy as np

    from vortex_rt_tpu_torch import Camera, RenderParams, WavefrontRenderer
    from vortex_rt_tpu_torch.ops.packet_walk import trace_packets_walk_ref
    from vortex_rt_tpu_torch.runtime import kernels

    sb, cfg = config2_scene()
    rk = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    rp = dataclasses.replace(rk, walk=trace_packets_walk_ref)
    cam = Camera.look_at(*EYE2)
    p = RenderParams(light_pos=LIGHT2, max_depth=2, shadow=True, spp=2)
    before = kernels.LAUNCHES["packet_walk"]
    img_k, rays_k = rk.render(cam, p, size, size)
    _sync(device)
    launched = kernels.LAUNCHES["packet_walk"] - before
    img_p, rays_p = rp.render(cam, p, size, size)
    _sync(device)
    _check(rays_k == rays_p, f"ray counts differ: {rays_k} vs {rays_p}")
    _check(img_k.shape == (size, size, 3) and np.isfinite(img_k).all(),
           "kernel-route image is not a finite (H, W, 3) image")
    diff = float(np.abs(img_k - img_p).max())
    _check(diff <= IMG_ATOL, f"images differ by {diff} > {IMG_ATOL}")
    if device.type == "cuda":
        # primary, shadow-0, bounce-1, shadow-1 per sample pass
        _check(launched >= 4, f"only {launched} kernel launches per frame")
    print(f"  {size}x{size} spp2: rays {rays_k} image max diff {diff:.3g} "
          f"kernel launches {launched}")


def phase_config2(device, size: int = 512, burst: int = 16, reps: int = 3,
                  wave_reps: int = 20) -> dict:
    import numpy as np

    from vortex_rt_tpu_torch import Camera, RenderParams, WavefrontRenderer
    from vortex_rt_tpu_torch.ops.packet_walk import (
        trace_packets_walk, trace_packets_walk_ref,
    )
    from vortex_rt_tpu_torch.runtime import kernels

    sb, cfg = config2_scene()
    rk = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    rp = dataclasses.replace(rk, walk=trace_packets_walk_ref)
    cam = Camera.look_at(*EYE2)
    p = RenderParams(light_pos=LIGHT2, max_depth=2, shadow=True, spp=2)

    # ---- the main path's run: counts reset just before, read just after
    kernels.reset_launches()
    img, rays = rk.render(cam, p, size, size)
    _sync(device)
    launches = dict(kernels.LAUNCHES)
    _check(launches["packet_walk"] > 0, "the main path launched no kernel")
    _check(img.shape == (size, size, 3) and np.isfinite(img).all(),
           "config-2 image is not a finite (H, W, 3) image")
    _check(rays >= size * size * p.spp, f"ray count {rays} below primaries")
    img_p, rays_p = rp.render(cam, p, size, size)
    _check(rays_p == rays, f"ray count {rays} vs plain route {rays_p}")
    diff = float(np.abs(img - img_p).max())
    _check(diff <= IMG_ATOL, f"config-2 images differ by {diff}")
    print(f"  main path: rays {rays} launches {launches} "
          f"image max diff vs plain {diff:.3g}")

    # ---- sustained throughput: 3 x 16-frame bursts after a warm-up
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

    # ---- one primary wave through the kernel and the plain version
    o, d = camera_rays(cam, size, size, device)
    k, ks = trace_packets_walk(rk.wa, o, d)
    pp, ps = trace_packets_walk_ref(rk.wa, o, d)
    err = compare_hits(f"primary {size}x{size}", k, pp, ks, ps, False)
    ms = _elapsed_ms(lambda: trace_packets_walk(rk.wa, o, d), wave_reps,
                     device)
    plain_ms = _elapsed_ms(lambda: trace_packets_walk_ref(rk.wa, o, d), 3,
                           device)
    print(f"  primary wave {size}x{size}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    return dict(launches=launches["packet_walk"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, mrays=mrays)


def phase_scale(device, w: int = 1920, h: int = 1080) -> dict:
    import numpy as np
    import torch

    from vortex_rt_tpu_torch import RenderParams, Scene, WavefrontRenderer

    t0 = time.perf_counter()
    sb, cfg = scale_scene()
    r = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    build_s = time.perf_counter() - t0
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
    table_bytes = r.wa.nbytes + r.sa.nbytes
    out = dict(tris=sb.num_tris, nodes=int(r.wa.nodes.shape[0]),
               leaf_rows=int(r.wa.tri_rows.shape[0]), depth=r.wa.depth,
               table_bytes=table_bytes, rays=rays, frame_ms=dt * 1e3,
               mrays=rays / dt / 1e6, peak_bytes=int(peak),
               host_build_s=build_s)
    print(f"  scale scene {w}x{h} spp2 d2 shadow: {json.dumps(out)}")
    return out


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

    from vortex_rt_tpu_torch.runtime import kernels

    # 2. build
    t0 = time.perf_counter()
    lib = kernels.load("packet_walk")
    print(f"phase 2 build: {lib.path.name} in {time.perf_counter() - t0:.2f}"
          f" s (nvcc {lib.build_seconds:.2f} s)")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            print("  " + line.strip())

    print("phase 3 kernel vs plain version (64x64 rays)")
    err3 = phase_kernel_vs_plain(device)
    print("phase 4 frame, kernel vs plain (64x64)")
    phase_small_frame(device)
    print("phase 5 config 2 (512x512)")
    c2 = phase_config2(device)
    print("phase 6 scale scene (blob n=187, 1920x1080)")
    sc = phase_scale(device)
    print(f"  summary: config2 {c2['mrays']:.3f} Mrays/s, scale "
          f"{sc['mrays']:.3f} Mrays/s, peak {sc['peak_bytes']} B")

    # 7. results
    print(json.dumps({"kernels": [{
        "name": "packet_walk", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": c2["launches"],
        "max_abs_err": max(err3, c2["max_abs_err"]),
        "ms": c2["ms"], "plain_ms": c2["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
