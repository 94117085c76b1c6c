"""Where a frame's time goes on the card: kernel launches per frame,
device kernel time per frame against the unprofiled frame time, and the
kernels that take the most device time.

    python -m vortex_rt_tpu_torch.tools.profile_frames --scene config2
    python -m vortex_rt_tpu_torch.tools.profile_frames --scene scale \\
        --frames 3
    python -m vortex_rt_tpu_torch.tools.profile_frames \\
        --scene config3,config4 --frames 2
    python -m vortex_rt_tpu_torch.tools.profile_frames --scene config5 \\
        --frames 4
    python -m vortex_rt_tpu_torch.tools.profile_frames \\
        --scene config6,config6hd --frames 4
    python -m vortex_rt_tpu_torch.tools.profile_frames --scene mk_a,mk_b \\
        --frames 4

``config2`` is BASELINE config 2 as ``bench.py`` renders it (Cornell box
and a 24x48 sphere, 512x512, spp 2, depth 2, shadow rays, flattened
8-wide fused build); ``scale`` is ``blob(n=187)`` at 1920x1080, spp 2,
depth 2, shadow rays, 8-wide.  ``config3`` and ``config4`` are the scale
ladder's path-traced frames at 1920x1080, depth 3, shadow rays:
``blob(n=187)`` at spp 4 (host-built) and ``atrium()`` at spp 8.
``config5`` is the ladder's animated mesh (``tools/bench_ladder.py``:
``wavy_grid(n=708)``, 1920x1080, spp 2, depth 2, shadow rays): every
frame ripples the vertices, refits and repacks the tree on the card, and
renders, so its split shows the refit beside the frame.  ``config6`` and
``config6hd`` are ladder row 6 at 512x512 and 1920x1080: the textured
atrium with ``alpha_test_anyhit(0.30)`` tested inside K1, spp 2, depth 2,
shadow rays.  ``mk_a`` and ``mk_b`` are the megakernel engine (K6 each
wave, ``engine/megakernel.py``): config 2's scene in the TLAS layout with
the sphere at reflectivity 0.6, 512x512, spp 4, depth 3; and
``atrium()``'s TLAS over 29 BLASes at 1920x1080, spp 1, depth 2 (the
CLI's ``-m atrium --engine megakernel``).

After one warm-up frame, ``--frames`` frames are timed unprofiled (wall
clock, device-synchronised), then the same number run under
``torch.profiler`` with CUDA activity.  Device time is the sum of the
kernel events' self device time (``key_averages()``, entries on the
CUDA device); launches are their counts.  The busy share is device time
per frame over unprofiled wall time per frame: the card runs one stream,
so kernels do not overlap.  Prints a table and, last, one JSON line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

TOP = 12  # kernels listed, by device time
# kernels reported by name even below the top: the walk and the refit's
WATCHED = ("traverse_packet_kernel", "refit_tile_kernel",
           "pack_nodes_kernel", "pack_leaves_kernel", "traverse_wide_kernel",
           "traverse2_kernel")
PROFILE_TRIES = 5  # sessions kernel_events tries before it gives up


class MegakernelFrames:
    """The megakernel engine behind ``profile``'s frame call: frames one
    call each, seeds ``seed0`` on; returns the rays."""

    def __init__(self, r) -> None:
        self.r = r

    def render_burst(self, cam, p, w: int, h: int, n_frames: int = 1,
                     seed0: int = 0, rays_only: bool = True) -> int:
        rays = 0
        for i in range(n_frames):
            rays += int(self.r.frame(cam, p, w, h, seed=seed0 + i)[1])
        return rays


def build(scene: str, device):
    """(renderer, camera, params, frame width, frame height)."""
    from vortex_rt_tpu_torch import (
        RenderParams, RTConfig, Scene, WavefrontRenderer,
    )
    from vortex_rt_tpu_torch.models import bigscenes, config2

    sc = Scene()
    cfg = RTConfig(flatten=True)
    if scene == "config2":
        sb, cfg = config2.config2_scene()
        cam, p = config2.config2_camera(), config2.config2_params()
        w = h = config2.SIZE2
    elif scene in ("scale", "config3", "config4"):
        if scene == "config4":
            for mesh, refl in bigscenes.atrium():
                sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
        else:
            sc.add_instance(sc.add_mesh(bigscenes.blob(n=187)))
        sb = sc.build(cfg)
        w, h = 1920, 1080
        cam = Scene.framing_camera(sb, 45.0, w / h)
        p = {"scale": RenderParams(max_depth=2, spp=2, shadow=True),
             "config3": RenderParams(max_depth=3, spp=4, shadow=True,
                                     pathtrace=True),
             "config4": RenderParams(max_depth=3, spp=8, shadow=True,
                                     pathtrace=True)}[scene]
    elif scene in ("mk_a", "mk_b"):
        from vortex_rt_tpu_torch.engine.megakernel import MegakernelRenderer

        if scene == "mk_a":
            sb, _ = config2.config2_scene(sphere_refl=0.6, flatten=False)
            cam = config2.config2_camera()
            p = RenderParams(light_pos=config2.LIGHT2, max_depth=3, spp=4)
            w = h = config2.SIZE2
        else:
            for mesh, refl in bigscenes.atrium():
                sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
            sb = sc.build(RTConfig())
            w, h = 1920, 1080
            cam = Scene.framing_camera(sb, 45.0, w / h, zoom=1.0)
            p = RenderParams(spp=1, max_depth=2)
        r = MegakernelRenderer.from_buffers(sb, device=device)
        return MegakernelFrames(r), cam, p, w, h
    elif scene in ("config6", "config6hd"):
        from vortex_rt_tpu_torch.tools import bench_ladder

        _, r, cam, p, _ = bench_ladder.setup6(device)
        w, h = (512, 512) if scene == "config6" else (1920, 1080)
        return r, cam, p, w, h
    else:
        raise ValueError(f"unknown scene {scene!r}")
    return WavefrontRenderer.from_buffers(sb, cfg, device=device), cam, p, w, h


def build_refit(device, grid: int = 708):
    """``config5``: (the ladder tool's refit scene, camera, params, frame
    width, frame height)."""
    from vortex_rt_tpu_torch.tools import bench_ladder

    w, h = 1920, 1080
    st = bench_ladder.setup_config5(device, grid)
    return st, bench_ladder.camera5(st.sb, w, h), bench_ladder.params5(), w, h


def kernel_events(run: Callable[[], object]) -> list:
    """``run()`` under ``torch.profiler`` with CUDA activity -> the
    ``key_averages()`` entries on the CUDA device that have device time,
    longest first.  A profiler session now and then records no device
    activity at all after many sessions in one process (three in a row
    once, in chip_smoke's phase 11c); ``run()`` is then profiled again
    after a pause of a second a try, up to ``PROFILE_TRIES`` times in
    all.  Raises when none recorded any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for attempt in range(PROFILE_TRIES):
        time.sleep(attempt)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if kern:
            break
    else:
        raise RuntimeError(f"the profiler recorded no device kernel time in "
                           f"{PROFILE_TRIES} sessions")
    kern.sort(key=lambda e: -e.self_device_time_total)
    return kern


def ms_by_name(kern: list, names: Sequence[str], per: int) -> Dict[str, float]:
    """Device ms per ``per`` runs of the kernels whose name contains each
    of ``names``, from ``kernel_events``' entries."""
    return {name: sum(e.self_device_time_total for e in kern
                      if name in e.key) / 1e3 / per for name in names}


def profile(r, cam, p, w: int, h: int, frames: int,
            before_frame: Optional[Callable[[int], None]] = None) -> Dict:
    """Unprofiled and profiled runs of ``frames`` frames each; see the
    module docstring.  ``before_frame(i)`` runs before frame i, inside
    the timed and the profiled region (the refit of a moving mesh); the
    frames are then rendered one call each."""
    def run():
        if before_frame is None:
            return r.render_burst(cam, p, w, h, n_frames=frames, seed0=1,
                                  rays_only=True)
        rays = 0
        for i in range(frames):
            before_frame(i)
            rays += r.render_burst(cam, p, w, h, n_frames=1, seed0=1 + i,
                                   rays_only=True)
        return rays

    if before_frame is not None:
        before_frame(0)
    r.render_burst(cam, p, w, h, n_frames=1, seed0=0, rays_only=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rays = run()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / frames

    kern = kernel_events(run)
    dev_us = sum(e.self_device_time_total for e in kern)
    launches = sum(e.count for e in kern)
    return dict(
        frames=frames, rays_per_frame=rays / frames, frame_ms=frame_ms,
        device_ms_per_frame=dev_us / 1e3 / frames,
        busy_share=dev_us / 1e3 / frames / frame_ms,
        launches_per_frame=launches / frames,
        watched=ms_by_name(kern, WATCHED, frames),
        top=[dict(name=e.key[:120], share=e.self_device_time_total / dev_us,
                  ms_per_frame=e.self_device_time_total / 1e3 / frames,
                  launches_per_frame=e.count / frames)
             for e in kern[:TOP]])


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="config2",
                    help="config2, scale, config3, config4, config5, "
                    "config6, config6hd, mk_a, mk_b, or a comma list")
    ap.add_argument("--frames", type=int, default=8)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frames: no CUDA device")
    device = torch.device("cuda", 0)
    out = []
    for scene in a.scene.split(","):
        hook = None
        if scene == "config5":
            st, cam, p, w, h = build_refit(device)
            r = st.r

            def hook(i, st=st, r=r):
                r.wa = st.refit_frame(0.1 * (i + 1))
        else:
            r, cam, p, w, h = build(scene, device)
        # the megakernel walks a binary tree
        width = r.wa.width if hasattr(r, "wa") else 2
        res = dict(scene=scene, bvh_width=width, w=w, h=h,
                   **profile(r, cam, p, w, h, a.frames, hook))
        print(f"{scene} {w}x{h} ({width}-wide), {a.frames} frames, "
              f"{torch.cuda.get_device_name(device)}: "
              f"{res['frame_ms']:.3f} ms/frame unprofiled, "
              f"{res['device_ms_per_frame']:.3f} ms device time/frame, busy "
              f"{res['busy_share']:.1%}, {res['launches_per_frame']:.0f} "
              f"launches/frame")
        for t in res["top"]:
            print(f"  {t['share']:6.1%} {t['ms_per_frame']:8.3f} ms "
                  f"{t['launches_per_frame']:6.0f}x  {t['name']}")
        print("  by name, ms/frame: " + ", ".join(
            f"{k} {v:.4f}" for k, v in res["watched"].items()))
        out.append(res)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
