"""Command-line renderer (port of ``vortex_rt_tpu/cli.py``).

Mirrors the reference app's CLI: ``-m model -w width -H height -s spp -d
depth -c (cpu golden) -o output``.  ``-m`` takes one or more .obj paths
(comma-separated; several are arranged on a circle around Y) or a
built-in scene name (cornell / sphere / soup, and the scale-ladder
stand-ins bunny / atrium / atrium_tex / waves).  ``-c`` renders with the
NumPy golden oracle instead of the device path.

The device path runs on the card (``--device cuda``, the default) and
exits with an error when there is none; ``--device cpu`` runs the same
path with the kernels' plain PyTorch versions.  Nothing falls back.

Usage:  python -m vortex_rt_tpu_torch.cli -m cornell -w 256 -H 256 -o out.ppm
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_scene(model: str):
    from vortex_rt_tpu_torch.models.procedural import (
        cornell_box, random_soup, uv_sphere,
    )
    from vortex_rt_tpu_torch.models.scene import Scene

    sc = Scene()
    if model == "cornell":
        for mesh, refl in cornell_box():
            i = sc.add_mesh(mesh)
            sc.add_instance(i, reflectivity=refl)
    elif model == "sphere":
        sc.add_mesh(uv_sphere((0, 0, 0), 1.0, 24, 48))
    elif model == "soup":
        sc.add_mesh(random_soup(np.random.default_rng(0), 2000))
    elif model in ("bunny", "atrium", "atrium_tex", "waves"):
        # the scale ladder's stand-ins (models.bigscenes)
        from vortex_rt_tpu_torch.models import bigscenes

        if model == "bunny":
            sc.add_mesh(bigscenes.blob(n=187))
        elif model == "atrium":
            for mesh, refl in bigscenes.atrium():
                sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
        elif model == "atrium_tex":
            for mesh, refl in bigscenes.textured_atrium():
                sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
        else:
            sc.add_mesh(bigscenes.wavy_grid())
    elif all(m.strip().endswith(".obj") for m in model.split(",")):
        # one or more OBJ files; several are arranged on a circle
        from vortex_rt_tpu_torch.io.obj import load_obj

        names = [m.strip() for m in model.split(",")]
        for name in names:
            mi = sc.add_mesh(load_obj(name))
            sc.add_instance(mi)
        if len(names) > 1:
            sc.arrange_around_y()
    else:
        raise SystemExit(f"unknown model {model!r}")
    return sc


def _device(ap: argparse.ArgumentParser, name: str):
    """The device the render runs on; the card unless asked for the CPU,
    and an error when it is not there."""
    import torch

    try:
        dev = torch.device(name)
    except RuntimeError as e:
        ap.error(f"--device {name!r}: {e}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: the renderer runs on the card (pass "
                 "--device cpu for the plain PyTorch path on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        ap.error(f"--device {name!r}: cuda or cpu")
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-m", "--model", default="cornell")
    ap.add_argument("-w", "--width", type=int, default=256)
    ap.add_argument("-H", "--height", type=int, default=256)
    ap.add_argument("-s", "--spp", type=int, default=1)
    ap.add_argument("-d", "--depth", type=int, default=2)
    ap.add_argument("-c", "--cpu", action="store_true",
                    help="render with the NumPy golden path (oracle)")
    ap.add_argument("-o", "--output", default="output.ppm")
    ap.add_argument("--vfov", type=float, default=45.0)
    ap.add_argument("--engine", choices=("megakernel", "wavefront"),
                    default="wavefront")
    ap.add_argument("--perf", action="store_true", help="print perf counters")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace JSON of the render")
    ap.add_argument("--scope-out", default=None, metavar="FILE",
                    help="frame logic-analyzer trace (scope analog): "
                         "per-stage ms spans + per-wave PerfStats "
                         "counter tracks on one Perfetto timeline")
    ap.add_argument("--shadow", action="store_true",
                    help="occlusion-tested direct lighting (shadow rays)")
    ap.add_argument("--pathtrace", action="store_true",
                    help="path-traced integrator (ladder configs 3-4) "
                         "instead of the Whitted closest shader")
    ap.add_argument("--bilinear", action="store_true",
                    help="bilinear texture filtering (texSampleBi)")
    ap.add_argument("--burst", type=int, default=0, metavar="N",
                    help="render N frames and report sustained Mrays/s "
                         "(the animation/throughput API)")
    ap.add_argument("--accum", type=int, default=0, metavar="N",
                    help="average N progressive passes (high-spp renders "
                         "without multiplying pool memory)")
    ap.add_argument("--ladder", default=None, metavar="CONFIGS",
                    help="run the scale ladder's rows (e.g. '3,5') and "
                         "exit — see tools/bench_ladder.py")
    ap.add_argument("--compare", action="store_true",
                    help="also render on the CPU golden oracle and report "
                         "the pixel RMSE (the reference's -c cross-check)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card, an error without "
                         "one) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.ladder is not None:
        import subprocess

        return subprocess.call(
            [sys.executable, "-m", "vortex_rt_tpu_torch.tools.bench_ladder",
             "--configs", args.ladder, "--device", args.device])
    for name in ("width", "height", "spp", "depth"):
        if getattr(args, name) < 1:
            ap.error(f"--{name} must be >= 1")
    device = None if args.cpu else _device(ap, args.device)

    from vortex_rt_tpu_torch.models.scene import RenderParams, Scene
    from vortex_rt_tpu_torch.utils.config import RTConfig
    from vortex_rt_tpu_torch.utils.image import write_ppm

    tracer = None
    if args.trace_out:
        from vortex_rt_tpu_torch.utils.trace import enable_tracing

        tracer = enable_tracing()

    sc = build_scene(args.model)
    # the wavefront device path traces the flattened single-BVH build
    # (instance transforms baked at build time, 8-wide fused rows: K1);
    # the megakernel engine and the golden oracle keep the TLAS layout
    flatten = args.engine == "wavefront" and not args.cpu
    sb = sc.build(RTConfig(flatten=flatten))
    aspect = args.width / args.height
    cam = Scene.framing_camera(sb, args.vfov, aspect, zoom=1.0)
    params = RenderParams(spp=args.spp, max_depth=args.depth,
                          shadow=args.shadow, pathtrace=args.pathtrace)

    t0 = time.perf_counter()
    if args.cpu:
        if args.pathtrace:
            from vortex_rt_tpu_torch.golden.renderer import render_golden_pt

            img = render_golden_pt(sb, cam, params, args.width,
                                   args.height).reshape(
                args.height, args.width, 3)
        else:
            from vortex_rt_tpu_torch.golden.renderer import render_golden

            img = render_golden(sb, cam, params, args.width, args.height)
        nrays = args.width * args.height * args.depth
    else:
        if args.engine == "megakernel":
            from vortex_rt_tpu_torch.engine.megakernel import (
                MegakernelRenderer,
            )

            r = MegakernelRenderer.from_buffers(sb, device=device)
        else:
            from vortex_rt_tpu_torch.engine.wavefront import (
                WavefrontRenderer,
            )

            cfg = RTConfig(
                flatten=True,
                tex_filter="bilinear" if args.bilinear else "point")
            r = WavefrontRenderer.from_buffers(sb, cfg, device=device)
        if args.burst > 0 and args.engine == "wavefront":
            img, nrays = r.render_burst(cam, params, args.width,
                                        args.height, n_frames=args.burst)
        elif args.accum > 0 and args.engine == "wavefront":
            img, nrays = r.render_accum(cam, params, args.width,
                                        args.height, n_passes=args.accum)
        else:
            img, nrays = r.render(cam, params, args.width, args.height)
    dt = time.perf_counter() - t0

    write_ppm(args.output, np.clip(img, 0, 1))
    mrays = nrays / dt / 1e6
    print(f"rendered {args.width}x{args.height} spp={args.spp} depth={args.depth} "
          f"model={args.model} engine={'cpu' if args.cpu else args.engine}: "
          f"{dt*1e3:.1f} ms, {nrays} rays, {mrays:.2f} Mrays/s -> {args.output}")
    if args.compare and not args.cpu:
        from vortex_rt_tpu_torch.golden.renderer import (
            render_golden, render_golden_pt,
        )
        from vortex_rt_tpu_torch.utils.image import rmse

        if args.pathtrace:
            if args.accum > 0:
                # replay the accumulation: n passes of spp samples
                # stratified over spp * n (render_accum's semantics)
                total = args.spp * args.accum
                gold = sum(
                    render_golden_pt(sb, cam, params, args.width,
                                     args.height, spp=args.spp,
                                     total_spp=total, seed=s)
                    for s in range(args.accum)) / args.accum
                gold = gold.reshape(args.height, args.width, 3)
            else:
                gold = render_golden_pt(sb, cam, params, args.width,
                                        args.height).reshape(
                    args.height, args.width, 3)
        else:
            gold = render_golden(sb, cam, params, args.width, args.height)
        err = rmse(np.clip(img, 0, 1), np.clip(gold, 0, 1))
        bad = (np.abs(np.clip(img, 0, 1)
                      - np.clip(gold, 0, 1)).max(-1) > 1 / 255).mean()
        # isolated exact-tie seam pixels may differ between the walk and
        # the oracle's brute force; the gate is RMSE or, failing that,
        # <1% differing pixels
        ok = err <= 2e-3 or bad < 0.01
        print(f"COMPARE: rmse={err:.6f} pixels_off={bad:.5f} "
              f"({'PASS' if ok else 'FAIL'}: rmse<=2e-3 or <1% seam px)")
    if args.perf:
        # vx_dump_perf analog: scene + run statistics
        print(f"PERF: tris={sb.num_tris} instances={sb.num_instances} "
              f"bvh_nodes={sb.bvh_min.shape[0]} tlas_nodes={sb.tlas_min.shape[0]} "
              f"rays={nrays} wall_ms={dt*1e3:.1f} mrays_per_s={mrays:.3f}")
        if not args.cpu and args.engine == "wavefront":
            # the RT unit's PerfStats: per-wave walk statistics of one
            # frame (the counting instantiations of the walks)
            for k, v in r.perf_trace(cam, params, args.width,
                                     args.height).items():
                print(f"PERF.trace: {k}={v}")
    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"trace -> {args.trace_out}")
    if args.scope_out and not args.cpu and args.engine == "wavefront":
        r.scope_trace(cam, params, args.width,
                      args.height).save(args.scope_out)
        print(f"scope -> {args.scope_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
