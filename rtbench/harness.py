"""One run of one cell: set-up, the measured window, the traced part of it,
the check against the reference, and the result line.

The system under test is ``vortex_rt_tpu_torch``; this module drives it
through its entry points and nothing else: ``Scene`` and
``WavefrontRenderer.from_buffers`` build the tables, ``frame_body``
renders each frame.

The window is a closed loop: one viewer hands a frame its inputs (its
sample seed) and waits for its image on the host before the next.  A
frame's wait runs from handing it its inputs to its image on the host;
the window runs from the first frame's dispatch to the last frame's
image.  Nothing
compiles inside it: set-up renders ``warmup_frames`` frames of the same
shapes first (the kernels are built, the allocator is grown).

What is checked: after the window, frames drawn from the seed, at pixels
drawn from the seed, against ``rtbench.reference`` (brute force, plain
PyTorch) given the same meshes, camera, light and seeds; and each
frame's ray count against the mean of the reference's counts at those
pixels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from rtbench import spec
from rtbench import trace as tr
from rtbench.reference import bounds, walk
from rtbench.reference.camera import Cam, framing_camera
from rtbench.reference.render import Light, frame_pixels
from rtbench.scenes import total_tris

FORBIDDEN = ("jax", "jaxlib", "flax", "vortex_rt_tpu")
U32 = 0xFFFFFFFF
PROFILE_TRIES = 3


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not have
    loaded, compared whole (``vortex_rt_tpu_torch`` is not
    ``vortex_rt_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def gpu_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
    return out.stdout.strip() or out.stderr.strip()


def frame_seeds(seed: int):
    """The first frame's sample seed from ``--seed``: frame i uses sample
    seed ``base + i`` (mod 2^32)."""
    return int(np.random.SeedSequence(int(seed)).generate_state(1)[0])


@dataclasses.dataclass
class Program:
    """The program's objects for one cell, and the inputs handed to it."""

    meshes: list
    cam: Cam
    light: Light
    traffic: dict
    device: torch.device
    cfg: object                     # RTConfig
    wa: object                      # WideArrays
    sa: object                      # ShadeArrays
    frame_body: Callable
    cam_arrays: object
    light_arrays: object
    table: object
    base_seed: int
    scene_build_s: float
    host_img: Optional[torch.Tensor] = None

    def frame_seed(self, i: int) -> int:
        return (self.base_seed + i) & U32

    def render(self, wa, i: int, walk=None, spp: Optional[int] = None):
        """frame_body of frame i over the tables ``wa``."""
        t = self.traffic
        cfg = self.cfg
        return self.frame_body(
            wa, self.sa, self.cam_arrays, self.light_arrays,
            t["width"], t["height"], max_depth=t["depth"],
            spp=spp or t["spp"], table=self.table, seed=self.frame_seed(i),
            shadow=t["shadow"], tile_w=cfg.tile_w, tile_h=cfg.tile_h,
            walk=walk, packet=cfg.packet_size)


def setup(cell: spec.Cell, seed: int, device: torch.device,
          config_params: Optional[dict] = None,
          traffic: Optional[dict] = None) -> Program:
    """Make the inputs from the cell's files and the seed, and hand them
    to the program: its tables."""
    from vortex_rt_tpu_torch import RenderParams, RTConfig, Scene
    from vortex_rt_tpu_torch.engine.megakernel import (
        CameraArrays, LightArrays,
    )
    from vortex_rt_tpu_torch.engine.shaders import (
        ShaderTable, pathtrace_closest,
    )
    from vortex_rt_tpu_torch.engine.wavefront import (
        WavefrontRenderer, frame_body,
    )
    from vortex_rt_tpu_torch.models.scene import Camera, Material, make_mesh

    t = dict(traffic or cell.traffic)
    c = cell.config
    params = dict(c["params"], **(config_params or {}))
    meshes = cell.scene.meshes(**params)
    if not config_params and (total_tris(meshes) != c["triangles"]
                              or len(meshes) != c["meshes"]):
        raise ValueError(f"{c['name']} made {total_tris(meshes)} triangles "
                         f"in {len(meshes)} meshes; its file states "
                         f"{c['triangles']} in {c['meshes']}")
    cam = framing_camera(meshes, t["vfov"], t["width"] / t["height"])
    light = Light(pos=tuple(c["light"]), background=tuple(c["background"]))
    cfg = RTConfig(**c["build"])

    t_build = time.perf_counter()
    sc = Scene()
    for m in meshes:
        mat = Material(diffuse=tuple(m.diffuse), diffuse_tex=m.tex)
        sc.add_instance(sc.add_mesh(make_mesh(
            m.v0, m.v1, m.v2, m.n0, m.n1, m.n2, m.uv0, m.uv1, m.uv2,
            materials=[mat])), reflectivity=m.reflectivity)
    r = WavefrontRenderer.from_buffers(sc.build(cfg), cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    scene_build_s = time.perf_counter() - t_build

    p = RenderParams(light_pos=light.pos, light_color=light.color,
                     ambient_color=light.ambient,
                     background_color=light.background)
    prog = Program(
        meshes=meshes, cam=cam, light=light, traffic=t, device=device,
        cfg=cfg, wa=r.wa, sa=r.sa, frame_body=frame_body,
        cam_arrays=CameraArrays.from_camera(
            Camera(cam.pos, cam.forward, cam.right, cam.up, cam.viewplane),
            device),
        light_arrays=LightArrays.from_params(p, device),
        table=(ShaderTable(closest=pathtrace_closest) if t["pathtrace"]
               else ShaderTable()),
        base_seed=frame_seeds(seed), scene_build_s=scene_build_s)
    n_pix = t["width"] * t["height"]
    prog.host_img = torch.empty((3, n_pix), dtype=torch.float32,
                                pin_memory=device.type == "cuda")
    return prog


@dataclasses.dataclass
class Window:
    """What the measured window recorded."""

    start: float
    end: float
    waits: List[float]           # seconds, one a frame
    spans: List[tuple]           # (start with the inputs, end), one a frame
    rays: np.ndarray             # rays traced, one a frame
    values: List[np.ndarray]     # (3, K) sampled pixel values, one a frame
    pixels: np.ndarray           # the K sampled pixel ids
    peak_bytes: int
    timed: int                   # frames inside the window (the rest traced)
    trace: Optional[dict] = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


def sample_pixels(seed: int, n_pix: int, k: int) -> np.ndarray:
    """``k`` distinct pixel ids drawn from the seed (every pixel when the
    frame has no more), sorted."""
    if k >= n_pix:
        return np.arange(n_pix)
    rng = np.random.default_rng([int(seed) & U32, int(seed) >> 32, 0x9E37])
    return np.sort(rng.choice(n_pix, size=k, replace=False))


def run_frame(prog: Program, i: int, label, hooks: dict):
    """One frame of the closed loop -> (wait seconds, rays tensor, the
    frame's start with its inputs).  The image lands in
    ``prog.host_img``."""
    t0 = time.perf_counter()
    with label("frame"):
        img, rays, _ = hooks.get("render", prog.render)(prog.wa, i)
    with label("image"):
        prog.host_img.copy_(img, non_blocking=True)
        if prog.device.type == "cuda":
            torch.cuda.current_stream().synchronize()
    return time.perf_counter() - t0, rays, t0


def warm_up(prog: Program, n: int, hooks: dict) -> None:
    for i in range(-n, 0):
        run_frame(prog, i, lambda _: contextlib.nullcontext(), hooks)


def window(prog: Program, seconds: float, pixels: np.ndarray,
           traced: bool, hooks: Optional[dict] = None) -> Window:
    """The measured window; with ``traced``, ``torch.profiler`` then
    records ``profile_frames`` more frames (again, up to
    ``PROFILE_TRIES`` times, while it records fewer hand-written launches
    than the program counted).  They follow the window: the profiler's
    cost on the host, and what it leaves behind once it stops, stay out
    of the frames that time a frame."""
    from vortex_rt_tpu_torch.runtime import kernels

    hooks = hooks or {}
    cuda = prog.device.type == "cuda"
    host_np = prog.host_img.numpy()
    waits, rays, values, spans = [], [], [], []
    prof = None

    def label(name):
        if prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(tr.PHASE + name)

    def frame(i):
        wait, r, t_in = run_frame(prog, i, label, hooks)
        spans.append((t_in, time.perf_counter()))
        waits.append(wait)
        rays.append(r)
        values.append(host_np[:, pixels].copy())

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    while not waits or time.perf_counter() - start < seconds:
        frame(len(waits))
    end = time.perf_counter()
    timed = len(waits)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    info = None
    for _ in range(PROFILE_TRIES if traced else 0):
        launches0 = sum(kernels.LAUNCHES.values())
        first = len(waits)
        prof = recorder = _start_profiler(cuda)
        for _ in range(prog.traffic["profile_frames"]):
            frame(len(waits))
        recorder.stop()
        prof = None
        info = _read_profile(recorder, list(range(first, len(waits))),
                             sum(kernels.LAUNCHES.values()) - launches0)
        if info["complete"]:
            break
        print(f"rtbench: the profiler recorded {info['hand_written_ops']} "
              f"of {info['expect']} hand-written launches; profiling again",
              file=sys.stderr)
    counts = torch.stack(rays).cpu().numpy().astype(np.int64)
    return Window(start=start, end=end, waits=waits, spans=spans, rays=counts,
                  values=values, pixels=pixels, peak_bytes=int(peak),
                  timed=timed, trace=info)


def _start_profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _read_profile(prof, frames: List[int], expect: int) -> dict:
    """The profiled frames' trace (``rtbench.trace.Trace``) and whether it
    holds every hand-written launch the program counted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        t = tr.Trace.from_chrome(path)
    finally:
        os.unlink(path)
    hand = sum(1 for o in t.ops if o.kind == "kernel" and tr.kernel_of(o.name))
    return dict(trace=t, frames=list(frames), expect=expect,
                hand_written_ops=hand,
                complete=bool(t.phases) and hand == expect)


def k1_bounds_ms(prog: Program, i: int) -> Optional[List[float]]:
    """K1's bound of each wave of the first pass of frame i, in launch
    order, each from the work of the walk on that wave's own rays as
    ``rtbench.reference.walk`` counts it: frame i is rendered again with
    a walk that records its waves.  None where the copy cannot read the
    table."""
    from vortex_rt_tpu_torch.ops import traverse_packet

    waves = []

    def recording(wa, o, d, **kw):
        waves.append((wa, o, d, kw))
        return traverse_packet.trace_packets(wa, o, d, **kw)

    prog.render(prog.wa, i, walk=recording)
    out = []
    for wa, o, d, kw in waves[:len(waves) // prog.traffic["spp"]]:
        kw = {k: v for k, v in kw.items() if k in (
            "active", "t_max", "occlusion", "occl_split")}
        work = walk.count(wa, o, d, **kw)
        if work is None:
            return None
        out.append(bounds.k1_bound(work, width=wa.width).ms)
    return out


def check(prog: Program, cell: spec.Cell, win: Window, seed: int,
          program_values=None) -> dict:
    """The compared numbers, each beside its limit, over frames drawn
    from the seed.  ``program_values`` (frame -> (3, K) values, frame ->
    rays) stands another side in the program's place (the control)."""
    c = cell.checks
    t = prog.traffic
    n = len(win.waits)
    rng = np.random.default_rng([int(seed) & U32, int(seed) >> 32, 0xC4EC])
    frames = sorted({int(x) for x in
                     (rng.random(t["check"]["frames"]) * n).astype(int)})
    n_pix = t["width"] * t["height"]
    diffs, ref_rays, got_rays = [], [], []
    for i in frames:
        ref, cnt = frame_pixels(prog.meshes, prog.cam, prog.light, t,
                                prog.frame_seed(i), win.pixels, prog.device,
                                torch.float32)
        if program_values is None:
            got, rays = win.values[i].T, int(win.rays[i])
        else:
            got, rays = program_values(i)
        diffs.append(np.abs(np.asarray(got, np.float64) - ref))
        ref_rays.append(cnt.mean())
        got_rays.append(rays / n_pix)
    d = np.concatenate(diffs)
    bad = ~np.isfinite(d).all(1) | (np.nan_to_num(d, nan=1.0).max(1)
                                    > c["bad_pixel_abs"])
    nums = {
        "px_bad_share": float(bad.mean()),
        "px_rmse": float(np.sqrt(np.mean(d ** 2))),
        "rays_gap": float(abs(np.mean(got_rays) - np.mean(ref_rays))
                          / max(np.mean(ref_rays), 1e-30)),
    }
    out = {k: {"value": v, "limit": c["limits"].get(k)}
           for k, v in nums.items()}
    out["frames_checked"] = {"value": len(frames), "limit": None}
    out["pixels_each"] = {"value": int(len(win.pixels)), "limit": None}
    return out


# the precision below each one a configuration may state
BELOW = {"float64": torch.float32, "float32": torch.bfloat16}


def control(prog: Program, win: Window, precision: str = "float32"):
    """The control, to stand in the program's place in ``check``: the
    reference itself at the same pixels, computed in the precision below
    the configuration's ``precision``; its frame's ray count is its
    pixels' mean count times the frame's pixels."""
    t = prog.traffic
    dtype = BELOW[precision]

    def values(i):
        got, cnt = frame_pixels(prog.meshes, prog.cam, prog.light, t,
                                prog.frame_seed(i), win.pixels, prog.device,
                                dtype)
        return got, float(cnt.mean()) * t["width"] * t["height"]

    return values


def checks_pass(checks: dict) -> bool:
    return all(v["limit"] is None or (v["value"] <= v["limit"])
               for v in checks.values())


def free(prog: Program) -> None:
    """Drop the program's tables and state before the reference runs."""
    prog.wa = prog.sa = None
    gc.collect()
    if prog.device.type == "cuda":
        torch.cuda.empty_cache()


def per_layer(prog: Program, win: Window) -> dict:
    """The traced frames' readings that the per-layer readers take.  The
    profiler's own cost on the host stretches the frames it records, so
    the device's busy seconds a frame come from the trace and the frame's
    length from the window's frames it did not record."""
    info = win.trace
    t = info["trace"]
    lo, hi = t.window()
    frames = t.frames()
    busy = [tr.busy_s(t, a, b) for a, b in frames]
    quiet = [b - a for k, (a, b) in enumerate(win.spans)
             if k not in info["frames"]]
    return dict(trace=t, lo=lo, hi=hi, frames=frames,
                frame_ids=info["frames"], complete=info["complete"],
                expect=info["expect"], scene_build_s=prog.scene_build_s,
                busy_per_frame=sum(busy) / len(busy),
                unprofiled_frames=len(quiet),
                unprofiled_s=sum(quiet))


def run(root: Path, workload: str, seed: int, seconds: float, traced: bool,
        device: torch.device, config_params: Optional[dict] = None,
        traffic: Optional[dict] = None,
        hooks: Optional[Callable[[Program], dict]] = None,
        stand_in: Optional[Callable] = None,
        age0: float = 0.0, t0: Optional[float] = None) -> dict:
    """One run -> the result line's object.  ``config_params`` and
    ``traffic`` override the cell's (the CPU tests' small sizes);
    ``hooks(prog)`` replace calls into the program (``rtbench.faults``);
    ``stand_in(prog, window, precision)`` puts another side in the program's place
    in the check (``control``)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.load_cell(root, workload)
    metrics = cell.per_layer if traced else cell.end_to_end
    read = spec.readers(metrics)
    prog = setup(cell, seed, device, config_params, traffic)
    hooks = hooks(prog) if hooks else {}
    t = prog.traffic
    t_w = time.perf_counter()
    warm_up(prog, t["warmup_frames"], hooks)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"rtbench: set-up: scene build and upload "
          f"{prog.scene_build_s:.2f} s, warm-up "
          f"{time.perf_counter() - t_w:.2f} s", file=sys.stderr)
    setup_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else 0
    pixels = sample_pixels(seed, t["width"] * t["height"],
                           t["check"]["pixels"])
    setup_s = age0 + time.perf_counter() - t0
    win = window(prog, seconds, pixels, traced, hooks)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"rtbench: sys.modules holds {', '.join(bad)}")
    waits_ms = [w * 1e3 for w in win.waits]
    timed = waits_ms[:win.timed]
    tenths = [statistics.mean(timed[k * len(timed) // 10:
                                    (k + 1) * len(timed) // 10] or [0.0])
              for k in range(10)]
    print(f"rtbench: {cell.name} seed {seed}: {len(timed)} frames in "
          f"{win.seconds:.4f} s, frame wait median "
          f"{statistics.median(timed):.4f} ms, min {min(timed):.4f}, max "
          f"{max(timed):.4f}, means by tenth of the window "
          f"{[round(x, 2) for x in tenths]}; "
          f"{int(win.rays[:len(timed)].sum())} rays; set-up {setup_s:.4f} s",
          file=sys.stderr)
    ctx = dict(cell=cell, window=win, setup_s=setup_s, prog=prog)
    device_rec = dict(
        platform="gpu" if device.type == "cuda" else device.type,
        kind=(torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu"),
        count=1, memory_peak_bytes=int(max(win.peak_bytes, setup_peak)))
    breakdown = None
    if traced:
        if win.trace is None:
            raise RuntimeError("the window closed before its profiled frames")
        ctx["layer"] = per_layer(prog, win)
        lay = ctx["layer"]
        lo, hi = lay["lo"], lay["hi"]
        device_rec.update(
            busy_s=lay["busy_per_frame"] * lay["unprofiled_frames"],
            window_s=lay["unprofiled_s"])
        if "k1_roofline" in read:
            t_b = time.perf_counter()
            ctx["layer"]["k1_bounds_ms"] = k1_bounds_ms(
                prog, ctx["layer"]["frame_ids"][0])
            print(f"rtbench: K1's bounds of the first pass of frame "
                  f"{ctx['layer']['frame_ids'][0]}: "
                  f"{ctx['layer']['k1_bounds_ms']} ms, worked out in "
                  f"{time.perf_counter() - t_b:.2f} s", file=sys.stderr)
        gaps = tr.gaps_by_phase(win.trace["trace"], lo, hi)
        breakdown = dict(
            device_ops=[[k, v] for k, v in
                        tr.top_ops(win.trace["trace"], lo, hi)],
            idle_gaps=[[k, v] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]])
        print(f"rtbench: traced {len(ctx['layer']['frame_ids'])} frames; "
              f"{ctx['layer']['expect']} hand-written launches counted by "
              f"the program, complete: {ctx['layer']['complete']}; card: "
              f"{gpu_line() if device.type == 'cuda' else 'cpu'}",
              file=sys.stderr)
    values = {}
    for m in metrics:
        v = read[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    free(prog)
    t_ref = time.perf_counter()
    checks = check(prog, cell, win, seed, program_values=(
        stand_in(prog, win, cell.config["precision"]) if stand_in
        else None))
    print(f"rtbench: the reference check took "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    nonfinite = sum(1 for v in win.values if not np.isfinite(v).all())
    out = dict(correct=checks_pass(checks), attempted=len(win.waits),
               failed=nonfinite, metrics=values, device=device_rec)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def print_checks(checks: dict) -> None:
    """Each compared number beside its limit, on the last lines of
    standard error."""
    for k, v in checks.items():
        lim = "-" if v["limit"] is None else repr(v["limit"])
        print(f"check {k}: {v['value']!r} (limit {lim})", file=sys.stderr)


