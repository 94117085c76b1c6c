"""The ladder's six rows on the port (port of ``tools/bench_ladder.py``:
``config1``, ``config2``, ``_scale_cfg`` for rows 3 and 4, ``config5`` and
``config6``), one JSON line a row.

    python -m vortex_rt_tpu_torch.tools.bench_ladder --configs 1,2,3,4,5,6

- **row 1**: the Cornell box alone, flattened (8-wide fused, leaf 4),
  256x256, ``framing_camera(sb, 45, 1)``, spp 2, depth 1, no shadow rays,
  Whitted.
- **row 2**: config 2 as ``bench.py`` renders it (``models/config2.py``:
  the Cornell box with ``bench.py``'s sphere; its camera and light),
  512x512, spp 2, depth 2, shadow rays.
- **row 4**: ``atrium()`` (259,594 triangles in 29 meshes, each with its
  reflectivity), flattened, native host build, 1920x1080, spp 8, depth 3,
  shadow rays, path traced, ``framing_camera(sb, 45, 1920/1080)``.

Rows 1 and 2 are timed as the bench entry times config 2
(``bench_bursts``: a 16-frame ``render_burst`` warm-up, then 3 timed
16-frame bursts, wall time); row 4 one frame a call after a warm-up
frame (``bench_frames``).  Each keeps the JAX row's golden parity
through the port's oracle (``golden/renderer.py``): rows 1 and 2 the
spp-1 image at 16 pixels drawn with seed 7 (``sample_pixel_parity``),
row 4 the bench-spp frame at 8 pixels (``render_golden_pt``), RMSE below
3e-3 (``parity_rmse``, ``parity_ok``).  ``launches_per_frame`` counts
each kernel's launches a frame over a row's timed calls (none on the
CPU, whose walks are the plain versions).

- **row 5**, the animated mesh: ``wavy_grid(n=708)`` (999,698 triangles),
  1920x1080, spp 2, depth 2, shadow rays, Whitted, light (0, 14, 0), flat
  8-wide, leaf 4.  The topology is built once on the device; each frame
  ripples the vertices, refits, repacks and writes the fused rows
  (``refit_frame``), then renders through ``render_burst(n_frames=1)``:
  four moved frames after a warm-up.
- **row 3**: ``blob(n=187)``, 1920x1080, spp 4, depth 3, shadow rays,
  path traced, on a tree built on the device: by PLOC (radius 16), the
  JAX ladder's default there (``--lbvh ploc``), or the Karras LBVH
  (``--lbvh karras``).

Build and refit times are medians of CUDA-event times around the calls
after a warm-up (wall time on the CPU; row 5's refit is the median of its
four frames'); frame times are wall times of one frame per call after a
warm-up frame, as the JAX ladder times its heavy rows (row 3 times its
frame on the device-built and on the host-built tree the same way, in
turns).  There is no jit,
so no compile/run split.  The JAX rows' parity against the golden oracle
is here a check against the host-built tree of
the same mesh: row 5 renders its t = 0 frame from both (images within
1e-5, ray counts equal); row 3 traces the camera rays over both (same
hit mask, triangle ids and distances to the bit; mean and largest steps
per ray on both) and prints the difference of the two path-traced
frames.

- **row 6**, textured alpha-cutout any-hit: ``textured_atrium()``
  (259,594 triangles; the procedural checker stands in for absent
  texture assets), flat 8-wide, leaf 4, ``alpha_test_anyhit(0.30)`` tested
  inside K1 (``alpha_ref``), the camera ``framing_camera(sb, 45.0, 1.0)``,
  light (0, 8, 0), spp 2, depth 2, shadow rays: frames at 512x512 and
  1920x1080 (one per call after a warm-up, as above); then the parity of
  a 192x192 frame against the per-ray suspension engine
  (``RTConfig(packet_size=0)`` on the TLAS build, K3 and ``commit``):
  RMSE below 1e-4, as the JAX row's gate, and equal ray counts.

A row that fails raises (the JAX ladder records the error and goes on);
the command exits 1 when a row fails its parity.  ``--res1``, ``--res2``,
``--atrium4``, ``--grid``, ``--blob``, ``--res``, ``--res6``,
``--atrium``, ``--atrium-cols`` and ``--parity-res`` shrink the meshes
and the frames (the CPU tests run row 5 on ``wavy_grid(n=24)`` at 32x32),
and change nothing at their defaults.  Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from vortex_rt_tpu_torch.accel import lbvh, ploc
from vortex_rt_tpu_torch.engine.shaders import (
    ShaderTable, alpha_test_anyhit, stateless_anyhit,
)
from vortex_rt_tpu_torch.engine.wavefront import WavefrontRenderer
from vortex_rt_tpu_torch.models import bigscenes, config2
from vortex_rt_tpu_torch.models.procedural import cornell_box
from vortex_rt_tpu_torch.models.scene import (
    Camera, RenderParams, Scene, SceneBuffers,
)
from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays
from vortex_rt_tpu_torch.runtime import kernels
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT, RTConfig

IMG_ATOL = 1e-5
LIGHT5 = (0.0, 14.0, 0.0)
LIGHT6 = (0.0, 8.0, 0.0)
ALPHA6 = 0.30         # row 6's alpha_test_anyhit threshold
PARITY6_RMSE = 1e-4   # the JAX row's gate against the suspension engine
MOVED_TS = (0.1, 0.2, 0.3, 0.4)  # the four timed refit frames
BUILD_REPS = 10  # row 5's timed topology builds (the median is reported)
BURST, REPS = 16, 3   # rows 1 and 2: frames a burst, timed bursts
PARITY_RMSE = 3e-3    # rows 1, 2 and 4: the JAX rows' golden gate
HD = (1920, 1080)


def timed_ms(fn: Callable[[], object], device, reps: int = 1) -> List[float]:
    """Per-call times of ``fn`` in ms: CUDA events around each call on a
    card, wall time on the CPU."""
    out = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def ripple(v: torch.Tensor, t: float) -> torch.Tensor:
    """Rest vertices ``v`` with the ripple field at time ``t``, less the
    field at 0, added to their heights.  The difference is taken first
    (the JAX tool adds, then subtracts), so t = 0 gives the rest mesh
    back to the bit and its frame can be held against the host-built
    tree's."""
    def field(t_):
        return (0.3 * torch.sin(0.7 * v[:, 0] + 2.1 * t_)
                * torch.cos(0.5 * v[:, 2] - 1.3 * t_))

    out = v.clone()
    out[:, 1] = v[:, 1] + (field(t) - field(0.0))
    return out


@dataclasses.dataclass
class RefitScene:
    """Row 5's state: the host-built renderer (shading tables, and the
    tree the t = 0 frame is checked against), the rest vertices on the
    device, the topology and its compact plan."""

    sb: SceneBuffers
    cfg: RTConfig
    r: WavefrontRenderer
    host_wa: WideArrays
    verts: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    topo: lbvh.LBVHTopo
    pool_rows: int
    leaf_rows: int
    surv_idx: torch.Tensor
    build_ms: float

    def moved(self, t: float):
        """The three vertex arrays at time ``t``."""
        return tuple(ripple(v, t) for v in self.verts)

    def refit_frame(self, t: float) -> WideArrays:
        """Ripple, refit, repack, fused rows: one frame's tree."""
        lb = lbvh.refit_lbvh(
            self.topo, *self.moved(t), leaf_size=self.cfg.max_leaf_tris,
            width=self.cfg.bvh_width, pool_rows=self.pool_rows,
            leaf_rows=self.leaf_rows, surv_idx=self.surv_idx)
        return lbvh.wide_arrays_from_lbvh(lb, self.cfg.max_leaf_tris,
                                          width=self.cfg.bvh_width)


def _single_mesh(mesh, cfg: RTConfig) -> SceneBuffers:
    sc = Scene()
    sc.add_instance(sc.add_mesh(mesh))
    return sc.build(cfg)


def _device_verts(sb: SceneBuffers, leaf: int, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for v in lbvh.pad_tris(sb.v0, sb.v1, sb.v2, leaf))


def setup_config5(device, grid: int = 708,
                  cfg: Optional[RTConfig] = None) -> RefitScene:
    """Build row 5's scene on the host (shading tables and the reference
    tree), then its topology on ``device``: a warm-up build, then
    ``BUILD_REPS`` timed builds (``build_ms`` their median)."""
    device = torch.device(device)
    cfg = cfg or RTConfig(flatten=True)
    sb = _single_mesh(bigscenes.wavy_grid(n=grid), cfg)
    r = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    verts = _device_verts(sb, cfg.max_leaf_tris, device)

    def build():
        return lbvh.build_lbvh_topo(*verts, leaf_size=cfg.max_leaf_tris,
                                    width=cfg.bvh_width)[1]

    build()
    topo = None

    def timed_build():
        nonlocal topo
        topo = build()

    build_ms = statistics.median(timed_ms(timed_build, device, BUILD_REPS))
    pool_rows, leaf_rows, surv_idx = lbvh.compact_plan(topo)
    return RefitScene(sb=sb, cfg=cfg, r=r, host_wa=r.wa, verts=verts,
                      topo=topo, pool_rows=pool_rows, leaf_rows=leaf_rows,
                      surv_idx=surv_idx, build_ms=build_ms)


def camera5(sb: SceneBuffers, w: int, h: int) -> Camera:
    return Scene.framing_camera(sb, 45.0, w / h)


def params5() -> RenderParams:
    return RenderParams(max_depth=2, spp=2, shadow=True, light_pos=LIGHT5)


def bench_frames(r: WavefrontRenderer, cam, params, w: int, h: int,
                 n_timed: int = 2) -> dict:
    """One frame per call, after a warm-up frame (wall time)."""
    r.render_burst(cam, params, w, h, n_frames=1, seed0=100, rays_only=True)
    t0 = time.perf_counter()
    total = 0
    for i in range(n_timed):
        total += r.render_burst(cam, params, w, h, n_frames=1,
                                seed0=200 + i, rays_only=True)
    dt = time.perf_counter() - t0
    return dict(rays_per_frame=total // n_timed, mrays=total / dt / 1e6,
                ms_per_frame=dt * 1e3 / n_timed)


def bench_bursts(r: WavefrontRenderer, cam, params, w: int, h: int,
                 burst: int = BURST, reps: int = REPS) -> dict:
    """One ``burst``-frame warm-up, then ``reps`` timed bursts (wall time;
    a burst waits for the device once, when it reads its ray count)."""
    r.render_burst(cam, params, w, h, n_frames=burst, seed0=0,
                   rays_only=True)
    total = 0
    t0 = time.perf_counter()
    for i in range(reps):
        total += r.render_burst(cam, params, w, h, n_frames=burst,
                                seed0=(i + 1) * burst, rays_only=True)
    dt = time.perf_counter() - t0
    return dict(rays_per_frame=total // (reps * burst),
                mrays=total / dt / 1e6,
                ms_per_frame=dt * 1e3 / (reps * burst))


@dataclasses.dataclass
class Row:
    """A golden-gated ladder row (1, 2 or 4): its scene on the host, its
    renderer, camera, parameters and frame size."""

    num: int
    scene: str
    sb: SceneBuffers
    r: WavefrontRenderer
    cam: Camera
    p: RenderParams
    res: Tuple[int, int]


def _flat_scene(meshes, cfg: RTConfig) -> SceneBuffers:
    sc = Scene()
    for mesh, refl in meshes:
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    return sc.build(cfg)


def setup1(device, res=(256, 256)) -> Row:
    """Row 1: the Cornell box alone, primary rays only."""
    cfg = RTConfig(flatten=True)
    sb = _flat_scene(cornell_box(), cfg)
    r = WavefrontRenderer.from_buffers(sb, cfg, device=torch.device(device))
    return Row(1, "cornell", sb, r, Scene.framing_camera(sb, 45.0, 1.0),
               RenderParams(max_depth=1, spp=2), tuple(res))


def setup2(device, res=None, width: int = 0, leaf: int = 4) -> Row:
    """Row 2: config 2 as ``bench.py`` renders it, at ``res`` (default
    ``config2.SIZE2`` square; ``width``, ``leaf``: the build's, as the
    bench entry's flags set them)."""
    res = res or (config2.SIZE2, config2.SIZE2)
    sb, cfg = config2.config2_scene(width=width, leaf=leaf)
    r = WavefrontRenderer.from_buffers(sb, cfg, device=torch.device(device))
    return Row(2, config2.SCENE2, sb, r,
               config2.config2_camera(), config2.config2_params(), tuple(res))


def setup4(device, res=HD, target_tris: int = 260_000,
           r: Optional[WavefrontRenderer] = None) -> Row:
    """Row 4: the atrium, path traced (``r``: its renderer, made already
    from ``atrium(target_tris)`` with ``RTConfig(flatten=True)``)."""
    if r is None:
        cfg = RTConfig(flatten=True)
        sb = _flat_scene(bigscenes.atrium(target_tris=target_tris), cfg)
        r = WavefrontRenderer.from_buffers(sb, cfg,
                                           device=torch.device(device))
    w, h = res
    return Row(4, "atrium", r.sb, r, Scene.framing_camera(r.sb, 45.0, w / h),
               RenderParams(max_depth=3, spp=8, shadow=True, pathtrace=True),
               tuple(res))


def golden_parity(row: Row, n: int, seed: int = 7) -> dict:
    """The JAX ladder's ``_parity`` through the port's oracle: a Whitted
    row's spp-1 image at ``n`` pixels drawn with ``seed``
    (``sample_pixel_parity``), a path-traced row's frame at the bench spp
    at ``n`` pixels (``render_golden_pt`` replays its samples); RMSE
    below ``PARITY_RMSE``."""
    from vortex_rt_tpu_torch.golden.renderer import (
        render_golden_pt, sample_pixel_parity,
    )

    (w, h), p = row.res, row.p
    if p.pathtrace:
        img, _ = row.r.render(row.cam, p, w, h)
        pix = np.random.default_rng(seed).choice(w * h, size=n,
                                                 replace=False)
        ref = render_golden_pt(row.sb, row.cam, p, w, h, seed=0, pixels=pix)
        got = np.asarray(img, np.float32).reshape(-1, 3)[pix]
        rmse = float(np.sqrt(((got - ref) ** 2).mean()))
    else:
        p = dataclasses.replace(p, spp=1)
        img, _ = row.r.render(row.cam, p, w, h)
        rmse, _, _ = sample_pixel_parity(row.sb, row.cam, p, w, h, img, n=n,
                                         seed=seed)
    return dict(parity_rmse=rmse, parity_pixels=n, parity_seed=seed,
                parity_ok=bool(rmse < PARITY_RMSE and np.isfinite(img).all()))


def run_row(row: Row) -> dict:
    """A row's record: the frame's rays, Mrays/s and ms/frame, the
    launches a frame of each kernel over the timed calls, and the golden
    parity."""
    (w, h), p = row.res, row.p
    rec = dict(config=row.num, scene=row.scene, tris=row.sb.num_tris,
               res=f"{w}x{h}", spp=p.spp, depth=p.max_depth, shadow=p.shadow,
               pathtrace=p.pathtrace, bvh_width=row.r.config.bvh_width,
               max_leaf_tris=row.r.config.max_leaf_tris,
               fused=row.r.wa.fused is not None)
    before = dict(kernels.LAUNCHES)
    if row.num == 4:
        n_frames = 3  # bench_frames: a warm-up and two timed frames
        rec.update(bench_frames(row.r, row.cam, p, w, h))
    else:
        n_frames = BURST * (REPS + 1)
        rec.update(bench_bursts(row.r, row.cam, p, w, h, BURST, REPS))
    rec["launches_per_frame"] = {
        k: (v - before.get(k, 0)) / n_frames
        for k, v in kernels.LAUNCHES.items() if v != before.get(k, 0)}
    rec.update(golden_parity(row, 8 if row.num == 4 else 16))
    return rec


def config5(device, grid: int = 708, res=(1920, 1080),
            state: Optional[RefitScene] = None) -> dict:
    """Row 5.  ``state`` is a scene ``setup_config5`` already built."""
    device = torch.device(device)
    w, h = res
    st = state or setup_config5(device, grid)
    rec = dict(config=5, scene=f"wavy_grid(n={grid})", tris=st.sb.num_tris,
               res=f"{w}x{h}", spp=2, depth=2, shadow=True, pathtrace=False,
               bvh_width=st.cfg.bvh_width, max_leaf_tris=st.cfg.max_leaf_tris,
               lbvh="karras", lbvh_build_ms=st.build_ms,
               refit_pool_rows=st.pool_rows, refit_leaf_rows=st.leaf_rows,
               survivors=int(st.topo.surv.sum()))
    r, cam, p = st.r, camera5(st.sb, w, h), params5()
    # warm-up: the t = 0 tree and a frame on it
    r.wa = st.refit_frame(0.0)
    r.render_burst(cam, p, w, h, n_frames=1, seed0=100, rays_only=True)
    refit_ms, frame_s, total = [], 0.0, 0
    for i, t in enumerate(MOVED_TS):
        def step(t=t):
            r.wa = st.refit_frame(t)
        refit_ms += timed_ms(step, device)
        t0 = time.perf_counter()
        total += r.render_burst(cam, p, w, h, n_frames=1, seed0=200 + i,
                                rays_only=True)
        frame_s += time.perf_counter() - t0
    n = len(MOVED_TS)
    rec.update(refit_ms=statistics.median(refit_ms),
               fused_bytes=r.wa.fused.numel() * 4,
               rays_per_frame=total // n, mrays=total / frame_s / 1e6,
               ms_per_frame=frame_s * 1e3 / n)
    rec["frame_plus_refit_ms"] = rec["ms_per_frame"] + rec["refit_ms"]

    # the t = 0 refit tree bounds the rest mesh: its frame against the
    # host-built tree's
    r.wa = st.refit_frame(0.0)
    img, rays = r.render(cam, p, w, h)
    img_h, rays_h = dataclasses.replace(r, wa=st.host_wa).render(cam, p, w, h)
    diff = float(np.abs(img - img_h).max())
    rec.update(parity_max_abs=diff, rays_t0=rays, rays_host_tree=rays_h,
               parity_ok=bool(diff <= IMG_ATOL and rays == rays_h
                              and np.isfinite(img).all()))
    return rec


def camera_hits_equal(wa_a: WideArrays, wa_b: WideArrays, cam, w: int, h: int,
                      walk) -> dict:
    """Pixel-center camera rays over two trees of one mesh: the same hit
    mask, triangle ids and distances to the bit?"""
    from vortex_rt_tpu_torch.engine import wavefront as wf
    from vortex_rt_tpu_torch.engine.megakernel import CameraArrays

    dev = wa_a.device
    lane = torch.arange(w * h, dtype=torch.int64, device=dev)
    pxi, pyi = wf._tile_pixel_ids(lane, w, 16, 8 if h % 16 else 16)
    pix = pyi * w + pxi
    ox, oy, oz, dx, dy, dz = wf._camera_from_pix(
        CameraArrays.from_camera(cam, dev), w, h, pxi, pyi, pix,
        torch.zeros_like(pix), 1)
    o, d = torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1)
    (a, sa), (b, sb_) = walk(wa_a, o, d), walk(wa_b, o, d)
    hit = b.dist < LARGE_FLOAT
    return dict(
        rays=int(hit.numel()), hits=int(hit.sum()),
        same_mask=bool(torch.equal(a.dist < LARGE_FLOAT, hit)),
        same_tri=bool(torch.equal(a.tri[hit], b.tri[hit])),
        same_dist=bool(torch.equal(a.dist, b.dist)),
        mean_steps_device_tree=float(sa.float().mean()),
        mean_steps_host_tree=float(sb_.float().mean()),
        max_steps_device_tree=int(sa.max()), max_steps_host_tree=int(sb_.max()))


def config3(device, method: str = "ploc", blob_n: int = 187,
            res=(1920, 1080), radius: int = 16) -> dict:
    """Row 3 on a tree built on ``device`` by ``method`` (``ploc`` with
    ``radius``, or ``karras``)."""
    if method not in ("ploc", "karras"):
        raise ValueError(f"unknown --lbvh {method!r}")
    device = torch.device(device)
    w, h = res
    cfg = RTConfig(flatten=True)
    sb = _single_mesh(bigscenes.blob(n=blob_n), cfg)
    r = WavefrontRenderer.from_buffers(sb, cfg, device=device)
    host_wa = r.wa
    rec = dict(config=3, scene=f"blob(n={blob_n})", tris=sb.num_tris,
               res=f"{w}x{h}", spp=4, depth=3, shadow=True, pathtrace=True,
               bvh_width=cfg.bvh_width, max_leaf_tris=cfg.max_leaf_tris,
               lbvh=method)
    if method == "ploc":
        rec["ploc_radius"] = radius

    wa, ptopo = None, None

    def build():
        nonlocal wa, ptopo
        if method == "karras":
            wa = lbvh.build_wide_from_tris(sb, leaf_size=cfg.max_leaf_tris,
                                           width=cfg.bvh_width, device=device)
            return
        verts = _device_verts(sb, cfg.max_leaf_tris, device)
        lb, ptopo = ploc.build_ploc_topo(*verts, leaf_size=cfg.max_leaf_tris,
                                         width=cfg.bvh_width, radius=radius)
        wa = ploc.wide_arrays_from_ploc(lb, ptopo, cfg.max_leaf_tris,
                                        cfg.bvh_width)

    build()  # warm-up
    rec["lbvh_build_ms"] = statistics.median(timed_ms(build, device, 5))
    rec["pool_rows"] = int(wa.nodes.shape[0])
    if ptopo is not None:
        rec.update(ploc_rounds=int(ptopo.n_levels),
                   leaf_rows=int((ptopo.topo.row_cnt > 0).sum()),
                   internals=int(ptopo.n_int),
                   tree_depth=int(ptopo.wide_depth), walk_depth=wa.depth)
    cam = Scene.framing_camera(sb, 45.0, w / h)
    p = RenderParams(max_depth=3, spp=4, shadow=True, pathtrace=True)
    # the frame on the device-built tree and on the host-built tree, timed
    # the same way, in turns (device, host, host, device)
    turns = {"device": [], "host": []}
    for name in ("device", "host", "host", "device"):
        r.wa = wa if name == "device" else host_wa
        turns[name].append(bench_frames(r, cam, p, w, h))
    r.wa = wa
    dev, host = turns["device"], turns["host"]
    rec.update(rays_per_frame=dev[0]["rays_per_frame"],
               mrays=statistics.mean(x["mrays"] for x in dev),
               ms_per_frame=statistics.mean(x["ms_per_frame"] for x in dev),
               ms_per_frame_host_tree=statistics.mean(x["ms_per_frame"]
                                                      for x in host),
               ms_per_frame_turns={k: [x["ms_per_frame"] for x in v]
                                   for k, v in turns.items()})
    rec["hits"] = camera_hits_equal(wa, host_wa, cam, w, h, r.walk)
    img, rays = r.render(cam, p, w, h)
    img_h, rays_h = dataclasses.replace(r, wa=host_wa).render(cam, p, w, h)
    rec.update(rays_device_tree=rays, rays_host_tree=rays_h,
               image_max_abs_vs_host_tree=float(np.abs(img - img_h).max()),
               parity_ok=bool(rec["hits"]["same_mask"]
                              and rec["hits"]["same_tri"]
                              and rec["hits"]["same_dist"]
                              and np.isfinite(img).all()))
    return rec


def atrium6(target_tris: int = 260_000, n_cols: int = 12):
    """Row 6's scene: the textured atrium."""
    sc = Scene()
    for mesh, refl in bigscenes.textured_atrium(n_cols=n_cols,
                                                target_tris=target_tris):
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    return sc


def params6() -> RenderParams:
    return RenderParams(max_depth=2, spp=2, shadow=True, light_pos=LIGHT6)


def checker_pred(u, v, alpha):
    """Row 6's stateless any-hit predicate (ROADMAP Queue 1 item 8b): a uv
    checkerboard cutout of six cells a unit that also drops near-black
    surfaces (tests/test_anyhit_inline.py::_checker_pred, in torch)."""
    cu = torch.floor(u * 6.0).to(torch.int32)
    cv = torch.floor(v * 6.0).to(torch.int32)
    return (((cu + cv) % 2) == 0) & (alpha >= 0.05)


def perforated_pred(u, v, alpha):
    """A perforated-panel cutout (ROADMAP Queue 1 item 8c; perforated
    metal, speaker grilles, procedural foliage masks): round holes of
    radius 0.3 on a 12-cell uv grid, a band where ``sin(25u) cos(25v)``
    reaches 0.8, and surfaces with ``alpha ** 2.2`` at or below 0.002
    cut out.  Its ``sqrt``, ``sin``, ``cos`` and ``**`` run correctly
    rounded in the walks (``ops/anyhit_pred.py``)."""
    du = (u * 12.0) % 1.0 - 0.5
    dv = (v * 12.0) % 1.0 - 0.5
    holes = torch.sqrt(du * du + dv * dv) > 0.3
    band = torch.sin(u * 25.0) * torch.cos(v * 25.0) < 0.8
    return holes & band & (alpha ** 2.2 > 0.002)


PREDICATES = {"checker": checker_pred, "perforated": perforated_pred}


def setup6(device, target_tris: int = 260_000, n_cols: int = 12,
           pred=False):
    """Row 6's scene, its flat 8-wide renderer with the alpha test (with
    ``pred``, True or a name of ``PREDICATES``:
    ``stateless_anyhit(checker_pred)`` or the named predicate, in K1's
    predicate mode), camera and parameters: (scene, renderer, camera,
    params, table)."""
    sc = atrium6(target_tris, n_cols)
    cfg = RTConfig(flatten=True)
    name = "checker" if pred is True else pred
    table = ShaderTable(anyhit=stateless_anyhit(PREDICATES[name], name)
                        if pred else alpha_test_anyhit(ALPHA6))
    r = WavefrontRenderer.from_buffers(sc.build(cfg), cfg, table,
                                       device=torch.device(device))
    return sc, r, Scene.framing_camera(r.sb, 45.0, 1.0), params6(), table


def frames6(r: WavefrontRenderer, cam, p, res=(512, 512),
            res_hd=(1920, 1080)) -> dict:
    """Row 6's frames at ``res`` and ``res_hd`` (one per call after a
    warm-up)."""
    rec = dict(config=6, scene="atrium_tex+alpha-anyhit",
               tris=r.sb.num_tris, res=f"{res[0]}x{res[1]}", spp=p.spp,
               depth=p.max_depth, shadow=p.shadow, anyhit=True, alpha=ALPHA6,
               bvh_width=r.config.bvh_width,
               max_leaf_tris=r.config.max_leaf_tris,
               fused_bytes=r.wa.fused.numel() * 4,
               table_bytes=r.wa.nbytes + r.sa.nbytes)
    rec.update(bench_frames(r, cam, p, *res))
    hd = bench_frames(r, cam, p, *res_hd)
    rec.update(res_hd=f"{res_hd[0]}x{res_hd[1]}",
               rays_per_frame_hd=hd["rays_per_frame"], mrays_hd=hd["mrays"],
               ms_per_frame_hd=hd["ms_per_frame"])
    return rec


def parity6(sc: Scene, r: WavefrontRenderer, cam, p, table,
            parity_res: int = 192) -> dict:
    """Row 6's gate: the ``parity_res`` frame in the walk against the
    per-ray suspension engine on the TLAS build (``packet_size=0``): RMSE
    below 1e-4 and equal ray counts.  ``k3_launches`` counts the
    suspension frame's K3 launches (its rounds, over all waves; 0 on the
    CPU, whose walk is the plain version)."""
    from vortex_rt_tpu_torch.runtime import kernels

    img, rays = r.render(cam, p, parity_res, parity_res)
    slow_cfg = RTConfig(packet_size=0)
    r_slow = WavefrontRenderer.from_buffers(sc.build(slow_cfg), slow_cfg,
                                            table, device=r.device)
    before = kernels.LAUNCHES["traverse_wide"]
    t0 = time.perf_counter()
    img_slow, rays_slow = r_slow.render(cam, p, parity_res, parity_res)
    slow_ms = (time.perf_counter() - t0) * 1e3
    rmse = float(np.sqrt(((img - img_slow) ** 2).mean()))
    return dict(parity_res=f"{parity_res}x{parity_res}", parity_rmse=rmse,
                parity_max_abs=float(np.abs(img - img_slow).max()),
                parity_vs="per-ray suspension engine (TLAS, packet_size=0)",
                rays_parity=rays, rays_suspension=rays_slow,
                suspension_ms=slow_ms,
                k3_launches=kernels.LAUNCHES["traverse_wide"] - before,
                parity_ok=bool(rmse < PARITY6_RMSE and rays == rays_slow
                               and np.isfinite(img).all()))


def config6(device, res=(512, 512), res_hd=(1920, 1080), parity_res=192,
            target_tris: int = 260_000, n_cols: int = 12) -> dict:
    """Row 6: the in-walk alpha test on the flat 8-wide build at ``res``
    and ``res_hd``, and the ``parity_res`` frame against the suspension
    engine on the TLAS build."""
    sc, r, cam, p, table = setup6(device, target_tris, n_cols)
    rec = frames6(r, cam, p, res, res_hd)
    rec.update(parity6(sc, r, cam, p, table, parity_res))
    return rec


def gpu_line() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def _size(text: str) -> Tuple[int, int]:
    w, h = (int(x) for x in text.split("x"))
    return w, h


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="1,2,3,4,5,6")
    ap.add_argument("--lbvh", default="ploc",
                    help="row 3's on-device build: ploc (radius 16, the "
                         "ladder's) or karras")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--res1", default="256x256", help="row 1's frame")
    ap.add_argument("--res2", default="512x512", help="row 2's frame")
    ap.add_argument("--atrium4", type=int, default=260_000,
                    help="row 4's atrium(target_tris)")
    ap.add_argument("--grid", type=int, default=708,
                    help="row 5's wavy_grid(n)")
    ap.add_argument("--blob", type=int, default=187, help="row 3's blob(n)")
    ap.add_argument("--res", default="1920x1080",
                    help="the frame of rows 3, 4 and 5, row 6's second")
    ap.add_argument("--res6", default="512x512",
                    help="row 6's first frame (its second is --res)")
    ap.add_argument("--parity-res", type=int, default=192,
                    help="row 6's parity frame side")
    ap.add_argument("--atrium", type=int, default=260_000,
                    help="row 6's textured_atrium(target_tris)")
    ap.add_argument("--atrium-cols", type=int, default=12,
                    help="row 6's textured_atrium(n_cols)")
    a = ap.parse_args(argv)
    res = _size(a.res)
    fns = {1: lambda: run_row(setup1(a.device, _size(a.res1))),
           2: lambda: run_row(setup2(a.device, _size(a.res2))),
           3: lambda: config3(a.device, a.lbvh, a.blob, res),
           4: lambda: run_row(setup4(a.device, res, a.atrium4)),
           5: lambda: config5(a.device, a.grid, res),
           6: lambda: config6(a.device, _size(a.res6), res, a.parity_res,
                              a.atrium, a.atrium_cols)}
    rows = [int(x) for x in a.configs.split(",")]
    unknown = [c for c in rows if c not in fns]
    if unknown:
        raise ValueError(f"ladder rows {unknown}: the ladder has rows 1-6")
    gpu = gpu_line() if a.device.startswith("cuda") else None
    out = []
    for c in rows:
        rec = fns[c]()
        rec["gpu"] = gpu
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    sys.exit(0 if all(r["parity_ok"] for r in main()) else 1)
