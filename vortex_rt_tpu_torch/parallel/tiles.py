"""Multi-device rendering by image row blocks (port of
``vortex_rt_tpu/parallel/tiles.py``) on ``torch.distributed``.

The JAX package maps a frame's rows onto a device mesh with
``shard_map``; here each rank of a process group is one device, and
``parallel.mesh.Mesh`` stands for the mesh:

* the scene's tables are replicated: every rank builds them and holds
  them on its own device;
* each rank makes and traces only the rays of its block of rows
  (``coords[axis] * rows``), with the frame's global pixel ids;
* the ray counts are summed over the ranks by an ``all_reduce``, as the
  JAX step sums them with ``psum``;
* a step returns its rank's block, and the host API gathers the blocks
  (``all_gather``) where the JAX one pulls the sharded image.

Two steps, as in the JAX package: the megakernel's waves
(``make_tiled_renderer``; K6 each wave on a card) and the whole wavefront
frame on each block (``make_tiled_wavefront``: ``frame_body`` with
``n_pix`` and ``pix_offset``, shadow rays, path tracing and spp; K1 on
8- and 16-wide fused tables, K2 on 4-wide ones).  Both give each rank's rows
exactly as one device renders them.  Scene shards are
``parallel.shards``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vortex_rt_tpu_torch.engine.megakernel import (
    CameraArrays, LightArrays, MegakernelRenderer, trace_wave,
)
from vortex_rt_tpu_torch.engine.shaders import ShaderTable, pathtrace_closest
from vortex_rt_tpu_torch.engine.wavefront import (
    WavefrontRenderer, frame_body,
)
from vortex_rt_tpu_torch.models.scene import (
    Camera, RenderParams, SceneBuffers,
)
from vortex_rt_tpu_torch.ops.intersect import dot, sqrt_rn
from vortex_rt_tpu_torch.parallel.mesh import Mesh
from vortex_rt_tpu_torch.utils.config import RTConfig


def rays_for_rows(cam: CameraArrays, width: int, height: int,
                  rows: torch.Tensor):
    """The centre ray of every pixel of the global image rows ``rows``:
    ((h*W, 3) origins, (h*W, 3) directions), in the arithmetic of the
    megakernel's camera (``generate_camera_rays``), so a block's rays are
    the whole frame's there."""
    dev = cam.pos.device
    x = torch.arange(width, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(rows.to(device=dev, dtype=torch.float32), x,
                            indexing="ij")
    x_ndc = (xx + 0.5) / width - 0.5
    y_ndc = (yy + 0.5) / height - 0.5
    pt = ((x_ndc * cam.viewplane[0]).unsqueeze(-1) * cam.right
          + (y_ndc * cam.viewplane[1]).unsqueeze(-1) * cam.up
          + cam.forward)
    d = pt / sqrt_rn(dot(pt, pt)).unsqueeze(-1)
    o = cam.pos.expand(d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _rows_local(mesh: Mesh, axis: str, height: int) -> int:
    n = mesh.shape[axis]
    if height % n:
        raise ValueError(f"height {height} not divisible by {n} ranks")
    return height // n


def make_tiled_renderer(mesh: Mesh, width: int, height: int,
                        max_depth: int = 2, axis: str = "tiles"):
    """The megakernel's frame over the ranks of ``axis``, one block of
    rows a rank: step(ta, st, cam, light) -> ((rows, W, 3) radiance of
    this rank's block, the rays traced by every rank as a 0-dim int64
    tensor).  ``height`` must divide by the ranks."""
    rows_local = _rows_local(mesh, axis, height)

    def step(ta, st, cam: CameraArrays, light: LightArrays):
        r0 = mesh.coords[axis] * rows_local
        rows = torch.arange(r0, r0 + rows_local, device=ta.device)
        o, d = rays_for_rows(cam, width, height, rows)
        r = o.shape[0]
        radiance = torch.zeros((r, 3), dtype=torch.float32, device=ta.device)
        throughput = torch.ones(r, dtype=torch.float32, device=ta.device)
        active = torch.ones(r, dtype=torch.bool, device=ta.device)
        rays_local = torch.zeros((), dtype=torch.int64, device=ta.device)
        for bounce in range(max_depth):
            rays_local = rays_local + active.sum()
            o, d, radiance, throughput, active, _ = trace_wave(
                ta, st, light, o, d, radiance, throughput, active, bounce,
                max_depth)
        return (radiance.reshape(rows_local, width, 3),
                mesh.all_reduce(rays_local, "sum", axis))

    return step


def render_tiled(sb_host: SceneBuffers, cam: Camera, params: RenderParams,
                 width: int, height: int, mesh: Optional[Mesh] = None,
                 device=None) -> Tuple[np.ndarray, int]:
    """Host API: the scene replicated on every rank, the megakernel's
    frame rendered by row blocks, the image gathered: ((H, W, 3) image,
    rays) on every rank.  ``mesh`` defaults to every rank on one axis,
    each on ``device`` (``parallel.mesh.default_device`` when None)."""
    mesh = mesh or Mesh.create(("tiles",), device=device)
    r = MegakernelRenderer.from_buffers(sb_host, device=mesh.device)
    step = make_tiled_renderer(mesh, width, height, params.max_depth)
    img, total = step(r.ta, r.st, CameraArrays.from_camera(cam, mesh.device),
                      LightArrays.from_params(params, mesh.device))
    return mesh.all_gather(img, "tiles").cpu().numpy(), int(total)


def make_tiled_wavefront(mesh: Mesh, width: int, height: int,
                         max_depth: int = 2, spp: int = 1,
                         axis: str = "tiles", shadow: bool = False,
                         pathtrace: bool = False, packet: int = 256,
                         tile_w: int = 16, tile_h: int = 8, walk=None):
    """The whole wavefront frame body on each rank's block of rows:
    step(wa, sa, cam, light) -> ((rows, W, 3) radiance of this rank's
    block, the rays traced by every rank as a 0-dim int64 tensor).  The
    tables are replicated; ``walk`` is ``frame_body``'s (K1 on 8- and
    16-wide fused tables, K2 on 4-wide ones, by default)."""
    rows_local = _rows_local(mesh, axis, height)
    n_pix_local = rows_local * width
    table = (ShaderTable(closest=pathtrace_closest) if pathtrace
             else ShaderTable())

    def step(wa, sa, cam: CameraArrays, light: LightArrays):
        img, rays, _ = frame_body(
            wa, sa, cam, light, width, height, max_depth=max_depth, spp=spp,
            table=table, seed=0, shadow=shadow, tile_w=tile_w,
            tile_h=tile_h, walk=walk, packet=packet, n_pix=n_pix_local,
            pix_offset=mesh.coords[axis] * n_pix_local)
        return (img.reshape(3, rows_local, width).permute(1, 2, 0),
                mesh.all_reduce(rays, "sum", axis))

    return step


def render_tiled_wavefront(sb_host: SceneBuffers, cam: Camera,
                           params: RenderParams, width: int, height: int,
                           mesh: Optional[Mesh] = None,
                           config: Optional[RTConfig] = None,
                           device=None) -> Tuple[np.ndarray, int]:
    """Host API of the multi-device wavefront frame: the tables built as
    ``WavefrontRenderer.from_buffers`` builds them (``config`` defaults
    to the build's own layout: 8-wide fused rows through K1 for a
    flattened build, 4-wide through K2 otherwise; ``RTConfig(bvh_width=
    16, flatten=True)`` 16-wide rows through K1) on every rank, the
    frame rendered by row blocks, the image gathered: ((H, W, 3) image,
    rays) on every rank."""
    mesh = mesh or Mesh.create(("tiles",), device=device)
    cfg = config or RTConfig(flatten=bool(sb_host.flat))
    r = WavefrontRenderer.from_buffers(sb_host, cfg, device=mesh.device)
    step = make_tiled_wavefront(
        mesh, width, height, params.max_depth, params.spp,
        shadow=params.shadow, pathtrace=params.pathtrace,
        packet=cfg.packet_size, walk=r.walk)
    img, total = step(r.wa, r.sa, CameraArrays.from_camera(cam, mesh.device),
                      LightArrays.from_params(params, mesh.device))
    return mesh.all_gather(img, "tiles").cpu().numpy(), int(total)


def dryrun(n_devices: Optional[int] = None, device=None) -> None:
    """The JAX package's multi-device check over every rank of the process
    group (``n_devices`` of them when given): tiny Cornell frames through
    both steps; an atrium-class scene (24,000 triangles, spp 1, shadow
    rays) by row blocks against the golden oracle on sampled pixels (RMSE
    below 3e-3); and, over an even number of ranks, the same scene in two
    shards (both schedules) against the replicated frame (RMSE below
    1e-5, equal ray counts).  Raises on a failed check."""
    import torch.distributed as dist

    from vortex_rt_tpu_torch.golden.renderer import sample_pixel_parity
    from vortex_rt_tpu_torch.models import bigscenes
    from vortex_rt_tpu_torch.models.procedural import cornell_box
    from vortex_rt_tpu_torch.models.scene import Scene
    from vortex_rt_tpu_torch.parallel.shards import render_sharded

    def check(ok, msg):
        if not ok:
            raise AssertionError(msg)

    n = dist.get_world_size()
    check(n_devices is None or n == n_devices,
          f"need {n_devices} ranks, have {n}")
    mesh = Mesh.create(("tiles",), device=device)
    sc = Scene()
    for m, refl in cornell_box():
        sc.add_instance(sc.add_mesh(m), reflectivity=refl)
    sb = sc.build()
    cam = Scene.framing_camera(sb, 45.0, 1.0)
    params = RenderParams(max_depth=2)
    height = 4 * n
    for render in (render_tiled, render_tiled_wavefront):
        img, total = render(sb, cam, params, 8, height, mesh=mesh)
        check(img.shape == (height, 8, 3), img.shape)
        check(np.isfinite(img).all(), "non-finite pixels")
        check(total >= height * 8, total)

    sc2 = Scene()
    for m, refl in bigscenes.atrium(n_cols=4, target_tris=24_000):
        sc2.add_instance(sc2.add_mesh(m), reflectivity=refl)
    sb2 = sc2.build()
    w2, h2 = 128, max(8 * n, 64)
    cam2 = Scene.framing_camera(sb2, 45.0, w2 / h2)
    params2 = RenderParams(max_depth=2, spp=1, shadow=True)
    img3, total3 = render_tiled_wavefront(sb2, cam2, params2, w2, h2,
                                          mesh=mesh)
    check(img3.shape == (h2, w2, 3) and np.isfinite(img3).all(),
          "atrium frame shape or values")
    check(total3 >= h2 * w2, total3)
    err, worst, where = sample_pixel_parity(sb2, cam2, params2, w2, h2,
                                            img3, n=24, seed=5)
    check(err < 3e-3, f"multi-device parity rmse {err} (worst {worst} at "
          f"{where})")
    if n >= 2 and n % 2 == 0:
        img4, total4 = render_sharded(sc2, cam2, params2, w2, h2,
                                      n_shards=2, device=mesh.device)
        check(img4.shape == (h2, w2, 3) and total4 >= h2 * w2, total4)
        derr = float(np.sqrt(((img4 - img3) ** 2).mean()))
        check(derr < 1e-5, f"sharded vs replicated rmse {derr}")
        img5, total5 = render_sharded(sc2, cam2, params2, w2, h2,
                                      n_shards=2, schedule="alltoall",
                                      device=mesh.device)
        check(total5 == total4, (total5, total4))
        derr2 = float(np.sqrt(((img5 - img3) ** 2).mean()))
        check(derr2 < 1e-5, f"alltoall vs replicated rmse {derr2}")
