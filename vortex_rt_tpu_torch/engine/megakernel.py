"""The megakernel renderer (port of ``vortex_rt_tpu/engine/megakernel.py``):
generate camera rays, trace, shade, bounce and accumulate over the whole
ray batch, wave after wave.  The simplest correct device renderer, and the
baseline the JAX package measured its wavefront engine against.

Each wave is one walk of the binary TLAS+BLAS pool (``ops/traverse2.py``:
K6 on the card, ``csrc/traverse2.cu``, over records packed once when the
renderer is made) and the closest-hit shader body in
torch ops (``ops/shade.py``).  The JAX wave traces every lane and masks
the dead ones out of the image; here the live mask goes to the walk, so a
dead lane takes no step, and the images and ray counts stay the JAX
package's.  At spp > 1 the sub-pixel jitter is ``jax.random``'s threefry
sequence from the seed (``utils/prng.py``), so a seed gives the JAX
image.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vortex_rt_tpu_torch.models.scene import (
    Camera, RenderParams, Scene, SceneBuffers,
)
from vortex_rt_tpu_torch.ops.intersect import dot, sqrt_rn
from vortex_rt_tpu_torch.ops.shade import SceneTensors, closest_hit_shade
from vortex_rt_tpu_torch.ops.traverse2 import TraversalArrays, trace_rays
from vortex_rt_tpu_torch.utils import prng
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT, RTConfig


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class CameraArrays(NamedTuple):
    """Camera block: (3,) float32 vectors + (2,) viewplane."""

    pos: torch.Tensor
    forward: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    viewplane: torch.Tensor

    @staticmethod
    def from_camera(cam: Camera, device) -> "CameraArrays":
        return CameraArrays(*(_f32(a, device) for a in cam.as_arrays()))


class LightArrays(NamedTuple):
    """Lighting / integrator constants, (3,) float32 each."""

    light_pos: torch.Tensor
    light_color: torch.Tensor
    ambient: torch.Tensor
    background: torch.Tensor

    @staticmethod
    def from_params(p: RenderParams, device) -> "LightArrays":
        return LightArrays(_f32(p.light_pos, device),
                           _f32(p.light_color, device),
                           _f32(p.ambient_color, device),
                           _f32(p.background_color, device))


def generate_camera_rays(cam: CameraArrays, width: int, height: int,
                         jitter: Optional[torch.Tensor] = None):
    """Primary rays, (H*W, 3) origins and directions.  ``jitter``: an
    optional (H, W, 2) in [0, 1) of sub-pixel positions (default: the
    pixel centre)."""
    dev = cam.pos.device
    x = torch.arange(width, dtype=torch.float32, device=dev)
    y = torch.arange(height, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    if jitter is None:
        jx = jy = 0.5
    else:
        jx, jy = jitter[..., 0], jitter[..., 1]
    x_ndc = (xx + jx) / width - 0.5
    y_ndc = (yy + jy) / height - 0.5
    pt = ((x_ndc * cam.viewplane[0]).unsqueeze(-1) * cam.right
          + (y_ndc * cam.viewplane[1]).unsqueeze(-1) * cam.up
          + cam.forward)
    d = pt / sqrt_rn(dot(pt, pt)).unsqueeze(-1)
    o = cam.pos.expand(d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def trace_wave(ta: TraversalArrays, st: SceneTensors, light: LightArrays,
               o, d, radiance, throughput, active, bounce: int,
               max_depth: int):
    """One bounce over the whole batch -> (o, d, radiance, throughput,
    active, perf counters).  Lanes outside ``active`` take no step in the
    walk; their records never reach the image."""
    hits, perf = trace_rays(ta, o, d, active=active)
    hit = hits.dist < LARGE_FLOAT
    shade = closest_hit_shade(
        st, o, d, torch.clamp_max(hits.dist, 1e18), hits.bx, hits.by,
        hits.bz, hits.tri, hits.inst, light.ambient, light.light_color,
        light.light_pos)
    zero = torch.zeros_like(radiance)

    miss_now = active & ~hit
    radiance = radiance + torch.where(
        miss_now.unsqueeze(1), throughput.unsqueeze(1) * light.background,
        zero)
    h = active & hit
    radiance = radiance + torch.where(
        h.unsqueeze(1),
        (throughput * (1.0 - shade.reflectivity)).unsqueeze(1)
        * shade.diffuse, zero)
    throughput = torch.where(h, throughput * shade.reflectivity, throughput)
    bounce_more = h & (shade.reflectivity > 0.0) & (bounce + 1 < max_depth)
    stop = h & ~bounce_more
    radiance = radiance + torch.where(
        stop.unsqueeze(1), throughput.unsqueeze(1) * light.background, zero)
    b = bounce_more.unsqueeze(1)
    o = torch.where(b, shade.new_o, o)
    d = torch.where(b, shade.new_d, d)
    return o, d, radiance, throughput, bounce_more, perf


def render_megakernel(ta: TraversalArrays, st: SceneTensors,
                      cam: CameraArrays, light: LightArrays, width: int,
                      height: int, max_depth: int = 2, spp: int = 1,
                      seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """A frame -> ((H, W, 3) radiance, rays traced: the sum of every
    wave's live lanes, a 0-dim int64 tensor), on the tables' device."""
    dev = ta.device
    n = width * height
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    key = prng.prng_key(seed)
    for _ in range(spp):
        if spp == 1:
            jitter = None
        else:
            key, k2 = prng.split(key)
            jitter = prng.uniform(k2, (height, width, 2), dev)
        o, d = generate_camera_rays(cam, width, height, jitter)
        radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        throughput = torch.ones(n, dtype=torch.float32, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        for bounce in range(max_depth):
            rays = rays + active.sum()
            o, d, radiance, throughput, active, _ = trace_wave(
                ta, st, light, o, d, radiance, throughput, active, bounce,
                max_depth)
        acc = acc + radiance
    return (acc / spp).reshape(height, width, 3), rays


@dataclasses.dataclass
class MegakernelRenderer:
    """Host-facing renderer: owns the device scene and renders frames."""

    st: SceneTensors
    ta: TraversalArrays
    config: RTConfig

    @property
    def device(self) -> torch.device:
        return self.ta.device

    @staticmethod
    def from_scene(scene: Scene, config: Optional[RTConfig] = None,
                   device="cuda") -> "MegakernelRenderer":
        cfg = config or RTConfig()
        return MegakernelRenderer.from_buffers(scene.build(cfg), cfg, device)

    @staticmethod
    def from_buffers(sb_host: SceneBuffers, config: Optional[RTConfig] = None,
                     device="cuda") -> "MegakernelRenderer":
        cfg = config or RTConfig()
        ta = TraversalArrays.from_scene(sb_host).to(device)
        if ta.device.type == "cuda":
            ta.walk_tables()  # K6's records, packed once with the scene
        return MegakernelRenderer(
            st=SceneTensors.from_scene(sb_host, device), ta=ta, config=cfg)

    def frame(self, cam: Camera, params: RenderParams, width: int,
              height: int, seed: int = 0):
        """The frame on the device: ((H, W, 3) tensor, rays tensor)."""
        return render_megakernel(
            self.ta, self.st, CameraArrays.from_camera(cam, self.device),
            LightArrays.from_params(params, self.device), width, height,
            max_depth=params.max_depth, spp=params.spp, seed=seed)

    def render(self, cam: Camera, params: RenderParams,
               width: Optional[int] = None, height: Optional[int] = None
               ) -> Tuple[np.ndarray, int]:
        w = width or self.config.width
        h = height or self.config.height
        img, nrays = self.frame(cam, params, w, h)
        return img.cpu().numpy(), int(nrays)
