"""The frame's functional entry points and the tables' host views
against the JAX package's, and the frame's row blocks.

* ``frame_body(n_pix=, pix_offset=)`` on each block of whole rows (and on
  blocks that are not whole rows) equals the whole frame's rows exactly,
  with the blocks' rays summing to the frame's, on the walk route (8-wide
  fused, K1's plain version; depth 3 with the merged wave) and on the
  pool route (``packet=0``, 4-wide TLAS, K3's plain version);
* the module-level ``render_wavefront``, ``render_frame`` and
  ``render_burst`` against the JAX ones at 32x32 (images within 1e-5:
  the JAX frame runs in-process, where XLA:CPU contracts into FMA,
  ROADMAP hazard H2; ray counts equal);
* ``tile_pixel_perm`` equal to the JAX table;
* the eight ``WideArrays`` views (``kind``, ``nchild``, ``left_first``,
  ``leaf_data``, ``origin``, ``scale``, ``qlo``, ``qhi``) word for word
  the JAX ones, on a fused 8-wide build and an unfused 4-wide TLAS build
  (NumPy builder on both sides).
"""

import numpy as np
import pytest
import torch

from vortex_rt_tpu.engine import megakernel as jmk
from vortex_rt_tpu.engine import wavefront as jwf
from vortex_rt_tpu.engine.shaders import ShaderTable as JTable
from vortex_rt_tpu.engine.shaders import (
    pathtrace_closest as jpathtrace_closest,
)
from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu.models.scene import (
    Camera as JCam, RenderParams as JParams, Scene as JScene,
)
from vortex_rt_tpu.ops.shade_lanes import ShadeArrays as JShade
from vortex_rt_tpu.ops.traverse_wide import WideArrays as JWide
from vortex_rt_tpu.utils.config import RTConfig as JCfg

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch.engine import megakernel as tmk
from vortex_rt_tpu_torch.engine import wavefront as twf
from vortex_rt_tpu_torch.engine.shaders import ShaderTable, pathtrace_closest
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.ops.shade_lanes import ShadeArrays as TShade
from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays as TWide

W = H = 32
EYE = ([0.05, 0.02, -3.2], [0, -0.05, 0], [0, 1, 0], 45.0, 1.0)
LIGHT = (0, 0.8, -0.5)
VIEWS = ("kind", "nchild", "left_first", "leaf_data", "origin", "scale",
         "qlo", "qhi")


def _fill(sc, proc):
    for mesh, refl in proc.cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sc.add_instance(sc.add_mesh(proc.uv_sphere((0, -0.3, 0), 0.35, 8, 12)),
                    reflectivity=0.5)
    sc.add_instance(sc.add_mesh(proc.box((0.45, -0.6, 0.3), 0.25)))
    return sc


def _tables(flatten: bool):
    cfg = pt.RTConfig(flatten=flatten, use_native_build=False)
    sb = _fill(pt.Scene(), tproc).build(cfg)
    wa = TWide.from_scene(sb, width=cfg.bvh_width)
    if wa.width == 8:
        wa = wa.fuse()
    return sb, wa, TShade.from_scene(sb)


def _cam_light(params):
    return (tmk.CameraArrays.from_camera(pt.Camera.look_at(*EYE), "cpu"),
            tmk.LightArrays.from_params(params, "cpu"))


@pytest.mark.parametrize("route,blocks", [
    ("walk", (8, 8, 8, 8)), ("walk", (12, 20)), ("pool", (16, 16)),
    ("walk", None)])
def test_row_blocks_equal_the_whole_frame(route, blocks):
    """Blocks of whole rows give the whole frame's rows and rays exactly
    (a block of 12 rows keeps its tiles at height 4, one of 20 at 4 as
    well); ``None``: blocks of 100 and 924 pixels, not whole rows
    (row-major lanes from the offset)."""
    flatten = route == "walk"
    _, wa, sa = _tables(flatten)
    params = pt.RenderParams(light_pos=LIGHT, max_depth=3, shadow=True,
                             spp=2, pathtrace=flatten)
    cam, light = _cam_light(params)
    table = ShaderTable(closest=pathtrace_closest) if flatten else None
    kw = dict(max_depth=3, spp=2, table=table, shadow=True,
              packet=256 if flatten else 0)
    img, rays, steps = twf.frame_body(wa, sa, cam, light, W, H, **kw)
    sizes = [W * b for b in blocks] if blocks else [100, W * H - 100]
    off, parts, n_rays = 0, [], 0
    for n in sizes:
        bimg, brays, _ = twf.frame_body(wa, sa, cam, light, W, H, n_pix=n,
                                        pix_offset=off, **kw)
        assert bimg.shape == (3, n)
        parts.append(bimg)
        n_rays += int(brays)
        off += n
    assert n_rays == int(rays)
    assert torch.equal(torch.cat(parts, 1), img)


def _jax_tables(flatten: bool):
    jcfg = JCfg(flatten=flatten, use_native_build=False)
    jsb = _fill(JScene(), jproc).build(jcfg)
    jwa = JWide.from_scene(jsb, width=jcfg.bvh_width)
    if jwa.width == 8:
        jwa = jwa.fuse()
    return jwa, JShade.from_scene(jsb)


@pytest.mark.parametrize("fn", ["render_wavefront", "render_frame"])
def test_render_wavefront_matches_jax(fn):
    jwa, jsa = _jax_tables(True)
    jparams = JParams(light_pos=LIGHT, max_depth=3, shadow=True, spp=2)
    jimg, jrays, _ = getattr(jwf, fn)(
        jwa, jsa, jmk.CameraArrays.from_camera(JCam.look_at(*EYE)),
        jmk.LightArrays.from_params(jparams), W, H, max_depth=3, spp=2,
        seed=1, shadow=True)
    _, wa, sa = _tables(True)
    params = pt.RenderParams(light_pos=LIGHT, max_depth=3, shadow=True,
                             spp=2)
    cam, light = _cam_light(params)
    img, rays, steps = getattr(twf, fn)(wa, sa, cam, light, W, H,
                                        max_depth=3, spp=2, seed=1,
                                        shadow=True)
    assert img.shape == (H, W, 3) and int(steps) > 0
    assert int(rays) == int(jrays)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-5)


def test_render_burst_matches_jax():
    jwa, jsa = _jax_tables(True)
    jparams = JParams(light_pos=LIGHT, max_depth=2, shadow=True)
    jn = jwf.render_burst(
        jwa, jsa, jmk.CameraArrays.from_camera(JCam.look_at(*EYE)),
        jmk.LightArrays.from_params(jparams), W, H, n_frames=3, seed0=2,
        max_depth=2, shadow=True,
        table=JTable(closest=jpathtrace_closest))
    _, wa, sa = _tables(True)
    params = pt.RenderParams(light_pos=LIGHT, max_depth=2, shadow=True)
    cam, light = _cam_light(params)
    n = twf.render_burst(wa, sa, cam, light, W, H, n_frames=3, seed0=2,
                         max_depth=2, shadow=True,
                         table=ShaderTable(closest=pathtrace_closest))
    assert n.dim() == 0 and n.dtype == torch.int64
    assert int(n) == int(jn)
    # the renderer's method counts the same frames
    r = pt.WavefrontRenderer(sb=None, wa=wa, sa=sa, config=pt.RTConfig(),
                             table=ShaderTable())
    got = r.render_burst(pt.Camera.look_at(*EYE), pt.RenderParams(
        light_pos=LIGHT, max_depth=2, shadow=True, pathtrace=True), W, H,
        n_frames=3, seed0=2, rays_only=True)
    assert got == int(jn)


@pytest.mark.parametrize("w,h,tw,th", [(32, 32, 16, 8), (64, 48, 16, 16),
                                       (40, 24, 16, 8), (48, 24, 8, 4)])
def test_tile_pixel_perm_matches_jax(w, h, tw, th):
    got = twf.tile_pixel_perm(w, h, tw, th)
    want = jwf.tile_pixel_perm(w, h, tw, th)
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # the frame's per-lane mapping is the same table
    q = torch.arange(w * h)
    px, py = twf._tile_pixel_ids(q, w, tw, th)
    np.testing.assert_array_equal((py * w + px).numpy(), want)


@pytest.mark.parametrize("flatten", [True, False])
def test_wide_views_match_jax(flatten):
    jwa, _ = _jax_tables(flatten)
    _, wa, _ = _tables(flatten)
    assert wa.width == (8 if flatten else 4)
    assert (wa.fused is not None) == flatten
    for name in VIEWS:
        got, want = getattr(wa, name), getattr(jwa, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(
            np.ascontiguousarray(got).view(np.uint8),
            np.ascontiguousarray(want).view(np.uint8), err_msg=name)
    if not flatten:
        assert (wa.kind == 2).any()  # instance rows in the TLAS build
