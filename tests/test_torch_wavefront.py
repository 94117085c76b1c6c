"""The slice end to end: the port's ``WavefrontRenderer`` on the CPU
against the JAX ``WavefrontRenderer``, on the ``tests/test_pallas_waves.py``
scene at 32x32 with shadow rays, in two configurations:

* the JAX main path, ``RTConfig(flatten=True)`` as ``bench.py`` builds
  it (8-wide fused rows through ``trace_packets``, the merged
  shadow+bounce wave at depth 3), against the port's default 8-wide
  route, at spp 1 and 2, depth 2 and 3 (and at depth 3 with a shader
  table whose spawn is not lit-independent, which keeps the sequential
  shadow -> bounce waves);
* the configuration that routes every wave through the Pallas walk,
  ``RTConfig(flatten=True, bvh_width=4, pallas_waves="all")`` run in
  interpret mode, against the port's 4-wide route, at depth 2, spp 1
  and 2 (and the TLAS build, and a 40x24 frame whose width is no tile
  multiple, at spp 1).

Equal ray counts and images within atol 1e-5 (the JAX frame runs
in-process, where XLA:CPU contracts into FMA: ROADMAP hazard H2).

At 32x32 the JAX frame takes its monolithic pool path (samples folded
into lanes); the port renders one pass per sample.  Both give pixel p's
k-th sample the global index seed*spp + k, so they trace the same rays.
"""

import numpy as np
import pytest

from vortex_rt_tpu.engine import wavefront as jwf
from vortex_rt_tpu.engine.shaders import ShaderTable as JTable
from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu.models.scene import (
    Camera as JCam, RenderParams as JParams, Scene as JScene,
)
from vortex_rt_tpu.utils.config import RTConfig as JCfg

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch.engine.shaders import ShaderTable as TTable
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.ops.packet_walk import trace_packets_walk
from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets
from vortex_rt_tpu_torch.runtime import kernels

W = H = 32
EYE = ([0.05, 0.02, -3.2], [0, -0.05, 0], [0, 1, 0], 45.0, 1.0)
LIGHT = (0, 0.8, -0.5)


def _fill(sc, proc, sphere_refl=0.0):
    for mesh, refl in proc.cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sc.add_instance(sc.add_mesh(proc.uv_sphere((0, -0.3, 0), 0.35, 8, 12)),
                    reflectivity=sphere_refl)
    sc.add_instance(sc.add_mesh(proc.box((0.45, -0.6, 0.3), 0.25)))
    return sc


@pytest.mark.parametrize("flatten,spp,w,h", [
    (True, 1, W, H), (True, 2, W, H), (False, 1, W, H),
    (True, 1, 40, 24),  # width not a tile multiple: row-major lanes
])
def test_frame_matches_jax_pallas_waves(monkeypatch, flatten, spp, w, h):
    monkeypatch.setattr(jwf, "_PALLAS_INTERPRET", True)
    from vortex_rt_tpu.ops.pallas import packet_walk as jpw

    jcalls = []
    real = jpw.trace_packets_pallas

    def spy(*a, **kw):
        jcalls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(jpw, "trace_packets_pallas", spy)
    jcfg = JCfg(flatten=flatten, bvh_width=4, pallas_waves="all",
                use_native_build=False)
    jsb = _fill(JScene(), jproc).build(jcfg)
    jr = jwf.WavefrontRenderer.from_buffers(jsb, jcfg)
    jimg, jrays = jr.render(JCam.look_at(*EYE),
                            JParams(light_pos=LIGHT, max_depth=2,
                                    shadow=True, spp=spp), w, h)
    # every wave (primary, shadow-0, bounce-1, shadow-1) took the kernel
    assert len(jcalls) == 4

    walks = []

    def walk(*a, **kw):
        walks.append(kw.get("occlusion", False))
        return trace_packets_walk(*a, **kw)

    tcfg = pt.RTConfig(flatten=flatten, bvh_width=4,
                       use_native_build=False)
    tr = pt.WavefrontRenderer.from_buffers(_fill(pt.Scene(), tproc)
                                           .build(tcfg), tcfg,
                                           device="cpu", walk=walk)
    launches = dict(kernels.LAUNCHES)
    timg, trays = tr.render(pt.Camera.look_at(*EYE),
                            pt.RenderParams(light_pos=LIGHT, max_depth=2,
                                            shadow=True, spp=spp), w, h)
    assert kernels.LAUNCHES == launches  # the CPU route launches nothing
    assert walks == [False, True, False, True] * spp
    assert timg.shape == (h, w, 3) and timg.dtype == np.float32
    assert trays == jrays
    np.testing.assert_allclose(timg, np.asarray(jimg), atol=1e-5)


def _kind(kw):
    if kw.get("occl_split", 0):
        return "mixed"
    return "occlusion" if kw.get("occlusion", False) else "closest"


@pytest.mark.parametrize("spp,depth", [(1, 2), (2, 2), (1, 3), (2, 3)])
def test_frame_matches_jax_main_path(monkeypatch, spp, depth):
    """The JAX main path (bench.py's build: flattened, 8-wide, fused
    rows, trace_packets) against the port's 8-wide route.  The sphere is
    reflective, so at depth 3 the merged shadow+bounce wave carries live
    bounce lanes."""
    _main_path_frame(monkeypatch, spp, depth, merged=depth == 3)


def test_frame_matches_jax_sequential_spawn(monkeypatch):
    """``lit_independent_spawn=False`` on both sides: at depth 3 neither
    merges, the 8-wide route runs the sequential shadow -> bounce waves."""
    _main_path_frame(monkeypatch, 2, 3, merged=False,
                     lit_independent_spawn=False)


def _main_path_frame(monkeypatch, spp, depth, merged,
                     lit_independent_spawn=True):
    from vortex_rt_tpu.ops import traverse_packet as jtp

    jcalls = []
    real = jtp.trace_packets

    def spy(*a, **kw):
        jcalls.append(_kind(kw))
        return real(*a, **kw)

    monkeypatch.setattr(jwf, "trace_packets", spy)
    jcfg = JCfg(flatten=True, use_native_build=False)
    assert jcfg.bvh_width == 8 and jcfg.fused_rows
    jsb = _fill(JScene(), jproc, sphere_refl=0.5).build(jcfg)
    jr = jwf.WavefrontRenderer.from_buffers(
        jsb, jcfg, JTable(lit_independent_spawn=lit_independent_spawn))
    assert jr.wa.fused is not None
    jimg, jrays = jr.render(JCam.look_at(*EYE),
                            JParams(light_pos=LIGHT, max_depth=depth,
                                    shadow=True, spp=spp), W, H)
    # the JAX frame folds its samples into one lane set: one merged
    # (occl_split) wave when it merges, none otherwise
    assert jcalls.count("mixed") == (1 if merged else 0)

    walks = []

    def walk(*a, **kw):
        walks.append(_kind(kw))
        return trace_packets(*a, **kw)

    tcfg = pt.RTConfig(flatten=True, use_native_build=False)
    tsb = _fill(pt.Scene(), tproc, sphere_refl=0.5).build(tcfg)
    tr = pt.WavefrontRenderer.from_buffers(
        tsb, tcfg, TTable(lit_independent_spawn=lit_independent_spawn),
        device="cpu", walk=walk)
    assert tr.wa.width == 8 and tr.wa.fused is not None
    tp = pt.RenderParams(light_pos=LIGHT, max_depth=depth, shadow=True,
                         spp=spp)
    launches = dict(kernels.LAUNCHES)
    timg, trays = tr.render(pt.Camera.look_at(*EYE), tp, W, H)
    assert kernels.LAUNCHES == launches  # the CPU route launches nothing
    if merged:
        assert walks == ["closest", "occlusion", "closest", "mixed",
                         "occlusion"] * spp
    else:
        assert walks == ["closest", "occlusion"] * depth * spp
    if depth == 3:
        # the third bounce traced live lanes: more rays than depth 2
        d2 = tr.render(pt.Camera.look_at(*EYE),
                       pt.RenderParams(light_pos=LIGHT, max_depth=2,
                                       shadow=True, spp=spp), W, H)[1]
        assert trays > d2
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    assert trays == jrays
    np.testing.assert_allclose(timg, np.asarray(jimg), atol=1e-5)


def test_render_burst_counts_every_frame():
    tcfg = pt.RTConfig(flatten=True, use_native_build=False)
    r = pt.WavefrontRenderer.from_buffers(_fill(pt.Scene(), tproc)
                                          .build(tcfg), tcfg, device="cpu")
    cam = pt.Camera.look_at(*EYE)
    p = pt.RenderParams(light_pos=LIGHT, max_depth=2, shadow=True, spp=2)
    rays = r.render_burst(cam, p, 16, 16, n_frames=3, rays_only=True)
    per = [r.render_burst(cam, p, 16, 16, n_frames=1, seed0=s,
                          rays_only=True) for s in range(3)]
    assert rays == sum(per) and rays > 3 * 2 * 256
    img, rays2 = r.render_burst(cam, p, 16, 16, n_frames=3)
    assert rays2 == rays and img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    # the image is render()'s seed-0 frame, as in the JAX package,
    # whatever seed0 is
    one, _ = r.render(cam, p, 16, 16)
    assert np.array_equal(one, img)
    later, _ = r.render_burst(cam, p, 16, 16, n_frames=2, seed0=7)
    assert np.array_equal(one, later)


def test_render_burst_image_equals_jax():
    """``render_burst(n_frames=3, seed0=5)`` returns the JAX method's
    image (its seed-0 ``render``) and the burst's total rays."""
    jcfg = JCfg(flatten=True, use_native_build=False)
    jr = jwf.WavefrontRenderer.from_buffers(_fill(JScene(), jproc)
                                            .build(jcfg), jcfg)
    tcfg = pt.RTConfig(flatten=True, use_native_build=False)
    tr = pt.WavefrontRenderer.from_buffers(_fill(pt.Scene(), tproc)
                                           .build(tcfg), tcfg, device="cpu")
    kw = dict(light_pos=LIGHT, max_depth=2, shadow=True, spp=1)
    jimg, jrays = jr.render_burst(JCam.look_at(*EYE), JParams(**kw), 16, 16,
                                  n_frames=3, seed0=5)
    timg, trays = tr.render_burst(pt.Camera.look_at(*EYE),
                                  pt.RenderParams(**kw), 16, 16,
                                  n_frames=3, seed0=5)
    assert trays == jrays
    np.testing.assert_allclose(timg, np.asarray(jimg), atol=1e-5)
