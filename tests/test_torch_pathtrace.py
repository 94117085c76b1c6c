"""The path-traced frame of the port against the JAX package, on the CPU.

* ``cosine_hemisphere`` against the JAX function (``xp=jnp`` and
  ``xp=np``) on 4,096 unit normals, ``nz = -1`` and its neighbourhood
  included: atol 2e-6 (measured 1.2e-7 against both); the directions
  are unit vectors within 1e-6 (measured 1.4e-7).
* ``sample2`` at ``dim=1`` and ``dim=2``, the path tracer's two draws:
  bit-equal.
* ``pathtrace_closest`` on bridged ``ShadeArrays`` and random hit lanes
  against the JAX shader: ``spawn`` equal, floats within atol 1e-5.
* Frames at 32x32, spp 2, on the JAX tables carried over by
  ``bridge.py``: depth 3 without shadow rays, depth 3 with them (the
  merged shadow+bounce wave) and ``render_accum(n_passes=2)``, against
  the JAX renderer: ray counts equal, at least 99% of the pixels within
  1e-5 and the image RMSE under 1e-3 (measured: 4,233, 6,529 and 13,048
  rays on both sides; every pixel within 1e-5 in all three, the largest
  difference 3.0e-7, RMSE 1.3e-8 to 1.5e-8).  sin and cos differ between
  torch and XLA in the last bits, so a bounce can land on another
  triangle at an edge: hence a share of pixels and not all of them.
* One of those frames against the NumPy golden path tracer's replay of
  the same light paths: RMSE under 3e-3, the limit the JAX renderer is
  held to (measured 1.3e-8).
* The native host builder: its tree against the NumPy tree by hits on
  256 random rays; a compiler that is missing or fails raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vortex_rt_tpu.engine import shaders as jsh
from vortex_rt_tpu.engine import wavefront as jwf
from vortex_rt_tpu.golden.renderer import render_golden_pt
from vortex_rt_tpu.models import bigscenes as jbig
from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu.models.scene import (
    Camera as JCam, RenderParams as JParams, Scene as JScene,
)
from vortex_rt_tpu.ops import shade_lanes as jsl
from vortex_rt_tpu.utils import sampling as jsam
from vortex_rt_tpu.utils.config import RTConfig as JCfg

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch import bridge
from vortex_rt_tpu_torch.engine import shaders as tsh
from vortex_rt_tpu_torch.engine import wavefront as twf
from vortex_rt_tpu_torch.engine.megakernel import CameraArrays, LightArrays
from vortex_rt_tpu_torch.models import bigscenes as tbig
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.ops import shade_lanes as tsl
from vortex_rt_tpu_torch.ops.traverse_packet import (
    trace_packets, trace_packets_ref,
)
from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays
from vortex_rt_tpu_torch.runtime import native
from vortex_rt_tpu_torch.utils import sampling as tsam
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

W = H = 32
N = 4096
EYE = ([0.05, 0.02, -3.2], [0, -0.05, 0], [0, 1, 0], 45.0, 1.0)
LIGHT = (0, 0.8, -0.5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- the sampler

def _normals(rng):
    n = rng.normal(size=(N, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    # the basis' pole and its neighbourhood
    n[0] = (0.0, 0.0, -1.0)
    n[1] = (0.0, 0.0, 1.0)
    eps = 10.0 ** -rng.uniform(1, 7, 62)
    phi = rng.uniform(0, 2 * np.pi, 62)
    n[2:64] = np.stack([np.sqrt(eps) * np.cos(phi), np.sqrt(eps) * np.sin(phi),
                        -np.sqrt(1.0 - eps)], 1)
    return n.astype(np.float32)


@pytest.mark.parametrize("xp", ["jnp", "np"])
def test_cosine_hemisphere_matches_jax(xp):
    rng = np.random.default_rng(5)
    n = _normals(rng)
    u1 = rng.random(N).astype(np.float32)
    u2 = rng.random(N).astype(np.float32)
    u1[:4] = (0.0, 0.99999994, 0.5, 0.0)
    u2[:4] = (0.0, 0.5, 0.99999994, 0.25)
    want = jsam.cosine_hemisphere(jnp if xp == "jnp" else np, n[:, 0],
                                  n[:, 1], n[:, 2], u1, u2)
    got = tsam.cosine_hemisphere(_t(n[:, 0]), _t(n[:, 1]), _t(n[:, 2]),
                                 _t(u1), _t(u2))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-6)
    g = np.stack([a.numpy().astype(np.float64) for a in got], 1)
    assert np.abs(np.linalg.norm(g, axis=1) - 1.0).max() < 1e-6
    # on the normal's side
    assert ((g * n).sum(1) > -1e-6).all()


@pytest.mark.parametrize("dim", [1, 2])
def test_sample2_path_tracer_draws_bit_equal(dim):
    rng = np.random.default_rng(dim)
    pix = rng.integers(0, 1920 * 1080, N).astype(np.uint32)
    samp = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    bounce = rng.integers(0, 4, N).astype(np.uint32)
    ju, jv = jsam.sample2(jnp, pix, samp, bounce, 0, dim=dim)
    tu, tv = tsam.sample2(_t(pix.astype(np.int64)), _t(samp.astype(np.int64)),
                          _t(bounce.astype(np.int32)), 0, dim=dim)
    for a, b in ((tu, ju), (tv, jv)):
        assert np.array_equal(a.numpy().view(np.uint32),
                              np.asarray(b).view(np.uint32))
    # another dim is another stream
    ou, _ = tsam.sample2(_t(pix.astype(np.int64)), _t(samp.astype(np.int64)),
                         _t(bounce.astype(np.int32)), 0, dim=3 - dim)
    assert not torch.equal(ou, tu)


# ------------------------------------------------------------- the scene

def _fill(sc, proc, sphere_refl=0.5):
    for mesh, refl in proc.cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sc.add_instance(sc.add_mesh(proc.uv_sphere((0, -0.3, 0), 0.35, 8, 12)),
                    reflectivity=sphere_refl)
    sc.add_instance(sc.add_mesh(proc.box((0.45, -0.6, 0.3), 0.25)))
    return sc


@pytest.fixture(scope="module")
def pair():
    """(JAX renderer, port renderer on the JAX tables, JAX SceneBuffers):
    a Cornell box with a mirror sphere and a diffuse box, flattened,
    8-wide fused."""
    jcfg = JCfg(flatten=True, use_native_build=False)
    jsb = _fill(JScene(), jproc).build(jcfg)
    jr = jwf.WavefrontRenderer.from_buffers(jsb, jcfg)
    jwa, jsa = jr.wa, jr.sa
    assert jwa.width == 8 and jwa.fused is not None
    wa = bridge.wide_arrays(
        np.asarray(jwa.nodes), np.asarray(jwa.tri_rows),
        fused=np.asarray(jwa.fused), num_tlas=jwa.num_tlas,
        max_leaf_tris=jwa.max_leaf_tris, depth=jwa.depth,
        tri_bits=jwa.tri_bits, width=jwa.width, device="cpu")
    sa = bridge.shade_arrays(
        np.asarray(jsa.shade_rows), np.asarray(jsa.mat_rows),
        np.asarray(jsa.inst_shade), np.asarray(jsa.texels), device="cpu")
    tr = pt.WavefrontRenderer(sb=None, wa=wa, sa=sa,
                              config=pt.RTConfig(flatten=True),
                              table=tsh.ShaderTable(), walk=trace_packets)
    return jr, tr, jsb


# ------------------------------------------------------------- the shader

def test_pathtrace_closest_matches_jax(pair):
    jr, tr, jsb = pair
    rng = np.random.default_rng(13)
    f = np.float32
    o = rng.normal(0, 1, (N, 3)).astype(f)
    d = rng.normal(0, 1, (N, 3)).astype(f)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = rng.uniform(0.2, 4.0, N).astype(f)
    bx = rng.random(N).astype(f)
    by = (rng.random(N) * (1 - bx)).astype(f)
    bz = (1.0 - bx - by).astype(f)
    tri = rng.integers(0, jsb.num_tris, N).astype(np.int32)
    inst = np.asarray(jsb.tri_inst)[tri].astype(np.int32)
    lit = (rng.random(N) < 0.7).astype(f)
    bounce = rng.integers(0, 3, N).astype(np.int32)
    pix = rng.integers(0, W * H, N).astype(np.int32)
    samp = rng.integers(0, 64, N).astype(np.uint32)

    jsp = jsl.shade_point(jr.sa, *o.T, *d.T, dist, bx, by, bz, tri, inst)
    tsp = tsl.shade_point(tr.sa, *(_t(a) for a in o.T), *(_t(a) for a in d.T),
                          _t(dist), _t(bx), _t(by), _t(bz), _t(tri).long(),
                          _t(inst).long())
    jsp = jsp._replace(lit=lit)
    tsp = tsp._replace(lit=_t(lit))
    lights = dict(light_pos=(0.3, 0.8, -0.5), light_color=(1.0, 0.9, 0.8),
                  ambient=(0.2, 0.2, 0.25), background=(0.2, 0.3, 0.5))
    jctx = jsh.ShaderContext(shade=jr.sa, max_depth=3, **{
        k: np.asarray(v, f) for k, v in lights.items()})
    tctx = tsh.ShaderContext(shade=tr.sa, max_depth=3, **{
        k: torch.tensor(v, dtype=torch.float32) for k, v in lights.items()})
    thr = np.ones(N, f)
    jco = jsh.pathtrace_closest(
        jctx, jsp, jsh.RayLanes(*o.T, *d.T),
        jsh.PayloadLanes(thr, bounce, pix, samp))
    tco = tsh.pathtrace_closest(
        tctx, tsp, tsh.RayLanes(*(_t(a) for a in (*o.T, *d.T))),
        tsh.PayloadLanes(_t(thr), _t(bounce), _t(pix).long(),
                         _t(samp.astype(np.int64))))
    for name in jco._fields:
        a = np.asarray(getattr(jco, name))
        b = getattr(tco, name).numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=name)
    spawn = np.asarray(jco.spawn)
    # the last bounce spawns nothing; roulette kills some of bounce 1 and
    # none of bounce 0; mirror and diffuse lanes both occur
    assert not spawn[bounce == 2].any() and spawn[bounce == 0].all()
    assert spawn[bounce == 1].any() and not spawn[bounce == 1].all()
    refl = np.asarray(jsp.reflectivity)
    assert (refl > 0).any() and (refl == 0).any()


# ------------------------------------------------------------- frames

def _close(timg, jimg, share=0.99, rmse_max=1e-3):
    jimg = np.asarray(jimg)
    assert timg.shape == jimg.shape == (H, W, 3)
    assert timg.dtype == np.float32 and np.isfinite(timg).all()
    diff = np.abs(timg - jimg).max(-1)
    rmse = float(np.sqrt(((timg - jimg) ** 2).mean()))
    assert (diff <= 1e-5).mean() >= share, ((diff <= 1e-5).mean(), diff.max())
    assert rmse < rmse_max, rmse


def _kind(kw):
    if kw.get("occl_split", 0):
        return "mixed"
    return "occlusion" if kw.get("occlusion", False) else "closest"


@pytest.mark.parametrize("shadow", [False, True])
def test_pathtraced_frame_matches_jax(pair, shadow):
    """Depth 3, spp 2: without shadow rays, and with them (the merged
    shadow+bounce wave, which evaluates the shader at lit 1 and lit 0)."""
    jr, tr, _ = pair
    jimg, jrays = jr.render(
        JCam.look_at(*EYE), JParams(light_pos=LIGHT, max_depth=3, spp=2,
                                    shadow=shadow, pathtrace=True), W, H)
    walks = []

    def walk(*a, **kw):
        walks.append(_kind(kw))
        return trace_packets(*a, **kw)

    p = pt.RenderParams(light_pos=LIGHT, max_depth=3, spp=2, shadow=shadow,
                        pathtrace=True)
    timg, trays = dataclasses.replace(tr, walk=walk).render(
        pt.Camera.look_at(*EYE), p, W, H)
    if shadow:
        assert walks == ["closest", "occlusion", "closest", "mixed",
                         "occlusion"] * 2
    else:
        assert walks == ["closest"] * 6
    assert trays == int(jrays)
    _close(timg, jimg)
    # diffuse surfaces bounce: more rays than the Whitted frame, and
    # another image
    wimg, wrays = tr.render(pt.Camera.look_at(*EYE),
                            dataclasses.replace(p, pathtrace=False), W, H)
    assert trays > wrays
    assert float(np.abs(timg - wimg).mean()) > 1e-3


def test_render_accum_matches_jax(pair):
    jr, tr, _ = pair
    jimg, jrays = jr.render_accum(
        JCam.look_at(*EYE), JParams(light_pos=LIGHT, max_depth=3, spp=2,
                                    shadow=True, pathtrace=True), W, H,
        n_passes=2, seed0=3)
    p = pt.RenderParams(light_pos=LIGHT, max_depth=3, spp=2, shadow=True,
                        pathtrace=True)
    cam = pt.Camera.look_at(*EYE)
    timg, trays = tr.render_accum(cam, p, W, H, n_passes=2, seed0=3)
    assert trays == int(jrays)
    _close(timg, jimg)
    # the mean of the passes' frames, each stratified over spp * n_passes
    def frames(**kw):
        return [twf.frame_body(
            tr.wa, tr.sa, CameraArrays.from_camera(cam, "cpu"),
            LightArrays.from_params(p, "cpu"), W, H, max_depth=3, spp=2,
            table=tr._table_for(p), seed=3 + i, shadow=True, **kw)
            for i in range(2)]

    def mean(fr):
        m = ((fr[0][0] + fr[1][0]) * 0.5).reshape(3, H, W)
        return m.permute(1, 2, 0).numpy()

    strat = frames(total_spp=4)
    np.testing.assert_allclose(timg, mean(strat), rtol=0, atol=1e-6)
    assert trays == int(strat[0][1] + strat[1][1])
    # stratified over 4, not over 2: not the mean of the plain seed-3 and
    # seed-4 frames
    assert float(np.abs(timg - mean(frames())).max()) > 1e-4


def test_pathtraced_frame_matches_golden_replay(pair):
    """The NumPy oracle replays the same light paths from the same
    counter-based streams (brute-force hits, no BVH)."""
    _, tr, jsb = pair
    jp = JParams(light_pos=LIGHT, max_depth=3, spp=2, pathtrace=True)
    ref = render_golden_pt(jsb, JCam.look_at(*EYE), jp, W, H)
    timg, _ = tr.render(pt.Camera.look_at(*EYE), pt.RenderParams(
        light_pos=LIGHT, max_depth=3, spp=2, pathtrace=True), W, H)
    rmse = float(np.sqrt(((timg - ref.reshape(H, W, 3)) ** 2).mean()))
    assert rmse < 3e-3, rmse


def test_pathtrace_entry_points_and_custom_table(pair):
    """``render``, ``render_burst`` and ``render_accum`` all take
    ``pathtrace=True``; a custom shader table is kept, as in the JAX
    package."""
    _, tr, _ = pair
    p = pt.RenderParams(light_pos=LIGHT, max_depth=2, spp=2, pathtrace=True)
    cam = pt.Camera.look_at(*EYE)
    assert tr._table_for(p).closest is tsh.pathtrace_closest
    assert tr._table_for(dataclasses.replace(p, pathtrace=False)) is tr.table
    custom = tsh.ShaderTable(lit_independent_spawn=False)
    assert dataclasses.replace(tr, table=custom)._table_for(p) is custom
    img, rays = tr.render(cam, p, 16, 16)
    burst, brays = tr.render_burst(cam, p, 16, 16, n_frames=2)
    acc, arays = tr.render_accum(cam, p, 16, 16, n_passes=2)
    for im in (img, burst, acc):
        assert im.shape == (16, 16, 3) and np.isfinite(im).all()
    np.testing.assert_array_equal(burst, img)  # render()'s seed-0 image
    assert rays >= 2 * 256 and brays > rays and arays > rays


# ------------------------------------------------------------- the scenes

def test_atrium_meshes_identical_to_jax():
    kw = dict(n_cols=3, target_tris=12_000)
    ja, ta = jbig.atrium(**kw), tbig.atrium(**kw)
    assert len(ja) == len(ta) == 5 + 2 * 3
    for (jm, jrefl), (tm, trefl) in zip(ja, ta):
        assert jrefl == trefl
        for name in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                     "mat_id"):
            np.testing.assert_array_equal(getattr(tm, name),
                                          getattr(jm, name), err_msg=name)
        assert [m.diffuse for m in tm.materials] == [m.diffuse
                                                     for m in jm.materials]
    np.testing.assert_array_equal(ta[0][0].materials[0].diffuse_tex,
                                  ja[0][0].materials[0].diffuse_tex)
    assert abs(sum(m.num_tris for m, _ in ta) - 12_000) < 1_500


# ------------------------------------------------------------- native build

def test_native_build_hits_match_numpy_build():
    """The native tree is not the NumPy tree node for node: compare what
    rays hit through each."""
    hits = {}
    rng = np.random.default_rng(17)
    o = _t(rng.uniform(-0.8, 0.8, (256, 3)).astype(np.float32))
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d = _t(d / np.linalg.norm(d, axis=1, keepdims=True))
    for native_build in (True, False):
        cfg = pt.RTConfig(flatten=True, use_native_build=native_build)
        sb = _fill(pt.Scene(), tproc).build(cfg)
        assert np.array_equal(np.sort(sb.bvh_tri_idx),
                              np.arange(sb.num_tris))
        wa = WideArrays.from_scene(sb, 8).fuse()
        hits[native_build], _ = trace_packets_ref(wa, o, d)
    a, b = hits[True], hits[False]
    hit = b.dist < LARGE_FLOAT
    assert hit.any() and torch.equal(a.dist < LARGE_FLOAT, hit)
    assert torch.equal(a.tri[hit], b.tri[hit])
    assert torch.equal(a.inst[hit], b.inst[hit])
    np.testing.assert_allclose(a.dist[hit].numpy(), b.dist[hit].numpy(),
                               rtol=2e-4)


@pytest.mark.parametrize("cxx,match", [("/nonexistent/bin/g++", "not found"),
                                       ("false", "failed building")])
def test_native_build_raises_without_a_working_compiler(monkeypatch,
                                                        tmp_path, cxx, match):
    """No fallback to NumPy: asked for the native build with a compiler
    that is missing or fails, ``Scene.build`` raises; asked for the NumPy
    build, it does not need one."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", cxx)
    sc = _fill(pt.Scene(), tproc)
    with pytest.raises(RuntimeError, match=match):
        sc.build(pt.RTConfig(flatten=True))
    assert not list(tmp_path.iterdir())
    sb = sc.build(pt.RTConfig(flatten=True, use_native_build=False))
    assert sb.num_tris > 0
