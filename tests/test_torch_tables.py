"""The port's host build and tables against the JAX package's.

``Scene.build`` -> ``WideArrays`` (flat and TLAS at width 4, flat at
width 8 with its fused rows) and ``ShadeArrays`` must be bit-identical
to the JAX package's NumPy build (``use_native_build=False``); the bridge
must carry the JAX tables across bit for bit; the width default must
resolve as the JAX package's; options the port has not ported must
raise; and the port must import and render with JAX blocked."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu.models.scene import Scene as JScene
from vortex_rt_tpu.ops.shade_lanes import ShadeArrays as JShade
from vortex_rt_tpu.ops.traverse_wide import WideArrays as JWide
from vortex_rt_tpu.utils import vecmath as jvm
from vortex_rt_tpu.utils.config import RTConfig as JCfg

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch import bridge
from vortex_rt_tpu_torch.engine.megakernel import CameraArrays, LightArrays
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.ops.shade_lanes import ShadeArrays as TShade
from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays as TWide
from vortex_rt_tpu_torch.utils import vecmath as tvm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fill(sc, proc, vm, kind):
    if kind == "flat":
        for mesh, refl in proc.cornell_box():
            sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
        sc.add_instance(sc.add_mesh(proc.uv_sphere((0, -0.3, 0), 0.35, 8, 12)))
        sc.add_instance(sc.add_mesh(proc.box((0.45, -0.6, 0.3), 0.25)))
    else:  # two meshes, three instances (one transformed): TLAS + BLAS
        s = sc.add_mesh(proc.uv_sphere((0, 0, 0), 1.0, 12, 16))
        b = sc.add_mesh(proc.box((0.5, 0.3, 0.5), 0.4))
        sc.add_instance(s)
        sc.add_instance(b, reflectivity=0.5)
        sc.add_instance(b, vm.mat4_translate([-1.5, 0.2, 0.4])
                        @ vm.mat4_rotate([0, 1, 0], 0.6))
    return sc


def build_pair(kind):
    """(JAX SceneBuffers, port SceneBuffers) of the same scene."""
    flatten = kind == "flat"
    jsb = _fill(JScene(), jproc, jvm, kind).build(
        JCfg(flatten=flatten, bvh_width=4, use_native_build=False))
    tsb = _fill(pt.Scene(), tproc, tvm, kind).build(
        pt.RTConfig(flatten=flatten, use_native_build=False))
    return jsb, tsb


@pytest.fixture(scope="module", params=["flat", "tlas"])
def pair(request):
    jsb, tsb = build_pair(request.param)
    return request.param, jsb, tsb


def _same_bits(a, b):
    a = np.ascontiguousarray(np.asarray(a))
    b = np.ascontiguousarray(np.asarray(b))
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
    np.testing.assert_array_equal(a.view(f"u{a.dtype.itemsize}"),
                                  b.view(f"u{b.dtype.itemsize}"))


def test_scene_buffers_identical(pair):
    _, jsb, tsb = pair
    for f in dataclasses.fields(tsb):
        a, b = getattr(jsb, f.name), getattr(tsb, f.name)
        if a is None or isinstance(a, bool):
            assert a == b, f.name
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
            _same_bits(a, b)


def test_wide_arrays_identical(pair):
    kind, jsb, tsb = pair
    jwa = JWide.from_scene(jsb, width=4)
    twa = TWide.from_scene(tsb, width=4)
    assert twa.nodes.dtype == torch.int32
    _same_bits(jwa.nodes, twa.nodes.numpy())
    _same_bits(jwa.tri_rows, twa.tri_rows.numpy())
    for name in ("num_tlas", "max_leaf_tris", "depth", "tri_bits", "width"):
        assert getattr(jwa, name) == getattr(twa, name), name
    assert (twa.num_tlas > 0) == (kind == "tlas")


def test_shade_arrays_identical(pair):
    _, jsb, tsb = pair
    jsa = JShade.from_scene(jsb)
    tsa = TShade.from_scene(tsb)
    for name in ("shade_rows", "mat_rows", "inst_shade", "texels"):
        _same_bits(getattr(jsa, name), getattr(tsa, name).numpy())


def test_bridge_round_trip(pair):
    _, jsb, _ = pair
    jwa = JWide.from_scene(jsb, width=4)
    jsa = JShade.from_scene(jsb)
    twa = bridge.wide_arrays(
        np.asarray(jwa.nodes), np.asarray(jwa.tri_rows),
        num_tlas=jwa.num_tlas, max_leaf_tris=jwa.max_leaf_tris,
        depth=jwa.depth, tri_bits=jwa.tri_bits, width=jwa.width,
        device="cpu")
    _same_bits(jwa.nodes, twa.nodes.numpy())
    _same_bits(jwa.tri_rows, twa.tri_rows.numpy())
    tsa = bridge.shade_arrays(*(np.asarray(getattr(jsa, n)) for n in (
        "shade_rows", "mat_rows", "inst_shade", "texels")), device="cpu")
    for name in ("shade_rows", "mat_rows", "inst_shade", "texels"):
        _same_bits(getattr(jsa, name), getattr(tsa, name).numpy())
    # camera and light vectors: the bridge equals the port's own build
    cam = pt.Camera.look_at([0.3, -0.2, -4], [0, 0.05, 0], [0, 1, 0],
                            40.0, 1.0)
    cb = bridge.camera_arrays(*cam.as_arrays(), device="cpu")
    for a, b in zip(cb, CameraArrays.from_camera(cam, "cpu")):
        _same_bits(a.numpy(), b.numpy())
    p = pt.RenderParams(light_pos=(0, 0.8, -0.5))
    lb = bridge.light_arrays(p.light_pos, p.light_color, p.ambient_color,
                             p.background_color, device="cpu")
    for a, b in zip(lb, LightArrays.from_params(p, "cpu")):
        _same_bits(a.numpy(), b.numpy())


def test_bridge_refuses_unported_tables():
    jsb, _ = build_pair("flat")
    jwa = JWide.from_scene(jsb, width=4)
    common = dict(num_tlas=jwa.num_tlas, max_leaf_tris=jwa.max_leaf_tris,
                  depth=jwa.depth, tri_bits=jwa.tri_bits, device="cpu")
    nodes, rows = np.asarray(jwa.nodes), np.asarray(jwa.tri_rows)
    # 16-wide tables are carried (tests/test_torch_wide16.py holds them
    # word for word), but only with their 40-word node rows
    j16 = JWide.from_scene(jsb, width=16)
    got = bridge.wide_arrays(np.asarray(j16.nodes), np.asarray(j16.tri_rows),
                             width=16, **{**common, "depth": j16.depth})
    assert got.width == 16 and got.nodes.shape[1] == 40
    with pytest.raises(ValueError, match="40"):
        bridge.wide_arrays(nodes, rows, width=16, **common)
    with pytest.raises(ValueError, match="fused"):  # wrong row width
        bridge.wide_arrays(nodes, rows, width=4, fused=nodes, **common)
    # alpha tables are carried now, but only whole: rows and pool together,
    # the rows (L, 8*k) beside tri_rows (L, 16*k)
    with pytest.raises(ValueError, match="alpha"):
        bridge.wide_arrays(nodes, rows, width=4,
                           alpha_rows=np.zeros((1, 32), np.float32),
                           **common)
    with pytest.raises(ValueError, match="alpha"):
        bridge.wide_arrays(nodes, rows, width=4,
                           alpha_rows=np.zeros((1, 32), np.float32),
                           alpha_pool=np.zeros(4, np.float32), **common)


@pytest.fixture(scope="module")
def wide8_pair():
    jsb, tsb = build_pair("flat")
    jcfg = JCfg(flatten=True, use_native_build=False)
    assert jcfg.bvh_width == 8  # the JAX default on flattened builds
    return JWide.from_scene(jsb, width=8).fuse(), tsb


@pytest.mark.parametrize("route", ["port_build", "bridge"])
def test_wide8_fused_tables_identical(wide8_pair, route):
    """Width-8 nodes, leaf rows and fused rows, word for word, through
    the port's own build and through the bridge."""
    jwa, tsb = wide8_pair
    if route == "port_build":
        twa = TWide.from_scene(tsb, width=8).fuse()
    else:
        twa = bridge.wide_arrays(
            np.asarray(jwa.nodes), np.asarray(jwa.tri_rows),
            fused=np.asarray(jwa.fused), num_tlas=jwa.num_tlas,
            max_leaf_tris=jwa.max_leaf_tris, depth=jwa.depth,
            tri_bits=jwa.tri_bits, width=jwa.width, device="cpu")
    for name in ("nodes", "tri_rows", "fused"):
        assert getattr(twa, name).dtype == (torch.float32 if name ==
                                            "tri_rows" else torch.int32)
        _same_bits(getattr(jwa, name), getattr(twa, name).numpy())
    for name in ("num_tlas", "max_leaf_tris", "depth", "tri_bits", "width"):
        assert getattr(jwa, name) == getattr(twa, name), name
    assert twa.width == 8 and twa.fused.shape[1] == 32 + twa.tri_rows.shape[1]
    # the 8-wide collapse has fewer internal nodes than the 4-wide one
    t4 = TWide.from_scene(tsb, width=4)
    kind8 = (twa.nodes[:, 22] >> 29) & 7
    kind4 = (t4.nodes[:, 14] >> 29) & 7
    assert int((kind8 == 0).sum()) < int((kind4 == 0).sum())


def test_renderer_fuses_8wide_builds():
    _, tsb = build_pair("flat")
    r = pt.WavefrontRenderer.from_buffers(tsb, pt.RTConfig(flatten=True),
                                          device="cpu")
    assert r.wa.width == 8 and r.wa.fused is not None
    r4 = pt.WavefrontRenderer.from_buffers(
        tsb, pt.RTConfig(flatten=True, bvh_width=4), device="cpu")
    assert r4.wa.width == 4 and r4.wa.fused is None


@pytest.mark.parametrize("kw", [dict(flatten=True), dict(flatten=False),
                                dict(flatten=True, bvh_width=4),
                                dict(flatten=False, bvh_width=4),
                                dict(flatten=True, bvh_width=8)])
def test_bvh_width_resolves_as_jax(kw):
    """The width default resolves as the JAX package's (0 = auto: 8 on
    flattened builds, else 4)."""
    assert pt.RTConfig(**kw).bvh_width == JCfg(**kw).bvh_width


@pytest.mark.parametrize("option", ["bvh_width8", "anyhit", "collect_stats",
                                    "stage_limit", "multi_device"])
def test_unported_options_raise(option):
    from vortex_rt_tpu_torch.engine import wavefront as twf
    from vortex_rt_tpu_torch.engine.shaders import ShaderTable

    if option == "bvh_width8":
        # 8- and 16-wide need the flattened build, as in the JAX package;
        # 16-wide is ported (tests/test_torch_wide16.py)
        with pytest.raises(ValueError, match="flatten"):
            pt.RTConfig(bvh_width=8)
        with pytest.raises(ValueError, match="flatten"):
            pt.RTConfig(bvh_width=16)
        assert pt.RTConfig(bvh_width=16, flatten=True).bvh_width == 16
        assert JCfg(bvh_width=16, flatten=True).bvh_width == 16
        return
    _, tsb = build_pair("flat")
    cfg = pt.RTConfig(flatten=True)
    cam = pt.Camera.look_at([0.05, 0.02, -3.2], [0, -0.05, 0], [0, 1, 0],
                            45.0, 1.0)
    if option in ("collect_stats", "stage_limit"):
        # ported since ROADMAP Queue 1 item 10d: the per-wave statistics
        # and the stage cut run (tests/test_torch_stats.py holds them to
        # the plain walk and to JAX); here they no longer raise
        r = pt.WavefrontRenderer.from_buffers(tsb, cfg, device="cpu")
        out = twf.frame_body(
            r.wa, r.sa, CameraArrays.from_camera(cam, "cpu"),
            LightArrays.from_params(pt.RenderParams(), "cpu"), 16, 16,
            **{option: True if option == "collect_stats" else 1})
        if option == "collect_stats":
            assert set(out[3]) == {"trace0", "trace1"}
        else:
            assert int(out[1]) == 16 * 16  # the camera rays only
        return
    if option == "multi_device":
        # ported since ROADMAP Queue 1 item 11 (parallel.tiles and
        # parallel.shards); the renderer, one device's as in the JAX
        # package, still refuses a device list and names them
        with pytest.raises(NotImplementedError, match="parallel.tiles"):
            pt.WavefrontRenderer.from_buffers(tsb, cfg,
                                              device=["cpu", "cpu"])
        return
    if option == "anyhit":
        # ported since ROADMAP Queue 1 items 8b and 8c: a stateless
        # predicate (sqrt and the transcendentals correctly rounded) runs
        # inside the walk of a flattened build (K1's predicate mode;
        # tests/test_torch_anyhit_pred.py holds it to JAX); what its
        # compiler refuses (a non-elementwise op) still raises, naming it
        from vortex_rt_tpu_torch.engine.shaders import stateless_anyhit

        r = pt.WavefrontRenderer.from_buffers(
            tsb, cfg, ShaderTable(anyhit=stateless_anyhit(
                lambda u, v, a: a.sqrt() > 0.5)), device="cpu")
        img, rays = r.render(cam, pt.RenderParams(), 16, 16)
        assert rays >= 16 * 16 and np.isfinite(img).all()
        with pytest.raises(NotImplementedError, match="cumsum"):
            pt.WavefrontRenderer.from_buffers(
                tsb, cfg, ShaderTable(anyhit=stateless_anyhit(
                    lambda u, v, a: a.cumsum(0) > 0.5)), device="cpu")
        return
    raise AssertionError(f"unknown option {option}")


_NO_JAX = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch.models.procedural import box, cornell_box, uv_sphere
sc = pt.Scene()
for mesh, refl in cornell_box():
    sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
sc.add_instance(sc.add_mesh(box((0.45, -0.6, 0.3), 0.25)))
cfg = pt.RTConfig(flatten=True)
r = pt.WavefrontRenderer.from_scene(sc, cfg, device="cpu")
cam = pt.Camera.look_at([0.05, 0.02, -3.2], [0, -0.05, 0], [0, 1, 0], 45.0, 1.0)
img, rays = r.render(cam, pt.RenderParams(light_pos=(0, 0.8, -0.5),
                                          shadow=True), 16, 16)
assert img.shape == (16, 16, 3) and np.isfinite(img).all(), img.shape
assert rays >= 256, rays
# the on-device LBVH build and refit, and the ladder tool over them
import torch
from vortex_rt_tpu_torch.accel import lbvh
from vortex_rt_tpu_torch.tools import bench_ladder
m = uv_sphere((0, 0, 0), 1.0, 8, 16)
v = [torch.from_numpy(x) for x in lbvh.pad_tris(m.v0, m.v1, m.v2, 4)]
lb, topo = lbvh.build_lbvh_topo(*v, width=8)
pool_rows, leaf_rows, surv_idx = lbvh.compact_plan(topo, pad=32)
lb = lbvh.refit_lbvh(topo, *v, width=8, pool_rows=pool_rows,
                     leaf_rows=leaf_rows, surv_idx=surv_idx)
assert lb.fused.shape == (pool_rows, 96), lb.fused.shape
rec = bench_ladder.config5("cpu", grid=8, res=(8, 8))
assert rec["parity_ok"], rec
# the on-device PLOC build and level refit
from vortex_rt_tpu_torch.accel import ploc
lb, ptopo = ploc.build_ploc_topo(*v, width=8)
lb = ploc.refit_ploc(ptopo, *v, width=8)
assert lb.fused.shape == (2 * v[0].shape[0] - 1, 96), lb.fused.shape
bad = sorted(m for m in sys.modules
             if m == "vortex_rt_tpu" or m.startswith("vortex_rt_tpu."))
assert not bad, bad
print("OK", rays)
"""


def test_port_imports_and_renders_without_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


def test_image_io_matches_jax(tmp_path):
    from vortex_rt_tpu.utils import image as jimg
    from vortex_rt_tpu_torch.utils import image as timg

    rng = np.random.default_rng(3)
    img = rng.uniform(-0.2, 1.2, (7, 5, 3)).astype(np.float32)
    jimg.write_ppm(str(tmp_path / "j.ppm"), img)
    timg.write_ppm(str(tmp_path / "t.ppm"), img)
    assert (tmp_path / "j.ppm").read_bytes() == (tmp_path / "t.ppm").read_bytes()
    back = timg.read_ppm(str(tmp_path / "j.ppm"))
    np.testing.assert_array_equal(back, jimg.read_ppm(str(tmp_path / "t.ppm")))
    assert timg.rmse(img, img * 0.5) == jimg.rmse(img, img * 0.5)
