"""The port's shading against the JAX package's on the same hit records:
``shade_point`` (point and bilinear texture filtering), ``default_closest``
and ``default_miss``, within atol 1e-6.  Hit records, rays and payloads
are made with NumPy from a seed and fed to both."""

import numpy as np
import pytest
import torch

from vortex_rt_tpu.engine import shaders as jsh
from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu.models.scene import Material as JMat, Scene as JScene
from vortex_rt_tpu.ops import shade_lanes as jsl
from vortex_rt_tpu.utils import vecmath as jvm
from vortex_rt_tpu.utils.config import LARGE_FLOAT, RTConfig as JCfg

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch.engine import shaders as tsh
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.models.scene import Material as TMat
from vortex_rt_tpu_torch.ops import shade_lanes as tsl
from vortex_rt_tpu_torch.utils import vecmath as tvm

N = 4096
LIGHT = dict(light_pos=(0.3, 0.8, -0.5), light_color=(1.0, 0.9, 0.8),
             ambient_color=(0.2, 0.2, 0.25),
             background_color=(0.2, 0.3, 0.5))


def _checker(n=8, cell=3):
    yy, xx = np.meshgrid(np.arange(n * cell), np.arange(n * cell + 5),
                         indexing="ij")
    return np.where(((xx // cell) + (yy // cell)) % 2 == 0, 0xE0C080,
                    0x203040).astype(np.uint32)


def _build(S, proc, Mat, vm, cfg):
    sc = S()
    tex = Mat(diffuse=(0.7, 0.7, 0.7), diffuse_tex=_checker())
    q = sc.add_mesh(proc.quad((-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1),
                              tex))
    s = sc.add_mesh(proc.uv_sphere((0, 0, 0), 0.5, 6, 8,
                                   Mat(diffuse=(0.8, 0.2, 0.1))))
    sc.add_instance(q)
    sc.add_instance(s, vm.mat4_translate([0.2, -0.3, 0.1])
                    @ vm.mat4_rotate([0, 1, 1], 0.7)
                    @ vm.mat4_scale([1.0, 1.5, 0.7]), reflectivity=0.4)
    sc.add_instance(q, vm.mat4_rotate([1, 0, 0], 0.3), reflectivity=0.7)
    return sc.build(cfg)


@pytest.fixture(scope="module")
def inputs():
    jsb = _build(JScene, jproc, JMat, jvm, JCfg(use_native_build=False))
    tsb = _build(pt.Scene, tproc, TMat, tvm, pt.RTConfig(use_native_build=False))
    rng = np.random.default_rng(11)
    f = np.float32
    o = rng.normal(0, 1, (N, 3)).astype(f)
    d = rng.normal(0, 1, (N, 3)).astype(f)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = rng.uniform(0.2, 4.0, N).astype(f)
    dist[rng.random(N) < 0.1] = LARGE_FLOAT  # misses shade at t = 1e18
    bx = rng.random(N).astype(f)
    by = (rng.random(N) * (1 - bx)).astype(f)
    bz = (1.0 - bx - by).astype(f)
    tri = rng.integers(0, jsb.num_tris, N).astype(np.int32)
    tri[::2] = rng.integers(0, 2, N // 2)  # half the lanes on the textured quad
    inst = rng.integers(0, jsb.num_instances, N).astype(np.int32)
    lit = (rng.random(N) < 0.7).astype(f)
    bounce = rng.integers(0, 3, N).astype(np.int32)
    return dict(jsa=jsl.ShadeArrays.from_scene(jsb),
                tsa=tsl.ShadeArrays.from_scene(tsb),
                o=o, d=d, dist=dist, bx=bx, by=by, bz=bz, tri=tri,
                inst=inst, lit=lit, bounce=bounce)


def _shade_both(x, bilinear):
    o, d = x["o"], x["d"]
    js = jsl.shade_point(x["jsa"], *o.T, *d.T, x["dist"], x["bx"], x["by"],
                         x["bz"], x["tri"], x["inst"], bilinear=bilinear)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    ts_ = tsl.shade_point(x["tsa"], *(t(a) for a in o.T),
                          *(t(a) for a in d.T), t(x["dist"]), t(x["bx"]),
                          t(x["by"]), t(x["bz"]), t(x["tri"]).long(),
                          t(x["inst"]).long(), bilinear=bilinear)
    return js, ts_


@pytest.mark.parametrize("bilinear", [False, True])
def test_shade_point_matches(inputs, bilinear):
    js, ts_ = _shade_both(inputs, bilinear)
    for name in js._fields:
        a = np.asarray(getattr(js, name))
        b = getattr(ts_, name).numpy()
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            scale = 1e18 if name in ("px", "py", "pz") else 1.0
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * scale,
                                       err_msg=name)
    # the texture path and the untextured path both ran
    mat = np.asarray(js.mat)
    assert len(np.unique(mat)) >= 2
    assert len(np.unique(ts_.color_r.numpy())) > (10 if bilinear else 2)


def _ctx(module, sa, tensor):
    return module.ShaderContext(
        shade=sa, light_pos=tensor(LIGHT["light_pos"]),
        light_color=tensor(LIGHT["light_color"]),
        ambient=tensor(LIGHT["ambient_color"]),
        background=tensor(LIGHT["background_color"]), max_depth=2)


@pytest.mark.parametrize("bilinear", [False, True])
def test_default_closest_and_miss_match(inputs, bilinear):
    x = inputs
    js, ts_ = _shade_both(x, bilinear)
    js = js._replace(lit=x["lit"])
    ts_ = ts_._replace(lit=torch.from_numpy(x["lit"]))
    jctx = _ctx(jsh, x["jsa"], lambda v: np.asarray(v, np.float32))
    tctx = _ctx(tsh, x["tsa"], lambda v: torch.tensor(v, dtype=torch.float32))
    n = np.arange(N)
    jray = jsh.RayLanes(*x["o"].T, *x["d"].T)
    tray = tsh.RayLanes(*(torch.from_numpy(np.ascontiguousarray(a))
                          for a in (*x["o"].T, *x["d"].T)))
    thr = np.ones(N, np.float32)
    jpl = jsh.PayloadLanes(thr, x["bounce"], n.astype(np.int32),
                           n.astype(np.uint32))
    tpl = tsh.PayloadLanes(torch.from_numpy(thr), torch.from_numpy(x["bounce"]),
                           torch.from_numpy(n), torch.from_numpy(n))
    jco = jsh.default_closest(jctx, js, jray, jpl)
    tco = tsh.default_closest(tctx, ts_, tray, tpl)
    for name in jco._fields:
        a = np.asarray(getattr(jco, name))
        b = getattr(tco, name).numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            scale = 1e18 if name in ("sox", "soy", "soz") else 1.0
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * scale,
                                       err_msg=name)
    assert np.asarray(jco.spawn).any() and not np.asarray(jco.spawn).all()
    for a, b in zip(jsh.default_miss(jctx, jray, jpl),
                    tsh.default_miss(tctx, tray, tpl)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
