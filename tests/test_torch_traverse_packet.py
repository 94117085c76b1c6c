"""The port's 8-wide walk (``trace_packets`` on CPU tensors, i.e. its
plain PyTorch version ``trace_packets_ref``) against the JAX package's
``trace_packets(..., packet=32)`` on fused 8-wide tables.

The ``tests/test_wide8.py`` scene (a box, a sphere and a 300-triangle
random soup as three instances of one flattened build, 462 triangles)
with two ray sets: 32x32 camera rays and 512 incoherent rays.  Five
modes: closest hit, active mask, t_max clamp, occlusion, and the mixed
``occl_split`` wave.  ``dist``, ``bx``, ``by``, ``tri`` and ``inst`` must
be bit-identical.

The JAX side runs in a subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``
(no FMA contraction, ROADMAP hazard H2): the port rounds every product,
and so does XLA below FMA.  The JAX loop walks packets over the union of
their paths where the port walks each ray's own path; hits cannot differ
except at exact-t ties (H3), and none of these lanes is one."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vortex_rt_tpu_torch import bridge
from vortex_rt_tpu_torch.ops.traverse_packet import (
    trace_packets, trace_packets_ref,
)
from vortex_rt_tpu_torch.runtime import kernels
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAYS = ("camera", "incoherent")
MODES = ("closest", "active", "t_max", "occlusion", "occl_split")
HITS = ("dist", "bx", "by", "tri", "inst")

# Runs in a fresh interpreter: builds the scene with the JAX package,
# fuses its 8-wide tables, makes both ray sets and the per-mode inputs
# with NumPy, traces them through trace_packets(packet=32) and saves
# everything to an .npz.
_JAX_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from vortex_rt_tpu.golden.renderer import generate_rays
from vortex_rt_tpu.models.procedural import box, random_soup, uv_sphere
from vortex_rt_tpu.models.scene import Camera, Scene
from vortex_rt_tpu.ops.traverse_packet import trace_packets
from vortex_rt_tpu.ops.traverse_wide import WideArrays
from vortex_rt_tpu.utils import vecmath as vm
from vortex_rt_tpu.utils.config import LARGE_FLOAT, RTConfig

rng = np.random.default_rng(0)
sc = Scene()  # tests/test_wide8.py::_flat_scene
mb = sc.add_mesh(box((0, 0, 0), 1.0))
ms = sc.add_mesh(uv_sphere((0, 0, 0), 1.0, 10, 14))
mr = sc.add_mesh(random_soup(rng, 300))
sc.add_instance(mb, vm.mat4_translate([-3, 0, 0]))
sc.add_instance(ms, vm.mat4_translate([3, 0, 0]) @ vm.mat4_scale(1.5))
sc.add_instance(mr, vm.mat4_translate([0, 0, 4]))
sb = sc.build(RTConfig(flatten=True, use_native_build=False))
wa = WideArrays.from_scene(sb, width=8).fuse()
out = {k: np.asarray(getattr(wa, k)) for k in ("nodes", "tri_rows", "fused")}
for k in ("num_tlas", "max_leaf_tris", "depth", "tri_bits", "width"):
    out[k] = np.int64(getattr(wa, k))
cam = Camera.look_at([0.3, -0.6, -7], [0, 0, 0.5], [0, 1, 0], 45.0, 1.0)
rays = {"camera": tuple(np.asarray(a) for a in generate_rays(cam, 32, 32))}
o = rng.uniform(-10, 10, (512, 3)).astype(np.float32)
d = rng.normal(size=(512, 3)).astype(np.float32)
d /= np.linalg.norm(d, axis=-1, keepdims=True)
rays["incoherent"] = (o, d)
for name, (o, d) in rays.items():
    n = o.shape[0]
    free, _ = trace_packets(wa, o, d, packet=32)
    ref = np.asarray(free.dist)
    hit = ref < LARGE_FLOAT
    cut = hit & (np.arange(n) % 2 == 0)
    t_max = np.full(n, LARGE_FLOAT, np.float32)
    t_max[cut] = ref[cut] * 0.5
    shadow_t = np.where(hit, ref * 1.5, np.float32(8.0)).astype(np.float32)
    half = n // 2
    args = {
        "closest": {},
        "active": dict(active=np.arange(n) % 3 != 0),
        "t_max": dict(t_max=t_max),
        "occlusion": dict(active=np.arange(n) % 5 != 0, t_max=shadow_t,
                          occlusion=True),
        # first half occlusion (clamped), second half closest-hit
        "occl_split": dict(
            active=np.arange(n) % 7 != 0,
            t_max=np.where(np.arange(n) < half, shadow_t,
                           np.float32(LARGE_FLOAT)).astype(np.float32),
            occl_split=half),
    }
    out[f"{name}/o"], out[f"{name}/d"] = o, d
    for mode, kw in args.items():
        hits, _ = trace_packets(wa, o, d, packet=32, **kw)
        for k, v in kw.items():
            out[f"{name}/{mode}/arg/{k}"] = np.asarray(v)
        for k in ("dist", "bx", "by", "tri", "inst"):
            out[f"{name}/{mode}/{k}"] = np.asarray(getattr(hits, k))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("k1") / "jax_k1.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _JAX_REFERENCE, str(path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    twa = bridge.wide_arrays(
        ref["nodes"], ref["tri_rows"], fused=ref["fused"], device="cpu",
        **{k: int(ref[k]) for k in ("num_tlas", "max_leaf_tris", "depth",
                                    "tri_bits", "width")})
    return ref, twa


def _mode_args(ref, rays, mode):
    pre = f"{rays}/{mode}/arg/"
    kw = {}
    for k, v in ref.items():
        if k.startswith(pre):
            name = k[len(pre):]
            kw[name] = (int(v) if name == "occl_split" else bool(v)
                        if name == "occlusion" else torch.from_numpy(v))
    return kw


@pytest.mark.parametrize("rays", RAYS)
@pytest.mark.parametrize("mode", MODES)
def test_walk_matches_jax_trace_packets(jax_reference, rays, mode):
    ref, twa = jax_reference
    kw = _mode_args(ref, rays, mode)
    launches = dict(kernels.LAUNCHES)
    got, steps = trace_packets(twa, torch.from_numpy(ref[f"{rays}/o"]),
                               torch.from_numpy(ref[f"{rays}/d"]), **kw)
    assert kernels.LAUNCHES == launches  # CPU tensors never launch
    assert steps.dtype == torch.int32 and bool((steps > 0).any())
    for k in HITS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      ref[f"{rays}/{mode}/{k}"], err_msg=k)
    dist = got.dist.numpy()
    if "active" in kw:  # dead rays report a miss
        assert (dist[~kw["active"].numpy()] >= LARGE_FLOAT).all()
    occ = np.zeros(dist.shape, bool)
    if mode == "occlusion":
        occ[:] = True
    elif mode == "occl_split":
        occ[:kw["occl_split"]] = True
    if occ.any():  # occlusion lanes: 0.0 (occluded) or LARGE_FLOAT
        assert set(np.unique(dist[occ])) == {0.0, np.float32(LARGE_FLOAT)}
        assert (dist[occ] == 0.0).sum() > 10
    hit = ~occ & (dist < LARGE_FLOAT)
    assert mode == "occlusion" or hit.sum() > 10
    if mode == "t_max":  # clamped rays find nothing before their clamp
        assert (dist[kw["t_max"].numpy() < LARGE_FLOAT] >= LARGE_FLOAT).all()
    # flat build: hits keep their per-instance ids
    if rays == "camera" and mode == "closest":
        assert len(np.unique(got.inst.numpy()[hit])) == 3


def test_mixed_wave_equals_its_two_halves(jax_reference):
    """occl_split=k is the occlusion trace of rays < k and the closest
    trace of the rest, lane for lane."""
    ref, twa = jax_reference
    o = torch.from_numpy(ref["camera/o"])
    d = torch.from_numpy(ref["camera/d"])
    kw = _mode_args(ref, "camera", "occl_split")
    k = kw.pop("occl_split")
    mixed, _ = trace_packets_ref(twa, o, d, occl_split=k, **kw)
    occ, _ = trace_packets_ref(twa, o[:k], d[:k], active=kw["active"][:k],
                               t_max=kw["t_max"][:k], occlusion=True)
    clo, _ = trace_packets_ref(twa, o[k:], d[k:], active=kw["active"][k:],
                               t_max=kw["t_max"][k:])
    for a, b, c in zip(mixed, occ, clo):
        assert torch.equal(a, torch.cat([b, c]))


def test_wrapper_and_plain_version_agree_on_cpu(jax_reference):
    ref, twa = jax_reference
    o = torch.from_numpy(ref["incoherent/o"])
    d = torch.from_numpy(ref["incoherent/d"])
    a, sa = trace_packets(twa, o, d)
    b, sb = trace_packets_ref(twa, o, d)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(sa, sb)


@pytest.mark.parametrize("bad", ["o_dtype", "active_dtype", "t_max_shape",
                                 "occl_split", "unfused", "width4"])
def test_wrapper_rejects_bad_inputs(jax_reference, bad):
    ref, twa = jax_reference
    o = torch.from_numpy(ref["camera/o"])
    d = torch.from_numpy(ref["camera/d"])
    kw = {}
    if bad == "o_dtype":
        o = o.double()
    elif bad == "active_dtype":
        kw["active"] = torch.ones(o.shape[0], dtype=torch.int32)
    elif bad == "t_max_shape":
        kw["t_max"] = torch.ones(o.shape[0] + 1)
    elif bad == "occl_split":
        kw["occl_split"] = o.shape[0] + 1
    elif bad == "unfused":
        twa = dataclasses.replace(twa, fused=None)
    else:
        twa = dataclasses.replace(twa, width=4)
    with pytest.raises(ValueError):
        trace_packets(twa, o, d, **kw)
