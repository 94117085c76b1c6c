"""The port's 8-wide walk (``trace_packets`` on CPU tensors, i.e. its
plain PyTorch version ``trace_packets_ref``) against the JAX package's
``trace_packets(..., packet=32)`` on fused 8-wide tables; then the
kernel's exact byte decode and the work count behind its bound.

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

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch import bridge
from vortex_rt_tpu_torch.models.procedural import box, quad, uv_sphere
from vortex_rt_tpu_torch.ops import traverse_packet as tp
from vortex_rt_tpu_torch.ops.packet_walk import (
    trace_packets_walk_ref, walk_work_4,
)
from vortex_rt_tpu_torch.ops.traverse_packet import (
    trace_packets, trace_packets_ref,
)
from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays, row_layout
from vortex_rt_tpu_torch.runtime import kernels
from vortex_rt_tpu_torch.tools import walk_bounds as wb
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


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("pos", [0, 1, 2, 3])
def test_qbyte_is_exact_for_every_byte(pos, dtype):
    """The kernel's byte decode (the byte in the mantissa of 2**23, less
    2**23) equals the int -> float conversion for all 256 values at each
    byte position of random u32 words."""
    rng = np.random.default_rng(pos)
    words = rng.integers(0, 2**32, size=(256, 8), dtype=np.uint64)
    sh = 8 * pos
    words = (words & ~np.uint64(255 << sh)) \
        | (np.arange(256, dtype=np.uint64)[:, None] << np.uint64(sh))
    w = torch.from_numpy(words.astype(np.int64))
    if dtype == torch.int32:  # the raw int32 view of the same words
        w = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    got = tp.qbyte(w, sh)
    want = ((w >> sh) & 255).to(torch.float32)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(got[:, 0], torch.arange(256, dtype=torch.float32))


def _three_quads():
    """Three unit quads facing -z at x = -6, 0 and 6."""
    sc = pt.Scene()
    for x in (-6.0, 0.0, 6.0):
        sc.add_instance(sc.add_mesh(quad(
            (x - 0.5, -0.5, 0), (x + 0.5, -0.5, 0), (x + 0.5, 0.5, 0),
            (x - 0.5, 0.5, 0))))
    cfg = pt.RTConfig(flatten=True, use_native_build=False)
    return WideArrays.from_scene(sc.build(cfg), 8).fuse()


def test_walk_work_and_bound_match_a_count_by_hand():
    wa = _three_quads()
    # the tree: a root with two children, a leaf holding the quad at -6
    # (2 triangles) and a leaf holding the quads at 0 and 6 (4 triangles)
    words = wa.fused.to(torch.int64) & 0xFFFFFFFF
    _, _, meta_at, leaf_at, _ = row_layout(8)
    meta = words[:, meta_at]
    assert wa.fused.shape == (3, 96)
    assert (meta >> 29).tolist() == [0, 1, 1]
    assert int((meta[0] >> 25) & 15) == 2
    assert words[1:, leaf_at].tolist() == [2, 4]
    # rays down +z at x = -6, 0, 6 (hits), 1.5 (inside the second leaf's
    # box, between its quads: a miss), above everything (y = 3), and an
    # inactive one
    o = torch.tensor([[-6.0, 0.1, -5.0], [0.0, 0.1, -5.0], [6.0, 0.1, -5.0],
                      [1.5, 0.0, -5.0], [0.0, 3.0, -5.0], [0.0, 0.0, -5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]] * 6)
    active = torch.tensor([True] * 5 + [False])
    hits, steps, work = tp.walk_work(wa, o, d, active=active)
    assert (hits.dist[:3] == 5.0).all() and (hits.dist[3:] >= LARGE_FLOAT).all()
    # every live ray tests the root's 2 children; the first four then
    # test one leaf each (2, 4, 4 and 4 triangle slots); the fifth stops
    assert steps.tolist() == [2, 2, 2, 2, 1, 0]
    assert work.internal.tolist() == [1] * 5 + [0]
    assert work.child_slots.tolist() == [2] * 5 + [0]
    assert work.leaf.tolist() == [1, 1, 1, 1, 0, 0]
    assert work.tri_slots.tolist() == [2, 4, 4, 4, 0, 0]
    assert work.instance.tolist() == [0] * 6
    # the rows read: the root's boxes and meta (96 B), each leaf's meta
    # quarter (16 B) and its triangle slots (40 B each)
    assert work.row_bytes.tolist() == [96, 16 + 2 * 40, 16 + 4 * 40]
    b = wb.k1_bound(work)
    assert b.ops == 37 * 10 + 19 * 5 + 53 * 14  # 1,207
    # 5 walking rays read 29 B, the inactive one 5 B (flag and t_max);
    # all write 28 B; each row read once, only the words the walk uses
    assert b.bytes == 5 * 29 + 5 + 6 * 28 + 96 + 96 + 176  # 686
    assert b.bound_by == "bytes"
    assert b.ms == pytest.approx(686 / 3.35e12 * 1e3)


def test_bound_of_a_wave_with_no_walking_ray():
    """A wave whose lanes are all inactive (or clamped to t_max <= 0)
    reads only flags and t_max and writes misses: 33 B a ray, no row."""
    wa = _three_quads()
    o = torch.tensor([[0.0, 0.1, -5.0]] * 7)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 7)
    active = torch.tensor([False] * 5 + [True] * 2)
    t_max = torch.tensor([1e30] * 5 + [0.0, -1.0])
    hits, steps, work = tp.walk_work(wa, o, d, active=active, t_max=t_max)
    assert (hits.dist >= LARGE_FLOAT).all() and int(steps.sum()) == 0
    assert int(work.row_bytes.sum()) == 0
    b = wb.k1_bound(work)
    assert (b.ops, b.bytes, b.bound_by) == (0, 7 * (5 + 28), "bytes")


@pytest.mark.parametrize("width", [4, 8])
def test_walk_work_adds_up_to_steps(width):
    """Every step of a flat walk is an internal or a leaf step, and the
    counting walk gives the plain walk's hits and steps."""
    sc = pt.Scene()
    sc.add_instance(sc.add_mesh(box((0.5, 0.3, 0.5), 0.4)))
    sc.add_instance(sc.add_mesh(uv_sphere((-0.5, 0, 0), 0.6, 8, 12)))
    cfg = pt.RTConfig(flatten=True, use_native_build=False)
    wa = WideArrays.from_scene(sc.build(cfg), width)
    rng = np.random.default_rng(width)
    o = torch.from_numpy(rng.uniform(-2, 2, (300, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32)))
    if width == 8:
        wa = wa.fuse()
        hits, steps, work = tp.walk_work(wa, o, d)
        want, want_steps = trace_packets_ref(wa, o, d)
    else:
        hits, steps, work = walk_work_4(wa, o, d)
        want, want_steps = trace_packets_walk_ref(wa, o, d)
    assert torch.equal(steps, want_steps)
    for a, b in zip(hits, want):
        assert torch.equal(a, b)
    assert bool((hits.dist < LARGE_FLOAT).any())
    assert torch.equal(work.internal + work.leaf, steps.to(torch.int64))
    assert bool((work.child_slots <= width * work.internal).all())
    assert bool((work.tri_slots <= wa.max_leaf_tris * work.leaf).all())
    assert int(work.instance.sum()) == 0
    # rows are read once each, and no more of a row than it holds
    visited = work.row_bytes > 0
    if width == 8:
        assert bool((work.row_bytes <= wa.fused.shape[1] * 4).all())
    else:
        assert work.row_bytes.numel() == (wa.nodes.shape[0]
                                          + wa.tri_rows.shape[0])
        assert bool((work.row_bytes[:wa.nodes.shape[0]] <= 128).all())
    assert 0 < int(visited.sum()) < work.row_bytes.numel()
