"""The port's binary TLAS+BLAS walk (``ops/traverse2.trace_rays`` on CPU
tensors, i.e. its plain PyTorch version ``trace_rays_ref``, the CPU side
of K6) against the JAX package's ``trace_rays``.

Scenes: a 300-triangle soup with every triangle twice (equal t, equal
instance: the triangle-id tie-break) and 512 random rays; three
instances of a box and a sphere under translations, a rotation and
scales, plus a second instance of the sphere under the same transform
(equal t and triangle: the instance tie-break), 512 rays; 32x32 camera
rays at a sphere; and the soup again at ``stack_depth=4``, where the
stack overflows and a pop reads the clamped entry.  Tolerance 0: hits
(dist, bx, by, bz, tri, inst) equal to the bit, and every lane's
``nodes_visited`` and ``tri_tests``, and ``steps``.

The JAX side runs jitted in a subprocess with
``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (no FMA contraction, ROADMAP hazard
H2); its tables come over through ``bridge.traversal_arrays``, and the
port's own ``TraversalArrays.from_scene`` of the same scene built by the
port must equal them."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vortex_rt_tpu_torch import bridge
from vortex_rt_tpu_torch.models.procedural import box, random_soup, uv_sphere
from vortex_rt_tpu_torch.models.scene import Camera, Scene
from vortex_rt_tpu_torch.ops import traverse2 as t2
from vortex_rt_tpu_torch.utils import vecmath as vm
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT, RTConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("soup", "instances", "camera", "overflow")
SCENE_OF = {"soup": "soup", "instances": "instances", "camera": "camera",
            "overflow": "soup"}
FIELDS = ("nmin", "nmax", "left", "count", "kind", "tri_idx", "v0", "v1",
          "v2", "inst_inv", "inst_root", "inst_refl", "max_leaf_tris",
          "num_tlas")

# The scenes, built by either package (``pkg`` is the package's name):
# the same seeded NumPy inputs go to both.
_SCENES = r"""
def build_scenes(Scene, RTConfig, box, random_soup, uv_sphere, Camera,
                 vm, generate_rays):
    import dataclasses
    import numpy as np
    rng = np.random.default_rng(11)
    cfg = RTConfig(use_native_build=False)

    def rays(n, extent):
        o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return o, d

    out = {}
    soup = random_soup(rng, 300)
    twice = dataclasses.replace(soup, **{
        f: np.concatenate([getattr(soup, f)] * 2)
        for f in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                  "mat_id")})
    sc = Scene()
    sc.add_mesh(twice)
    out["soup"] = (sc.build(cfg), rays(512, 14.0))
    sc = Scene()
    mb = sc.add_mesh(box((0, 0, 0), 1.0))
    ms = sc.add_mesh(uv_sphere((0, 0, 0), 1.0, 8, 12))
    sphere_at = vm.mat4_translate([3, 0, 0]) @ vm.mat4_scale(1.5)
    sc.add_instance(mb, vm.mat4_translate([-3, 0, 0]))
    sc.add_instance(ms, sphere_at)
    sc.add_instance(mb, vm.mat4_translate([0, 3, 0])
                    @ vm.mat4_rotate([0, 0, 1], 0.6) @ vm.mat4_scale(0.7))
    sc.add_instance(ms, sphere_at)
    out["instances"] = (sc.build(cfg), rays(512, 8.0))
    sc = Scene()
    sc.add_mesh(uv_sphere((0, 0, 0), 1.0, 12, 16))
    cam = Camera.look_at([0.3, -0.2, -4], [0, 0.05, 0], [0, 1, 0], 40.0,
                         1.0)
    out["camera"] = (sc.build(cfg), tuple(
        np.asarray(a, np.float32) for a in generate_rays(cam, 32, 32)))
    return out
"""

_JAX_REFERENCE = _SCENES + r"""
import dataclasses
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from vortex_rt_tpu.golden.renderer import generate_rays
from vortex_rt_tpu.models.procedural import box, random_soup, uv_sphere
from vortex_rt_tpu.models.scene import Camera, Scene
from vortex_rt_tpu.ops.traverse2 import TraversalArrays, trace_rays
from vortex_rt_tpu.utils import vecmath as vm
from vortex_rt_tpu.utils.config import RTConfig

scenes = build_scenes(Scene, RTConfig, box, random_soup, uv_sphere, Camera,
                      vm, generate_rays)
out = {}
walk = jax.jit(trace_rays, static_argnames=("stack_depth",))
for case, scene in (("soup", "soup"), ("instances", "instances"),
                    ("camera", "camera"), ("overflow", "soup")):
    sb, (o, d) = scenes[scene]
    ta = TraversalArrays.from_scene(sb)
    if case == scene:
        for k, v in dataclasses.asdict(ta).items():
            out[f"{case}/ta/{k}"] = np.asarray(v)
    out[f"{case}/o"], out[f"{case}/d"] = o, d
    hits, perf = walk(ta, o, d, stack_depth=4 if case == "overflow" else 64)
    for k, v in hits._asdict().items():
        out[f"{case}/hit/{k}"] = np.asarray(v)
    for k, v in perf._asdict().items():
        out[f"{case}/perf/{k}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("k6") / "jax_k6.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _JAX_REFERENCE, str(path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port_scenes():
    from vortex_rt_tpu_torch.golden.renderer import generate_rays

    ns = {}
    exec(_SCENES, ns)
    return ns["build_scenes"](Scene, RTConfig, box, random_soup, uv_sphere,
                              Camera, vm, generate_rays)


def _tables(ref, scene) -> t2.TraversalArrays:
    return bridge.traversal_arrays(device="cpu", **{
        k: ref[f"{scene}/ta/{k}"] for k in FIELDS})


def _bits(a) -> np.ndarray:
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a


def _same(got, want, label):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, (label, g.shape, w.shape)
    bad = np.nonzero(g != w)
    assert bad[0].size == 0, f"{label}: {bad[0].size} differ"


def _walk(ref, case, **kw):
    ta = _tables(ref, SCENE_OF[case])
    o, d = (torch.from_numpy(ref[f"{case}/{k}"]) for k in ("o", "d"))
    depth = 4 if case == "overflow" else 64
    return t2.trace_rays(ta, o, d, stack_depth=depth, **kw)


@pytest.mark.parametrize("case", CASES)
def test_walk_equals_jax(jax_reference, case):
    """Hits, per-ray ``nodes_visited`` and ``tri_tests``, and ``steps``
    to the bit."""
    ref = jax_reference
    hits, perf = _walk(ref, case)
    for k in t2.Hits._fields:
        _same(getattr(hits, k), ref[f"{case}/hit/{k}"], f"{case} {k}")
    for k in t2.PerfCounters._fields:
        _same(getattr(perf, k), ref[f"{case}/perf/{k}"], f"{case} {k}")
    assert int((hits.dist < LARGE_FLOAT).sum()) > 0


def test_ties_and_overflow_are_exercised(jax_reference):
    """The cases reach what they are there for: the doubled soup's hits
    tie with a duplicate triangle, the instances' hits on the sphere tie
    with the copy on the later instance (the earlier one wins), and at
    stack_depth=4 some walk overflows and finds other hits than at 64."""
    ref = jax_reference
    n = ref["soup/ta/v0"].shape[0] // 2
    tri = ref["soup/hit/tri"][ref["soup/hit/dist"] < LARGE_FLOAT]
    assert (tri < n).all() and tri.size > 20
    hit = ref["instances/hit/dist"] < LARGE_FLOAT
    inst = ref["instances/hit/inst"][hit]
    assert (inst == 1).any() and not (inst == 3).any()
    assert ref["overflow/perf/nodes_visited"].max() > 0
    assert (ref["overflow/hit/tri"] != ref["soup/hit/tri"]).any()


def test_inactive_rays_take_no_step(jax_reference):
    """``active``: live rays give the JAX hits and counts, dead rays the
    initial record (a miss at LARGE_FLOAT, zero counts)."""
    ref = jax_reference
    r = ref["instances/o"].shape[0]
    live = torch.from_numpy(np.arange(r) % 3 != 1)
    hits, perf = _walk(ref, "instances", active=live)
    lv = live.numpy()
    for k in ("dist", "tri", "inst", "bx"):
        _same(getattr(hits, k)[live], ref[f"instances/hit/{k}"][lv], k)
    _same(perf.nodes_visited[live], ref["instances/perf/nodes_visited"][lv],
          "nodes_visited")
    dead = ~live
    assert (hits.dist[dead] == LARGE_FLOAT).all()
    assert (perf.nodes_visited[dead] == 0).all()
    assert (perf.tri_tests[dead] == 0).all()


@pytest.mark.parametrize("scene", ("soup", "instances", "camera"))
def test_traversal_arrays_equal_jax(jax_reference, port_scenes, scene):
    """The port's ``TraversalArrays.from_scene`` of the scene the port
    built equals the JAX package's, carried by ``bridge``."""
    mine = t2.TraversalArrays.from_scene(port_scenes[scene][0])
    carried = _tables(jax_reference, scene)
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(carried, f.name)
        if torch.is_tensor(a):
            assert a.dtype == b.dtype, f.name
            _same(a, b.numpy(), f.name)
        else:
            assert a == b, f.name


def test_rays_work_counts_each_row_once(jax_reference):
    """``rays_work``, the input of ``k6_bound``: one step per visited
    node, two boxes per internal step, the leaves' slots, and each table
    entry's bytes once; the bound grows with the walk."""
    from vortex_rt_tpu_torch.tools.walk_bounds import k6_bound

    ref = jax_reference
    ta = _tables(ref, "instances")
    o, d = (torch.from_numpy(ref[f"instances/{k}"]) for k in ("o", "d"))
    work = t2.rays_work(ta, o, d)
    steps = work.internal + work.leaf + work.instance
    _same(steps.to(torch.int32), ref["instances/perf/nodes_visited"],
          "steps")
    assert torch.equal(work.child_slots, 2 * work.internal)
    _same(work.tri_slots.to(torch.int32), ref["instances/perf/tri_tests"],
          "tri_slots")
    p = ta.kind.shape[0]
    rb = work.row_bytes
    assert set(rb[:p].unique().tolist()) <= {0, 12}
    assert set(rb[p:2 * p].unique().tolist()) <= {0, 24}
    b = k6_bound(work)
    half = k6_bound(t2.rays_work(ta, o[:256], d[:256]))
    assert b.ops > half.ops > 0 and b.bytes > half.bytes > 0
    assert b.ms == max(b.ops_ms, b.bytes_ms)


def test_refuses_bad_arguments(jax_reference):
    ta = _tables(jax_reference, "camera")
    o = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="stack_depth"):
        t2.trace_rays(ta, o, o, stack_depth=65)
    with pytest.raises(ValueError, match="t_max"):
        t2.trace_rays(ta, o, o, t_max=2e30)
    with pytest.raises(ValueError, match="float32"):
        t2.trace_rays(ta, o.double(), o)
    with pytest.raises(ValueError, match="no CUDA walk"):
        t2.kernel_call(ta, o, o)
