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
port must equal them.

K6 reads packed records (``pack_walk_tables``): each record must hold
the words of the arrays it was packed from, and the plain walk over the
records alone (``trace_records_ref``, K6's reads and stack length) must
give the JAX records too; past 64 levels (``chain_pool``) it must give
``trace_rays_ref``'s."""

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
    entry's bytes once; the bound grows with the walk.  The bytes K6's
    records make it fetch: the bound's rays, a 64-B record per visited
    node and a 48-B record per tested slot."""
    from vortex_rt_tpu_torch.tools.walk_bounds import (
        k6_bound, k6_record_bytes,
    )

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
    t = ta.tri_idx.shape[0]
    assert k6_record_bytes(work, p, t) == (
        b.bytes - int(rb.sum()) + 64 * int((rb[:p] > 0).sum())
        + 48 * int((rb[2 * p:2 * p + t] > 0).sum()))


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


def _pool_levels(kind, left, root) -> int:
    """Levels of a pool from node 0 (instance leaves enter their BLAS)."""
    frontier, levels = np.zeros(1, np.int64), 0
    while frontier.size:
        levels += 1
        k, lft = kind[frontier], left[frontier]
        inner = np.clip(lft[k == t2.KIND_INTERNAL], 0, kind.size - 2)
        enter = root[np.clip(lft[k == t2.KIND_INSTANCE], 0, root.size - 1)]
        frontier = np.unique(np.concatenate([inner, inner + 1, enter]))
    return levels


@pytest.mark.parametrize("scene", ("soup", "instances", "camera"))
def test_walk_tables_hold_the_arrays_words(jax_reference, scene):
    """``pack_walk_tables`` of the JAX package's arrays: each node record
    holds its node's kind and count, its left word clamped as the walk
    clamps it, an internal node's children's boxes and an instance
    node's inverse-transform rows and BLAS root, word for word (every
    instance, the rotated and scaled ones included, is an instance
    node's); each slot record its triangle's v0, v1 - v0, v2 - v0 and
    clamped id; ``depth`` is the pool's levels."""
    ref = {k: jax_reference[f"{scene}/ta/{k}"] for k in FIELDS}
    wt = t2.pack_walk_tables(_tables(jax_reference, scene))
    rec, tri = wt.nodes.numpy(), wt.tris.numpy()
    kind, left, count = ref["kind"], ref["left"], ref["count"]
    p, n_inst = kind.size, ref["inst_root"].size
    assert rec.shape == (p, t2.NODE_WORDS) and rec.dtype == np.int32
    _same(rec[:, 0], kind, "kind")
    _same(rec[:, 2], count, "count")
    f32 = lambda a: np.ascontiguousarray(a, np.float32).view(np.int32)
    inner = kind == t2.KIND_INTERNAL
    l = np.clip(left, 0, p - 2)
    boxes = np.concatenate([ref["nmin"][l], ref["nmax"][l],
                            ref["nmin"][l + 1], ref["nmax"][l + 1]], 1)
    _same(rec[inner, 1], l[inner], "internal left")
    _same(rec[inner, 4:], f32(boxes)[inner], "child boxes")
    inst = kind == t2.KIND_INSTANCE
    iid = np.clip(left, 0, n_inst - 1)
    _same(rec[inst, 1], iid[inst], "instance id")
    _same(rec[inst, 3], ref["inst_root"][iid][inst], "BLAS root")
    _same(rec[inst, 4:], f32(ref["inst_inv"][iid, :3, :].reshape(p, 12))[
        inst], "inverse transform rows")
    assert set(rec[inst, 1]) == set(range(n_inst))
    leaf = ~inner & ~inst
    _same(rec[leaf, 1], left[leaf], "first slot")
    assert not rec[~inst, 3].any() and not rec[leaf, 4:].any()
    tid = np.clip(ref["tri_idx"], 0, ref["v0"].shape[0] - 1)
    v0 = ref["v0"][tid]
    assert tri.shape == (tid.size, t2.TRI_WORDS)
    _same(tri[:, :9], f32(np.concatenate(
        [v0, ref["v1"][tid] - v0, ref["v2"][tid] - v0], 1)), "v0, e1, e2")
    _same(tri[:, 9], tid, "triangle id")
    assert not tri[:, 10:].any()
    assert wt.depth == _pool_levels(kind, left, ref["inst_root"]) > 2
    assert wt.max_leaf_tris == ref["max_leaf_tris"]
    assert wt.num_tlas == ref["num_tlas"]


@pytest.mark.parametrize("case", CASES)
def test_records_walk_equals_jax(jax_reference, case):
    """The plain walk over K6's records alone, with K6's stack of
    min(stack_depth, depth) entries: the JAX hits, per-ray counts and
    steps to the bit, the 4-entry overflow included."""
    ref = jax_reference
    wt = t2.pack_walk_tables(_tables(ref, SCENE_OF[case]))
    o, d = (torch.from_numpy(ref[f"{case}/{k}"]) for k in ("o", "d"))
    depth = 4 if case == "overflow" else 64
    assert min(depth, wt.depth) < 64  # K6's stack is cut to the pool
    hits, perf = t2.trace_records_ref(wt, o, d, stack_depth=depth)
    for k in t2.Hits._fields:
        _same(getattr(hits, k), ref[f"{case}/hit/{k}"], f"{case} {k}")
    for k in t2.PerfCounters._fields:
        _same(getattr(perf, k), ref[f"{case}/perf/{k}"], f"{case} {k}")


def _chain_rays(n: int, seed: int):
    """Rays along +x (a little off) through chain_pool's square: those
    through y < z miss every triangle and walk the whole chain."""
    g = torch.Generator().manual_seed(seed)
    yz = torch.rand(n, 2, generator=g) * 1.8 - 0.9
    o = torch.stack([torch.full((n,), -1.0), yz[:, 0], yz[:, 1]], 1)
    d = torch.nn.functional.normalize(
        torch.tensor([1.0, 0.0, 0.0]) + 1e-3 * torch.randn(n, 3, generator=g))
    return o, d


@pytest.mark.parametrize("depth", (64, 4))
def test_records_walk_past_the_stack(depth):
    """``chain_pool(100)``: 102 levels (``depth`` caps at 64), walks
    that defer 100 leaves.  The records walk equals ``trace_rays_ref``
    on lanes that overflow a 64-entry stack, inactive lanes included."""
    ta = t2.chain_pool(100)
    wt = ta.walk_tables()
    assert wt.depth == t2.STACK_MAX and ta.walk_tables() is wt
    o, d = _chain_rays(300, 1)
    live = torch.arange(300) % 5 != 2
    want, want_p = t2.trace_rays_ref(ta, o, d, stack_depth=depth,
                                     active=live)
    got, got_p = t2.trace_records_ref(wt, o, d, stack_depth=depth,
                                      active=live)
    for a, b, k in zip((*got, *got_p), (*want, *want_p),
                       t2.Hits._fields + t2.PerfCounters._fields):
        _same(a, b, k)
    miss = live & (o[:, 1] < o[:, 2] - 0.01)
    assert int((want_p.nodes_visited[miss] == 202).sum()) > 100
    assert int((want.dist < LARGE_FLOAT).sum()) > 50
