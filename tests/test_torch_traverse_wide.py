"""The port's per-ray walk (``trace_lanes`` on CPU tensors, i.e. its plain
PyTorch version ``trace_lanes_ref``, the CPU side of K3) and ``commit``
against the JAX package's ``trace_lanes`` and ``commit``.

The scenes of ``tests/test_traverse_wide.py``: a 300-triangle soup with
512 random rays, three instances of a box and a sphere (TLAS + BLAS) with
512 rays, and 32x32 camera rays at a sphere; then the any-hit suspension
loops: every candidate over the soup ACCEPTed (which must give the
auto-accept hits), CONT rejecting the near of two quads, and TERM at the
first quad.  Hits must be equal to
the bit, and so must every lane's ``nodes_visited`` and ``tri_tests``
(the port walks each lane's JAX path, in the JAX order); the suspension
loops must end in the same state, field for field.  ``commit`` is held
to the JAX function on a suspended state with mixed actions, and a walk
the JAX package suspended resumes in the port (``bridge.wide_state``)
to the JAX package's next state.

The JAX side runs in a subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``
(no FMA contraction, ROADMAP hazard H2); its tables come over through
``bridge.wide_arrays``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vortex_rt_tpu_torch import bridge
from vortex_rt_tpu_torch.ops import traverse_wide as tw
from vortex_rt_tpu_torch.utils.config import (
    COMMIT_ACCEPT, COMMIT_CONT, COMMIT_TERM, LARGE_FLOAT,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("soup", "instances", "camera")
LOOPS = ("accept", "cont", "term")
HITS = ("dist", "bx", "by", "tri", "inst")

# Runs in a fresh interpreter: builds each scene with the JAX package,
# makes its rays with NumPy, walks them through trace_rays_wide (and the
# suspension loops through commit) and saves tables, rays, hits and states.
_JAX_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from vortex_rt_tpu.golden.renderer import generate_rays
from vortex_rt_tpu.models.procedural import box, quad, random_soup, uv_sphere
from vortex_rt_tpu.models.scene import Camera, Scene
from vortex_rt_tpu.ops.traverse_wide import (
    WideArrays, commit, init_state, trace_rays_wide)
from vortex_rt_tpu.utils import vecmath as vm
from vortex_rt_tpu.utils.config import (
    COMMIT_ACCEPT, COMMIT_CONT, COMMIT_TERM, RTConfig)

rng = np.random.default_rng(7)
out = {}
# jitted with the tables as arguments: one compile per table shape and
# mode, reused by every round of a suspension loop
walk = jax.jit(lambda wa, o, d: trace_rays_wide(wa, o, d))
resume = jax.jit(lambda wa, o, d, st: trace_rays_wide(wa, o, d, state=st,
                                                      suspend=True))
commit_j = jax.jit(commit)


def rays(n, extent):
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def save_tables(name, wa):
    for k in ("nodes", "tri_rows"):
        out[f"{name}/{k}"] = np.asarray(getattr(wa, k))
    for k in ("num_tlas", "max_leaf_tris", "depth", "tri_bits", "width"):
        out[f"{name}/{k}"] = np.int64(getattr(wa, k))


def save_state(pre, st):
    for k, v in st._asdict().items():
        if k != "steps":
            out[f"{pre}/{k}"] = np.asarray(v)


def save_hits(pre, h):
    for k in ("dist", "bx", "by", "tri", "inst"):
        out[f"{pre}/hit/{k}"] = np.asarray(getattr(h, k))


cfg = RTConfig(use_native_build=False)
scenes = {}
sc = Scene()
sc.add_mesh(random_soup(rng, 300))
scenes["soup"] = (sc.build(cfg), rays(512, 14.0))
sc = Scene()
mb = sc.add_mesh(box((0, 0, 0), 1.0))
ms = sc.add_mesh(uv_sphere((0, 0, 0), 1.0, 8, 12))
sc.add_instance(mb, vm.mat4_translate([-3, 0, 0]))
sc.add_instance(ms, vm.mat4_translate([3, 0, 0]) @ vm.mat4_scale(1.5))
sc.add_instance(mb, vm.mat4_translate([0, 3, 0])
                @ vm.mat4_rotate([0, 0, 1], 0.6) @ vm.mat4_scale(0.7))
scenes["instances"] = (sc.build(cfg), rays(512, 8.0))
sc = Scene()
sc.add_mesh(uv_sphere((0, 0, 0), 1.0, 12, 16))
cam = Camera.look_at([0.3, -0.2, -4], [0, 0.05, 0], [0, 1, 0], 40.0, 1.0)
scenes["camera"] = (sc.build(cfg),
                    tuple(np.asarray(a) for a in generate_rays(cam, 32, 32)))
for name, (sb, (o, d)) in scenes.items():
    wa = WideArrays.from_scene(sb)
    save_tables(name, wa)
    out[f"{name}/o"], out[f"{name}/d"] = o, d
    h, st, _ = walk(wa, o, d)
    save_hits(name, h)
    save_state(name, st)

# ---- suspension loops (ACCEPT over the soup's walk; CONT and TERM over
# two quads, one compile for both)
sc = Scene()
sc.add_instance(sc.add_mesh(quad((-2, -2, 1), (2, -2, 1), (2, 2, 1),
                                 (-2, 2, 1))))
sc.add_instance(sc.add_mesh(quad((-2, -2, 3), (2, -2, 3), (2, 2, 3),
                                 (-2, 2, 3))))
two_quads = sc.build(cfg)
quad_o = np.tile(np.array([[0.0, 0.1, -1.0]], np.float32), (8, 1))
quad_d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (8, 1))
loops = {"accept": scenes["soup"], "cont": (two_quads, (quad_o, quad_d)),
         "term": (two_quads, (quad_o, quad_d))}


def action_of(name, st):
    sus = np.asarray(st.suspended)
    if name == "accept":
        act = np.full(sus.shape, COMMIT_ACCEPT)
    elif name == "cont":
        act = np.where(np.asarray(st.pend_inst) == 0, COMMIT_CONT,
                       COMMIT_ACCEPT)
    else:
        act = np.full(sus.shape, COMMIT_TERM)
    return np.where(sus, act, COMMIT_CONT).astype(np.int32)


for name, (sb, (o, d)) in loops.items():
    wa = WideArrays.from_scene(sb)
    save_tables(name, wa)
    out[f"{name}/o"], out[f"{name}/d"] = o, d
    if name == "accept":
        h_auto, _, _ = walk(wa, o, d)
        save_hits(f"{name}/auto", h_auto)
    h, st, _ = resume(wa, o, d, init_state(o.shape[0], o, d))
    rounds = 0
    while bool(np.asarray(st.suspended).any()):
        act = action_of(name, st)
        if rounds == 0:
            # the first suspended state, a mixed action on it, its commit
            # and the next suspension
            save_state(f"{name}/sus0", st)
            mixed = np.where(np.arange(act.shape[0]) % 3 == 0, COMMIT_CONT,
                             np.where(np.arange(act.shape[0]) % 3 == 1,
                                      COMMIT_ACCEPT, COMMIT_TERM))
            mixed = mixed.astype(np.int32)
            out[f"{name}/mixed"] = mixed
            save_state(f"{name}/committed", commit_j(st, mixed))
        st = commit_j(st, act)
        if rounds == 0:
            save_state(f"{name}/resume_in", st)
        h, st, _ = resume(wa, o, d, st)
        if rounds == 0:
            save_state(f"{name}/resume_out", st)
        rounds += 1
        assert rounds < 200
    out[f"{name}/rounds"] = np.int64(rounds)
    save_hits(name, h)
    save_state(name, st)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("k3") / "jax_k3.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _JAX_REFERENCE, str(path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tables(ref, name):
    return bridge.wide_arrays(
        ref[f"{name}/nodes"], ref[f"{name}/tri_rows"], device="cpu",
        **{k: int(ref[f"{name}/{k}"]) for k in (
            "num_tlas", "max_leaf_tris", "depth", "tri_bits", "width")})


def _rays(ref, name):
    return (torch.from_numpy(ref[f"{name}/o"]),
            torch.from_numpy(ref[f"{name}/d"]))


def _state(ref, pre):
    return bridge.wide_state(device="cpu", **{
        k: ref[f"{pre}/{k}"] for k in tw.WideState._fields})


def _same_bits(got: torch.Tensor, want: np.ndarray, label: str) -> None:
    g = got.numpy()
    w = np.asarray(want)
    if w.dtype == np.uint32:
        w = w.view(np.int32)
    if g.dtype == np.float32:
        g, w = g.view(np.int32), w.astype(np.float32).view(np.int32)
    assert g.shape == w.shape, label
    bad = np.nonzero(g != w)[0]
    assert bad.size == 0, f"{label}: {bad.size} lanes differ, e.g. {bad[:4]}"


def _same_state(got: tw.WideState, ref, pre: str) -> None:
    for k in tw.WideState._fields:
        _same_bits(getattr(got, k), ref[f"{pre}/{k}"], f"{pre}/{k}")


def _same_hits(got, ref, pre: str) -> None:
    for k in HITS:
        _same_bits(getattr(got, k), ref[f"{pre}/hit/{k}"], f"{pre}/hit/{k}")


@pytest.mark.parametrize("scene", SCENES)
def test_lanes_match_jax(jax_reference, scene):
    """Auto-accept walks: hits, the whole final state, and every lane's
    ``nodes_visited`` and ``tri_tests``, to the bit."""
    ref = jax_reference
    wa = _tables(ref, scene)
    o, d = _rays(ref, scene)
    hits, st, perf = tw.trace_rays_wide(wa, o, d)
    _same_hits(hits, ref, scene)
    _same_state(st, ref, scene)
    assert bool(st.done.all()) and not bool(st.suspended.any())
    assert int((hits.dist < LARGE_FLOAT).sum()) > 0
    assert torch.equal(perf.nodes_visited, st.nodes_visited)
    assert int(perf.steps) == int(st.nodes_visited.max())


@pytest.mark.parametrize("scene", SCENES)
def test_lanes_work_counts_what_k3_reads(jax_reference, scene):
    """``lanes_work``, the input of K3's bound: the plain walk's state,
    one step counted per visited node and one slot per triangle test, and
    of each visited row only the bytes K3 reads: 64 B of an internal
    node, 80 B of an instance node, 16 B of a leaf node, 40 B per slot of
    a leaf's triangle row."""
    from vortex_rt_tpu_torch.accel import qbvh

    ref = jax_reference
    wa = _tables(ref, scene)
    o, d = _rays(ref, scene)
    lanes = [a.contiguous() for a in (*o.unbind(1), *d.unbind(1))]
    st, work = tw.lanes_work(wa, *lanes)
    _same_state(st, ref, scene)
    assert torch.equal(work.internal + work.leaf + work.instance,
                       st.nodes_visited.to(torch.int64))
    assert torch.equal(work.tri_slots, st.tri_tests.to(torch.int64))
    n = wa.nodes.shape[0]
    meta = wa.nodes[:, tw.META].to(torch.int64) & 0xFFFFFFFF
    kind = meta >> 29
    want = torch.where(kind == qbvh.KIND_INTERNAL, 64, torch.where(
        kind == qbvh.KIND_INSTANCE, 80, 16))
    node_b = work.row_bytes[:n]
    seen = node_b > 0
    assert bool(seen.any())
    assert torch.equal(node_b[seen], want[seen])
    leaf = seen & (kind == qbvh.KIND_TRIS)
    rows = (meta & tw.LEFT_MASK)[leaf]
    slots = wa.nodes[leaf, tw.LEAF].to(torch.int64).clamp(
        0, int(wa.max_leaf_tris))
    row_b = work.row_bytes[n:]
    assert torch.equal(row_b[rows], 40 * slots)
    assert int(row_b.sum()) == int((40 * slots).sum())


@pytest.mark.parametrize("loop", LOOPS)
def test_suspension_loop_matches_jax(jax_reference, loop):
    """The suspension loop with ACCEPT, CONT (the near quad rejected) and
    TERM: the same rounds, the same final state, field for field."""
    ref = jax_reference
    wa = _tables(ref, loop)
    o, d = _rays(ref, loop)
    hits, st, _ = tw.trace_rays_wide(wa, o, d, suspend=True)
    rounds = 0
    while bool(st.suspended.any()):
        if loop == "accept":
            act = torch.full_like(st.tri, COMMIT_ACCEPT)
        elif loop == "cont":
            act = torch.where(st.pend_inst == 0, COMMIT_CONT, COMMIT_ACCEPT)
        else:
            act = torch.full_like(st.tri, COMMIT_TERM)
        act = torch.where(st.suspended, act, COMMIT_CONT).to(torch.int32)
        st = tw.commit(st, act)
        hits, st, _ = tw.trace_rays_wide(wa, o, d, state=st, suspend=True)
        rounds += 1
        assert rounds < 200
    assert rounds == int(ref[f"{loop}/rounds"]) > 0
    _same_state(st, ref, loop)
    _same_hits(hits, ref, loop)
    if loop == "accept":
        # accepting every candidate is the auto-accept walk's result
        _same_hits(hits, ref, f"{loop}/auto")
    if loop == "cont":
        assert torch.allclose(hits.dist, torch.full_like(hits.dist, 4.0),
                              atol=1e-4) and bool((hits.inst == 1).all())
    if loop == "term":
        # TERM leaves the best hit at its committed value: none
        assert bool(st.done.all())
        assert bool((st.best_t == LARGE_FLOAT).all())
        assert bool((st.pend_inst == 0).all())


@pytest.mark.parametrize("loop", LOOPS)
def test_commit_matches_jax(jax_reference, loop):
    """``commit`` of a suspended state with CONT, ACCEPT and TERM mixed
    over the lanes, field for field."""
    ref = jax_reference
    st = _state(ref, f"{loop}/sus0")
    mixed = torch.from_numpy(ref[f"{loop}/mixed"])
    _same_state(tw.commit(st, mixed), ref, f"{loop}/committed")


@pytest.mark.parametrize("loop", ("accept", "cont"))
def test_resume_from_a_jax_suspended_state(jax_reference, loop):
    """A walk the JAX package suspended and committed, carried over by
    ``bridge.wide_state``, resumes in the port to the JAX next state."""
    ref = jax_reference
    wa = _tables(ref, loop)
    o, d = _rays(ref, loop)
    st = _state(ref, f"{loop}/resume_in")
    _, out, _ = tw.trace_rays_wide(wa, o, d, state=st, suspend=True)
    _same_state(out, ref, f"{loop}/resume_out")
    # the input state is not changed
    _same_state(st, ref, f"{loop}/resume_in")


def test_per_ray_walk_refusals(jax_reference):
    """Suspension needs the TLAS build (flat builds pack instance ids
    into leaf ids), the walk needs 4-wide tables, and the bridge needs
    every WideState field."""
    import vortex_rt_tpu_torch as pt
    from vortex_rt_tpu_torch.models.procedural import box

    sc = pt.Scene()
    sc.add_instance(sc.add_mesh(box((0, 0, 0), 1.0)))
    sb = sc.build(pt.RTConfig(flatten=True, use_native_build=False))
    o = torch.tensor([[0.0, 0.1, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    flat4 = tw.WideArrays.from_scene(sb, width=4)
    hits, _, _ = tw.trace_rays_wide(flat4, o, d)
    assert float(hits.dist[0]) == pytest.approx(2.0)
    with pytest.raises(ValueError, match="TLAS"):
        tw.trace_rays_wide(flat4, o, d, suspend=True)
    with pytest.raises(ValueError, match="4-wide"):
        tw.trace_rays_wide(tw.WideArrays.from_scene(sb, width=8), o, d)
    fields = {k: jax_reference[f"soup/{k}"] for k in tw.WideState._fields
              if k != "tri_tests"}
    with pytest.raises(ValueError, match="tri_tests"):
        bridge.wide_state(device="cpu", **fields)


# ---- the pool path's in-place walk (no JAX: the port against itself)

def _pool_renderer():
    """A TLAS scene (two quads in front of a box and a sphere) through the
    suspension engine, with an any-hit predicate that rejects part of
    every surface."""
    import vortex_rt_tpu_torch as pt
    from vortex_rt_tpu_torch.engine.shaders import (
        ShaderTable, stateless_anyhit,
    )
    from vortex_rt_tpu_torch.models.procedural import box, quad, uv_sphere

    sc = pt.Scene()
    def square(cx, cy, z, h):
        return quad((cx - h, cy - h, z), (cx + h, cy - h, z),
                    (cx + h, cy + h, z), (cx - h, cy + h, z))

    for mesh in (square(0, 0, 0.5, 0.6), square(0.2, 0.1, 1.0, 0.6),
                 box((0, 0, 2.0), 0.6), uv_sphere((0.4, -0.3, 1.6), 0.4,
                                                   6, 8)):
        sc.add_instance(sc.add_mesh(mesh))
    cfg = pt.RTConfig(packet_size=0, use_native_build=False)
    table = ShaderTable(anyhit=stateless_anyhit(
        lambda u, v, a: (u + v) > 0.7, "diag"))
    r = pt.WavefrontRenderer.from_buffers(sc.build(cfg), cfg, table,
                                          device="cpu")
    cam = pt.Camera.look_at([0.1, 0.05, -2.5], [0, 0, 1], [0, 1, 0], 50.0,
                            1.0)
    return r, cam, pt.RenderParams(max_depth=1, spp=1)


def test_pool_walks_in_place_like_out_of_place(monkeypatch):
    """``_trace_pool`` walks its own state in place (``walk_lanes``, K3's
    contract on the card): its hits, step total, image and ray count
    equal those of the same frame with every round walking a copy of
    the state, round for round; the step total is not zero, so the
    count it starts from (``visited0``) does not alias the walked state.
    Exact equality: the same plain walk either way."""
    from vortex_rt_tpu_torch.engine import wavefront as wf

    r, cam, p = _pool_renderer()
    real_pool, real_walk = wf._trace_pool, wf.walk_lanes
    runs = {}
    for mode in ("in_place", "out_of_place"):
        got, in_place = [], []

        def pool(*a, **kw):
            got.append(real_pool(*a, **kw))
            return got[-1]

        def walk(*a, state, **kw):
            if mode == "out_of_place":
                state = tw.WideState(*(x.clone() for x in state))
            out = real_walk(*a, state=state, **kw)
            in_place.append(out is state)
            return out

        monkeypatch.setattr(wf, "_trace_pool", pool)
        monkeypatch.setattr(wf, "walk_lanes", walk)
        img, rays = r.render(cam, p, 12, 12)
        runs[mode] = (img, rays, got)
        # the walks write the state they are given, in several
        # suspension rounds
        assert all(in_place) and len(in_place) > 2 * len(got) > 0
    (img_i, rays_i, got_i), (img_o, rays_o, got_o) = (
        runs["in_place"], runs["out_of_place"])
    assert rays_i == rays_o and np.array_equal(img_i, img_o)
    assert len(got_i) == len(got_o) > 0
    for (hi, si), (ho, so) in zip(got_i, got_o):
        assert int(si) == int(so) > 0
        for a, b in zip(hi, ho):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_walk_lanes_in_place_contract():
    """``trace_lanes`` leaves its input state unchanged; ``walk_lanes``
    writes the state it is given and returns it, with ``trace_lanes``'
    every field, over a suspension loop, and from no state walks a fresh
    one as ``trace_lanes`` does; it refuses a state whose fields share
    storage."""
    from vortex_rt_tpu_torch.engine import wavefront as wf
    from vortex_rt_tpu_torch.engine.megakernel import CameraArrays

    r, cam, _ = _pool_renderer()
    n = 10
    lane = torch.arange(n * n)
    pxi, pyi = wf._tile_pixel_ids(lane, n, n, n)
    lanes = wf._camera_from_pix(CameraArrays.from_camera(cam, "cpu"), n, n,
                                pxi, pyi, pyi * n + pxi,
                                torch.zeros_like(lane), 1)
    st = tw.init_state_lanes(*lanes)
    si = tw.init_state_lanes(*lanes)
    for k in range(50):
        before = [a.clone() for a in st]
        _, st_next, _ = tw.trace_lanes(r.wa, *lanes, state=st, suspend=True)
        for a, b in zip(st, before):
            assert torch.equal(a, b)
        out = tw.walk_lanes(r.wa, *lanes, state=si, suspend=True)
        assert out is si
        for name, a, b in zip(tw.WideState._fields, si, st_next):
            assert torch.equal(a, b), (k, name)
        if not bool(st_next.suspended.any()):
            break
        act = torch.where(lane % 3 == 0, COMMIT_ACCEPT, COMMIT_CONT)
        act = torch.where(lane % 11 == 0, COMMIT_TERM, act).to(torch.int32)
        st, si = tw.commit(st_next, act), tw.commit(si, act)
    assert k >= 2 and bool(st_next.done.all())
    fresh = tw.walk_lanes(r.wa, *lanes)
    for a, b in zip(fresh, tw.trace_lanes(r.wa, *lanes)[1]):
        assert torch.equal(a, b)
    shared = si._replace(tri_tests=si.nodes_visited)
    with pytest.raises(ValueError, match="distinct"):
        tw.walk_lanes(r.wa, *lanes, state=shared)


def test_k3_bound_counts_walking_lanes_and_changed_fields():
    """``tools/walk_bounds.k3_bound`` given the walk's states: a lane
    that takes no step costs its 2 flag bytes; one that steps its world
    ray (24 B), the 29 + 3 words a suspending walk reads, its flags and
    the fields whose bytes changed (counted here lane by lane in NumPy);
    both under the every-lane figure, the second round (after a commit that
    ends some lanes) with fewer walking lanes.  Exact integers."""
    from vortex_rt_tpu_torch.engine import wavefront as wf
    from vortex_rt_tpu_torch.engine.megakernel import CameraArrays
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    r, cam, _ = _pool_renderer()
    n = 10
    lane = torch.arange(n * n)
    pxi, pyi = wf._tile_pixel_ids(lane, n, n, n)
    lanes = wf._camera_from_pix(CameraArrays.from_camera(cam, "cpu"), n, n,
                                pxi, pyi, pyi * n + pxi,
                                torch.zeros_like(lane), 1)
    st0 = tw.init_state_lanes(*lanes)
    st1, work1 = tw.lanes_work(r.wa, *lanes, state=st0, suspend=True)
    act = torch.where(lane % 2 == 0, COMMIT_TERM, COMMIT_CONT)
    st1c = tw.commit(st1, act.to(torch.int32))
    st2, work2 = tw.lanes_work(r.wa, *lanes, state=st1c, suspend=True)
    counts = []
    for before, after, work in ((st0, st1, work1), (st1c, st2, work2)):
        walking = ((work.internal + work.leaf + work.instance) > 0).numpy()
        changed = 0
        for a, b in zip(before, after):
            ab = a.numpy().view(np.uint8).reshape(n * n, -1)
            bb = b.numpy().view(np.uint8).reshape(n * n, -1)
            changed += int((ab != bb).any(1)[walking].sum()) * ab.shape[1]
        k = int(walking.sum())
        want = ((n * n - k) * 2 + k * (24 + 4 * 32 + 2) + changed
                + int(work.row_bytes.sum()))
        b = wb.k3_bound(work, before, after, suspend=True)
        assert b.bytes == want < wb.k3_bound(work).bytes
        assert b.ops == wb.k3_bound(work).ops
        counts.append(k)
    assert counts[0] == n * n > counts[1] > 0
