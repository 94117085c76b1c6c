"""The port's on-device PLOC build and level refit (``accel/ploc.py``,
plain PyTorch versions on the CPU) against the JAX package's, on the same
vertices from seeded NumPy generators: tolerance 0 everywhere — every
``PLOCTopo`` field, ``n_int`` and ``n_levels`` equal, ``nodes`` equal
word for word, ``tri_rows`` and the fused rows equal bit for bit.

The JAX side runs with ``jax.disable_jit()``: jitted, ``build_ploc_topo``
compiles a ``while_loop`` of 32 windowed costs and an unrolled
``_merge_tids`` for every new triangle count.  Each (mesh, width, leaf)
is built once a module.  The jitted program is compared once, on the
sphere at width 8, leaf 4: in the test process XLA:CPU may contract the
merge cost's products and sums into FMAs (ROADMAP hazards H2, H9), which
changes a cost, so a merge, so the tree; with FMA off
(``XLA_FLAGS=--xla_cpu_max_isa=AVX``, in a subprocess) its words equal
the port's.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vortex_rt_tpu.accel import lbvh as jl
from vortex_rt_tpu.accel import ploc as jp
from vortex_rt_tpu_torch import bridge
from vortex_rt_tpu_torch.accel import lbvh as tl
from vortex_rt_tpu_torch.accel import ploc as tp
from vortex_rt_tpu_torch.models import bigscenes as tbig
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.ops.packet_walk import trace_packets_walk_ref
from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets_ref
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

from tests.test_torch_gpu import chain_records
from tests.test_torch_lbvh import (
    _bits, _brute_force, _moved, _rays, _same, assert_dense_ids,
)

SCENES = ("uv_sphere", "random_soup")
SHAPES = ((4, 4), (8, 4), (8, 8))  # (width, leaf)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MERGE_CU = os.path.join(REPO, "vortex_rt_tpu_torch", "csrc", "ploc_merge.cu")


def _cu_constant(name):
    """An integer constant of the merge kernel's source."""
    with open(MERGE_CU) as f:
        return int(re.search(rf"\b{name} = (\d+)", f.read()).group(1))


def _mesh(scene):
    if scene == "uv_sphere":
        return tproc.uv_sphere((0, 0, 0), 1.0, 8, 16)   # 224 triangles
    return tproc.random_soup(np.random.default_rng(3), 500)


@pytest.fixture(scope="module")
def built():
    """``built(scene, width, leaf)`` -> (padded vertices, JAX (nodes,
    topo), port (nodes, topo)); each case is built once per module."""
    cache = {}

    def get(scene, width, leaf):
        key = (scene, width, leaf)
        if key not in cache:
            m = _mesh(scene)
            v = tl.pad_tris(m.v0, m.v1, m.v2, leaf)
            with jax.disable_jit():
                j = jp.build_ploc_topo(*(jnp.asarray(x) for x in v),
                                       leaf_size=leaf, width=width)
            t = tp.build_ploc_topo(*(torch.from_numpy(x) for x in v),
                                   leaf_size=leaf, width=width)
            cache[key] = (v, j, t)
        return cache[key]

    return get


def _same_ptopo(jt, tt):
    for f in jt.topo._fields:
        _same(getattr(jt.topo, f), getattr(tt.topo, f), f)
    for f in ("leaf_tids", "level", "n_int", "n_levels"):
        _same(getattr(jt, f), getattr(tt, f), f)


def _carry(jt):
    return bridge.ploc_topo(
        topo={f: np.asarray(getattr(jt.topo, f)) for f in jt.topo._fields},
        leaf_tids=np.asarray(jt.leaf_tids), level=np.asarray(jt.level),
        n_int=np.asarray(jt.n_int), n_levels=np.asarray(jt.n_levels),
        device="cpu")


@pytest.mark.parametrize("width,leaf", SHAPES)
@pytest.mark.parametrize("scene", SCENES)
def test_topology_equals_jax(built, scene, width, leaf):
    _, (_, jt), (_, tt) = built(scene, width, leaf)
    _same_ptopo(jt, tt)
    assert 0 < int(tt.n_int) < tt.topo.order.shape[0]
    # parent, the port's extra field, inverts the live internals' children
    n = int(tt.n_int)
    par = tt.topo.parent.numpy()
    for ch in (tt.topo.lchild.numpy()[:n], tt.topo.rchild.numpy()[:n]):
        assert (par[ch] == np.arange(n)).all()
    # and the bridge derives the same parent and depth from JAX's arrays
    carried = _carry(jt)
    for a, b in zip(carried.topo, tt.topo):
        _same(a, b, "carried topology")
    assert int(carried.wide_depth) == int(tt.wide_depth)


@pytest.mark.parametrize("width,leaf", SHAPES)
@pytest.mark.parametrize("scene", SCENES)
def test_build_tables_equal_jax(built, scene, width, leaf):
    _, (jlb, _), (tlb, _) = built(scene, width, leaf)
    _same(jlb.nodes, tlb.nodes, "nodes")
    _same(jlb.tri_rows, tlb.tri_rows, "tri_rows")
    assert int(jlb.num_leaves) == int(tlb.num_leaves)
    # the fused rows: written by the pack itself at width 8, by
    # WideArrays.fuse at width 4
    jwa = jl.wide_arrays_from_lbvh(jlb, leaf, width=width).fuse()
    assert (tlb.fused is None) == (width == 4)
    twa = tl.wide_arrays_from_lbvh(tlb, leaf, width=width)
    _same(jwa.fused, (twa if width == 8 else twa.fuse()).fused, "fused")


@pytest.mark.parametrize("width,leaf", SHAPES)
@pytest.mark.parametrize("scene", SCENES)
def test_refit_on_carried_topology_equals_jax(built, scene, width, leaf):
    v, (_, jt), (tlb, tt) = built(scene, width, leaf)
    w = _moved(v)
    with jax.disable_jit():
        jre = jp.refit_ploc(jt, *(jnp.asarray(x) for x in w),
                            leaf_size=leaf, width=width)
    tre = tp.refit_ploc(_carry(jt), *(torch.from_numpy(x) for x in w),
                        leaf_size=leaf, width=width)
    _same(jre.nodes, tre.nodes, "nodes")
    _same(jre.tri_rows, tre.tri_rows, "tri_rows")
    # the refit at the build's vertices is the build
    re0 = tp.refit_ploc(tt, *(torch.from_numpy(x) for x in v),
                        leaf_size=leaf, width=width)
    for name in ("nodes", "tri_rows", "fused"):
        a, b = getattr(re0, name), getattr(tlb, name)
        assert (a is None) == (b is None)
        if a is not None:
            _same(a, b, name)


@pytest.mark.parametrize("lmax", [4, 8])
def test_merge_tids_equals_jax(lmax):
    rng = np.random.default_rng(lmax)
    n = 300
    ti = rng.integers(0, 1000, (n, lmax)).astype(np.int32)
    tj = rng.integers(0, 1000, (n, lmax)).astype(np.int32)
    cnt = rng.integers(-1, lmax + 2, n).astype(np.int32)
    with jax.disable_jit():
        want = jp._merge_tids(jnp.asarray(ti), jnp.asarray(cnt),
                              jnp.asarray(tj), lmax)
    got = tp._merge_tids(*(torch.from_numpy(a) for a in (ti, cnt, tj)), lmax)
    _same(want, got, "_merge_tids")


_JIT_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_platforms", "cpu")
from vortex_rt_tpu.accel import ploc as jp
v = [np.load(sys.argv[1])[k] for k in ("v0", "v1", "v2")]
lb, t = jp.build_ploc_topo(*(jnp.asarray(x) for x in v), leaf_size=4, width=8)
out = {f: np.asarray(getattr(t.topo, f)).astype(np.int32).ravel().tolist()
       for f in t.topo._fields}
for f in ("leaf_tids", "level", "n_int", "n_levels"):
    out[f] = np.asarray(getattr(t, f)).astype(np.int32).ravel().tolist()
out["nodes"] = np.asarray(lb.nodes).view(np.int32).ravel().tolist()
out["tri_rows"] = np.asarray(lb.tri_rows).view(np.int32).ravel().tolist()
print(json.dumps(out))
"""


def test_jitted_jax_build_equals_the_port_without_fma(built, tmp_path):
    """The jitted JAX build of the sphere at width 8, leaf 4, in a
    subprocess with FMA off (``--xla_cpu_max_isa=AVX``): every field and
    word equals the port's.  With FMA on, XLA:CPU contracts the merge cost
    into FMAs, which can change the tree (ROADMAP H9)."""
    v, _, (tlb, tt) = built("uv_sphere", 8, 4)
    path = tmp_path / "verts.npz"
    np.savez(path, v0=v[0], v1=v[1], v2=v[2])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    proc = subprocess.run([sys.executable, "-c", _JIT_SCRIPT, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for f in tt.topo._fields:
        if f != "parent":
            _same(np.array(got[f], np.int32),
                  _bits(getattr(tt.topo, f)).ravel(), f)
    for f in ("leaf_tids", "level", "n_int", "n_levels"):
        _same(np.array(got[f], np.int32), _bits(getattr(tt, f)).ravel(), f)
    _same(np.array(got["nodes"], np.int32), _bits(tlb.nodes).ravel(), "nodes")
    _same(np.array(got["tri_rows"], np.int32), _bits(tlb.tri_rows).ravel(),
          "tri_rows")


@pytest.mark.parametrize("leaf", [4, 8])
def test_walks_give_brute_force_hits_at_both_widths(leaf):
    """The 8-wide fused walk and the 4-wide walk over PLOC trees of one
    soup find the same hits, and they are the brute-force hits."""
    m = _mesh("random_soup")
    v = tuple(torch.from_numpy(x)
              for x in tl.pad_tris(m.v0, m.v1, m.v2, leaf))
    was = {}
    for width in (4, 8):
        lb, pt_ = tp.build_ploc_topo(*v, leaf_size=leaf, width=width)
        was[width] = tp.wide_arrays_from_ploc(lb, pt_, leaf, width)
    assert was[8].depth == 22 and was[4].depth == 32  # the bounds hold
    o, d = _rays(384, 11)
    h8, s8 = trace_packets_ref(was[8], torch.from_numpy(o),
                               torch.from_numpy(d))
    h4, _ = trace_packets_walk_ref(was[4], torch.from_numpy(o),
                                   torch.from_numpy(d))
    assert torch.equal(h4.dist, h8.dist) and torch.equal(h4.tri, h8.tri)
    dist, tri = _brute_force(o, d, m.v0, m.v1, m.v2)
    hit = dist < LARGE_FLOAT
    assert hit.any() and not hit.all()
    assert ((h8.dist.numpy() < LARGE_FLOAT) == hit).all()
    assert (h8.tri.numpy()[hit] == tri[hit]).all()
    np.testing.assert_allclose(h8.dist.numpy()[hit], dist[hit], rtol=1e-4)


def _tilted_rays(n_side=40, span=20.0, y0=12.0):
    """Oblique rays over a grid (``tests/test_ploc.py``'s)."""
    n = n_side * n_side
    ii = np.arange(n)
    x = (ii % n_side + 0.5) / n_side * span - span / 2
    z = (ii // n_side + 0.5) / n_side * span - span / 2
    o = np.stack([x - 0.2 * span, np.full(n, y0), z - 0.2 * span], 1)
    d = np.tile(np.array([[0.25, -1.0, 0.2]], np.float32), (n, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def test_ploc_walk_takes_fewer_steps_than_karras():
    """The quality gate of ``tests/test_ploc.py`` through the port alone,
    at 7,938 triangles: the plain 8-wide walk takes fewer steps per ray
    on the PLOC tree than on the Karras tree, with the same hits."""
    m = tbig.wavy_grid(n=64)
    v = tuple(torch.from_numpy(x) for x in tl.pad_tris(m.v0, m.v1, m.v2, 4))
    lb, pt_ = tp.build_ploc_topo(*v, leaf_size=4, width=8)
    wa_p = tp.wide_arrays_from_ploc(lb, pt_, 4, 8)
    wa_k = tl.wide_arrays_from_lbvh(tl.build_lbvh(*v, leaf_size=4, width=8),
                                    4, width=8)
    o, d = _tilted_rays(48)
    hp, sp = trace_packets_ref(wa_p, o, d)
    hk, sk = trace_packets_ref(wa_k, o, d)
    assert torch.equal(hp.dist, hk.dist) and torch.equal(hp.tri, hk.tri)
    assert bool((hp.dist < LARGE_FLOAT).any())
    mean_p, mean_k = float(sp.float().mean()), float(sk.float().mean())
    assert mean_p < mean_k, (mean_p, mean_k)


def test_depth_is_the_real_depth_and_a_deep_tree_raises(built):
    """``wide_arrays_from_ploc``: depth is the larger of the LBVH bound
    and the collapsed tree's own depth (root = 1, leaves counted, as the
    host builder counts it); a tree deeper than the card's walk holds
    raises (ROADMAP H8)."""
    _, _, (lb, tt) = built("random_soup", 8, 4)
    real = int(tt.wide_depth)
    # the host builder's count, from the pool: walk every leaf up
    nodes = lb.nodes.numpy().view(np.uint32)
    meta = nodes[:, 22]
    depth = np.zeros(nodes.shape[0], np.int64)
    depth[0] = 1
    for r in range(nodes.shape[0]):     # children have larger ids
        if meta[r] != 0 and (meta[r] >> 29) == 0:
            base, n = meta[r] & ((1 << 25) - 1), (meta[r] >> 25) & 15
            depth[base:base + n] = depth[r] + 1
    assert real == int(depth.max()) and real <= 22
    wa = tp.wide_arrays_from_ploc(lb, tt, 4, 8)
    assert wa.depth == 22
    deep = tt._replace(wide_depth=torch.tensor(30, dtype=torch.int32))
    assert tp.wide_arrays_from_ploc(lb, deep, 4, 8).depth == 30
    with pytest.raises(ValueError, match="stack"):
        tp.wide_arrays_from_ploc(
            lb, tt._replace(wide_depth=torch.tensor(45, dtype=torch.int32)),
            4, 8)


@pytest.mark.parametrize("width", [4, 8])
def test_remap_collapse_of_a_chain_deeper_than_the_cap(width):
    """``_remap_collapse_ploc`` (the plain remap, then the plain collapse)
    on a chain of 297 internals over 298 of 300 leaf rows: the dead rows
    are zero, the collapse's fields equal the JAX ``_collapse_ploc``'s,
    and the deepest internal, 296 levels down, past the propagation's
    256 rounds, makes the depth DEPTH_CAP + 1."""
    l, n = 300, 297
    out = tp._remap_collapse_ploc(*chain_records(l, n), l, width)
    assert int(out[-1]) == tp.DEPTH_CAP + 1
    for a in out[:5]:
        assert not bool(a[n:].any())
    with jax.disable_jit():
        want = jp._collapse_ploc(jnp.asarray(out[0].numpy()),
                                 jnp.asarray(out[1].numpy()), jnp.int32(n),
                                 l, width)
    for k, (a, b) in enumerate(zip(want, out[6:11])):
        _same(a, b, f"collapse field {k}")


@pytest.mark.parametrize("width", [4, 8])
def test_bounds_count_each_input_and_output_once(built, width):
    """``walk_bounds.ploc_bounds`` against the bytes of the tensors that
    go into and come out of each K4 function, the merge's summed over
    the live counts of its rounds."""
    from vortex_rt_tpu_torch.tools.walk_bounds import ploc_bounds

    v, _, (_, tt) = built("random_soup", width, 4)
    v = [torch.from_numpy(x) for x in v]
    l = v[0].shape[0]

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    order, cmin0, cmax0, tids0 = tp.seed_clusters(*v, 4)
    live = []
    merged = tp._ploc_merge(cmin0, cmax0, tids0, l, l, 4, 16, live)
    out = tp._remap_collapse_ploc(*merged[:5], merged[7], l, width)
    rm, col = out[:6], out[6:]
    rows = tp._row_boxes(*v, order, merged[5], merged[6])
    refit = tp._refit_boxes_ploc(tt, *v)
    b = ploc_bounds(l, width, 4, live)
    state = nbytes(cmin0, cmax0, tids0) // l + 8      # + count, internal id
    outs = nbytes(*merged[:7])
    # reads at each round's start, writes of the survivors: the counts
    # end with the loop's last, 1 when no round cap stopped it
    assert live[-1] == 1 and len(live) == int(merged[8]) + 1
    assert b["ploc_merge"].bytes == state * (2 * sum(live) - live[0]
                                             - live[-1]) + outs
    assert b["ploc_collapse"].bytes == nbytes(*merged[:5], *rm, *col[:5])
    assert b["ploc_refit"].bytes == (
        nbytes(*v, order, tt.leaf_tids, tt.topo.row_cnt, tt.topo.lchild,
               tt.topo.rchild, *refit))
    assert b["ploc_refit_rows"].bytes == nbytes(*v, order, tt.leaf_tids,
                                                tt.topo.row_cnt, *rows)
    assert all(x.bound_by == "bytes" for x in b.values())


@pytest.mark.parametrize("width,leaf", SHAPES)
@pytest.mark.parametrize("scene", SCENES)
def test_new_ids_are_a_dense_prefix(built, scene, width, leaf):
    """The PLOC collapse's new ids and leaf rows as the pack's kernels
    rely on them (``test_torch_lbvh.assert_dense_ids``): the full pools'
    unused rows are the tail from n_used on."""
    _, _, (_, tt) = built(scene, width, leaf)
    assert_dense_ids(tt.topo)


def test_tail_size_fills_one_block_shared_memory():
    """T, the live count from which one block runs the merge's rounds:
    the most clusters of the tail kernel's words (its ``kTailWords`` a
    cluster and ``lmax`` id slots) that ``TAIL_SMEM`` holds."""
    words = _cu_constant("kTailWords")
    assert 4 * words == 44
    for lmax in (1, 2, 4, 8, 16):
        t = tp.tail_size(lmax)
        per = 4 * (words + lmax)
        assert t * per <= tp.TAIL_SMEM < (t + 1) * per
    assert (tp.tail_size(1), tp.tail_size(4), tp.tail_size(8)) == (
        4821, 3857, 3045)


@pytest.mark.parametrize("scene", SCENES)
def test_round_log_decodes_to_the_plain_live_counts(scene):
    """``decode_round_log`` over state words laid out as the kernels
    leave them (the final counters and the log where
    ``csrc/ploc_merge.cu`` puts them, every other word junk) gives the
    plain merge's ``live``; and a loop stopped by the round cap."""
    assert (tp._ST_CTR, tp._ST_FINAL, tp._ST_LOG) == tuple(
        _cu_constant(n) for n in ("kCtr", "kFinal", "kLog"))
    m = _mesh(scene)
    v = [torch.from_numpy(x) for x in tl.pad_tris(m.v0, m.v1, m.v2, 4)]
    l = v[0].shape[0]
    _, cmin0, cmax0, tids0 = tp.seed_clusters(*v, 4)
    live = []
    out = tp._ploc_merge(cmin0, cmax0, tids0, l, l, 4, 16, live)
    rounds = int(out[8])

    def state(log, final, n_int):
        s = [-7] * (tp._ST_LOG + tp.round_cap(l))
        s[tp._ST_LOG:tp._ST_LOG + len(log)] = log
        s[tp._ST_FINAL:tp._ST_FINAL + 3] = [final, n_int, len(log)]
        return s

    assert tp.decode_round_log(state(live[:-1], live[-1],
                                     int(out[7]))) == live
    assert len(live) == rounds + 1
    assert tp.decode_round_log(state([9, 7, 5], 4, 3)) == [9, 7, 5, 4]


def test_merge_rounds_stamps_each_phase():
    """``tools/merge_rounds``: the stamped copy of the merge kernel stamps
    a grid round's start and its three barriers and each tail round (the
    patch points exist in the source), and the stamps decode into each
    round's phase times."""
    from vortex_rt_tpu_torch.tools import merge_rounds as mr

    s = mr.stamped_source()
    assert s.count("stamp(g, it, ") == 6
    assert "__launch_bounds__(kTile, 4)" in mr.stamped_source(4)
    ts = torch.tensor([[0, 10_000, 13_000, 20_000],
                       [20_000, 30_000, 32_000, 40_000],
                       [40_000, 0, 0, 0], [45_000, 0, 0, 0]])
    got = mr.rounds([9000, 5000, 3000, 1], ts, tail=4000)
    assert got["grid"] == [dict(m=9000, a=10.0, b=3.0, c=7.0),
                           dict(m=5000, a=10.0, b=2.0, c=8.0)]
    assert got["tail"] == [dict(m=3000, us=5.0)]
    assert (got["rounds"], got["grid_rounds"], got["grid_us"],
            got["tail_us"]) == (3, 2, 40.0, 5.0)
