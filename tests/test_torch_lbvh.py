"""The port's on-device LBVH build and refit (``accel/lbvh.py``, plain
PyTorch versions on the CPU) against the JAX package's, on the same
vertices from seeded NumPy generators: tolerance 0 everywhere — every
``LBVHTopo`` field equal, ``nodes`` equal word for word, ``tri_rows``
equal bit for bit.

The JAX side runs with ``jax.disable_jit()``: jitted, ``_karras`` alone
compiles 95 unrolled whole-array steps for every new triangle count
(about a minute).  The jitted programs, which may fuse and contract what
op-by-op execution does not (hazard H2), are compared once, as the ladder
runs them: ``test_jitted_jax_*`` on the soup at width 8, leaf 4.

The one place the packages can differ is the scale exponent (hazard H7):
XLA:CPU's ``log2`` rounds ``log2(x)`` to k for x one ulp above 2**k
(for k >= 3 and k <= -6), so its ``ceil`` gives a scale half the port's (the port reads the exponent
from the float's bits).  ``test_h7_exponent_case`` builds a scene that
hits it and checks that only the scale of that node differs and that no
hit changes; no other scene here has such a node.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vortex_rt_tpu.accel import lbvh as jl
from vortex_rt_tpu.models import bigscenes as jbig
from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu_torch import bridge
from vortex_rt_tpu_torch.accel import lbvh as tl
from vortex_rt_tpu_torch.models import bigscenes as tbig
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.ops.packet_walk import trace_packets_walk_ref
from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets_ref
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

SCENES = ("uv_sphere", "random_soup")
SHAPES = ((4, 4), (8, 4), (8, 8), (4, 8))  # (width, leaf)


def _mesh(scene):
    if scene == "uv_sphere":
        return tproc.uv_sphere((0, 0, 0), 1.0, 8, 16)   # 224 triangles
    return tproc.random_soup(np.random.default_rng(3), 500)


def _bits(a):
    """Any array or tensor as int32 words (floats by their bits)."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    if a.dtype == np.bool_:
        return a.astype(np.int32)
    return np.ascontiguousarray(a).view(np.int32) if a.itemsize == 4 else a


def _same(a, b, what):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert (a == b).all(), (what, int((a != b).sum()), "words differ")


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
                j = jl.build_lbvh_topo(*(jnp.asarray(x) for x in v),
                                       leaf_size=leaf, width=width)
            t = tl.build_lbvh_topo(*(torch.from_numpy(x) for x in v),
                                   leaf_size=leaf, width=width)
            cache[key] = (v, j, t)
        return cache[key]

    return get


def assert_dense_ids(topo):
    """The collapse's new ids of the survivors and of the used leaf rows
    are 0 .. n_used - 1, each once, n_used = base + arity of the last
    internal when it survives; the used leaf rows are the first ones.
    The pack's kernels rely on it: they write every row below n_used
    from its one record and zero the pool rows from n_used on."""
    l = topo.order.shape[0]
    used = topo.row_cnt > 0
    ids = torch.cat([topo.newid[: l - 1][topo.surv],
                     topo.leaf_newid[used]]).sort().values
    n_used = int(topo.base[l - 2]) + (int(topo.arity[l - 2])
                                      if bool(topo.surv[l - 2]) else 0)
    assert torch.equal(ids.long(), torch.arange(n_used))
    assert torch.equal(topo.leaf_newid >= 0, used)
    assert not bool(used[int(used.sum()):].any())


@pytest.fixture(scope="module")
def jitted():
    """The soup at width 8, leaf 4 through the jitted JAX build and a
    jitted refit of the moved vertices -> (vertices, moved vertices, JAX
    (nodes, topo), JAX refit nodes)."""
    m = _mesh("random_soup")
    v = tl.pad_tris(m.v0, m.v1, m.v2, 4)
    w = _moved(v)
    jlb, jtopo = jl.build_lbvh_topo(*(jnp.asarray(x) for x in v),
                                    leaf_size=4, width=8)
    jre = jl.refit_lbvh(jtopo, *(jnp.asarray(x) for x in w), leaf_size=4,
                        width=8)
    return v, w, (jlb, jtopo), jre


def _carry(jtopo):
    return bridge.lbvh_topo(device="cpu", **{
        f: np.asarray(getattr(jtopo, f)) for f in jtopo._fields})


def _moved(v, shift=0.37):
    """The vertices pushed along a smooth field (new boxes everywhere)."""
    def move(a):
        out = a.copy()
        out[:, 1] += np.float32(shift) * np.sin(a[:, 0] * np.float32(1.3))
        out[:, 0] += np.float32(0.11)
        return out
    return tuple(move(a) for a in v)


@pytest.mark.parametrize("n", [1, 7, 4096])
def test_morton3d_equals_jax(n):
    rng = np.random.default_rng(n)
    x, y, z = (rng.uniform(-0.1, 1.1, n).astype(np.float32) for _ in range(3))
    want = np.asarray(jl.morton3d(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(z)))
    got = tl.morton3d(*(torch.from_numpy(a) for a in (x, y, z)))
    _same(want, got, "morton3d")


@pytest.mark.parametrize("width,leaf", SHAPES)
@pytest.mark.parametrize("scene", SCENES)
def test_topology_equals_jax(built, scene, width, leaf):
    _, (_, jtopo), (_, ttopo) = built(scene, width, leaf)
    for f in jtopo._fields:
        _same(getattr(jtopo, f), getattr(ttopo, f), f)
    # parent, the port's extra field, is the inverse of the child lists
    par = ttopo.parent.numpy()
    for ch in (ttopo.lchild.numpy(), ttopo.rchild.numpy()):
        assert (par[ch] == np.arange(len(ch))).all()


@pytest.mark.parametrize("width,leaf", SHAPES)
@pytest.mark.parametrize("scene", SCENES)
def test_new_ids_are_a_dense_prefix(built, scene, width, leaf):
    """Which pool rows the pack's records reach (``assert_dense_ids``),
    on the topology that equals the JAX package's."""
    _, _, (_, topo) = built(scene, width, leaf)
    assert_dense_ids(topo)


@pytest.mark.parametrize("width,leaf", SHAPES)
@pytest.mark.parametrize("scene", SCENES)
def test_build_tables_equal_jax(built, scene, width, leaf):
    _, (jlb, _), (tlb, _) = built(scene, width, leaf)
    _same(jlb.nodes, tlb.nodes, "nodes")
    _same(jlb.tri_rows, tlb.tri_rows, "tri_rows")
    assert int(jlb.num_leaves) == int(tlb.num_leaves)


def test_jitted_jax_topology_equals_the_port(jitted, built):
    _, _, (_, jtopo), _ = jitted
    _, _, (_, ttopo) = built("random_soup", 8, 4)
    for f in jtopo._fields:
        _same(getattr(jtopo, f), getattr(ttopo, f), f)


def test_jitted_jax_build_tables_equal_the_port(jitted, built):
    _, _, (jlb, _), _ = jitted
    _, _, (tlb, _) = built("random_soup", 8, 4)
    _same(jlb.nodes, tlb.nodes, "nodes")
    _same(jlb.tri_rows, tlb.tri_rows, "tri_rows")


def test_jitted_jax_refit_equals_the_port(jitted, built):
    _, w, _, jre = jitted
    _, _, (_, ttopo) = built("random_soup", 8, 4)
    tre = tl.refit_lbvh(ttopo, *(torch.from_numpy(x) for x in w),
                        leaf_size=4, width=8)
    _same(jre.nodes, tre.nodes, "nodes")
    _same(jre.tri_rows, tre.tri_rows, "tri_rows")


@pytest.mark.parametrize("pools", ["full", "compact"])
@pytest.mark.parametrize("width,leaf,tlas", [(4, 4, False), (8, 4, False),
                                            (4, 4, True)])
@pytest.mark.parametrize("scene", SCENES)
def test_refit_on_carried_topology_equals_jax(built, scene, width, leaf,
                                              tlas, pools):
    v, (_, jtopo), _ = built(scene, width, leaf)
    ttopo = _carry(jtopo)
    w = _moved(v)
    jkw, tkw = {}, {}
    if pools == "compact":
        jp, jr, js = jl.compact_plan(jtopo, pad=32)
        tp, tr, ts = tl.compact_plan(ttopo, pad=32)
        assert (jp, jr) == (tp, tr)
        _same(js, ts, "surv_idx")
        jkw = dict(pool_rows=jp, leaf_rows=jr, surv_idx=js)
        tkw = dict(pool_rows=tp, leaf_rows=tr, surv_idx=ts)
    with jax.disable_jit():
        jlb = jl.refit_lbvh(jtopo, *(jnp.asarray(x) for x in w),
                            leaf_size=leaf, width=width, tlas=tlas, **jkw)
    tlb = tl.refit_lbvh(ttopo, *(torch.from_numpy(x) for x in w),
                        leaf_size=leaf, width=width, tlas=tlas, **tkw)
    _same(jlb.nodes, tlb.nodes, "nodes")
    _same(jlb.tri_rows, tlb.tri_rows, "tri_rows")


@pytest.mark.parametrize("width", [4, 8])
def test_wide_arrays_and_fused_rows_equal_jax(built, width):
    """``wide_arrays_from_lbvh`` of a refit against the JAX package's,
    and its fused rows against ``.fuse()`` there: written by the refit
    itself at width 8, by ``WideArrays.fuse`` at width 4."""
    v, (jlb, _), (_, ttopo) = built("random_soup", width, 4)
    jwa = jl.wide_arrays_from_lbvh(jlb, 4, width=width)
    tlb = tl.refit_lbvh(ttopo, *(torch.from_numpy(x) for x in v),
                        leaf_size=4, width=width)
    assert (tlb.fused is None) == (width == 4)
    twa = tl.wide_arrays_from_lbvh(tlb, 4, width=width)
    assert (twa.num_tlas, twa.tri_bits, twa.max_leaf_tris, twa.depth,
            twa.width) == (jwa.num_tlas, jwa.tri_bits, jwa.max_leaf_tris,
                           jwa.depth, jwa.width)
    _same(jwa.fuse().fused, (twa if width == 8 else twa.fuse()).fused,
          "fused")


def _brute_force(o, d, v0, v1, v2, eps=1e-6):
    """Closest Moller-Trumbore hit of every ray over every triangle, in
    float64 -> (dist, tri); LARGE_FLOAT / -1 on a miss."""
    o, d = o[:, None, :].astype(np.float64), d[:, None, :].astype(np.float64)
    a = v0[None].astype(np.float64)
    e1, e2 = v1[None] - a, v2[None] - a
    h = np.cross(d, e2)
    det = (e1 * h).sum(-1)
    ok = np.abs(det) > eps
    inv = 1.0 / np.where(ok, det, 1.0)
    s = o - a
    u = inv * (s * h).sum(-1)
    q = np.cross(s, e1)
    w = inv * (d * q).sum(-1)
    t = inv * (e2 * q).sum(-1)
    ok &= (u >= 0) & (u <= 1) & (w >= 0) & (u + w <= 1) & (t > eps)
    t = np.where(ok, t, np.inf)
    tri = t.argmin(1)
    best = t[np.arange(t.shape[0]), tri]
    return (np.where(np.isfinite(best), best, LARGE_FLOAT),
            np.where(np.isfinite(best), tri, -1))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-14, 14, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("leaf", [4, 8])
def test_walks_give_brute_force_hits_at_both_widths(leaf):
    """The port's counterpart of ``tests/test_lbvh8.py``: the 8-wide
    fused walk and the 4-wide walk over device-built trees of one soup
    find the same hits, and they are the brute-force hits."""
    m = _mesh("random_soup")
    v = tuple(torch.from_numpy(x) for x in tl.pad_tris(m.v0, m.v1, m.v2, leaf))
    wa8 = tl.wide_arrays_from_lbvh(
        tl.build_lbvh(*v, leaf_size=leaf, width=8), leaf, width=8)
    wa4 = tl.wide_arrays_from_lbvh(
        tl.build_lbvh(*v, leaf_size=leaf, width=4), leaf, width=4)
    assert wa8.width == 8 and wa8.depth == 22 and wa4.depth == 32

    def n_internal(wa):
        meta = wa.nodes[:, 6 + 2 * wa.width]
        return int(((meta != 0) & ((meta >> 29) == 0)).sum())

    assert n_internal(wa8) < n_internal(wa4)
    o, d = _rays(384, 11)
    h8, s8 = trace_packets_ref(wa8, torch.from_numpy(o), torch.from_numpy(d))
    h4, s4 = trace_packets_walk_ref(wa4, torch.from_numpy(o),
                                    torch.from_numpy(d))
    assert torch.equal(h4.dist, h8.dist) and torch.equal(h4.tri, h8.tri)
    assert int(s8.sum()) < int(s4.sum())
    dist, tri = _brute_force(o, d, m.v0, m.v1, m.v2)
    hit = dist < LARGE_FLOAT
    assert hit.any() and not hit.all()
    assert ((h8.dist.numpy() < LARGE_FLOAT) == hit).all()
    assert (h8.tri.numpy()[hit] == tri[hit]).all()
    np.testing.assert_allclose(h8.dist.numpy()[hit], dist[hit], rtol=1e-4)


@pytest.mark.parametrize("width", [4, 8])
def test_bounds_count_each_input_and_output_once(built, width):
    """``walk_bounds.lbvh_bounds`` against the bytes of the tensors that
    go into and come out of each step, on a compact plan."""
    from vortex_rt_tpu_torch.tools.walk_bounds import lbvh_bounds

    v, _, (_, topo) = built("random_soup", width, 4)
    v = [torch.from_numpy(x) for x in v]
    l = v[0].shape[0]

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    codes, smin, smax = tl.scene_codes(*v)
    tree = tl._karras(torch.sort(codes, stable=True)[0], l)
    col = tl._collapse_wide(*tree, l, 4, width)
    boxes = tl._refit_boxes(topo, *v)
    pool, rows, surv_idx = tl.compact_plan(topo, pad=32)
    packed = tl._pack_rows(topo, *boxes, *v, 4, width, pool_rows=pool,
                           leaf_rows=rows, surv_idx=surv_idx,
                           fused=width == 8)
    b = lbvh_bounds(l, width, 4, pool, rows, surv_idx.shape[0], width == 8,
                    16)
    assert b["lbvh_karras"].bytes == (nbytes(*v, smin, smax, codes)
                                      + nbytes(codes, *tree))
    plan = tl._refit_plan(topo, 16)   # (the collapse's own on the card)
    assert b["lbvh_collapse"].bytes == nbytes(
        *tree, *col, tl.topo_state(topo).num_leaves, *plan)
    assert b["lbvh_refit"].bytes == nbytes(*v, topo.order, topo.lchild,
                                           topo.rchild, *boxes)
    s = surv_idx.shape[0]
    per_survivor = nbytes(surv_idx) + s * (1 + 12 + 4 * width)
    assert b["lbvh_pack"].bytes == (
        per_survivor + nbytes(*boxes) // (2 * l - 1) * min(2 * l - 1, pool)
        + 12 * rows + nbytes(topo.order, *v)
        + nbytes(*(t for t in packed if t is not None)))
    assert all(x.bound_by == "bytes" for x in b.values())


def test_refit_follows_the_moved_geometry():
    m = tproc.uv_sphere((0, 0, 0), 1.0, 10, 14)
    v = [torch.from_numpy(x) for x in tl.pad_tris(m.v0, m.v1, m.v2, 4)]
    _, topo = tl.build_lbvh_topo(*v, leaf_size=4, width=8)
    o = torch.tensor([[0.0, 0.0, -5.0]]).repeat(32, 1)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(32, 1)
    for shift in (0.0, 2.0):
        lb = tl.refit_lbvh(topo, *(x + shift for x in v), leaf_size=4,
                           width=8)
        hits, _ = trace_packets_ref(tl.wide_arrays_from_lbvh(lb, 4, width=8),
                                    o, d)
        if shift == 0.0:
            np.testing.assert_allclose(hits.dist.numpy(), 4.0, atol=0.05)
        else:
            assert bool((hits.dist == LARGE_FLOAT).all())


def test_h7_exponent_case():
    """A root whose x extent over 255 is one ulp above 2**3: XLA:CPU's
    ``ceil(log2(.))`` gives 3 there (it is right at 2**0 .. 2**2), the
    exact exponent is 4."""
    two_k = np.float32(8.0)
    ext = np.float32(255.0) * two_k
    while ext / np.float32(255.0) <= two_k:
        ext = np.nextafter(ext, np.float32(np.inf))
    assert ext / np.float32(255.0) == np.nextafter(two_k, np.float32(16.0))
    rng = np.random.default_rng(9)
    n = 200
    v0 = rng.uniform(100.0, 1900.0, (n, 3)).astype(np.float32)
    v1 = v0 + rng.normal(0, 8.0, (n, 3)).astype(np.float32)
    v2 = v0 + rng.normal(0, 8.0, (n, 3)).astype(np.float32)
    v0[0, 0], v0[1, 0] = 0.0, ext        # the scene's x range is [0, ext]
    with jax.disable_jit():
        jlb, jtopo = jl.build_lbvh_topo(*(jnp.asarray(x) for x in
                                          (v0, v1, v2)), width=8)
    tlb, ttopo = tl.build_lbvh_topo(*(torch.from_numpy(x) for x in
                                      (v0, v1, v2)), width=8)
    for f in jtopo._fields:
        _same(getattr(jtopo, f), getattr(ttopo, f), f)
    _same(jlb.tri_rows, tlb.tri_rows, "tri_rows")
    jn, tn = _bits(jlb.nodes), _bits(tlb.nodes)
    rows = np.nonzero((jn != tn).any(1))[0]
    assert rows.tolist() == [0], rows      # only the root differs
    js, ts = (a[0, 3:6].view(np.float32) for a in (jn, tn))
    assert (js[0], ts[0]) == (8.0, 16.0) and (js[1:] == ts[1:]).all()
    assert (jn[0, 0:3] == tn[0, 0:3]).all() and jn[0, 22] == tn[0, 22]
    # the looser scale changes no hit
    o, d = _rays(256, 2)
    o = o * np.float32(70.0) + np.float32(950.0)
    aim = ((v0 + v1 + v2) / np.float32(3.0))[:128] - o[:128]
    d[:128] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    twa = tl.wide_arrays_from_lbvh(tlb, 4, width=8)
    jwa = bridge.wide_arrays(
        np.asarray(jlb.nodes), np.asarray(jlb.tri_rows), num_tlas=0,
        max_leaf_tris=4, depth=22, tri_bits=twa.tri_bits, width=8,
        device="cpu").fuse()
    ht, _ = trace_packets_ref(twa, torch.from_numpy(o), torch.from_numpy(d))
    hj, _ = trace_packets_ref(jwa, torch.from_numpy(o), torch.from_numpy(d))
    assert bool((ht.dist < LARGE_FLOAT).any())
    for a, b in zip(ht, hj):
        assert torch.equal(a, b)


def test_scale_exponent_is_exact():
    ks = np.arange(-126, 128)
    p = (2.0 ** ks.astype(np.float64)).astype(np.float32)
    rnd = np.exp(np.random.default_rng(0).uniform(-60, 60, 20000)
                 ).astype(np.float32)
    x = np.concatenate([p, np.nextafter(p, np.float32(np.inf))[:-1],
                        np.nextafter(p, np.float32(0))[1:], rnd])
    m, e = np.frexp(x.astype(np.float64))    # x = m * 2**e, m in [0.5, 1)
    want = np.clip(np.where(m == 0.5, e - 1, e), -126, 127)
    got = tl.scale_exponent(torch.from_numpy(x)).numpy()
    assert (got == want).all()


def test_staleness_and_surface_area_equal_jax(built):
    v, (jlb, jtopo), (tlb, ttopo) = built("uv_sphere", 4, 4)
    assert tl.tree_surface_area(tlb.nodes) == jl.tree_surface_area(jlb.nodes)
    w = _moved(v, shift=0.9)
    with jax.disable_jit():
        want = jl.refit_staleness(jtopo, *(jnp.asarray(x) for x in w))
    got = tl.refit_staleness(ttopo, *(torch.from_numpy(x) for x in w))
    assert got == want and 0.5 < got < 4.0


@pytest.mark.parametrize("t,leaf", [(10, 4), (12, 4), (13, 8)])
def test_pad_tris(t, leaf):
    rng = np.random.default_rng(t)
    v = [rng.normal(size=(t, 3)).astype(np.float32) for _ in range(3)]
    for a, b in zip(jl.pad_tris(*v, leaf), tl.pad_tris(*v, leaf)):
        assert a.shape[0] % leaf == 0
        _same(a, b, "pad_tris")


@pytest.mark.parametrize("n,t", [(24, 0.0), (9, 0.7)])
def test_wavy_grid_equals_jax(n, t):
    a, b = jbig.wavy_grid(n=n, t=t), tbig.wavy_grid(n=n, t=t)
    assert a.num_tris == 2 * (n - 1) ** 2
    for f in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2"):
        _same(getattr(a, f), getattr(b, f), f)


def test_random_soup_equals_jax():
    a = jproc.random_soup(np.random.default_rng(4), 100)
    b = tproc.random_soup(np.random.default_rng(4), 100)
    for f in ("v0", "v1", "v2"):
        _same(getattr(a, f), getattr(b, f), f)


def test_refused_options():
    v = [torch.zeros(16, 3)] * 3
    with pytest.raises(ValueError):
        tl.build_lbvh_topo(*v, method="median")
    with pytest.raises(ValueError, match="smaller than one leaf"):
        tl.build_lbvh_topo(*(x[:4] for x in v))
    v = [torch.rand(16, 3) for _ in range(3)]
    _, topo = tl.build_lbvh_topo(*v, width=8)
    with pytest.raises(ValueError, match="4-wide only"):
        tl.refit_lbvh(topo, *v, width=8, tlas=True)


# ------------------------------------------------- the sweep-SAH tree

# The meshes of the sweep-SAH checks, made from seeded NumPy alone, run in
# this process and in the JAX subprocess: a 300-triangle soup, and a
# regular grid of 12 x 12 squares (corner heights 0 or 0.5 in a checker
# pattern, so no box is flat: a flat box's scale exponent is hazard H7)
# with every triangle twice, where equal boxes and mirror-symmetric
# splits give equal costs (the argmin's ties).
_SAH_MESHES = r"""
import numpy as np


def sah_meshes():
    rng = np.random.default_rng(17)
    base = rng.uniform(-10, 10, (300, 3)).astype(np.float32)
    soup = tuple(base + rng.normal(size=(300, 3)).astype(np.float32)
                 for _ in range(3))
    g = np.arange(12, dtype=np.float32)
    x, y = (a.ravel() for a in np.meshgrid(g, g))

    def corner(px, py):
        return np.stack([px, py, np.float32(0.5) * ((px + py) % 2)], 1)

    p00, p10 = corner(x, y), corner(x + 1, y)
    p11, p01 = corner(x + 1, y + 1), corner(x, y + 1)
    tri = (np.concatenate([p00, p00]), np.concatenate([p10, p11]),
           np.concatenate([p11, p01]))
    ties = tuple(np.concatenate([a, a]).astype(np.float32) for a in tri)
    return {"soup": soup, "ties": ties}
"""

# jitted, in an interpreter with XLA_FLAGS=--xla_cpu_max_isa=AVX (no FMA
# contraction of the cost's products and sums, hazard H2): _sah_sweep_tree
# over each mesh's Morton-sorted leaf boxes, and build_lbvh_topo(
# method="sah") at widths 4 and 8
_SAH_REFERENCE = _SAH_MESHES + r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from vortex_rt_tpu.accel import lbvh as jl

out = {}
sweep = jax.jit(jl._sah_sweep_tree, static_argnums=2)
for name, v in sah_meshes().items():
    v = [jnp.asarray(a) for a in v]
    for w in (4, 8):
        lb, topo = jl.build_lbvh_topo(*v, leaf_size=4, method="sah", width=w)
        for k, a in topo._asdict().items():
            out[f"{name}/{w}/topo/{k}"] = np.asarray(a)
        out[f"{name}/{w}/nodes"] = np.asarray(lb.nodes)
        out[f"{name}/{w}/tri_rows"] = np.asarray(lb.tri_rows)
    lmin, lmax = jl._leaf_boxes(*v, topo.order)
    for k, a in zip(("lchild", "rchild", "lo", "hi"),
                    sweep(lmin, lmax, v[0].shape[0])):
        out[f"{name}/sweep/{k}"] = np.asarray(a)
np.savez(sys.argv[1], **out)
"""
SAH_MESHES = ("soup", "ties")


@pytest.fixture(scope="module", autouse=True)
def _sah_reference_started(tmp_path_factory):
    """Starts the JAX reference's subprocess when the module's first test
    starts, so that it runs beside the tests before the sweep-SAH ones;
    ``sah_reference`` waits for it."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = tmp_path_factory.mktemp("sah") / "jax_sah.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.Popen([sys.executable, "-c", _SAH_REFERENCE, str(path)],
                            cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        yield proc, path
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def sah_reference(_sah_reference_started):
    proc, path = _sah_reference_started
    out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _sah_mesh(name):
    ns = {}
    exec(_SAH_MESHES, ns)
    return [torch.from_numpy(a) for a in ns["sah_meshes"]()[name]]


@pytest.mark.parametrize("mesh", SAH_MESHES)
def test_sah_sweep_tree_equals_jax(sah_reference, mesh):
    """``_sah_sweep_tree`` over the JAX build's sorted leaf boxes: lchild,
    rchild, lo and hi equal word for word; ``levels`` is the loop's count,
    one more than the deepest internal's depth."""
    ref = sah_reference
    v = _sah_mesh(mesh)
    order = torch.from_numpy(ref[f"{mesh}/4/topo/order"])
    lmin, lmax = tl._leaf_boxes(*v, order)
    l = v[0].shape[0]
    *got, levels = tl._sah_sweep_tree(lmin, lmax, l)
    for k, a in zip(("lchild", "rchild", "lo", "hi"), got):
        _same(ref[f"{mesh}/sweep/{k}"], a, k)
    # every internal's range splits into two non-empty halves
    lo, hi = got[2].numpy(), got[3].numpy()
    assert (hi > lo).all()
    depth = np.zeros(l - 1, np.int64)
    for k in range(l - 1):  # ids grow level by level: parents come first
        for c in (got[0][k], got[1][k]):
            if c < l - 1:
                depth[c] = depth[k] + 1
    assert levels == depth.max() + 1


@pytest.mark.parametrize("mesh", SAH_MESHES)
def test_sah_live_counts_match_brute_force(mesh):
    """The plain sweep's live positions a level (what ``sah_bounds``
    counts and the kernel reports) against a brute-force count from the
    tree it built: an internal node at binary depth d holds hi - lo + 1
    positions in a range longer than one at level d.  The bound is a
    live position's 24-B box and 41 operations a level, the tree written
    once (the first version's figure: 48 B every position at every level);
    exact
    integers."""
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    v = _sah_mesh(mesh)
    l = v[0].shape[0]
    _, order = torch.sort(tl.scene_codes(*v)[0], stable=True)
    live = []
    lch, rch, lo, hi, levels = tl._sah_sweep_tree_ref(
        *tl._leaf_boxes(*v, order.to(torch.int32)), l, live=live)
    depth = np.zeros(l - 1, np.int64)
    lch, rch = lch.numpy(), rch.numpy()
    for k in range(l - 1):   # ids are allocated level by level
        for c in (lch[k], rch[k]):
            if c < l - 1:
                depth[c] = depth[k] + 1
    brute = np.bincount(depth, weights=(hi - lo + 1).numpy(),
                        minlength=levels).astype(np.int64)
    assert live == brute.tolist() and len(live) == levels
    assert live[0] == l and all(a >= b for a, b in zip(live, live[1:]))
    b = wb.sah_bounds(l, levels, live)
    assert (b.ops, b.bytes) == (41 * sum(live), 24 * sum(live) + 16 * (l - 1))
    every = wb.sah_bounds(l, levels)
    assert every.bytes == 48 * l * levels + 16 * (l - 1) > b.bytes


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("mesh", SAH_MESHES)
def test_sah_build_equals_jax(sah_reference, mesh, width):
    """``build_lbvh_topo(method="sah")``: every ``LBVHTopo`` field, the
    node words and the triangle rows equal the JAX build's; the nodes
    carry the collapsed tree's real depth."""
    ref = sah_reference
    v = _sah_mesh(mesh)
    lb, topo = tl.build_lbvh_topo(*v, leaf_size=4, method="sah", width=width)
    for k in ref_fields(ref, f"{mesh}/{width}/topo/"):
        _same(ref[f"{mesh}/{width}/topo/{k}"], getattr(topo, k), k)
    _same(ref[f"{mesh}/{width}/nodes"], lb.nodes, "nodes")
    _same(ref[f"{mesh}/{width}/tri_rows"], lb.tri_rows, "tri_rows")
    wa = tl.wide_arrays_from_lbvh(lb, 4, width=width)
    assert lb.wide_depth is not None and wa.depth >= lb.wide_depth >= 2


def ref_fields(ref, prefix):
    return [k[len(prefix):] for k in ref if k.startswith(prefix)]


def test_sah_tree_walks_to_brute_force_hits():
    """K1's and K2's plain walks over the sweep-SAH tree find the hits of
    the Karras tree over the same soup (ids equal, distances within
    1e-6 relative: the trees group the triangles differently)."""
    v = _sah_mesh("soup")
    rng = np.random.default_rng(5)
    o = torch.from_numpy(rng.uniform(-12, 12, (256, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(256, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    for width, walk in ((8, trace_packets_ref), (4, trace_packets_walk_ref)):
        hits = []
        for method in ("sah", "karras"):
            lb, _ = tl.build_lbvh_topo(*v, leaf_size=4, method=method,
                                       width=width)
            wa = tl.wide_arrays_from_lbvh(lb, 4, width=width)
            hits.append(walk(wa, o, d)[0])
        a, b = hits
        assert torch.equal(a.tri, b.tri)
        assert torch.allclose(a.dist, b.dist, rtol=1e-6)
        assert int((a.dist < LARGE_FLOAT).sum()) > 10


def test_deep_sah_tree_is_refused():
    """A tree deeper than the card's walk holds raises where it is
    wrapped (ROADMAP H8), at both widths."""
    v = _sah_mesh("soup")
    for width in (4, 8):
        lb, _ = tl.build_lbvh_topo(*v, leaf_size=4, method="sah",
                                   width=width)
        deep = tl.LBVHNodes(nodes=lb.nodes, tri_rows=lb.tri_rows,
                            num_leaves=lb.num_leaves, fused=lb.fused,
                            wide_depth=60)
        with pytest.raises(ValueError, match="stack entries"):
            tl.wide_arrays_from_lbvh(deep, 4, width=width)


def test_width4_refusal_reads_k2s_cap():
    """At width 4 the refusal reads K2's cap of packed entries (depth + 4
    of 48): a sweep-SAH tree 44 levels deep is taken, 45 refused."""
    from vortex_rt_tpu_torch.ops import packet_walk as pw

    lb, _ = tl.build_lbvh_topo(*_sah_mesh("soup"), leaf_size=4,
                               method="sah", width=4)
    cap = pw.STACK_MAX - 4

    def deep(levels):
        return tl.LBVHNodes(nodes=lb.nodes, tri_rows=lb.tri_rows,
                            num_leaves=lb.num_leaves, fused=lb.fused,
                            wide_depth=levels)

    assert tl.wide_arrays_from_lbvh(deep(cap), 4, width=4).depth == cap
    with pytest.raises(ValueError, match=f"holds {pw.STACK_MAX} stack"):
        tl.wide_arrays_from_lbvh(deep(cap + 1), 4, width=4)


# ------------------------------------ the refit climb's tiles (K5 C)

def _plain_tree(method, l, dups, seed=0):
    """The port's plain Karras or sweep-SAH tree over ``l`` sorted leaves
    -> (lchild, rchild, lo, hi) int64: Karras over sorted random codes,
    the sweep over random leaf boxes; ``dups`` draws from 6 values, so
    most codes and boxes repeat."""
    rng = np.random.default_rng(seed)
    if method == "karras":
        codes = np.sort(rng.integers(0, 6 if dups else 2**30, l))
        tree = tl._karras_ref(torch.from_numpy(codes.astype(np.int32)), l)
    else:
        c = rng.integers(0, 6, (l, 3)) if dups else rng.uniform(-9, 9, (l, 3))
        c = torch.from_numpy(c.astype(np.float32))
        tree = tl._sah_sweep_tree_ref(c - 0.5, c + 0.5, l)[:4]
    return tuple(a.long() for a in tree)


def _child_range(c, lo, hi, l):
    leaf = c >= l - 1
    ci = c.clamp(max=l - 2)
    return (torch.where(leaf, c - (l - 1), lo[ci]),
            torch.where(leaf, c - (l - 1), hi[ci]))


@pytest.mark.parametrize("dups", [False, True])
@pytest.mark.parametrize("method", ["karras", "sah"])
@pytest.mark.parametrize("l", [2, 3, 7, 33, 100, 257, 333])
def test_split_gaps_key_the_internal_nodes(method, l, dups):
    """The refit kernel's shared slot key: an internal node's split gap,
    the last sorted position of its left child, lies in its own range
    [lo, hi - 1], and the gaps of all internals are 0 .. l-2, each once,
    on Karras and sweep-SAH trees alike.  A thread arriving from either
    child [a, b] finds it as the kernel does: b when a == lo (the left
    child), else a - 1."""
    lchild, rchild, lo, hi = _plain_tree(method, l, dups)
    la, lb = _child_range(lchild, lo, hi, l)
    ra, rb = _child_range(rchild, lo, hi, l)
    gap = lb
    assert bool(((lo <= gap) & (gap < hi)).all())
    assert torch.equal(gap.sort().values, torch.arange(l - 1))
    assert torch.equal(la, lo) and torch.equal(rb, hi)
    assert not bool((ra == lo).any())
    assert torch.equal(torch.where(la == lo, lb, la - 1), gap)
    assert torch.equal(torch.where(ra == lo, rb, ra - 1), gap)


def _tile_model(topo, v, tile, seed):
    """A model of ``csrc/lbvh_refit.cu`` over its plan (``_refit_plan``,
    CPU: ``_refit_records_ref``): each block of treelets (maximal subtrees
    of at most ``tile`` leaves) joins its inner nodes deepest first from
    their records' child slots (leaf positions and gaps from the block's
    first leaf); then the treelets' roots, in a random order (any
    interleaving of the kernel's climbs is one of these: a climb never
    waits), climb with the plan's counters, the second arriver at a node
    joining it.  -> (bmin, bmax, plan, the counters afterwards)."""
    l = v[0].shape[0]
    n = l - 1
    lmin, lmax = tl._leaf_boxes(*v, topo.order)
    plan = tl._refit_plan(topo, tile)
    rec = plan.rec.tolist()
    arrived = plan.arrived.tolist()
    lc, rc, par = (t.tolist() for t in (topo.lchild, topo.rchild,
                                        topo.parent))
    bmin = torch.full((2 * l - 1, 3), float("nan"))
    bmax = bmin.clone()
    bmin[n:], bmax[n:] = lmin, lmax
    roots = []
    rows = plan.roots.tolist()
    for t0, t1, rb, re in plan.blocks.tolist():
        assert t1 - t0 < tile
        box = {}

        def child(ref):
            if ref & tl._LEAF_REF:
                j = t0 + (ref & 0x3FF)
                assert t0 <= j <= t1
                return lmin[j], lmax[j]
            return box[ref]      # a deeper node of this block: joined

        loc = [(i, r) for i, r in enumerate(rec[t0:t1]) if r[0] >= 0]
        for i, r in sorted(loc, key=lambda ir: -(ir[1][1] >> 22)):
            (a0, a1), (b0, b1) = child(r[1] & 0x7FF), child(r[1] >> 11 & 0x7FF)
            box[i] = (torch.minimum(a0, b0), torch.maximum(a1, b1))
            bmin[r[0]], bmax[r[0]] = box[i]
        for root, slot in rows[rb:re]:
            b = child(slot)
            assert torch.equal(bmin[root], b[0]) and torch.equal(bmax[root],
                                                                 b[1])
            if root != 0:
                roots.append(root)
    for k in np.random.default_rng(seed).permutation(len(roots)).tolist():
        node = roots[k]
        mn, mx = bmin[node].clone(), bmax[node].clone()
        p = par[node]
        while True:
            arrived[p] += 1
            if arrived[p] == 1:
                break
            arrived[p] = 0
            sib = rc[p] if lc[p] == node else lc[p]
            mn, mx = torch.minimum(mn, bmin[sib]), torch.maximum(mx, bmax[sib])
            bmin[p], bmax[p] = mn, mx
            if p == 0:
                break
            node, p = p, par[p]
    return bmin, bmax, plan, arrived


@pytest.mark.parametrize("tile", [4, 16, 64])
@pytest.mark.parametrize("method", ["karras", "sah"])
def test_tile_model_equals_the_range_refit(method, tile):
    """The kernel's treelets and climbs, modelled on the CPU over its
    plan for a 500-triangle soup (treelets of at most 4 to 64 leaves:
    tens of them, packed into blocks of at most as many), give
    ``_refit_boxes_ref``'s boxes bit for bit and leave every counter zero.
    The plan: the blocks partition the sorted leaves; every internal has
    one record; a treelet's inner child is one deeper than its parent."""
    m = _mesh("random_soup")
    v = [torch.from_numpy(x) for x in tl.pad_tris(m.v0, m.v1, m.v2, 4)]
    _, topo = tl.build_lbvh_topo(*v, method=method)
    w = [torch.from_numpy(x) for x in _moved([x.numpy() for x in v])]
    bmin, bmax, plan, arrived = _tile_model(topo, w, tile, seed=tile)
    want = tl._refit_boxes_ref(topo, *w)
    _same(bmin, want[0], "bmin")
    _same(bmax, want[1], "bmax")
    assert not any(arrived) and not bool(plan.arrived.any())
    l = w[0].shape[0]
    first, last = plan.blocks[:, 0], plan.blocks[:, 1]
    assert int(first[0]) == 0 and int(last[-1]) == l - 1
    assert torch.equal(first[1:], last[:-1] + 1)
    assert torch.equal(plan.blocks[1:, 2], plan.blocks[:-1, 3])
    ids = plan.rec[:, 0] & (tl._TOP - 1)
    assert torch.equal(ids.sort().values, torch.arange(l - 1,
                                                       dtype=torch.int32))
    # an inner child's record is one deeper than its parent's
    rec = plan.rec.long()
    by_id = torch.empty_like(rec)
    by_id[rec[:, 0] & (tl._TOP - 1)] = rec
    small = by_id[:, 0] >= 0            # (bit 31: above the treelets)
    par = topo.parent[1: l - 1].long()
    inner = small[1:] & small[par]
    assert torch.equal((by_id[1:, 1] >> 22)[inner],
                       (by_id[par, 1] >> 22)[inner] + 1)


def test_topo_state_is_made_once_and_goes_with_the_topology():
    """``topo_state``: one per topology, made at its build's refit; its
    leaf-row count is the one ``LBVHNodes`` used to compute a frame
    (same value and dtype), returned by every refit; the entry goes when
    the topology's arrays do."""
    import gc

    m = _mesh("uv_sphere")
    v = [torch.from_numpy(x) for x in tl.pad_tris(m.v0, m.v1, m.v2, 4)]
    lb, topo = tl.build_lbvh_topo(*v, width=8)
    st = tl.topo_state(topo)
    assert tl.topo_state(topo) is st and st.plan is None   # (CPU: none)
    want = (topo.row_cnt > 0).sum()
    assert st.num_leaves.dtype == want.dtype and torch.equal(st.num_leaves,
                                                             want)
    re = tl.refit_lbvh(topo, *v, width=8)
    assert lb.num_leaves is st.num_leaves and re.num_leaves is st.num_leaves
    key = id(topo.parent)
    assert key in tl._TOPO_STATE
    del topo
    gc.collect()
    assert key not in tl._TOPO_STATE


# -------------------------- the collapse's one launch (K5 B), modelled

class _Once(list):
    """An output array of the model: each word written once."""

    def __init__(self, n):
        super().__init__([None] * n)

    def put(self, i, v):
        assert self[i] is None, f"word {i} written twice"
        self[i] = int(v)


def _collapse_model(tree, l, max_leaf, width, cap, grid=3, chunk=8):
    """A model of ``csrc/lbvh_collapse.cu``'s phases over the plain tree
    ``tree`` (lchild, rchild, lo, hi): blocks own runs of ``chunk``-item
    chunks in three orders (internals, nodes, sorted positions) and sum
    the counts of the blocks before them; every output word is written
    once.  -> (the collapse's nine arrays, the plan's (rec, blocks,
    roots, gstart, arrived), the leaf-row count, the binary depth of
    every internal, the three numberings)."""
    lch, rch, lo, hi = (t.tolist() for t in tree)
    n, nodes, nb = l - 1, 2 * l - 1, -(-l // cap)
    stride = 2 if width == 4 else 3

    def size(x):
        return 1 if x >= n else hi[x] - lo[x] + 1

    def leafish(x):
        return size(x) <= max_leaf

    def small(x):
        return size(x) <= cap

    def end(c):
        return c - n if c >= n else hi[c]

    def run(b, count):      # the items of block b's chunks (past count too)
        chunks = -(-count // chunk)
        per = -(-chunks // grid)
        c0 = min(b * per, chunks)
        return [range(c * chunk, (c + 1) * chunk)
                for c in range(c0, min(c0 + per, chunks))]

    def is_max(x):
        return (x >= n or leafish(x)) and not leafish(parent[x])

    def is_lf(c):
        return c >= n or leafish(c)

    def expand(x):
        out = []
        for c in (lch[x], rch[x]):
            if is_lf(c):
                out.append(c)
            elif width == 4:
                out += [lch[c], rch[c]]
            else:
                out += expand4(c)
        return out

    def expand4(x):
        return [c for k in (lch[x], rch[x])
                for c in ([k] if is_lf(k) else [lch[k], rch[k]])]

    parent, tpar, start = _Once(nodes), _Once(nodes), _Once(l)
    surv, ch_old, arity, base = _Once(n), _Once(n * width), _Once(n), _Once(n)
    newid, row_lo, row_cnt, leaf_newid = (_Once(nodes), _Once(l), _Once(l),
                                          _Once(l))
    rec, blocks, roots = _Once(2 * n), _Once(4 * nb), _Once(2 * l)
    gstart, arrived, row_of = _Once(n), _Once(n), _Once(nodes)
    aux, root_at, wmin = [None] * n, _Once(l), _Once(nb)
    totals = [[0] * grid for _ in range(3)]

    # 1. parents, treelet parents, treelet starts, counters
    for x in range(n):
        tp = x if small(x) else -1
        for c in (lch[x], rch[x]):
            parent.put(c, x)
            tpar.put(c, tp)
        start.put(end(lch[x]) + 1, tp < 0)
        arrived.put(x, 0)
    parent.put(0, 0)
    tpar.put(0, -1)
    start.put(0, 1)

    # 2. the walks; the treelet roots' first leaves and block windows
    for x in range(n):
        p, d = x, 0
        if small(x):
            while tpar[p] >= 0:
                p, d = tpar[p], d + 1
        if not small(x) or p == x:
            p = x
            while p != 0:
                p, d = parent[p], d + 1
            aux[x] = (x, d)
        else:
            aux[x] = (p, d)
        if small(x) and tpar[x] < 0:
            root_at.put(lo[x], x)
            if lo[x] % cap == 0:
                wmin.put(lo[x] // cap, lo[x])
            m = (lo[x] // cap + 1) * cap
            if m <= hi[x]:
                wmin.put(m // cap, hi[x] + 1)
    for b in range(grid):
        for ch in run(b, nodes):
            totals[1][b] += sum(is_max(i) for i in ch if i < nodes)
        for ch in run(b, l):
            for j in ch:
                if j >= l:
                    continue
                totals[2][b] += start[j]
                if tpar[n + j] < 0:
                    root_at.put(j, n + j)
                    if j % cap == 0:
                        wmin.put(j // cap, j)

    # 3a. per internal
    depth = [0] * n
    for x in range(n):
        r, y = aux[x]
        inner = small(x) and r != x
        depth[x] = y + aux[r][1] if inner else y
        sv = not leafish(x) and depth[x] % stride == 0
        e = expand(x)
        for k in range(width):
            ch_old.put(x * width + k, e[k] if k < len(e) else -1)
        surv.put(x, sv)
        arity.put(x, len(e))
        if x == 0:
            newid.put(0, 0)
        elif not sv and not is_max(x):
            newid.put(x, -1)
        q = end(lch[x])
        if not small(x):
            rec.put(2 * q, x | tl._TOP)
            rec.put(2 * q + 1, 0)
            gstart.put(x, -1)
            continue
        root = r if inner else x
        t0 = wmin[lo[root] // cap]

        def slot(c):
            return (c - n - t0) | tl._LEAF_REF if c >= n else end(lch[c]) - t0

        rec.put(2 * q, x)
        rec.put(2 * q + 1, slot(lch[x]) | slot(rch[x]) << 11
                | (y if inner else 0) << 22)
        gstart.put(x, -1 if inner else t0)
    for b in range(grid):
        totals[0][b] = sum(arity[x] for ch in run(b, n) for x in ch
                           if x < n and surv[x])

    # 3b, 3c: the leaf rows by node, the treelets' rows by position
    n_rows, n_roots = sum(totals[1]), sum(totals[2])
    rows, ranks = [], []
    for b in range(grid):
        r = sum(totals[1][:b])
        for ch in run(b, nodes):
            for i in ch:
                m = i < nodes and is_max(i)
                if m:
                    row_lo.put(r, lo[i] if i < n else i - n)
                    row_cnt.put(r, size(i))
                    row_of.put(i, r)
                    rows.append(r)
                if n_rows <= i < l:
                    row_lo.put(i, 0)
                    row_cnt.put(i, 0)
                    leaf_newid.put(i, -1)
                if n <= i < nodes and not m:
                    newid.put(i, -1)
                r += m
        r = sum(totals[2][:b])
        for ch in run(b, l):
            for p in ch:
                st = p < l and start[p]
                if st:
                    root, t0 = root_at[p], wmin[p // cap]
                    roots.put(2 * r, root)
                    roots.put(2 * r + 1, (p - t0) | tl._LEAF_REF if root >= n
                              else end(lch[root]) - t0)
                    ranks.append(r)
                if n_roots <= p < l:
                    roots.put(2 * p, -1)
                    roots.put(2 * p + 1, -1)
                if p < l and p % cap == 0:
                    k = p // cap
                    blocks.put(4 * k, wmin[k])
                    blocks.put(4 * k + 2, r)
                    if k > 0:
                        blocks.put(4 * (k - 1) + 1, wmin[k] - 1)
                        blocks.put(4 * (k - 1) + 3, r)
                    if k == nb - 1:
                        blocks.put(4 * k + 1, l - 1)
                        blocks.put(4 * k + 3, n_roots)
                r += bool(st)

    # 4. the numbering
    bases = []
    for b in range(grid):
        off = 1 + sum(totals[0][:b])
        for ch in run(b, n):
            for x in ch:
                if x >= n:
                    continue
                base.put(x, off)
                bases.append(off)
                if surv[x]:
                    for t in range(arity[x]):
                        c = ch_old[x * width + t]
                        newid.put(c, off + t)
                        if is_lf(c):
                            leaf_newid.put(row_of[c], off + t)
                    off += arity[x]

    def i32(a, *shape):
        assert None not in a
        return torch.tensor(a, dtype=torch.int32).reshape(*shape)

    cols = (i32(surv, n).bool(), i32(ch_old, n, width), i32(arity, n),
            i32(base, n), i32(newid, nodes), i32(row_lo, l), i32(row_cnt, l),
            i32(leaf_newid, l), i32(parent, nodes))
    plan = tl.RefitPlan(rec=tl._wrap32(torch.tensor(rec).reshape(n, 2)),
                        blocks=i32(blocks, nb, 4), roots=i32(roots, l, 2),
                        gstart=i32(gstart, n), arrived=i32(arrived, n))
    return cols, plan, n_rows, depth, (bases, rows, ranks)


@pytest.mark.parametrize("dups", [False, True])
@pytest.mark.parametrize("method", ["karras", "sah"])
@pytest.mark.parametrize("l", [2, 3, 7, 33, 100, 257, 333])
def test_collapse_phases_model_the_plain_versions(method, l, dups):
    """The collapse's one launch, modelled phase by phase on Karras and
    sweep-SAH trees (3 blocks of 8-item chunks; treelets of at most 4 and
    128 leaves; widths 4 and 8, leaves of 1 and 4): every word written
    once; each block's offset plus its own scan gives ``torch.cumsum``'s
    numbering (survivor arities, leaf rows, treelet starts); the depth
    below a treelet's root plus the root's is the depth of the walk to the
    tree's root; the topology equals ``_collapse_wide_ref``'s and the plan
    ``_refit_plan``'s (CPU path) word for word."""
    tree = tuple(a.int() for a in _plain_tree(method, l, dups))
    lc, rc, lo, hi = tree
    par = tl._parents_ref(lc, rc, l).tolist()
    walk = []
    for x in range(l - 1):
        d = 0
        while x != 0:
            x, d = par[x], d + 1
        walk.append(d)
    for width, leaf in ((4, 1), (8, 4)):
        want = tl._collapse_wide_ref(*tree, l, leaf, width)
        topo = tl.LBVHTopo(torch.arange(l, dtype=torch.int32), lc, rc,
                           *want[:8], lo, hi, want[8])
        for cap in (4, 128):
            cols, plan, n_rows, depth, (bases, rows, ranks) = _collapse_model(
                tree, l, leaf, width, cap)
            for a, b in zip(cols, want):
                _same(a, b, "collapse")
            assert depth == walk
            contrib = torch.where(want[0], want[2], 0)
            assert bases == (1 + torch.cumsum(contrib, 0) - contrib).tolist()
            assert rows == list(range(int((want[6] > 0).sum())))
            assert n_rows == len(rows)
            ref = tl._refit_plan(topo, 2 * cap)
            starts = (ref.roots[:, 0] >= 0).sum()
            assert ranks == list(range(int(starts)))
            for f in ("rec", "blocks", "roots", "gstart", "arrived"):
                _same(getattr(plan, f), getattr(ref, f), f)
