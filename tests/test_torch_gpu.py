"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the 4-wide walk (K2), the 8-wide fused walk (K1), both in their
alpha-cutout and predicate modes (and every op case of the predicate
compiler, built by nvcc and run on the card, against torch on the CPU),
the per-ray walk with any-hit suspension (K3), the
chained row-fetch probe (K7), the four kernels of the on-device LBVH build
and refit (K5) and those of the on-device PLOC build and level refit (K4),
the binary TLAS+BLAS walk of the megakernel (K6, over its packed records,
on a pool past its 64-entry stack too) and the sweep-SAH tree's
kernels.

Needs a CUDA device and nvcc; skips without a card.  It imports neither
JAX nor the JAX package, so it also runs on a machine without JAX — with
``--noconftest``, since ``tests/conftest.py`` imports JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import functools

import pytest
import torch

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch.accel import lbvh, ploc
from vortex_rt_tpu_torch.models.bigscenes import blob, wavy_grid
from vortex_rt_tpu_torch.models.procedural import (
    box, cornell_box, random_soup, uv_sphere,
)
from vortex_rt_tpu_torch.ops.packet_walk import (
    kernel_call as k2_kernel_call, trace_packets_walk,
    trace_packets_walk_ref,
)
from vortex_rt_tpu_torch.ops.traverse_packet import (
    kernel_call, trace_packets, trace_packets_ref,
)
from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays
from vortex_rt_tpu_torch.runtime import kernels
from vortex_rt_tpu_torch.tools import exp_hbm_walk as hw

from tests.torch_pred_cases import OPS, grid

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scene(flatten):
    sc = pt.Scene()
    for mesh, refl in cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sc.add_instance(sc.add_mesh(uv_sphere((0, -0.3, 0), 0.35, 8, 12)))
    sc.add_instance(sc.add_mesh(box((0.45, -0.6, 0.3), 0.25)))
    return sc.build(pt.RTConfig(flatten=flatten))


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("occlusion", [False, True])
def test_kernel_matches_plain_version(cuda, flatten, occlusion):
    wa = WideArrays.from_scene(_scene(flatten)).to(cuda)
    g = torch.Generator().manual_seed(0)
    n = 5000  # not a multiple of the block size
    o = (torch.rand(n, 3, generator=g) - 0.5).to(cuda)
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g)).to(cuda)
    active = torch.arange(n, device=cuda) % 7 != 0
    t_max = torch.full((n,), 2.0, device=cuda)
    before = kernels.LAUNCHES["packet_walk"]
    k, ks = trace_packets_walk(wa, o, d, active=active, t_max=t_max,
                               occlusion=occlusion)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["packet_walk"] == before + 1
    p, ps = trace_packets_walk_ref(wa, o, d, active=active, t_max=t_max,
                                   occlusion=occlusion)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(ks, ps)
    assert bool((k.dist < 1e30).any())


def test_frame_kernel_route_matches_plain_route(cuda):
    import dataclasses

    import numpy as np

    cfg = pt.RTConfig(flatten=True, bvh_width=4)
    rk = pt.WavefrontRenderer.from_buffers(_scene(True), cfg, device=cuda)
    rp = dataclasses.replace(rk, walk=trace_packets_walk_ref)
    cam = pt.Camera.look_at([0.05, 0.02, -3.2], [0, -0.05, 0], [0, 1, 0],
                            45.0, 1.0)
    p = pt.RenderParams(light_pos=(0, 0.8, -0.5), shadow=True, spp=2)
    img_k, rays_k = rk.render(cam, p, 48, 32)
    img_p, rays_p = rp.render(cam, p, 48, 32)
    assert rays_k == rays_p
    np.testing.assert_allclose(img_k, img_p, atol=1e-5)


def _rays(cuda, n=5000):
    g = torch.Generator().manual_seed(0)
    o = (torch.rand(n, 3, generator=g) - 0.5).to(cuda)
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g)).to(cuda)
    return o, d


@pytest.mark.parametrize("mode", ["closest", "occlusion", "occl_split"])
def test_k1_kernel_matches_plain_version(cuda, mode):
    wa = WideArrays.from_scene(_scene(True), 8).fuse().to(cuda)
    o, d = _rays(cuda)  # 5000: not a multiple of the block size
    n = o.shape[0]
    kw = dict(active=torch.arange(n, device=cuda) % 7 != 0,
              t_max=torch.full((n,), 2.0, device=cuda))
    if mode == "occlusion":
        kw["occlusion"] = True
    elif mode == "occl_split":
        kw["occl_split"] = n // 3
    before = kernels.LAUNCHES["traverse_packet"]
    k, ks = trace_packets(wa, o, d, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["traverse_packet"] == before + 1
    p, ps = trace_packets_ref(wa, o, d, **kw)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(ks, ps)
    assert bool((k.dist < 1e30).any())


@pytest.fixture(scope="module")
def deep_build():
    """blob(n=160): 51,200 triangles, an 8-wide tree of depth 9 (the
    scale scene's depth, where the walk's stack runs deepest)."""
    sc = pt.Scene()
    sc.add_instance(sc.add_mesh(blob(n=160)))
    return sc.build(pt.RTConfig(flatten=True))


def _deep_rays(cuda, n):
    """Rays from a shell of radius 3 towards random points near the
    blob's centre (most hit), with a third of the lanes inactive."""
    g = torch.Generator().manual_seed(n)
    o = torch.nn.functional.normalize(torch.randn(n, 3, generator=g)) * 3.0
    target = (torch.rand(n, 3, generator=g) - 0.5) * 1.2
    d = torch.nn.functional.normalize(target - o)
    t_max = 1.5 + 3.0 * torch.rand(n, generator=g)
    active = torch.arange(n) % 3 != 1
    return o.to(cuda), d.to(cuda), active.to(cuda), t_max.to(cuda)


@pytest.mark.parametrize("count", ["1", "31", "33", "many_blocks"])
@pytest.mark.parametrize("mode", ["closest", "occlusion", "occl_split"])
def test_k1_deep_tree_matches_plain_version(cuda, deep_build, count, mode):
    """K1 gives the plain version's hits and per-ray steps on a depth-9
    tree, for ray counts below and past a warp and past what the card
    holds at once (4,225 blocks of 128: four times 132 SMs x 8 blocks,
    and one more)."""
    wa = WideArrays.from_scene(deep_build, 8).fuse().to(cuda)
    assert wa.depth >= 9
    n = 4 * 132 * 8 * 128 + 17 if count == "many_blocks" else int(count)
    o, d, active, t_max = _deep_rays(cuda, n)
    kw = dict(active=active)
    if mode == "occlusion":
        kw.update(t_max=t_max, occlusion=True)
    elif mode == "occl_split":
        split = max(n // 3, 1)
        split += split % 32 == 0  # not a multiple of 32
        kw.update(t_max=torch.where(torch.arange(n, device=cuda) < split,
                                    t_max, torch.full_like(t_max, 1e30)),
                  occl_split=split)
    before = kernels.LAUNCHES["traverse_packet"]
    k, ks = trace_packets(wa, o, d, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["traverse_packet"] == before + 1
    p, ps = trace_packets_ref(wa, o, d, **kw)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(ks, ps)
    if n > 1:
        assert bool((p.dist < 1e30).any())


def test_k1_rejects_a_tree_deeper_than_its_stack(cuda, deep_build):
    """The shared-memory stack holds 48 entries (48 KB a block): a tree
    that needs more raises before any launch."""
    import dataclasses

    wa = WideArrays.from_scene(deep_build, 8).fuse().to(cuda)
    o, d, _, _ = _deep_rays(cuda, 64)
    trace_packets(dataclasses.replace(wa, depth=44), o, d)
    before = kernels.LAUNCHES["traverse_packet"]
    with pytest.raises(ValueError, match="stack entries"):
        trace_packets(dataclasses.replace(wa, depth=45), o, d)
    assert kernels.LAUNCHES["traverse_packet"] == before


def test_k1_kernel_call_relaunches(cuda, deep_build):
    """The bare launch writes every output on each call: a second launch
    into the same (overwritten) outputs gives the first one's results."""
    wa = WideArrays.from_scene(deep_build, 8).fuse().to(cuda)
    o, d, active, _ = _deep_rays(cuda, 4097)
    call = kernel_call(wa, o, d, active=active)
    hits, steps = call()
    first = [x.clone() for x in (*hits, steps)]
    for x in (*hits, steps):
        x.fill_(-7)
    hits, steps = call()
    torch.cuda.synchronize()
    for a, b in zip((*hits, steps), first):
        assert torch.equal(a, b)


def test_k1_frame_matches_plain_route(cuda):
    import dataclasses

    import numpy as np

    cfg = pt.RTConfig(flatten=True)
    rk = pt.WavefrontRenderer.from_buffers(_scene(True), cfg, device=cuda)
    assert rk.walk is trace_packets
    rp = dataclasses.replace(rk, walk=trace_packets_ref)
    cam = pt.Camera.look_at([0.05, 0.02, -3.2], [0, -0.05, 0], [0, 1, 0],
                            45.0, 1.0)
    p = pt.RenderParams(light_pos=(0, 0.8, -0.5), shadow=True, spp=2,
                        max_depth=3)
    before = kernels.LAUNCHES["traverse_packet"]
    img_k, rays_k = rk.render(cam, p, 48, 32)
    assert kernels.LAUNCHES["traverse_packet"] == before + 5 * p.spp
    img_p, rays_p = rp.render(cam, p, 48, 32)
    assert rays_k == rays_p
    np.testing.assert_allclose(img_k, img_p, atol=1e-5)


@pytest.mark.parametrize("shadow", [False, True])
def test_pathtraced_frame_matches_plain_route(cuda, shadow):
    """A 64x64 path-traced frame at depth 3 (mirror sphere, diffuse
    bounces, Russian roulette): the K1 route and the plain route run the
    same shading on the same device, so ray counts are equal and images
    agree to 1e-5."""
    import dataclasses

    import numpy as np

    sc = pt.Scene()
    for mesh, refl in cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sc.add_instance(sc.add_mesh(uv_sphere((0, -0.3, 0), 0.35, 8, 12)),
                    reflectivity=0.5)
    sc.add_instance(sc.add_mesh(box((0.45, -0.6, 0.3), 0.25)))
    cfg = pt.RTConfig(flatten=True)
    rk = pt.WavefrontRenderer.from_buffers(sc.build(cfg), cfg, device=cuda)
    rp = dataclasses.replace(rk, walk=trace_packets_ref)
    cam = pt.Camera.look_at([0.05, 0.02, -3.2], [0, -0.05, 0], [0, 1, 0],
                            45.0, 1.0)
    p = pt.RenderParams(light_pos=(0, 0.8, -0.5), shadow=shadow, spp=2,
                        max_depth=3, pathtrace=True)
    before = kernels.LAUNCHES["traverse_packet"]
    img_k, rays_k = rk.render(cam, p, 64, 64)
    assert kernels.LAUNCHES["traverse_packet"] == before + (
        5 if shadow else 3) * p.spp
    img_p, rays_p = rp.render(cam, p, 64, 64)
    assert rays_k == rays_p and rays_k > 2 * 64 * 64 * p.spp
    assert np.isfinite(img_k).all()
    np.testing.assert_allclose(img_k, img_p, atol=1e-5)
    acc_k, arays_k = rk.render_accum(cam, p, 64, 64, n_passes=2)
    acc_p, arays_p = rp.render_accum(cam, p, 64, 64, n_passes=2)
    assert arays_k == arays_p
    np.testing.assert_allclose(acc_k, acc_p, atol=1e-5)


def test_k2_kernel_call_relaunches(cuda):
    """K2's bare launch writes every output on each call."""
    wa = WideArrays.from_scene(_scene(True)).to(cuda)
    o, d = _rays(cuda, 4097)
    call = k2_kernel_call(wa, o, d, active=torch.arange(4097, device=cuda)
                          % 5 != 0)
    before = kernels.LAUNCHES["packet_walk"]
    hits, steps = call()
    first = [x.clone() for x in (*hits, steps)]
    for x in (*hits, steps):
        x.fill_(-7)
    hits, steps = call()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["packet_walk"] == before + 2
    for a, b in zip((*hits, steps), first):
        assert torch.equal(a, b)
    ref, ref_steps = trace_packets_walk_ref(
        wa, o, d, active=torch.arange(4097, device=cuda) % 5 != 0)
    for a, b in zip((*hits, steps), (*ref, ref_steps)):
        assert torch.equal(a, b)


def test_k2_at_its_stack_cap(cuda):
    """K2's shared-memory stack holds 48 packed entries (48 KB a block):
    a TLAS tree taken at depth 44 walks as the plain version does; one
    level more raises before any launch."""
    wa = WideArrays.from_scene(_scene(False)).to(cuda)
    o, d = _rays(cuda, 4097)
    at_cap = dataclasses.replace(wa, depth=44)
    k, ks = trace_packets_walk(at_cap, o, d)
    torch.cuda.synchronize()
    p, ps = trace_packets_walk_ref(at_cap, o, d)
    for a, b in zip((*k, ks), (*p, ps)):
        assert torch.equal(a, b)
    before = kernels.LAUNCHES["packet_walk"]
    with pytest.raises(ValueError, match="stack entries"):
        trace_packets_walk(dataclasses.replace(wa, depth=45), o, d)
    assert kernels.LAUNCHES["packet_walk"] == before


@pytest.mark.parametrize("occlusion", [False, True])
def test_k2_tlas_instance_descents(cuda, occlusion):
    """K2 on a TLAS build of translated, rotated and scaled instances
    (two of them the same sphere under one transform) against the plain
    version, 135,185 rays (past what the card holds at once), a fifth
    inactive and a quarter at t_max = LARGE_FLOAT, the largest a walk
    takes: hits and per-ray steps equal."""
    wa = WideArrays.from_scene(_instances_scene(), width=4).to(cuda)
    assert wa.num_tlas > 0 and wa.width == 4
    n = 132 * 8 * 128 + 17
    g = torch.Generator().manual_seed(6)
    o = ((torch.rand(n, 3, generator=g) - 0.5) * 12).to(cuda)
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g)).to(cuda)
    lane = torch.arange(n, device=cuda)
    t_max = torch.where(lane % 4 == 0, torch.full((n,), 1e30, device=cuda),
                        torch.full((n,), 9.0, device=cuda))
    kw = dict(active=lane % 5 != 2, t_max=t_max, occlusion=occlusion)
    k, ks = trace_packets_walk(wa, o, d, **kw)
    torch.cuda.synchronize()
    p, ps = trace_packets_walk_ref(wa, o, d, **kw)
    for a, b in zip((*k, ks), (*p, ps)):
        assert torch.equal(a, b)
    assert bool((p.dist < 1e30).any()) and int(ps.max()) > 4


@pytest.mark.parametrize("k", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("words", [4, 24, 128])
def test_k7_kernel_matches_plain_version(cuda, k, words):
    tab = hw.make_table(4096, cuda)
    before = kernels.LAUNCHES["hbm_walk"]
    got = hw.run_walks(tab, 300, k, words)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hbm_walk"] == before + 1
    assert torch.equal(got, hw.run_walks_ref(tab, 300, k, words))



# ---- K5: the on-device LBVH build and refit, kernel by kernel

def _lbvh_mesh(name):
    import numpy as np

    if name == "uv_sphere":
        return uv_sphere((0, 0, 0), 1.0, 16, 32)
    if name == "random_soup":
        return random_soup(np.random.default_rng(5), 2000)
    return wavy_grid(n=100)   # 19,602 triangles


def _words(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, want):
    got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(_words(a), _words(b))


@pytest.mark.parametrize("width,leaf", [(4, 4), (8, 4), (8, 8), (4, 8)])
@pytest.mark.parametrize("mesh", ["uv_sphere", "random_soup", "wavy_grid"])
def test_lbvh_kernels_match_plain_versions(cuda, mesh, width, leaf):
    """Box + Morton + Karras (A), collapse (B), bottom-up boxes (C) and
    pack (D, full and compact pools, flat and TLAS) on the card: every
    integer field and every output word equals the plain version's."""
    m = _lbvh_mesh(mesh)
    v0, v1, v2 = (torch.from_numpy(v).to(cuda)
                  for v in lbvh.pad_tris(m.v0, m.v1, m.v2, leaf))
    l = v0.shape[0]
    before = dict(kernels.LAUNCHES)
    codes, smin, smax = lbvh.scene_codes(v0, v1, v2)
    _assert_same((codes, smin, smax), lbvh.scene_codes_ref(v0, v1, v2))
    lcodes, order = torch.sort(codes, stable=True)
    tree = lbvh._karras(lcodes, l)
    _assert_same(tree, lbvh._karras_ref(lcodes, l))
    # box and codes, Karras
    assert kernels.LAUNCHES["lbvh_karras"] == before["lbvh_karras"] + 2
    made = []
    col = lbvh._collapse_wide(*tree, l, leaf, width, state=made)
    _assert_same(col, lbvh._collapse_wide_ref(*tree, l, leaf, width))
    # one launch, the refit plan made in it
    assert kernels.LAUNCHES["lbvh_collapse"] == before["lbvh_collapse"] + 1
    surv, ch_old, arity, base, newid, row_lo, row_cnt, leaf_newid, par = col
    topo = lbvh.LBVHTopo(
        order=order.to(torch.int32), lchild=tree[0], rchild=tree[1],
        surv=surv, ch_old=ch_old, arity=arity, base=base, newid=newid,
        row_lo=row_lo, row_cnt=row_cnt, leaf_newid=leaf_newid, lo=tree[2],
        hi=tree[3], parent=par)
    assert lbvh.topo_state(topo, made[0]) is made[0]
    boxes = lbvh._refit_boxes(topo, v0, v1, v2)
    _assert_same(boxes, lbvh._refit_boxes_ref(topo, v0, v1, v2))
    # the topology's first refit: the climb alone, over the collapse's plan
    assert kernels.LAUNCHES["lbvh_refit"] == before["lbvh_refit"] + 1
    assert not bool(lbvh.topo_state(topo).plan.arrived.any())
    pool_rows, leaf_rows, surv_idx = lbvh.compact_plan(topo)
    n = 0
    for kw in (dict(), dict(pool_rows=pool_rows, leaf_rows=leaf_rows,
                            surv_idx=surv_idx)):
        for tlas in ((False, True) if width == 4 else (False,)):
            kw2 = dict(kw, leaf_size=leaf, width=width, tlas=tlas,
                       fused=not tlas)
            got = lbvh._pack_rows(topo, *boxes, v0, v1, v2, **kw2)
            n += 2   # pack_nodes, pack_leaves
            _assert_same(got, lbvh._pack_rows_ref(topo, *boxes, v0, v1, v2,
                                                  **kw2))
            # a second launch gives the same words
            _assert_same(lbvh._pack_rows(topo, *boxes, v0, v1, v2, **kw2),
                         got)
            n += 2
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lbvh_pack"] == before["lbvh_pack"] + n


@pytest.mark.parametrize("width", [4, 8])
def test_lbvh_build_and_refit_walk_like_the_plain_build(cuda, width):
    """``build_lbvh_topo`` and a compact ``refit_lbvh`` of moved vertices
    on the card against the same calls on the CPU (plain versions): the
    same tables; the walk over them finds the CPU walk's hits."""
    m = _lbvh_mesh("random_soup")
    host = [torch.from_numpy(v) for v in lbvh.pad_tris(m.v0, m.v1, m.v2, 4)]
    dev = [v.to(cuda) for v in host]
    lb_d, topo_d = lbvh.build_lbvh_topo(*dev, leaf_size=4, width=width)
    lb_h, topo_h = lbvh.build_lbvh_topo(*host, leaf_size=4, width=width)
    for a, b in zip(topo_d, topo_h):
        assert torch.equal(a.cpu(), b)
    plan_d, plan_h = lbvh.compact_plan(topo_d), lbvh.compact_plan(topo_h)
    assert plan_d[:2] == plan_h[:2] and torch.equal(plan_d[2].cpu(), plan_h[2])
    moved_h = [v + 0.25 * torch.sin(v.flip(1)) for v in host]
    moved_d = [v.to(cuda) for v in moved_h]
    for lb_a, lb_b in ((lb_d, lb_h), (
            lbvh.refit_lbvh(topo_d, *moved_d, width=width,
                            pool_rows=plan_d[0], leaf_rows=plan_d[1],
                            surv_idx=plan_d[2]),
            lbvh.refit_lbvh(topo_h, *moved_h, width=width,
                            pool_rows=plan_h[0], leaf_rows=plan_h[1],
                            surv_idx=plan_h[2]))):
        assert (lb_a.fused is None) == (width == 4)
        for name in ("nodes", "tri_rows") + (("fused",) if width == 8 else ()):
            assert torch.equal(_words(getattr(lb_a, name)).cpu(),
                               _words(getattr(lb_b, name))), name
    wa_d = lbvh.wide_arrays_from_lbvh(lb_d, 4, width=width)
    wa_h = lbvh.wide_arrays_from_lbvh(lb_h, 4, width=width)
    g = torch.Generator().manual_seed(1)
    o = (torch.rand(3001, 3, generator=g) - 0.5) * 28.0
    d = torch.nn.functional.normalize(torch.randn(3001, 3, generator=g))
    walk = trace_packets if width == 8 else trace_packets_walk
    k, _ = walk(wa_d, o.to(cuda), d.to(cuda))
    p, _ = walk(wa_h, o, d)
    assert bool((p.dist < 1e30).any())
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b)


def test_lbvh_refit_copies_nothing_to_the_host(cuda):
    """A compact refit makes no device-to-host copy: it runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    m = _lbvh_mesh("uv_sphere")
    v = [torch.from_numpy(x).to(cuda) for x in lbvh.pad_tris(m.v0, m.v1,
                                                             m.v2, 4)]
    _, topo = lbvh.build_lbvh_topo(*v, width=8)
    pool_rows, leaf_rows, surv_idx = lbvh.compact_plan(topo)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lb = lbvh.refit_lbvh(topo, *v, width=8, pool_rows=pool_rows,
                             leaf_rows=leaf_rows, surv_idx=surv_idx)
        wa = lbvh.wide_arrays_from_lbvh(lb, 4, width=8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert wa.fused.shape == (pool_rows, 32 + 64)


# ---- K4: the on-device PLOC build and level refit, kernel by kernel

def chain_records(l, n, device="cpu"):
    """The merge's records (lk, rk, lvl, bmn, bmx, n_int) of a chain: ``n``
    internals over leaf rows 0..n, internal k joining internal k-1 (leaf
    rows 0 and 1 for k = 0) and leaf row k+1, so the last created, the
    root, sits n-1 levels above the first; rows n+1.. are dead.  Boxes
    from a seeded NumPy generator."""
    import numpy as np

    k = torch.arange(l - 1, dtype=torch.int32)
    lk = torch.where(k == 0, l - 1, -k)
    rk = l - 1 + k + 1
    live = k < n
    box = torch.from_numpy(np.random.default_rng(n).uniform(
        -1, 1, (l - 1, 3)).astype(np.float32))
    rec = (torch.where(live, lk, 0), torch.where(live, rk, 0),
           torch.where(live, k, 0), box - 1, box + 1,
           torch.tensor(n, dtype=torch.int32))
    return tuple(a.to(device).contiguous() for a in rec)


def _ploc_stages(v, leaf, width, radius=16):
    """Each K4 kernel against its plain version on the card, stage by
    stage, every output word equal; returns the build's topology."""
    v0, v1, v2 = v
    l = v0.shape[0]
    before = dict(kernels.LAUNCHES)
    order, cmin0, cmax0, tids0 = ploc.seed_clusters(v0, v1, v2, leaf)
    live = []
    merged = ploc._ploc_merge(cmin0, cmax0, tids0, l, l, leaf, radius, live)
    _assert_same(merged, ploc._ploc_merge_ref(cmin0, cmax0, tids0, l, l,
                                              leaf, radius))
    # each round's live count, then the last
    assert int(merged[-1]) == len(live) - 1 > 0 and live[-1] == 1
    # the cooperative grid when the first round is above the tail, then
    # the tail block: at most two launches a loop, whatever its rounds
    assert kernels.LAUNCHES["ploc_merge"] == (
        before["ploc_merge"] + 1 + (l > ploc.tail_size(leaf)))
    lk, rk, lvl, bmn, bmx, row_tids, row_cnt, n_int, _ = merged
    _assert_same(ploc._remap_collapse_ploc(lk, rk, lvl, bmn, bmx, n_int, l,
                                           width),
                 _remap_collapse_ref(lk, rk, lvl, bmn, bmx, n_int, l, width))
    # the remap and the collapse: one cooperative launch
    assert kernels.LAUNCHES["ploc_collapse"] == before["ploc_collapse"] + 1
    _assert_same(ploc._row_boxes(v0, v1, v2, order, row_tids, row_cnt),
                 ploc._row_boxes_ref(v0, v1, v2, order, row_tids, row_cnt))
    assert kernels.LAUNCHES["ploc_refit"] == before["ploc_refit"] + 1
    return ploc.build_ploc_topo(*v, leaf_size=leaf, width=width,
                                radius=radius)


def _remap_collapse_ref(lk, rk, lvl, bmn, bmx, n_int, l, width):
    """The plain remap, then the plain collapse: the one-launch K4b's
    plain version."""
    rm = ploc._remap_ploc_ref(lk, rk, lvl, bmn, bmx, n_int, l)
    return (*rm, *ploc._collapse_ploc_ref(rm[0], rm[1], rm[5], n_int, l,
                                          width))


def _merge_mesh(name):
    """Meshes for the merge: ``identical`` is 5,000 copies of one triangle
    (every cost ties: one mutual pair a round until round 128, then the
    even/odd fallback); ``wavy_grid`` has more clusters than the tail
    holds at every leaf size, ``uv_sphere`` fewer."""
    import numpy as np

    if name == "identical":
        v0 = np.zeros((5000, 3), np.float32)
        v1, v2 = v0.copy(), v0.copy()
        v1[:, 0], v2[:, 1] = 1.0, 1.0
        return v0, v1, v2
    m = _lbvh_mesh(name)
    return m.v0, m.v1, m.v2


@pytest.mark.parametrize("mesh,radius,leaf", [
    ("uv_sphere", 16, 4), ("uv_sphere", 1, 1), ("random_soup", 16, 8),
    ("wavy_grid", 16, 4), ("wavy_grid", 1, 8), ("wavy_grid", 16, 1),
    ("identical", 16, 4), ("identical", 1, 8)])
def test_ploc_merge_matches_plain_version(cuda, mesh, radius, leaf):
    """K4a, the whole merge loop on the card, against ``_ploc_merge_ref``
    word for word in all nine outputs and in ``live``: with the tail
    alone (the first round at or below T), with both phases, and with
    the grid phase alone down to one cluster (``tail`` 2); one or two
    launches a loop."""
    v0, v1, v2 = (torch.from_numpy(x).to(cuda)
                  for x in lbvh.pad_tris(*_merge_mesh(mesh), leaf))
    l = v0.shape[0]
    t = ploc.tail_size(leaf)
    assert (l > t) == (mesh in ("wavy_grid", "identical"))
    _, cmin0, cmax0, tids0 = ploc.seed_clusters(v0, v1, v2, leaf)
    live_ref = []
    want = ploc._ploc_merge_ref(cmin0, cmax0, tids0, l, l, leaf, radius,
                                live_ref)
    if mesh == "identical":
        assert int(want[8]) > 128   # the fallback's rounds ran
    before = kernels.LAUNCHES["ploc_merge"]
    live = []
    got = ploc._ploc_merge(cmin0, cmax0, tids0, l, l, leaf, radius, live)
    _assert_same(got, want)
    assert live == live_ref
    assert kernels.LAUNCHES["ploc_merge"] == before + 1 + (l > t)
    out, state = ploc._merge_on_card(cmin0, cmax0, tids0, l, l, leaf, radius,
                                     2)
    _assert_same(out, want[:7])
    assert ploc.decode_round_log(state.tolist()) == live_ref


def test_ploc_merge_reads_nothing_back(cuda):
    """Without ``live`` the merge loop makes no copy to the host: it runs
    under ``torch.cuda.set_sync_debug_mode("error")``."""
    v = [torch.from_numpy(x).to(cuda)
         for x in lbvh.pad_tris(*_merge_mesh("wavy_grid"), 4)]
    l = v[0].shape[0]
    _, cmin0, cmax0, tids0 = ploc.seed_clusters(*v, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ploc._ploc_merge(cmin0, cmax0, tids0, l, l, 4, 16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_same(got, ploc._ploc_merge_ref(cmin0, cmax0, tids0, l, l, 4, 16))


def _poisoned(monkeypatch, call):
    """``call()`` with every ``torch.empty`` block it takes full of 0xFF
    bytes, so a word the kernels leave unwritten reads -1 and fails the
    comparison; ``torch.zeros``, ``torch.full``, ``torch.cumsum`` and
    ``torch.searchsorted`` raise (no fill, no prefix sum or search around
    the kernels)."""
    empty = torch.empty

    def poisoned(*args, **kwargs):
        t = empty(*args, **kwargs)
        t.reshape(-1).view(torch.uint8).fill_(255)
        return t

    def refused(*args, **kwargs):
        raise AssertionError("a fill or a prefix sum around the kernels")

    with monkeypatch.context() as mp:
        mp.setattr(torch, "empty", poisoned)
        mp.setattr(torch, "zeros", refused)
        mp.setattr(torch, "full", refused)
        mp.setattr(torch, "cumsum", refused)
        mp.setattr(torch, "searchsorted", refused)
        return call()


@pytest.mark.parametrize("width,leaf", [(4, 4), (8, 4), (8, 8), (4, 8)])
@pytest.mark.parametrize("mesh", ["random_soup", "wavy_grid"])
def test_pack_writes_every_word(cuda, monkeypatch, mesh, width, leaf):
    """``_pack_rows`` allocates its outputs unfilled and writes every
    word: into memory poisoned with 0xFF words it equals
    ``_pack_rows_ref`` word for word, with full and compact pools, flat
    and TLAS layouts (width 4), and from explicit leaf ids (PLOC, full
    pools)."""
    m = _lbvh_mesh(mesh)
    v = [torch.from_numpy(x).to(cuda)
         for x in lbvh.pad_tris(m.v0, m.v1, m.v2, leaf)]
    moved = [x + 0.25 * torch.sin(x.flip(1)) for x in v]
    _, topo = lbvh.build_lbvh_topo(*v, leaf_size=leaf, width=width)
    boxes = lbvh._refit_boxes(topo, *moved)
    pool_rows, leaf_rows, surv_idx = lbvh.compact_plan(topo)
    cases = []
    for kw in (dict(), dict(pool_rows=pool_rows, leaf_rows=leaf_rows,
                            surv_idx=surv_idx)):
        for tlas in ((False, True) if width == 4 else (False,)):
            cases.append((topo, boxes, dict(kw, tlas=tlas, fused=not tlas)))
    _, pt_ = ploc.build_ploc_topo(*v, leaf_size=leaf, width=width)
    cases.append((pt_.topo, ploc._refit_boxes_ploc(pt_, *moved),
                  dict(fused=width == 8, leaf_tids=pt_.leaf_tids)))
    for tp_, bx, kw in cases:
        kw = dict(kw, leaf_size=leaf, width=width)
        got = _poisoned(monkeypatch,
                        lambda: lbvh._pack_rows(tp_, *bx, *moved, **kw))
        _assert_same(got, lbvh._pack_rows_ref(tp_, *bx, *moved, **kw))


@pytest.mark.parametrize("width,leaf,radius", [(4, 4, 16), (8, 4, 16),
                                               (8, 8, 16), (8, 4, 8)])
@pytest.mark.parametrize("mesh", ["uv_sphere", "random_soup", "wavy_grid"])
def test_ploc_kernels_match_plain_versions(cuda, mesh, width, leaf, radius):
    """The merge rounds (K4a), the remap and collapse (K4b), the row boxes
    and the refit climb (K4c) and the pack from explicit leaf ids (K4d)
    on the card: every output word equals the plain version's, a second
    launch gives the same words, and the refit at the build's vertices
    gives the build's tables."""
    m = _lbvh_mesh(mesh)
    v = [torch.from_numpy(x).to(cuda)
         for x in lbvh.pad_tris(m.v0, m.v1, m.v2, leaf)]
    lb, pt_ = _ploc_stages(v, leaf, width, radius)
    moved = [x + 0.25 * torch.sin(x.flip(1)) for x in v]
    before = dict(kernels.LAUNCHES)
    boxes = ploc._refit_boxes_ploc(pt_, *moved)
    _assert_same(boxes, ploc._refit_boxes_ploc_ref(pt_, *moved))
    _assert_same(ploc._refit_boxes_ploc(pt_, *moved), boxes)
    assert kernels.LAUNCHES["ploc_refit"] == before["ploc_refit"] + 2
    kw = dict(leaf_size=leaf, width=width, fused=width == 8,
              leaf_tids=pt_.leaf_tids)
    got = lbvh._pack_rows(pt_.topo, *boxes, *moved, **kw)
    _assert_same(got, lbvh._pack_rows_ref(pt_.topo, *boxes, *moved, **kw))
    _assert_same(lbvh._pack_rows(pt_.topo, *boxes, *moved, **kw), got)
    # survivor records and leaf rows, twice
    assert kernels.LAUNCHES["ploc_pack"] == before["ploc_pack"] + 4
    assert kernels.LAUNCHES["lbvh_pack"] == before["lbvh_pack"]
    re0 = ploc.refit_ploc(pt_, *v, leaf_size=leaf, width=width)
    for name in ("nodes", "tri_rows", "fused"):
        a, b = getattr(re0, name), getattr(lb, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(_words(a), _words(b)), name


@pytest.mark.parametrize("width", [4, 8])
def test_ploc_build_walks_like_the_plain_build(cuda, width):
    """``build_ploc_topo`` on the card against the same call on the CPU:
    every topology field and table word equal; the walk over the card's
    tree finds the CPU walk's hits."""
    m = _lbvh_mesh("random_soup")
    host = [torch.from_numpy(v) for v in lbvh.pad_tris(m.v0, m.v1, m.v2, 4)]
    dev = [v.to(cuda) for v in host]
    lb_d, pt_d = ploc.build_ploc_topo(*dev, leaf_size=4, width=width)
    lb_h, pt_h = ploc.build_ploc_topo(*host, leaf_size=4, width=width)
    for a, b in zip((*pt_d.topo, *pt_d[1:]), (*pt_h.topo, *pt_h[1:])):
        assert torch.equal(a.cpu(), b)
    for name in ("nodes", "tri_rows") + (("fused",) if width == 8 else ()):
        assert torch.equal(_words(getattr(lb_d, name)).cpu(),
                           _words(getattr(lb_h, name))), name
    wa_d = ploc.wide_arrays_from_ploc(lb_d, pt_d, 4, width)
    wa_h = ploc.wide_arrays_from_ploc(lb_h, pt_h, 4, width)
    assert wa_d.depth == wa_h.depth
    g = torch.Generator().manual_seed(1)
    o = (torch.rand(3001, 3, generator=g) - 0.5) * 28.0
    d = torch.nn.functional.normalize(torch.randn(3001, 3, generator=g))
    walk = trace_packets if width == 8 else trace_packets_walk
    k, _ = walk(wa_d, o.to(cuda), d.to(cuda))
    p, _ = walk(wa_h, o, d)
    assert bool((p.dist < 1e30).any())
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("width,leaf,radius", [
    (4, 1, 16), (8, 4, 16), (8, 8, 1), (4, 8, 1), (8, 1, 1), (4, 4, 16)])
def test_ploc_remap_collapse_writes_every_word(cuda, monkeypatch, width,
                                               leaf, radius):
    """The one-launch K4b into memory poisoned with 0xFF words, no fill
    and no prefix sum around it: every output equals the plain remap and
    collapse word for word, on the merge's records of the grid (at leaf
    4 and 8 many internals are dead: n_int < l-1); one launch."""
    v = [torch.from_numpy(x).to(cuda)
         for x in lbvh.pad_tris(*_merge_mesh("wavy_grid"), leaf)]
    l = v[0].shape[0]
    _, cmin0, cmax0, tids0 = ploc.seed_clusters(*v, leaf)
    rec = ploc._ploc_merge(cmin0, cmax0, tids0, l, l, leaf, radius)
    lk, rk, lvl, bmn, bmx, _, _, n_int, _ = rec
    assert (int(n_int) < l - 1) == (leaf > 1)
    before = kernels.LAUNCHES["ploc_collapse"]
    got = _poisoned(monkeypatch, lambda: ploc._remap_collapse_ploc(
        lk, rk, lvl, bmn, bmx, n_int, l, width))
    assert kernels.LAUNCHES["ploc_collapse"] == before + 1
    _assert_same(got, _remap_collapse_ref(lk, rk, lvl, bmn, bmx, n_int, l,
                                          width))


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("l,n", [(300, 297), (300_000, 299_998)])
def test_ploc_remap_collapse_of_a_deep_chain(cuda, monkeypatch, l, n, width):
    """The one-launch K4b on a chain deeper than the JAX propagation's
    256 rounds (``chain_records``), into poisoned memory: the depth is
    DEPTH_CAP + 1 and every word but ``newid`` equals the plain
    version's.  Past the cap the unreached internals count as depth 0 and
    all survive, so a node may be the wide child of two survivors, and
    which of the two ids lands depends on the order of the writes (in the
    JAX scatter as here): every claimed node holds one of its claims,
    every other node -1, the root 0.  At 300,000 leaf rows the grid's
    blocks own more than one chunk of nodes each."""
    rec = chain_records(l, n, cuda)
    got = _poisoned(monkeypatch,
                    lambda: ploc._remap_collapse_ploc(*rec, l, width))
    want = _remap_collapse_ref(*rec, l, width)
    assert int(got[-1]) == ploc.DEPTH_CAP + 1
    _assert_same(got[:10] + got[11:], want[:10] + want[11:])
    surv, ch_old, base, newid = got[6], got[7].long(), got[9], got[10]
    idx = ch_old[surv]
    val = base[surv][:, None] + torch.arange(width, device=cuda)
    ok = idx >= 0
    idx, val = idx[ok], val[ok]
    claimed = torch.zeros_like(newid, dtype=torch.bool)
    claimed[idx] = True
    assert int(claimed.sum()) < idx.numel()   # some nodes claimed twice
    held = torch.zeros_like(newid, dtype=torch.bool)
    held[idx[newid[idx] == val]] = True
    assert torch.equal(held, claimed)
    assert int(newid[0]) == 0 and bool((newid[1:][~claimed[1:]] == -1).all())


def _refit_case(case):
    """Vertices on the CPU for the refit's checks: random triangles just
    below, at and just above one block of 256 sorted leaves and at many
    blocks; 200 copies each of 31 triangles (most Morton codes repeat);
    config 5's 999,700-triangle grid."""
    import numpy as np

    if case == "config5":
        m = wavy_grid(n=708)
        return [torch.from_numpy(x) for x in lbvh.pad_tris(m.v0, m.v1,
                                                           m.v2, 4)]
    rng = np.random.default_rng(7)
    if case == "duplicates":
        tri = rng.uniform(-5, 5, (3, 31, 3)).astype(np.float32)
        return [torch.from_numpy(np.tile(t, (200, 1))) for t in tri]
    c = rng.uniform(-20, 20, (case, 3)).astype(np.float32)
    return [torch.from_numpy(c + rng.normal(size=(case, 3)).astype(
        np.float32)) for _ in range(3)]


@pytest.mark.parametrize("method", ["karras", "sah"])
@pytest.mark.parametrize("case", [255, 256, 257, 5000, 20_481,
                                  "duplicates", "config5"])
def test_refit_tiles_match_plain_version(cuda, case, method):
    """K5 C, the blocks of treelets and the climbs above them, against
    ``_refit_boxes_ref`` (the sparse-table range refit) word for word on
    Karras and sweep-SAH trees, at the build's vertices and at moved ones,
    one launch each; its counters are all zero after every call, and a
    relaunch after other allocations gives the same words (the launch
    names its own buffers).  The plan's records and depths, made with the
    build's refit, equal their plain version's (``_refit_records_ref``);
    its blocks partition the leaves, at most a tile each."""
    tile = kernels.load("lbvh_refit").lib.vrt_lbvh_refit_tile()
    v = [x.to(cuda) for x in _refit_case(case)]
    _, topo = lbvh.build_lbvh_topo(*v, method=method, width=8)
    st = lbvh.topo_state(topo)
    plan = st.plan
    _assert_same(plan.rec, lbvh._refit_records_ref(topo, tile // 2,
                                                   plan.gstart))
    first, last = plan.blocks[:, 0], plan.blocks[:, 1]
    assert int(first[0]) == 0 and int(last[-1]) == v[0].shape[0] - 1
    assert torch.equal(first[1:], last[:-1] + 1)
    assert int((last - first).max()) < tile
    moved = [x + 0.25 * torch.sin(x.flip(1)) for x in v]
    for verts in (v, moved):
        before = kernels.LAUNCHES["lbvh_refit"]
        got = lbvh._refit_boxes(topo, *verts)
        assert kernels.LAUNCHES["lbvh_refit"] == before + 1
        assert lbvh.topo_state(topo).plan is plan
        assert not bool(plan.arrived.any())
        _assert_same(got, lbvh._refit_boxes_ref(topo, *verts))
    junk = torch.empty(8 << 20, dtype=torch.int32, device=cuda).fill_(-1)
    _assert_same(lbvh._refit_boxes(topo, *moved), got)
    assert not bool(plan.arrived.any())
    del junk


def test_refit_after_a_failed_launch_starts_from_a_new_plan(cuda,
                                                            monkeypatch):
    """A refit whose launch raises drops the topology's plan and its
    counters; the next refit makes new ones (two launches) and
    gives the plain version's words."""
    v = [x.to(cuda) for x in _refit_case(5000)]
    _, topo = lbvh.build_lbvh_topo(*v, width=8)
    old = lbvh.topo_state(topo).plan

    def failed(*args, **kwargs):
        raise RuntimeError("vrt_lbvh_refit_boxes launch failed")

    with monkeypatch.context() as mp:
        mp.setattr(lbvh, "_launch", failed)
        with pytest.raises(RuntimeError):
            lbvh._refit_boxes(topo, *v)
    assert lbvh.topo_state(topo).plan is None
    before = kernels.LAUNCHES["lbvh_refit"]
    got = lbvh._refit_boxes(topo, *v)
    assert kernels.LAUNCHES["lbvh_refit"] == before + 2
    st = lbvh.topo_state(topo)
    assert st.plan is not None and st.plan is not old
    assert not bool(st.plan.arrived.any())
    _assert_same(got, lbvh._refit_boxes_ref(topo, *v))


@functools.lru_cache(maxsize=None)
def _front_case(case):
    """Vertices on the CPU for K5 A and K5 B: two and three random
    triangles, the refit's cases (``_refit_case``), and 5,000 triangles
    whose vertices are all one point (a scene box of no extent: the
    1e-30 clamp, every code 0)."""
    import numpy as np

    if case in (2, 3):
        rng = np.random.default_rng(case)
        return [torch.from_numpy(rng.normal(size=(case, 3)).astype(
            np.float32)) for _ in range(3)]
    if case == "equal":
        p = torch.full((5000, 3), 1.25)
        return [p, p, p]
    return _refit_case(case)


@pytest.mark.parametrize("method", ["karras", "sah"])
@pytest.mark.parametrize("case", [2, 3, 255, 256, 257, 5000, 20_481,
                                  "config5", "duplicates", "equal"])
@pytest.mark.parametrize("width,leaf", [(4, 1), (8, 1), (4, 4), (8, 4),
                                        (4, 8), (8, 8)])
def test_lbvh_front_writes_every_word(cuda, monkeypatch, width, leaf, case,
                                      method):
    """K5 A (the scene box and codes in one launch, then Karras) and K5 B
    (the collapse with the refit plan, one launch) into memory poisoned
    with 0xFF words, with no fill, prefix sum or search around them: the
    box, codes and tree equal ``scene_codes_ref`` and ``_karras_ref``, the
    topology ``_collapse_wide_ref``, the plan ``_refit_plan`` (its torch
    ops and ``refit_plan_kernel``) and ``_refit_records_ref``, the
    leaf-row count the used rows, word for word; a relaunch gives the same
    words; the plan drives a refit of moved vertices in one launch to the
    plain version's boxes, and leaves its counters zero.  Karras and
    sweep-SAH trees (``config5`` is config 5's 999,700 triangles)."""
    tile = kernels.load("lbvh_refit").lib.vrt_lbvh_refit_tile()
    v = [x.to(cuda) for x in _front_case(case)]
    l = v[0].shape[0]
    before = dict(kernels.LAUNCHES)
    got = _poisoned(monkeypatch, lambda: lbvh.scene_codes(*v))
    _assert_same(got, lbvh.scene_codes_ref(*v))
    lcodes, order = torch.sort(got[0], stable=True)
    order = order.to(torch.int32)
    if method == "karras":
        tree = _poisoned(monkeypatch, lambda: lbvh._karras(lcodes, l))
        _assert_same(tree, lbvh._karras_ref(lcodes, l))
    else:
        tree = lbvh._sah_sweep_tree(*lbvh._leaf_boxes(*v, order), l)[:4]
    assert (kernels.LAUNCHES["lbvh_karras"] - before["lbvh_karras"]
            == (2 if method == "karras" else 1))
    made = []
    col = _poisoned(monkeypatch, lambda: lbvh._collapse_wide(
        *tree, l, leaf, width, state=made))
    assert kernels.LAUNCHES["lbvh_collapse"] == before["lbvh_collapse"] + 1
    _assert_same(col, lbvh._collapse_wide_ref(*tree, l, leaf, width))
    topo = lbvh.LBVHTopo(order, tree[0], tree[1], *col[:8], tree[2],
                         tree[3], col[8])
    st = made[0]
    assert st.num_leaves.dtype == torch.int64
    assert int(st.num_leaves) == int((col[6] > 0).sum())
    want = lbvh._refit_plan(topo, tile)
    _assert_same(tuple(st.plan), tuple(want))
    _assert_same(st.plan.rec, lbvh._refit_records_ref(topo, tile // 2,
                                                      want.gstart))
    again = []
    _assert_same(lbvh._collapse_wide(*tree, l, leaf, width, state=again), col)
    _assert_same(tuple(again[0].plan), tuple(st.plan))
    assert lbvh.topo_state(topo, st) is st
    moved = [x + 0.25 * torch.sin(x.flip(1)) for x in v]
    n = kernels.LAUNCHES["lbvh_refit"]
    _assert_same(lbvh._refit_boxes(topo, *moved),
                 lbvh._refit_boxes_ref(topo, *moved))
    assert kernels.LAUNCHES["lbvh_refit"] == n + 1
    assert not bool(st.plan.arrived.any())


@pytest.mark.parametrize("width", [4, 8])
def test_lbvh_build_enqueues_no_fill_or_scan(cuda, monkeypatch, width):
    """``build_lbvh_topo`` (Karras) into 0xFF-poisoned memory with
    ``torch.zeros``, ``torch.full``, ``torch.cumsum`` and
    ``torch.searchsorted`` refused: K5 A in two launches, K5 B in one,
    the refit in one over the build's plan, the pack in two; the topology
    and the tables equal the plain build's on the CPU."""
    host = _front_case(5000)
    before = dict(kernels.LAUNCHES)
    lb, topo = _poisoned(monkeypatch, lambda: lbvh.build_lbvh_topo(
        *(x.to(cuda) for x in host), width=width))
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in (
        "lbvh_karras", "lbvh_collapse", "lbvh_refit", "lbvh_pack")} == {
        "lbvh_karras": 2, "lbvh_collapse": 1, "lbvh_refit": 1,
        "lbvh_pack": 2}
    lb_h, topo_h = lbvh.build_lbvh_topo(*host, width=width)
    for a, b in zip(topo, topo_h):
        assert torch.equal(a.cpu(), b)
    for name in ("nodes", "tri_rows") + (("fused",) if width == 8 else ()):
        assert torch.equal(_words(getattr(lb, name)).cpu(),
                           _words(getattr(lb_h, name))), name
    assert int(lb.num_leaves) == int(lb_h.num_leaves)


def test_ploc_stack_capacities_match_the_kernels(cuda):
    """The stack sizes the PLOC depth check uses are the kernels' own."""
    from vortex_rt_tpu_torch.ops import packet_walk, traverse_packet

    assert traverse_packet.STACK_MAX == int(
        kernels.load("traverse_packet").lib.vrt_traverse_packet_stack_max())
    assert packet_walk.STACK_MAX == int(
        kernels.load("packet_walk").lib.vrt_packet_walk_stack_max())


# ---- K3 (the per-ray walk with any-hit suspension) and the alpha modes
# of K1 and K2

def _cutout(flatten, width=0):
    """Checkered and dark quads before a sphere, a box and two instances
    of a triangle soup (a TLAS over several BLASes when not flattened)."""
    import numpy as np

    from vortex_rt_tpu_torch.models.procedural import quad
    from vortex_rt_tpu_torch.models.scene import Material
    from vortex_rt_tpu_torch.utils import vecmath as vm

    yy, xx = np.meshgrid(np.arange(12), np.arange(12), indexing="ij")
    tex = np.where(((xx // 3) + (yy // 3)) % 2 == 0, 0xFFFFFF,
                   0x101010).astype(np.uint32)
    sc = pt.Scene()
    for mesh in (
            quad((-1.5, -1.5, 0), (1.5, -1.5, 0), (1.5, 1.5, 0),
                 (-1.5, 1.5, 0), Material(diffuse=(1, 1, 1), diffuse_tex=tex)),
            quad((-2, -2, 1.0), (2, -2, 1.0), (2, 2, 1.0), (-2, 2, 1.0),
                 Material(diffuse=(1, 1, 1), diffuse_tex=tex)),
            quad((-0.5, -0.5, 1.7), (0.5, -0.5, 1.7), (0.5, 0.5, 1.7),
                 (-0.5, 0.5, 1.7), Material(diffuse=(0.1, 0.1, 0.1))),
            uv_sphere((0, 0, 2.6), 0.8, 10, 14), box((1.2, 1.0, 2.4), 0.5)):
        sc.add_instance(sc.add_mesh(mesh))
    import numpy.random as npr

    ms = sc.add_mesh(random_soup(npr.default_rng(0), 2000, extent=2.0,
                                 tri_size=0.3))
    sc.add_instance(ms, vm.mat4_translate([0.5, 0, 4]))
    sc.add_instance(ms, vm.mat4_translate([-1, 0.5, 5])
                    @ vm.mat4_rotate([0, 1, 0], 0.5))
    return sc.build(pt.RTConfig(flatten=flatten, bvh_width=width))


def _camera_lanes(device, n):
    from vortex_rt_tpu_torch.engine import wavefront as wf
    from vortex_rt_tpu_torch.engine.megakernel import CameraArrays

    cam = pt.Camera.look_at([0.15, -0.1, -3.0], [0, 0, 1], [0, 1, 0], 50.0,
                            1.0)
    lane = torch.arange(n * n, device=device)
    pxi, pyi = wf._tile_pixel_ids(lane, n, 16, 16)
    return wf._camera_from_pix(CameraArrays.from_camera(cam, device), n, n,
                               pxi, pyi, pyi * n + pxi,
                               torch.zeros_like(lane), 1)


def _same_state(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("suspend", [False, True])
def test_k3_matches_plain_version(cuda, suspend):
    """K3 against its plain version on a TLAS build: every state field
    (hits, pending hits, trail, stack, steps and triangle tests) equal,
    in auto-accept and through a suspension loop of mixed actions."""
    from vortex_rt_tpu_torch.ops import traverse_wide as tw

    wa = WideArrays.from_scene(_cutout(False)).to(cuda)
    lanes = _camera_lanes(cuda, 96)
    before = kernels.LAUNCHES["traverse_wide"]
    st = sr = None
    rounds = 0
    while True:
        h, st, _ = tw.trace_lanes(wa, *lanes, state=st, suspend=suspend)
        torch.cuda.synchronize()
        hr, sr, _ = tw.trace_lanes_ref(wa, *lanes, state=sr, suspend=suspend)
        _same_state(st, sr)
        _same_state(h, hr)
        if not suspend or not bool(st.suspended.any()):
            break
        lane = torch.arange(st.tri.shape[0], device=cuda)
        act = torch.where(st.pend_inst == 0, 0, torch.where(
            lane % 17 == 0, 2, 1)).to(torch.int32)
        st, sr = tw.commit(st, act), tw.commit(sr, act)
        rounds += 1
    assert kernels.LAUNCHES["traverse_wide"] == before + rounds + 1
    assert bool(st.done.all()) and int((h.dist < 1e30).sum()) > 0
    if suspend:
        assert rounds >= 2


def test_k3_kernel_call_relaunches(cuda):
    """K3's bare launch walks the state its closure names, in place, on
    each call: with the input state put back, relaunching gives the same
    words in the same tensors."""
    from vortex_rt_tpu_torch.ops import traverse_wide as tw

    wa = WideArrays.from_scene(_cutout(False)).to(cuda)
    lanes = _camera_lanes(cuda, 33)
    st0 = tw.init_state_lanes(*lanes)
    fresh = [x.clone() for x in st0]
    call = tw.kernel_call(wa, *lanes, state=st0, suspend=True)
    st = call()
    assert st is st0
    first = [x.clone() for x in st]
    for x, f in zip(st, fresh):
        x.copy_(f)
    st = call()
    torch.cuda.synchronize()
    assert st is st0
    for a, b in zip(st, first):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["k1/closest", "k1/occlusion",
                                  "k1/occl_split", "k2tlas/closest",
                                  "k2tlas/occlusion", "k2flat/closest"])
def test_alpha_walks_match_plain_version(cuda, case):
    """K1's and K2's alpha instantiations against their plain versions:
    hits and per-ray steps equal; the launches count as the alpha mode."""
    walk_name, mode = case.split("/")
    flat = walk_name != "k2tlas"
    width = 8 if walk_name == "k1" else 4
    sb = _cutout(flat, width)
    wa = WideArrays.from_scene(sb, width=width)
    if width == 8:
        wa = wa.fuse()
    wa = wa.with_alpha(sb).to(cuda)
    lanes = _camera_lanes(cuda, 80)
    o, d = torch.stack(lanes[:3], 1), torch.stack(lanes[3:], 1)
    n = o.shape[0]
    t = torch.full((n,), 6.0, device=cuda)
    kw = {"closest": {}, "occlusion": dict(t_max=t, occlusion=True),
          "occl_split": dict(t_max=torch.where(
              torch.arange(n, device=cuda) < n // 2, t,
              torch.full_like(t, 1e30)), occl_split=n // 2)}[mode]
    walk, ref, name = ((trace_packets, trace_packets_ref,
                        "traverse_packet_alpha") if width == 8 else
                       (trace_packets_walk, trace_packets_walk_ref,
                        "packet_walk_alpha"))
    before = kernels.LAUNCHES[name]
    hk, sk = walk(wa, o, d, alpha_ref=0.35, **kw)
    torch.cuda.synchronize()
    hp, sp = ref(wa, o, d, alpha_ref=0.35, **kw)
    assert kernels.LAUNCHES[name] == before + 1
    for a, b in zip((*hk, sk), (*hp, sp)):
        assert torch.equal(a, b)
    h0, _ = walk(wa, o, d, **kw)
    assert bool((h0.dist != hk.dist).any())  # the cutout rejects hits


@pytest.mark.parametrize("route", ["alpha_k1", "alpha_k2", "suspension"])
def test_anyhit_frames_match_plain_route(cuda, route, monkeypatch):
    """Any-hit frames through the kernels against the plain route: the
    alpha test inside K1 (flattened) and K2 (TLAS), and the suspension
    engine (K3, packet_size=0, TLAS)."""
    import numpy as np

    from vortex_rt_tpu_torch.engine import wavefront as wf
    from vortex_rt_tpu_torch.engine.shaders import (
        ShaderTable, alpha_test_anyhit,
    )
    from vortex_rt_tpu_torch.ops import traverse_wide as tw

    flat = route == "alpha_k1"
    cfg = pt.RTConfig(flatten=flat,
                      packet_size=0 if route == "suspension" else 256)
    table = ShaderTable(anyhit=alpha_test_anyhit(0.35))
    rk = pt.WavefrontRenderer.from_buffers(_cutout(flat), cfg, table,
                                           device=cuda)
    cam = pt.Camera.look_at([0.15, -0.1, -3.0], [0, 0, 1], [0, 1, 0], 50.0,
                            1.0)
    p = pt.RenderParams(light_pos=(0.5, 1.5, -1.0), max_depth=2, spp=2,
                        shadow=True)
    kernels.reset_launches()
    img_k, rays_k = rk.render(cam, p, 64, 64)
    launches = dict(kernels.LAUNCHES)
    if route == "suspension":
        monkeypatch.setattr(wf, "walk_lanes", lambda *a, **kw:
                            tw.trace_lanes_ref(*a, **kw)[1])
        rp = rk
        assert launches["traverse_wide"] > 4
    else:
        ref = trace_packets_ref if flat else trace_packets_walk_ref
        rp = dataclasses.replace(rk, walk=ref)
        name = "traverse_packet_alpha" if flat else "packet_walk_alpha"
        assert launches[name] > 0 and launches["traverse_wide"] == 0
    img_p, rays_p = rp.render(cam, p, 64, 64)
    assert rays_k == rays_p
    np.testing.assert_allclose(img_k, img_p, atol=1e-5)


def _checker_pred(u, v, alpha):
    """A uv checkerboard cutout that also drops near-black surfaces
    (tests/test_anyhit_inline.py::_checker_pred, in torch)."""
    cu = torch.floor(u * 6.0).to(torch.int32)
    cv = torch.floor(v * 6.0).to(torch.int32)
    return (((cu + cv) % 2) == 0) & (alpha >= 0.05)


# the op cases of the predicate compiler (tests/torch_pred_cases.py)
PRED_OPS = {**OPS, "checker": _checker_pred}


@pytest.fixture(scope="module")
def card_preds(tmp_path_factory):
    """Every op case's ``vrt_pred`` run on the card over the seeded grid
    (one nvcc build with the kernels' flags, every header in a namespace
    of its own; a thread a grid point): {case: (R,) bool}, and the grid."""
    import ctypes

    from vortex_rt_tpu_torch.ops import anyhit_pred as ap

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = tmp_path_factory.mktemp("pred_card")
    compiled = [ap.compile_predicate(fn) for fn in PRED_OPS.values()]
    src = [f'namespace c{i} {{\n#include "{c.header_name}"\n}}\n'
           for i, c in enumerate(compiled)]
    calls = "\n".join(f"    out[{i} * n + i] = c{i}::vrt_pred(uu, vv, aa);"
                      for i in range(len(compiled)))
    src.append(f"""
__global__ void eval_preds(const float* u, const float* v, const float* a,
                           unsigned char* out, long n) {{
    const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float uu = u[i], vv = v[i], aa = a[i];
{calls}
}}

extern "C" int vrt_eval_preds(const void* u, const void* v, const void* a,
                              void* out, long n) {{
    eval_preds<<<(unsigned)((n + 255) / 256), 256>>>(
        (const float*)u, (const float*)v, (const float*)a,
        (unsigned char*)out, n);
    return (int)cudaDeviceSynchronize();
}}
""")
    cu = d / "eval_preds.cu"
    cu.write_text("".join(src))
    so, _, _ = kernels._build(cu, include_dirs=(d,), headers=tuple(
        c.write(d) for c in compiled))
    lib = ctypes.CDLL(str(so))
    lib.vrt_eval_preds.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_long]
    lib.vrt_eval_preds.restype = ctypes.c_int
    u, v, a = grid()
    n = u.shape[0]
    uva = [torch.from_numpy(x).cuda() for x in (u, v, a)]
    out = torch.empty(len(compiled) * n, dtype=torch.uint8, device="cuda")
    err = lib.vrt_eval_preds(*(t.data_ptr() for t in uva), out.data_ptr(), n)
    assert err == 0, f"CUDA error {err}"
    got = out.cpu().numpy().reshape(len(compiled), n).astype(bool)
    return dict(zip(PRED_OPS, got)), (u, v, a), uva


@pytest.mark.parametrize("op", list(PRED_OPS))
def test_emitted_predicate_on_card_equals_torch(card_preds, op):
    """Each op case of the predicate compiler, its ``vrt_pred`` built by
    nvcc with the kernels' flags and run on the card, on every point of
    the seeded grid (negative values, values past 1, exact cell edges,
    values past int32 and 1e5, near exp's overflow, signed zeros,
    subnormals, infinities, NaN): a case of exact ops decides as the
    torch callable does on the CPU; a case with correctly rounded ops as
    the compiled predicate's plain version does on the card, to the bit
    (both call the CUDA math library's double functions).  The points
    where the plain version on the CPU (torch's float64 kernels) decides
    otherwise are counted and printed (expected 0)."""
    import numpy as np

    from vortex_rt_tpu_torch.ops import anyhit_pred as ap

    got, (u, v, a), uva = card_preds
    c = ap.compile_predicate(PRED_OPS[op])
    cpu = [torch.from_numpy(x) for x in (u, v, a)]
    if c.exact:
        want = PRED_OPS[op](*cpu)
    else:
        want = c.plain(*uva).cpu()
        off_cpu = int((c.plain(*cpu) != want).sum())
        print(f"{op}: the plain version on the CPU differs from the card's "
              f"at {off_cpu} of {want.numel()} points")
    assert want.dtype == torch.bool
    want = want.numpy()
    bad = np.flatnonzero(got[op] != want)
    assert bad.size == 0, (f"{op}: {bad.size} of {want.size} differ, e.g. "
                           f"u={u[bad[:3]]} v={v[bad[:3]]} a={a[bad[:3]]}")


@pytest.mark.parametrize("case", ["k1/closest", "k1/occlusion",
                                  "k1/occl_split", "k2tlas/closest",
                                  "k2tlas/occlusion", "k1/stats",
                                  "perforated/k1/closest",
                                  "perforated/k1/occl_split",
                                  "perforated/k2tlas/closest",
                                  "perforated/k2tlas/occlusion"])
def test_pred_walks_match_plain_version(cuda, case):
    """K1's and K2's predicate modes (the library built with the compiled
    checker predicate, or ``bench_ladder.perforated_pred``: correctly
    rounded ``sqrt``, ``sin``, ``cos``, ``**``) against their plain
    versions, which call the predicate's plain version on tensors: hits
    and per-ray steps equal; the launches count as the predicate mode
    (the counting one as ``_stats``)."""
    from vortex_rt_tpu_torch.tools.bench_ladder import perforated_pred

    pred = perforated_pred if case.startswith("perforated/") \
        else _checker_pred
    walk_name, mode = case.split("/")[-2:]
    flat = walk_name == "k1"
    width = 8 if flat else 4
    sb = _cutout(flat, width)
    wa = WideArrays.from_scene(sb, width=width)
    if width == 8:
        wa = wa.fuse()
    wa = wa.with_alpha(sb).to(cuda)
    lanes = _camera_lanes(cuda, 80)
    o, d = torch.stack(lanes[:3], 1), torch.stack(lanes[3:], 1)
    n = o.shape[0]
    t = torch.full((n,), 6.0, device=cuda)
    kw = {"closest": {}, "stats": dict(stats=True),
          "occlusion": dict(t_max=t, occlusion=True),
          "occl_split": dict(t_max=torch.where(
              torch.arange(n, device=cuda) < n // 2, t,
              torch.full_like(t, 1e30)), occl_split=n // 2)}[mode]
    walk, ref, name = ((trace_packets, trace_packets_ref,
                        "traverse_packet_pred") if flat else
                       (trace_packets_walk, trace_packets_walk_ref,
                        "packet_walk_pred"))
    if mode == "stats":
        name = "traverse_packet_stats"
    before = kernels.LAUNCHES[name]
    out = walk(wa, o, d, anyhit_pred=pred, **kw)
    torch.cuda.synchronize()
    kw.pop("stats", None)
    hp, sp = ref(wa, o, d, anyhit_pred=pred, **kw)
    assert kernels.LAUNCHES[name] == before + 1
    hk, sk = out[0], out[1]
    for a, b in zip((*hk, sk), (*hp, sp)):
        assert torch.equal(a, b)
    h0, _ = walk(wa, o, d, **kw)
    assert bool((h0.dist != hk.dist).any())  # the predicate rejects hits


@pytest.mark.parametrize("pred_name,flat", [
    ("checker", True), ("checker", False), ("perforated", True),
    ("perforated", False)])
def test_pred_frames_match_plain_route(cuda, pred_name, flat):
    """``stateless_anyhit`` frames through K1's (flattened) and K2's (TLAS)
    predicate modes against the plain route, and no K3 launch; with the
    checker predicate and with ``bench_ladder.perforated_pred``."""
    import numpy as np

    from vortex_rt_tpu_torch.engine.shaders import (
        ShaderTable, stateless_anyhit,
    )
    from vortex_rt_tpu_torch.tools.bench_ladder import perforated_pred

    cfg = pt.RTConfig(flatten=flat)
    table = ShaderTable(anyhit=stateless_anyhit(
        perforated_pred if pred_name == "perforated" else _checker_pred,
        pred_name))
    rk = pt.WavefrontRenderer.from_buffers(_cutout(flat), cfg, table,
                                           device=cuda)
    cam = pt.Camera.look_at([0.15, -0.1, -3.0], [0, 0, 1], [0, 1, 0], 50.0,
                            1.0)
    p = pt.RenderParams(light_pos=(0.5, 1.5, -1.0), max_depth=3, spp=2,
                        shadow=True)
    kernels.reset_launches()
    img_k, rays_k = rk.render(cam, p, 64, 64)
    launches = dict(kernels.LAUNCHES)
    name = "traverse_packet_pred" if flat else "packet_walk_pred"
    assert launches[name] > 0 and launches["traverse_wide"] == 0
    ref = trace_packets_ref if flat else trace_packets_walk_ref
    img_p, rays_p = dataclasses.replace(rk, walk=ref).render(cam, p, 64, 64)
    assert rays_k == rays_p
    np.testing.assert_allclose(img_k, img_p, atol=1e-5)


# ---------------------------------------------- K6 and the megakernel

def _instances_scene():
    from vortex_rt_tpu_torch.utils import vecmath as vm

    sc = pt.Scene()
    mb = sc.add_mesh(box((0, 0, 0), 1.0))
    ms = sc.add_mesh(uv_sphere((0, 0, 0), 1.0, 8, 12))
    sc.add_instance(mb, vm.mat4_translate([-3, 0, 0]))
    sc.add_instance(ms, vm.mat4_translate([3, 0, 0]) @ vm.mat4_scale(1.5))
    sc.add_instance(mb, vm.mat4_translate([0, 3, 0])
                    @ vm.mat4_rotate([0, 0, 1], 0.6) @ vm.mat4_scale(0.7))
    sc.add_instance(ms, vm.mat4_translate([3, 0, 0]) @ vm.mat4_scale(1.5))
    sc.add_instance(sc.add_mesh(random_soup(
        __import__("numpy").random.default_rng(1), 400, extent=2.0)))
    return sc.build(pt.RTConfig())


def _tlas_pool():
    from vortex_rt_tpu_torch.ops.traverse2 import TraversalArrays

    return TraversalArrays.from_scene(_instances_scene())


@pytest.mark.parametrize("stack_depth", [64, 4])
def test_k6_matches_plain_version(cuda, stack_depth):
    """K6 against trace_rays_ref: hits, per-ray counts and steps equal,
    with a third of the rays inactive; at stack_depth 4 the stack
    overflows (the clamped push and pop of the JAX arrays)."""
    from vortex_rt_tpu_torch.ops import traverse2 as t2

    ta = _tlas_pool().to(cuda)
    g = torch.Generator().manual_seed(3)
    n = 5000
    o = ((torch.rand(n, 3, generator=g) - 0.5) * 12).to(cuda)
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g)).to(cuda)
    live = torch.arange(n, device=cuda) % 3 != 1
    for active in (None, live):
        before = kernels.LAUNCHES["traverse2"]
        k, kp = t2.trace_rays(ta, o, d, stack_depth=stack_depth,
                              active=active)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["traverse2"] == before + 1
        p, pp = t2.trace_rays_ref(ta, o, d, stack_depth=stack_depth,
                                  active=active)
        for a, b in zip((*k, *kp), (*p, *pp)):
            assert torch.equal(a, b)
        assert bool((k.dist < 1e30).any())


def test_k6_kernel_call_relaunches(cuda):
    """Relaunches through kernel_call after other allocations give the
    same records: the launcher holds its inputs, the packed records and
    its outputs."""
    from vortex_rt_tpu_torch.ops import traverse2 as t2

    ta = _tlas_pool().to(cuda)
    g = torch.Generator().manual_seed(4)
    o = ((torch.rand(3000, 3, generator=g) - 0.5) * 12).to(cuda)
    d = torch.nn.functional.normalize(torch.randn(3000, 3, generator=g))
    launch = t2.kernel_call(ta, o, d.to(cuda))
    first = [a.clone() for a in launch()]
    del o, d, ta  # the packed records live on in the launcher's closure
    junk = [torch.full((1 << 20,), 7.0, device=cuda) for _ in range(8)]
    again = launch()
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    del junk


@pytest.mark.parametrize("stack_depth", [64, 4])
def test_k6_past_its_stack(cuda, stack_depth):
    """K6 on ``chain_pool(100)``, a pool 102 levels deep whose walks defer
    100 leaves: its stack keeps min(stack_depth, 64) entries and
    overflows as the plain version's does (hits, counts, steps equal),
    a fifth of the rays inactive."""
    from vortex_rt_tpu_torch.ops import traverse2 as t2

    ta = t2.chain_pool(100, cuda)
    assert ta.walk_tables().depth == t2.STACK_MAX == int(
        kernels.load("traverse2").lib.vrt_traverse2_stack_max())
    n = 20000
    g = torch.Generator().manual_seed(7)
    yz = torch.rand(n, 2, generator=g) * 1.8 - 0.9
    o = torch.stack([torch.full((n,), -1.0), yz[:, 0], yz[:, 1]], 1)
    d = torch.nn.functional.normalize(
        torch.tensor([1.0, 0.0, 0.0]) + 1e-3 * torch.randn(n, 3, generator=g))
    o, d = o.to(cuda), d.to(cuda)
    active = torch.arange(n, device=cuda) % 5 != 2
    k, kp = t2.trace_rays(ta, o, d, stack_depth=stack_depth, active=active)
    torch.cuda.synchronize()
    p, pp = t2.trace_rays_ref(ta, o, d, stack_depth=stack_depth,
                              active=active)
    for a, b in zip((*k, *kp), (*p, *pp)):
        assert torch.equal(a, b)
    assert int(pp.steps) == 202 and bool((p.dist < 1e30).any())


def test_megakernel_frame_matches_cpu_frame(cuda):
    """A 48x48 frame at spp 2, depth 3 (mirror sphere) on the card
    against the same frame on the CPU: equal ray counts, pixels within
    1e-5 (elementwise torch ops may round differently on the two
    devices), K6 launched once a wave."""
    from vortex_rt_tpu_torch.engine.megakernel import MegakernelRenderer

    sb = _scene(False)
    cam = pt.Camera.look_at([0.11, 0.07, -3.2], [0.02, -0.01, 0], [0, 1, 0],
                            45.0, 1.0)
    p = pt.RenderParams(light_pos=(0, 0.8, -0.5), max_depth=3, spp=2)
    kernels.reset_launches()
    img, n = MegakernelRenderer.from_buffers(sb, device=cuda).render(
        cam, p, 48, 48)
    assert kernels.LAUNCHES["traverse2"] == 6
    ref, n_ref = MegakernelRenderer.from_buffers(sb, device="cpu").render(
        cam, p, 48, 48)
    assert n == n_ref > 2 * 48 * 48
    assert float(abs(img - ref).max()) <= 1e-5


@pytest.mark.parametrize("mesh", ["random_soup", "wavy_grid"])
def test_sah_kernels_match_plain_version(cuda, mesh):
    """The sweep-SAH tree's kernel against _sah_sweep_tree_ref (run on
    the card too: it is torch ops on any device): lchild, rchild, lo, hi
    and the level count equal, one launch a sweep, on a mesh past one
    sub-tile of positions and on one of 1,096 sub-tiles of 1,024 (more
    than the grid's blocks); then, on the soup, the build's tables
    against the plain build's on the CPU, word for word."""
    import numpy as np

    m = (random_soup(np.random.default_rng(2), 3001) if mesh == "random_soup"
         else wavy_grid(n=750))
    v = lbvh.pad_tris(m.v0, m.v1, m.v2, 4)
    vd = [torch.from_numpy(a).to(cuda) for a in v]
    vc = [torch.from_numpy(a) for a in v]
    l = vd[0].shape[0]
    order = torch.randperm(l, generator=torch.Generator().manual_seed(1))
    order = order.to(torch.int32)
    before = kernels.LAUNCHES["lbvh_sah"]
    got = lbvh._sah_sweep_tree(*lbvh._leaf_boxes(*vd, order.to(cuda)), l)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lbvh_sah"] == before + 1
    want = lbvh._sah_sweep_tree_ref(
        *lbvh._leaf_boxes(*vd, order.to(cuda)), l)
    assert got[-1] == want[-1]
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    if mesh != "random_soup":
        return
    lb, topo = lbvh.build_lbvh_topo(*vd, method="sah", width=8)
    lbc, topoc = lbvh.build_lbvh_topo(*vc, method="sah", width=8)
    for a, b in zip(topo, topoc):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(lb.fused.cpu(), lbc.fused)
    assert lb.wide_depth == lbc.wide_depth


@pytest.mark.parametrize("l", [2, 3, 1023, 1024, 1025, 2049, "config3",
                               "soup3m"])
@pytest.mark.parametrize("dups", [False, True])
def test_sah_sweep_sizes_match_plain_version(cuda, l, dups):
    """The sweep's one cooperative launch at sizes around its sub-tile of
    1,024 positions, at config 3's mesh (blob n=187, 69,940 triangles)
    and at 3,000,000 triangles of a random soup, both Morton-sorted
    (``dups`` there: every box rounded to a coarse grid, so most costs
    tie); at the soup a block's range state (12 B a position,
    about 11,400 positions a block) does not fit in its shared memory
    beside the other block of its SM, so it lives in global memory.
    The grid is one block a sub-tile up to two blocks an SM; lchild,
    rchild, lo, hi, the level count and the live positions of each
    level equal the plain version's word for word."""
    import numpy as np

    rng = np.random.default_rng(5)
    if l in ("config3", "soup3m"):
        m = (blob(n=187) if l == "config3" else
             random_soup(np.random.default_rng(7), 3_000_000))
        v = [torch.from_numpy(a).to(cuda)
             for a in lbvh.pad_tris(m.v0, m.v1, m.v2, 4)]
        _, order = torch.sort(lbvh.scene_codes(*v)[0], stable=True)
        lmin, lmax = lbvh._leaf_boxes(*v, order.to(torch.int32))
        if dups:
            lmin, lmax = (torch.round(b * (5 / 16)) for b in (lmin, lmax))
        l = lmin.shape[0]
    else:
        c = rng.integers(0, 6, (l, 3)) if dups else rng.uniform(-9, 9, (l, 3))
        c = torch.from_numpy(c.astype(np.float32)).to(cuda)
        lmin, lmax = c - 0.5, c + 0.5
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert kernels.load("lbvh_sah").lib.vrt_sah_blocks(l) == min(
        -(-l // 1024), 2 * sms)
    live_k, live = [], []
    got = lbvh._sah_sweep_tree(lmin, lmax, l, live=live_k)
    want = lbvh._sah_sweep_tree_ref(lmin, lmax, l, live=live)
    assert got[-1] == want[-1] and live_k == live
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)


def test_sah_sweep_reads_the_host_once(cuda):
    """A sweep at config 3's mesh is one kernel launch and one copy to the
    host (the level count with the live counts), as the profiler records
    them."""
    from torch.profiler import ProfilerActivity, profile

    m = blob(n=187)
    v = [torch.from_numpy(a).to(cuda)
         for a in lbvh.pad_tris(m.v0, m.v1, m.v2, 4)]
    _, order = torch.sort(lbvh.scene_codes(*v)[0], stable=True)
    lmin, lmax = lbvh._leaf_boxes(*v, order.to(torch.int32))
    l = lmin.shape[0]
    lbvh._sah_sweep_tree(lmin, lmax, l)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lbvh._sah_sweep_tree(lmin, lmax, l)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    assert sum(e.count for e in ev if "DtoH" in e.key) == 1
    assert sum(e.count for e in ev if "sweep_kernel" in e.key) == 1


def _k3_loop_states(cuda, wa, lanes, rounds=1000):
    """K3 through ``trace_lanes`` (a copy of the state walked), K3 in
    place on a state of its own (``walk_lanes``, the pool path's rounds)
    and the plain version through a suspension loop of mixed actions:
    yields the three states of each round."""
    from vortex_rt_tpu_torch.ops import traverse_wide as tw

    lane = torch.arange(lanes[0].shape[0], device=cuda)
    st = sr = None
    si = tw.init_state_lanes(*lanes)
    for _ in range(rounds):
        _, st, _ = tw.trace_lanes(wa, *lanes, state=st, suspend=True)
        si = tw.walk_lanes(wa, *lanes, state=si, suspend=True)
        torch.cuda.synchronize()
        _, sr, _ = tw.trace_lanes_ref(wa, *lanes, state=sr, suspend=True)
        yield st, si, sr
        if not bool(st.suspended.any()):
            return
        act = torch.where(st.pend_inst == 0, 0, torch.where(
            lane % 17 == 0, 2, torch.where(lane % 5 == 0, 1, 0)))
        act = torch.where(st.suspended, act.to(torch.int32), 0)
        st, sr, si = tw.commit(st, act), tw.commit(sr, act), tw.commit(si, act)


def test_k3_in_place_matches_out_of_place(cuda):
    """K3 in place on the pool's own state (``walk_lanes``) against K3 on
    a copy (``trace_lanes``, whose input stays as it was) and the plain
    version, every state field, through a suspension loop of mixed
    CONT / ACCEPT / TERM actions on a TLAS build."""
    wa = WideArrays.from_scene(_cutout(False)).to(cuda)
    lanes = _camera_lanes(cuda, 96)
    rounds = 0
    for st, si, sr in _k3_loop_states(cuda, wa, lanes):
        _same_state(st, sr)
        _same_state(si, sr)
        rounds += 1
    assert rounds >= 3 and bool(st.done.all())


def test_k3_pass_through_lanes_untouched(cuda):
    """In place, a lane that is done or suspended at entry keeps every
    byte of its state: lanes marked so mid-loop, their other fields
    filled with garbage bits, come out bit for bit as they went in, and
    the walking lanes equal the plain version's."""
    from vortex_rt_tpu_torch.ops import traverse_wide as tw

    wa = WideArrays.from_scene(_cutout(False)).to(cuda)
    lanes = _camera_lanes(cuda, 64)
    loop = _k3_loop_states(cuda, wa, lanes)
    next(loop)
    _, si, _ = next(loop)   # every lane suspended or done
    lane = torch.arange(si.tri.shape[0], device=cuda)
    # resumed past its candidate, or ended; a third of the lanes parked
    si = tw.commit(si, torch.where(lane % 7 == 0, 2, 0).to(torch.int32))
    parked = (lane % 3 == 0) & ~si.done
    gen = torch.Generator(device=cuda).manual_seed(3)

    def poison(name, a):
        if a.dtype == torch.bool:
            return (a | parked) if name == "done" else a.clone()
        junk = torch.randint(-2**31, 2**31 - 1, a.shape, generator=gen,
                             device=cuda, dtype=torch.int32).view(a.dtype)
        return torch.where(parked, junk, a)

    st = tw.WideState(*(poison(n, a) for n, a in zip(si._fields, si)))
    want = tw.trace_lanes_ref(wa, *lanes, state=st, suspend=True)[1]
    before = [a.clone() for a in st]
    got = tw.walk_lanes(wa, *lanes, state=st, suspend=True)
    torch.cuda.synchronize()
    assert got is st
    pass_through = parked | si.done
    assert bool(pass_through.any()) and bool((~pass_through).any())
    for name, a, b, w in zip(st._fields, got, before, want):
        bits = (a.view(torch.int32) if a.dtype != torch.bool else a)
        old = (b.view(torch.int32) if b.dtype != torch.bool else b)
        assert torch.equal(bits[pass_through], old[pass_through]), name
        ref = (w.view(torch.int32) if w.dtype != torch.bool else w)
        assert torch.equal(bits, ref), name


# ---- K1's alpha classes and K4c's refit in one launch

def _coincident_cutout():
    """A checkered quad twice at one place (coincident triangles under
    other ids), a dark quad (always cut out) and a checkered one before
    it, a white quad, a sphere and a box behind: flat 8-wide fused rows
    with the alpha fields."""
    import numpy as np

    from vortex_rt_tpu_torch.models.procedural import quad
    from vortex_rt_tpu_torch.models.scene import Material

    yy, xx = np.meshgrid(np.arange(12), np.arange(12), indexing="ij")
    tex = np.where(((xx // 3) + (yy // 3)) % 2 == 0, 0xFFFFFF,
                   0x101010).astype(np.uint32)
    sc = pt.Scene()
    checker = sc.add_mesh(quad((-2, -2, 1.0), (2, -2, 1.0), (2, 2, 1.0),
                               (-2, 2, 1.0),
                               Material(diffuse=(1, 1, 1), diffuse_tex=tex)))
    sc.add_instance(checker)
    sc.add_instance(checker)
    for mesh in (
            quad((-1.5, -1.5, 0), (1.5, -1.5, 0), (1.5, 1.5, 0),
                 (-1.5, 1.5, 0), Material(diffuse=(1, 1, 1), diffuse_tex=tex)),
            quad((-0.5, -0.5, -0.5), (0.5, -0.5, -0.5), (0.5, 0.5, -0.5),
                 (-0.5, 0.5, -0.5), Material(diffuse=(0.1, 0.1, 0.1))),
            quad((-3, -3, 2.0), (3, -3, 2.0), (3, 3, 2.0), (-3, 3, 2.0),
                 Material(diffuse=(1, 1, 1))),
            uv_sphere((0, 0, 2.6), 0.8, 10, 14), box((1.2, 1.0, 2.4), 0.5)):
        sc.add_instance(sc.add_mesh(mesh))
    sb = sc.build(pt.RTConfig(flatten=True))
    return WideArrays.from_scene(sb, width=8).fuse().with_alpha(sb)


@pytest.mark.parametrize("mode", ["closest", "occlusion", "occl_split"])
def test_alpha_classes_keep_the_plain_hits(cuda, mode):
    """K1's alpha mode, which skips the test of a slot its classes find
    kept or cut out wherever its triangle is hit, against its plain
    version, which tests every candidate, where coincident triangles
    under other ids are cut out and nearer cut-out candidates lie before
    kept ones: hits and steps equal in closest, occlusion and mixed
    waves; the kernel tests fewer candidates than pass Moller-Trumbore."""
    wa = _coincident_cutout().to(cuda)
    lanes = _camera_lanes(cuda, 96)
    o, d = torch.stack(lanes[:3], 1), torch.stack(lanes[3:], 1)
    n = o.shape[0]
    t = torch.full((n,), 6.0, device=cuda)
    kw = {"closest": {}, "occlusion": dict(t_max=t, occlusion=True),
          "occl_split": dict(t_max=torch.where(
              torch.arange(n, device=cuda) < n // 2, t,
              torch.full_like(t, 1e30)), occl_split=n // 2)}[mode]
    before = kernels.LAUNCHES["traverse_packet_alpha"]
    hk, sk = trace_packets(wa, o, d, alpha_ref=0.35, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["traverse_packet_alpha"] == before + 1
    from vortex_rt_tpu_torch.ops.traverse_packet import walk_work

    hp, sp, work = walk_work(wa, o, d, alpha_ref=0.35, **kw)
    for a, b in zip((*hk, sk), (*hp, sp)):
        assert torch.equal(a, b)
    assert 0 < int(work.alpha_lookups.sum()) < int(work.alpha_tests.sum())


def _ploc_case(name):
    m = _lbvh_mesh(name)
    return [torch.from_numpy(x) for x in lbvh.pad_tris(m.v0, m.v1, m.v2, 4)]


@pytest.mark.parametrize("mesh", ["uv_sphere", "random_soup", "wavy_grid"])
def test_ploc_refit_twice_matches_plain_version(cuda, mesh):
    """K4c on the card: ``refit_ploc`` twice in a row on moved vertices
    equals the plain refit (boxes, nodes, rows, fused rows), each refit
    one K4c launch, the climb's counters (made at the first refit) zero
    after each and kept."""
    v = _ploc_case(mesh)
    vc = [x.to(cuda) for x in v]
    _, ptc = ploc.build_ploc_topo(*vc, leaf_size=4, width=8)
    assert lbvh.topo_state(ptc.topo).ploc_arrived is None
    _, ptp = ploc.build_ploc_topo(*v, leaf_size=4, width=8)
    for k in range(2):
        moved = [x + 0.25 * k * torch.sin(x.flip(1)) + 0.1 for x in v]
        before = kernels.LAUNCHES["ploc_refit"]
        boxes = ploc._refit_boxes_ploc(ptc, *(x.to(cuda) for x in moved))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["ploc_refit"] == before + 1
        arrived = lbvh.topo_state(ptc.topo).ploc_arrived
        assert not bool(arrived.any())
        _assert_same(tuple(b.cpu() for b in boxes),
                     ploc._refit_boxes_ploc_ref(ptp, *moved))
        got = ploc.refit_ploc(ptc, *(x.to(cuda) for x in moved), width=8)
        want = ploc.refit_ploc(ptp, *moved, width=8)
        for name in ("nodes", "tri_rows", "fused"):
            assert torch.equal(_words(getattr(got, name)).cpu(),
                               _words(getattr(want, name))), name
    assert lbvh.topo_state(ptc.topo).ploc_arrived is arrived


def test_ploc_refit_after_a_failed_launch_starts_from_new_counters(
        cuda, monkeypatch):
    """A K4c refit whose launch raises drops the topology's climb
    counters; the next refit makes new zero ones (one launch) and gives
    the plain version's words."""
    v = [x.to(cuda) for x in _ploc_case("wavy_grid")]
    _, ptopo = ploc.build_ploc_topo(*v, leaf_size=4, width=8)
    ploc._refit_boxes_ploc(ptopo, *v)
    old = lbvh.topo_state(ptopo.topo).ploc_arrived
    assert old is not None

    def failed(*args, **kwargs):
        raise RuntimeError("vrt_ploc_boxes launch failed")

    with monkeypatch.context() as mp:
        mp.setattr(ploc, "_launch", failed)
        with pytest.raises(RuntimeError):
            ploc._refit_boxes_ploc(ptopo, *v)
    assert lbvh.topo_state(ptopo.topo).ploc_arrived is None
    before = kernels.LAUNCHES["ploc_refit"]
    got = ploc._refit_boxes_ploc(ptopo, *v)
    assert kernels.LAUNCHES["ploc_refit"] == before + 1
    arrived = lbvh.topo_state(ptopo.topo).ploc_arrived
    assert arrived is not None and arrived is not old
    assert not bool(arrived.any())
    _assert_same(got, ploc._refit_boxes_ploc_ref(ptopo, *v))


# ---- the counting instantiations of K1 and K2 (per-wave statistics)

@pytest.mark.parametrize("case", ["k1", "k1_alpha", "k1_occlusion",
                                  "k2flat", "k2tlas", "k2tlas_alpha",
                                  "k2tlas_occlusion"])
def test_stats_walks_match_walk_work(cuda, case):
    """The STATS instantiations of K1 and K2 (plain and alpha) on a 64x64
    wave: each ray's internal and instance steps equal the plain walk's
    ``walk_work`` counts, and the hits and steps equal the default
    instantiation's and the plain version's."""
    from vortex_rt_tpu_torch.ops.packet_walk import walk_work_4
    from vortex_rt_tpu_torch.ops.traverse_packet import walk_work

    width = 8 if case.startswith("k1") else 4
    flat = not case.startswith("k2tlas")
    sb = _cutout(flat, width)
    wa = WideArrays.from_scene(sb, width=width)
    if width == 8:
        wa = wa.fuse()
    if case.endswith("alpha"):
        wa = wa.with_alpha(sb)
    wa = wa.to(cuda)
    lanes = _camera_lanes(cuda, 64)
    o, d = torch.stack(lanes[:3], 1), torch.stack(lanes[3:], 1)
    n = o.shape[0]
    kw = dict(active=torch.arange(n, device=cuda) % 5 != 2)
    if case.endswith("alpha"):
        kw["alpha_ref"] = 0.35
    if case.endswith("occlusion"):
        kw.update(t_max=torch.full((n,), 6.0, device=cuda), occlusion=True)
    walk, work_fn = ((trace_packets, walk_work) if width == 8
                     else (trace_packets_walk, walk_work_4))
    name = "traverse_packet_stats" if width == 8 else "packet_walk_stats"
    plain = ("traverse_packet" if width == 8 else "packet_walk") + (
        "_alpha" if case.endswith("alpha") else "")
    before = dict(kernels.LAUNCHES)
    hs, ss, kinds = walk(wa, o, d, stats=True, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before[name] + 1
    assert kernels.LAUNCHES[plain] == before[plain]
    hd, sd = walk(wa, o, d, **kw)
    hp, sp, work = work_fn(wa, o, d, **kw)
    for a, b, c in zip((*hs, ss), (*hd, sd), (*hp, sp)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(kinds.internal, work.internal.to(torch.int32))
    assert torch.equal(kinds.instance, work.instance.to(torch.int32))
    assert torch.equal(ss - kinds.internal - kinds.instance,
                       work.leaf.to(torch.int32))
    assert bool((kinds.instance > 0).any()) == (not flat)


def test_cli_runs_on_the_card_by_default(cuda, tmp_path, capsys):
    """``cli.main`` with no --device renders on the card: K1 on the
    wavefront frame and K1's counting instantiation for --perf."""
    from vortex_rt_tpu_torch import cli

    kernels.reset_launches()
    rc = cli.main(["-m", "cornell", "-w", "64", "-H", "64", "-d", "2",
                   "--shadow", "--perf", "--compare",
                   "-o", str(tmp_path / "o.ppm")])
    out = capsys.readouterr().out
    assert rc == 0 and "PASS" in out and "PERF.trace: trace0=" in out
    assert kernels.LAUNCHES["traverse_packet"] > 0
    assert kernels.LAUNCHES["traverse_packet_stats"] == 4


# ---- K1 at width 16 (RTConfig(bvh_width=16)): every entry point against
# the plain walk

def _wide16(sb, alpha=False):
    wa = WideArrays.from_scene(sb, width=16).fuse()
    return (wa.with_alpha(sb) if alpha else wa)


def _wide16_kw(cuda, mode, n, stats=False):
    t = torch.full((n,), 6.0, device=cuda)
    kw = {"closest": {}, "active": dict(
              active=torch.arange(n, device=cuda) % 5 != 2),
          "occlusion": dict(t_max=t, occlusion=True),
          "occl_split": dict(t_max=torch.where(
              torch.arange(n, device=cuda) < n // 2 + 3, t,
              torch.full_like(t, 1e30)), occl_split=n // 2 + 3)}[mode]
    return dict(kw, stats=True) if stats else kw


def _wide16_same(cuda, wa, o, d, name, kw, **mode):
    """The walk at width 16 through its kernel (one launch counted as
    ``name``) against the plain walk: hits, steps and, with stats, each
    ray's internal steps equal.  Returns the plain hits."""
    from vortex_rt_tpu_torch.ops.traverse_packet import walk_work

    stats = kw.pop("stats", False)
    before = dict(kernels.LAUNCHES)
    out = trace_packets(wa, o, d, stats=stats, **kw, **mode)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before[name] + 1
    assert all(kernels.LAUNCHES[k] == before[k] for k in before
               if k != name)
    hp, sp, work = walk_work(wa, o, d, **kw, **mode)
    for a, b in zip((*out[0], out[1]), (*hp, sp)):
        assert torch.equal(a, b)
    if stats:
        assert torch.equal(out[2].internal, work.internal.to(torch.int32))
        assert not bool(out[2].instance.any())
    return hp


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("mode", ["closest", "active", "occlusion",
                                  "occl_split"])
def test_wide16_k1_matches_plain_version(cuda, mode, stats):
    """``vrt_traverse_packet16`` and its counting instantiation against
    the plain walk on 5,000 rays (not a multiple of the block size), and
    the 8-wide kernel's hits on the same rays."""
    sb = _scene(True)
    wa = _wide16(sb).to(cuda)
    assert wa.width == 16 and wa.fused.shape[1] == 40 + 16 * 4
    o, d = _rays(cuda)
    kw = _wide16_kw(cuda, mode, o.shape[0], stats)
    hp = _wide16_same(cuda, wa, o, d, "traverse_packet16_stats" if stats
                      else "traverse_packet16", dict(kw))
    kw.pop("stats", None)
    h8, _ = trace_packets(WideArrays.from_scene(sb, 8).fuse().to(cuda), o, d,
                          **kw)
    for a, b in zip(h8, hp):
        assert torch.equal(a, b)
    assert bool((hp.dist < 1e30).any())


@pytest.mark.parametrize("count", ["33", "many_blocks"])
@pytest.mark.parametrize("mode", ["closest", "occlusion", "occl_split"])
def test_wide16_deep_tree_matches_plain_version(cuda, deep_build, count,
                                                mode):
    """K1 at width 16 on the blob's tree (51,200 triangles), for a ray
    count past a warp and past what the card holds at once."""
    wa = _wide16(deep_build).to(cuda)
    n = 4 * 132 * 8 * 128 + 17 if count == "many_blocks" else int(count)
    o, d, active, t_max = _deep_rays(cuda, n)
    kw = dict(active=active)
    if mode == "occlusion":
        kw.update(t_max=t_max, occlusion=True)
    elif mode == "occl_split":
        split = max(n // 3, 1) + 1
        kw.update(t_max=torch.where(torch.arange(n, device=cuda) < split,
                                    t_max, torch.full_like(t_max, 1e30)),
                  occl_split=split)
    hp = _wide16_same(cuda, wa, o, d, "traverse_packet16", kw)
    assert bool((hp.dist < 1e30).any())


@pytest.mark.parametrize("case", ["alpha/closest", "alpha/occlusion",
                                  "alpha/occl_split", "alpha/stats",
                                  "pred/closest", "pred/occlusion",
                                  "pred/occl_split", "pred/stats",
                                  "perforated/closest",
                                  "perforated/occl_split"])
def test_wide16_anyhit_walks_match_plain_version(cuda, case):
    """The alpha and predicate modes at width 16 (``_alpha``, ``_pred``
    and their counting instantiations) against the plain walk on the
    cutout scene's 80x80 camera rays."""
    from vortex_rt_tpu_torch.tools.bench_ladder import perforated_pred

    kind, mode = case.split("/")
    sb = _cutout(True, 16)
    wa = _wide16(sb, alpha=True).to(cuda)
    lanes = _camera_lanes(cuda, 80)
    o, d = torch.stack(lanes[:3], 1), torch.stack(lanes[3:], 1)
    stats = mode == "stats"
    kw = _wide16_kw(cuda, "active" if stats else mode, o.shape[0], stats)
    anyhit = (dict(alpha_ref=0.35) if kind == "alpha" else dict(
        anyhit_pred=perforated_pred if kind == "perforated"
        else _checker_pred))
    name = "traverse_packet16_" + ("stats" if stats else
                                   "alpha" if kind == "alpha" else "pred")
    hp = _wide16_same(cuda, wa, o, d, name, kw, **anyhit)
    kw.pop("stats", None)
    h0, _ = trace_packets(wa, o, d, **kw)
    assert bool((h0.dist != hp.dist).any())  # the test rejects hits


def test_wide16_rejects_a_tree_deeper_than_its_stack(cuda, deep_build):
    """At width 16 the shared-memory stack holds 32 entries of 12 B (48 KB
    a block): depth 28 walks, depth 29 raises before any launch; the
    library reports both widths' capacities."""
    from vortex_rt_tpu_torch.ops import traverse_packet as tp

    lib = kernels.load("traverse_packet").lib
    assert int(lib.vrt_traverse_packet16_stack_max()) == tp.STACK_MAX16
    assert int(lib.vrt_traverse_packet_stack_max()) == tp.STACK_MAX
    wa = _wide16(deep_build).to(cuda)
    o, d, _, _ = _deep_rays(cuda, 64)
    trace_packets(dataclasses.replace(wa, depth=28), o, d)
    before = kernels.LAUNCHES["traverse_packet16"]
    with pytest.raises(ValueError, match="stack entries"):
        trace_packets(dataclasses.replace(wa, depth=29), o, d)
    assert kernels.LAUNCHES["traverse_packet16"] == before


def _tie_scene():
    """tests/test_wide16.py's flat scene (seed 0): a box, a sphere and a
    300-triangle random soup as three instances of one flattened build."""
    import numpy as np

    from vortex_rt_tpu_torch.utils import vecmath as vm

    rng = np.random.default_rng(0)
    sc = pt.Scene()
    mb = sc.add_mesh(box((0, 0, 0), 1.0))
    ms = sc.add_mesh(uv_sphere((0, 0, 0), 1.0, 10, 14))
    mr = sc.add_mesh(random_soup(rng, 300))
    sc.add_instance(mb, vm.mat4_translate([-3, 0, 0]))
    sc.add_instance(ms, vm.mat4_translate([3, 0, 0]) @ vm.mat4_scale(1.5))
    sc.add_instance(mr, vm.mat4_translate([0, 0, 4]))
    return sc.build(pt.RTConfig(flatten=True))


def _tie_rays(cuda):
    """Rays whose hit children often enter at one distance: axis-aligned
    rays on a 24x24 grid over the scene from both ends of each axis (a
    child's entry plane lies on its node's quantization grid, shared with
    its siblings), and 2,000 seeded incoherent rays."""
    import numpy as np

    g = torch.linspace(-6.0, 7.0, 24)
    u, v = (x.reshape(-1) for x in torch.meshgrid(g, g, indexing="ij"))
    os, ds = [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            o = torch.zeros(u.shape[0], 3)
            o[:, axis] = -20.0 * sign
            o[:, (axis + 1) % 3] = u
            o[:, (axis + 2) % 3] = v
            d = torch.zeros_like(o)
            d[:, axis] = sign
            os.append(o)
            ds.append(d)
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.uniform(-10, 10, (2000, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(2000, 3)).astype(np.float32))
    os.append(o)
    ds.append(d / d.norm(dim=1, keepdim=True))
    return torch.cat(os).to(cuda), torch.cat(ds).to(cuda)


def _root_ties(wa, o, d) -> int:
    """Rays with two hit children of the root at one entry distance (the
    slab test of the walks, best_t unbounded)."""
    from vortex_rt_tpu_torch.ops.traverse_packet import qbyte
    from vortex_rt_tpu_torch.ops.traverse_wide import row_layout

    q_lo, q_hi, m_off, _, _ = row_layout(16)
    row = wa.fused[0].to(torch.int64) & 0xFFFFFFFF
    f = wa.fused[0].view(torch.float32)
    nch = int((row[m_off] >> 24) & 31)
    dd = torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    iv = 1.0 / dd
    keys = []
    for c in range(nch):
        lo = torch.stack([f[k] + qbyte(row[q_lo + c], 8 * k) * f[3 + k]
                          for k in range(3)])
        hi = torch.stack([f[k] + qbyte(row[q_hi + c], 8 * k) * f[3 + k]
                          for k in range(3)])
        t1 = (lo[None, :] - o) * iv
        t2 = (hi[None, :] - o) * iv
        tmin = torch.minimum(t1, t2).max(1).values
        tmax = torch.maximum(t1, t2).min(1).values
        keys.append(torch.where((tmax >= tmin) & (tmax > 0), tmin,
                                torch.full_like(tmin, float("nan"))))
    k = torch.stack(keys, 1).sort(1).values
    return int(((k[:, 1:] == k[:, :-1]).any(1)).sum())


@pytest.mark.parametrize("case", ["closest", "closest/stats", "occl_split",
                                  "alpha", "alpha/stats", "pred",
                                  "pred/stats"])
def test_wide16_order_matches_plain_version_on_ties(cuda, case):
    """Every mode of K1 at width 16 against the plain walk (hits, steps
    and, with stats, internal steps to the bit) on rays whose hit children
    tie: the step orders the hit children by a selection, and by Batcher's
    network when two keys agree above their 4 low bits
    (``csrc/sort16.cuh``); the plain walk runs the network always."""
    mode, _, stats = case.partition("/")
    sb = _tie_scene()
    wa = _wide16(sb, alpha=mode != "closest" and mode != "occl_split")
    wa = wa.to(cuda)
    o, d = _tie_rays(cuda)
    assert _root_ties(wa, o, d) > 100
    n = o.shape[0]
    kw = _wide16_kw(cuda, "occl_split" if mode == "occl_split" else
                    "closest", n, bool(stats))
    anyhit = (dict(alpha_ref=0.5) if mode == "alpha" else
              dict(anyhit_pred=_checker_pred) if mode == "pred" else {})
    name = "traverse_packet16_" + ("stats" if stats else mode
                                   if mode in ("alpha", "pred") else "")
    hp = _wide16_same(cuda, wa, o, d, name.rstrip("_"), kw, **anyhit)
    assert bool((hp.dist < 1e30).any())


@pytest.mark.parametrize("pathtrace", [False, True])
def test_wide16_frame_matches_plain_route(cuda, pathtrace):
    """A 48x32 spp-2 depth-3 frame with ``RTConfig(bvh_width=16,
    flatten=True)``: 5 K1 launches a sample pass at width 16 (the merged
    wave among them), the plain route's rays and image within 1e-5, and
    the 8-wide frame's."""
    import numpy as np

    cfg = pt.RTConfig(flatten=True, bvh_width=16)
    sb = _scene(True)
    rk = pt.WavefrontRenderer.from_buffers(sb, cfg, device=cuda)
    assert rk.walk is trace_packets and rk.wa.width == 16
    rp = dataclasses.replace(rk, walk=trace_packets_ref)
    r8 = pt.WavefrontRenderer.from_buffers(sb, pt.RTConfig(flatten=True),
                                           device=cuda)
    cam = pt.Camera.look_at([0.05, 0.02, -3.2], [0, -0.05, 0], [0, 1, 0],
                            45.0, 1.0)
    p = pt.RenderParams(light_pos=(0, 0.8, -0.5), shadow=True, spp=2,
                        max_depth=3, pathtrace=pathtrace)
    kernels.reset_launches()
    img_k, rays_k = rk.render(cam, p, 48, 32)
    assert kernels.LAUNCHES["traverse_packet16"] == 5 * p.spp
    assert kernels.LAUNCHES["traverse_packet"] == 0
    img_p, rays_p = rp.render(cam, p, 48, 32)
    img_8, rays_8 = r8.render(cam, p, 48, 32)
    assert rays_k == rays_p == rays_8
    np.testing.assert_allclose(img_k, img_p, atol=1e-5)
    np.testing.assert_allclose(img_k, img_8, atol=1e-5)


# ---- the predicate modes' slot classes (ops/pred_classes.py): K1 at
# widths 8 and 16 and K2 (flat and TLAS) with the computed classes and
# with every slot forced to CLS_TEST, against the plain walk

@pytest.fixture(scope="module")
def pred_class_tables():
    """The textured table of ``tests/test_torch_pred_classes.py`` (texels
    on both sides of the predicates' thresholds, negative and wrapped uv)
    in each walk's layout, on the card."""
    from tests.test_torch_pred_classes import table_scene
    from vortex_rt_tpu_torch.models import procedural as tproc
    from vortex_rt_tpu_torch.models.scene import Material as TMat

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    sc = table_scene(pt.Scene, tproc, TMat)
    out = {}
    for name, flat, width in (("k1w8", True, 8), ("k1w16", True, 16),
                              ("k2flat", True, 4), ("k2tlas", False, 4)):
        sb = sc.build(pt.RTConfig(flatten=flat))
        wa = WideArrays.from_scene(sb, width=width)
        out[name] = (wa.fuse() if width > 4 else wa).with_alpha(sb).to(dev)
    return out


@pytest.mark.parametrize("pred_name", ["checker", "perforated", "noalpha",
                                       "norule"])
@pytest.mark.parametrize("walk_name", ["k1w8", "k1w16", "k2flat",
                                       "k2tlas"])
def test_pred_classes_match_plain_version(cuda, pred_class_tables,
                                          walk_name, pred_name):
    """The predicate mode with its slot classes (kept, cut out, tested on
    the uv alone with the representative alpha, tested) and with every
    slot forced to ``CLS_TEST``: hits and per-ray steps equal to the
    plain walk's, which tests every candidate, in closest-hit and
    occlusion (K1: ``occl_split``) waves; one launch each."""
    from tests.test_torch_pred_classes import PREDS
    from vortex_rt_tpu_torch.ops import packet_walk as pw
    from vortex_rt_tpu_torch.ops import traverse_packet as tp

    wa = pred_class_tables[walk_name]
    pred = PREDS[pred_name]
    k1 = walk_name.startswith("k1")
    mod = tp if k1 else pw
    ref = tp.trace_packets_ref if k1 else pw.trace_packets_walk_ref
    name = ("traverse_packet16_pred" if walk_name == "k1w16" else
            "traverse_packet_pred" if k1 else "packet_walk_pred")
    cls = mod.pred_classes(wa, pred)
    assert sum(cls.counts[c] for c in ("kept", "cut", "uv")) > 0
    lanes = _camera_lanes(cuda, 72)
    o, d = torch.stack(lanes[:3], 1), torch.stack(lanes[3:], 1)
    n = o.shape[0]
    t = torch.full((n,), 6.0, device=cuda)
    for kw in ({}, dict(t_max=torch.where(
            torch.arange(n, device=cuda) < n // 2, t,
            torch.full_like(t, 1e30)), occl_split=n // 2) if k1 else
            dict(t_max=t, occlusion=True)):
        hp, sp = ref(wa, o, d, anyhit_pred=pred, **kw)
        for forced in (None, cls._replace(cls=torch.zeros_like(cls.cls))):
            before = kernels.LAUNCHES[name]
            hk, sk = mod.kernel_call(wa, o, d, anyhit_pred=pred,
                                     pred_cls=forced, **kw)()
            torch.cuda.synchronize()
            assert kernels.LAUNCHES[name] == before + 1
            for a, b in zip((*hk, sk), (*hp, sp)):
                assert torch.equal(a, b), (walk_name, pred_name, kw.keys(),
                                           forced is None)
    h0, _ = ref(wa, o, d)
    assert bool((h0.dist != hp.dist).any())  # the predicate rejects hits
