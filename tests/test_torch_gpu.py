"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the 4-wide walk (K2), the 8-wide fused walk (K1) and the chained
row-fetch probe (K7).

Needs a CUDA device and nvcc; skips without a card.  It imports neither
JAX nor the JAX package, so it also runs on a machine without JAX — with
``--noconftest``, since ``tests/conftest.py`` imports JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch.models.bigscenes import blob
from vortex_rt_tpu_torch.models.procedural import box, cornell_box, uv_sphere
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


@pytest.mark.parametrize("k", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("words", [4, 24, 128])
def test_k7_kernel_matches_plain_version(cuda, k, words):
    tab = hw.make_table(4096, cuda)
    before = kernels.LAUNCHES["hbm_walk"]
    got = hw.run_walks(tab, 300, k, words)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hbm_walk"] == before + 1
    assert torch.equal(got, hw.run_walks_ref(tab, 300, k, words))

