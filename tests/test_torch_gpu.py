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
from vortex_rt_tpu_torch.models.procedural import box, cornell_box, uv_sphere
from vortex_rt_tpu_torch.ops.packet_walk import (
    trace_packets_walk, trace_packets_walk_ref,
)
from vortex_rt_tpu_torch.ops.traverse_packet import (
    trace_packets, trace_packets_ref,
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


@pytest.mark.parametrize("k", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("words", [4, 24, 128])
def test_k7_kernel_matches_plain_version(cuda, k, words):
    tab = hw.make_table(4096, cuda)
    before = kernels.LAUNCHES["hbm_walk"]
    got = hw.run_walks(tab, 300, k, words)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hbm_walk"] == before + 1
    assert torch.equal(got, hw.run_walks_ref(tab, 300, k, words))

