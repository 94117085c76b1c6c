"""The port's multi-device rendering by image row blocks
(``vortex_rt_tpu_torch/parallel/tiles.py``) on gloo ranks on the CPU,
against the JAX ``parallel.tiles`` on conftest's 8 virtual devices and
against the port's single-device frames.

Each world size (2 and 4 ranks) is one launch of processes
(``parallel/launch.spawn``: spawned, a ``file://`` store under pytest's
temporary directory, one torch thread a rank) that runs every case of the
module and returns each rank's results; the JAX images are computed once
in the pytest process.  Cases on the test_parallel.py Cornell scene at
32x24, depth 2:

* the tiled megakernel (``render_tiled``): the JAX tiled image within the
  JAX test's own gate (at most 1% of pixels off by more than 1e-4, seam
  ties) with equal rays, and the port's single-device megakernel frame
  within 1e-5;
* the tiled wavefront frame (``render_tiled_wavefront``, 4-wide TLAS
  through K2's plain version): the JAX tiled image within its gate (at
  most 2% of pixels) with equal rays, and the single-device frame within
  1e-5;
* the tiled wavefront frame of a flattened build (8-wide fused rows
  through K1's plain version) with shadow rays, path tracing, spp 2 and
  depth 3: the single-device frame within 1e-5, equal rays;
* at 2 ranks, ``dryrun`` (the JAX package's multi-device check: Cornell
  frames, an atrium-class frame against the golden oracle, its two-shard
  frames against the replicated one).

Every rank holds the same gathered image and totals.  Also: a rank that
raises fails the launch; the renderer refuses a device list and names
the multi-device modules; ``Mesh`` needs a process group, and a rank
finds no card on the CPU unless it is given one.
"""

import numpy as np
import pytest
import torch

from vortex_rt_tpu.engine import wavefront as jwf
from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu.models.scene import (
    Camera as JCam, RenderParams as JParams, Scene as JScene,
)
from vortex_rt_tpu.parallel import tiles as jtiles

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch.engine.megakernel import MegakernelRenderer
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.parallel import launch, mesh as tmesh, tiles

W, H = 32, 24
EYE = ([0.11, 0.07, -3.2], [0.02, -0.01, 0], [0, 1, 0], 45.0, W / H)
LIGHT = (0, 0.8, -0.5)
WORLDS = (2, 4)


def _cornell(sc, proc):
    for mesh, refl in proc.cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    return sc


def _port_cases():
    """(name, function, args, kwargs, single-device reference)."""
    sb = _cornell(pt.Scene(), tproc).build()
    cam = pt.Camera.look_at(*EYE)
    p = pt.RenderParams(light_pos=LIGHT, max_depth=2)
    flat = pt.RTConfig(flatten=True)
    sc_pt = _cornell(pt.Scene(), tproc)
    sc_pt.add_instance(sc_pt.add_mesh(tproc.uv_sphere((0, -0.3, 0), 0.35, 8,
                                                      12)), reflectivity=0.5)
    sb_pt = sc_pt.build(flat)
    p_pt = pt.RenderParams(light_pos=LIGHT, max_depth=3, spp=2, shadow=True,
                           pathtrace=True)
    return [
        ("mk", tiles.render_tiled, (sb, cam, p, W, H),
         MegakernelRenderer.from_buffers(sb, device="cpu").render(
             cam, p, W, H)),
        ("wf", tiles.render_tiled_wavefront, (sb, cam, p, W, H),
         pt.WavefrontRenderer.from_buffers(sb, device="cpu").render(
             cam, p, W, H)),
        ("pt8", tiles.render_tiled_wavefront, (sb_pt, cam, p_pt, W, H),
         pt.WavefrontRenderer.from_buffers(sb_pt, flat, device="cpu")
         .render(cam, p_pt, W, H)),
    ]


@pytest.fixture(scope="module")
def port():
    return _port_cases()


@pytest.fixture(scope="module")
def jax_images():
    """The JAX tiled frames over conftest's 8 virtual devices."""
    sb = _cornell(JScene(), jproc).build()
    cam = JCam.look_at(*EYE)
    p = JParams(light_pos=LIGHT, max_depth=2)
    return {"mk": jtiles.render_tiled(sb, cam, p, W, H),
            "wf": jtiles.render_tiled_wavefront(sb, cam, p, W, H,
                                                chunk=32)}


@pytest.fixture(scope="module")
def launches(port, tmp_path_factory):
    """world -> every rank's results of every case, one launch a world
    (made at its first use, then kept)."""
    done = {}

    def get(world):
        if world not in done:
            calls = [(f, a, {"device": "cpu"}) for _, f, a, _ in port]
            if world == 2:
                calls.append((tiles.dryrun, (2,), {"device": "cpu"}))
            done[world] = launch.spawn(
                launch.call_all, world, (calls,), threads=1,
                store_dir=str(tmp_path_factory.mktemp("store")),
                timeout=600)
        return done[world]

    return get


def _case(res, port, name):
    k = [c[0] for c in port].index(name)
    got = [r[k] for r in res]
    for g in got[1:]:  # every rank gathered the same frame
        np.testing.assert_array_equal(g[0], got[0][0])
        assert g[1] == got[0][1]
    return got[0], port[k][3]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,bad_share", [("mk", 0.01), ("wf", 0.02)])
def test_tiled_matches_jax_and_one_device(launches, port, jax_images, world,
                                          name, bad_share):
    (img, rays), (ref, ref_rays) = _case(launches(world), port, name)
    jimg, jrays = jax_images[name]
    assert img.shape == (H, W, 3) and img.dtype == np.float32
    assert rays == jrays == ref_rays
    bad = np.abs(img - jimg).max(-1) > 1e-4
    assert bad.mean() < bad_share
    np.testing.assert_allclose(img, ref, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_tiled_pathtraced_8wide_matches_one_device(launches, port, world):
    (img, rays), (ref, ref_rays) = _case(launches(world), port, "pt8")
    assert rays == ref_rays and rays > W * H * 2
    np.testing.assert_allclose(img, ref, atol=1e-5)


def test_dryrun(launches):
    """The multi-device check passed on every rank of the 2-rank launch."""
    assert all(r[-1] is None for r in launches(2))


def test_a_failing_rank_fails_the_launch(tmp_path):
    calls = [(int, ("not a number",), {})]
    with pytest.raises(Exception, match="not a number"):
        launch.spawn(launch.call_all, 2, (calls,), threads=1,
                     store_dir=str(tmp_path), timeout=300)


def test_renderer_refuses_a_device_list():
    sb = _cornell(pt.Scene(), tproc).build()
    with pytest.raises(NotImplementedError, match="parallel.tiles") as e:
        pt.WavefrontRenderer.from_buffers(sb, device=["cpu", "cpu"])
    assert "parallel.shards" in str(e.value)
    assert pt.RTConfig().mesh_axes == ("tiles",)


def test_mesh_needs_a_process_group_and_a_device(monkeypatch):
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.Mesh.create(("tiles",), device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.default_device()


def test_rays_for_rows_are_the_megakernel_rays():
    from vortex_rt_tpu_torch.engine.megakernel import (
        CameraArrays, generate_camera_rays,
    )

    cam = CameraArrays.from_camera(pt.Camera.look_at(*EYE), "cpu")
    o, d = generate_camera_rays(cam, W, H)
    rows = torch.arange(6, 18)
    ob, db = tiles.rays_for_rows(cam, W, H, rows)
    assert torch.equal(db, d.reshape(H, W, 3)[6:18].reshape(-1, 3))
    assert torch.equal(ob, o.reshape(H, W, 3)[6:18].reshape(-1, 3))
    jo, jd = jtiles.rays_for_rows(
        jwf.CameraArrays.from_camera(JCam.look_at(*EYE)), W, H,
        np.arange(6, 18))
    np.testing.assert_allclose(db.numpy(), np.asarray(jd), atol=1e-7)
