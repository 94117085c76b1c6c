"""The port's megakernel renderer (``engine/megakernel.py`` on the CPU: the
plain walk ``trace_rays_ref`` and the shader body in torch ops) against
the JAX package's ``render_megakernel``, the threefry jitter against
``jax.random``, and the port's golden oracle (``golden/renderer.py``)
against the JAX package's.

Frames are 32x32 at depth 3: the Cornell box with its mirror sphere
under a camera that is not axis-aligned, at spp 1 and spp 2 (threefry
jitter), and a textured quad behind a reflective sphere.  Tolerances:
equal ray counts, and every pixel within 1e-5 (the JAX frame is jitted
in this process, where XLA may contract a product into an FMA, so
floats may differ in the last bits).  Under an axis-aligned camera rays
graze wall seams where two walls meet at the same distance, and which
wins can flip with a last-bit change: there at most 1% of the pixels
may differ by more than 1e-5, as ``tests/test_megakernel.py`` allows the
JAX frame against its oracle (no RMSE bound: one flipped seam pixel of
a 32x32 frame, a wall's colour against another's, alone gives an RMSE
near 3e-3).

The golden functions are NumPy on both sides and must agree to the bit,
except ``render_golden_pt``'s cosine lobe, whose sin and cos are
NumPy's on both sides too: equal to the bit as well."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vortex_rt_tpu.engine import megakernel as jmk
from vortex_rt_tpu.golden import renderer as jgold
from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu.models import scene as jscene
from vortex_rt_tpu.utils.config import RTConfig as JConfig
from vortex_rt_tpu_torch.engine import megakernel as tmk
from vortex_rt_tpu_torch.golden import renderer as tgold
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.models import scene as tscene
from vortex_rt_tpu_torch.utils import prng
from vortex_rt_tpu_torch.utils.config import RTConfig as TConfig

SIZE = 32
EYE = ([0.11, 0.07, -3.2], [0.02, -0.01, 0], [0, 1, 0], 45.0, 1.0)
EYE_ALIGNED = ([0, 0, -3.2], [0, 0, 0], [0, 1, 0], 45.0, 1.0)
LIGHT = (0, 0.8, -0.5)
TEX = jproc.checkerboard_texture(8, 0xFFFFFF, 0x303030, cell=3)


def _build(pkg, name):
    """The same scene built by the JAX package (pkg "jax") or the port."""
    proc, scene = (jproc, jscene) if pkg == "jax" else (tproc, tscene)
    cfg = (JConfig if pkg == "jax" else TConfig)(use_native_build=False)
    sc = scene.Scene()
    if name == "cornell":
        for mesh, refl in proc.cornell_box():
            sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    else:
        sc.add_instance(sc.add_mesh(proc.quad(
            (-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0),
            scene.Material(diffuse_tex=TEX))))
        sc.add_instance(sc.add_mesh(proc.uv_sphere(
            (0, 0.2, -0.8), 0.35, 10, 14,
            scene.Material(diffuse=(0.9, 0.4, 0.2)))), reflectivity=0.5)
    return sc.build(cfg)


@pytest.fixture(scope="module")
def scenes():
    return {(pkg, name): _build(pkg, name) for pkg in ("jax", "torch")
            for name in ("cornell", "textured")}


def _frames(scenes, name, eye, spp, light=LIGHT):
    jr = jmk.MegakernelRenderer.from_buffers(scenes["jax", name])
    tr = tmk.MegakernelRenderer.from_buffers(scenes["torch", name],
                                             device="cpu")
    jimg, jn = jr.render(jscene.Camera.look_at(*eye),
                         jscene.RenderParams(light_pos=light, max_depth=3,
                                             spp=spp), SIZE, SIZE)
    timg, tn = tr.render(tscene.Camera.look_at(*eye),
                         tscene.RenderParams(light_pos=light, max_depth=3,
                                             spp=spp), SIZE, SIZE)
    return np.asarray(jimg), jn, timg, tn


@pytest.mark.parametrize("name,spp,light", [
    ("cornell", 1, LIGHT), ("cornell", 2, LIGHT), ("textured", 1, (1, 2, -3))])
def test_frame_equals_jax(scenes, name, spp, light):
    jimg, jn, timg, tn = _frames(scenes, name, EYE, spp, light)
    assert tn == jn and tn > SIZE * SIZE * spp  # bounce waves traced rays
    assert timg.shape == (SIZE, SIZE, 3) and np.isfinite(timg).all()
    assert np.abs(timg - jimg).max() <= 1e-5


def test_aligned_camera_seam_tolerance(scenes):
    jimg, jn, timg, tn = _frames(scenes, "cornell", EYE_ALIGNED, 1)
    assert tn == jn
    bad = np.abs(timg - jimg).max(-1) > 1e-5
    assert bad.mean() <= 0.01


def test_camera_rays_equal_jax():
    """Primary rays with and without jitter, to the bit."""
    jcam = jmk.CameraArrays.from_camera(jscene.Camera.look_at(*EYE))
    tcam = tmk.CameraArrays.from_camera(tscene.Camera.look_at(*EYE), "cpu")
    jit = np.random.default_rng(2).random((SIZE, SIZE + 3, 2),
                                          dtype=np.float32)
    for j in (None, jit):
        jo, jd = jmk.generate_camera_rays(
            jcam, SIZE + 3, SIZE, None if j is None else jnp.asarray(j))
        to, td = tmk.generate_camera_rays(
            tcam, SIZE + 3, SIZE, None if j is None else torch.from_numpy(j))
        for a, b in ((jo, to), (jd, td)):
            assert (np.asarray(a).view(np.int32)
                    == b.numpy().view(np.int32)).all()


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_threefry_jitter_equals_jax_random(seed):
    """PRNGKey, split and uniform, as ``render_megakernel`` draws them,
    bit for bit."""
    key, k = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert tuple(np.asarray(key).tolist()) == k
    for _ in range(3):
        key, k2 = jax.random.split(key)
        k, t2 = prng.split(k)
        assert tuple(np.asarray(key).tolist()) == k
        assert tuple(np.asarray(k2).tolist()) == t2
        a = np.asarray(jax.random.uniform(k2, (SIZE, SIZE + 5, 2)))
        b = prng.uniform(t2, (SIZE, SIZE + 5, 2), "cpu").numpy()
        assert (a.view(np.int32) == b.view(np.int32)).all()


def _same(a, b, label):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, label
    assert (a.view(np.uint8) == b.view(np.uint8)).all(), label


def test_golden_equals_jax(scenes):
    """brute_force_hits, render_golden (with bounces), generate_rays and
    sample_pixel_parity of the port equal the JAX package's."""
    for name in ("cornell", "textured"):
        jsb, tsb = scenes["jax", name], scenes["torch", name]
        jcam, tcam = (m.Camera.look_at(*EYE) for m in (jscene, tscene))
        jp, tp = (m.RenderParams(light_pos=LIGHT, max_depth=3)
                  for m in (jscene, tscene))
        jr, tr = jgold.generate_rays(jcam, 24, 20), tgold.generate_rays(
            tcam, 24, 20)
        for a, b in zip(jr, tr):
            _same(a, b, "rays")
        jh = jgold.brute_force_hits(*jr, jsb)
        th = tgold.brute_force_hits(*tr, tsb)
        for k in jh:
            _same(jh[k], th[k], f"hits {k}")
        _same(jgold.render_golden(jsb, jcam, jp, 24, 20),
              tgold.render_golden(tsb, tcam, tp, 24, 20), "render_golden")
        img = np.asarray(jgold.render_golden(jsb, jcam, jp, 24, 20))
        assert (jgold.sample_pixel_parity(jsb, jcam, jp, 24, 20, img, n=64)
                == tgold.sample_pixel_parity(tsb, tcam, tp, 24, 20, img,
                                             n=64))


def test_golden_pathtrace_equals_jax(scenes):
    """render_golden_pt replays the path tracer's streams: the port's
    replay (integer streams from the port's sampler, the cosine lobe in
    NumPy) equals the JAX package's to the bit, with shadow rays."""
    jsb, tsb = scenes["jax", "cornell"], scenes["torch", "cornell"]
    jcam, tcam = (m.Camera.look_at(*EYE) for m in (jscene, tscene))
    jp, tp = (m.RenderParams(light_pos=LIGHT, max_depth=3, spp=2,
                             shadow=True, pathtrace=True)
              for m in (jscene, tscene))
    pix = np.arange(0, 16 * 16, 7)
    _same(jgold.render_golden_pt(jsb, jcam, jp, 16, 16, seed=3, pixels=pix),
          tgold.render_golden_pt(tsb, tcam, tp, 16, 16, seed=3, pixels=pix),
          "render_golden_pt")
