"""The port's any-hit path against the JAX package, on the cutout scene of
``tests/test_anyhit_inline.py`` (two checkered quads and a dark quad in
front of a sphere and a box: a ray can pass through up to three rejected
surfaces before an accepted hit).

* The alpha tables (``WideArrays.with_alpha``, and the fused rows that
  carry them, in both call orders) equal the JAX package's word for word.
* K1's and K2's plain alpha modes (``alpha_ref=0.35``) give the hits of
  the JAX ``trace_packets(alpha_ref=0.35)`` to the bit: 8-wide flattened
  in closest, occlusion and ``occl_split`` modes, 4-wide TLAS and
  flattened in closest and occlusion modes.  The JAX side runs in a
  subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (ROADMAP hazard H2).
* 48x48 frames with shadows, depth 2, against the JAX frames (in
  process, atol 1e-5, equal ray counts): ``alpha_test_anyhit`` in the
  walk (8-wide flattened and 4-wide TLAS) and ``stateless_anyhit``
  through the port's suspension engine (``packet_size=0``, K3 on the TLAS build) against
  the JAX in-walk predicate; and the port's in-walk frame against its own
  suspension frame (``packet_size=0``) within 2e-6, the JAX test's bound.
* ``render(mode="chunked")`` against the JAX chunked frame.
* ``load_texture`` on a PNG (every filter type) and a PPM written here,
  and a reduced ``textured_atrium`` whose tables equal the JAX build's.
"""

import os
import struct
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vortex_rt_tpu.engine import shaders as jsh
from vortex_rt_tpu.engine import wavefront as jwf
from vortex_rt_tpu.io import obj as jobj
from vortex_rt_tpu.models import bigscenes as jbig
from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu.models.scene import (
    Camera as JCam, Material as JMat, RenderParams as JParams,
    Scene as JScene,
)
from vortex_rt_tpu.ops import traverse_wide as jtw
from vortex_rt_tpu.utils.config import RTConfig as JCfg

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch import bridge
from vortex_rt_tpu_torch.engine import shaders as tsh
from vortex_rt_tpu_torch.io import obj as tobj
from vortex_rt_tpu_torch.models import bigscenes as tbig
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.models.scene import Material as TMat
from vortex_rt_tpu_torch.ops import traverse_wide as ttw
from vortex_rt_tpu_torch.ops.packet_walk import trace_packets_walk_ref
from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets_ref
from vortex_rt_tpu_torch.runtime import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THR = 0.35
EYE = ([0.15, -0.1, -3.0], [0, 0, 1], [0, 1, 0], 50.0, 1.0)
LIGHT = (0.5, 1.5, -1.0)
W = H = 48
WALKS = ("flat8/closest", "flat8/occlusion", "flat8/occl_split",
         "tlas4/closest", "tlas4/occlusion", "flat4/closest")


def _texture():
    """checkerboard_texture(n=4, c0=0xFFFFFF, c1=0x101010, cell=3)."""
    yy, xx = np.meshgrid(np.arange(12), np.arange(12), indexing="ij")
    return np.where(((xx // 3) + (yy // 3)) % 2 == 0, 0xFFFFFF,
                    0x101010).astype(np.uint32)


def cutout_scene(scene_cls, proc, mat_cls):
    """tests/test_anyhit_inline.py::_cutout_scene, with either package."""
    tex = _texture()
    sc = scene_cls()
    for mesh in (
            proc.quad((-1.5, -1.5, 0), (1.5, -1.5, 0), (1.5, 1.5, 0),
                      (-1.5, 1.5, 0), mat_cls(diffuse=(1, 1, 1),
                                              diffuse_tex=tex)),
            proc.quad((-2, -2, 1.0), (2, -2, 1.0), (2, 2, 1.0), (-2, 2, 1.0),
                      mat_cls(diffuse=(1, 1, 1), diffuse_tex=tex)),
            # dark and untextured (luminance < THR): always cut out
            proc.quad((-0.5, -0.5, 1.7), (0.5, -0.5, 1.7), (0.5, 0.5, 1.7),
                      (-0.5, 0.5, 1.7), mat_cls(diffuse=(0.1, 0.1, 0.1))),
            proc.uv_sphere((0, 0, 2.6), 0.8, 10, 14),
            proc.box((1.2, 1.0, 2.4), 0.5)):
        sc.add_instance(sc.add_mesh(mesh))
    return sc


def _jcfg(flat, **kw):
    return JCfg(flatten=flat, use_native_build=False, **kw)


def _tcfg(flat, **kw):
    return pt.RTConfig(flatten=flat, use_native_build=False, **kw)


@pytest.fixture(scope="module")
def builds():
    """(JAX scene buffers, port scene buffers) per build."""
    jsc = cutout_scene(JScene, jproc, JMat)
    tsc = cutout_scene(pt.Scene, tproc, TMat)
    return {flat: (jsc.build(_jcfg(flat)), tsc.build(_tcfg(flat)))
            for flat in (False, True)}


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


@pytest.mark.parametrize("order", ["tlas4", "alpha_then_fuse",
                                   "fuse_then_alpha"])
def test_alpha_tables_equal_jax(builds, order):
    """``with_alpha`` (and the fused rows that carry the alpha fields, in
    both call orders) word for word the JAX package's tables."""
    jsb, tsb = builds[order != "tlas4"]
    if order == "tlas4":
        jwa = jtw.WideArrays.from_scene(jsb).with_alpha(jsb)
        twa = ttw.WideArrays.from_scene(tsb).with_alpha(tsb)
        names = ("nodes", "tri_rows", "alpha_rows", "alpha_pool")
    else:
        jwa = jtw.WideArrays.from_scene(jsb, width=8)
        twa = ttw.WideArrays.from_scene(tsb, width=8)
        if order == "alpha_then_fuse":
            jwa, twa = jwa.with_alpha(jsb).fuse(), twa.with_alpha(tsb).fuse()
        else:
            jwa, twa = jwa.fuse().with_alpha(jsb), twa.fuse().with_alpha(tsb)
        names = ("nodes", "tri_rows", "fused", "alpha_rows", "alpha_pool")
        lmax = twa.tri_rows.shape[1] // 16
        assert twa.fused.shape[1] == 32 + 24 * lmax
    for name in names:
        a, b = _bits(getattr(jwa, name)), _bits(getattr(twa, name).numpy())
        assert a.shape == b.shape and np.array_equal(a, b), name
    np.testing.assert_array_equal(jwa.leaf_tids, twa.leaf_tids)
    # the pool ends with the materials' luminance: the dark quad's is
    # below the threshold, the checker's light cells above it
    pool = twa.alpha_pool.numpy()
    assert pool.min() < THR < pool.max()


# Runs in a fresh interpreter: the cutout scene's tables with the alpha
# fields, camera rays, and trace_packets(alpha_ref=THR) in each mode.
_JAX_WALKS = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, sys.argv[2])
from test_torch_anyhit import EYE, THR, cutout_scene
from vortex_rt_tpu.golden.renderer import generate_rays
from vortex_rt_tpu.models import procedural as proc
from vortex_rt_tpu.models.scene import Camera, Material, Scene
from vortex_rt_tpu.ops.traverse_packet import trace_packets
from vortex_rt_tpu.ops.traverse_wide import WideArrays
from vortex_rt_tpu.utils.config import RTConfig

sc = cutout_scene(Scene, proc, Material)
o, d = (np.asarray(a) for a in generate_rays(Camera.look_at(*EYE), 48, 48))
n = o.shape[0]
out = {"o": o, "d": d}
t_occ = np.full(n, 10.0, np.float32)
split_t = np.where(np.arange(n) < n // 2, np.float32(10.0),
                   np.float32(1e30)).astype(np.float32)
modes = {"closest": {}, "occlusion": dict(t_max=t_occ, occlusion=True),
         "occl_split": dict(t_max=split_t, occl_split=n // 2)}
for build, flat, width, names in (
        ("flat8", True, 8, ("closest", "occlusion", "occl_split")),
        ("tlas4", False, 4, ("closest", "occlusion")),
        ("flat4", True, 4, ("closest",))):
    sb = sc.build(RTConfig(flatten=flat, use_native_build=False))
    wa = WideArrays.from_scene(sb, width=width)
    if width == 8:
        wa = wa.fuse()
    wa = wa.with_alpha(sb)
    for k in ("nodes", "tri_rows", "alpha_rows", "alpha_pool") + (
            ("fused",) if width == 8 else ()):
        out[f"{build}/{k}"] = np.asarray(getattr(wa, k))
    for k in ("num_tlas", "max_leaf_tris", "depth", "tri_bits", "width"):
        out[f"{build}/{k}"] = np.int64(getattr(wa, k))
    for mode in names:
        kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in modes[mode].items()}
        for name, v in modes[mode].items():
            out[f"{build}/{mode}/arg/{name}"] = np.asarray(v)
        h, _ = trace_packets(wa, o, d, packet=64, alpha_ref=THR, **kw)
        h0, _ = trace_packets(wa, o, d, packet=64, **kw)
        for k in ("dist", "bx", "by", "tri", "inst"):
            out[f"{build}/{mode}/{k}"] = np.asarray(getattr(h, k))
        out[f"{build}/{mode}/dist_solid"] = np.asarray(h0.dist)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_walks_started(tmp_path_factory):
    """Starts the JAX walks' subprocess when the module's first test
    starts (it runs beside the table and frame tests, which come first);
    ``jax_walks`` waits for it."""
    path = tmp_path_factory.mktemp("alpha") / "jax_alpha.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_WALKS, str(path),
         os.path.join(REPO, "tests")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        yield proc, path
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_walks(_jax_walks_started):
    proc, path = _jax_walks_started
    out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _frames(builds, jtable, ttable, flat, **tkw):
    """(JAX image, JAX rays, port image, port rays) of one 48x48 frame."""
    jsb, tsb = builds[flat]
    params = dict(light_pos=LIGHT, max_depth=2, shadow=True)
    jr = jwf.WavefrontRenderer.from_buffers(jsb, _jcfg(flat),
                                            table=jsh.ShaderTable(
                                                anyhit=jtable))
    jimg, jrays = jr.render(JCam.look_at(*EYE), JParams(**params), W, H)
    tr = pt.WavefrontRenderer.from_buffers(
        tsb, _tcfg(flat, **tkw), tsh.ShaderTable(anyhit=ttable),
        device="cpu")
    timg, trays = tr.render(pt.Camera.look_at(*EYE),
                            pt.RenderParams(**params), W, H)
    return np.asarray(jimg), jrays, timg, trays


def _checker_pred_jax(u, v, alpha):
    cu = jnp.floor(u * 6.0).astype(jnp.int32)
    cv = jnp.floor(v * 6.0).astype(jnp.int32)
    return (((cu + cv) % 2) == 0) & (alpha >= 0.05)


def _checker_pred(u, v, alpha):
    """tests/test_anyhit_inline.py::_checker_pred in torch: a uv
    checkerboard cutout that also drops near-black surfaces."""
    cu = torch.floor(u * 6.0).to(torch.int32)
    cv = torch.floor(v * 6.0).to(torch.int32)
    return (((cu + cv) % 2) == 0) & (alpha >= 0.05)


@pytest.mark.parametrize("build", ["flat8", "tlas4"])
def test_alpha_frame_matches_jax(builds, build, monkeypatch):
    """``alpha_test_anyhit`` frames: the port's in-walk alpha (K1 or K2
    alpha mode, shadow rays included) against the JAX frame; on the TLAS
    build also against the port's own suspension frame (K3), within the
    JAX test's 2e-6; and the cutout changes the image."""
    flat = build == "flat8"
    jimg, jrays, timg, trays = _frames(
        builds, jsh.alpha_test_anyhit(THR), tsh.alpha_test_anyhit(THR),
        flat)
    assert trays == jrays
    np.testing.assert_allclose(timg, jimg, atol=1e-5)
    _, tsb = builds[flat]
    solid = pt.WavefrontRenderer.from_buffers(tsb, _tcfg(flat),
                                              device="cpu")
    simg, _ = solid.render(pt.Camera.look_at(*EYE), pt.RenderParams(
        light_pos=LIGHT, max_depth=2, shadow=True), W, H)
    assert np.abs(timg - simg).max() > 0.05
    if not flat:
        slow = pt.WavefrontRenderer.from_buffers(
            tsb, _tcfg(False, packet_size=0),
            tsh.ShaderTable(anyhit=tsh.alpha_test_anyhit(THR)),
            device="cpu")
        calls = []
        real = ttw.walk_lanes
        monkeypatch.setattr(
            "vortex_rt_tpu_torch.engine.wavefront.walk_lanes",
            lambda *a, **kw: calls.append(kw.get("suspend")) or real(*a, **kw))
        img_s, rays_s = slow.render(pt.Camera.look_at(*EYE), pt.RenderParams(
            light_pos=LIGHT, max_depth=2, shadow=True), W, H)
        assert rays_s == trays
        np.testing.assert_allclose(img_s, timg, atol=2e-6)
        # the pool path suspended, in several rounds
        assert calls.count(True) > 4


def test_stateless_frame_through_suspension_matches_jax(builds):
    """``stateless_anyhit`` with a uv-checker predicate: the port runs it
    through the suspension engine (``packet_size=0``: K3 on the TLAS
    build), the JAX package inside its walk; the same image and ray
    count.  (The port's in-walk frames: tests/test_torch_anyhit_pred.py.)"""
    jimg, jrays, timg, trays = _frames(
        builds, jsh.stateless_anyhit(_checker_pred_jax, "checker"),
        tsh.stateless_anyhit(_checker_pred, "checker"), False,
        packet_size=0)
    assert trays == jrays
    np.testing.assert_allclose(timg, jimg, atol=1e-5)


def test_chunked_render_matches_jax(builds):
    """``render(mode="chunked")``: the compacted pool traced by the
    per-ray walk, default shaders, no shadows; and a table it cannot
    shade warns and renders fused."""
    jsb, tsb = builds[False]
    jr = jwf.WavefrontRenderer.from_buffers(jsb, _jcfg(False, lanes=512))
    p = dict(light_pos=LIGHT, max_depth=2, spp=2)
    jimg, jrays = jr.render(JCam.look_at(*EYE), JParams(**p), 16, 16,
                            mode="chunked")
    tr = pt.WavefrontRenderer.from_buffers(tsb, _tcfg(False), device="cpu")
    before = kernels.LAUNCHES["traverse_wide"]
    timg, trays = tr.render(pt.Camera.look_at(*EYE), pt.RenderParams(**p),
                            16, 16, mode="chunked")
    assert trays == jrays
    np.testing.assert_allclose(timg, np.asarray(jimg), atol=1e-5)
    assert kernels.LAUNCHES["traverse_wide"] == before  # CPU: plain walk
    with pytest.warns(UserWarning, match="chunked"):
        img_f, rays_f = tr.render(pt.Camera.look_at(*EYE), pt.RenderParams(
            shadow=True, **p), 16, 16, mode="chunked")
    img_d, rays_d = tr.render(pt.Camera.look_at(*EYE), pt.RenderParams(
        shadow=True, **p), 16, 16)
    assert rays_f == rays_d and np.array_equal(img_f, img_d)


def test_any_hit_routes_and_refusals(builds):
    """Which route each shader takes, and what no route runs."""
    from vortex_rt_tpu_torch.engine import wavefront as twf

    _, flat_sb = builds[True]
    _, tlas_sb = builds[False]
    alpha = tsh.ShaderTable(anyhit=tsh.alpha_test_anyhit(THR))
    pred = tsh.ShaderTable(anyhit=tsh.stateless_anyhit(_checker_pred))
    plain = tsh.ShaderTable(anyhit=lambda ctx, sp, ray, pl: torch.ones_like(
        sp.mat, dtype=torch.int32))
    r = pt.WavefrontRenderer.from_buffers(flat_sb, _tcfg(True), alpha,
                                          device="cpu")
    assert r.wa.alpha_rows is not None
    assert twf._route(alpha, r.wa, 256) == ("walk", THR)
    with pytest.raises(ValueError, match="4-wide"):
        twf._route(alpha, r.wa, 0)  # the per-ray walk is 4-wide
    t = pt.WavefrontRenderer.from_buffers(tlas_sb, _tcfg(False), pred,
                                          device="cpu")
    # a stateless predicate runs inside the walk (K2's predicate mode) on
    # the TLAS build, as in the JAX package, and by suspension at packet 0
    route, inline = twf._route(pred, t.wa, 256)
    assert route == "walk" and inline.fn is _checker_pred
    assert twf._route(pred, t.wa, 0) == ("pool", None)
    assert twf._route(alpha, t.wa, 0) == ("pool", None)
    assert twf._route(alpha, t.wa, 256) == ("walk", THR)
    assert twf._route(plain, t.wa, 256) == ("pool", None)
    # and inside K1's predicate mode on the flattened build
    f = pt.WavefrontRenderer.from_buffers(flat_sb, _tcfg(True), pred,
                                          device="cpu")
    assert f.wa.alpha_rows is not None
    route, inline = twf._route(pred, f.wa, 256)
    assert route == "walk" and inline.fn is _checker_pred
    with pytest.raises(ValueError, match="TLAS"):
        pt.WavefrontRenderer.from_buffers(
            flat_sb, _tcfg(True, bvh_width=4), plain, device="cpu")
    with pytest.raises(ValueError, match="4-wide"):
        pt.WavefrontRenderer.from_buffers(flat_sb,
                                          _tcfg(True, packet_size=0),
                                          device="cpu")


def _png_bytes(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG of ``img`` (H, W, C), C in 1, 3, 4; row y filtered
    with ``filters[y % len(filters)]`` (0 none ... 4 Paeth)."""
    h, w, nch = img.shape
    coltype = {1: 0, 3: 2, 4: 6}[nch]
    raw = bytearray()
    prev = np.zeros(w * nch, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(nch, np.int32), cur[:-nch]])
        upleft = np.concatenate([np.zeros(nch, np.int32), prev[:-nch]])
        f = filters[y % len(filters)]
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - ((left + prev) >> 1)
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            enc = cur - pred
        raw += bytes([f]) + (enc & 255).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, coltype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("fmt", ["png_rgb", "png_rgba", "png_gray", "ppm"])
def test_load_texture_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(3)
    nch = {"png_rgb": 3, "png_rgba": 4, "png_gray": 1, "ppm": 3}[fmt]
    img = rng.integers(0, 256, (7, 9, nch), dtype=np.uint8)
    if fmt == "ppm":
        path = tmp_path / "t.ppm"
        path.write_bytes(b"P6\n# texture\n9 7\n255\n" + img.tobytes())
    else:
        path = tmp_path / "t.png"
        path.write_bytes(_png_bytes(img, (0, 1, 2, 3, 4)))
    got = tobj.load_texture(str(path))
    want = jobj.load_texture(str(path))
    assert got.dtype == np.uint32 and got.shape == (7, 9)
    np.testing.assert_array_equal(got, want)
    rgb = img if nch >= 3 else np.repeat(img, 3, axis=-1)
    np.testing.assert_array_equal(got >> 16, rgb[..., 0])
    with pytest.raises(ValueError, match="unsupported"):
        tobj.load_texture(str(tmp_path / "t.bmp"))


def test_textured_atrium_tables_equal_jax():
    """A reduced textured atrium (the checker stands in for absent
    assets): the same meshes, texel pool and alpha-carrying fused
    tables as the JAX package's."""
    kw = dict(n_cols=2, target_tris=3000)
    jsc, tsc = JScene(), pt.Scene()
    for (jm, jr), (tm, tr) in zip(jbig.textured_atrium(**kw),
                                  tbig.textured_atrium(**kw)):
        jsc.add_instance(jsc.add_mesh(jm), reflectivity=jr)
        tsc.add_instance(tsc.add_mesh(tm), reflectivity=tr)
    jsb, tsb = jsc.build(_jcfg(True)), tsc.build(_tcfg(True))
    np.testing.assert_array_equal(jsb.texels, tsb.texels)
    jwa = jtw.WideArrays.from_scene(jsb, width=8).fuse().with_alpha(jsb)
    twa = ttw.WideArrays.from_scene(tsb, width=8).fuse().with_alpha(tsb)
    for name in ("fused", "alpha_rows", "alpha_pool"):
        assert np.array_equal(_bits(getattr(jwa, name)),
                              _bits(getattr(twa, name).numpy())), name
    assert tsb.num_tris == jsb.num_tris > 3000


def test_kernel_digest_follows_included_headers(tmp_path):
    """The build key of a kernel library hashes the headers its source
    includes (and theirs): editing one rebuilds, as editing the source
    does.  K1's and K2's sources include the alpha test's header."""
    src, hdr, inner = (tmp_path / "k.cu", tmp_path / "a.cuh",
                       tmp_path / "b.cuh")
    inner.write_text("int b;\n")
    hdr.write_text('#include "b.cuh"\nint a;\n')
    src.write_text('#include <stdint.h>\n#include "a.cuh"\nint k;\n')
    assert kernels.includes(src) == sorted([hdr.resolve(), inner.resolve()])
    d0 = kernels._digest(src)
    assert kernels._digest(src) == d0
    inner.write_text("int b = 1;\n")
    d1 = kernels._digest(src)
    hdr.write_text('#include "b.cuh"\nint a = 1;\n')
    assert len({d0, d1, kernels._digest(src)}) == 3
    header = (kernels.SRC_DIR / "alpha_test.cuh").resolve()
    for name in ("traverse_packet", "packet_walk"):
        assert header in kernels.includes(kernels.SRC_DIR / f"{name}.cu")
    assert kernels.includes(kernels.SRC_DIR / "traverse_wide.cu") == []


@pytest.mark.parametrize("case", WALKS)
def test_alpha_walk_matches_jax(jax_walks, case):
    """K1's (8-wide) and K2's (4-wide) plain alpha modes against the JAX
    ``trace_packets(alpha_ref)``: every hit field to the bit; the cutout
    rejects many candidates."""
    ref = jax_walks
    build, mode = case.split("/")
    wa = bridge.wide_arrays(
        ref[f"{build}/nodes"], ref[f"{build}/tri_rows"], device="cpu",
        fused=ref.get(f"{build}/fused"),
        alpha_rows=ref[f"{build}/alpha_rows"],
        alpha_pool=ref[f"{build}/alpha_pool"],
        **{k: int(ref[f"{build}/{k}"]) for k in (
            "num_tlas", "max_leaf_tris", "depth", "tri_bits", "width")})
    pre = f"{build}/{mode}/arg/"
    kw = {k[len(pre):]: torch.from_numpy(v) for k, v in ref.items()
          if k.startswith(pre)}
    if mode == "occlusion":
        kw["occlusion"] = True
    if mode == "occl_split":
        kw["occl_split"] = ref["o"].shape[0] // 2
    walk = trace_packets_ref if wa.width == 8 else trace_packets_walk_ref
    o, d = torch.from_numpy(ref["o"]), torch.from_numpy(ref["d"])
    hits, _ = walk(wa, o, d, alpha_ref=THR, **kw)
    for k in ("dist", "bx", "by", "tri", "inst"):
        got = getattr(hits, k).numpy()
        want = ref[f"{build}/{mode}/{k}"]
        if mode != "closest" and k != "dist":
            continue  # occlusion lanes carry no hit record
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), k
    changed = (ref[f"{build}/{mode}/dist"]
               != ref[f"{build}/{mode}/dist_solid"]).sum()
    assert changed > 50
