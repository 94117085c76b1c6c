"""The port's OBJ/MTL/texture loaders, scene placement, procedural
texture and configuration against the JAX package's, on the same files
(written to ``tmp_path``) and the same inputs.

Every case of ``tests/test_obj.py`` (quads and negative indices, normals
and uvs, MTL and ``usemtl``, PPM and PNG textures, texture binding, faces
before ``usemtl``) plus ``load_obj_scene``, an n-gon, faces mixing corners
with and without ``vt``/``vn``, and an unsupported texture format:
each loaded mesh equals the JAX one field by field, to the bit (both
parse with Python floats and store float32), and the test's own
assertions hold on the port's mesh.  ``Scene.arrange_around_y`` and
``Scene.apply_transform`` (NumPy float32 on both sides) equal to the bit;
``checkerboard_texture`` exactly; ``RTConfig.as_dict()`` is a subset of
the JAX dict with equal values, on defaults and after ``from_overrides``.
"""

import dataclasses
import struct
import zlib

import numpy as np
import pytest

from vortex_rt_tpu.io import obj as jobj
from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu.models.scene import Scene as JScene
from vortex_rt_tpu.utils import config as jcfg
from vortex_rt_tpu.utils.image import write_ppm

from vortex_rt_tpu_torch.io import obj as tobj
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.models.scene import Scene as TScene
from vortex_rt_tpu_torch.utils import config as tcfg

_MESH_FIELDS = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                "mat_id")


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def _same_material(a, b):
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "diffuse_tex":
            assert (va is None) == (vb is None)
            if vb is not None:
                assert va.dtype == vb.dtype
                np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb, f.name


def _same_mesh(m_port, m_jax):
    for f in _MESH_FIELDS:
        a, b = getattr(m_port, f), getattr(m_jax, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(m_port.materials) == len(m_jax.materials)
    for a, b in zip(m_port.materials, m_jax.materials):
        _same_material(a, b)


def _png(path, rows, width, height, coltype=2):
    raw = b"".join(b"\x00" + bytes(r) for r in rows)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, coltype, 0, 0, 0)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


# name -> (files {name: text}, the OBJ to load, the test_obj.py checks)
def _check_simple(m):
    assert m.num_tris == 2
    np.testing.assert_allclose(m.v0[0], [0, 0, 0])
    np.testing.assert_allclose(np.abs(m.n0[:, 2]), 1.0, atol=1e-6)


def _check_quad(m):
    assert m.num_tris == 2  # fan triangulation


def _check_normals_uvs(m):
    np.testing.assert_allclose(m.n0[0], [0, 0, 1])
    np.testing.assert_allclose(m.uv1[0], [1, 0])


def _check_mtl(m):
    assert len(m.materials) == 2
    assert m.materials[0].diffuse == (1.0, 0.0, 0.0)
    assert m.materials[0].shininess == 32
    assert m.materials[1].diffuse == (0.0, 0.0, 1.0)
    assert m.mat_id.tolist() == [0, 1]


def _check_before_usemtl(m):
    assert m.materials[m.mat_id[0]].diffuse == (0.8, 0.8, 0.8)
    assert m.materials[m.mat_id[1]].diffuse == (0.0, 0.0, 1.0)


def _check_binding(m):
    assert m.materials[0].diffuse_tex is not None
    assert m.materials[0].diffuse_tex.shape == (2, 2)


def _check_ngon(m):
    assert m.num_tris == 3
    # the fan (0, k, k + 1): every triangle starts at the first corner
    np.testing.assert_array_equal(m.v0, np.zeros((3, 3), np.float32))
    np.testing.assert_array_equal(m.v2[:, 0], [1.0, 0.5, 0.0])


def _check_mixed(m):
    # corners without vn take the face's flat normal, without vt (0, 0)
    assert m.num_tris == 3
    np.testing.assert_array_equal(m.uv0[1], [0.0, 0.0])
    np.testing.assert_allclose(np.abs(m.n0[1, 2]), 1.0, atol=1e-6)
    np.testing.assert_array_equal(m.n0[0], [0.0, 0.0, 1.0])


CASES = {
    "simple": ({"tri.obj": "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
                           "f 1 2 3\nf 2 4 3\n"}, "tri.obj", _check_simple),
    "quad_negative": ({"quad.obj": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                                   "f -4 -3 -2 -1\n"}, "quad.obj",
                      _check_quad),
    "normals_uvs": ({"full.obj": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\n"
                                 "vt 1 0\nvt 0 1\nvn 0 0 1\n"
                                 "f 1/1/1 2/2/1 3/3/1\n"}, "full.obj",
                    _check_normals_uvs),
    "mtl_usemtl": ({"m.mtl": "newmtl red\nKd 1 0 0\nKa 0.1 0 0\nNs 32\n"
                             "newmtl blue\nKd 0 0 1\n",
                    "two.obj": "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                               "usemtl red\nf 1 2 3\nusemtl blue\n"
                               "f 3 2 1\n"}, "two.obj", _check_mtl),
    "before_usemtl": ({"m.mtl": "newmtl glass\nKd 0 0 1\n",
                       "pre.obj": "mtllib m.mtl\nv 0 0 0\nv 1 0 0\n"
                                  "v 0 1 0\nf 1 2 3\nusemtl glass\n"
                                  "f 3 2 1\n"}, "pre.obj",
                      _check_before_usemtl),
    "texture_binding": ({"m.mtl": "newmtl wood\nKd 0.5 0.5 0.5\n"
                                  "map_Kd wood.ppm\n",
                         "t.obj": "mtllib m.mtl\nv 0 0 0\nv 1 0 0\n"
                                  "v 0 1 0\nusemtl wood\nf 1 2 3\n"},
                        "t.obj", _check_binding),
    "ngon": ({"p.obj": "# a pentagon\nv 0 0 0\nv 1 0 0\nv 1 1 0\n"
                       "v 0.5 1.5 0\nv 0 1 0\nf 1 2 3 4 5\n"}, "p.obj",
             _check_ngon),
    "mixed_corners": ({"x.mtl": "newmtl a\nKd 0.2 0.3 0.4\nKs 1 1 1\n"
                                "Ke 0 0 0.5\nNi 1.5\nd 0.5\nillum 3\n"
                                "newmtl b\nTr 0.25\nmap_Kd tex.bmp\n",
                       "x.obj": "mtllib x.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                                "v 1 1 0\nvt 0.25 0.75\nvt 0.5 0.5\n"
                                "vn 0 0 1\nusemtl b\nf 1/1/1 2/2/1 3//1\n"
                                "usemtl a\nf 2 4 3\nf -3/-1 -2 -1/-2\n"},
                      "x.obj", _check_mixed),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_obj_matches_jax(tmp_path, case):
    files, name, check = CASES[case]
    write_ppm(str(tmp_path / "wood.ppm"), np.full((2, 2, 3), 128, np.uint8))
    (tmp_path / "tex.bmp").write_bytes(b"BM")
    for fname, text in files.items():
        _write(tmp_path / fname, text)
    m_port = tobj.load_obj(str(tmp_path / name))
    _same_mesh(m_port, jobj.load_obj(str(tmp_path / name)))
    check(m_port)


def test_load_mtl_matches_jax(tmp_path):
    write_ppm(str(tmp_path / "wood.ppm"), np.full((2, 2, 3), 64, np.uint8))
    _write(tmp_path / "sub.mtl", "# comment\nKd 1 1 1\nnewmtl two words\n"
                                 "Kd 0.1 0.2 0.3\nmap_Kd -s 1 1 wood.ppm\n"
                                 "newmtl missing_tex\nmap_Kd none.png\n")
    a = tobj.load_mtl(str(tmp_path / "sub.mtl"))
    b = jobj.load_mtl(str(tmp_path / "sub.mtl"))
    assert list(a) == list(b) == ["two words", "missing_tex"]
    for k in b:
        _same_material(a[k], b[k])
    assert a["two words"].diffuse_tex.shape == (2, 2)


@pytest.mark.parametrize("token,count", [
    ("", 5), ("1", 5), ("5", 5), ("-1", 5), ("-5", 5), ("3", 0)])
def test_parse_index_matches_jax(token, count):
    assert tobj._parse_index(token, count) == jobj._parse_index(token, count)


def test_texture_ppm_and_png(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    img[..., 0] = 255
    write_ppm(str(tmp_path / "t.ppm"), img)
    _png(tmp_path / "t.png", [[10, 20, 30, 40, 50, 60]] * 2, 2, 2)
    _png(tmp_path / "g.png", [[7, 200, 9], [1, 2, 3], [4, 5, 6]], 3, 3, 0)
    for name in ("t.ppm", "t.png", "g.png"):
        a = tobj.load_texture(str(tmp_path / name))
        b = jobj.load_texture(str(tmp_path / name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (tobj.load_texture(str(tmp_path / "t.ppm")) == 0xFF0000).all()
    assert tobj.load_texture(str(tmp_path / "t.png"))[0, 0] == \
        (10 << 16) | (20 << 8) | 30


def test_load_obj_scene_matches_jax(tmp_path):
    _write(tmp_path / "q.obj", "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                               "vn 0 0 -1\nf 1//1 2//1 3//1 4//1\n")
    a = tobj.load_obj_scene(str(tmp_path / "q.obj"))
    b = jobj.load_obj_scene(str(tmp_path / "q.obj"))
    assert len(a._meshes) == len(b._meshes) == 1
    _same_mesh(a._meshes[0], b._meshes[0])
    assert [(m, r) for m, _, r in a._instances] == \
        [(m, r) for m, _, r in b._instances]
    for (_, ta, _), (_, tb, _) in zip(a._instances, b._instances):
        np.testing.assert_array_equal(ta, tb)
    # a second file into the same scene
    a2 = tobj.load_obj_scene(str(tmp_path / "q.obj"), a)
    assert a2 is a and len(a._instances) == 2


def _placed(mod_scene, mod_proc, seed, n):
    rng = np.random.default_rng(seed)
    sc = mod_scene()
    for k in range(n):
        m = mod_proc.uv_sphere((k * 0.5, 0.1 * k, -0.2), 0.3 + 0.2 * k, 6, 8)
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = rng.normal(size=3).astype(np.float32)
        sc.add_instance(sc.add_mesh(m), t, reflectivity=0.1 * k)
    return sc


@pytest.mark.parametrize("n,margin", [(1, 0.0), (3, 0.0), (5, 0.25)])
def test_arrange_and_transform_match_jax(n, margin):
    rot = np.asarray([[0.0, -1.0, 0.0, 0.5], [1.0, 0.0, 0.0, -1.0],
                      [0.0, 0.0, 1.0, 2.0], [0.0, 0.0, 0.0, 1.0]])
    a = _placed(TScene, tproc, 7, n)
    b = _placed(JScene, jproc, 7, n)
    a.arrange_around_y(margin)
    b.arrange_around_y(margin)
    a.apply_transform(rot)
    b.apply_transform(rot)
    for (ma, ta, ra), (mb, tb, rb) in zip(a._instances, b._instances):
        assert (ma, ra) == (mb, rb)
        assert ta.dtype == tb.dtype == np.float32
        np.testing.assert_array_equal(ta, tb)


@pytest.mark.parametrize("kw", [{}, dict(n=4, cell=3),
                                dict(n=2, c0=0xFFFFFF, c1=0, cell=2)])
def test_checkerboard_texture_matches_jax(kw):
    a = tproc.checkerboard_texture(**kw)
    b = jproc.checkerboard_texture(**kw)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    {}, dict(spp=4, max_depth=3, tex_filter="bilinear", epsilon=1e-5,
             t_max=100.0, queue_capacity=64, stack_size=7, max_trail=16),
    dict(flatten=True, width=64, height=32)])
def test_config_dict_matches_jax(kw):
    a = tcfg.from_overrides(**kw).as_dict()
    b = jcfg.from_overrides(**kw).as_dict()
    assert set(a) <= set(b)
    for k in a:
        assert a[k] == b[k], k
    base = tcfg.RTConfig(width=8)
    assert tcfg.from_overrides(base, height=4) == tcfg.RTConfig(width=8,
                                                                height=4)


def test_config_tex_filter_validated():
    with pytest.raises(ValueError):
        tcfg.RTConfig(tex_filter="trilinear")
