"""OBJ + MTL asset loading (port of ``vortex_rt_tpu/io/obj.py``;
host-side NumPy).

Wavefront OBJ geometry with per-face vertex / texcoord / normal indices,
polygon-fan triangulation (a face of n corners gives the triangles
(0, k, k + 1), k = 1 .. n - 2), negative (relative) indices, material
libraries and per-face materials.  A face corner without a normal takes
the face's flat normal, one without a texcoord (0, 0); faces before the
first ``usemtl`` get a default material of their own.

Materials map to ``models.scene.Material`` (the reference's
material_info_t): Ka/Kd/Ks/Ke -> ambient/diffuse/specular/emissive, Ns
shininess, Ni ior, d dissolve (Tr = 1 - d), illum, map_Kd -> diffuse
texture, its path resolved relative to the MTL file.

Textures decode to (H, W) uint32 0xRRGGBB texels, the packing of the
scene's texel pool.  PPM (binary P6, through ``utils/image.read_ppm``)
and PNG (8-bit gray / RGB / RGBA, non-interlaced, stdlib ``zlib``) are
read; other formats raise (an MTL's texture in another format falls back
to its Kd color).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from vortex_rt_tpu_torch.models.scene import (
    Material, MeshData, Scene, flat_normals, make_mesh,
)


def _rgb_to_texels(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) uint32 0xRRGGBB (surface.cpp packing)."""
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    return (r << 16) | (g << 8) | b


def load_texture(path: str) -> np.ndarray:
    """Decode an image file to (H, W) uint32 0xRRGGBB texels."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".ppm", ".pnm"):
        from vortex_rt_tpu_torch.utils.image import read_ppm

        return _rgb_to_texels(read_ppm(path))
    if ext == ".png":
        return _rgb_to_texels(_decode_png(path))
    raise ValueError(
        f"unsupported texture format {ext!r} ({path}); supported: ppm, png")


def _decode_png(path: str) -> np.ndarray:
    """Minimal PNG decoder: 8-bit gray / RGB / RGBA, non-interlaced."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos = 8
    idat = b""
    width = height = bitdepth = coltype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bitdepth, coltype, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
            if bitdepth != 8:
                raise ValueError(f"PNG bitdepth {bitdepth} unsupported")
            if interlace != 0:
                raise ValueError("interlaced PNG unsupported")
            if coltype not in (0, 2, 6):
                raise ValueError(f"PNG color type {coltype} unsupported")
        elif ctype == b"IDAT":
            idat += body
        elif ctype == b"IEND":
            break
    raw = zlib.decompress(idat)
    nch = {0: 1, 2: 3, 6: 4}[coltype]
    stride = width * nch
    img = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    off = 0
    for y in range(height):
        ftype = raw[off]
        line = np.frombuffer(raw, np.uint8, stride, off + 1).astype(np.int32)
        off += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub
            cur = line.copy()
            for x in range(nch, stride):
                cur[x] = (cur[x] + cur[x - nch]) & 255
        elif ftype == 2:  # Up
            cur = (line + prev) & 255
        elif ftype == 3:  # Average
            cur = line.copy()
            for x in range(stride):
                left = cur[x - nch] if x >= nch else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 255
        elif ftype == 4:  # Paeth
            cur = line.copy()
            for x in range(stride):
                a = cur[x - nch] if x >= nch else 0
                b = prev[x]
                c = prev[x - nch] if x >= nch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 255
        else:
            raise ValueError(f"PNG filter {ftype} unsupported")
        img[y] = cur.astype(np.uint8)
        prev = cur
    px = img.reshape(height, width, nch)
    if nch == 1:
        px = np.repeat(px, 3, axis=-1)
    return px[..., :3].copy()


# ---------------------------------------------------------------------------
# MTL
# ---------------------------------------------------------------------------

def load_mtl(path: str) -> Dict[str, Material]:
    """Parse a .mtl library into Material objects."""
    mats: Dict[str, Material] = {}
    cur: Optional[dict] = None
    name = None
    base = os.path.dirname(path)

    def flush():
        if name is not None:
            tex = None
            if cur.get("map_kd"):
                tpath = os.path.join(base, cur["map_kd"])
                if os.path.exists(tpath):
                    try:
                        tex = load_texture(tpath)
                    except ValueError:
                        tex = None  # unsupported format: fall back to Kd
            mats[name] = Material(
                ambient=tuple(cur.get("ka", (0, 0, 0))),
                diffuse=tuple(cur.get("kd", (0.8, 0.8, 0.8))),
                specular=tuple(cur.get("ks", (0, 0, 0))),
                emissive=tuple(cur.get("ke", (0, 0, 0))),
                shininess=cur.get("ns", 0.0),
                ior=cur.get("ni", 1.0),
                dissolve=cur.get("d", 1.0),
                illum=int(cur.get("illum", 2)),
                diffuse_tex=tex,
            )

    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0].lower()
            if key == "newmtl":
                flush()
                name = " ".join(tok[1:])
                cur = {}
            elif cur is None:
                continue
            elif key in ("ka", "kd", "ks", "ke"):
                cur[key] = [float(v) for v in tok[1:4]]
            elif key in ("ns", "ni", "d", "illum"):
                cur[key] = float(tok[1])
            elif key == "tr":  # transparency = 1 - d
                cur["d"] = 1.0 - float(tok[1])
            elif key == "map_kd":
                cur["map_kd"] = tok[-1]
    flush()
    return mats


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

def _parse_index(token: str, count: int) -> Optional[int]:
    """A face index token -> 0-based index (negative: relative to the
    ``count`` entries read so far); None for an empty token."""
    if not token:
        return None
    i = int(token)
    return i - 1 if i > 0 else count + i


def load_obj(path: str) -> MeshData:
    """Load an OBJ file into a MeshData (one mesh, packed materials)."""
    positions: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    faces: List[Tuple] = []  # ((vi, ti, ni) x3, mat_index)
    mat_lib: Dict[str, Material] = {}
    mat_names: List[str] = []
    cur_mat = -1
    base = os.path.dirname(path)

    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "v":
                positions.append(tuple(float(v) for v in tok[1:4]))
            elif key == "vt":
                texcoords.append(tuple(float(v) for v in tok[1:3]))
            elif key == "vn":
                normals.append(tuple(float(v) for v in tok[1:4]))
            elif key == "mtllib":
                mpath = os.path.join(base, " ".join(tok[1:]))
                if os.path.exists(mpath):
                    mat_lib.update(load_mtl(mpath))
            elif key == "usemtl":
                mname = " ".join(tok[1:])
                if mname not in mat_names:
                    mat_names.append(mname)
                cur_mat = mat_names.index(mname)
            elif key == "f":
                verts = []
                for vtok in tok[1:]:
                    parts = vtok.split("/")
                    vi = _parse_index(parts[0], len(positions))
                    ti = (_parse_index(parts[1], len(texcoords))
                          if len(parts) > 1 else None)
                    ni = (_parse_index(parts[2], len(normals))
                          if len(parts) > 2 else None)
                    verts.append((vi, ti, ni))
                for k in range(1, len(verts) - 1):  # fan triangulation
                    faces.append((verts[0], verts[k], verts[k + 1], cur_mat))

    if not faces:
        raise ValueError(f"no faces in {path}")
    pos = np.asarray(positions, np.float32)
    tex = (np.asarray(texcoords, np.float32)
           if texcoords else np.zeros((1, 2), np.float32))
    nrm = (np.asarray(normals, np.float32)
           if normals else np.zeros((1, 3), np.float32))

    t = len(faces)
    vidx = np.zeros((t, 3), np.int64)
    tidx = np.full((t, 3), -1, np.int64)
    nidx = np.full((t, 3), -1, np.int64)
    mat_id = np.zeros(t, np.int32)
    for i, (a, b, c, m) in enumerate(faces):
        for j, (vi, ti, ni) in enumerate((a, b, c)):
            vidx[i, j] = vi
            tidx[i, j] = -1 if ti is None else ti
            nidx[i, j] = -1 if ni is None else ni
        mat_id[i] = m  # -1 = before any usemtl, rebased below

    v0, v1, v2 = pos[vidx[:, 0]], pos[vidx[:, 1]], pos[vidx[:, 2]]
    # normals: per-vertex where present, the flat face normal elsewhere
    flat = np.asarray(flat_normals(v0, v1, v2), np.float32)

    def pick_n(col):
        has = nidx[:, col] >= 0
        out = flat.copy()
        out[has] = nrm[nidx[has, col]]
        return out

    def pick_t(col):
        has = tidx[:, col] >= 0
        out = np.zeros((t, 2), np.float32)
        out[has] = tex[tidx[has, col]]
        return out

    materials = [mat_lib.get(n, Material()) for n in mat_names] or [Material()]
    if (mat_id < 0).any():
        # faces before the first usemtl get a default material of their
        # own, not whichever material is declared first
        materials.append(Material())
        mat_id = np.where(mat_id < 0, len(materials) - 1, mat_id)
    return make_mesh(
        v0, v1, v2,
        pick_n(0), pick_n(1), pick_n(2),
        pick_t(0), pick_t(1), pick_t(2),
        mat_id=mat_id, materials=materials,
    )


def load_obj_scene(path: str, scene: Optional[Scene] = None) -> Scene:
    """Load an OBJ as a one-instance scene."""
    sc = scene or Scene()
    mi = sc.add_mesh(load_obj(path))
    sc.add_instance(mi)
    return sc
