"""Texture loading (port of the texture part of ``vortex_rt_tpu/io/obj.py``:
``_rgb_to_texels``, ``load_texture`` and ``_decode_png``; host-side NumPy).

Images decode to (H, W) uint32 0xRRGGBB texels, the packing of the
scene's texel pool.  PPM (binary P6, through ``utils/image.read_ppm``)
and PNG (8-bit gray / RGB / RGBA, non-interlaced, stdlib ``zlib``) are
read; other formats raise.  The OBJ and MTL loaders of that module are
not ported yet (ROADMAP Queue 1, item 10a).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


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
