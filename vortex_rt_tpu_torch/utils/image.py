"""Framebuffer output: PPM writer + tonemap (port of
``vortex_rt_tpu/utils/image.py``; NumPy, host-side)."""

from __future__ import annotations

import numpy as np


def rgb32f_to_rgb8(img: np.ndarray) -> np.ndarray:
    """Clamp to [0, 1] and quantize to 8 bits."""
    img = np.asarray(img, dtype=np.float32)
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def write_ppm(path: str, img: np.ndarray) -> None:
    """Binary P6 PPM of an (H, W, 3) float [0,1] or uint8 image."""
    if img.dtype != np.uint8:
        img = rgb32f_to_rgb8(img)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM back into (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    tokens = []
    i = 0
    while len(tokens) < 4:
        if data[i : i + 1] == b"#":
            i = data.index(b"\n", i) + 1
            continue
        j = i
        while data[j : j + 1] not in b" \t\r\n":
            j += 1
        if j > i:
            tokens.append(data[i:j])
        i = j + 1
    if tokens[0] != b"P6":
        raise ValueError("only binary P6 supported")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval != 255:
        raise ValueError(f"only maxval 255 supported, got {maxval}")
    pix = np.frombuffer(data[i:], dtype=np.uint8, count=w * h * 3)
    return pix.reshape(h, w, 3).copy()


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Pixel RMSE on float [0,1] images."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
