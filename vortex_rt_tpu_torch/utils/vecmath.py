"""Vector / matrix math over NumPy SoA arrays (port of
``vortex_rt_tpu/utils/vecmath.py``; host-side, NumPy only).

Every function works on arrays whose trailing axis is the component axis
``(..., 3)``.  Matrices are row-major ``(4, 4)``; points transform as
``M @ [p, 1]`` and vectors as ``M @ [v, 0]``.
"""

from __future__ import annotations

import numpy as np


def dot(a, b):
    """Component dot product over the trailing axis."""
    return (a * b).sum(-1)


def cross(a, b):
    """Cross product over the trailing axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return np.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length(v):
    return dot(v, v) ** 0.5


def normalize(v, eps: float = 1e-20):
    return v / (length(v)[..., None] + eps)


def reflect(d, n):
    """Mirror direction d about normal n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def mat4_identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def mat4_translate(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def mat4_scale(s) -> np.ndarray:
    s = np.broadcast_to(np.asarray(s, dtype=np.float32), (3,))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def mat4_rotate(axis, angle_rad: float) -> np.ndarray:
    """Rotation about an arbitrary axis (Rodrigues)."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    x, y, z = a
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    ic = 1.0 - c
    r = np.array(
        [
            [c + x * x * ic, x * y * ic - z * s, x * z * ic + y * s],
            [y * x * ic + z * s, c + y * y * ic, y * z * ic - x * s],
            [z * x * ic - y * s, z * y * ic + x * s, c + z * z * ic],
        ],
        dtype=np.float64,
    )
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r.astype(np.float32)
    return m


def mat4_inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


def transform_point(m, p):
    """Apply the affine part + translation: rows of m against [p, 1]."""
    return p @ m[:3, :3].T + m[:3, 3]


def transform_vector(m, v):
    """Apply only the linear part: rows of m against [v, 0]."""
    return v @ m[:3, :3].T


def transform_normal(inv_m, n):
    """Normals transform by the inverse-transpose."""
    return n @ inv_m[:3, :3]


def aabb_empty():
    big = np.float32(1e30)
    return np.full(3, big, np.float32), np.full(3, -big, np.float32)


def aabb_area(bmin, bmax):
    """Half surface area (the SAH 'area')."""
    e = bmax - bmin
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def aabb_corners(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    """All 8 corners, for transformed-AABB TLAS leaves."""
    corners = np.array(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        dtype=np.float32,
    )
    return bmin + corners * (bmax - bmin)
