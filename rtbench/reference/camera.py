"""The camera the benchmark hands both sides: a frozen copy of the
``framing_camera`` and ``look_at`` arithmetic (on -z, looking at the
centre of the vertices' box, far enough back to frame its bounding
sphere), in NumPy float32."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Cam:
    pos: np.ndarray
    forward: np.ndarray
    right: np.ndarray
    up: np.ndarray
    viewplane: np.ndarray   # (width, height) at unit distance


def _normalize(v):
    return v / ((v * v).sum(-1) ** 0.5 + 1e-20)


def _cross(a, b):
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], np.float32)


def framing_camera(meshes, vfov_deg: float, aspect: float) -> Cam:
    """The camera of ``meshes`` (``rtbench.scenes.Mesh``) for a frame of
    ``aspect`` (width over height)."""
    bmin = np.min([np.minimum(np.minimum(m.v0, m.v1), m.v2).min(0)
                   for m in meshes], axis=0).astype(np.float32)
    bmax = np.max([np.maximum(np.maximum(m.v0, m.v1), m.v2).max(0)
                   for m in meshes], axis=0).astype(np.float32)
    center = (bmin + bmax) * 0.5
    radius = float(((bmax - center) * (bmax - center)).sum(-1) ** 0.5)
    distance = radius / max(np.tan(np.deg2rad(vfov_deg)), 1e-6)
    pos = center - np.array([0.0, 0.0, 1.0], np.float32) * distance
    forward = _normalize(center - pos).astype(np.float32)
    right = _normalize(_cross(forward, np.array([0.0, 1.0, 0.0],
                                                np.float32))).astype(np.float32)
    up = _cross(right, forward)
    vh = 2.0 * np.tan(np.deg2rad(vfov_deg) * 0.5)
    return Cam(pos.astype(np.float32), forward, right, up,
               np.array([vh * aspect, vh], np.float32))
