"""What a configuration's scene module makes: its meshes, in NumPy.
Both sides are handed what it makes: the program through its ``Scene``
API, the reference as it is.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    """One mesh with one material: (T, 3) vertices and normals, (T, 2)
    uvs, a diffuse colour, an optional (h, w) uint32 0xRRGGBB texture and
    the reflectivity of its instance."""

    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    n0: np.ndarray
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray
    uv1: np.ndarray
    uv2: np.ndarray
    diffuse: tuple = (0.8, 0.8, 0.8)
    tex: Optional[np.ndarray] = None
    reflectivity: float = 0.0

    @property
    def num_tris(self) -> int:
        return int(self.v0.shape[0])


def total_tris(meshes: List[Mesh]) -> int:
    return sum(m.num_tris for m in meshes)
