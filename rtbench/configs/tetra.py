"""The ``tetra`` configuration's scene: the Standard Procedural Databases'
recursive tetrahedral pyramid (Haines 1987), made in NumPy.

A regular tetrahedron with corners at (1, 1, 1), (1, -1, -1), (-1, 1, -1)
and (-1, -1, 1) is replaced by four tetrahedra of half its size, one at
each of its corners, and so on ``levels - 1`` times; each of the
``4^(levels - 1)`` tetrahedra left gives its four faces: ``4^levels``
triangles, one material, flat normals.  The pyramid is turned so that its
apex, the SPD view's up vector (-1, -1, 1), points along +y.
"""

from __future__ import annotations

from typing import List

import numpy as np

from rtbench.scenes import Mesh

CORNERS = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                   np.float64)
# each face's corners, the fourth corner behind it (outward order is
# fixed below)
FACES = ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1))


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


# rows: the new x, y (the apex) and z axes, a right-handed rotation
_EY = _unit([-1.0, -1.0, 1.0])
_EX = _unit([1.0, -1.0, 0.0])
ROTATION = np.stack([_EX, _EY, np.cross(_EX, _EY)])


def centres(levels: int):
    """(the ``4^(levels - 1)`` tetrahedra's centres, their corner offset)."""
    c, s = np.zeros((1, 3)), 1.0
    for _ in range(levels - 1):
        c = (c[:, None, :] + 0.5 * s * CORNERS[None]).reshape(-1, 3)
        s *= 0.5
    return c, s


def meshes(levels: int = 9, diffuse=(1.0, 0.2, 0.2)) -> List[Mesh]:
    """One mesh of ``4^levels`` triangles, every reflectivity 0."""
    c, s = centres(levels)
    faces = []
    for f in FACES:
        a, b, d = (CORNERS[k] for k in f)
        back = CORNERS[6 - sum(f)]
        # outward: the face's normal points away from its fourth corner
        if np.dot(np.cross(b - a, d - a), back - a) > 0:
            b, d = d, b
        faces.append((a, b, d))
    # triangle 4 t + f is face f of tetrahedron t
    v = [np.stack([c + s * f[k] for f in faces], 1).reshape(-1, 3)
         @ ROTATION.T for k in range(3)]
    v0, v1, v2 = (x.astype(np.float32) for x in v)
    n = np.cross(v[1] - v[0], v[2] - v[0])
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    uv = np.zeros((v0.shape[0], 2), np.float32)
    return [Mesh(v0, v1, v2, n, n, n, uv, uv, uv, diffuse=tuple(diffuse))]
