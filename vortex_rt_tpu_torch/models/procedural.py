"""Procedural test geometry (port of ``vortex_rt_tpu/models/procedural.py``:
``quad``, ``box``, ``uv_sphere``, ``random_soup``,
``checkerboard_texture`` and ``cornell_box``, unchanged).

The reference ships binary OBJ assets (teapot/sphere/torus/... under
tests/regression/raytracing/assets).  We generate equivalent geometry
procedurally so tests are hermetic; the OBJ loader (io.obj) covers the
asset-file path itself.
"""

from __future__ import annotations

import numpy as np

from vortex_rt_tpu_torch.models.scene import Material, MeshData, make_mesh


def quad(p0, p1, p2, p3, material: Material | None = None) -> MeshData:
    """Two triangles spanning the (possibly non-planar) quad p0-p1-p2-p3."""
    p = np.asarray([p0, p1, p2, p3], np.float32)
    v0 = np.stack([p[0], p[0]])
    v1 = np.stack([p[1], p[2]])
    v2 = np.stack([p[2], p[3]])
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    uv0 = np.stack([uv[0], uv[0]])
    uv1 = np.stack([uv[1], uv[2]])
    uv2 = np.stack([uv[2], uv[3]])
    return make_mesh(v0, v1, v2, uv0=uv0, uv1=uv1, uv2=uv2,
                     materials=[material] if material else None)


def box(center, half, material: Material | None = None) -> MeshData:
    """Axis-aligned box, 12 tris, outward flat normals."""
    c = np.asarray(center, np.float32)
    h = np.broadcast_to(np.asarray(half, np.float32), (3,))
    lo, hi = c - h, c + h
    # 6 faces, each wound CCW viewed from outside
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    faces = [
        # -z
        [(x0, y0, z0), (x0, y1, z0), (x1, y1, z0), (x1, y0, z0)],
        # +z
        [(x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)],
        # -y
        [(x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)],
        # +y
        [(x0, y1, z0), (x0, y1, z1), (x1, y1, z1), (x1, y1, z0)],
        # -x
        [(x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)],
        # +x
        [(x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1)],
    ]
    v0, v1, v2 = [], [], []
    for f in faces:
        p = np.asarray(f, np.float32)
        v0 += [p[0], p[0]]
        v1 += [p[1], p[2]]
        v2 += [p[2], p[3]]
    return make_mesh(np.stack(v0), np.stack(v1), np.stack(v2),
                     materials=[material] if material else None)


def uv_sphere(center, radius: float, n_theta: int = 16, n_phi: int = 32,
              material: Material | None = None) -> MeshData:
    """UV-sphere with smooth per-vertex normals and spherical UVs."""
    c = np.asarray(center, np.float32)
    th = np.linspace(0.0, np.pi, n_theta + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_phi + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    nrm = np.stack(
        [np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)], axis=-1
    ).astype(np.float32)
    pos = c + radius * nrm
    uv = np.stack([P / (2 * np.pi), T / np.pi], axis=-1).astype(np.float32)

    v0, v1, v2, n0, n1, n2, t0, t1, t2 = ([] for _ in range(9))
    for i in range(n_theta):
        for j in range(n_phi):
            quad_idx = [(i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)]
            pts = [pos[a] for a in quad_idx]
            ns = [nrm[a] for a in quad_idx]
            ts = [uv[a] for a in quad_idx]
            for tri in ((0, 1, 2), (0, 2, 3)):
                a, b, d = tri
                # skip degenerate polar slivers
                if (np.allclose(pts[a], pts[b]) or np.allclose(pts[b], pts[d])
                        or np.allclose(pts[a], pts[d])):
                    continue
                v0.append(pts[a]); v1.append(pts[b]); v2.append(pts[d])
                n0.append(ns[a]); n1.append(ns[b]); n2.append(ns[d])
                t0.append(ts[a]); t1.append(ts[b]); t2.append(ts[d])
    return make_mesh(np.stack(v0), np.stack(v1), np.stack(v2),
                     np.stack(n0), np.stack(n1), np.stack(n2),
                     np.stack(t0), np.stack(t1), np.stack(t2),
                     materials=[material] if material else None)


def random_soup(rng: np.random.Generator, n_tris: int, extent: float = 10.0,
                tri_size: float = 1.0) -> MeshData:
    """Random triangle soup — the stress input for traversal property tests."""
    base = rng.uniform(-extent, extent, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, tri_size, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, tri_size, (n_tris, 3)).astype(np.float32)
    return make_mesh(base, base + e1, base + e2)


def checkerboard_texture(n: int = 8, c0: int = 0xFFFFFF, c1: int = 0x202020,
                         cell: int = 4) -> np.ndarray:
    """(n*cell, n*cell) uint32 0xRRGGBB checker texture."""
    yy, xx = np.meshgrid(np.arange(n * cell), np.arange(n * cell), indexing="ij")
    return np.where(((xx // cell) + (yy // cell)) % 2 == 0, c0, c1).astype(np.uint32)


def cornell_box(reflective_sphere: bool = True):
    """Cornell-style box scene (BASELINE.json config 2).

    Returns (Scene-ready list of (MeshData, reflectivity)) — white floor/
    ceiling/back, red/green walls, one box and one sphere inside.
    """
    white = Material(diffuse=(0.73, 0.73, 0.73))
    red = Material(diffuse=(0.65, 0.05, 0.05))
    green = Material(diffuse=(0.12, 0.45, 0.15))
    steel = Material(diffuse=(0.8, 0.8, 0.9))

    s = 1.0  # half-size
    meshes = [
        (quad((-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s), white), 0.0),   # floor
        (quad((-s, s, -s), (-s, s, s), (s, s, s), (s, s, -s), white), 0.0),       # ceiling
        (quad((-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s), white), 0.0),       # back
        (quad((-s, -s, -s), (-s, -s, s), (-s, s, s), (-s, s, -s), red), 0.0),     # left
        (quad((s, -s, -s), (s, s, -s), (s, s, s), (s, -s, s), green), 0.0),       # right
        (box((-0.35, -0.65, 0.3), (0.25, 0.35, 0.25), white), 0.0),
        (uv_sphere((0.4, -0.7, -0.2), 0.3, 12, 24, steel),
         0.6 if reflective_sphere else 0.0),
    ]
    return meshes
