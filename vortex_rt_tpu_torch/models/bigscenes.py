"""Large procedural scenes for the scale ladder (port of
``vortex_rt_tpu/models/bigscenes.py``: ``parametric_mesh``, ``blob``,
``atrium`` with its parts and ``wavy_grid``, unchanged, so both packages
make the same triangles).

``blob(n=187)`` is the ladder's config-3 stand-in for the Stanford bunny
(~69k tris): a sphere displaced by low-frequency sinusoids.  ``atrium()``
is its config-4 stand-in for Sponza (~260k tris): a hall with two
colonnades, a checker-textured floor, relief walls and a ceiling.
``wavy_grid(n=708)`` is its config-5 mesh: a 1M-triangle heightfield whose
vertices the refit path moves every frame.  ``textured_atrium`` is the
atrium with the reference's texture assets (ladder config 6, the alpha
cutout any-hit row); where the assets are absent it falls back to the
procedural checker, as the JAX package does.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from vortex_rt_tpu_torch.models.scene import Material, MeshData, make_mesh


def parametric_mesh(f: Callable[[np.ndarray, np.ndarray], np.ndarray],
                    nu: int, nv: int,
                    material: Optional[Material] = None,
                    smooth: bool = True,
                    uv_scale=(1.0, 1.0)) -> MeshData:
    """Triangulate the parametric surface ``f(u, v) -> (..., 3)`` on an
    (nu+1) x (nv+1) grid over [0,1]^2; 2*nu*nv triangles, vectorized.

    ``smooth`` derives per-vertex normals from the grid's central
    differences (matching how OBJ assets carry smooth vertex normals);
    otherwise flat geometric normals are used.  Degenerate cells (poles)
    are dropped.
    """
    u = np.linspace(0.0, 1.0, nu + 1, dtype=np.float32)
    v = np.linspace(0.0, 1.0, nv + 1, dtype=np.float32)
    uu, vv = np.meshgrid(u, v, indexing="ij")          # (nu+1, nv+1)
    pos = np.asarray(f(uu, vv), np.float32)            # (nu+1, nv+1, 3)

    if smooth:
        du = np.gradient(pos, axis=0)
        dv = np.gradient(pos, axis=1)
        nrm = np.cross(du, dv)
        ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = nrm / np.maximum(ln, 1e-20)

    uvg = np.stack([uu * uv_scale[0], vv * uv_scale[1]],
                   axis=-1).astype(np.float32)

    a = pos[:-1, :-1].reshape(-1, 3)   # (u, v)
    b = pos[1:, :-1].reshape(-1, 3)    # (u+1, v)
    c = pos[1:, 1:].reshape(-1, 3)     # (u+1, v+1)
    d = pos[:-1, 1:].reshape(-1, 3)    # (u, v+1)
    v0 = np.concatenate([a, a]); v1 = np.concatenate([b, c])
    v2 = np.concatenate([c, d])

    def corners(g):
        ga = g[:-1, :-1].reshape(-1, g.shape[-1])
        gb = g[1:, :-1].reshape(-1, g.shape[-1])
        gc = g[1:, 1:].reshape(-1, g.shape[-1])
        gd = g[:-1, 1:].reshape(-1, g.shape[-1])
        return (np.concatenate([ga, ga]), np.concatenate([gb, gc]),
                np.concatenate([gc, gd]))

    t0, t1, t2 = corners(uvg)
    # drop degenerate (zero-area) tris, e.g. sphere pole caps
    area2 = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    keep = area2 > 1e-12
    if smooth:
        n0, n1, n2 = corners(nrm)
        return make_mesh(v0[keep], v1[keep], v2[keep],
                         n0[keep], n1[keep], n2[keep],
                         t0[keep], t1[keep], t2[keep],
                         materials=[material] if material else None)
    return make_mesh(v0[keep], v1[keep], v2[keep],
                     uv0=t0[keep], uv1=t1[keep], uv2=t2[keep],
                     materials=[material] if material else None)


# ---------------------------------------------------------------------------
# Config 3 stand-in: bunny-class dense smooth blob (~69k tris)
# ---------------------------------------------------------------------------

def blob(center=(0.0, 0.0, 0.0), radius: float = 1.0, n: int = 187,
         seed: int = 7, material: Optional[Material] = None) -> MeshData:
    """Bunny-class organic mesh: a sphere displaced by a fixed band of
    low-frequency spherical harmonics-ish sinusoids.  n=187 -> ~69.2k
    tris (2*n*(n-1)), the Stanford-bunny count of BASELINE config 3."""
    rng = np.random.default_rng(seed)
    kf = rng.uniform(1.5, 5.0, (6, 2)).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, (6, 2)).astype(np.float32)
    amp = (rng.uniform(0.03, 0.09, 6).astype(np.float32)
           * radius / np.arange(1, 7))
    c = np.asarray(center, np.float32)

    def f(u, v):
        th = u * np.pi                 # polar
        phi = v * 2 * np.pi            # azimuth
        disp = 0.0
        for i in range(6):
            disp = disp + amp[i] * np.sin(kf[i, 0] * th + ph[i, 0]) \
                * np.cos(kf[i, 1] * phi + ph[i, 1])
        r = radius * (1.0 + disp)
        sin_t = np.sin(th)
        return np.stack([
            c[0] + r * sin_t * np.cos(phi),
            c[1] + r * np.cos(th),
            c[2] + r * sin_t * np.sin(phi)], axis=-1)

    return parametric_mesh(f, n, n, material=material)


# ---------------------------------------------------------------------------
# Config 4 stand-in: Sponza-class architectural hall (~260k tris)
# ---------------------------------------------------------------------------

def _checker(n=8, c0=0xC8C0B0, c1=0x504840, cell=8) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(n * cell), np.arange(n * cell),
                         indexing="ij")
    return np.where(((xx // cell) + (yy // cell)) % 2 == 0,
                    c0, c1).astype(np.uint32)


def fluted_column(pos, height: float = 3.0, radius: float = 0.3,
                  nu: int = 96, nv: int = 64,
                  material: Optional[Material] = None) -> MeshData:
    """Classical column: fluted shaft with entasis (slight taper bulge).
    2*nu*nv tris."""
    p = np.asarray(pos, np.float32)

    def f(u, v):
        phi = u * 2 * np.pi
        y = v * height
        # 20 flutes + entasis profile
        r = radius * (1.0 - 0.18 * v) * (1.0 + 0.04 * np.cos(20.0 * phi))
        return np.stack([p[0] + r * np.cos(phi),
                         p[1] + y,
                         p[2] + r * np.sin(phi)], axis=-1)

    return parametric_mesh(f, nu, nv, material=material)


def bumpy_slab(center, size, nu: int, nv: int, axis: str = "y",
               bump: float = 0.0, material: Optional[Material] = None,
               uv_scale=(8.0, 8.0)) -> MeshData:
    """Subdivided rectangular slab (floor/wall/ceiling) with optional
    low-amplitude relief so the geometry is not a trivial two-triangle
    plane.  2*nu*nv tris."""
    c = np.asarray(center, np.float32)
    s = np.asarray(size, np.float32)

    def f(u, v):
        a = (u - 0.5) * s[0]
        b = (v - 0.5) * s[1]
        h = bump * np.sin(17.0 * u * np.pi) * np.sin(13.0 * v * np.pi)
        if axis == "y":
            return np.stack([c[0] + a, c[1] + h, c[2] + b], axis=-1)
        if axis == "z":
            return np.stack([c[0] + a, c[1] + b, c[2] + h], axis=-1)
        return np.stack([c[0] + h, c[1] + b, c[2] + a], axis=-1)

    return parametric_mesh(f, nu, nv, material=material, smooth=bump > 0,
                           uv_scale=uv_scale)


def atrium(n_cols: int = 12, target_tris: int = 260_000):
    """Sponza-class hall (BASELINE config 4 stand-in): a long atrium with
    two colonnades, textured floor, relief walls and a ceiling.  Returns
    a list of (MeshData, reflectivity) like models.procedural.cornell_box.

    Workload character matches Sponza's: most primary rays end on the
    floor/walls, colonnade rays traverse long occluded corridors, and
    the repeated columns make the TLAS non-trivial (each column is its
    own instance-able mesh here, but packed as distinct meshes so the
    triangle pool really holds ~target_tris unique triangles, like the
    reference scene).
    """
    floor_mat = Material(diffuse=(0.9, 0.87, 0.8), diffuse_tex=_checker())
    wall_mat = Material(diffuse=(0.75, 0.72, 0.65))
    col_mat = Material(diffuse=(0.82, 0.8, 0.75))

    hall_l, hall_w, hall_h = 24.0, 10.0, 6.0
    meshes = []

    # budget: ~35% slabs, ~65% columns
    slab_tris = int(target_tris * 0.35)
    per_slab = slab_tris // 5
    n_slab = max(int(np.sqrt(per_slab / 2)), 8)

    def slab(center, size, axis, mat, bump=0.02):
        meshes.append((bumpy_slab(center, size, n_slab, n_slab, axis=axis,
                                  bump=bump, material=mat), 0.0))

    slab((0, 0, 0), (hall_l, hall_w), "y", floor_mat, bump=0.0)      # floor
    slab((0, hall_h, 0), (hall_l, hall_w), "y", wall_mat)            # ceiling
    slab((0, hall_h / 2, -hall_w / 2), (hall_l, hall_h), "z", wall_mat)
    slab((0, hall_h / 2, hall_w / 2), (hall_l, hall_h), "z", wall_mat)
    slab((-hall_l / 2, hall_h / 2, 0), (hall_w, hall_h), "x", wall_mat)

    col_tris = target_tris - sum(m.num_tris for m, _ in meshes)
    per_col = col_tris // (2 * n_cols)
    nu = max(int(np.sqrt(per_col / 2 * 1.5)), 24)
    nv = max(per_col // (2 * nu), 16)
    xs = np.linspace(-hall_l / 2 + 1.5, hall_l / 2 - 1.5, n_cols)
    for x in xs:
        for z in (-hall_w / 2 + 1.2, hall_w / 2 - 1.2):
            meshes.append((fluted_column((x, 0.0, z), height=hall_h * 0.8,
                                         radius=0.35, nu=nu, nv=nv,
                                         material=col_mat), 0.0))
    return meshes


def textured_atrium(n_cols: int = 12, target_tris: int = 260_000,
                    assets: Optional[str] = None):
    """The atrium with texture images on every surface: floor, walls,
    ceiling accents and columns each take a texture from the directory
    ``assets`` (the reference renderer's raytracing test assets:
    ``bricks.png``, ``ceramic.png``, ``flower.png``, ``blue.png`` and
    the Sponza floor and column textures), so the texel pool holds
    several multi-texel textures.  Ladder config 6's scene.

    A texture that is missing or unreadable, or every texture when
    ``assets`` is None, falls back to the procedural checker, as the JAX
    package does on a tree without the reference checkout; the meshes,
    materials and triangle counts do not change."""
    import os

    from vortex_rt_tpu_torch.io.obj import load_texture

    def tex(*names):
        for nm in names if assets is not None else ():
            p = os.path.join(assets, nm)
            if os.path.exists(p):
                try:
                    return load_texture(p)
                except (OSError, ValueError):
                    continue
        return _checker()

    floor_tex = tex("Sponza/textures/sponza_floor_a_diff.png",
                    "ceramic.png")
    wall_tex = tex("bricks.png")
    col_tex = tex("Sponza/textures/sponza_column_a_diff.png",
                  "ceramic.png")
    accent_tex = tex("flower.png", "blue.png")

    floor_mat = Material(diffuse=(1.0, 1.0, 1.0), diffuse_tex=floor_tex)
    wall_mat = Material(diffuse=(1.0, 1.0, 1.0), diffuse_tex=wall_tex)
    col_mat = Material(diffuse=(1.0, 1.0, 1.0), diffuse_tex=col_tex)
    accent_mat = Material(diffuse=(1.0, 1.0, 1.0), diffuse_tex=accent_tex)

    hall_l, hall_w, hall_h = 24.0, 10.0, 6.0
    meshes = []
    slab_tris = int(target_tris * 0.35)
    per_slab = slab_tris // 5
    n_slab = max(int(np.sqrt(per_slab / 2)), 8)

    def slab(center, size, axis, mat, bump=0.02):
        meshes.append((bumpy_slab(center, size, n_slab, n_slab, axis=axis,
                                  bump=bump, material=mat), 0.0))

    slab((0, 0, 0), (hall_l, hall_w), "y", floor_mat, bump=0.0)
    slab((0, hall_h, 0), (hall_l, hall_w), "y", accent_mat)
    slab((0, hall_h / 2, -hall_w / 2), (hall_l, hall_h), "z", wall_mat)
    slab((0, hall_h / 2, hall_w / 2), (hall_l, hall_h), "z", wall_mat)
    slab((-hall_l / 2, hall_h / 2, 0), (hall_w, hall_h), "x", wall_mat)

    col_tris = target_tris - sum(m.num_tris for m, _ in meshes)
    per_col = col_tris // (2 * n_cols)
    nu = max(int(np.sqrt(per_col / 2 * 1.5)), 24)
    nv = max(per_col // (2 * nu), 16)
    xs = np.linspace(-hall_l / 2 + 1.5, hall_l / 2 - 1.5, n_cols)
    for x in xs:
        for z in (-hall_w / 2 + 1.2, hall_w / 2 - 1.2):
            meshes.append((fluted_column((x, 0.0, z), height=hall_h * 0.8,
                                         radius=0.35, nu=nu, nv=nv,
                                         material=col_mat), 0.0))
    return meshes


# ---------------------------------------------------------------------------
# Config 5 ingredient: animated 1M-tri heightfield
# ---------------------------------------------------------------------------

def wavy_grid(n: int = 708, extent: float = 20.0, t: float = 0.0,
              amp: float = 0.8,
              material: Optional[Material] = None) -> MeshData:
    """Animated heightfield: 2*(n-1)^2 tris (n=708 -> 1.0M), height a
    smooth function of (x, z, t) so per-frame refit/rebuild (BASELINE
    config 5) has real motion.  Vertices move only in y, so an LBVH
    refit (topology kept, boxes recomputed) stays a good tree."""

    def f(u, v):
        x = (u - 0.5) * extent
        z = (v - 0.5) * extent
        y = amp * (np.sin(0.8 * x + 1.7 * t) * np.cos(0.6 * z - 1.3 * t)
                   + 0.4 * np.sin(2.3 * x - 0.9 * t + 1.0)
                   * np.sin(1.9 * z + 0.7 * t))
        return np.stack([x, y, z], axis=-1)

    return parametric_mesh(f, n - 1, n - 1, material=material,
                           uv_scale=(8.0, 8.0))
