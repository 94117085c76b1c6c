"""Large procedural scenes for the scale ladder (port of
``vortex_rt_tpu/models/bigscenes.py``: ``parametric_mesh`` and ``blob``,
unchanged).

``blob(n=187)`` is the ladder's config-3 stand-in for the Stanford bunny
(~69k tris): a sphere displaced by low-frequency sinusoids, vectorized.
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
