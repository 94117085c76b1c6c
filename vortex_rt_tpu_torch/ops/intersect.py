"""Intersection primitives as plain torch functions (port of
``vortex_rt_tpu/ops/intersect.py``).

* :func:`moller_trumbore` (``moller_trumbore_edges`` from a corner and
  two edges) — EPSILON = 1e-6, reject |a| < eps, w1 in
  [0, 1], w2 >= 0, w1 + w2 <= 1, t > eps; barycentrics bx = w1, by = w2,
  bz = 1 - w1 - w2;
* :func:`ray_aabb` — the slab test: returns t_enter, hit iff t_exit >=
  t_enter and t_exit > 0 (a ray starting inside the box reports a
  negative t_enter and still hits);
* :func:`transform_ray` — the TLAS -> BLAS object-space jump: origin by
  the affine inverse, direction by its linear part, unnormalized so the t
  parameter is preserved.

Every 3-term dot product is ``(a0*b0 + a1*b1) + a2*b2``, the order in
which XLA reduces the JAX package's ``(a * b).sum(-1)``; torch's own
``sum`` over a dimension of 3 may add in another order, and the walk of
``ops/traverse2.py`` and its kernel must give the JAX package's floats
(ROADMAP hazard H2).  ``1/a`` and ``1/d`` are true divisions (H6).
Shape-polymorphic over leading batch dimensions.
"""

from __future__ import annotations

import torch

from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT, MT_EPSILON


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last dimension (of size 3)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def moller_trumbore(o, d, v0, v1, v2, eps: float = MT_EPSILON):
    """Batched Moller-Trumbore.  Returns (t, w1, w2); t = LARGE_FLOAT on
    a miss."""
    return moller_trumbore_edges(o, d, v0, v1 - v0, v2 - v0, eps)


def moller_trumbore_edges(o, d, v0, e1, e2, eps: float = MT_EPSILON):
    """``moller_trumbore`` of the triangle with corner ``v0`` and edges
    ``e1 = v1 - v0``, ``e2 = v2 - v0`` (float32 differences, as K6's
    triangle records store them)."""
    h = cross(d, e2)
    a = dot(e1, h)
    small = a.abs() < eps
    f = 1.0 / torch.where(small, torch.ones_like(a), a)
    s = o - v0
    w1 = f * dot(s, h)
    q = cross(s, e1)
    w2 = f * dot(d, q)
    t = f * dot(e2, q)
    ok = (~small & (w1 >= 0.0) & (w1 <= 1.0) & (w2 >= 0.0)
          & (w1 + w2 <= 1.0) & (t > eps))
    return torch.where(ok, t, torch.full_like(t, LARGE_FLOAT)), w1, w2


def ray_aabb(o, inv_d, bmin, bmax):
    """Slab test.  Returns (t_enter, hit); ``inv_d`` = ``safe_rcp(d)``."""
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    hit = (tmax >= tmin) & (tmax > 0.0)
    return torch.where(hit, tmin, torch.full_like(tmin, LARGE_FLOAT)), hit


def transform_ray(inv_t, o, d):
    """Object-space ray: o by the rows of ``inv_t`` against [o, 1], d
    against [d, 0].  ``inv_t`` (..., 4, 4); o, d (..., 3)."""
    rot = inv_t[..., :3, :3]
    lo = dot(rot, o.unsqueeze(-2)) + inv_t[..., :3, 3]
    ld = dot(rot, d.unsqueeze(-2))
    return lo, ld


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (IEEE, as XLA and CUDA's
    ``sqrtf`` give it): torch's vectorized CPU kernel is off by one ulp
    for about 1% of inputs, and the float64 root rounded once to float32
    is exact (ROADMAP Queue 3)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def safe_rcp(d: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Reciprocal with a sign-preserving clamp, so axis-parallel rays
    behave like the reference's IEEE 1/0 = inf slab arithmetic."""
    e = torch.full_like(d, eps)
    return 1.0 / torch.where(d.abs() < eps, torch.where(d < 0, -e, e), d)
