"""K1's alpha-mode slot classes checked on the CPU, without JAX.

``ops/traverse_packet.alpha_classes`` marks a slot of a fused row kept
(cut out) when every texel its triangle can sample keeps (cuts), and the
kernel then skips the slot's alpha test.  Here:

* the classes equal a brute-force reading of each leaf slot's texels
  (numpy, texel by texel), at thresholds that keep all, some and none;
* a scalar walk written here (one ray at a time, numpy float32, the same
  slab test, sorting network, stack words and Moller-Trumbore order)
  tests every candidate, as the plain walk does: its hits and steps equal
  the plain walk's, every classed candidate's test gives its class's
  answer, and its count of the tests the kernel makes (the candidates of
  slots classed "test") equals ``walk_work``'s ``alpha_lookups`` ray by
  ray, below ``alpha_tests`` on the cutout scene.
"""

import numpy as np
import pytest
import torch

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch.models.procedural import box, quad, uv_sphere
from vortex_rt_tpu_torch.models.scene import Material
from vortex_rt_tpu_torch.ops import traverse_packet as tp
from vortex_rt_tpu_torch.ops.traverse_wide import (
    ROW_WORDS, WideArrays, row_layout,
)
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT, MT_EPSILON

THR = 0.35
# the 8-wide row's quantized boxes, meta word and leaf count
QLO, QHI, META, LEAF, _ = row_layout(8)
F = np.float32


def _cutout_wa():
    """Checkered quads (one of them twice, coincident: the same
    triangles under other ids), a dark quad (always cut out) before
    them, a sphere and a box behind: flat 8-wide fused rows with the
    alpha fields."""
    yy, xx = np.meshgrid(np.arange(12), np.arange(12), indexing="ij")
    tex = np.where(((xx // 3) + (yy // 3)) % 2 == 0, 0xFFFFFF,
                   0x101010).astype(np.uint32)
    sc = pt.Scene()
    checker = sc.add_mesh(quad((-2, -2, 1.0), (2, -2, 1.0), (2, 2, 1.0),
                               (-2, 2, 1.0),
                               Material(diffuse=(1, 1, 1), diffuse_tex=tex)))
    sc.add_instance(checker)
    sc.add_instance(checker)
    for mesh in (
            quad((-1.5, -1.5, 0), (1.5, -1.5, 0), (1.5, 1.5, 0),
                 (-1.5, 1.5, 0), Material(diffuse=(1, 1, 1), diffuse_tex=tex)),
            quad((-0.5, -0.5, -0.5), (0.5, -0.5, -0.5), (0.5, 0.5, -0.5),
                 (-0.5, 0.5, -0.5), Material(diffuse=(0.1, 0.1, 0.1))),
            uv_sphere((0, 0, 2.6), 0.8, 10, 14), box((1.2, 1.0, 2.4), 0.5)):
        sc.add_instance(sc.add_mesh(mesh))
    sb = sc.build(pt.RTConfig(flatten=True, use_native_build=False))
    return WideArrays.from_scene(sb, width=8).fuse().with_alpha(sb)


def _rays(n):
    """n x n rays from z = -3 toward the quads, slightly divergent."""
    s = np.linspace(-0.9, 0.9, n, dtype=np.float32)
    x, y = np.meshgrid(s, s)
    o = np.stack([x.ravel(), y.ravel(), np.full(n * n, -3.0, F)], 1)
    d = np.stack([0.15 * x.ravel(), 0.1 * y.ravel(), np.ones(n * n, F)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(F), d.astype(F)


def _qb(w, k):
    return F((int(w) >> (8 * k)) & 255)


def _alpha_keep(fields, w1, w2, pool, thr=THR):
    """The alpha test of one candidate: luminance of the point-sampled
    texel (floored modulo) not below THR."""
    u0, v0, u1, v1, u2, v2 = (F(x) for x in fields[:6].view(np.float32))
    toff, twh = (int(x) for x in fields[6:8])
    bz = F(1.0) - w1 - w2
    u = u1 * w1 + u2 * w2 + u0 * bz
    v = v1 * w1 + v2 * w2 + v0 * bz
    tw, th = max(twh >> 16, 1), max(twh & 0xFFFF, 1)
    iu = int(np.floor(u * F(tw))) % tw
    iv = int(np.floor(v * F(th))) % th
    idx = min(max(toff + iu + iv * tw, 0), pool.shape[0] - 1)
    return not pool[idx] < F(thr)


def _slot_class(fields, pool, thr=THR):
    """Whether every texel the slot's triangle can sample keeps (1), cuts
    (2) or neither (0): the texels of the box of its uv corners' texel
    coordinates widened by ``_CLS_MARGIN``, moved into the texture by
    whole sides, or the whole side along an axis where it wraps."""
    uv = fields[:6].view(np.float32).astype(np.float64)
    toff, twh = (int(x) for x in fields[6:8])
    tw, th = max(twh >> 16, 1), max(twh & 0xFFFF, 1)
    if toff < 0 or toff + tw * th > pool.shape[0]:
        return 0

    def span(c, side):
        """The texel indices the floored modulo gives along an axis."""
        if not (np.isfinite(c).all()
                and np.abs(c).max() * side <= tp._CLS_SPAN):
            return range(side)
        lo = int(np.floor(c.min() * side - tp._CLS_MARGIN))
        hi = int(np.floor(c.max() * side + tp._CLS_MARGIN))
        hi, lo = hi - (lo - lo % side), lo % side
        return range(lo, hi + 1) if hi < side else range(side)

    keep = [not pool[toff + iu + iv * tw] < F(thr)
            for iv in span(uv[1::2], th) for iu in span(uv[0::2], tw)]
    return 1 if all(keep) else 2 if not any(keep) else 0


def _scalar_walk(wa, o, d, t_max, occ):
    """One ray's walk, every candidate tested: (dist, tri, steps, the
    alpha tests the kernel makes); asserts that each classed candidate's
    test gives its class's answer."""
    rows = wa.fused.numpy()
    pool = wa.alpha_pool.numpy()
    lmax = max(int(wa.max_leaf_tris), 1)
    a_off = tp.alpha_offset(wa)
    qlo, qhi, meta_w, leaf_w = QLO, QHI, META, LEAF
    ox, oy, oz = o
    dx, dy, dz = d
    iv = [F(1.0) / (c if abs(c) >= F(1e-20) else F(-1e-20 if c < 0 else
                                                   1e-20)) for c in d]
    best, tri, node, steps, tests = F(t_max), 0, 0, 0, 0
    stack = []   # [left, deferred count, sorted slot ids]
    while True:
        row_u = rows[node].view(np.uint32)
        row_f = rows[node].view(np.float32)
        meta = int(row_u[meta_w])
        steps += 1
        if meta >> 29 == 0:
            nch, left = (meta >> 25) & 15, meta & ((1 << 25) - 1)
            g, s = row_f[0:3], row_f[3:6]
            ds, ix = [], []
            for c in range(8):
                lo = [g[k] + _qb(row_u[qlo + c], k) * s[k] for k in range(3)]
                hi = [g[k] + _qb(row_u[qhi + c], k) * s[k] for k in range(3)]
                t1 = [(lo[k] - o[k]) * iv[k] for k in range(3)]
                t2 = [(hi[k] - o[k]) * iv[k] for k in range(3)]
                tmin = max(max(min(t1[0], t2[0]), min(t1[1], t2[1])),
                           min(t1[2], t2[2]))
                tmax = min(min(max(t1[0], t2[0]), max(t1[1], t2[1])),
                           max(t1[2], t2[2]))
                hit = tmax >= tmin and tmax > 0 and tmin < best and c < nch
                ds.append(tmin if hit else F(-LARGE_FLOAT))
                ix.append(c)
            for a, b in tp.SORT_NETS[8]:
                if ds[a] < ds[b]:
                    ds[a], ds[b], ix[a], ix[b] = ds[b], ds[a], ix[b], ix[a]
            m = sum(x > F(-LARGE_FLOAT) for x in ds)
            if m >= 1:
                if m >= 2:
                    stack.append([left, m - 1, ix])
                node = left + ix[m - 1]
                continue
        elif meta >> 29 == 1:
            t_min, tid_sel, w1_sel = F(LARGE_FLOAT), 2**31 - 1, F(0)
            for c in range(min(lmax, int(rows[node][leaf_w]))):
                v0 = row_f[ROW_WORDS + 16 * c:ROW_WORDS + 16 * c + 3]
                e1 = row_f[ROW_WORDS + 16 * c + 3:ROW_WORDS + 16 * c + 6]
                e2 = row_f[ROW_WORDS + 16 * c + 6:ROW_WORDS + 16 * c + 9]
                tid = int(rows[node][ROW_WORDS + 16 * c + 9])
                hx, hy, hz = (dy * e2[2] - dz * e2[1], dz * e2[0] - dx * e2[2],
                              dx * e2[1] - dy * e2[0])
                det = e1[0] * hx + e1[1] * hy + e1[2] * hz
                fba = F(1.0) / (F(1.0) if abs(det) < F(MT_EPSILON) else det)
                sx, sy, sz = ox - v0[0], oy - v0[1], oz - v0[2]
                w1 = fba * (sx * hx + sy * hy + sz * hz)
                qx, qy, qz = (sy * e1[2] - sz * e1[1], sz * e1[0] - sx * e1[2],
                              sx * e1[1] - sy * e1[0])
                w2 = fba * (dx * qx + dy * qy + dz * qz)
                t = fba * (e2[0] * qx + e2[1] * qy + e2[2] * qz)
                if not (abs(det) >= F(MT_EPSILON) and 0 <= w1 <= 1
                        and w2 >= 0 and w1 + w2 <= 1 and t > F(MT_EPSILON)):
                    continue
                fields = rows[node][a_off + 8 * c:a_off + 8 * c + 8]
                cls = _slot_class(fields, pool)
                keep = _alpha_keep(fields, w1, w2, pool)
                assert cls == 0 or keep == (cls == 1), (node, c, cls)
                tests += cls == 0   # the kernel tests only these
                if keep and (t, tid) < (t_min, tid_sel):
                    t_min, tid_sel, w1_sel = t, tid, w1
            if occ and t_min < best:
                best = F(-LARGE_FLOAT)
            elif not occ and (t_min, tid_sel) < (best, tri):
                best, tri = t_min, tid_sel
        if not stack or (occ and not best > 0):
            break
        top = stack[-1]
        node = top[0] + top[2][top[1] - 1]
        top[1] -= 1
        if top[1] == 0:
            stack.pop()
    if occ:
        return (F(0) if best < 0 else F(LARGE_FLOAT)), 0, steps, tests
    return (best if best < F(t_max) else F(LARGE_FLOAT)), tri, steps, tests


@pytest.mark.parametrize("mode", ["closest", "occlusion"])
def test_alpha_lookups_match_a_scalar_walk(mode):
    """``walk_work``'s hits, steps and ``alpha_lookups``, ray by ray,
    against the scalar walk's, which tests every candidate and checks
    each classed one's answer; the classes spare some of the tests."""
    wa = _cutout_wa()
    o, d = _rays(12)
    occ = mode == "occlusion"
    t_max = np.full(o.shape[0], 6.0 if occ else LARGE_FLOAT, F)
    kw = dict(t_max=torch.from_numpy(t_max), occlusion=occ)
    hits, steps, work = tp.walk_work(wa, torch.from_numpy(o),
                                     torch.from_numpy(d), alpha_ref=THR, **kw)
    for i in range(o.shape[0]):
        dist, tri, n_steps, tests = _scalar_walk(wa, o[i], d[i], t_max[i], occ)
        assert (float(hits.dist[i]), int(steps[i])) == (float(dist), n_steps)
        assert int(hits.tri[i]) == tri & ((1 << wa.tri_bits) - 1)
        assert int(work.alpha_lookups[i]) == tests, i
    assert 0 < int(work.alpha_lookups.sum()) < int(work.alpha_tests.sum())


@pytest.mark.parametrize("thr", [0.0, THR, 0.6, 1.5])
def test_alpha_classes_match_brute_force(thr):
    """Every leaf slot's class from ``alpha_classes`` equals the texel by
    texel reading of ``_slot_class``; at 0 every slot is kept, above 1
    every one is cut out."""
    wa = _cutout_wa()
    rows = wa.fused.numpy()
    pool = wa.alpha_pool.numpy()
    a_off = tp.alpha_offset(wa)
    cls = tp.alpha_classes(wa, thr).numpy().view(np.uint32)
    assert tp.alpha_classes(wa, thr) is tp.alpha_classes(wa, thr)
    seen = set()
    for node in range(rows.shape[0]):
        if int(rows[node].view(np.uint32)[META]) >> 29 != 1:
            continue
        for c in range(min(int(wa.max_leaf_tris), int(rows[node][LEAF]))):
            fields = rows[node][a_off + 8 * c:a_off + 8 * c + 8]
            want = _slot_class(fields, pool, thr)
            assert (int(cls[node]) >> (2 * c)) & 3 == want, (node, c)
            seen.add(want)
    assert seen == ({1} if thr == 0.0 else {2} if thr > 1 else {0, 1, 2})
