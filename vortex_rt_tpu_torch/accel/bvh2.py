"""Binary BVH: host-side binned-SAH builder over SoA triangle buffers
(port of ``vortex_rt_tpu/accel/bvh2.py``: the NumPy builder, unchanged,
so both packages build bit-identical trees with it, and
``build_bvh2_auto``, which picks the native C++ builder of
``runtime/native.py`` when asked).

Top-down binned SAH with BINS=8 over all 3 axes, cost =
leftArea*leftCount + rightArea*rightCount, leaf when no improving split.

* The builder emits a permutation ``tri_idx`` instead of reordering the
  triangle arrays in place.
* Nodes are emitted depth-first into flat SoA arrays (min/max/left_first/
  tri_count) ready to be uploaded as-is; internal nodes store the left
  child index and the right child is always ``left+1`` (children are
  allocated adjacently), matching the classic 2-wide layout the
  reference's raycast app traverses (tests/regression/raycast/render.h:74-126).

The same builder output also feeds the 4-wide quantized collapse in
``accel.qbvh``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vortex_rt_tpu_torch.utils.vecmath import aabb_area


@dataclasses.dataclass
class BVH2:
    """Flat binary BVH. Leaf iff tri_count > 0; then tri_idx[left_first :
    left_first + tri_count] are the triangle ids."""

    node_min: np.ndarray    # (N, 3) f32
    node_max: np.ndarray    # (N, 3) f32
    left_first: np.ndarray  # (N,) i32 — left child (internal) / first tri slot (leaf)
    tri_count: np.ndarray   # (N,) i32 — 0 for internal nodes
    tri_idx: np.ndarray     # (T,) i32 permutation into the tri buffer

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]

    def depth(self) -> int:
        d = np.zeros(self.num_nodes, np.int32)
        best = 1
        for i in range(self.num_nodes):
            if self.tri_count[i] == 0:
                l = self.left_first[i]
                d[l] = d[l + 1] = d[i] + 1
                best = max(best, d[i] + 2)
        return best

    def sah_cost(self) -> float:
        area = aabb_area(self.node_min, self.node_max)
        root = max(float(area[0]), 1e-12)
        internal = self.tri_count == 0
        return float(
            (np.where(internal, 1.0, 0.0) * area).sum() / root
            + (self.tri_count * area).sum() / root
        )


def _sah_split(cen: np.ndarray, bmin: np.ndarray, bmax: np.ndarray,
               tmin: np.ndarray, tmax: np.ndarray, bins: int):
    """Best binned-SAH split of one node.

    Returns (axis, threshold, cost) or None if every candidate bin is
    degenerate.  Mirrors findBestSplitPlane (bvh.cpp:135-191): bins are laid
    over the *centroid* extent per axis; plane cost is
    leftArea*leftCount + rightArea*rightCount.
    """
    n = cen.shape[0]
    best = None  # (cost, axis, threshold)
    for axis in range(3):
        cmin = cen[:, axis].min()
        cmax = cen[:, axis].max()
        if cmax <= cmin:
            continue
        scale = bins / (cmax - cmin)
        b = np.minimum((cen[:, axis] - cmin) * scale, bins - 1).astype(np.int32)
        # per-bin counts and bounds via scatter-min/max
        counts = np.bincount(b, minlength=bins)
        binmin = np.full((bins, 3), 1e30, np.float32)
        binmax = np.full((bins, 3), -1e30, np.float32)
        np.minimum.at(binmin, b, tmin)
        np.maximum.at(binmax, b, tmax)
        # prefix (left) and suffix (right) sweeps over the bins-1 planes
        lcnt = np.cumsum(counts)[:-1]
        rcnt = n - lcnt
        lmin = np.minimum.accumulate(binmin, axis=0)[:-1]
        lmax = np.maximum.accumulate(binmax, axis=0)[:-1]
        rmin = np.minimum.accumulate(binmin[::-1], axis=0)[::-1][1:]
        rmax = np.maximum.accumulate(binmax[::-1], axis=0)[::-1][1:]

        def _area(mn, mx):
            e = np.maximum(mx - mn, 0.0)
            return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

        cost = np.where(lcnt > 0, _area(lmin, lmax) * lcnt, 0.0) + np.where(
            rcnt > 0, _area(rmin, rmax) * rcnt, 0.0
        )
        cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
        k = int(np.argmin(cost))
        if np.isfinite(cost[k]):
            thr = cmin + (k + 1) / scale
            if best is None or cost[k] < best[0]:
                best = (float(cost[k]), axis, float(thr))
    return best


def build_bvh2(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    max_leaf_tris: int = 4,
    sah_bins: int = 8,
) -> BVH2:
    """Build a binary BVH over triangles (v0, v1, v2): (T, 3) float32 each."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    cen = (v0 + v1 + v2) / 3.0
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    return build_bvh2_aabbs(tmin, tmax, cen, max_leaf_tris, sah_bins)


def build_bvh2_aabbs(
    tmin: np.ndarray,
    tmax: np.ndarray,
    cen: np.ndarray | None = None,
    max_leaf_tris: int = 4,
    sah_bins: int = 8,
) -> BVH2:
    """Build a binary BVH over arbitrary AABBs (also used for the TLAS over
    transformed instance bounds, mirroring TLAS::build bvh.cpp:286-321)."""
    tmin = np.asarray(tmin, np.float32)
    tmax = np.asarray(tmax, np.float32)
    if cen is None:
        cen = (tmin + tmax) * 0.5
    t = tmin.shape[0]
    assert t > 0, "empty primitive set"

    order = np.arange(t, dtype=np.int32)
    node_min, node_max, left_first, tri_count = [], [], [], []

    def _push(lo: int, hi: int) -> int:
        idx = len(node_min)
        sel = order[lo:hi]
        node_min.append(tmin[sel].min(0))
        node_max.append(tmax[sel].max(0))
        left_first.append(lo)
        tri_count.append(hi - lo)
        return idx

    root = _push(0, t)
    stack = [root]
    while stack:
        ni = stack.pop()
        lo, n = left_first[ni], tri_count[ni]
        hi = lo + n
        if n <= max_leaf_tris:
            continue
        sel = order[lo:hi]
        split = _sah_split(cen[sel], node_min[ni], node_max[ni],
                           tmin[sel], tmax[sel], sah_bins)
        if split is not None:
            # split only if it beats keeping the node as a leaf
            # (calculateNodeCost = area(parent) * count, common.h)
            cost, axis, thr = split
            parent_cost = float(aabb_area(node_min[ni], node_max[ni])) * n
            if cost >= parent_cost:
                split = None
        if split is None:
            # forced median split on the widest centroid axis to respect
            # max_leaf_tris (reference TLAS does the same fallback,
            # bvh.cpp:372-384).  Even with IDENTICAL centroids we must
            # split by index: consumers (TLAS instance leaves, qbvh
            # collapse) rely on leaves respecting max_leaf_tris — an
            # oversize TLAS leaf would silently drop instances.
            ext = cen[sel].max(0) - cen[sel].min(0)
            axis = int(np.argmax(ext))
            if ext[axis] > 0:
                med = np.argsort(cen[sel, axis], kind="stable")
                order[lo:hi] = sel[med]
            mid = n // 2
            l = _push(lo, mid + lo)
            _push(mid + lo, hi)
        else:
            cost, axis, thr = split
            mask = cen[sel, axis] < thr
            order[lo:hi] = np.concatenate([sel[mask], sel[~mask]])
            mid = int(mask.sum())
            if mid == 0 or mid == n:
                continue
            l = _push(lo, lo + mid)
            _push(lo + mid, hi)
        left_first[ni] = l
        tri_count[ni] = 0
        stack.append(l + 1)
        stack.append(l)

    return BVH2(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        left_first=np.asarray(left_first, np.int32),
        tri_count=np.asarray(tri_count, np.int32),
        tri_idx=order,
    )


def build_bvh2_auto(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    max_leaf_tris: int = 4,
    sah_bins: int = 8,
    prefer_native: bool = True,
) -> BVH2:
    """Build with the native C++ builder (``csrc/builder.cpp``) when
    ``prefer_native``, else with the NumPy implementation.  Same
    algorithm either way.  A native build that cannot be compiled or
    loaded raises: there is no fallback to NumPy."""
    if prefer_native:
        from vortex_rt_tpu_torch.runtime.native import build_bvh2_native

        return build_bvh2_native(v0, v1, v2, max_leaf_tris, sah_bins)
    return build_bvh2(v0, v1, v2, max_leaf_tris, sah_bins)
