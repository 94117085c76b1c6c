"""4/8-wide quantized BVH (QBVH): build + flat SoA device format (port of
``vortex_rt_tpu/accel/qbvh.py``, NumPy, unchanged; ``width`` defaults
to 4).

Capability match for the reference's quantized wide acceleration structure:

* node format mirrors bvh_quantized_node_t (raytracing/common.h:56-67 /
  sim/simx/rt_traversal.h:14-52): per-node fp32 origin + per-axis power-of-2
  scale (stored as the reference's int8 exponent e with dequantization
  ``p + ldexp(q, e)``, rt_traversal.cpp:61-67), and per-child uint8
  quantized AABBs;
* quantization rule matches BVH::quantize (raytracing/bvh.cpp:215-264):
  ``e = ceil(log2(extent / 255))``, child min bytes floored, max bytes
  ceiled — dequantized boxes are conservative supersets, so traversal can
  only over-visit, never miss;
* children of a node are allocated contiguously and addressed as
  ``left_first + slot`` (rt_traversal.cpp:95-105).

Construction differs from the reference (which builds 4-wide directly with
repeated binary SAH cluster splits, bvh.cpp:30-109): we *collapse* the
binary binned-SAH tree from accel.bvh2 by repeatedly expanding the
largest-area internal child until the node has up to 4 children — same
class of tree, one builder to maintain, and the binary tree stays available
as the traversal oracle.

Device layout is SoA arrays sized for ONE gather per hot field per
traversal step (see ops.traverse_wide for why that matters on TPU).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

KIND_INTERNAL = 0
KIND_TRIS = 1
KIND_INSTANCE = 2

WIDTH = 4  # RT_BVH_WIDTH (hw/VX_config.toml:244)


@dataclasses.dataclass
class QBVH:
    """Flat wide-node pool.  Leaf payload in left_first/leaf_data:

    internal:       left_first = first child node id, leaf_data = -1
    triangle leaf:  left_first = first tri slot,      leaf_data = tri count
    instance leaf:  left_first = instance id,         leaf_data = instance id
    """

    origin: np.ndarray      # (N, 3) f32
    scale: np.ndarray       # (N, 3) f32 = 2^e (exact powers of two)
    qlo: np.ndarray         # (N, WIDTH*3) u8, child-major
    qhi: np.ndarray         # (N, WIDTH*3) u8
    nchild: np.ndarray      # (N,) i32
    left_first: np.ndarray  # (N,) i32
    leaf_data: np.ndarray   # (N,) i32
    kind: np.ndarray        # (N,) i32
    roots: np.ndarray       # (R,) i32 — wide root per input root
    depth: int              # max internal-descend depth over all roots

    @property
    def num_nodes(self) -> int:
        return self.origin.shape[0]


def _quantize_children(cmins: np.ndarray, cmaxs: np.ndarray):
    """Quantize child boxes against their common parent frame.

    Returns (origin(3,), scale(3,), qlo(k,3) u8, qhi(k,3) u8) with the
    reference's conservative floor/ceil rule."""
    origin = cmins.min(0)
    extent = np.maximum(cmaxs.max(0) - origin, 0.0)
    # e = ceil(log2(extent / 255)); clamp so 2^e stays a normal float
    with np.errstate(divide="ignore"):
        e = np.ceil(np.log2(np.maximum(extent, 1e-30) / 255.0))
    e = np.clip(e, -126, 127)
    scale = np.exp2(e).astype(np.float32)
    qlo = np.clip(np.floor((cmins - origin) / scale), 0, 255).astype(np.uint8)
    qhi = np.clip(np.ceil((cmaxs - origin) / scale), 0, 255).astype(np.uint8)
    return origin.astype(np.float32), scale, qlo, qhi


def collapse_flat(
    node_min: np.ndarray,
    node_max: np.ndarray,
    left_first: np.ndarray,
    tri_count: np.ndarray,
    roots: Sequence[int],
    leaf_kind: int = KIND_TRIS,
    leaf_payload: np.ndarray | None = None,
    width: int = WIDTH,
) -> QBVH:
    """Collapse flat binary BVH(s) (accel.bvh2 layout, possibly several
    trees packed in one pool) into one wide pool.

    ``leaf_kind``: what binary leaves become.  For KIND_TRIS the leaf keeps
    (first-slot, count); for KIND_INSTANCE the payload is
    ``leaf_payload[left_first]`` (the instance id, TLAS leaves have count 1).
    """
    n_est = node_min.shape[0] + len(roots) + 1
    o_origin = np.zeros((n_est, 3), np.float32)
    o_scale = np.ones((n_est, 3), np.float32)
    o_qlo = np.zeros((n_est, width * 3), np.uint8)
    o_qhi = np.zeros((n_est, width * 3), np.uint8)
    o_nchild = np.zeros(n_est, np.int32)
    o_left = np.zeros(n_est, np.int32)
    o_leaf = np.full(n_est, -1, np.int32)
    o_kind = np.zeros(n_est, np.int32)

    def grow(need: int):
        nonlocal o_origin, o_scale, o_qlo, o_qhi, o_nchild, o_left, o_leaf, o_kind
        cap = o_origin.shape[0]
        if need <= cap:
            return
        new = max(need, cap * 2)
        pad = new - cap
        o_origin = np.concatenate([o_origin, np.zeros((pad, 3), np.float32)])
        o_scale = np.concatenate([o_scale, np.ones((pad, 3), np.float32)])
        o_qlo = np.concatenate([o_qlo, np.zeros((pad, width * 3), np.uint8)])
        o_qhi = np.concatenate([o_qhi, np.zeros((pad, width * 3), np.uint8)])
        o_nchild = np.concatenate([o_nchild, np.zeros(pad, np.int32)])
        o_left = np.concatenate([o_left, np.zeros(pad, np.int32)])
        o_leaf = np.concatenate([o_leaf, np.full(pad, -1, np.int32)])
        o_kind = np.concatenate([o_kind, np.zeros(pad, np.int32)])

    def area(b: int) -> float:
        e = node_max[b] - node_min[b]
        return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    next_free = 0
    max_depth = 0

    def fill_leaf(out_id: int, b: int):
        if leaf_kind == KIND_TRIS:
            o_kind[out_id] = KIND_TRIS
            o_left[out_id] = int(left_first[b])
            o_leaf[out_id] = int(tri_count[b])
        else:
            iid = int(leaf_payload[left_first[b]])
            o_kind[out_id] = KIND_INSTANCE
            o_left[out_id] = iid
            o_leaf[out_id] = iid

    def build(out_id: int, b: int, depth: int):
        nonlocal next_free, max_depth
        max_depth = max(max_depth, depth)
        if tri_count[b] > 0:  # binary leaf
            fill_leaf(out_id, b)
            return
        # expand to up to `width` children, largest-area internal first
        kids: List[int] = [int(left_first[b]), int(left_first[b]) + 1]
        while len(kids) < width:
            best_i, best_a = -1, -1.0
            for i, k in enumerate(kids):
                if tri_count[k] == 0:
                    a = area(k)
                    if a > best_a:
                        best_i, best_a = i, a
            if best_i < 0:
                break
            k = kids.pop(best_i)
            kids.extend([int(left_first[k]), int(left_first[k]) + 1])
        cmins = node_min[kids]
        cmaxs = node_max[kids]
        org, scl, qlo, qhi = _quantize_children(cmins, cmaxs)
        grow(next_free + len(kids))
        base = next_free
        next_free += len(kids)
        o_kind[out_id] = KIND_INTERNAL
        o_origin[out_id] = org
        o_scale[out_id] = scl
        o_nchild[out_id] = len(kids)
        o_left[out_id] = base
        o_leaf[out_id] = -1
        o_qlo[out_id, : len(kids) * 3] = qlo.reshape(-1)
        o_qhi[out_id, : len(kids) * 3] = qhi.reshape(-1)
        for slot, k in enumerate(kids):
            build(base + slot, k, depth + 1)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100_000))
    try:
        wide_roots = []
        for r in roots:
            grow(next_free + 1)
            rid = next_free
            next_free += 1
            wide_roots.append(rid)
            build(rid, int(r), 1)
    finally:
        sys.setrecursionlimit(old_limit)

    return QBVH(
        origin=o_origin[:next_free],
        scale=o_scale[:next_free],
        qlo=o_qlo[:next_free],
        qhi=o_qhi[:next_free],
        nchild=o_nchild[:next_free],
        left_first=o_left[:next_free],
        leaf_data=o_leaf[:next_free],
        kind=o_kind[:next_free],
        roots=np.asarray(wide_roots, np.int32),
        depth=max_depth,
    )
