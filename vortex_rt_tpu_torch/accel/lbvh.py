"""On-device LBVH: Morton sort + Karras hierarchy + wide collapse + refit
+ packed emit (port of ``vortex_rt_tpu/accel/lbvh.py``, K5).

The tree is built and refit where the vertices live, with no host round
trip, so a scene whose vertices move is re-bounded every frame (ladder
config 5) and a static one can be built on the device (ladder config 3).

Pipeline (``build_lbvh_topo``):

1. the scene box, and 30-bit Morton codes of the triangle centroids over
   it;
2. a stable sort by code (``torch.sort``, as the JAX package calls
   ``jnp.argsort``);
3. the Karras 2012 binary radix tree over all triangles, ties broken by
   index;
4. subtree-cut leaves: every maximal Karras subtree of at most
   ``leaf_size`` triangles becomes one wide leaf (a contiguous Morton
   range);
5. the collapse to 4- or 8-wide nodes: above the cut, internals at depth
   % 2 (or 3) == 0 survive and adopt their grandchildren (or
   great-grandchildren); ids come from two exclusive prefix sums (on the
   card inside the collapse's one launch, which also makes the refit
   kernel's plan of the topology);
6. bottom-up boxes of every binary node;
7. quantize and pack into the traversal tables of
   ``ops/traverse_wide.py`` (``nodes``, ``tri_rows`` and, at width 8,
   the fused rows the 8-wide walk reads).

``refit_lbvh`` keeps the topology (steps 1-5) and redoes steps 6-7: the
per-frame update.  With ``compact_plan`` it runs only over the pool rows,
leaf rows and survivors the collapse assigned, and copies nothing to the
host.

Every step has two versions.  On CUDA tensors it launches a hand-written
kernel (``csrc/lbvh_karras.cu``, ``lbvh_collapse.cu``, ``lbvh_refit.cu``,
``lbvh_pack.cu``, built by ``runtime/kernels.py``) or raises; on CPU
tensors it runs the plain PyTorch version (``*_ref``), which is the JAX
arithmetic in torch ops, sparse-table refit included.  There is no
fallback between the two.  All integer fields equal the JAX package's,
and so do the packed words: the scale exponent ``ceil(log2(extent /
255))`` is taken from the float's bits in both versions (ROADMAP hazard
H7).

``method="sah"`` replaces step 3 with the JAX package's sweep-SAH tree
(measured there and not adopted): every contiguous range of the sorted
triangles splits at its SAH-cheapest position within its middle half, one
level of ranges at a time (``_sah_sweep_tree``; its kernel is
``csrc/lbvh_sah.cu``, every level in one cooperative launch,
``_sah_sweep_tree_ref`` its plain version).  Its
depth is not bounded by the key's length: the build reports the collapsed
tree's real depth (``LBVHNodes.wide_depth``), and ``wide_arrays_from_lbvh``
takes it and refuses a tree deeper than the walk's stack (ROADMAP H8).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vortex_rt_tpu_torch.accel.qbvh import (
    KIND_INSTANCE, KIND_INTERNAL, KIND_TRIS,
)
from vortex_rt_tpu_torch.ops import packet_walk, traverse_packet
from vortex_rt_tpu_torch.ops.traverse_wide import (
    INST_ROOT, INST_XFORM, ROW_WORDS, WideArrays, fuse_rows, left_bits,
    row_layout,
)
from vortex_rt_tpu_torch.runtime import kernels

_I32 = torch.int32
_I64 = torch.int64
_F32 = torch.float32


@dataclasses.dataclass
class LBVHNodes:
    """Packed traversal arrays for a single-mesh LBVH scene."""

    nodes: torch.Tensor       # (pool [+1 TLAS root], 32) int32 node records
    tri_rows: torch.Tensor    # (rows, 16*leaf) f32: one leaf per row
    num_leaves: torch.Tensor  # 0-dim: leaf rows in use
    fused: Optional[torch.Tensor] = None  # (pool, 32 + 16*leaf) int32
    # the collapsed tree's depth (root = 1), where it is not bounded by
    # the Morton key's length: the sweep-SAH build sets it
    wide_depth: Optional[int] = None


class LBVHTopo(NamedTuple):
    """Fixed topology for the refit path.  Node-id convention: Karras
    internals 0..T-2, triangle leaves (T-1)+j.  The fields are the JAX
    package's, int32 (``surv`` bool), plus ``parent``, which the
    bottom-up refit kernel climbs."""

    order: torch.Tensor       # (T,) Morton triangle permutation
    lchild: torch.Tensor      # (T-1,) Karras left child (old ids)
    rchild: torch.Tensor      # (T-1,)
    surv: torch.Tensor        # (T-1,) bool: survives the wide collapse
    ch_old: torch.Tensor      # (T-1, width) old ids of wide children (-1)
    arity: torch.Tensor       # (T-1,)
    base: torch.Tensor        # (T-1,) new id of first wide child
    newid: torch.Tensor       # (2T-1,) new id of surviving/cut nodes
    row_lo: torch.Tensor      # (T,) first sorted-tri slot of leaf row j
    row_cnt: torch.Tensor     # (T,) tri count of leaf row j (0 = unused)
    leaf_newid: torch.Tensor  # (T,) wide-pool id of leaf row j (-1 unused)
    lo: torch.Tensor          # (T-1,) Karras internal leaf-range start
    hi: torch.Tensor          # (T-1,) inclusive range end
    parent: torch.Tensor      # (2T-1,) binary parent (old ids; root: 0)


def _cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no LBVH build for device {t.device}")
    return False


MAX_TRIS = 1 << 26  # the depth bound of wide_arrays_from_lbvh holds below


def _check_verts(v0, v1, v2) -> int:
    """The triangle count of three (T, 3) float32 tensors on one device."""
    for v in (v0, v1, v2):
        if (v.dtype != _F32 or v.dim() != 2 or v.shape[1] != 3
                or v.shape != v0.shape or v.device != v0.device):
            raise ValueError("vertices must be three (T, 3) float32 tensors "
                             "on one device")
    if not 2 <= v0.shape[0] < MAX_TRIS:
        raise ValueError(f"the LBVH takes 2 to {MAX_TRIS - 1} triangles, got "
                         f"{v0.shape[0]}")
    return int(v0.shape[0])


def _check_i32(dev, **arrays) -> None:
    """Each ``name=(tensor, shape)``: contiguous int32 (``surv``: bool) of
    that shape on ``dev``, so a kernel may take its pointer."""
    for name, (a, shape) in arrays.items():
        want = torch.bool if name == "surv" else _I32
        if (a.dtype != want or tuple(a.shape) != shape or a.device != dev
                or not a.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {want} tensor of shape {shape} "
                f"on {dev}, got {a.dtype}{tuple(a.shape)} on {a.device}")


def _check_topo(topo: "LBVHTopo", l: int, dev) -> int:
    """Check the topology against ``l`` triangles; returns its width."""
    width = int(topo.ch_old.shape[-1])
    i, n = (l - 1,), (2 * l - 1,)
    _check_i32(dev, order=(topo.order, (l,)), lchild=(topo.lchild, i),
               rchild=(topo.rchild, i), surv=(topo.surv, i),
               ch_old=(topo.ch_old, (l - 1, width)), arity=(topo.arity, i),
               base=(topo.base, i), newid=(topo.newid, n),
               row_lo=(topo.row_lo, (l,)), row_cnt=(topo.row_cnt, (l,)),
               leaf_newid=(topo.leaf_newid, (l,)), lo=(topo.lo, i),
               hi=(topo.hi, i), parent=(topo.parent, n))
    return width


def _launch(lib: kernels.KernelLibrary, fn: str, dev, *args,
            n_kernels: int = 1, counts=None) -> None:
    """Call C entry point ``fn`` on the current stream of ``dev``; raises
    on a launch error and counts the ``n_kernels`` kernels it launches
    under the library's name (or ``counts``, {count name: kernels}, when
    one entry point launches kernels counted apart)."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib.lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: {lib.error_string(err)} "
                           f"({err})")
    for name, n in (counts or {lib.name: n_kernels}).items():
        kernels.LAUNCHES[name] += n


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """u32 words held in int64 -> int32 with the same bits."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(_I32)


# --------------------------------------------------------- Morton codes

def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v (int64) so there are 2 zero bits
    between each."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor
             ) -> torch.Tensor:
    """30-bit Morton code (int32) of coordinates in [0, 1)."""
    def q(c):
        return (c * 1024.0).clamp(0.0, 1023.0).to(_I64)

    return (_expand_bits(q(x)) * 4 + _expand_bits(q(y)) * 2
            + _expand_bits(q(z))).to(_I32)


def _half_area(mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """Half the surface area of the boxes [mn, mx] (..., 3), evaluated as
    the JAX package evaluates it: (e0*e1 + e1*e2) + e2*e0 over the
    extents clamped at 0 (the PLOC merge cost; ``csrc/ploc_merge.cu``
    keeps the same order)."""
    e = (mx - mn).clamp_min(0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def _scene_box(v0, v1, v2):
    """Plain version of the scene box: the (3,) min and max over every
    vertex.  A zero of either sign comes out as +0 (x + 0.0), so the box's
    words do not depend on the order of the reduction; the codes do not
    depend on the sign of a zero."""
    tmin = torch.minimum(torch.minimum(v0, v1), v2)
    tmax = torch.maximum(torch.maximum(v0, v1), v2)
    return tmin.amin(0) + 0.0, tmax.amax(0) + 0.0


def morton_codes_ref(v0, v1, v2, smin, smax) -> torch.Tensor:
    """Plain version: codes of the centroids over the box [smin, smax]."""
    three = torch.tensor(3.0, dtype=_F32, device=v0.device)
    cen = (v0 + v1 + v2) / three  # (a 0-dim divisor: true division)
    ext = (smax - smin).clamp_min(1e-30)
    n = (cen - smin) / ext
    return morton3d(n[:, 0], n[:, 1], n[:, 2])


def scene_codes_ref(v0, v1, v2):
    """Plain version of ``scene_codes``."""
    smin, smax = _scene_box(v0, v1, v2)
    return morton_codes_ref(v0, v1, v2, smin, smax), smin, smax


def scene_codes(v0, v1, v2):
    """The scene box and the Morton codes of the triangle centroids over it
    -> (codes (T,) int32, smin, smax (3,) float32).  CUDA tensors: one
    cooperative launch (``box_morton_kernel``: the box, then the codes);
    CPU tensors: ``scene_codes_ref``."""
    t = _check_verts(v0, v1, v2)
    if not _cuda(v0):
        return scene_codes_ref(v0, v1, v2)
    lib = kernels.load("lbvh_karras")
    dev = v0.device
    v0, v1, v2 = (v.contiguous() for v in (v0, v1, v2))
    box = torch.empty((2, 3), dtype=_F32, device=dev)
    part = torch.empty(6 * lib.lib.vrt_lbvh_box_blocks(t), dtype=_F32,
                       device=dev)
    codes = torch.empty(t, dtype=_I32, device=dev)
    _launch(lib, "vrt_lbvh_box_morton", dev, v0.data_ptr(), v1.data_ptr(),
            v2.data_ptr(), t, part.data_ptr(), box.data_ptr(),
            codes.data_ptr())
    return codes, box[0], box[1]


# ------------------------------------------------------------- Karras

def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 0 <= x < 2**32 as a 32-bit word (exact: the
    float64 exponent of x is its bit length)."""
    return 32 - torch.frexp(x.to(torch.float64))[1].to(_I64)


def _karras_ref(lcodes: torch.Tensor, l: int):
    """Plain version: the JAX package's fixed-step vectorized searches
    (31 doubling steps, 32 + 32 bisection steps over every node)."""
    dev = lcodes.device
    codes = lcodes.to(_I64)
    i_idx = torch.arange(l - 1, dtype=_I64, device=dev)

    def delta(i, j):
        valid = (j >= 0) & (j < l)
        jj = j.clamp(0, l - 1)
        x = codes[i] ^ codes[jj]
        d = torch.where(x == 0, 32 + _clz32(i ^ jj), _clz32(x))
        return torch.where(valid, d, -1)

    d_plus = delta(i_idx, i_idx + 1)
    d_minus = delta(i_idx, i_idx - 1)
    d = torch.where(d_plus >= d_minus, 1, -1).to(_I64)
    delta_min = delta(i_idx, i_idx - d)

    lmax_s = torch.full((l - 1,), 2, dtype=_I64, device=dev)
    for _ in range(31):
        grow = delta(i_idx, i_idx + lmax_s * d) > delta_min
        lmax_s = torch.where(grow, (lmax_s * 2).clamp_max(2**28), lmax_s)
    ln = torch.zeros(l - 1, dtype=_I64, device=dev)
    step = lmax_s
    for _ in range(32):
        step = step // 2
        ok = (step > 0) & (delta(i_idx, i_idx + (ln + step) * d) > delta_min)
        ln = torch.where(ok, ln + step, ln)
    j_end = i_idx + ln * d

    delta_node = delta(i_idx, j_end)
    s = torch.zeros(l - 1, dtype=_I64, device=dev)
    step = ln
    for _ in range(32):
        step = (step + 1) // 2
        cand = s + step
        ok = (cand < ln) & (delta(i_idx, i_idx + cand * d) > delta_node)
        s = torch.where(ok, cand, s)
        step = torch.where(step > 1, step, 0)
    gamma = i_idx + s * d + d.clamp_max(0)

    lo = torch.minimum(i_idx, j_end)
    hi = torch.maximum(i_idx, j_end)
    lchild = torch.where(lo == gamma, (l - 1) + gamma, gamma)
    rchild = torch.where(hi == gamma + 1, (l - 1) + gamma + 1, gamma + 1)
    return tuple(a.to(_I32) for a in (lchild, rchild, lo, hi))


def _karras(lcodes: torch.Tensor, l: int):
    """Karras 2012 ranges and splits over the sorted codes ->
    (lchild, rchild, lo, hi), (l-1,) int32 old ids (internal k in
    [0, l-1), leaf j at (l-1)+j)."""
    if not _cuda(lcodes):
        return _karras_ref(lcodes, l)
    lib = kernels.load("lbvh_karras")
    dev = lcodes.device
    lcodes = lcodes.contiguous()
    _check_i32(dev, lcodes=(lcodes, (l,)))
    out = [torch.empty(l - 1, dtype=_I32, device=dev) for _ in range(4)]
    _launch(lib, "vrt_lbvh_karras", dev, lcodes.data_ptr(), l,
            *(a.data_ptr() for a in out))
    return tuple(out)


# ------------------------------------------------------ sweep-SAH tree

SAH_MAX_LEVELS = 96      # the JAX loop's cap
_SAH_INVALID = 3e38      # the cost of a position no range may split at


def _seg_scan_ref(box: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented scan of (l, 6) boxes (min xyz, max xyz) over
    positions 0..l-1, each position's range starting at ``start``: the
    doubling steps of an associative scan (min and max are exact in any
    order)."""
    l = box.shape[0]
    pos = torch.arange(l, dtype=_I64, device=box.device)
    k = 1
    while k < l:
        prev = torch.cat([box[:k], box[:-k]])
        joined = torch.cat([torch.minimum(prev[:, :3], box[:, :3]),
                            torch.maximum(prev[:, 3:], box[:, 3:])], 1)
        box = torch.where((pos - k >= start).unsqueeze(1), joined, box)
        k *= 2
    return box


def _sah_sweep_tree_ref(lmin: torch.Tensor, lmax: torch.Tensor, l: int,
                        live: Optional[list] = None):
    """Plain version of ``_sah_sweep_tree``: the JAX level body in torch
    ops, on any device.  ``live``, when given, gets the number of
    positions in ranges longer than one at the start of each level."""
    dev = lmin.device
    pos = torch.arange(l, dtype=_I64, device=dev)
    leaf = torch.cat([lmin, lmax], 1)
    inv = torch.full((l,), _SAH_INVALID, dtype=_F32, device=dev)
    seg_lo = torch.zeros(l, dtype=_I64, device=dev)
    seg_hi = torch.full((l,), l - 1, dtype=_I64, device=dev)
    node = torch.zeros(l, dtype=_I64, device=dev)
    next_id = 1
    out = torch.zeros((4, l), dtype=_I64, device=dev)  # slot l-1 drops
    levels = 0
    while levels < SAH_MAX_LEVELS:
        levels += 1
        length = seg_hi - seg_lo + 1
        active = length > 1
        if live is not None:
            live.append(int(active.sum()))
        pre = _seg_scan_ref(leaf, seg_lo)
        rev = (l - 1) - seg_hi.flip(0)
        suf = _seg_scan_ref(leaf.flip(0), rev).flip(0)
        sa_pre = _half_area(pre[:, :3], pre[:, 3:])
        sa_suf = _half_area(suf[:, :3], suf[:, 3:])
        sa_next = torch.cat([sa_suf[1:], torch.zeros(1, dtype=_F32,
                                                     device=dev)])
        cnt_l = (pos - seg_lo + 1).to(_F32)
        cnt_r = (seg_hi - pos).to(_F32)
        cost = sa_pre * cnt_l + sa_next * cnt_r
        minside = torch.clamp_min(length // 4, 1).to(_F32)
        valid = (active & (pos < seg_hi) & (cnt_l >= minside)
                 & (cnt_r >= minside))
        cost = torch.where(valid, cost, inv)
        # each range's cheapest position, the lower one on equal cost
        seg_min = inv.clone().scatter_reduce(0, seg_lo, cost, "amin")
        cand = torch.where(cost == seg_min[seg_lo], pos, l)
        split = torch.full((l,), l, dtype=_I64, device=dev).scatter_reduce(
            0, seg_lo, cand, "amin")[seg_lo]

        rep = (pos == seg_lo) & active
        left_int = split > seg_lo
        right_int = seg_hi > split + 1
        contrib = torch.where(rep, left_int.to(_I64) + right_int.to(_I64), 0)
        base = next_id + torch.cumsum(contrib, 0) - contrib
        lid = torch.where(left_int, base, (l - 1) + seg_lo)
        rid = torch.where(right_int, base + left_int.to(_I64),
                          (l - 1) + seg_hi)
        m = torch.where(rep, node, l - 1)
        for k, val in enumerate((lid, rid, seg_lo, seg_hi)):
            out[k, m] = torch.where(rep, val, 0)
        left = pos <= split
        lid_all, rid_all = lid[seg_lo], rid[seg_lo]
        seg_lo, seg_hi, node = (
            torch.where(active, torch.where(left, seg_lo, split + 1), seg_lo),
            torch.where(active, torch.where(left, split, seg_hi), seg_hi),
            torch.where(active, torch.where(left, lid_all, rid_all), node))
        next_id += int(contrib.sum())
        if not bool((seg_hi > seg_lo).any()):
            break
    lch, rch, nlo, nhi = (out[k, :l - 1].to(_I32) for k in range(4))
    return lch, rch, nlo, nhi, levels


def _sah_sweep_tree(lmin: torch.Tensor, lmax: torch.Tensor, l: int,
                    live: Optional[list] = None):
    """The sweep-SAH binary tree over ``l`` Morton-sorted leaf boxes
    ((l, 3) float32 each) -> (lchild, rchild, lo, hi, levels): the
    children and leaf ranges in the Karras id layout (internal k in
    [0, l-1), root 0, leaf j at (l-1)+j), as the JAX ``_sah_sweep_tree``
    gives them, and the levels the loop ran (the deepest internal sits at
    binary depth ``levels - 1``).  ``live``, when given, gets the number
    of positions in ranges longer than one at the start of each level.
    CUDA tensors run ``csrc/lbvh_sah.cu``: every level in one cooperative
    launch, then one read of the level count (with the live counts) to
    the host; CPU tensors run ``_sah_sweep_tree_ref``."""
    for b in (lmin, lmax):
        if (b.dtype != _F32 or tuple(b.shape) != (l, 3)
                or b.device != lmin.device):
            raise ValueError(f"leaf boxes must be two ({l}, 3) float32 "
                             f"tensors on one device")
    if l < 2:
        raise ValueError("the sweep-SAH tree needs two leaves")
    if not _cuda(lmin):
        return _sah_sweep_tree_ref(lmin, lmax, l, live)
    lib = kernels.load("lbvh_sah")
    dev = lmin.device
    lmin, lmax = lmin.contiguous(), lmax.contiguous()
    with torch.cuda.device(dev):
        blocks = lib.lib.vrt_sah_blocks(l)
    if blocks <= 0:
        raise RuntimeError(f"vrt_sah_blocks failed: "
                           f"{lib.error_string(-blocks)} ({-blocks})")
    scratch = torch.empty(lib.lib.vrt_sah_scratch(l, blocks), dtype=_I32,
                          device=dev)
    out = torch.empty((4, l - 1), dtype=_I32, device=dev)
    _launch(lib, "vrt_sah_sweep", dev, lmin.data_ptr(), lmax.data_ptr(), l,
            blocks, *(a.data_ptr() for a in out), scratch.data_ptr())
    at = lib.lib.vrt_sah_live_offset(l, blocks)
    counts = scratch[at:at + SAH_MAX_LEVELS + 2].tolist()   # the one read
    levels = counts[-1]
    if live is not None:
        live.extend(counts[:levels])
    return (*out.unbind(0), levels)


def wide_depth_of(max_depth, width: int):
    """The collapsed tree's depth in the host builder's count (root = 1,
    leaf rows counted) from its deepest internal's binary depth D: the
    deepest survivor sits at the last multiple of the stride <= D, and
    its children are leaves."""
    stride = 2 if width == 4 else 3
    return max_depth // stride + 2


# ------------------------------------------------------------- collapse

def _parents_ref(lchild, rchild, l: int) -> torch.Tensor:
    i_idx = torch.arange(l - 1, dtype=_I32, device=lchild.device)
    parent = torch.zeros(2 * l - 1, dtype=_I32, device=lchild.device)
    parent[lchild.to(_I64)] = i_idx
    parent[rchild.to(_I64)] = i_idx
    return parent


def _collapse_wide_ref(lchild, rchild, lo, hi, l: int, max_leaf: int,
                       width: int = 4):
    """Plain version of the subtree cut and depth-stride collapse."""
    dev = lchild.device
    n_nodes = 2 * l - 1
    lchild, rchild, lo, hi = (a.to(_I64) for a in (lchild, rchild, lo, hi))
    i_idx = torch.arange(l - 1, dtype=_I64, device=dev)
    parent = _parents_ref(lchild, rchild, l).to(_I64)

    size_int = hi - lo + 1
    leafish = size_int <= max_leaf

    # top-down depth sweep over internal nodes
    depth = torch.zeros(l - 1, dtype=_I64, device=dev)
    ready = i_idx == 0
    p = parent[: l - 1]
    it = 0
    while not bool(ready.all()) and it < 192:
        can = ready[p] & ~ready & (i_idx != 0)
        depth = torch.where(can, depth[p] + 1, depth)
        ready = ready | can
        it += 1

    stride = 2 if width == 4 else 3
    surv = ~leafish & ((depth % stride) == 0)

    def is_lf(c):
        return (c >= l - 1) | leafish[c.clamp(0, l - 2)]

    is_leaf_l = is_lf(lchild)
    is_leaf_r = is_lf(rchild)
    lc_s = lchild.clamp(0, l - 2)
    rc_s = rchild.clamp(0, l - 2)
    a_left = torch.where(is_leaf_l, 1, 2)
    a_right = torch.where(is_leaf_r, 1, 2)
    arity4 = a_left + a_right
    none = torch.full_like(lchild, -1)

    left0 = torch.where(is_leaf_l, lchild, lchild[lc_s])
    left1 = torch.where(is_leaf_l, none, rchild[lc_s])
    right0 = torch.where(is_leaf_r, rchild, lchild[rc_s])
    right1 = torch.where(is_leaf_r, none, rchild[rc_s])

    def slot4(t):
        li = left0 if t == 0 else left1
        u = t - a_left
        ri = torch.where(u == 0, right0, torch.where(u == 1, right1, none))
        return torch.where(t < a_left, li,
                           torch.where(t < arity4, ri, none))

    ch4 = torch.stack([slot4(t) for t in range(4)], 1)

    if width == 4:
        ch_old, arity = ch4, arity4
    else:
        a_l8 = torch.where(is_leaf_l, 1, arity4[lc_s])
        a_r8 = torch.where(is_leaf_r, 1, arity4[rc_s])
        arity = a_l8 + a_r8
        ch4_l = ch4[lc_s]
        ch4_r = ch4[rc_s]

        def sel4(m, t):
            return m.gather(1, t.clamp(0, 3).unsqueeze(1)).squeeze(1)

        def slot8(t):
            tt = torch.full_like(lchild, t)
            lt = torch.where(is_leaf_l, lchild if t == 0 else none,
                             sel4(ch4_l, tt))
            u = tt - a_l8
            rt = torch.where(is_leaf_r, torch.where(u == 0, rchild, none),
                             sel4(ch4_r, u))
            return torch.where(tt < a_l8, lt,
                               torch.where(tt < arity, rt, none))

        ch_old = torch.stack([slot8(t) for t in range(8)], 1)

    # new ids: root = 0; survivor children get contiguous slots after an
    # exclusive prefix sum of survivor arities
    contrib = torch.where(surv, arity, 0)
    base = 1 + torch.cumsum(contrib, 0) - contrib

    newid = torch.full((n_nodes + 1,), -1, dtype=_I64, device=dev)
    newid[0] = 0
    for t in range(width):
        idx = ch_old[:, t]
        ok = surv & (idx >= 0)
        # (index n_nodes is a spare slot: the JAX scatter's mode="drop")
        newid[torch.where(ok, idx, n_nodes)] = torch.where(ok, base + t, -1)
    newid = newid[:n_nodes]

    # leaf rows: one per maximal leafish node, numbered by a prefix sum
    # in node-id order
    max_int = leafish & ~leafish[parent[: l - 1].clamp(0, l - 2)]
    max_tri = ~leafish[parent[l - 1:].clamp(0, l - 2)]
    is_max = torch.cat([max_int, max_tri])
    row_of = torch.cumsum(is_max.to(_I64), 0) - 1
    node_lo = torch.cat([lo, torch.arange(l, dtype=_I64, device=dev)])
    node_cnt = torch.cat([size_int, torch.ones(l, dtype=_I64, device=dev)])
    tgt = torch.where(is_max, row_of, l)

    def rows(fill, val):
        out = torch.full((l + 1,), fill, dtype=_I64, device=dev)
        out[tgt] = torch.where(is_max, val, fill)
        return out[:l].to(_I32)

    return (surv, ch_old.to(_I32), arity.to(_I32), base.to(_I32),
            newid.to(_I32), rows(0, node_lo), rows(0, node_cnt),
            rows(-1, newid), parent.to(_I32))


def _collapse_wide(lchild, rchild, lo, hi, l: int, max_leaf: int,
                   width: int = 4, state: Optional[list] = None):
    """Subtree cut + depth-stride collapse of the binary tree ->
    (surv, ch_old, arity, base, newid, row_lo, row_cnt, leaf_newid,
    parent); see ``LBVHTopo``.  CUDA tensors: one cooperative launch
    (``csrc/lbvh_collapse.cu``), which also makes the refit kernel's plan
    of the topology (treelets of at most half the refit's tile) and its
    leaf-row count; CPU tensors: ``_collapse_wide_ref``.  ``state``, a
    list, receives the topology's refit state (``_TopoState``: the count,
    and on the card the plan) for ``topo_state``."""
    if width not in (4, 8):
        raise ValueError(f"unsupported BVH width {width}")
    if not _cuda(lchild):
        out = _collapse_wide_ref(lchild, rchild, lo, hi, l, max_leaf, width)
        if state is not None:
            state.append(_TopoState(num_leaves=(out[6] > 0).sum()))
        return out
    lib = kernels.load("lbvh_collapse")
    cap = kernels.load("lbvh_refit").lib.vrt_lbvh_refit_tile() // 2
    dev = lchild.device
    lchild, rchild, lo, hi = (a.contiguous() for a in (lchild, rchild, lo, hi))
    _check_i32(dev, lchild=(lchild, (l - 1,)), rchild=(rchild, (l - 1,)),
               lo=(lo, (l - 1,)), hi=(hi, (l - 1,)))
    n, n_nodes = l - 1, 2 * l - 1

    def i32(*shape):
        return torch.empty(shape, dtype=_I32, device=dev)

    # unfilled: the launch writes every word
    parent, newid = i32(n_nodes), i32(n_nodes)
    surv = torch.empty(n, dtype=torch.bool, device=dev)
    ch_old, arity, base = i32(n, width), i32(n), i32(n)
    row_lo, row_cnt, leaf_newid = i32(l), i32(l), i32(l)
    num_leaves = torch.empty((), dtype=_I64, device=dev)
    plan = RefitPlan(rec=i32(n, 2), blocks=i32(-(-l // cap), 4),
                     roots=i32(l, 2), gstart=i32(n), arrived=i32(n))
    scratch = i32(lib.lib.vrt_lbvh_collapse_scratch(l, cap))
    _launch(lib, "vrt_lbvh_collapse", dev, lchild.data_ptr(),
            rchild.data_ptr(), lo.data_ptr(), hi.data_ptr(), l, max_leaf,
            width, cap, parent.data_ptr(), surv.data_ptr(), ch_old.data_ptr(),
            arity.data_ptr(), base.data_ptr(), newid.data_ptr(),
            row_lo.data_ptr(), row_cnt.data_ptr(), leaf_newid.data_ptr(),
            num_leaves.data_ptr(), *(a.data_ptr() for a in plan),
            scratch.data_ptr())
    if state is not None:
        state.append(_TopoState(num_leaves=num_leaves, plan=plan))
    return (surv, ch_old, arity, base, newid, row_lo, row_cnt, leaf_newid,
            parent)


# ---------------------------------------------------------- refit boxes

def _leaf_boxes(v0, v1, v2, order):
    """Per-triangle boxes in sorted order (the Karras leaves)."""
    tmin = torch.minimum(torch.minimum(v0, v1), v2)
    tmax = torch.maximum(torch.maximum(v0, v1), v2)
    o = order.to(_I64)
    return tmin[o], tmax[o]


def _range_refit(lmin, lmax, lo, hi):
    """Internal-node boxes as range min/max over the sorted leaf boxes,
    from a sparse table of power-of-two windows (the JAX package's
    refit; the plain version's only)."""
    l = lmin.shape[0]
    k_top = int(np.floor(np.log2(max(l, 2))))
    mins, maxs, offs = [lmin], [lmax], [0]
    for k in range(1, k_top + 1):
        h = 1 << (k - 1)
        prev_min, prev_max = mins[-1], maxs[-1]
        m = l - (1 << k) + 1
        if m <= 0:
            break
        offs.append(offs[-1] + prev_min.shape[0])
        mins.append(torch.minimum(prev_min[:m], prev_min[h:h + m]))
        maxs.append(torch.maximum(prev_max[:m], prev_max[h:h + m]))
    tmin, tmax = torch.cat(mins), torch.cat(maxs)
    off_arr = torch.tensor(offs, dtype=_I64, device=lmin.device)
    lo, hi = lo.to(_I64), hi.to(_I64)
    k = 31 - _clz32(hi - lo + 1)               # floor(log2(len))
    base = off_arr[k]
    ia = base + lo
    ib = base + hi - (1 << k) + 1
    return (torch.minimum(tmin[ia], tmin[ib]),
            torch.maximum(tmax[ia], tmax[ib]))


def _refit_boxes_ref(topo: LBVHTopo, v0, v1, v2):
    lmin, lmax = _leaf_boxes(v0, v1, v2, topo.order)
    imin, imax = _range_refit(lmin, lmax, topo.lo, topo.hi)
    return torch.cat([imin, lmin]), torch.cat([imax, lmax])


class RefitPlan(NamedTuple):
    """The refit kernel's plan of a topology (``csrc/lbvh_refit.cu``),
    made on the card by the collapse of the topology's build, or at its
    first refit (``_refit_plan``) for a topology made elsewhere.
    Treelets are the maximal subtrees of at most half a tile of leaves
    (they partition the sorted leaves); a block takes the treelets that
    start in its half tile of leaves, less than a tile in all.  The
    fields: by split gap (the last sorted position of a node's left
    child; one internal per gap) the node's record, (T-1, 2) int32; the
    blocks as (first leaf, last leaf, first and end row of their roots)
    rows; the treelets' roots as (id, slot in the block) rows, (T, 2),
    (-1, -1) past the last; the first leaf of each treelet root's block
    by node id (-1 elsewhere; the records' input); the climb's arrival
    counters, (T-1,) int32, zero before and after every launch."""

    rec: torch.Tensor
    blocks: torch.Tensor
    roots: torch.Tensor
    gstart: torch.Tensor
    arrived: torch.Tensor


@dataclasses.dataclass
class _TopoState:
    """What the refit keeps of a topology between frames: the leaf-row
    count ``LBVHNodes`` reports, and on the card the refit kernel's plan
    (made by the build's collapse, or at the first refit); for a PLOC
    topology the PLOC refit's climb counters instead (made zero at its
    first refit)."""

    num_leaves: torch.Tensor
    plan: Optional[RefitPlan] = None
    ploc_arrived: Optional[torch.Tensor] = None


# by the identity of the topology's ``parent`` array (a topology's arrays
# are never written after its build); an entry goes with its array
_TOPO_STATE: Dict[int, _TopoState] = {}


def topo_state(topo: LBVHTopo,
               made: Optional[_TopoState] = None) -> _TopoState:
    """The refit state of ``topo``: ``made`` (its build's, from
    ``_collapse_wide``) where a topology has none yet, else one made here
    at its first refit."""
    key = id(topo.parent)
    st = _TOPO_STATE.get(key)
    if st is None:
        st = made or _TopoState(num_leaves=(topo.row_cnt > 0).sum())
        _TOPO_STATE[key] = st
        weakref.finalize(topo.parent, _TOPO_STATE.pop, key, None)
    return st


_TOP = 1 << 31       # a plan record's bit: the node is above the treelets
_LEAF_REF = 1 << 10  # a record's child slot that is a leaf


def _refit_records_ref(topo: LBVHTopo, cap: int, gstart: torch.Tensor):
    """Plain version of ``refit_plan_kernel`` for treelets of at most
    ``cap`` leaves, in blocks whose first leaves ``gstart`` ((T-1,)) gives
    by treelet root -> rec (T-1, 2) int32.  The record of the node with
    split gap g is its id and, when the node lies in a treelet, its
    children as slots of its block (a leaf's position from the block's
    first, bit 10 set, or an inner node's gap from it) in bits 0-10 and
    11-21 and its depth below the treelet's root from bit 22; above the
    treelets, its id with bit 31 set."""
    l = topo.order.shape[0]
    n = l - 1
    lc, rc, par = topo.lchild.long(), topo.rchild.long(), topo.parent.long()
    lo, hi = topo.lo.long(), topo.hi.long()
    ids = torch.arange(n, device=lc.device)

    def end(c):      # a child's last position (a leaf's is its own)
        return torch.where(c >= n, c - n, hi[c.clamp(max=n - 1)])

    small = hi - lo < cap                # a treelet's node
    depth = torch.zeros(n, dtype=_I64, device=lc.device)
    root = ids.clone()                   # the highest small ancestor
    up = (root != 0) & small[par[root]] & small
    while bool(up.any()):
        root = torch.where(up, par[root], root)
        depth += up.long()
        up = (root != 0) & small[par[root]] & small
    t0 = gstart.long()[root]
    gap = end(lc)

    def slot(c):
        return torch.where(c >= n, (c - n - t0) | _LEAF_REF,
                           gap[c.clamp(max=n - 1)] - t0)

    rec = torch.empty((n, 2), dtype=_I64, device=lc.device)
    rec[gap, 0] = ids | torch.where(small, 0, _TOP)
    rec[gap, 1] = torch.where(small, slot(lc) | slot(rc) << 11
                              | depth << 22, 0)
    return _wrap32(rec)


def _refit_plan(topo: LBVHTopo, tile: int) -> RefitPlan:
    """The refit kernel's plan of ``topo`` for blocks of at most ``tile``
    leaves, on the topology's device with no copy to the host: the
    treelets (at most ``cap = tile // 2`` leaves) by their first leaves;
    block k takes the treelets that start in leaves [k cap, (k+1) cap)
    (every whole window holds a start, and its treelets end less than a
    tile from the window's start; the last, partial one may hold none:
    an empty block); then the records from ``refit_plan_kernel`` (CUDA;
    counted as an ``lbvh_refit`` launch) or ``_refit_records_ref`` (CPU),
    and zeroed counters."""
    l = topo.order.shape[0]
    n = l - 1
    dev = topo.lchild.device
    cap = tile // 2
    lo, hi, par = topo.lo.long(), topo.hi.long(), topo.parent.long()
    pos = torch.arange(l, device=dev)
    first = torch.cat([lo, pos])         # by node id, leaves after
    last = torch.cat([hi, pos])
    small = last - first < cap
    ids = torch.arange(2 * l - 1, device=dev)
    is_root = small & ((ids == 0) | ~small[par])
    # by leaf: the root of the treelet that starts there (the treelets
    # partition the leaves), and the treelets' order.  (Each scatter sends
    # what it does not keep to spare slots past the end, one each: no copy
    # to the host for a count, and no two writes to one slot.)
    root_at = torch.full((3 * l - 1,), -1, dtype=_I64, device=dev)
    root_at[torch.where(is_root, first, l + ids)] = torch.where(is_root, ids,
                                                                -1)
    root_at = root_at[:l]
    start = root_at >= 0
    rank = torch.cumsum(start, 0) - 1    # the treelet's row, at its start
    roots = torch.full((2 * l,), -1, dtype=_I64, device=dev)
    roots[torch.where(start, rank, l + pos)] = root_at
    roots = roots[:l]
    # each row's first leaf, ascending (l past the treelets), and each
    # block's first row: the first treelet that starts at or after k cap
    nb = -(-l // cap)
    rf = torch.where(roots >= 0, first[roots.clamp(min=0)], l)
    rf = torch.cat([rf, rf.new_full((1,), l)])
    edge = torch.searchsorted(
        rf, (torch.arange(nb + 1, device=dev) * cap).clamp(max=l))
    blocks = torch.stack([rf[edge[:-1]], rf[edge[1:]] - 1, edge[:-1],
                          edge[1:]], 1).to(_I32)
    rf = rf[:l]
    g0 = blocks[:, 0].long()[(rf // cap).clamp(max=nb - 1)]
    gap = last[topo.lchild.long()[roots.clamp(0, n - 1)]]
    slot = torch.where(roots >= n, (rf - g0) | _LEAF_REF, gap - g0)
    slot = torch.where(roots >= 0, slot, -1)
    inner = (roots >= 0) & (roots < n)
    gstart = torch.full((n + l,), -1, dtype=_I32, device=dev)
    gstart[torch.where(inner, roots, n + pos)] = torch.where(inner, g0,
                                                             -1).to(_I32)
    gstart = gstart[:n]
    if _cuda(topo.lchild):
        rec = torch.empty((n, 2), dtype=_I32, device=dev)
        _launch(kernels.load("lbvh_refit"), "vrt_lbvh_refit_plan", dev,
                topo.lchild.data_ptr(), topo.rchild.data_ptr(),
                topo.parent.data_ptr(), topo.lo.data_ptr(),
                topo.hi.data_ptr(), l, cap, gstart.data_ptr(),
                rec.data_ptr())
    else:
        rec = _refit_records_ref(topo, cap, gstart)
    return RefitPlan(rec=rec, blocks=blocks,
                     roots=torch.stack([roots, slot], 1).to(_I32),
                     gstart=gstart,
                     arrived=torch.zeros(n, dtype=_I32, device=dev))


def _refit_boxes(topo: LBVHTopo, v0, v1, v2):
    """Boxes of every binary node -> ((2T-1, 3) bmin, bmax) in old ids:
    internals 0..T-2, sorted leaves after.  On the card a refit is one
    launch, with no fill, over the kernel's plan kept in ``topo_state``:
    the build's (``build_lbvh_topo``), or one the first refit makes
    (``_refit_plan``) for a topology made elsewhere.  A launch that fails
    drops the plan, so the next refit makes a new one."""
    l = _check_verts(v0, v1, v2)
    _check_topo(topo, l, v0.device)
    if not _cuda(v0):
        return _refit_boxes_ref(topo, v0, v1, v2)
    lib = kernels.load("lbvh_refit")
    dev = v0.device
    v0, v1, v2 = (v.contiguous() for v in (v0, v1, v2))
    bmin = torch.empty((2 * l - 1, 3), dtype=_F32, device=dev)
    bmax = torch.empty((2 * l - 1, 3), dtype=_F32, device=dev)
    st = topo_state(topo)
    if st.plan is None:
        st.plan = _refit_plan(topo, lib.lib.vrt_lbvh_refit_tile())
    plan = st.plan
    try:
        _launch(lib, "vrt_lbvh_refit_boxes", dev, v0.data_ptr(),
                v1.data_ptr(), v2.data_ptr(), topo.order.data_ptr(),
                topo.lchild.data_ptr(), topo.rchild.data_ptr(),
                topo.parent.data_ptr(), l, plan.rec.data_ptr(),
                plan.blocks.data_ptr(), plan.roots.data_ptr(),
                plan.blocks.shape[0], plan.arrived.data_ptr(),
                bmin.data_ptr(), bmax.data_ptr())
    except RuntimeError:
        st.plan = None
        raise
    return bmin, bmax


# ----------------------------------------------------------------- pack

def scale_exponent(x: torch.Tensor) -> torch.Tensor:
    """clip(ceil(log2(x)), -126, 127) of positive normal float32 ``x``,
    exactly, from the float's bits: the exponent field, plus one when
    any mantissa bit is set (no ``log2``: hazard H7)."""
    bits = x.contiguous().view(_I32)
    e = ((bits >> 23) & 255) - 127 + ((bits & 0x7FFFFF) != 0).to(_I32)
    return e.clamp(-126, 127)


def _pack_wide(topo: LBVHTopo, bmin, bmax, l: int, leaf_size: int,
               root_offset: int = 0, width: int = 4, pool_rows: int = 0,
               surv_idx=None, leaf_rows: int = 0) -> torch.Tensor:
    """Plain version: quantize and scatter the wide records (old boxes ->
    new-id pool), (pool, 32) int32.  e = ceil(log2(extent / 255)); every
    child box is widened by one quantization step."""
    dev = bmin.device
    w = width
    lb = left_bits(w)
    qoff, hoff, moff, loff = row_layout(w)
    n_nodes = pool_rows if pool_rows else 2 * l - 1
    if surv_idx is not None:
        si = surv_idx.to(_I64).clamp(0, l - 2)
        pad_row = surv_idx < 0
        surv = topo.surv[si] & ~pad_row
        ch_old = torch.where(pad_row[:, None], -1, topo.ch_old[si].to(_I64))
        arity, base, sid_rows = topo.arity[si], topo.base[si], topo.newid[si]
    else:
        surv, ch_old, arity, base = (topo.surv, topo.ch_old.to(_I64),
                                     topo.arity, topo.base)
        sid_rows = topo.newid[: l - 1]
    arity, base, sid_rows = (a.to(_I64) for a in (arity, base, sid_rows))
    ch_s = ch_old.clamp(0, 2 * l - 2)
    cmin, cmax = bmin[ch_s], bmax[ch_s]          # (S, w, 3)
    present = (ch_old >= 0)[..., None]
    inf = torch.tensor(float("inf"), dtype=_F32, device=dev)
    org = torch.where(present, cmin, inf).amin(1)
    top = torch.where(present, cmax, -inf).amax(1)
    extent = (top - org).clamp_min(1e-30)
    q255 = torch.tensor(255.0, dtype=_F32, device=dev)
    e = scale_exponent(extent / q255)
    scale = ((e + 127) << 23).view(_F32)

    def qpack(b, lo_side):
        q = (b - org[:, None, :]) / scale[:, None, :]
        q = torch.floor(q) - 1 if lo_side else torch.ceil(q) + 1
        q = q.clamp(0, 255).to(_I64)
        return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)

    srec = torch.zeros((surv.shape[0], ROW_WORDS), dtype=_I64, device=dev)
    srec[:, 0:3] = org.contiguous().view(_I32).to(_I64)
    srec[:, 3:6] = scale.contiguous().view(_I32).to(_I64)
    has = ch_old >= 0
    srec[:, qoff:qoff + w] = torch.where(has, qpack(cmin, True), 0)
    srec[:, hoff:hoff + w] = torch.where(has, qpack(cmax, False), 0)
    srec[:, moff] = ((base + root_offset) | (arity << lb)
                     | (KIND_INTERNAL << 29))
    # (row n_nodes is a spare slot: the JAX scatter's mode="drop")
    rec = torch.zeros((n_nodes + 1, ROW_WORDS), dtype=_I64, device=dev)
    ok = surv & (sid_rows >= 0) & (sid_rows < n_nodes)
    rec[torch.where(ok, sid_rows, n_nodes)] = torch.where(
        ok[:, None], srec, 0)

    lr = leaf_rows if leaf_rows else l
    lrec = torch.zeros((lr, ROW_WORDS), dtype=_I64, device=dev)
    lrec[:, moff] = (torch.arange(lr, dtype=_I64, device=dev) | (1 << lb)
                     | (KIND_TRIS << 29))
    lrec[:, loff] = topo.row_cnt[:lr].to(_I64)
    lid = topo.leaf_newid[:lr].to(_I64)
    used = (lid >= 0) & (lid < n_nodes)
    rec[torch.where(used, lid, n_nodes)] = torch.where(
        used[:, None], lrec, 0)
    return _wrap32(rec[:n_nodes])


def _leaf_rows(v0, v1, v2, order, row_lo, row_cnt, l: int,
               leaf_size: int = 4, n_rows: int = 0,
               leaf_tids=None) -> torch.Tensor:
    """Plain version: (rows, 16*leaf_size) packed leaf rows; row j holds
    the ``row_cnt[j]`` triangles at sorted slots ``row_lo[j]``.. (or, with
    ``leaf_tids`` (l, leaf_size), at the slots ``leaf_tids[j]``: the PLOC
    rows, ``ploc._rows_from_tids``) as (v0, e1, e2, tid bits); empty
    slots are zero-area (tid -1)."""
    if n_rows:
        l = n_rows
        row_lo, row_cnt = row_lo[:n_rows], row_cnt[:n_rows]
    dev = v0.device
    t = v0.shape[0]
    k = torch.arange(leaf_size, dtype=_I64, device=dev)
    if leaf_tids is not None:
        idx = leaf_tids[:l].to(_I64).clamp(0, t - 1)
    else:
        idx = (row_lo.to(_I64)[:, None] + k[None, :]).clamp(0, t - 1)
    tid = order[idx]                             # (l, leaf) global ids
    valid = k[None, :] < row_cnt[:, None]
    tid64 = tid.to(_I64)
    sv0 = v0[tid64]
    se1 = v1[tid64] - sv0
    se2 = v2[tid64] - sv0
    zero = ~valid[..., None]
    sv0, se1, se2 = (torch.where(zero, 0.0, a) for a in (sv0, se1, se2))
    tids = torch.where(valid, tid, -1).to(_I32).view(_F32)
    rows = torch.zeros((l, leaf_size, 16), dtype=_F32, device=dev)
    rows[..., 0:3] = sv0
    rows[..., 3:6] = se1
    rows[..., 6:9] = se2
    rows[..., 9] = tids
    return rows.reshape(l, 16 * leaf_size)


def _tlas_root(device) -> torch.Tensor:
    """The one-node TLAS wrapper: an identity instance whose BLAS root
    is row 1."""
    tlas = np.zeros((1, ROW_WORDS), np.uint32)
    tlas[0, 14] = np.uint32(KIND_INSTANCE) << 29
    tlas[0, INST_XFORM:INST_ROOT] = np.array(
        [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], np.float32).view(np.uint32)
    tlas[0, INST_ROOT] = 1
    return torch.from_numpy(tlas.view(np.int32)).to(device)


def _pack_rows_ref(topo: LBVHTopo, bmin, bmax, v0, v1, v2,
                   leaf_size: int = 4, width: int = 4, tlas: bool = False,
                   pool_rows: int = 0, leaf_rows: int = 0, surv_idx=None,
                   fused: bool = False, leaf_tids=None):
    """Plain version of ``_pack_rows``."""
    l = v0.shape[0]
    blas = _pack_wide(topo, bmin, bmax, l, leaf_size,
                      root_offset=1 if tlas else 0, width=width,
                      pool_rows=pool_rows, surv_idx=surv_idx,
                      leaf_rows=leaf_rows)
    nodes = torch.cat([_tlas_root(blas.device), blas]) if tlas else blas
    rows = _leaf_rows(v0, v1, v2, topo.order, topo.row_lo, topo.row_cnt, l,
                      leaf_size=leaf_size, n_rows=leaf_rows,
                      leaf_tids=leaf_tids)
    return nodes, rows, fuse_rows(nodes, rows, width) if fused else None


def _pack_rows(topo: LBVHTopo, bmin, bmax, v0, v1, v2, leaf_size: int = 4,
               width: int = 4, tlas: bool = False, pool_rows: int = 0,
               leaf_rows: int = 0, surv_idx=None, fused: bool = False,
               leaf_tids=None):
    """Quantize, pack and scatter -> (nodes, tri_rows, fused or None):
    the survivor records and the leaf records at their new ids, the
    triangle rows, and (``fused``, flat layout only) the fused
    node+leaf rows, word for word ``WideArrays.fuse()`` of the two.
    ``leaf_tids`` ((l, leaf_size) int32 sorted slots, -1 padded) gives
    each leaf row its triangles explicitly, as PLOC forms them
    (``accel/ploc.py``): the leaf kernel then reads them instead of the
    Morton range ``row_lo``.., and the call's launches, survivor records
    and leaf rows, count as ``ploc_pack`` (K4d), not as ``lbvh_pack``."""
    if tlas and width != 4:
        raise ValueError("the TLAS wrapper is 4-wide only")
    if fused and tlas:
        raise ValueError("fused rows require the flat layout")
    l = _check_verts(v0, v1, v2)
    dev = v0.device
    if _check_topo(topo, l, dev) != width:
        raise ValueError(f"the topology was collapsed to width "
                         f"{topo.ch_old.shape[-1]}, not {width}")
    pool = pool_rows if pool_rows else 2 * l - 1
    lr = leaf_rows if leaf_rows else l
    off = 1 if tlas else 0
    if not (1 <= lr <= l and 1 <= pool
            and pool + off <= 1 << left_bits(width) and leaf_size >= 1):
        raise ValueError(f"pool_rows {pool} / leaf_rows {lr} outside what "
                         f"{l} triangles and a {left_bits(width)}-bit child "
                         f"index allow")
    for b in (bmin, bmax):
        if (b.dtype != _F32 or tuple(b.shape) != (2 * l - 1, 3)
                or b.device != dev or not b.is_contiguous()):
            raise ValueError("bmin and bmax must be contiguous (2T-1, 3) "
                             "float32 tensors on the vertices' device")
    if not _cuda(v0):
        return _pack_rows_ref(topo, bmin, bmax, v0, v1, v2, leaf_size,
                              width, tlas, pool_rows, leaf_rows, surv_idx,
                              fused, leaf_tids)
    lib = kernels.load("lbvh_pack")
    v0, v1, v2 = (v.contiguous() for v in (v0, v1, v2))
    if surv_idx is not None:
        surv_idx = surv_idx.contiguous()
        _check_i32(dev, surv_idx=(surv_idx, (surv_idx.shape[0],)))
    if leaf_tids is not None:
        leaf_tids = leaf_tids.contiguous()
        _check_i32(dev, leaf_tids=(leaf_tids, (l, leaf_size)))
    # unfilled: the kernels write every word, the pool rows no record
    # reaches among them (row 0 of the TLAS layout is written here)
    nodes = torch.empty((pool + off, ROW_WORDS), dtype=_I32, device=dev)
    if tlas:
        nodes[0] = _tlas_root(dev)[0]
    rows = torch.empty((lr, 16 * leaf_size), dtype=_F32, device=dev)
    fz = (torch.empty((pool, ROW_WORDS + 16 * leaf_size), dtype=_I32,
                      device=dev) if fused else None)
    n_surv = l - 1 if surv_idx is None else surv_idx.shape[0]
    # two kernels back to back: survivor records and the zero rows, then
    # leaf records and triangle rows
    counts = {"lbvh_pack" if leaf_tids is None else "ploc_pack": 2}
    _launch(lib, "vrt_lbvh_pack_rows", dev, topo.surv.data_ptr(),
            topo.ch_old.data_ptr(), topo.arity.data_ptr(),
            topo.base.data_ptr(), topo.newid.data_ptr(),
            0 if surv_idx is None else surv_idx.data_ptr(),
            n_surv, bmin.data_ptr(), bmax.data_ptr(), topo.order.data_ptr(),
            topo.row_lo.data_ptr(), topo.row_cnt.data_ptr(),
            0 if leaf_tids is None else leaf_tids.data_ptr(),
            topo.leaf_newid.data_ptr(), v0.data_ptr(), v1.data_ptr(),
            v2.data_ptr(), l, width, leaf_size, off, pool, lr,
            nodes.data_ptr(), rows.data_ptr(),
            0 if fz is None else fz.data_ptr(), counts=counts)
    return nodes, rows, fz


# --------------------------------------------------------- entry points

def build_lbvh_topo(v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor,
                    leaf_size: int = 4, method: str = "karras",
                    width: int = 4) -> Tuple[LBVHNodes, LBVHTopo]:
    """Device BVH build over (T, 3) float32 vertices -> (LBVHNodes,
    LBVHTopo), on the vertices' device.  ``leaf_size`` is the maximum
    triangles per wide leaf.  8-wide tables come with their fused rows
    (the port always fuses them: they are what the 8-wide walk reads).
    ``method``: 'karras' (the default) is the radix tree over the Morton
    codes; 'sah' splits every contiguous Morton range at its sweep-SAH
    cheapest position instead (``_sah_sweep_tree``), and its nodes carry
    the collapsed tree's real depth (``wide_depth``)."""
    if method not in ("karras", "sah"):
        raise ValueError(f"unknown LBVH method {method!r}")
    l = _check_verts(v0, v1, v2)
    if l <= leaf_size:
        raise ValueError("scene smaller than one leaf")
    codes = scene_codes(v0, v1, v2)[0]
    lcodes, order = torch.sort(codes, stable=True)
    order = order.to(_I32)
    levels = 0
    if method == "sah":
        lchild, rchild, lo, hi, levels = _sah_sweep_tree(
            *_leaf_boxes(v0, v1, v2, order), l)
    else:
        lchild, rchild, lo, hi = _karras(lcodes, l)
    made = []
    (surv, ch_old, arity, base, newid, row_lo, row_cnt, leaf_newid,
     parent) = _collapse_wide(lchild, rchild, lo, hi, l, leaf_size,
                              width=width, state=made)
    topo = LBVHTopo(order=order, lchild=lchild, rchild=rchild, surv=surv,
                    ch_old=ch_old, arity=arity, base=base, newid=newid,
                    row_lo=row_lo, row_cnt=row_cnt, leaf_newid=leaf_newid,
                    lo=lo, hi=hi, parent=parent)
    topo_state(topo, made[0])   # the plan belongs to these arrays (H15)
    lb = refit_lbvh(topo, v0, v1, v2, leaf_size=leaf_size, width=width)
    if method == "sah":
        lb = dataclasses.replace(lb, wide_depth=wide_depth_of(levels - 1,
                                                              width))
    return lb, topo


def compact_sizes(topo: LBVHTopo, pad: int = 256) -> Tuple[int, int]:
    """Exact pool bounds for the compact refit path: (pool_rows,
    leaf_rows) the collapse assigned, padded up to ``pad`` (and, for a
    mesh smaller than the padding, capped at the full pools' sizes).
    Copies two numbers to the host, once per topology build."""
    pool = max(int(topo.newid.max()), int(topo.leaf_newid.max())) + 1
    rows = int((topo.row_cnt > 0).sum())
    l = topo.order.shape[0]

    def up(v):
        return ((v + pad - 1) // pad) * pad

    return min(up(pool), 2 * l - 1), min(up(max(rows, 1)), l)


def compact_plan(topo: LBVHTopo, pad: int = 256
                 ) -> Tuple[int, int, torch.Tensor]:
    """``compact_sizes`` and the survivor list of the compacted repack:
    (pool_rows, leaf_rows, surv_idx), surv_idx the (S,) int32 ids of the
    binary internals that survive the collapse, -1 padded to a ``pad``
    multiple.  Built once per topology, reused every refit."""
    pool_rows, leaf_rows = compact_sizes(topo, pad=pad)
    ids = torch.nonzero(topo.surv).squeeze(1).to(_I32)
    n = max(((ids.shape[0] + pad - 1) // pad) * pad, pad)
    out = torch.full((n,), -1, dtype=_I32, device=ids.device)
    out[: ids.shape[0]] = ids
    return pool_rows, leaf_rows, out


def refit_lbvh(topo: LBVHTopo, v0, v1, v2, leaf_size: int = 4,
               tlas: bool = False, width: int = 4, pool_rows: int = 0,
               leaf_rows: int = 0, surv_idx=None) -> LBVHNodes:
    """Keep the topology, recompute the boxes, requantize and repack: the
    per-frame update of a moving mesh.  ``tlas=False`` emits the flat
    single-tree layout; ``tlas=True`` prepends the one-node TLAS wrapper
    (4-wide only).  ``pool_rows``, ``leaf_rows`` and ``surv_idx`` (from
    ``compact_plan``) emit the compact pools.  8-wide tables come with
    their fused rows.  Nothing is copied to the host."""
    bmin, bmax = _refit_boxes(topo, v0, v1, v2)
    nodes, rows, fz = _pack_rows(topo, bmin, bmax, v0, v1, v2, leaf_size,
                                 width, tlas, pool_rows, leaf_rows, surv_idx,
                                 fused=width == 8)
    return LBVHNodes(nodes=nodes, tri_rows=rows,
                     num_leaves=topo_state(topo).num_leaves, fused=fz)


def build_lbvh(v0, v1, v2, leaf_size: int = 4, width: int = 4
               ) -> LBVHNodes:
    """Device BVH build over triangles (T, 3) x 3 -> packed wide pool."""
    return build_lbvh_topo(v0, v1, v2, leaf_size=leaf_size, width=width)[0]


def wide_arrays_from_lbvh(lb: LBVHNodes, leaf_size: int = 4,
                          tlas: bool = False, width: int = 4) -> WideArrays:
    """Wrap a device-built LBVH as traversal-ready ``WideArrays``.  The
    flat layout reports triangle ids directly (one implicit instance 0).
    ``depth`` is a bound, not the tree's depth: the binary Karras depth
    is at most the augmented key's length (32 + 26 bits under 2**26
    leaves), and the collapse divides it by 2 (width 4) or 3 (width 8).
    A tree whose depth that does not bound (the sweep-SAH tree) carries
    its real depth in ``lb.wide_depth``: ``depth`` is then the larger of
    the two, and a tree the card's walk cannot hold raises here rather
    than overflowing its stack (ROADMAP H8)."""
    t = int(lb.tri_rows.shape[0])
    bound = 32 if width == 4 else 22
    depth = bound if lb.wide_depth is None else max(bound,
                                                    int(lb.wide_depth))
    wa = WideArrays(
        nodes=lb.nodes, tri_rows=lb.tri_rows,
        num_tlas=1 if tlas else 0,
        tri_bits=0 if tlas else max(
            int(np.ceil(np.log2(max(t * leaf_size, 2)))), 1),
        max_leaf_tris=leaf_size, depth=depth, width=width, fused=lb.fused)
    walk = traverse_packet if width == 8 else packet_walk
    if walk.stack_entries(wa) > walk.STACK_MAX:
        raise ValueError(f"the tree is {depth} levels deep; a {width}-wide "
                         f"walk on the card holds {walk.STACK_MAX} stack "
                         f"entries, it needs {walk.stack_entries(wa)}")
    return wa


def tree_surface_area(nodes, width: int = 4) -> float:
    """Total dequantized child-box surface area of a packed node pool:
    the SAH-cost proxy behind ``refit_staleness`` (host-side)."""
    n = nodes.detach().cpu().numpy().view(np.uint32)
    scale = n[:, 3:6].view(np.float32)
    meta = n[:, row_layout(width)[2]]
    nch = (meta >> left_bits(width)) & (7 if width == 4 else 15)
    total = 0.0
    for c in range(width):
        ql = n[:, 6 + c]
        qh = n[:, 6 + width + c]
        lo = np.stack([(ql >> s) & 255 for s in (0, 8, 16)], -1)
        hi = np.stack([(qh >> s) & 255 for s in (0, 8, 16)], -1)
        ext = np.maximum((hi.astype(np.int64) - lo) * scale, 0.0)
        area = 2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                      + ext[:, 0] * ext[:, 2])
        total += float(area[nch > c].sum())
    return total


def refit_staleness(topo: LBVHTopo, v0, v1, v2, leaf_size: int = 4
                    ) -> float:
    """Refit-quality ratio >= 1.0: summed node area of the refit tree on
    the current geometry over a fresh rebuild's.  About 1.0 while the
    motion preserves the Morton clustering; rebuild the topology when it
    passes about 1.5."""
    refit = refit_lbvh(topo, v0, v1, v2, leaf_size=leaf_size)
    fresh = build_lbvh(v0, v1, v2, leaf_size=leaf_size)
    return tree_surface_area(refit.nodes) / max(
        tree_surface_area(fresh.nodes), 1e-30)


def pad_tris(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
             leaf_size: int = 4):
    """Pad the triangle soup to a leaf_size multiple with degenerate
    copies of the last triangle's first vertex (zero-area: never hit)."""
    pad = (-v0.shape[0]) % leaf_size
    if pad == 0:
        return v0, v1, v2
    p = np.repeat(v0[-1:], pad, axis=0)
    return (np.concatenate([v0, p]), np.concatenate([v1, p]),
            np.concatenate([v2, p]))


def build_wide_from_tris(sb, leaf_size: int = 4, width: int = 4, *,
                         device) -> WideArrays:
    """Scene buffers -> traversal-ready ``WideArrays`` via the on-device
    build, on ``device``; 8-wide tables come fused.  For scenes of one
    identity instance (the build works in triangle space)."""
    if not (sb.inst_transform.shape[0] == 1
            and np.allclose(sb.inst_transform[0], np.eye(4))):
        raise ValueError("LBVH direct build needs a single identity instance")
    v0, v1, v2 = (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for v in pad_tris(sb.v0, sb.v1, sb.v2, leaf_size))
    lb = build_lbvh(v0, v1, v2, leaf_size=leaf_size, width=width)
    return wide_arrays_from_lbvh(lb, leaf_size, width=width)
