"""The binary TLAS+BLAS walk (port of ``vortex_rt_tpu/ops/traverse2.py``,
K6): closest-first descent with a far-child push, the TLAS -> BLAS
instance jump with an object-space ray, Moller-Trumbore leaves.

The TLAS and every BLAS are merged into one node pool (TLAS at [0, K),
BLAS node i at K + i), so an instance leaf moves the ray into object
space and jumps to the instance's BLAS root, and the LIFO stack keeps
every stacked BLAS entry inside the current instance.  This is the
engine behind ``engine/megakernel.py``.

``trace_rays`` launches ``csrc/traverse2.cu`` (K6, one thread per ray)
on CUDA tensors and raises if it cannot; on CPU tensors it runs
``trace_rays_ref``, the JAX loop body over all lanes with masks in the
JAX order of operations.  Both give the JAX package's hits and per-ray
``nodes_visited`` and ``tri_tests`` to the bit.

K6 reads packed records, not the JAX arrays (``pack_walk_tables``, made
once per ``TraversalArrays`` and kept with it: ``walk_tables``): a
64-B record a pool node (kind, left, count, and both children's boxes
at an internal node, or the 3x4 inverse transform and BLAS root at an
instance node) and a 48-B record a leaf slot (v0, the two edges, the
triangle id).  ``trace_records_ref`` is the plain walk over those
records alone; it gives ``trace_rays_ref``'s records.

The JAX loop steps every lane under one global ``max_steps``; a lane that
is done is frozen.  One thread walking its own ray to its end, capped at
``max_steps`` of its own, is the same walk, and ``steps`` (the lockstep
iterations) is the largest ``nodes_visited``.

Stack overflow (ROADMAP Queue 3): a push writes ``stack[min(sp, D-1)]``
while ``sp`` keeps counting, and a pop reads ``stack[min(max(sp-1, 0),
D-1)]`` (the JAX gather clamps its index), so a walk deeper than
``stack_depth`` silently loses entries and finds other hits.  Both
versions copy the clamp.  A walk never holds more entries than the
pool has levels (``WalkTables.depth``), so K6 and the records walk keep
``min(stack_depth, depth)`` entries: the clamp bites only where the
pool is deeper than ``stack_depth``, and then they keep all of them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vortex_rt_tpu_torch.models.scene import SceneBuffers
from vortex_rt_tpu_torch.ops.intersect import (
    moller_trumbore, moller_trumbore_edges, ray_aabb, safe_rcp,
    transform_ray,
)
from vortex_rt_tpu_torch.runtime import kernels
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

# node kinds in the merged pool
KIND_INTERNAL = 0
KIND_INSTANCE = 1  # TLAS leaf -> enter a BLAS
KIND_TRIS = 2      # BLAS leaf -> intersect triangles
_POP = -1          # next node: pop the stack, or end the walk
_INT_MAX = 2**31 - 1
# stack entries K6 holds per thread (VRT_STACK_MAX of csrc/traverse2.cu)
STACK_MAX = 64
NODE_WORDS = 16  # a node record: kind, left, count, root, 12 box/row words
TRI_WORDS = 12   # a slot record: v0, e1, e2, triangle id, 2 zero words


class Hits(NamedTuple):
    """Ray hit records as SoA lanes."""

    dist: torch.Tensor  # (R,) f32, LARGE_FLOAT = miss
    bx: torch.Tensor    # (R,) f32 barycentrics
    by: torch.Tensor
    bz: torch.Tensor
    tri: torch.Tensor   # (R,) i32 global triangle id
    inst: torch.Tensor  # (R,) i32 instance id


class PerfCounters(NamedTuple):
    """Per-ray steps and triangle tests, and the steps of the longest walk
    (the lockstep loop's iterations)."""

    nodes_visited: torch.Tensor  # (R,) i32
    tri_tests: torch.Tensor      # (R,) i32
    steps: torch.Tensor          # () i32


@dataclasses.dataclass
class TraversalArrays:
    """Merged TLAS+BLAS node pool and leaf payloads."""

    nmin: torch.Tensor       # (K+N, 3) f32
    nmax: torch.Tensor       # (K+N, 3) f32
    left: torch.Tensor       # (K+N,) i32: child / instance id / first slot
    count: torch.Tensor      # (K+N,) i32: triangle count of a leaf
    kind: torch.Tensor       # (K+N,) i32
    tri_idx: torch.Tensor    # (T,) i32 leaf slot -> global triangle id
    v0: torch.Tensor         # (T, 3) f32
    v1: torch.Tensor
    v2: torch.Tensor
    inst_inv: torch.Tensor   # (I, 4, 4) f32
    inst_root: torch.Tensor  # (I,) i32 merged-pool BLAS root
    inst_refl: torch.Tensor  # (I,) f32
    max_leaf_tris: int
    num_tlas: int

    def _tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)
                if torch.is_tensor(getattr(self, f.name))]

    @property
    def device(self) -> torch.device:
        return self.nmin.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._tensors())

    def to(self, device) -> "TraversalArrays":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})

    @staticmethod
    def from_scene(sb: SceneBuffers) -> "TraversalArrays":
        """The merged pool of a built scene, on the CPU (move it with
        ``.to(device)``): the JAX ``TraversalArrays.from_scene``."""
        k = sb.tlas_min.shape[0]
        t_kind = np.where(sb.tlas_count > 0, KIND_INSTANCE, KIND_INTERNAL)
        # internal: left child TLAS index; leaf: its single instance id
        t_left = np.where(
            sb.tlas_count > 0,
            sb.tlas_inst_idx[np.minimum(sb.tlas_left,
                                        sb.tlas_inst_idx.shape[0] - 1)],
            sb.tlas_left).astype(np.int32)
        t_count = np.zeros_like(sb.tlas_count)
        b_internal = sb.bvh_count == 0
        b_kind = np.where(b_internal, KIND_INTERNAL, KIND_TRIS)
        b_left = np.where(b_internal, sb.bvh_left + k,
                          sb.bvh_left).astype(np.int32)

        def t(a, dt=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dt))

        return TraversalArrays(
            nmin=t(np.concatenate([sb.tlas_min, sb.bvh_min])),
            nmax=t(np.concatenate([sb.tlas_max, sb.bvh_max])),
            left=t(np.concatenate([t_left, b_left]), np.int32),
            count=t(np.concatenate([t_count, sb.bvh_count]), np.int32),
            kind=t(np.concatenate([t_kind, b_kind]), np.int32),
            tri_idx=t(sb.bvh_tri_idx, np.int32),
            v0=t(sb.v0), v1=t(sb.v1), v2=t(sb.v2),
            inst_inv=t(sb.inst_inv_transform),
            inst_root=t(sb.inst_bvh_root + np.int32(k), np.int32),
            inst_refl=t(sb.inst_reflectivity),
            max_leaf_tris=int(sb.bvh_count.max()),
            num_tlas=int(k))

    def walk_tables(self) -> "WalkTables":
        """K6's packed records of these arrays, on their device: made by
        ``pack_walk_tables`` at the first call and kept with them (the
        port never edits a ``TraversalArrays`` in place; ``to`` makes a
        new one, which packs its own)."""
        wt = self.__dict__.get("_walk_tables")
        if wt is None:
            wt = self.__dict__["_walk_tables"] = pack_walk_tables(self)
        return wt


@dataclasses.dataclass
class WalkTables:
    """The records K6 reads (``pack_walk_tables``).

    ``nodes`` (P, 16) int32, one 64-B record a pool node: word 0 the
    kind, 1 the left word as the walk uses it (an internal node's left
    child clamped to [0, P-2], an instance node's instance id clamped to
    [0, I-1], a triangle leaf's first slot), 2 the count, 3 an instance
    node's BLAS root; words 4-15 an internal node's children's boxes
    (left min, left max, right min, right max, float32 bits) or an
    instance node's rows 0-2 of its inverse transform, else 0.
    ``tris`` (S, 12) int32, one 48-B record a leaf slot in slot order:
    v0, e1 = v1 - v0, e2 = v2 - v0 (float32 bits) of the slot's triangle,
    its id clamped to [0, T-1], two zero words.  ``depth``: levels of
    the pool from the TLAS root (the longest path, entering every BLAS
    an instance names), at most ``STACK_MAX``."""

    nodes: torch.Tensor
    tris: torch.Tensor
    max_leaf_tris: int
    num_tlas: int
    depth: int

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.nodes, self.tris))


def pack_walk_tables(ta: TraversalArrays) -> WalkTables:
    """K6's records of ``ta`` (``WalkTables``), in torch ops on ``ta``'s
    device: the words of the JAX arrays, moved, with the clamps the walk
    applies to them already applied.  Run once per scene, never per
    launch (``TraversalArrays.walk_tables``)."""
    p, n_inst = ta.kind.shape[0], ta.inst_root.shape[0]
    i32 = torch.int32
    kind = ta.kind
    is_int = kind == KIND_INTERNAL
    is_inst = kind == KIND_INSTANCE
    l = ta.left.clamp(0, p - 2).long()
    iid = ta.left.clamp(0, n_inst - 1).long()
    left = torch.where(is_int, l.to(i32),
                       torch.where(is_inst, iid.to(i32), ta.left))
    root = torch.where(is_inst, ta.inst_root[iid],
                       torch.zeros_like(ta.inst_root[iid]))
    boxes = torch.cat([ta.nmin[l], ta.nmax[l], ta.nmin[l + 1],
                       ta.nmax[l + 1]], 1).view(i32)
    rows = ta.inst_inv[iid][:, :3, :].reshape(p, 12).view(i32)
    body = torch.where(is_int.unsqueeze(1), boxes, torch.where(
        is_inst.unsqueeze(1), rows, torch.zeros_like(rows)))
    nodes = torch.cat([kind.unsqueeze(1), left.unsqueeze(1),
                       ta.count.unsqueeze(1), root.unsqueeze(1), body],
                      1).contiguous()
    tid = ta.tri_idx.clamp(0, ta.v0.shape[0] - 1).long()
    v0 = ta.v0[tid]
    tris = torch.cat([v0.view(i32), (ta.v1[tid] - v0).view(i32),
                      (ta.v2[tid] - v0).view(i32), tid.to(i32).unsqueeze(1),
                      torch.zeros((tid.shape[0], 2), dtype=i32,
                                  device=tid.device)], 1).contiguous()
    return WalkTables(nodes=nodes, tris=tris,
                      max_leaf_tris=int(ta.max_leaf_tris),
                      num_tlas=int(ta.num_tlas), depth=_levels(nodes))


def chain_pool(links: int, device="cpu") -> TraversalArrays:
    """A pool deeper than any stack: a TLAS instance leaf over one BLAS
    whose internal nodes form a chain of ``links`` (at 2j+1: children a
    one-triangle leaf at 2j+2 and the next link at 2j+3, the last link's
    right child a leaf).  Leaf j's triangle lies in the plane x = 1 + j,
    on the half y >= z of [-1, 1]^2; the links' boxes start at x = 0.  A
    ray along +x from x < 0 through y < z misses every triangle, meets
    each link before its leaf, and defers one leaf a level: its stack
    holds ``links`` entries (no SAH build of a real mesh goes this deep
    within float32's range)."""
    n, p = links + 1, 2 * links + 2
    j = torch.arange(n, dtype=torch.float32)
    one = torch.ones(n)
    v0 = torch.stack([1 + j, -one, -one], 1)
    v1 = torch.stack([1 + j, one, -one], 1)
    v2 = torch.stack([1 + j, one, one], 1)
    nmin = torch.zeros(p, 3)
    nmax = torch.zeros(p, 3)
    kind = torch.full((p,), KIND_TRIS, dtype=torch.int32)
    left = torch.zeros(p, dtype=torch.int32)
    count = torch.ones(p, dtype=torch.int32)
    kind[0], count[0] = KIND_INSTANCE, 0
    link = torch.arange(1, 2 * links, 2)
    kind[link], left[link], count[link] = KIND_INTERNAL, (link + 1).int(), 0
    nmin[link] = torch.tensor([0.0, -1.0, -1.0])
    nmax[link] = torch.tensor([float(n + 1), 1.0, 1.0])
    leaf = torch.cat([link + 1, torch.tensor([p - 1])])
    left[leaf] = torch.arange(n, dtype=torch.int32)
    nmin[leaf], nmax[leaf] = v0, v2
    return TraversalArrays(
        nmin=nmin, nmax=nmax, left=left, count=count, kind=kind,
        tri_idx=torch.arange(n, dtype=torch.int32), v0=v0, v1=v1, v2=v2,
        inst_inv=torch.eye(4).unsqueeze(0),
        inst_root=torch.ones(1, dtype=torch.int32),
        inst_refl=torch.zeros(1), max_leaf_tris=1, num_tlas=1).to(device)


def _levels(nodes: torch.Tensor) -> int:
    """Levels of the pool from node 0 along the edges the walk can take
    (an internal node's two children, an instance node's BLAS root,
    clamped as the walk reads them), at most ``STACK_MAX``: a walk's
    stack never holds more entries than that."""
    p = nodes.shape[0]
    kind, left, root = nodes[:, 0], nodes[:, 1].long(), nodes[:, 3].long()
    frontier = torch.zeros(1, dtype=torch.int64, device=nodes.device)
    levels = 0
    while frontier.numel() and levels < STACK_MAX:
        levels += 1
        k = kind[frontier]
        inner = left[frontier][k == KIND_INTERNAL]
        enter = root[frontier][k == KIND_INSTANCE].clamp(0, p - 1)
        frontier = torch.unique(torch.cat([inner, inner + 1, enter]))
    return levels if frontier.numel() == 0 else STACK_MAX


def _check(ta: TraversalArrays, o, d, active, stack_depth: int,
           t_max: float) -> None:
    dev = ta.device
    p, n_tri, n_inst = ta.kind.shape[0], ta.v0.shape[0], ta.inst_root.shape[0]
    for name, dt, shape in (
            ("nmin", torch.float32, (p, 3)), ("nmax", torch.float32, (p, 3)),
            ("left", torch.int32, (p,)), ("count", torch.int32, (p,)),
            ("kind", torch.int32, (p,)),
            ("tri_idx", torch.int32, (ta.tri_idx.shape[0],)),
            ("v0", torch.float32, (n_tri, 3)), ("v1", torch.float32, (n_tri, 3)),
            ("v2", torch.float32, (n_tri, 3)),
            ("inst_inv", torch.float32, (n_inst, 4, 4)),
            ("inst_root", torch.int32, (n_inst,))):
        a = getattr(ta, name)
        if a.dtype != dt or tuple(a.shape) != shape or a.device != dev:
            raise ValueError(f"TraversalArrays.{name} must be a {dt} tensor "
                             f"of shape {shape} on {dev}, got {a.dtype}"
                             f"{tuple(a.shape)} on {a.device}")
    if ta.max_leaf_tris < 1 or p < 2:
        raise ValueError("the pool needs two nodes and a triangle leaf")
    _check_rays(dev, o, d, active, stack_depth, t_max)


def _check_records(wt: WalkTables, o, d, active, stack_depth: int,
                   t_max: float) -> None:
    dev = wt.device
    for name, words in (("nodes", NODE_WORDS), ("tris", TRI_WORDS)):
        a = getattr(wt, name)
        if a.dtype != torch.int32 or a.dim() != 2 or a.shape[1] != words \
                or a.device != dev or not a.is_contiguous():
            raise ValueError(f"WalkTables.{name} must be a contiguous "
                             f"(N, {words}) int32 tensor on {dev}")
    if wt.max_leaf_tris < 1 or wt.nodes.shape[0] < 2 or not wt.tris.numel():
        raise ValueError("the pool needs two nodes and a triangle leaf")
    if not 1 <= wt.depth <= STACK_MAX:
        raise ValueError(f"WalkTables.depth must be 1..{STACK_MAX}")
    _check_rays(dev, o, d, active, stack_depth, t_max)


def _check_rays(dev, o, d, active, stack_depth: int, t_max: float) -> None:
    r = o.shape[0]
    for a in (o, d):
        if a.dtype != torch.float32 or tuple(a.shape) != (r, 3) \
                or a.device != dev:
            raise ValueError("o and d must be (R, 3) float32 tensors on the "
                             "tables' device")
    if active is not None and (active.dtype != torch.bool
                               or tuple(active.shape) != (r,)
                               or active.device != dev):
        raise ValueError("active must be an (R,) bool tensor on the tables' "
                         "device")
    if not 1 <= stack_depth <= STACK_MAX:
        raise ValueError(f"stack_depth must be 1..{STACK_MAX} (the "
                         f"kernel's stack), got {stack_depth}")
    # above LARGE_FLOAT a missed leaf would count as closer than the best
    if not t_max <= LARGE_FLOAT:
        raise ValueError(f"t_max must be at most LARGE_FLOAT, got {t_max}")


def trace_rays(ta: TraversalArrays, o: torch.Tensor, d: torch.Tensor,
               stack_depth: int = 64, max_steps: int = 200_000,
               t_max: float = LARGE_FLOAT,
               active: Optional[torch.Tensor] = None
               ) -> Tuple[Hits, PerfCounters]:
    """Closest-hit walk of (R, 3) world-space rays -> (Hits,
    PerfCounters).  ``active`` (optional (R,) bool): rays marked False
    take no step and keep the initial record (a miss at ``t_max``, zero
    counts).  CUDA tensors launch K6; CPU tensors run
    ``trace_rays_ref``."""
    if o.device.type == "cpu":
        return trace_rays_ref(ta, o, d, stack_depth, max_steps, t_max,
                              active)
    out = kernel_call(ta, o, d, stack_depth, max_steps, t_max, active)()
    return _records(out)


def _records(out) -> Tuple[Hits, PerfCounters]:
    dist, bx, by, bz, tri, inst, visited, tests = out
    steps = visited.max() if visited.numel() else visited.sum()
    return (Hits(dist, bx, by, bz, tri, inst),
            PerfCounters(visited, tests, steps))


def kernel_call(ta: TraversalArrays, o: torch.Tensor, d: torch.Tensor,
                stack_depth: int = 64, max_steps: int = 200_000,
                t_max: float = LARGE_FLOAT,
                active: Optional[torch.Tensor] = None):
    """The K6 launch of ``trace_rays`` for CUDA tensors, inputs checked,
    the records packed (once per ``ta``: ``ta.walk_tables()``) and
    outputs allocated once.  Each call of the returned function launches
    the kernel into the same outputs (dist, bx, by, bz, tri, inst,
    nodes_visited, tri_tests) and returns them, and launches nothing
    else, so CUDA events around many calls time the kernel."""
    _check(ta, o, d, active, stack_depth, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"no CUDA walk for device {o.device}")
    lib = kernels.load("traverse2")
    r = o.shape[0]
    if r >= 2**31:
        raise ValueError("ray count exceeds the kernel's int32 index")
    wt = ta.walk_tables()
    if wt.nodes.data_ptr() % 64 or wt.tris.data_ptr() % 16:
        raise ValueError("the kernel reads node records as 64-B rows and "
                         "slot records as 16-B vectors: align them")
    o, d = o.contiguous(), d.contiguous()
    act = None if active is None else active.contiguous()
    dev = o.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = (torch.empty(r, **f32), torch.empty(r, **f32),
           torch.empty(r, **f32), torch.empty(r, **f32),
           torch.empty(r, **i32), torch.empty(r, **i32),
           torch.empty(r, **i32), torch.empty(r, **i32))
    ptrs = (ctypes.c_void_p * len(out))()
    sizes = (r, wt.nodes.shape[0], wt.tris.shape[0], wt.max_leaf_tris,
             wt.num_tlas, int(stack_depth), min(int(stack_depth), wt.depth),
             int(max_steps))

    def launch():
        # the closure holds the records, inputs and outputs: their
        # addresses are taken here, at each launch, never kept past them
        for k, a in enumerate(out):
            ptrs[k] = a.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.lib.vrt_traverse2(
                wt.nodes.data_ptr(), wt.tris.data_ptr(), o.data_ptr(),
                d.data_ptr(), 0 if act is None else act.data_ptr(), ptrs,
                *sizes, float(t_max), stream)
        if err != 0:
            raise RuntimeError(f"traverse2 launch failed: "
                               f"{lib.error_string(err)} ({err})")
        if r > 0:
            kernels.LAUNCHES["traverse2"] += 1
        return out

    return launch


def trace_rays_ref(ta: TraversalArrays, o: torch.Tensor, d: torch.Tensor,
                   stack_depth: int = 64, max_steps: int = 200_000,
                   t_max: float = LARGE_FLOAT,
                   active: Optional[torch.Tensor] = None
                   ) -> Tuple[Hits, PerfCounters]:
    """Plain PyTorch version of ``trace_rays``, on any device: the JAX
    loop body over all lanes with masks."""
    _check(ta, o, d, active, stack_depth, t_max)
    return _records(_walk_ref(ta, o, d, stack_depth, max_steps, t_max,
                              active, None))


def trace_records_ref(wt: WalkTables, o: torch.Tensor, d: torch.Tensor,
                      stack_depth: int = 64, max_steps: int = 200_000,
                      t_max: float = LARGE_FLOAT,
                      active: Optional[torch.Tensor] = None
                      ) -> Tuple[Hits, PerfCounters]:
    """The plain walk over K6's records alone (no word of the arrays they
    were packed from), with K6's stack of ``min(stack_depth,
    wt.depth)`` entries: ``trace_rays_ref``'s records."""
    _check_records(wt, o, d, active, stack_depth, t_max)
    return _records(_walk_ref(wt, o, d, stack_depth, max_steps, t_max,
                              active, None))


def rays_work(ta: TraversalArrays, o: torch.Tensor, d: torch.Tensor,
              stack_depth: int = 64, max_steps: int = 200_000,
              active: Optional[torch.Tensor] = None):
    """What the walk of these rays computes and reads, per ray and per
    table entry (``packet_walk.WalkWork``; ``tools/walk_bounds.k6_bound``
    turns it into a bound).  Rows: node records [0, P) (kind, left,
    count: 12 B), node boxes [P, 2P) (24 B, read when the parent is
    visited), leaf slots [2P, 2P+T) (4 B of ``tri_idx``), triangles
    [2P+T, 2P+T+V) (36 B of vertices), instances after them (52 B: the
    3x4 inverse transform and the BLAS root)."""
    from vortex_rt_tpu_torch.ops.packet_walk import WalkWork  # (imports K2)

    _check(ta, o, d, active, stack_depth, LARGE_FLOAT)
    p, t, v = ta.kind.shape[0], ta.tri_idx.shape[0], ta.v0.shape[0]
    work = WalkWork.zeros(o.shape[0], 2 * p + t + v + ta.inst_root.shape[0],
                          o.device)
    _walk_ref(ta, o, d, stack_depth, max_steps, LARGE_FLOAT, active, work)
    return work


def _walk_ref(src, o, d, stack_depth: int, max_steps: int, t_max: float,
              active, work):
    """(dist, bx, by, bz, tri, inst, nodes_visited, tri_tests) of the
    plain walk over ``src``, a ``TraversalArrays`` (the JAX layout) or a
    ``WalkTables`` (K6's records, and K6's stack length); counts into
    ``work`` (a WalkWork, the JAX layout only) when it is given."""
    packed = isinstance(src, WalkTables)
    dev = o.device
    r = o.shape[0]
    i64 = dict(dtype=torch.int64, device=dev)
    lanes = torch.arange(r, **i64)
    lmax = int(src.max_leaf_tris)
    num_tlas = int(src.num_tlas)
    if packed:
        n_pool, n_slots = src.nodes.shape[0], src.tris.shape[0]
        stack_n = min(stack_depth, src.depth)
        node_f = src.nodes.view(torch.float32)
        tri_f = src.tris.view(torch.float32)
    else:
        ta = src
        n_pool = ta.kind.shape[0]
        n_slots = ta.tri_idx.shape[0]
        n_tris = ta.v0.shape[0]
        n_inst = ta.inst_root.shape[0]
        stack_n = stack_depth
        kind_t, left_t, count_t = (a.to(torch.int64) for a in (
            ta.kind, ta.left, ta.count))
        tri_idx = ta.tri_idx.to(torch.int64)
        inst_root = ta.inst_root.to(torch.int64)
    inv_d = safe_rcp(d)
    large = torch.full((r,), LARGE_FLOAT, dtype=torch.float32, device=dev)

    node = torch.zeros(r, **i64)
    stack = torch.zeros((r, stack_n), **i64)
    sp = torch.zeros(r, **i64)
    inst = torch.zeros(r, **i64)
    lo, ld, linv = o.clone(), d.clone(), inv_d.clone()
    best_t = torch.full((r,), float(t_max), dtype=torch.float32, device=dev)
    bx = torch.zeros(r, dtype=torch.float32, device=dev)
    by = torch.zeros_like(bx)
    tri = torch.zeros(r, **i64)
    best_inst = torch.zeros(r, **i64)
    done = (torch.zeros(r, dtype=torch.bool, device=dev) if active is None
            else ~active)
    visited = torch.zeros(r, **i64)
    tests = torch.zeros(r, **i64)
    steps = 0
    while steps < max_steps and not bool(done.all()):
        act = ~done
        nd = node.clamp(0, n_pool - 1)
        if packed:
            rec = src.nodes[nd].to(torch.int64)
            kind, lft, lcount = rec[:, 0], rec[:, 1], rec[:, 2]
            body = node_f[nd, 4:]
        else:
            kind, lft, lcount = kind_t[nd], left_t[nd], count_t[nd]
        is_int = act & (kind == KIND_INTERNAL)
        is_inst = act & (kind == KIND_INSTANCE)
        is_tris = act & (kind == KIND_TRIS)
        in_tlas = (nd < num_tlas).unsqueeze(1)
        ro = torch.where(in_tlas, o, lo)
        rinv = torch.where(in_tlas, inv_d, linv)

        # ---- internal: both children, closest first ----
        if packed:  # the record's left child is clamped, its boxes inline
            l = lft
            boxes = (body[:, 0:3], body[:, 3:6], body[:, 6:9], body[:, 9:12])
        else:
            l = lft.clamp(0, n_pool - 2)
            boxes = (ta.nmin[l], ta.nmax[l], ta.nmin[l + 1], ta.nmax[l + 1])
        rgt = l + 1
        tl, hl = ray_aabb(ro, rinv, boxes[0], boxes[1])
        tr, hr = ray_aabb(ro, rinv, boxes[2], boxes[3])
        # the non-strict prune: exact-tie hits are still tested
        hl = hl & (tl <= best_t)
        hr = hr & (tr <= best_t)
        l_first = tl <= tr
        near = torch.where(l_first, l, rgt)
        far = torch.where(l_first, rgt, l)
        both = hl & hr
        pop = torch.full_like(l, _POP)
        next_int = torch.where(both, near, torch.where(
            hl, l, torch.where(hr, rgt, pop)))
        push = is_int & both
        spc = sp.clamp_max(stack_n - 1)
        stack[lanes, spc] = torch.where(push, far, stack[lanes, spc])
        sp = sp + push.to(torch.int64)

        # ---- instance leaf: object space, jump to the BLAS root ----
        if packed:  # the record's instance id is clamped, its rows inline
            iid = lft
            lo_new, ld_new = transform_ray(body.view(r, 3, 4), o, d)
            next_inst = rec[:, 3]
        else:
            iid = lft.clamp(0, n_inst - 1)
            lo_new, ld_new = transform_ray(ta.inst_inv[iid], o, d)
            next_inst = inst_root[iid]
        e = is_inst.unsqueeze(1)
        inst = torch.where(is_inst, iid, inst)
        lo = torch.where(e, lo_new, lo)
        ld = torch.where(e, ld_new, ld)
        linv = torch.where(e, safe_rcp(ld_new), linv)

        # ---- triangle leaf: max_leaf_tris Moller-Trumbore slots ----
        slot_j = torch.arange(lmax, **i64)
        slots = (lft.unsqueeze(1) + slot_j).clamp(0, n_slots - 1)
        valid = slot_j.unsqueeze(0) < lcount.unsqueeze(1)
        if packed:  # the slot's record: v0, the edges, the clamped id
            tf = tri_f[slots]
            tids = src.tris[slots, 9].to(torch.int64)
            t, w1, w2 = moller_trumbore_edges(
                lo.unsqueeze(1), ld.unsqueeze(1), tf[..., 0:3],
                tf[..., 3:6], tf[..., 6:9])
        else:
            tids = tri_idx[slots].clamp(0, n_tris - 1)
            t, w1, w2 = moller_trumbore(lo.unsqueeze(1), ld.unsqueeze(1),
                                        ta.v0[tids], ta.v1[tids],
                                        ta.v2[tids])
        t = torch.where(valid & is_tris.unsqueeze(1), t,
                        torch.full_like(t, LARGE_FLOAT))
        # among equal-t hits the smallest global triangle id, then (below)
        # the smallest instance
        t_min = t.amin(1)
        tid_key = torch.where(t == t_min.unsqueeze(1), tids,
                              torch.full_like(tids, _INT_MAX))
        j = tid_key.argmin(1)
        t_best = t[lanes, j]
        tid_best = tids[lanes, j]
        closer = t_best < best_t
        tie = (t_best == best_t) & (t_best < large)
        tie_better = tie & ((inst < best_inst)
                            | ((inst == best_inst) & (tid_best < tri)))
        upd = closer | tie_better
        best_t = torch.where(upd, t_best, best_t)
        bx = torch.where(upd, w1[lanes, j], bx)
        by = torch.where(upd, w2[lanes, j], by)
        tri = torch.where(upd, tid_best, tri)
        best_inst = torch.where(upd, inst, best_inst)

        # ---- next node, then pop where asked ----
        nxt = torch.where(is_int, next_int, torch.where(is_inst, next_inst,
                                                        pop))
        nxt = torch.where(act, nxt, node)
        want_pop = act & (nxt == _POP)
        can_pop = want_pop & (sp > 0)
        sp_top = (sp - 1).clamp_min(0)
        popped = stack[lanes, sp_top.clamp_max(stack_n - 1)]
        node = torch.where(can_pop, popped, nxt)
        sp = torch.where(can_pop, sp_top, sp)
        done = done | (want_pop & ~can_pop)
        visited = visited + act.to(torch.int64)
        tests = tests + torch.where(is_tris, lcount, 0)
        if work is not None:
            n_valid = lcount.clamp(0, lmax)
            work.add(is_int, torch.full_like(lcount, 2), is_tris, n_valid,
                     is_inst)
            work.read(nd, torch.full_like(nd, 12), act)
            for c in (l, rgt):
                work.read(n_pool + c, torch.full_like(c, 24), is_int)
            m = is_tris.unsqueeze(1) & valid
            flat = torch.full_like(slots, 4)
            work.read((2 * n_pool + slots).flatten(), flat.flatten(),
                      m.flatten())
            work.read((2 * n_pool + n_slots + tids).flatten(),
                      (flat * 9).flatten(), m.flatten())
            work.read(2 * n_pool + n_slots + n_tris + iid,
                      torch.full_like(iid, 52), is_inst)
        steps += 1

    i32 = torch.int32
    return (best_t, bx, by, (1.0 - bx) - by, tri.to(i32), best_inst.to(i32),
            visited.to(i32), tests.to(i32))
