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

The JAX loop steps every lane under one global ``max_steps``; a lane that
is done is frozen.  One thread walking its own ray to its end, capped at
``max_steps`` of its own, is the same walk, and ``steps`` (the lockstep
iterations) is the largest ``nodes_visited``.

Stack overflow (ROADMAP Queue 3): a push writes ``stack[min(sp, D-1)]``
while ``sp`` keeps counting, and a pop reads ``stack[min(max(sp-1, 0),
D-1)]`` (the JAX gather clamps its index), so a walk deeper than
``stack_depth`` silently loses entries and finds other hits.  Both
versions copy the clamp.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vortex_rt_tpu_torch.models.scene import SceneBuffers
from vortex_rt_tpu_torch.ops.intersect import (
    moller_trumbore, ray_aabb, safe_rcp, transform_ray,
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
    if ta.max_leaf_tris < 1 or ta.kind.shape[0] < 2:
        raise ValueError("the pool needs two nodes and a triangle leaf")


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
    """The K6 launch of ``trace_rays`` for CUDA tensors, inputs checked
    and outputs allocated once.  Each call of the returned function
    launches the kernel into the same outputs (dist, bx, by, bz, tri,
    inst, nodes_visited, tri_tests) and returns them, and launches
    nothing else, so CUDA events around many calls time the kernel."""
    _check(ta, o, d, active, stack_depth, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"no CUDA walk for device {o.device}")
    lib = kernels.load("traverse2")
    r = o.shape[0]
    if r >= 2**31:
        raise ValueError("ray count exceeds the kernel's int32 index")
    o, d = o.contiguous(), d.contiguous()
    act = None if active is None else active.contiguous()
    tabs = [a.contiguous() for a in (
        ta.nmin, ta.nmax, ta.left, ta.count, ta.kind, ta.tri_idx, ta.v0,
        ta.v1, ta.v2, ta.inst_inv, ta.inst_root)]
    dev = o.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = (torch.empty(r, **f32), torch.empty(r, **f32),
           torch.empty(r, **f32), torch.empty(r, **f32),
           torch.empty(r, **i32), torch.empty(r, **i32),
           torch.empty(r, **i32), torch.empty(r, **i32))
    ptrs = (ctypes.c_void_p * len(out))()

    def launch():
        # the closure holds the inputs and outputs: their addresses are
        # taken here, at each launch, never kept past the tensors
        for k, a in enumerate(out):
            ptrs[k] = a.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.lib.vrt_traverse2(
                *(a.data_ptr() for a in tabs), o.data_ptr(), d.data_ptr(),
                0 if act is None else act.data_ptr(), ptrs, r,
                ta.kind.shape[0], ta.tri_idx.shape[0], ta.v0.shape[0],
                ta.inst_root.shape[0], int(ta.max_leaf_tris),
                int(ta.num_tlas), int(stack_depth), int(max_steps),
                float(t_max), stream)
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
    return _records(_walk_ref(ta, o, d, stack_depth, max_steps, t_max,
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

    p, t, v = ta.kind.shape[0], ta.tri_idx.shape[0], ta.v0.shape[0]
    work = WalkWork.zeros(o.shape[0], 2 * p + t + v + ta.inst_root.shape[0],
                          o.device)
    _walk_ref(ta, o, d, stack_depth, max_steps, LARGE_FLOAT, active, work)
    return work


def _walk_ref(ta: TraversalArrays, o, d, stack_depth: int, max_steps: int,
              t_max: float, active, work):
    """(dist, bx, by, bz, tri, inst, nodes_visited, tri_tests) of the
    plain walk; counts into ``work`` (a WalkWork) when it is given."""
    _check(ta, o, d, active, stack_depth, t_max)
    dev = o.device
    r = o.shape[0]
    i64 = dict(dtype=torch.int64, device=dev)
    n_pool = ta.kind.shape[0]
    n_slots = ta.tri_idx.shape[0]
    n_tris = ta.v0.shape[0]
    n_inst = ta.inst_root.shape[0]
    lmax = int(ta.max_leaf_tris)
    lanes = torch.arange(r, **i64)
    kind_t, left_t, count_t = (a.to(torch.int64) for a in (
        ta.kind, ta.left, ta.count))
    tri_idx = ta.tri_idx.to(torch.int64)
    inst_root = ta.inst_root.to(torch.int64)
    inv_d = safe_rcp(d)
    large = torch.full((r,), LARGE_FLOAT, dtype=torch.float32, device=dev)

    node = torch.zeros(r, **i64)
    stack = torch.zeros((r, stack_depth), **i64)
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
        kind = kind_t[nd]
        is_int = act & (kind == KIND_INTERNAL)
        is_inst = act & (kind == KIND_INSTANCE)
        is_tris = act & (kind == KIND_TRIS)
        in_tlas = (nd < ta.num_tlas).unsqueeze(1)
        ro = torch.where(in_tlas, o, lo)
        rinv = torch.where(in_tlas, inv_d, linv)

        # ---- internal: both children, closest first ----
        lft = left_t[nd]
        l = lft.clamp(0, n_pool - 2)
        rgt = l + 1
        tl, hl = ray_aabb(ro, rinv, ta.nmin[l], ta.nmax[l])
        tr, hr = ray_aabb(ro, rinv, ta.nmin[rgt], ta.nmax[rgt])
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
        spc = sp.clamp_max(stack_depth - 1)
        stack[lanes, spc] = torch.where(push, far, stack[lanes, spc])
        sp = sp + push.to(torch.int64)

        # ---- instance leaf: object space, jump to the BLAS root ----
        iid = lft.clamp(0, n_inst - 1)
        lo_new, ld_new = transform_ray(ta.inst_inv[iid], o, d)
        e = is_inst.unsqueeze(1)
        inst = torch.where(is_inst, iid, inst)
        lo = torch.where(e, lo_new, lo)
        ld = torch.where(e, ld_new, ld)
        linv = torch.where(e, safe_rcp(ld_new), linv)
        next_inst = inst_root[iid]

        # ---- triangle leaf: max_leaf_tris Moller-Trumbore slots ----
        lcount = count_t[nd]
        slot_j = torch.arange(lmax, **i64)
        slots = (lft.unsqueeze(1) + slot_j).clamp(0, n_slots - 1)
        tids = tri_idx[slots].clamp(0, n_tris - 1)
        valid = slot_j.unsqueeze(0) < lcount.unsqueeze(1)
        t, w1, w2 = moller_trumbore(lo.unsqueeze(1), ld.unsqueeze(1),
                                    ta.v0[tids], ta.v1[tids], ta.v2[tids])
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
        popped = stack[lanes, sp_top.clamp_max(stack_depth - 1)]
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
