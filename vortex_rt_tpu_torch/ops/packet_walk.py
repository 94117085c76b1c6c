"""BVH walk over the 4-wide quantized tables: the CUDA kernel's wrapper
and its plain PyTorch version (port of
``vortex_rt_tpu/ops/pallas/packet_walk.py``).

``trace_packets_walk`` is what the frame calls.  For CUDA tensors it
launches ``csrc/packet_walk.cu`` (K2: one thread per ray, K1's design at
width 4; ``stack_entries`` packed deferred-children entries a ray, at
most ``STACK_MAX``) or raises; for CPU
tensors it runs ``trace_packets_walk_ref``, the plain PyTorch version of
the same per-ray walk.  There is no fallback between the two.
``kernel_call`` is the bare launch, for timing it; ``walk_work_4`` counts
what a walk computes, for its bound.

Semantics (shared with the JAX package's ``trace_packets_pallas``):
``stats=True`` also returns each ray's steps by node kind
(``StepKinds``): CUDA tensors launch the kernel's counting
instantiation (counted as ``packet_walk_stats``), CPU tensors count in
the plain walk (``walk_work_4``).
``active`` masks dead rays (they report a miss), ``t_max`` (at most
LARGE_FLOAT: past it the plain version folds a missed candidate into the
record, which no kernel does) clamps the search interval, and
``occlusion=True`` retires a ray at its first hit
inside the clamp: occluded rays return dist 0.0, the others LARGE_FLOAT.
``alpha_ref=thr`` (the tables of ``WideArrays.with_alpha``) rejects every
candidate whose surface alpha is below ``thr`` before it counts, as the
JAX ``trace_packets(alpha_ref=thr)`` does on 4-wide tables (the Pallas
kernel had no any-hit mode); CUDA tensors launch the kernel's alpha
instantiation, counted as ``packet_walk_alpha``.  ``anyhit_pred=pred`` (a
stateless predicate ``pred(u, v, alpha) -> keep``, or its
``ops.anyhit_pred.CompiledPredicate``; the same tables) rejects every
candidate whose predicate is false, as the JAX
``trace_packets(anyhit_pred=pred)`` does; it wins over ``alpha_ref``.
CUDA tensors launch the predicate mode of a library built with the
compiled predicate (``kernels.load_pred``), counted as
``packet_walk_pred``, which decides a slot's candidates by its class
(``pred_classes``, a class word a triangle row; ``ops/pred_classes.py``);
the plain version tests every candidate: it calls the compiled
predicate's plain version (``CompiledPredicate.plain``: its correctly
rounded ops in float64, rounded once, as the kernel evaluates them) on
the candidates' (u, v, alpha).
The TPU kernel walked the union of a 1024-ray packet's paths; both
versions here walk each ray's own path, which gives the same hits (the
closest hit is a min over a ray's own candidates with a lexicographic
(t, tid) tie-break) up to exact-t ties that pruning by a strict
``tmin < best_t`` resolves by visit order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from vortex_rt_tpu_torch.ops.anyhit_pred import (
    CompiledPredicate, compile_predicate,
)
from vortex_rt_tpu_torch.ops.pred_classes import (
    CLS_TEST, CLS_UV, PredClasses, build as build_classes, check_classes,
)
from vortex_rt_tpu_torch.ops.traverse2 import Hits
from vortex_rt_tpu_torch.ops.traverse_wide import (
    INST_ROOT, INST_XFORM, LEAF, LEFT_BITS, LEFT_MASK, META, QHI, QLO,
    WideArrays,
)
from vortex_rt_tpu_torch.runtime import kernels
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT, MT_EPSILON

MAX_STEPS = 400_000
# packed stack entries the kernel holds (VRT_STACK_MAX of
# csrc/packet_walk.cu: 48 KB a block; the library reports it and
# kernel_call refuses a deeper tree)
STACK_MAX = 48
_INT_MAX = 2**31 - 1
# the child sorting network of the TPU kernel (packet_walk.py:148)
_SORT_NET = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))
# bytes of a triangle slot a leaf test reads: v0, e1, e2 and the tid
TRI_SLOT_BYTES = 40


class WalkWork(NamedTuple):
    """What a BVH walk computes, per ray ((R,) int64 each), as the plain
    versions count it: steps at internal nodes and the child slots they
    test (each node's child count), steps at triangle leaves and the
    triangle slots they test (each leaf's triangle count), steps at
    instance nodes (TLAS builds), and alpha tests (candidates that
    passed Moller-Trumbore in an alpha-mode walk); per table row
    ((rows,) int64), the bytes of it the walk reads (0 for a row no ray
    visits); and the alpha tests the kernel makes (K1's alpha mode: the
    candidates of slots its classes leave to the test; the predicate
    modes: the candidates of slots classed ``CLS_TEST`` or ``CLS_UV``, of
    which only the first read a texel, ``texel_reads``; K2's alpha mode
    tests every candidate), and in a predicate walk the candidates by
    slot class (``by_class``, (4,): test, kept, cut, uv).  An alpha-mode
    walk's rows include the alpha pool's entries, 4 B each."""

    internal: torch.Tensor
    child_slots: torch.Tensor
    leaf: torch.Tensor
    tri_slots: torch.Tensor
    instance: torch.Tensor
    alpha_tests: torch.Tensor
    row_bytes: torch.Tensor
    alpha_lookups: torch.Tensor
    texel_reads: Optional[torch.Tensor] = None
    by_class: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(r: int, rows: int, device) -> "WalkWork":
        def per_ray():
            return torch.zeros(r, dtype=torch.int64, device=device)

        return WalkWork(*(per_ray() for _ in range(6)),
                        torch.zeros(rows, dtype=torch.int64, device=device),
                        per_ray(), per_ray(),
                        torch.zeros(4, dtype=torch.int64, device=device))

    def classify(self, cand, cls, looked, texel) -> None:
        """Count the candidates ``cand`` of one slot column by class
        ``cls`` (per ray), the tests (``looked``) and texel reads
        (``texel``) the kernel makes of them."""
        self.alpha_lookups.add_(looked.to(torch.int64))
        self.texel_reads.add_(texel.to(torch.int64))
        if cls is not None:
            self.by_class.add_(torch.bincount(cls[cand], minlength=4))

    def read(self, row, nbytes, mask) -> None:
        """Rays in ``mask`` read ``nbytes`` of table row ``row`` (a row
        read by many rays, or many times, counts once)."""
        self.row_bytes.scatter_reduce_(0, row[mask], nbytes[mask].to(
            torch.int64), reduce="amax")

    def add(self, is_int, nch, is_leaf, leaf_slots, is_inst=None) -> None:
        """Count one lockstep step (masks and counts per ray)."""
        self.internal.add_(is_int.to(torch.int64))
        self.child_slots.add_(torch.where(is_int, nch, 0).to(torch.int64))
        self.leaf.add_(is_leaf.to(torch.int64))
        self.tri_slots.add_(torch.where(is_leaf, leaf_slots, 0)
                            .to(torch.int64))
        if is_inst is not None:
            self.instance.add_(is_inst.to(torch.int64))


class StepKinds(NamedTuple):
    """A counting walk's per-ray steps by node kind ((R,) int32 each):
    steps at internal nodes and at instance nodes.  A ray's steps at
    triangle leaves are its steps less both.  The kernels' counting
    instantiations write them; on CPU tensors they come from the plain
    walk's ``WalkWork``."""

    internal: torch.Tensor
    instance: torch.Tensor

    @staticmethod
    def from_work(work: WalkWork) -> "StepKinds":
        return StepKinds(work.internal.to(torch.int32),
                         work.instance.to(torch.int32))


# bytes of a leaf slot's alpha fields (uv triple, texture offset and size)
ALPHA_SLOT_BYTES = 32


def alpha_fields(rows_f: torch.Tensor, c: int):
    """Slot ``c``'s alpha fields of gathered alpha rows (R, 8*k) float32:
    (u0, v0, u1, v1, u2, v2) float lanes, then the texture offset and
    ``tw << 16 | th`` as int lanes."""
    b = 8 * c
    ints = rows_f.view(torch.int32)
    return ([rows_f[:, b + j] for j in range(6)]
            + [ints[:, b + 6].to(torch.int64), ints[:, b + 7].to(torch.int64)])


def candidate_surface(f, w1, w2, pool: torch.Tensor):
    """The plain version of ``csrc/alpha_test.cuh::vrt_candidate_surface``:
    a candidate's interpolated uv at barycentrics (w1, w2) and its surface
    alpha, the pool entry of the point-sampled texel, for every lane (the
    caller masks).  Returns (u, v, alpha, pool index).  The JAX body's
    operations in its order (traverse_packet.py:723-761); ``%`` is
    floored, as jnp's."""
    u0, v0, u1, v1, u2, v2, toff, twh = f
    bz = 1.0 - w1 - w2
    u = u1 * w1 + u2 * w2 + u0 * bz
    v = v1 * w1 + v2 * w2 + v0 * bz
    tw = (twh >> 16).clamp_min(1)
    th = (twh & 0xFFFF).clamp_min(1)
    iu = torch.floor(u * tw.to(torch.float32)).to(torch.int64) % tw
    iv = torch.floor(v * th.to(torch.float32)).to(torch.int64) % th
    idx = (toff + iu + iv * tw).clamp(0, pool.shape[0] - 1)
    return u, v, pool[idx], idx


def alpha_keep(f, w1, w2, pool: torch.Tensor, thr: float):
    """The plain version of ``csrc/alpha_test.cuh::vrt_alpha_keep``: keep
    a candidate at barycentrics (w1, w2) unless its surface alpha is
    below ``thr``.  Returns (keep, pool index) for every lane."""
    _, _, alpha, idx = candidate_surface(f, w1, w2, pool)
    thr_t = torch.tensor(thr, dtype=torch.float32, device=pool.device)
    return ~(alpha < thr_t), idx


def pred_keep(pred: CompiledPredicate, f, w1, w2, pool: torch.Tensor,
              mask: torch.Tensor):
    """The predicate mode's test in the plain walks: the predicate's
    plain version (``CompiledPredicate.plain``: its correctly rounded ops
    in float64, rounded once, as the kernel evaluates them) on the
    surface (u, v, alpha) of the candidates in ``mask``; True elsewhere.
    Returns (keep, pool index)."""
    u, v, alpha, idx = candidate_surface(f, w1, w2, pool)
    keep = torch.ones_like(mask)
    keep[mask] = pred.plain(u[mask], v[mask], alpha[mask])
    return keep, idx


def pred_classes(wa: WideArrays, pred) -> PredClasses:
    """The slot classes of K2's predicate mode for ``pred`` over the
    4-wide tables' alpha rows (one class word a triangle row: the BLAS
    rows on a TLAS build; ``ops/pred_classes.py``), made once per table
    and predicate on the CPU and kept with ``wa`` keyed by the
    predicate's header hash (ROADMAP hazard H25).  Raises for rows of
    more than 16 slots."""
    compiled = compile_predicate(pred)
    kept = wa.__dict__.setdefault("_pred_classes", {})
    if compiled.digest not in kept:
        check_alpha(wa)
        n, k = wa.tri_rows.shape[0], wa.tri_rows.shape[1] // 16
        nodes = wa.nodes.cpu().long() & 0xFFFFFFFF
        leaf = (nodes[:, META] >> 29) == 1
        row = (nodes[:, META] & LEFT_MASK)[leaf].clamp(0, n - 1)
        cnt = torch.zeros(n, dtype=torch.int64)
        cnt[row] = nodes[:, LEAF][leaf]
        real = torch.arange(k) < cnt.unsqueeze(1)
        kept[compiled.digest] = build_classes(
            compiled, wa.alpha_rows.cpu().reshape(n, k, 8), wa.alpha_pool,
            real, wa.nodes.device)
    return kept[compiled.digest]


def anyhit_mode(alpha_ref: Optional[float], anyhit_pred
                ) -> Tuple[Optional[float], Optional[CompiledPredicate]]:
    """(alpha_ref, compiled predicate) of a walk: a predicate wins over
    the threshold, as in the JAX ``trace_packets``; compiling it raises
    ``NotImplementedError`` for what the kernels cannot run."""
    if anyhit_pred is None:
        return alpha_ref, None
    return None, compile_predicate(anyhit_pred)


def check_alpha(wa: WideArrays) -> None:
    """An alpha- or predicate-mode walk needs the tables of
    ``WideArrays.with_alpha``."""
    if wa.alpha_rows is None or wa.alpha_pool is None:
        raise ValueError("alpha_ref and anyhit_pred need the alpha "
                         "tables: WideArrays.with_alpha(sb)")
    k = wa.tri_rows.shape[1] // 16
    if (wa.alpha_rows.dtype != torch.float32
            or wa.alpha_rows.shape != (wa.tri_rows.shape[0], 8 * k)
            or not wa.alpha_rows.is_contiguous()
            or wa.alpha_pool.dtype != torch.float32
            or wa.alpha_pool.dim() != 1 or wa.alpha_pool.numel() < 1
            or wa.alpha_rows.device != wa.nodes.device
            or wa.alpha_pool.device != wa.nodes.device):
        raise ValueError("alpha_rows must be a contiguous (L, 8*k) float32 "
                         "tensor beside tri_rows (L, 16*k) and alpha_pool a "
                         "non-empty (P,) float32 tensor, on the tables' "
                         "device")


def stack_entries(wa: WideArrays) -> int:
    """Stack entries the kernel's walk over ``wa`` needs: one packed
    deferred-children entry per descended level, so depth + 4 cannot
    overflow (``depth`` counts the TLAS and BLAS levels of a path)."""
    return int(wa.depth) + 4


def check_stack(wa: WideArrays) -> int:
    """The kernel's stack entries for ``wa``; raises when they pass its
    cap, ``STACK_MAX`` (ROADMAP H8: a clamped push would lose hits)."""
    n = stack_entries(wa)
    if n > STACK_MAX:
        raise ValueError(f"BVH depth {wa.depth} needs {n} stack entries; "
                         f"the kernel is compiled for {STACK_MAX}")
    return n


def _limit(n: int, device, active, t_max) -> torch.Tensor:
    """Per-ray search limit: t_max (or LARGE_FLOAT), -1 for dead rays."""
    limit = (torch.full((n,), LARGE_FLOAT, dtype=torch.float32, device=device)
             if t_max is None else t_max.to(torch.float32))
    if active is not None:
        limit = torch.where(active, limit, torch.full_like(limit, -1.0))
    return limit.contiguous()


def _check(wa: WideArrays, o, d, active, t_max) -> None:
    if wa.width != 4:
        raise ValueError("this walk reads 4-wide rows; 8-wide fused "
                         "tables go to ops.traverse_packet.trace_packets")
    if wa.nodes.dtype != torch.int32 or wa.nodes.dim() != 2 \
            or wa.nodes.shape[1] != 32 or not wa.nodes.is_contiguous():
        raise ValueError("nodes must be a contiguous (N, 32) int32 tensor")
    if wa.tri_rows.dtype != torch.float32 or wa.tri_rows.dim() != 2 \
            or wa.tri_rows.shape[1] % 16 \
            or wa.tri_rows.shape[1] < 16 * max(wa.max_leaf_tris, 1) \
            or not wa.tri_rows.is_contiguous():
        raise ValueError("tri_rows must be a contiguous (L, 16*k) float32 "
                         "tensor with k >= max_leaf_tris")
    if wa.tri_rows.device != wa.nodes.device:
        raise ValueError("nodes and tri_rows lie on different devices")
    check_rays(wa.nodes.device, o, d, active, t_max)


def check_rays(dev, o, d, active, t_max) -> None:
    """Ray inputs of a walk: (R, 3) float32 o and d, optional (R,) bool
    ``active`` and (R,) float32 ``t_max``, all on the tables' device."""
    for name, a in (("o", o), ("d", d)):
        if a.dtype != torch.float32 or a.dim() != 2 or a.shape[1] != 3:
            raise ValueError(f"{name} must be an (R, 3) float32 tensor")
        if a.device != dev:
            raise ValueError(f"{name} lies on {a.device}, the tables on {dev}")
    r = o.shape[0]
    if d.shape[0] != r:
        raise ValueError("o and d hold different ray counts")
    if active is not None and (active.dtype != torch.bool
                               or active.shape != (r,)
                               or active.device != dev):
        raise ValueError("active must be an (R,) bool tensor on the "
                         "tables' device")
    if t_max is not None and (t_max.dtype != torch.float32
                              or t_max.shape != (r,)
                              or t_max.device != dev):
        raise ValueError("t_max must be an (R,) float32 tensor on the "
                         "tables' device")


def trace_packets_walk(wa: WideArrays, o: torch.Tensor, d: torch.Tensor,
                       active: Optional[torch.Tensor] = None,
                       t_max: Optional[torch.Tensor] = None,
                       occlusion: bool = False,
                       max_steps: int = MAX_STEPS,
                       alpha_ref: Optional[float] = None,
                       stats: bool = False, anyhit_pred=None):
    """Closest-hit (or bounded occlusion) trace of (R, 3) rays over the
    4-wide tables.  Returns (Hits, per-ray step counts (R,) int32), and
    the rays' ``StepKinds`` third with ``stats=True``.

    CUDA tensors launch the hand-written kernel; CPU tensors run the
    plain PyTorch version."""
    alpha_ref, pred = anyhit_mode(alpha_ref, anyhit_pred)
    if o.device.type == "cpu":
        if stats:
            hits, steps, work = walk_work_4(wa, o, d, active, t_max,
                                            occlusion, max_steps, alpha_ref,
                                            pred)
            return hits, steps, StepKinds.from_work(work)
        return trace_packets_walk_ref(wa, o, d, active, t_max, occlusion,
                                      max_steps, alpha_ref, pred)
    return kernel_call(wa, o, d, active, t_max, occlusion, max_steps,
                       alpha_ref, stats, pred)()


def kernel_call(wa: WideArrays, o: torch.Tensor, d: torch.Tensor,
                active: Optional[torch.Tensor] = None,
                t_max: Optional[torch.Tensor] = None,
                occlusion: bool = False, max_steps: int = MAX_STEPS,
                alpha_ref: Optional[float] = None, stats: bool = False,
                anyhit_pred=None,
                pred_cls: Optional[PredClasses] = None
                ) -> Callable[[], tuple]:
    """The kernel launch of ``trace_packets_walk`` for CUDA tensors, with
    the inputs checked and the search limits and outputs made once.  Each
    call of the returned function launches the kernel into the same
    outputs and returns them, and does nothing else: CUDA events around
    many calls time the kernel alone.  ``stats=True`` launches the
    counting instantiation, which also returns the ``StepKinds``;
    ``anyhit_pred`` the predicate mode of the library built with it, with
    the slot classes ``pred_classes`` makes (``pred_cls``: others, for
    measuring and testing the kernel, e.g. every slot ``CLS_TEST``)."""
    _check(wa, o, d, active, t_max)
    alpha_ref, pred = anyhit_mode(alpha_ref, anyhit_pred)
    if alpha_ref is not None or pred is not None:
        check_alpha(wa)
    if pred is not None:
        pred_cls = pred_cls or pred_classes(wa, pred)
        check_classes(pred_cls.cls, wa.tri_rows.shape[0], o.device)
    stack_n = check_stack(wa)
    if o.device.type != "cuda":
        raise ValueError(f"no CUDA walk for device {o.device}")
    lib = (kernels.load("packet_walk") if pred is None
           else kernels.load_pred("packet_walk", pred))
    cap = int(lib.lib.vrt_packet_walk_stack_max())
    if cap != STACK_MAX:
        raise RuntimeError(f"the kernel holds {cap} stack entries, "
                           f"ops/packet_walk.py says {STACK_MAX}")
    r = o.shape[0]
    if r >= 2**31:
        raise ValueError("ray count exceeds the kernel's int32 index")
    if wa.nodes.data_ptr() % 16 or wa.tri_rows.data_ptr() % 16:
        raise ValueError("the kernel reads table rows as 16-byte vectors: "
                         "nodes and tri_rows must be 16-byte aligned")
    dev = o.device
    o = o.contiguous()
    d = d.contiguous()
    limit = _limit(r, dev, active, t_max)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    dist, bx, by, bz = (torch.empty(r, **f32) for _ in range(4))
    tri, inst, steps = (torch.empty(r, **i32) for _ in range(3))
    kinds = (StepKinds(torch.empty(r, **i32), torch.empty(r, **i32))
             if stats else None)

    # the closure holds the tensors (not only their addresses), so the
    # inputs made here live as long as the launcher
    tensors = (wa.nodes, wa.tri_rows, o, d, limit, dist, bx, by, bz, tri,
               inst, steps)
    sizes = (r, wa.nodes.shape[0], wa.tri_rows.shape[0],
             wa.tri_rows.shape[1], max(int(wa.max_leaf_tris), 1),
             int(wa.num_tlas), int(wa.tri_bits), stack_n, int(max_steps),
             int(bool(occlusion)))
    mode = ("pred" if pred is not None else
            "alpha" if alpha_ref is not None else "")
    name = ("packet_walk_stats" if stats else
            f"packet_walk_{mode}" if mode else "packet_walk")

    def launch() -> tuple:
        common = [t.data_ptr() for t in tensors]
        if mode:
            common += [wa.alpha_rows.data_ptr(), wa.alpha_pool.data_ptr()]
        if mode == "pred":
            common.append(pred_cls.cls.data_ptr())
        if stats:
            common += [kinds.internal.data_ptr(), kinds.instance.data_ptr()]
        alpha_sizes = (() if not mode else
                       (wa.alpha_rows.shape[1], wa.alpha_pool.shape[0],
                        float(alpha_ref if mode == "alpha"
                              else pred_cls.rep)))
        fn = getattr(lib.lib, "vrt_packet_walk" + (f"_{mode}" if mode else "")
                     + ("_stats" if stats else ""))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*common, *sizes, *alpha_sizes, stream)
        if err != 0:
            raise RuntimeError(f"packet_walk launch failed: "
                               f"{lib.error_string(err)} ({err})")
        if r > 0:
            kernels.LAUNCHES[name] += 1
        if stats:
            return Hits(dist, bx, by, bz, tri, inst), steps, kinds
        return Hits(dist, bx, by, bz, tri, inst), steps

    return launch


def _rcp(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| < 1e-20 clamped to +-1e-20 (the TPU kernel's rcp)."""
    tiny = torch.where(d < 0, torch.full_like(d, -1e-20),
                       torch.full_like(d, 1e-20))
    return 1.0 / torch.where(d.abs() < 1e-20, tiny, d)


def trace_packets_walk_ref(wa: WideArrays, o: torch.Tensor, d: torch.Tensor,
                           active: Optional[torch.Tensor] = None,
                           t_max: Optional[torch.Tensor] = None,
                           occlusion: bool = False,
                           max_steps: int = MAX_STEPS,
                           alpha_ref: Optional[float] = None,
                           anyhit_pred=None) -> Tuple[Hits, torch.Tensor]:
    """Plain PyTorch version of the per-ray walk, on any device.

    All rays step together: each step gathers every live ray's node row,
    evaluates the internal / leaf / instance paths with masks, and keeps
    per-ray stacks in an (R, S) tensor.  The same child sorting network
    and the same arithmetic order as the kernel, so both give the same
    hits and the same per-ray step counts to the bit."""
    hits, steps, _ = _walk_ref(wa, o, d, active, t_max, occlusion,
                               max_steps, False, alpha_ref, anyhit_pred)
    return hits, steps


def walk_work_4(wa: WideArrays, o: torch.Tensor, d: torch.Tensor,
                active: Optional[torch.Tensor] = None,
                t_max: Optional[torch.Tensor] = None,
                occlusion: bool = False, max_steps: int = MAX_STEPS,
                alpha_ref: Optional[float] = None, anyhit_pred=None
                ) -> Tuple[Hits, torch.Tensor, WalkWork]:
    """The plain 4-wide walk of these rays, with what it computes per
    ray: (Hits, steps, WalkWork).  ``tools/walk_bounds.py`` turns the
    work into a bound.  Its rows are the nodes, then the triangle rows,
    and in alpha or predicate mode the alpha rows and the alpha pool's
    entries."""
    return _walk_ref(wa, o, d, active, t_max, occlusion, max_steps, True,
                     alpha_ref, anyhit_pred)


def _walk_ref(wa: WideArrays, o, d, active, t_max, occlusion: bool,
              max_steps: int, count: bool, alpha_ref: Optional[float] = None,
              anyhit_pred=None):
    """(Hits, steps, WalkWork or None) of the plain 4-wide walk."""
    _check(wa, o, d, active, t_max)
    alpha_ref, pred = anyhit_mode(alpha_ref, anyhit_pred)
    alpha = alpha_ref is not None or pred is not None
    if alpha:
        check_alpha(wa)
    # the kernel's classes (predicate mode), for its count of tests only
    classes = pred_classes(wa, pred).cls if pred is not None and count \
        else None
    dev = o.device
    r = o.shape[0]
    limit = _limit(r, dev, active, t_max)
    nodes = wa.nodes
    nodes_f = nodes.view(torch.float32)
    rows = wa.tri_rows
    rows_i = rows.view(torch.int32)
    n_nodes, n_rows = nodes.shape[0], rows.shape[0]
    lmax = max(int(wa.max_leaf_tris), 1)
    # up to 3 separate pushes a level (the kernel packs them in one entry)
    stack_n = 3 * (int(wa.depth) + 2) + 8
    eps = MT_EPSILON

    def f32(v):
        return torch.full((r,), v, dtype=torch.float32, device=dev)

    large = f32(LARGE_FLOAT)
    ox, oy, oz = (o[:, k].contiguous() for k in range(3))
    dx, dy, dz = (d[:, k].contiguous() for k in range(3))
    ivx, ivy, ivz = _rcp(dx), _rcp(dy), _rcp(dz)
    lox, loy, loz = ox, oy, oz
    ldx, ldy, ldz = dx, dy, dz
    lix, liy, liz = ivx, ivy, ivz
    inst = torch.zeros(r, dtype=torch.int32, device=dev)
    best_t = limit.clone()
    bx, by = f32(0.0), f32(0.0)
    tri = torch.full((r,), _INT_MAX, dtype=torch.int32, device=dev)
    binst = torch.zeros(r, dtype=torch.int32, device=dev)
    node = torch.zeros(r, dtype=torch.int64, device=dev)
    sc = torch.zeros(r, dtype=torch.int64, device=dev)
    steps = torch.zeros(r, dtype=torch.int32, device=dev)
    stack = torch.zeros((r, stack_n), dtype=torch.int64, device=dev)
    alive = limit > 0.0
    n_pool = wa.alpha_pool.shape[0] if alpha else 0
    work = (WalkWork.zeros(r, n_nodes + n_rows * (2 if alpha else 1)
                           + n_pool, dev) if count else None)

    while bool(alive.any()):
        node_c = node.clamp(0, n_nodes - 1)
        row = nodes[node_c]
        row_f = nodes_f[node_c]
        meta = row[:, META]
        kind = (meta >> 29).clamp(0, 2)
        nch = (meta >> LEFT_BITS) & 7
        left = (meta & LEFT_MASK).to(torch.int64)
        leaf_n = row[:, LEAF]
        in_tlas = node_c < wa.num_tlas
        is_int = alive & (kind == 0)
        is_leaf = alive & (kind == 1)
        is_inst = alive & (kind == 2)

        # ---- internal: 4 slab tests, near->far sort, push far ----
        rox = torch.where(in_tlas, ox, lox)
        roy = torch.where(in_tlas, oy, loy)
        roz = torch.where(in_tlas, oz, loz)
        rix = torch.where(in_tlas, ivx, lix)
        riy = torch.where(in_tlas, ivy, liy)
        riz = torch.where(in_tlas, ivz, liz)
        gx, gy, gz = row_f[:, 0], row_f[:, 1], row_f[:, 2]
        sx, sy, sz = row_f[:, 3], row_f[:, 4], row_f[:, 5]
        ds, ix = [], []
        for c in range(4):
            ql = row[:, QLO + c]
            qh = row[:, QHI + c]

            def qb(w, sh):
                return ((w >> sh) & 255).to(torch.float32)

            lx = gx + qb(ql, 0) * sx
            ly = gy + qb(ql, 8) * sy
            lz = gz + qb(ql, 16) * sz
            hx = gx + qb(qh, 0) * sx
            hy = gy + qb(qh, 8) * sy
            hz = gz + qb(qh, 16) * sz
            t1x = (lx - rox) * rix
            t2x = (hx - rox) * rix
            t1y = (ly - roy) * riy
            t2y = (hy - roy) * riy
            t1z = (lz - roz) * riz
            t2z = (hz - roz) * riz
            tmin = torch.maximum(torch.maximum(
                torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
                torch.minimum(t1z, t2z))
            tmax = torch.minimum(torch.minimum(
                torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
                torch.maximum(t1z, t2z))
            hit = (tmax >= tmin) & (tmax > 0.0) & (tmin < best_t) & (c < nch)
            ds.append(torch.where(hit, tmin, large))
            ix.append(torch.full((r,), c, dtype=torch.int64, device=dev))
        for a, b in _SORT_NET:
            swap = ds[a] > ds[b]
            ds[a], ds[b] = (torch.where(swap, ds[b], ds[a]),
                            torch.where(swap, ds[a], ds[b]))
            ix[a], ix[b] = (torch.where(swap, ix[b], ix[a]),
                            torch.where(swap, ix[a], ix[b]))
        for j in (3, 2, 1):
            do = is_int & (ds[j] < LARGE_FLOAT)
            slot = sc.clamp(max=stack_n - 1).unsqueeze(1)
            cur = stack.gather(1, slot).squeeze(1)
            stack.scatter_(1, slot, torch.where(do, left + ix[j], cur)
                           .unsqueeze(1))
            sc = sc + do.to(torch.int64)
        int_desc = is_int & (ds[0] < LARGE_FLOAT)
        nxt = torch.where(int_desc, left + ix[0], node)

        # ---- triangle leaf: up to lmax Moller-Trumbore tests ----
        row_i = left.clamp(0, n_rows - 1)
        tr = rows[row_i]
        tr_i = rows_i[row_i]
        ar = wa.alpha_rows[row_i] if alpha else None
        cls_w = (None if classes is None
                 else classes[row_i].to(torch.int64) & 0xFFFFFFFF)
        n_alpha = torch.zeros(r, dtype=torch.int64, device=dev)
        n_looked = torch.zeros(r, dtype=torch.int64, device=dev)
        t_b, bx_b, by_b, tri_b, bi_b = best_t, bx, by, tri, binst
        for c in range(lmax):
            b0 = 16 * c
            v0x, v0y, v0z = tr[:, b0 + 0], tr[:, b0 + 1], tr[:, b0 + 2]
            e1x, e1y, e1z = tr[:, b0 + 3], tr[:, b0 + 4], tr[:, b0 + 5]
            e2x, e2y, e2z = tr[:, b0 + 6], tr[:, b0 + 7], tr[:, b0 + 8]
            tid = tr_i[:, b0 + 9]
            hx_ = ldy * e2z - ldz * e2y
            hy_ = ldz * e2x - ldx * e2z
            hz_ = ldx * e2y - ldy * e2x
            a = e1x * hx_ + e1y * hy_ + e1z * hz_
            small = a.abs() < eps
            fba = 1.0 / torch.where(small, torch.ones_like(a), a)
            sx_ = lox - v0x
            sy_ = loy - v0y
            sz_ = loz - v0z
            w1 = fba * (sx_ * hx_ + sy_ * hy_ + sz_ * hz_)
            qx = sy_ * e1z - sz_ * e1y
            qy = sz_ * e1x - sx_ * e1z
            qz = sx_ * e1y - sy_ * e1x
            w2 = fba * (ldx * qx + ldy * qy + ldz * qz)
            t = fba * (e2x * qx + e2y * qy + e2z * qz)
            ok = (~small & (w1 >= 0.0) & (w1 <= 1.0) & (w2 >= 0.0)
                  & (w1 + w2 <= 1.0) & (t > eps) & (c < leaf_n) & is_leaf)
            if alpha:
                keep, idx = (alpha_keep(alpha_fields(ar, c), w1, w2,
                                        wa.alpha_pool, alpha_ref)
                             if pred is None else
                             pred_keep(pred, alpha_fields(ar, c), w1, w2,
                                       wa.alpha_pool, ok))
                if count:
                    # the predicate mode tests the slots its classes leave
                    # to the test, reading a texel for "test" ones; the
                    # alpha mode tests every candidate
                    cls = None if cls_w is None else (cls_w >> (2 * c)) & 3
                    texel = ok if cls is None else ok & (cls == CLS_TEST)
                    looked = texel if cls is None else (
                        texel | (ok & (cls == CLS_UV)))
                    n_alpha += ok.to(torch.int64)
                    n_looked += looked.to(torch.int64)
                    work.classify(ok, cls, looked, texel)
                    work.read(n_nodes + 2 * n_rows + idx,
                              torch.full_like(idx, 4), texel)
                ok = ok & keep
            t = torch.where(ok, t, large)
            if occlusion:
                t_b = torch.where(t < t_b, torch.full_like(t_b, -1.0), t_b)
            else:
                better = (t < t_b) | ((t == t_b) & (t < LARGE_FLOAT)
                                      & (tid < tri_b))
                t_b = torch.where(better, t, t_b)
                bx_b = torch.where(better, w1, bx_b)
                by_b = torch.where(better, w2, by_b)
                tri_b = torch.where(better, tid, tri_b)
                bi_b = torch.where(better, inst, bi_b)
        best_t, bx, by, tri, binst = t_b, bx_b, by_b, tri_b, bi_b
        if count:
            slots = leaf_n.clamp(0, lmax).to(torch.int64)
            work.add(is_int, nch, is_leaf, slots, is_inst)
            # the kernel's reads: a node's meta quarter (words 12..15) at
            # every step, then its boxes (words 0..11) or its transform
            # (words 16..31); a leaf's triangle slots in its tri row
            work.read(node_c, torch.where(is_int, 64, torch.where(
                is_inst, 80, 16)), alive)
            work.read(n_nodes + row_i, TRI_SLOT_BYTES * slots, is_leaf)
            if alpha:
                # the alpha fields of the slots whose candidates it tests,
                # and in predicate mode the leaf row's class word (4 B)
                work.alpha_tests.add_(n_alpha)
                cw = 4 if classes is not None else 0
                work.read(n_nodes + n_rows + row_i,
                          ALPHA_SLOT_BYTES * n_looked + cw,
                          is_leaf & ((n_looked > 0) | (cw > 0)))

        # ---- instance: world ray -> instance space, descend to BLAS ----
        mm = [row_f[:, INST_XFORM + k] for k in range(12)]
        nlox = mm[0] * ox + mm[1] * oy + mm[2] * oz + mm[3]
        nloy = mm[4] * ox + mm[5] * oy + mm[6] * oz + mm[7]
        nloz = mm[8] * ox + mm[9] * oy + mm[10] * oz + mm[11]
        nldx = mm[0] * dx + mm[1] * dy + mm[2] * dz
        nldy = mm[4] * dx + mm[5] * dy + mm[6] * dz
        nldz = mm[8] * dx + mm[9] * dy + mm[10] * dz
        lox = torch.where(is_inst, nlox, lox)
        loy = torch.where(is_inst, nloy, loy)
        loz = torch.where(is_inst, nloz, loz)
        ldx = torch.where(is_inst, nldx, ldx)
        ldy = torch.where(is_inst, nldy, ldy)
        ldz = torch.where(is_inst, nldz, ldz)
        lix = torch.where(is_inst, _rcp(nldx), lix)
        liy = torch.where(is_inst, _rcp(nldy), liy)
        liz = torch.where(is_inst, _rcp(nldz), liz)
        inst = torch.where(is_inst, left.to(torch.int32), inst)
        nxt = torch.where(is_inst, row[:, INST_ROOT].to(torch.int64), nxt)

        # ---- pop when we didn't descend; empty stack ends the ray ----
        descended = int_desc | is_inst
        can_pop = sc > 0
        do_pop = alive & ~descended & can_pop
        popped = stack.gather(
            1, (sc - 1).clamp(0, stack_n - 1).unsqueeze(1)).squeeze(1)
        nxt = torch.where(do_pop, popped, nxt)
        sc = torch.where(do_pop, sc - 1, sc)
        steps = steps + alive.to(torch.int32)
        node = torch.where(alive, nxt, node)
        alive = alive & (descended | can_pop) & (steps < max_steps)
        if occlusion:
            alive = alive & (best_t > 0.0)

    bz = 1.0 - bx - by
    if occlusion:
        occluded = (limit > 0.0) & (best_t < 0.0)
        dist = torch.where(occluded, f32(0.0), large)
        return (Hits(dist, bx, by, bz, torch.zeros_like(tri), binst), steps,
                work)
    # a real hit is strictly inside the clamp; unhit rays still carry
    # their initial t_max and report a miss
    miss = (best_t < 0.0) | (best_t >= limit)
    tri = torch.where(miss, torch.zeros_like(tri), tri)
    if wa.num_tlas == 0 and wa.tri_bits > 0:
        # flattened build: leaf tids are packed (inst << tri_bits) | tri
        binst = tri >> wa.tri_bits
        tri = tri & ((1 << wa.tri_bits) - 1)
    dist = torch.where(miss, large, best_t)
    return Hits(dist, bx, by, bz, tri, binst), steps, work
