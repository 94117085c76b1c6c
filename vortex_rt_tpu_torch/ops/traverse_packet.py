"""8- and 16-wide BVH walk over fused node+leaf rows: the CUDA kernel's
wrapper and its plain PyTorch version (port of
``vortex_rt_tpu/ops/traverse_packet.py::trace_packets`` on the JAX main
path's tables: flat 8-wide builds after ``WideArrays.fuse``, and flat
16-wide ones, ``RTConfig(bvh_width=16)``).

``trace_packets`` is what the frame calls for 8- and 16-wide tables.
The width is the table's: 8-wide rows launch the kernel's 8-wide entry
points, 16-wide rows (40 node words, the meta word at word 38) its
16-wide ones (``vrt_traverse_packet16*``, counted as
``traverse_packet16``, ``traverse_packet16_alpha``,
``traverse_packet16_pred`` and ``traverse_packet16_stats``).  For CUDA
tensors it launches ``csrc/traverse_packet.cu`` (one thread per ray) or
raises; for CPU tensors it runs ``trace_packets_ref``, the plain PyTorch
version of the same per-ray walk.  There is no fallback between the two.
``kernel_call`` is the bare launch, for timing it; ``walk_work`` counts
what a walk computes, for its bound.

Semantics (shared with the JAX ``trace_packets``): ``active`` masks dead
rays (they report a miss), ``t_max`` clamps the search interval,
``occlusion=True`` retires a ray at its first hit inside the clamp
(occluded rays return dist 0.0, the others LARGE_FLOAT), and
``occl_split=k`` runs a mixed wave: rays ``< k`` in occlusion mode, the
rest closest-hit (the merged shadow+bounce wave of the frame loop).
Occlusion lanes report bx = by = 0, tri = inst = 0.

At width 16 a node's children are ordered by Batcher's odd-even merge
network over 16 slots (63 comparators, the JAX ``_SORT_NET[16]``, of
which the port keeps its own copy), and a deferred-children stack entry
is three words: ``left << 4 | count``, sorted slots 0..7 at 4 bits each,
sorted slots 8..14 at 4 bits each.  The stack still holds depth + 4
entries; the kernel keeps at most ``STACK_MAX16`` of them (12 B each).

The JAX loop walked packets of rays over the union of their paths,
near-first by the packet-minimum child distance; both versions here walk
each ray's own path, near-first by the ray's own distance.  That changes
visit order and step counts, not hits: the closest hit is a min-fold
over a ray's own candidates with the lexicographic (t, packed tid)
tie-break, up to exact-t ties that strict ``tmin < best_t`` pruning
resolves by visit order (ROADMAP hazard H3).  The JAX knobs ``packet``,
``fronts``, ``lax_sort``, ``array_stack``, ``unroll`` and ``bf16_slab``
batch XLA's lockstep loop and are not carried.

``stats=True`` also returns each ray's internal steps (``StepKinds``;
no instance steps on flat tables): CUDA tensors launch the kernel's
counting instantiation (counted as ``traverse_packet_stats``), CPU
tensors count in the plain walk (``walk_work``).  ``packet_stats``
reduces a wave's per-ray counts to the JAX ``PacketStats`` counters
(their definitions over the port's walk are in its docstring).

``alpha_ref=thr`` is the JAX in-walk alpha-cutout any-hit over the tables
of ``WideArrays.with_alpha`` (the fused rows then carry each leaf's alpha
fields after its triangle slots): a Moller-Trumbore candidate whose
surface alpha is below ``thr`` is rejected before the fold, in closest,
occlusion and ``occl_split`` modes.  The plain version tests every
candidate; the kernel skips the test of a slot that ``alpha_classes``
finds kept or cut out wherever its triangle is hit, which changes no
hit and no step (``walk_work`` counts both the tests the kernel makes,
``alpha_lookups``, and the candidates, ``alpha_tests``).  CUDA tensors
launch the kernel's
alpha instantiation (counted as ``traverse_packet_alpha``; the walk
without alpha is unchanged).

``anyhit_pred=pred`` is the JAX in-walk stateless any-hit over the same
tables: ``pred(u, v, alpha) -> keep`` (or its
``ops.anyhit_pred.CompiledPredicate``) on every candidate that passes
Moller-Trumbore, before the fold, in the three modes; it wins over
``alpha_ref``, as in the JAX ``trace_packets``.  ``compile_predicate``
turns it into a CUDA device function, its ``sqrt`` and transcendentals
correctly rounded (the float32 rounding of their float64 evaluation),
and raises ``NotImplementedError`` for what it refuses, on any device;
CUDA tensors launch the predicate mode of the library built with it
(``kernels.load_pred``, counted as ``traverse_packet_pred``), which
tests every candidate (no slot classes); the plain version calls the
compiled predicate's plain version (``CompiledPredicate.plain``: the
same float64 evaluations, rounded once) on the candidates' (u, v,
alpha).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from vortex_rt_tpu_torch.ops.packet_walk import (
    ALPHA_SLOT_BYTES, TRI_SLOT_BYTES, StepKinds, WalkWork, _rcp,
    alpha_fields, alpha_keep, anyhit_mode, check_alpha, check_rays,
    pred_keep,
)
from vortex_rt_tpu_torch.ops.traverse2 import Hits
from vortex_rt_tpu_torch.ops.traverse_wide import (
    LEFT_BITS16, WideArrays, left_bits, nchild_mask, row_layout, row_words,
)
from vortex_rt_tpu_torch.runtime import kernels
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT, MT_EPSILON

MAX_STEPS = 400_000
# stack entries the kernel holds, by width (VRT_STACK_MAX and
# VRT_STACK_MAX16 of csrc/traverse_packet.cu: 48 entries of 8 B, 32 of
# 12 B, each 48 KB for a block of 128 threads; the library reports them
# and check_stack refuses a deeper tree before any launch)
STACK_MAX = 48
STACK_MAX16 = 32
WIDTHS = (8, 16)
_F23 = 0x4B000000  # 2**23 as float32 bits
_INT_MAX = 2**31 - 1
_MISS = -LARGE_FLOAT  # sort key of a culled child (descending sort)


def batcher_pairs(n: int) -> tuple:
    """Batcher's odd-even merge sorting network over ``n`` inputs (a
    power of two) as (a, b) comparators in order: 63 at n = 16.  Used
    descending (swap when d[a] < d[b]), as the JAX ``_batcher_pairs``."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


# the JAX body's descending sorting networks over the child slots
# (traverse_packet.py:78-102): swap when d[a] < d[b].  8 slots: 19
# comparators; 16 slots: Batcher's odd-even merge, 63
SORT_NETS = {
    8: ((0, 2), (1, 3), (4, 6), (5, 7), (0, 4), (1, 5), (2, 6), (3, 7),
        (0, 1), (2, 3), (4, 5), (6, 7), (2, 4), (3, 5), (1, 4), (3, 6),
        (1, 2), (3, 4), (5, 6)),
    16: batcher_pairs(16),
}


def stack_max(width: int) -> int:
    """Stack entries the kernel holds at ``width``."""
    return STACK_MAX16 if width == 16 else STACK_MAX


# lanes of a warp: the group over which packet_steps takes its maximum
WARP = 32


class PacketStats(NamedTuple):
    """A wave's walk statistics under the JAX ``PacketStats`` names, each a
    0-dim int64 tensor.  The JAX counters count XLA packets of P rays
    walking in lockstep; the port walks one ray a thread, so each is
    defined over its own walk:

    steps         the wave's longest walk (the max over rays of steps)
    packet_steps  warp-steps: over each group of ``WARP`` consecutive
                  lanes (a warp of the kernel), the group's longest walk,
                  summed (the JAX ``packet_size`` is reported as WARP)
    ray_steps     the sum of the rays' steps (exact; JAX carries f32)
    int_steps     ray-steps at internal nodes
    tri_steps     ray-steps at triangle leaves
    ins_steps     ray-steps at instance nodes

    Summing two waves' stats (spp passes) adds every counter, ``steps``
    too, as the JAX frame adds its slabs' and passes'."""

    steps: torch.Tensor
    packet_steps: torch.Tensor
    ray_steps: torch.Tensor
    int_steps: torch.Tensor
    tri_steps: torch.Tensor
    ins_steps: torch.Tensor

    def __add__(self, other: "PacketStats") -> "PacketStats":
        return PacketStats(*(a + b for a, b in zip(self, other)))


def packet_stats(steps: torch.Tensor, kinds: StepKinds) -> PacketStats:
    """A wave's ``PacketStats`` from its per-ray steps and ``StepKinds``
    (torch reductions on their device; nothing is read to the host)."""
    s = steps.to(torch.int64)
    n_int = kinds.internal.to(torch.int64)
    n_ins = kinds.instance.to(torch.int64)
    pad = (-s.shape[0]) % WARP
    warps = torch.cat([s, s.new_zeros(pad)]).reshape(-1, WARP)
    zero = s.new_zeros(())
    return PacketStats(
        steps=s.max() if s.numel() else zero,
        packet_steps=warps.max(1).values.sum() if s.numel() else zero,
        ray_steps=s.sum(), int_steps=n_int.sum(),
        tri_steps=(s - n_int - n_ins).sum(), ins_steps=n_ins.sum())


def qbyte(w: torch.Tensor, sh: int) -> torch.Tensor:
    """Byte ``sh // 8`` of u32 words ``w`` (int32 or int64) as float32,
    decoded as the kernel decodes it: the byte becomes the low mantissa
    byte of 2**23, and 2**23 is subtracted.  Equal to
    ``((w >> sh) & 255).float()`` for every byte, with no int -> float
    conversion."""
    bits = (((w >> sh) & 255) | _F23).to(torch.int32)
    return bits.view(torch.float32) - 8388608.0


def stack_entries(wa: WideArrays) -> int:
    """Stack entries a walk over ``wa`` needs: one packed deferred-
    children entry per descended level, so depth + 4 cannot overflow
    (the JAX bound, traverse_packet.py:355)."""
    return int(wa.depth) + 4


def check_stack(wa: WideArrays) -> int:
    """``stack_entries(wa)``, or ``ValueError`` where the kernel at the
    table's width holds fewer (ROADMAP H8: a clamped push would lose
    hits): at width 16 a tree deeper than 28 levels."""
    n = stack_entries(wa)
    cap = stack_max(wa.width)
    if n > cap:
        raise ValueError(f"BVH depth {wa.depth} needs {n} stack entries; "
                         f"the {wa.width}-wide kernel is compiled for {cap}")
    return n


def alpha_offset(wa: WideArrays) -> int:
    """Word offset of a fused row's alpha fields: after its triangle
    slots.  Raises unless the fused rows carry them."""
    check_alpha(wa)
    k = wa.tri_rows.shape[1] // 16
    nw = row_words(wa.width)
    if wa.fused is None or wa.fused.shape[1] != nw + 24 * k:
        raise ValueError("alpha_ref and anyhit_pred need fused rows that "
                         "carry the alpha fields (WideArrays.with_alpha on "
                         "a fused table)")
    return nw + 16 * k


# the slot classes of alpha_classes (2 bits a slot of a fused row)
CLS_TEST, CLS_KEPT, CLS_CUT = 0, 1, 2
# the classes' texel boxes: a slot's uv triangle spans at most this many
# texels along an axis (times its largest |uv|), so that the walk's float32
# uv interpolation lands within _CLS_MARGIN of a texel coordinate of the
# triangle's corners (its rounding: about 1e-6 of that span)
_CLS_SPAN = 2048.0
_CLS_MARGIN = 2.0**-8


def alpha_classes(wa: WideArrays, thr: float) -> Optional[torch.Tensor]:
    """(N,) int32 on the table's device (None for rows of more than 16
    slots: every slot is then tested): for each fused row, 2 bits a slot
    (slot c at bits 2c, 2c+1): ``CLS_KEPT`` (1) where every texel the
    slot's triangle can sample keeps its candidate (``!(alpha < thr)``),
    ``CLS_CUT`` (2) where none does, else ``CLS_TEST`` (0).  The texels a
    triangle can sample: the box of its three uv corners' texel
    coordinates, widened by ``_CLS_MARGIN`` texels (the walk's rounding
    stays within it while the span is under ``_CLS_SPAN`` texels) and
    moved into the texture by whole sides (the floored modulo), or the
    texture's whole range along an axis where it wraps there.  A 1x1
    texture (an untextured material) is always kept or always cut.
    Exact: the walk looks up a texel of that box, so a classed slot gives
    the test's answer without it.  Made once per table and threshold
    with torch ops (a few per texture; the textures' table is read to the
    host) and kept with ``wa``, as K6's records are with their arrays:
    the port never edits a table in place, and an edit after the first
    alpha walk would keep stale classes (ROADMAP hazard H17)."""
    kept = wa.__dict__.setdefault("_alpha_classes", {})
    if float(thr) not in kept:
        f = wa.fused
        n, k = f.shape[0], wa.tri_rows.shape[1] // 16
        kept[float(thr)] = (None if k > 16 else _classes(
            f, alpha_offset(wa), n, k, wa.alpha_pool, thr))
    return kept[float(thr)]


def _classes(f, a_off: int, n: int, k: int, pool, thr: float):
    dev = f.device
    words = f[:, a_off:a_off + 8 * k].reshape(n, k, 8)
    uv = words[..., :6].contiguous().view(torch.float32).double()
    toff = words[..., 6].long()
    twh = words[..., 7].long()
    tw = (twh >> 16).clamp_min(1)
    th = (twh & 0xFFFF).clamp_min(1)
    keep = ~(pool < torch.tensor(thr, dtype=torch.float32, device=dev))

    def texels(c, side):
        """The texel range [lo, hi] of corners c (n, k, 3) along an axis
        of ``side`` texels, after the floored modulo (the whole side
        where the range wraps)."""
        lo = torch.floor(c.amin(-1) * side - _CLS_MARGIN)
        hi = torch.floor(c.amax(-1) * side + _CLS_MARGIN)
        fit = (torch.isfinite(c).all(-1)
               & (c.abs().amax(-1) * side <= _CLS_SPAN))
        lo = torch.where(fit, lo, 0.0)
        hi = torch.where(fit, hi, 0.0)
        shift = torch.floor(lo / side) * side
        lo, hi = lo - shift, hi - shift
        fit = fit & (hi <= side - 1)
        return (torch.where(fit, lo, 0).long(),
                torch.where(fit, hi, side - 1).long())

    ulo, uhi = texels(uv[..., 0::2], tw.double())
    vlo, vhi = texels(uv[..., 1::2], th.double())
    # each texture's summed-area table of kept texels, one flat array
    tex, inv = torch.unique(torch.stack([toff, tw, th], -1).reshape(-1, 3),
                            dim=0, return_inverse=True)
    sat, base = [], []
    at = 0
    for t_off, t_w, t_h in tex.tolist():
        base.append(at)
        s2 = torch.zeros((t_h + 1, t_w + 1), dtype=torch.int64, device=dev)
        if 0 <= t_off and t_off + t_w * t_h <= pool.shape[0]:
            m = keep[t_off:t_off + t_w * t_h].reshape(t_h, t_w).long()
            s2[1:, 1:] = m.cumsum(0).cumsum(1)
        sat.append(s2.reshape(-1))
        at += (t_h + 1) * (t_w + 1)
    sat = torch.cat(sat)
    ok_tex = ((tex[:, 0] >= 0)
              & (tex[:, 0] + tex[:, 1] * tex[:, 2] <= pool.shape[0]))
    inv = inv.reshape(n, k)
    b0 = torch.tensor(base, dtype=torch.int64, device=dev)[inv]
    w1 = tw + 1

    def corner(v, u):
        return sat[b0 + v * w1 + u]

    kept = (corner(vhi + 1, uhi + 1) - corner(vlo, uhi + 1)
            - corner(vhi + 1, ulo) + corner(vlo, ulo))
    area = (uhi - ulo + 1) * (vhi - vlo + 1)
    cls = torch.where(kept == area, CLS_KEPT,
                      torch.where(kept == 0, CLS_CUT, CLS_TEST))
    cls = torch.where(ok_tex[inv], cls, CLS_TEST)
    shift = 2 * torch.arange(k, dtype=torch.int64, device=dev)
    packed = (cls << shift).sum(-1)
    return torch.where(packed >= 2**31, packed - 2**32,
                       packed).to(torch.int32)


def _check(wa: WideArrays, o, d, active, t_max, occl_split: int) -> None:
    if wa.width not in WIDTHS or wa.fused is None:
        raise ValueError("trace_packets walks 8- and 16-wide fused tables "
                         "(WideArrays.from_scene(sb, 8 or 16).fuse()); "
                         "4-wide tables go to "
                         "ops.packet_walk.trace_packets_walk")
    if not (wa.num_tlas == 0 and wa.tri_bits > 0):
        raise ValueError(f"{wa.width}-wide fused rows require the flattened "
                         f"build")
    f = wa.fused
    nw = row_words(wa.width)
    lmax = max(int(wa.max_leaf_tris), 1)
    if f.dtype != torch.int32 or f.dim() != 2 \
            or (f.shape[1] - nw) % 8 \
            or f.shape[1] < nw + 16 * lmax \
            or not f.is_contiguous():
        raise ValueError(f"fused must be a contiguous (N, {nw} + 16*k) or "
                         f"(N, {nw} + 24*k) int32 tensor with k >= "
                         f"max_leaf_tris")
    if wa.width == 16 and f.shape[0] >= 1 << LEFT_BITS16:
        raise ValueError(f"a 16-wide pool of {f.shape[0]} nodes exceeds the "
                         f"walk's {LEFT_BITS16}-bit node ids")
    check_rays(f.device, o, d, active, t_max)
    if not 0 <= int(occl_split) <= o.shape[0]:
        raise ValueError(f"occl_split={occl_split} outside [0, {o.shape[0]}]")


def _split(r: int, occlusion: bool, occl_split: int) -> int:
    """Rays [0, split) trace in occlusion mode."""
    return r if occlusion else int(occl_split)


def trace_packets(wa: WideArrays, o: torch.Tensor, d: torch.Tensor,
                  active: Optional[torch.Tensor] = None,
                  t_max: Optional[torch.Tensor] = None,
                  occlusion: bool = False, occl_split: int = 0,
                  max_steps: int = MAX_STEPS,
                  alpha_ref: Optional[float] = None,
                  stats: bool = False, anyhit_pred=None):
    """Closest-hit, occlusion or mixed trace of (R, 3) rays over the
    8- or 16-wide fused table, with the alpha cutout when ``alpha_ref`` is
    given, or the stateless predicate ``anyhit_pred``.  Returns (Hits,
    per-ray step counts (R,) int32), and the rays' ``StepKinds`` third
    with ``stats=True``.

    CUDA tensors launch the hand-written kernel; CPU tensors run the
    plain PyTorch version."""
    alpha_ref, pred = anyhit_mode(alpha_ref, anyhit_pred)
    if o.device.type == "cpu":
        if stats:
            hits, steps, work = walk_work(wa, o, d, active, t_max, occlusion,
                                          occl_split, max_steps, alpha_ref,
                                          pred)
            return hits, steps, StepKinds.from_work(work)
        return trace_packets_ref(wa, o, d, active, t_max, occlusion,
                                 occl_split, max_steps, alpha_ref, pred)
    return kernel_call(wa, o, d, active, t_max, occlusion, occl_split,
                       max_steps, alpha_ref, stats, pred)()


def kernel_call(wa: WideArrays, o: torch.Tensor, d: torch.Tensor,
                active: Optional[torch.Tensor] = None,
                t_max: Optional[torch.Tensor] = None,
                occlusion: bool = False, occl_split: int = 0,
                max_steps: int = MAX_STEPS,
                alpha_ref: Optional[float] = None, stats: bool = False,
                anyhit_pred=None) -> Callable[[], tuple]:
    """The kernel launch of ``trace_packets`` for CUDA tensors, with the
    inputs checked and the outputs allocated once.  Each call of the
    returned function launches the kernel into the same outputs and
    returns them, and does nothing else: CUDA events around many calls
    time the kernel alone.  ``stats=True`` launches the counting
    instantiation, which also returns the ``StepKinds``;
    ``anyhit_pred`` the predicate mode of the library built with it."""
    _check(wa, o, d, active, t_max, occl_split)
    alpha_ref, pred = anyhit_mode(alpha_ref, anyhit_pred)
    if alpha_ref is not None:
        classes = alpha_classes(wa, alpha_ref)
    if pred is not None:
        alpha_offset(wa)
    if o.device.type != "cuda":
        raise ValueError(f"no CUDA walk for device {o.device}")
    stack_n = check_stack(wa)
    lib = (kernels.load("traverse_packet") if pred is None
           else kernels.load_pred("traverse_packet", pred))
    # the entry points of the table's width: vrt_traverse_packet* or
    # vrt_traverse_packet16*
    entry = "traverse_packet" + ("16" if wa.width == 16 else "")
    cap = int(getattr(lib.lib, f"vrt_{entry}_stack_max")())
    if cap != stack_max(wa.width):
        raise RuntimeError(f"{lib.path.name} holds {cap} stack entries at "
                           f"width {wa.width}; ops/traverse_packet.py says "
                           f"{stack_max(wa.width)}")
    r = o.shape[0]
    if r >= 2**31:
        raise ValueError("ray count exceeds the kernel's int32 index")
    if wa.fused.data_ptr() % 16:
        raise ValueError("the kernel reads fused rows as 16-byte vectors: "
                         "the table must be 16-byte aligned")
    dev = o.device
    o = o.contiguous()
    d = d.contiguous()
    limit = (torch.full((r,), LARGE_FLOAT, dtype=torch.float32, device=dev)
             if t_max is None else t_max.contiguous())
    on = (torch.ones(r, dtype=torch.bool, device=dev) if active is None
          else active.contiguous())
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    dist, bx, by, bz = (torch.empty(r, **f32) for _ in range(4))
    tri, inst, steps = (torch.empty(r, **i32) for _ in range(3))
    # (flat tables hold no instance nodes: the instance count stays 0)
    kinds = (StepKinds(torch.empty(r, **i32), torch.zeros(r, **i32))
             if stats else None)
    split = _split(r, occlusion, occl_split)
    # the closure holds the tensors (not only their addresses), so the
    # inputs made here live as long as the launcher
    tensors = (wa.fused, o, d, limit, on, dist, bx, by, bz, tri, inst, steps)
    sizes = (r, wa.fused.shape[0], wa.fused.shape[1],
             max(int(wa.max_leaf_tris), 1), int(wa.tri_bits), stack_n,
             int(max_steps), split)
    mode = ("pred" if pred is not None else
            "alpha" if alpha_ref is not None else "")
    name = (f"{entry}_stats" if stats else
            f"{entry}_{mode}" if mode else entry)

    def launch() -> tuple:
        ptrs = [t.data_ptr() for t in tensors]
        alpha_sizes = ()
        if mode:
            ptrs.append(wa.alpha_pool.data_ptr())
            alpha_sizes = (wa.alpha_pool.shape[0], wa.tri_rows.shape[1] // 16)
        if mode == "alpha":
            ptrs.append(0 if classes is None else classes.data_ptr())
            alpha_sizes += (float(alpha_ref),)
        if stats:
            ptrs.append(kinds.internal.data_ptr())
        fn = getattr(lib.lib, f"vrt_{entry}"
                     + (f"_{mode}" if mode else "")
                     + ("_stats" if stats else ""))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*ptrs, *sizes, *alpha_sizes, stream)
        if err != 0:
            raise RuntimeError(f"traverse_packet launch failed: "
                               f"{lib.error_string(err)} ({err})")
        if r > 0:
            kernels.LAUNCHES[name] += 1
        if stats:
            return Hits(dist, bx, by, bz, tri, inst), steps, kinds
        return Hits(dist, bx, by, bz, tri, inst), steps

    return launch


def trace_packets_ref(wa: WideArrays, o: torch.Tensor, d: torch.Tensor,
                      active: Optional[torch.Tensor] = None,
                      t_max: Optional[torch.Tensor] = None,
                      occlusion: bool = False, occl_split: int = 0,
                      max_steps: int = MAX_STEPS,
                      alpha_ref: Optional[float] = None,
                      anyhit_pred=None) -> Tuple[Hits, torch.Tensor]:
    """Plain PyTorch version of the per-ray 8- or 16-wide walk, on any
    device.

    All rays step together: each step gathers every live ray's fused row,
    evaluates the internal and leaf paths with masks, and keeps per-ray
    stacks of packed deferred-children entries in two (R, S) tensors
    (three at width 16).
    The same sorting network, stack words, byte decode and arithmetic
    order as the kernel, so both give the same hits and the same per-ray
    step counts to the bit."""
    hits, steps, _ = _walk_ref(wa, o, d, active, t_max, occlusion,
                               occl_split, max_steps, False, alpha_ref,
                               anyhit_pred)
    return hits, steps


def walk_work(wa: WideArrays, o: torch.Tensor, d: torch.Tensor,
              active: Optional[torch.Tensor] = None,
              t_max: Optional[torch.Tensor] = None,
              occlusion: bool = False, occl_split: int = 0,
              max_steps: int = MAX_STEPS,
              alpha_ref: Optional[float] = None, anyhit_pred=None
              ) -> Tuple[Hits, torch.Tensor, WalkWork]:
    """The plain walk of these rays, with what it computes per ray:
    (Hits, steps, WalkWork of internal steps and their child slots, leaf
    steps and their triangle slots, the alpha or predicate tests the
    kernel makes and the candidates that passed Moller-Trumbore).
    ``tools/walk_bounds.py`` turns the work into a bound.  In alpha or
    predicate mode the rows are the fused rows, then the alpha pool's
    entries."""
    return _walk_ref(wa, o, d, active, t_max, occlusion, occl_split,
                     max_steps, True, alpha_ref, anyhit_pred)


def _walk_ref(wa: WideArrays, o, d, active, t_max, occlusion: bool,
              occl_split: int, max_steps: int, count: bool,
              alpha_ref: Optional[float] = None, anyhit_pred=None):
    """(Hits, steps, WalkWork or None) of the plain walk."""
    _check(wa, o, d, active, t_max, occl_split)
    alpha_ref, pred = anyhit_mode(alpha_ref, anyhit_pred)
    # alpha: the surface of every candidate is read (either mode)
    alpha = alpha_ref is not None or pred is not None
    a_off = alpha_offset(wa) if alpha else 0
    # the kernel's classes (alpha mode), for its count of tests only: the
    # hits come from testing every candidate
    classes = (alpha_classes(wa, alpha_ref)
               if alpha_ref is not None and count else None)
    dev = o.device
    r = o.shape[0]
    occ = torch.arange(r, device=dev) < _split(r, occlusion, occl_split)
    limit = (torch.full((r,), LARGE_FLOAT, dtype=torch.float32, device=dev)
             if t_max is None else t_max)
    on = (torch.ones(r, dtype=torch.bool, device=dev) if active is None
          else active)
    fused = wa.fused
    n_nodes = fused.shape[0]
    lmax = max(int(wa.max_leaf_tris), 1)
    stack_n = stack_entries(wa)
    eps = MT_EPSILON
    width = int(wa.width)
    q_lo, q_hi, m_off, l_off, base = row_layout(width)
    nw = row_words(width)
    lb, n_mask = left_bits(width), nchild_mask(width)
    wide16 = width == 16

    def f32(v):
        return torch.full((r,), v, dtype=torch.float32, device=dev)

    large = f32(LARGE_FLOAT)
    miss_key = f32(_MISS)
    ox, oy, oz = (o[:, k].contiguous() for k in range(3))
    dx, dy, dz = (d[:, k].contiguous() for k in range(3))
    ivx, ivy, ivz = _rcp(dx), _rcp(dy), _rcp(dz)
    # dead lanes carry best_t = -LARGE_FLOAT and never walk; a live ray
    # with a clamp <= 0 cannot find a hit (t > eps) either
    best_t = torch.where(on, limit, -large)
    bx, by = f32(0.0), f32(0.0)
    tri = torch.zeros(r, dtype=torch.int64, device=dev)
    node = torch.zeros(r, dtype=torch.int64, device=dev)
    sc = torch.zeros(r, dtype=torch.int64, device=dev)
    steps = torch.zeros(r, dtype=torch.int32, device=dev)
    st0 = torch.zeros((r, stack_n), dtype=torch.int64, device=dev)
    st1 = torch.zeros((r, stack_n), dtype=torch.int64, device=dev)
    # width 16: sorted slots 8..14 in a third word
    st2 = (torch.zeros((r, stack_n), dtype=torch.int64, device=dev)
           if wide16 else None)
    alive = best_t > 0.0
    work = (WalkWork.zeros(r, n_nodes + (wa.alpha_pool.shape[0] if alpha
                                         else 0), dev) if count else None)

    while bool(alive.any()):
        node_c = node.clamp(0, n_nodes - 1)
        raw = fused[node_c]
        row_f = raw.view(torch.float32)
        row = raw.to(torch.int64) & 0xFFFFFFFF  # the u32 words
        meta = row[:, m_off]
        kind = meta >> 29
        nch = (meta >> lb) & n_mask
        left = meta & ((1 << lb) - 1)
        leaf_n = raw[:, l_off].to(torch.int64)
        is_int = alive & (kind == 0)
        is_tri = alive & (kind == 1)

        # ---- internal: 8 or 16 slab tests, far->near network, push the
        # deferred children.  (R,) tensors a child, as the kernel's
        # thread computes them: small CPU waves then run each op on one
        # thread, which keeps the CPU tests' worker processes apart ----
        gx, gy, gz = row_f[:, 0], row_f[:, 1], row_f[:, 2]
        sx, sy, sz = row_f[:, 3], row_f[:, 4], row_f[:, 5]
        ds, ix = [], []
        for c in range(width):
            ql = row[:, q_lo + c]
            qh = row[:, q_hi + c]
            lx = gx + qbyte(ql, 0) * sx
            ly = gy + qbyte(ql, 8) * sy
            lz = gz + qbyte(ql, 16) * sz
            hx = gx + qbyte(qh, 0) * sx
            hy = gy + qbyte(qh, 8) * sy
            hz = gz + qbyte(qh, 16) * sz
            t1x = (lx - ox) * ivx
            t2x = (hx - ox) * ivx
            t1y = (ly - oy) * ivy
            t2y = (hy - oy) * ivy
            t1z = (lz - oz) * ivz
            t2z = (hz - oz) * ivz
            tmin = torch.maximum(torch.maximum(
                torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
                torch.minimum(t1z, t2z))
            tmax = torch.minimum(torch.minimum(
                torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
                torch.maximum(t1z, t2z))
            hit = (tmax >= tmin) & (tmax > 0.0) & (tmin < best_t) & (c < nch)
            ds.append(torch.where(hit, tmin, miss_key))
            ix.append(torch.full((r,), c, dtype=torch.int64, device=dev))
        for a, b in SORT_NETS[width]:
            swap = ds[a] < ds[b]
            ds[a], ds[b] = (torch.where(swap, ds[b], ds[a]),
                            torch.where(swap, ds[a], ds[b]))
            ix[a], ix[b] = (torch.where(swap, ix[b], ix[a]),
                            torch.where(swap, ix[a], ix[b]))
        m = sum((dc > _MISS).to(torch.int64) for dc in ds)
        descend = is_int & (m >= 1)
        child = torch.stack(ix, 1).gather(
            1, (m - 1).clamp(0, width - 1).unsqueeze(1)).squeeze(1)
        cnt_def = (m - 1).clamp(0, width - 1)
        word0 = (left << 4) | cnt_def
        if wide16:  # slots 0..7 and 8..14, 4 bits each
            word1 = ix[0] & 15
            for j in range(1, 8):
                word1 = word1 | ((ix[j] & 15) << (4 * j))
            word2 = ix[8] & 15
            for j in range(9, 15):
                word2 = word2 | ((ix[j] & 15) << (4 * (j - 8)))
        else:  # slots 0..6, 3 bits each
            word1 = ix[0] & 7
            for j in range(1, 7):
                word1 = word1 | ((ix[j] & 7) << (3 * j))
        push = descend & (cnt_def >= 1)
        slot = sc.clamp(max=stack_n - 1).unsqueeze(1)
        for st, word in ((st0, word0), (st1, word1)) + (
                ((st2, word2),) if wide16 else ()):
            st.scatter_(1, slot, torch.where(
                push, word, st.gather(1, slot).squeeze(1)).unsqueeze(1))
        sc = sc + push.to(torch.int64)
        nxt = torch.where(descend, left + child, node)

        # ---- triangle leaf: up to lmax Moller-Trumbore tests over the
        # row's own slots, folded to the leaf's best, then into the ray's
        tr = row_f[:, nw:]
        tr_i = raw[:, nw:].to(torch.int64)
        ar = row_f[:, a_off:] if alpha else None
        cls_w = (None if classes is None
                 else classes[node_c].to(torch.int64) & 0xFFFFFFFF)
        n_alpha = torch.zeros(r, dtype=torch.int64, device=dev)
        n_looked = torch.zeros(r, dtype=torch.int64, device=dev)
        t_min, tid_sel = large, torch.full((r,), _INT_MAX, dtype=torch.int64,
                                           device=dev)
        w1_sel, w2_sel = f32(0.0), f32(0.0)
        for c in range(lmax):
            b0 = 16 * c
            v0x, v0y, v0z = tr[:, b0 + 0], tr[:, b0 + 1], tr[:, b0 + 2]
            e1x, e1y, e1z = tr[:, b0 + 3], tr[:, b0 + 4], tr[:, b0 + 5]
            e2x, e2y, e2z = tr[:, b0 + 6], tr[:, b0 + 7], tr[:, b0 + 8]
            tid = tr_i[:, b0 + 9]
            hx_ = dy * e2z - dz * e2y
            hy_ = dz * e2x - dx * e2z
            hz_ = dx * e2y - dy * e2x
            a = e1x * hx_ + e1y * hy_ + e1z * hz_
            small = a.abs() < eps
            fba = 1.0 / torch.where(small, torch.ones_like(a), a)
            sx_ = ox - v0x
            sy_ = oy - v0y
            sz_ = oz - v0z
            w1 = fba * (sx_ * hx_ + sy_ * hy_ + sz_ * hz_)
            qx = sy_ * e1z - sz_ * e1y
            qy = sz_ * e1x - sx_ * e1z
            qz = sx_ * e1y - sy_ * e1x
            w2 = fba * (dx * qx + dy * qy + dz * qz)
            t = fba * (e2x * qx + e2y * qy + e2z * qz)
            ok = (~small & (w1 >= 0.0) & (w1 <= 1.0) & (w2 >= 0.0)
                  & (w1 + w2 <= 1.0) & (t > eps) & (c < leaf_n))
            if alpha:
                keep, idx = (alpha_keep(alpha_fields(ar, c), w1, w2,
                                        wa.alpha_pool, alpha_ref)
                             if pred is None else
                             pred_keep(pred, alpha_fields(ar, c), w1, w2,
                                       wa.alpha_pool, ok & is_tri))
                if count:
                    # the kernel looks up the candidates of the slots its
                    # classes leave to the test (every slot, without them)
                    tested = ok & is_tri
                    n_alpha += tested.to(torch.int64)
                    looked = tested if cls_w is None else (
                        tested & (((cls_w >> (2 * c)) & 3) == CLS_TEST))
                    n_looked += looked.to(torch.int64)
                    work.read(n_nodes + idx, torch.full_like(idx, 4), looked)
                ok = ok & keep
            t = torch.where(ok, t, large)
            better = (t < t_min) | ((t == t_min) & (t < LARGE_FLOAT)
                                    & (tid < tid_sel))
            t_min = torch.where(better, t, t_min)
            tid_sel = torch.where(better, tid, tid_sel)
            w1_sel = torch.where(better, w1, w1_sel)
            w2_sel = torch.where(better, w2, w2_sel)
        occ_hit = is_tri & occ & (t_min < best_t)
        upd = is_tri & ~occ & (
            (t_min < best_t) | ((t_min == best_t) & (t_min < LARGE_FLOAT)
                                & (tid_sel < tri)))
        best_t = torch.where(upd, t_min, best_t)
        best_t = torch.where(occ_hit, -large, best_t)
        bx = torch.where(upd, w1_sel, bx)
        by = torch.where(upd, w2_sel, by)
        tri = torch.where(upd, tid_sel, tri)
        if count:
            slots = leaf_n.clamp(0, lmax)
            work.add(is_int, nch, is_tri, slots)
            # the kernel's reads: the row's meta quarter (the last two
            # child boxes, meta, leaf_n: words 20..23, or 36..39 at width
            # 16) at every step, the words before it (the other boxes) at
            # an internal node (96 B in all, or 160 B), the triangle slots
            # at a leaf and in alpha mode the row's slot classes (4 B) and
            # the alpha fields of each candidate the kernel tests
            work.read(node_c, torch.where(is_int, 4 * base, torch.where(
                is_tri, 16 + TRI_SLOT_BYTES * slots
                + ALPHA_SLOT_BYTES * n_looked
                + (4 if alpha_ref is not None else 0), 16)),
                alive)
            work.alpha_tests.add_(n_alpha)
            work.alpha_lookups.add_(n_looked)

        # ---- pop when we didn't descend; an empty stack ends the ray ----
        can_pop = sc > 0
        do_pop = alive & ~descend & can_pop
        top_at = (sc - 1).clamp(0, stack_n - 1).unsqueeze(1)
        top = st0.gather(1, top_at).squeeze(1)
        c_top = top & 15
        j = (c_top - 1).clamp(min=0)
        top1 = st1.gather(1, top_at).squeeze(1)
        if wide16:
            top2 = st2.gather(1, top_at).squeeze(1)
            slot_id = torch.where(j < 8, (top1 >> (4 * j.clamp(max=7))) & 15,
                                  (top2 >> (4 * (j - 8).clamp(min=0))) & 15)
        else:
            slot_id = (top1 >> (3 * j)) & 7
        partial = do_pop & (c_top > 1)
        st0.scatter_(1, top_at, torch.where(partial, top - 1, top)
                     .unsqueeze(1))
        sc = torch.where(do_pop & (c_top <= 1), sc - 1, sc)
        nxt = torch.where(do_pop, (top >> 4) + slot_id, nxt)
        steps = steps + alive.to(torch.int32)
        node = torch.where(alive, nxt, node)
        alive = (alive & (descend | can_pop) & (steps < max_steps)
                 & (~occ | (best_t > 0.0)))

    zero = f32(0.0)
    d_occ = torch.where(on & (best_t < 0.0), zero, large)
    d_clo = torch.where((best_t < 0.0) | (best_t >= limit), large, best_t)
    dist = torch.where(occ, d_occ, d_clo)
    tri32 = tri.to(torch.int32)
    tri_out = tri32 & ((1 << wa.tri_bits) - 1)
    inst_out = tri32 >> wa.tri_bits
    return Hits(dist, bx, by, 1.0 - bx - by, tri_out, inst_out), steps, work
