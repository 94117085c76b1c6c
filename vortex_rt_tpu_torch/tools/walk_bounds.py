"""The least time one H100 could take for a walk or for a step of the
on-device LBVH build (its roofline bound).

A bound is the larger of two times: the bytes the function must move
(each input read once, each output written once) over the card's memory
rate, and the FP32 operations it does on these inputs over the card's
FP32 rate (NVIDIA's data sheet, H100 SXM: 3.35 TB/s of HBM3, 67 TFLOP/s
FP32 outside the tensor cores; at the full 700 W power limit).  The
walks' work depends on the data, so the operations are counted from
what the plain version does on these rays (``WalkWork``), not from the
most they could need:

- a child slot of an internal step, ``OPS_PER_CHILD`` = 37: 6 FMUL and
  6 FADD for the corners g + q*s, 6 FSUB and 6 FMUL for the slab
  distances, 6 min/max of the pairs, 4 min/max folds, 3 comparisons;
- the child sort of an internal step: one comparison per comparator,
  ``OPS_SORT8`` = 19 (K1), ``OPS_SORT16`` = 63 (K1 at width 16: Batcher's
  odd-even merge), ``OPS_SORT4`` = 5 (K2);
- a triangle slot of a leaf step, ``OPS_PER_TRI`` = 53 (Moller-Trumbore
  in the kernels' op order: 9 for h, 5 for a, 1 test and 1 reciprocal,
  3 for s, 6 for u, 9 for q, 6 for v, 6 for t, 6 for the five tests,
  1 for the fold);
- an instance step (K2's and K3's TLAS builds), ``OPS_PER_INSTANCE`` =
  36: the 4x3 transform of o (18) and d (15) and three reciprocals;
- an alpha test (K1's and K2's alpha mode, per candidate tested: in K1
  each candidate of a slot that is not kept or cut out wherever its
  triangle is hit (its classes; ``WalkWork.alpha_lookups``); in K2, and
  in the first figure of K1 (``k1_bound(lookups=False)``), every
  candidate that passed Moller-Trumbore), ``OPS_PER_ALPHA`` = 17: 2 for bz, 5 each
  for u and v, 2 products by the texture's sides, 2 floors, 1
  comparison;
- a predicate test (K1's and K2's predicate mode: since PR 21 the
  candidates of slots their classes leave to the test,
  ``WalkWork.alpha_lookups``, ``OPS_UV`` = 12 for bz, u and v, and
  ``OPS_TEXEL`` = 5 more for each that reads a texel,
  ``WalkWork.texel_reads``; in the first figure, ``lookups=False``,
  every candidate that passed Moller-Trumbore at ``OPS_PER_ALPHA``),
  and the compiled predicate's own operations a test
  (``pred_ops(compiled)``, the ``pred_ops``
  of ``k1_bound`` and ``k2_bound``): one a node of its graph, and for a
  correctly rounded op (``sqrt``, the transcendentals, ``pow`` on
  floats: float64 library sequences) its weight in ``PRED_OP_WEIGHTS``,
  the instructions of its sequence's common path with each FP64
  arithmetic instruction counted twice (they issue at half the FP32
  rate), read from the SASS ``tools/pred_op_sass.py`` prints.

Bytes: per walking ray o and d (24 B), t_max (4 B) and the active flag
(1 B) in; a ray that takes no step (inactive, or t_max <= 0) needs only
its flag and t_max (5 B); every ray writes dist, bx, by, bz, tri, inst
and steps (28 B); of the tables, each row that some ray visits is read
once, and only the words the walk uses of it (``WalkWork.row_bytes``:
K1 96 B of an internal row (160 B at width 16: the 40 node words), 16 B
of a leaf row's meta and 40 B per triangle slot; K2 64 B of an internal node, 16 B of a leaf node, 80 B
of an instance node, 40 B per triangle slot; in alpha mode 32 B of
alpha fields per slot whose candidate is tested and 4 B per alpha-pool
entry read, and in K1's alpha mode 4 B of slot classes per leaf step;
the predicate modes 4 B of classes per leaf step, 32 B of fields a test
and 4 B a texel read; the first figure 36 B every candidate).  A wave in
which no ray walks reads none of the tables.

K3 (``k3_bound``), per launch, given the walk's state before and after
it: a ray done or suspended at entry reads its two flags (2 B); a ray
that steps reads its world ray (24 B) and the fields the walk reads
(``K3_READ_WORDS`` = 29 words: node, level, the 8 trail words, the 5
stack entries and their count, the instance, the 9 floats of the local
ray, best_t, nodes_visited, tri_tests; then the best hit's 2 ids without
suspension or the barrier's 3 words with it; and the 2 flags), and
writes the fields whose bits the walk changed; of the tables, each row a
ray visits is read once, and only the words K3 uses of it
(``lanes_work``, K2's convention: 16 B of meta at every step, then 48 B
of child boxes at an internal node or 64 B of transform and BLAS root at
an instance node, and 40 B per triangle slot of a leaf's row).  Without
the states, the first version's figure: every ray reads its world ray
and its whole state and writes the state back (``STATE_BYTES`` = 166 B
each way: 41 words and the 2 flags), walking or not.

K6 (``k6_bound``), the binary TLAS+BLAS walk over float boxes: a child
box test costs ``OPS_PER_BOX`` = 25 (6 FSUB and 6 FMUL for the slab
distances, 6 min/max of the pairs, 4 min/max folds, 3 comparisons), an
internal step adds one comparison for the near child, a triangle slot
``OPS_PER_TRI`` + 6 (the two edges from the vertices), an instance step
``OPS_PER_INSTANCE``.  Bytes: a walking ray's o and d (24 B) in, every
ray's active flag (1 B) in and its record (dist, bx, by, bz, tri, inst,
nodes_visited, tri_tests: 32 B) out; of the tables, each entry some ray
reads once (``ops/traverse2.rays_work``: 12 B of a visited node's kind,
left and count, 24 B of a child's box, 4 B of a leaf slot's triangle id,
36 B of a tested triangle's vertices, 52 B of an entered instance's 3x4
inverse transform and BLAS root).

The sweep-SAH tree (``sah_bounds``) runs ``levels`` levels over ``l``
positions.  Its least work a level, for each position in a range longer
than one (``live``, the plain version's count at the start of each
level): its leaf box read (24 B; the range state of a position can stay
on chip), and ``OPS_SAH`` = 41 operations (6 min/max for each of the two
box scans, 11 for each half area, 3 for the cost, 4 comparisons for the
middle-half window); the tree (lchild, rchild, lo, hi: 16 B an internal)
written once.  Without ``live``, the first version's figure: every
position at every level, its box and range state (seg_lo, seg_hi, node:
12 B) read and the state written back (``SAH_BYTES_EVERY`` = 48 B).

The LBVH and PLOC kernels (``lbvh_bounds``, ``ploc_bounds``) do integer
and min/max work (the PLOC window costs: 11 FP32 operations per pair,
under 2% of the bytes time), a
few operations per word moved, so their bound is their bytes: every
input array of the function read once and every output array written
once, at the sizes the call is given (T triangles, the pool and leaf rows
of the tables it writes).  Arrays that one kernel of a function writes
for the next and scratch arrays (the collapse's, the scene box's parts)
are not inputs or outputs, so they are not counted.
"""

from __future__ import annotations

import dataclasses

H100_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12

OPS_PER_CHILD = 37
OPS_SORT8 = 19
OPS_SORT16 = 63
OPS_SORT4 = 5
OPS_PER_TRI = 53
OPS_PER_INSTANCE = 36
OPS_PER_ALPHA = 17
OPS_UV = 12
OPS_TEXEL = OPS_PER_ALPHA - OPS_UV
# the correctly rounded ops' weights in FP32 operations: ``weight`` of
# ``python -m vortex_rt_tpu_torch.tools.pred_op_sass`` (nvcc 12.9 for
# sm_90a with the kernels' flags; run on an NVIDIA H100 80GB HBM3 at
# 700.00 W): each sequence's common path, FP64 arithmetic counted twice
PRED_OP_WEIGHTS = {
    "sqrt": 13, "rsqrt": 53, "sin": 70, "cos": 71, "tan": 123, "asin": 161,
    "acos": 179, "atan": 110, "sinh": 163, "cosh": 83, "tanh": 137,
    "asinh": 377, "acosh": 340, "atanh": 233, "exp": 80, "exp2": 82,
    "expm1": 95, "log": 116, "log2": 124, "log10": 124, "log1p": 194,
    "sigmoid": 106, "erf": 166, "erfc": 233, "atan2": 173, "hypot": 63,
    "pow": 341,
}
RAY_IN_BYTES = 29
IDLE_RAY_IN_BYTES = 5
HIT_OUT_BYTES = 28
WORLD_RAY_BYTES = 24
STATE_BYTES = 41 * 4 + 2
OPS_PER_BOX = 25
K6_OUT_BYTES = 32
OPS_SAH = 41
SAH_BOX_BYTES = 24
SAH_BYTES_EVERY = 48
FLAG_BYTES = 2
K3_READ_WORDS = 29


@dataclasses.dataclass(frozen=True)
class Bound:
    ops: int
    bytes: int

    @property
    def ops_ms(self) -> float:
        return self.ops / H100_FP32_OPS_PER_S * 1e3

    @property
    def bytes_ms(self) -> float:
        return self.bytes / H100_BYTES_PER_S * 1e3

    @property
    def ms(self) -> float:
        return max(self.ops_ms, self.bytes_ms)

    @property
    def bound_by(self) -> str:
        return "operations" if self.ops_ms >= self.bytes_ms else "bytes"


def pred_ops(compiled) -> int:
    """The operations of one test of a compiled predicate
    (``ops.anyhit_pred.CompiledPredicate``): one per node of its graph,
    ``PRED_OP_WEIGHTS`` for each correctly rounded one."""
    return sum(PRED_OP_WEIGHTS.get(kind, 1) for kind in compiled.ops)


def walk_ops(work, sort_ops: int, lookups: bool = False,
             pred_ops: int = 0) -> int:
    """FP32 operations of a walk from its per-ray ``WalkWork``: the alpha
    tests the kernel makes (``work.alpha_lookups``) or every candidate's
    (``work.alpha_tests``), each with ``pred_ops`` more operations in
    predicate mode."""
    if lookups:  # the uv of each test, the texel of those that read one
        tests = ((OPS_UV + pred_ops) * work.alpha_lookups.sum()
                 + OPS_TEXEL * work.texel_reads.sum())
    else:
        tests = (OPS_PER_ALPHA + pred_ops) * work.alpha_tests.sum()
    return int(OPS_PER_CHILD * work.child_slots.sum()
               + sort_ops * work.internal.sum()
               + OPS_PER_TRI * work.tri_slots.sum()
               + OPS_PER_INSTANCE * work.instance.sum() + tests)


def walk_bound(work, sort_ops: int, lookups: bool = False,
               pred_ops: int = 0) -> Bound:
    """Bound of a walk of ``len(work.internal)`` rays from its
    ``WalkWork``."""
    r = int(work.internal.numel())
    walking = int(((work.internal + work.leaf + work.instance) > 0).sum())
    return Bound(ops=walk_ops(work, sort_ops, lookups, pred_ops),
                 bytes=(walking * RAY_IN_BYTES
                        + (r - walking) * IDLE_RAY_IN_BYTES
                        + r * HIT_OUT_BYTES + int(work.row_bytes.sum())))


def k1_bound(work, lookups: bool = True, pred_ops: int = 0,
             width: int = 8) -> Bound:
    """K1: the 8-wide (or ``width``-wide: 16) walk over the fused table;
    in alpha and predicate mode the tests it makes (``lookups=False``:
    every candidate's, the first figure), in predicate mode each with the
    predicate's ``pred_ops``.  The rows' bytes are in ``work``
    (``ops/traverse_packet.walk_work`` of a table of that width; its
    bytes are the tests the classes leave in either figure)."""
    return walk_bound(work, OPS_SORT16 if width == 16 else OPS_SORT8,
                      lookups, pred_ops)


def k2_bound(work, pred_ops: int = 0, lookups: bool = False) -> Bound:
    """K2: the 4-wide walk over the node and triangle rows (in predicate
    mode with the predicate's ``pred_ops`` a test: the tests its classes
    leave with ``lookups=True``, every candidate's without, the first
    figure)."""
    return walk_bound(work, OPS_SORT4, lookups, pred_ops=pred_ops)


def k3_bound(work, before=None, after=None, suspend: bool = False
             ) -> Bound:
    """K3: one launch of the per-ray walk over the 4-wide tables, from
    the ``WalkWork`` of ``ops/traverse_wide.lanes_work`` and the
    ``WideState`` before and after it (``suspend``: the launch's mode);
    without the states, the first version's figure."""
    import torch

    r = int(work.internal.numel())
    if before is None:
        lanes = r * (WORLD_RAY_BYTES + 2 * STATE_BYTES)
    else:
        walking = (work.internal + work.leaf + work.instance) > 0
        n = int(walking.sum())
        read = 4 * (K3_READ_WORDS + (3 if suspend else 2)) + FLAG_BYTES
        written = 0
        for a, b in zip(before, after):
            if a.dtype == torch.float32:   # bits, not values
                a, b = a.view(torch.int32), b.view(torch.int32)
            written += int(((a != b) & walking).sum()) * a.element_size()
        lanes = (r - n) * FLAG_BYTES + n * (WORLD_RAY_BYTES + read) + written
    return Bound(ops=walk_ops(work, OPS_SORT4),
                 bytes=lanes + int(work.row_bytes.sum()))


def k6_bound(work) -> Bound:
    """K6: the binary TLAS+BLAS walk, from the ``WalkWork`` of
    ``ops/traverse2.rays_work``."""
    r = int(work.internal.numel())
    walking = int(((work.internal + work.leaf + work.instance) > 0).sum())
    ops = int(OPS_PER_BOX * work.child_slots.sum() + work.internal.sum()
              + (OPS_PER_TRI + 6) * work.tri_slots.sum()
              + OPS_PER_INSTANCE * work.instance.sum())
    return Bound(ops=ops, bytes=walking * WORLD_RAY_BYTES
                 + r * (1 + K6_OUT_BYTES) + int(work.row_bytes.sum()))


def k6_record_bytes(work, n_pool: int, n_slots: int) -> int:
    """The bytes K6's packed records (``ops/traverse2.pack_walk_tables``)
    make a walk fetch, from the same ``rays_work``: each visited node's
    64-B record and each tested slot's 48-B record once, a walking ray's
    o and d, every ray's flag and record."""
    rows = work.row_bytes
    r = int(work.internal.numel())
    walking = int(((work.internal + work.leaf + work.instance) > 0).sum())
    return int(64 * (rows[:n_pool] > 0).sum()
               + 48 * (rows[2 * n_pool:2 * n_pool + n_slots] > 0).sum()
               + walking * WORLD_RAY_BYTES + r * (1 + K6_OUT_BYTES))


def sah_bounds(l: int, levels: int, live=None) -> Bound:
    """Bound of the sweep-SAH tree over ``l`` leaf boxes in ``levels``
    levels; ``live`` the positions in ranges longer than one at the start
    of each level (``_sah_sweep_tree_ref(..., live=[])``), or None for
    the first version's figure."""
    if live is None:
        n = l * levels
        return Bound(ops=OPS_SAH * n, bytes=SAH_BYTES_EVERY * n + 16 * (l - 1))
    n = sum(int(x) for x in live[:levels])
    return Bound(ops=OPS_SAH * n, bytes=SAH_BOX_BYTES * n + 16 * (l - 1))


def k7_bound(rows: int, steps: int, k: int, words: int) -> Bound:
    """K7: ``steps`` dependent fetches of ``words`` words by each of ``k``
    walks (at most every row once) and one int32 out; integer work only.
    The probe measures dependent-fetch latency, so this is not its
    target."""
    fetched = min(steps * k, rows) * words * 4
    return Bound(ops=0, bytes=fetched + 4)


def lbvh_bounds(t: int, width: int, leaf: int, pool_rows: int,
                leaf_rows: int, surv_rows: int, fused: bool,
                tile: int) -> dict:
    """Bounds of the four LBVH kernels for ``t`` (padded) triangles, by
    kernel library name.  ``pool_rows`` and ``leaf_rows`` size the tables
    the pack writes, ``surv_rows`` is the length of the survivor list it
    runs over (``t - 1`` without a compact plan); ``tile`` is the refit's
    (its plan's blocks take the treelets of ``tile // 2`` leaves)."""
    n = 2 * t - 1
    i = t - 1
    karras = (36 * t + 24 + 4 * t          # box, codes: vertices in; box, codes out
              + 4 * t + 16 * i)            # karras: codes in; 4 arrays out
    # lchild, rchild, lo, hi in; surv (1 B), ch_old, arity, base (l-1,),
    # newid, parent (2l-1,), row_lo, row_cnt, leaf_newid (l,) and the
    # leaf-row count (8 B) out; the refit plan out: rec (l-1, 2), blocks
    # (ceil(l / (tile / 2)), 4), roots (l, 2), gstart and the climb's
    # counters (l-1,).  The launch's scratch is not counted
    collapse = (16 * i + i + 4 * width * i + 8 * i + 8 * n + 12 * t + 8
                + 8 * i + 16 * -(-t // (tile // 2)) + 8 * t + 8 * i)
    # vertices, order, lchild, rchild in; bmin, bmax (2l-1, 3) out.  The
    # parent array and the arrival counters of the climb are not counted
    refit = 36 * t + 4 * t + 8 * i + 24 * n
    row_words = 32 + 16 * leaf
    pack = (4 * surv_rows + (13 + 4 * width) * surv_rows  # survivors in
            + 24 * min(n, pool_rows)                      # child boxes in
            + 12 * leaf_rows + 4 * t + 36 * t             # rows, order, verts
            + 128 * pool_rows + 64 * leaf * leaf_rows     # nodes, tri_rows out
            + (4 * row_words * pool_rows if fused else 0))
    return {"lbvh_karras": Bound(0, karras), "lbvh_collapse": Bound(0, collapse),
            "lbvh_refit": Bound(0, refit), "lbvh_pack": Bound(0, pack)}


def ploc_bounds(t: int, width: int, leaf: int, live) -> dict:
    """Bounds of the K4 functions for ``t`` (padded) triangles: the merge
    loop (``ploc_merge``), the remap and collapse (``ploc_collapse``),
    the refit's boxes with the climb (``ploc_refit``), the build's leaf
    row boxes (``ploc_refit_rows``) and the pack from explicit leaf ids
    (``ploc_pack``, full pools, fused at width 8).  ``live`` is what
    ``_ploc_merge`` gives back in it: the live cluster count at the start
    of each round, then the count the loop ended with.  A round reads
    every live cluster's state (box 24 B,
    count and internal id 8 B, ids 4 * leaf B) once and writes the
    survivors' once; each output of the loop (the records, (t-1) x 36 B,
    and the leaf rows, t x (4 * leaf + 4) B) is written once."""
    n = 2 * t - 1
    i = t - 1
    state = 32 + 4 * leaf
    live = [int(m) for m in live]
    merge = (state * (sum(live[:-1]) + sum(live[1:]))
             + 36 * i + (4 * leaf + 4) * t)
    # lk, rk, lvl, bmn, bmx in; lchild, rchild, level, imin, imax (l-1,),
    # parent (2l-1,), surv (1 B), ch_old, arity, base (l-1,), newid (2l-1,)
    # out.  contrib, which the kernels hand each other, is not counted
    collapse = 36 * i + 36 * i + 4 * n + i + 4 * width * i + 8 * i + 4 * n
    rows_in = 36 * t + 4 * t + 4 * leaf * t + 4 * t   # verts, order, ids, counts
    refit = rows_in + 8 * i + 24 * n                  # + lchild, rchild; boxes
    rows = rows_in + 24 * t
    pack = (lbvh_bounds(t, width, leaf, n, t, i, width == 8,
                        tile=2)["lbvh_pack"].bytes   # (the pack's alone)
            + 4 * leaf * t)
    return {"ploc_merge": Bound(0, merge), "ploc_collapse": Bound(0, collapse),
            "ploc_refit": Bound(0, refit), "ploc_refit_rows": Bound(0, rows),
            "ploc_pack": Bound(0, pack)}
