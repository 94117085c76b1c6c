"""The least time one H100 could take for a walk of K1 (its roofline
bound): a frozen copy of the arithmetic and constants of the port's
``tools/walk_bounds.py`` (``k1_bound``), so that a change to the program
cannot move the yardstick its kernel is held to.

A bound is the larger of the bytes the function must move over the
card's memory rate and its FP32 operations over the card's FP32 rate
(NVIDIA's data sheet, H100 SXM at its full 700 W limit: 3.35 TB/s of
HBM3, 67 TFLOP/s FP32 outside the tensor cores).  A walk's work depends
on its rays, so it is counted from what the plain walk does on them
(``rtbench.reference.walk``, a frozen copy of the program's: per ray,
internal steps and their child slots, leaf steps and their triangle
slots, the bytes of the rows it visits; the alpha and predicate tests,
zero outside those modes):

- a child slot of an internal step: 37 operations; the child sort: 19
  comparisons (width 8), 63 (width 16); a triangle slot: 53
  (Moller-Trumbore); an instance step: 36;
- bytes: a walking ray's o, d, t_max and flag in (29 B), 5 B for a ray
  that takes no step, every ray's hit record out (28 B), and each table
  row some ray visits, once.
"""

from __future__ import annotations

import dataclasses

H100_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12

OPS_PER_CHILD = 37
OPS_SORT8 = 19
OPS_SORT16 = 63
OPS_PER_TRI = 53
OPS_PER_INSTANCE = 36
OPS_PER_ALPHA = 17
OPS_UV = 12
OPS_TEXEL = OPS_PER_ALPHA - OPS_UV
RAY_IN_BYTES = 29
IDLE_RAY_IN_BYTES = 5
HIT_OUT_BYTES = 28


@dataclasses.dataclass(frozen=True)
class Bound:
    ops: int
    bytes: int

    @property
    def ms(self) -> float:
        return max(self.ops / H100_FP32_OPS_PER_S,
                   self.bytes / H100_BYTES_PER_S) * 1e3


def k1_bound(work, width: int = 8, pred_ops: int = 0) -> Bound:
    """K1's bound on the rays of one wave, from their ``WalkWork``."""
    sort = OPS_SORT16 if width == 16 else OPS_SORT8
    tests = ((OPS_UV + pred_ops) * int(work.alpha_lookups.sum())
             + OPS_TEXEL * int(work.texel_reads.sum()))
    ops = (OPS_PER_CHILD * int(work.child_slots.sum())
           + sort * int(work.internal.sum())
           + OPS_PER_TRI * int(work.tri_slots.sum())
           + OPS_PER_INSTANCE * int(work.instance.sum()) + tests)
    r = int(work.internal.numel())
    walking = int(((work.internal + work.leaf + work.instance) > 0).sum())
    return Bound(ops=ops, bytes=walking * RAY_IN_BYTES
                 + (r - walking) * IDLE_RAY_IN_BYTES + r * HIT_OUT_BYTES
                 + int(work.row_bytes.sum()))
