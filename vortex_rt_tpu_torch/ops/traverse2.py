"""Hit records (port of the ``Hits`` tuple of
``vortex_rt_tpu/ops/traverse2.py``).  The binary-BVH cross-check walk of
that module (K6 in ROADMAP) is not ported yet."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Hits(NamedTuple):
    """Ray hit records as SoA lanes."""

    dist: torch.Tensor  # (R,) f32, LARGE_FLOAT = miss
    bx: torch.Tensor    # (R,) f32 barycentrics
    by: torch.Tensor
    bz: torch.Tensor
    tri: torch.Tensor   # (R,) i32 global triangle id
    inst: torch.Tensor  # (R,) i32 instance id
