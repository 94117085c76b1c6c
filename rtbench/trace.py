"""What a traced run reads from ``torch.profiler``'s trace: the device
operations (kernels, copies, fills) with their times, the harness's own
phase labels (``record_function`` ranges named ``rtbench.*`` around the
calls into the program), and from them the busy time, the idle gaps by
what the host was doing, and the device time of each frame by kind of
operation.

The port's hand-written kernels are told apart from PyTorch's own by
their ``__global__`` names (``HAND_WRITTEN``); a kernel named in none of
them is one of PyTorch's (the gathers, the sampler's hash, the
elementwise and scan operations around the walks).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

# the port's __global__ functions (vortex_rt_tpu_torch/csrc/*.cu), by the
# layer they belong to
K1 = ("traverse_packet_kernel", "traverse_packet16_kernel")
K5 = ("refit_tile_kernel", "pack_nodes_kernel", "pack_leaves_kernel")
HAND_WRITTEN = K1 + K5 + (
    "packet_walk_kernel", "traverse_wide_kernel", "traverse2_kernel",
    "hbm_walk_kernel", "box_morton_kernel", "karras_kernel",
    "collapse_kernel", "refit_plan_kernel", "sweep_kernel",
    "merge_grid_kernel", "merge_tail_kernel", "remap_collapse_kernel",
    "boxes_kernel")
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}
PHASE = "rtbench."


def kernel_of(name: str) -> Optional[str]:
    """The hand-written ``__global__`` a device operation's name calls,
    or None (the name as the profiler demangles it: ``void
    traverse_packet_kernel<8, ...>(...)``)."""
    for k in HAND_WRITTEN:
        if re.search(rf"(^|[\s:*]){k}\s*[<(]", name) or name == k:
            return k
    return None


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    kind: str      # kernel, memcpy, memset
    start: float   # seconds on the trace's clock
    end: float


@dataclasses.dataclass
class Trace:
    ops: List[Op]
    phases: List[Tuple[str, float, float]]   # host ranges, seconds

    @staticmethod
    def from_chrome(path) -> "Trace":
        with open(path) as f:
            doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        return Trace.from_events(events)

    @staticmethod
    def from_events(events: Sequence[dict]) -> "Trace":
        ops, phases = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e.get("dur", 0.0)) * 1e-6
            if cat in DEVICE_CATS:
                ops.append(Op(e.get("name", ""), DEVICE_CATS[cat], t0, t1))
            elif cat == "user_annotation" and e.get("name", "").startswith(
                    PHASE):
                phases.append((e["name"], t0, t1))
        ops.sort(key=lambda o: o.start)
        phases.sort(key=lambda p: p[1])
        return Trace(ops, phases)

    def window(self) -> Tuple[float, float]:
        """From the first phase's start to the last one's end: the frames
        the trace holds, closed loop (each ends with its image on the
        host, so a frame's device work lies inside its phases)."""
        return self.phases[0][1], max(p[2] for p in self.phases)

    def frames(self) -> List[Tuple[float, float]]:
        """Each frame's host range: from its first phase to the end of its
        image copy (``rtbench.image``)."""
        out, start = [], None
        for name, t0, t1 in self.phases:
            if start is None:
                start = t0
            if name == PHASE + "image":
                out.append((start, t1))
                start = None
        return out


def union(intervals: List[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """The union of intervals clipped to [lo, hi], as disjoint sorted
    intervals."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(tr: Trace, lo: float, hi: float) -> float:
    """Seconds in [lo, hi] in which some device operation ran."""
    return sum(b - a for a, b in union([(o.start, o.end) for o in tr.ops],
                                       lo, hi))


def idle_gaps(tr: Trace, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] with no device operation."""
    busy = union([(o.start, o.end) for o in tr.ops], lo, hi)
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def phase_at(tr: Trace, t: float) -> str:
    """The innermost harness phase whose host range holds ``t`` (the
    latest started), or ``between phases``."""
    best = None
    for name, a, b in tr.phases:
        if a <= t < b and (best is None or a >= best[1]):
            best = (name, a)
    return best[0] if best else "between phases"


def gaps_by_phase(tr: Trace, lo: float, hi: float) -> Dict[str, float]:
    """Idle seconds by the phase the host was in when each gap began."""
    out: Dict[str, float] = {}
    for a, b in idle_gaps(tr, lo, hi):
        k = phase_at(tr, a)
        out[k] = out.get(k, 0.0) + (b - a)
    return out


def ops_in(tr: Trace, lo: float, hi: float) -> List[Op]:
    return [o for o in tr.ops if lo <= o.start < hi]


def device_ms(ops: Sequence[Op], pick) -> float:
    return sum(o.end - o.start for o in ops if pick(o)) * 1e3


def top_ops(tr: Trace, lo: float, hi: float, n: int = 10
            ) -> List[Tuple[str, float]]:
    """The ``n`` device operations (by name) that took most time."""
    tot: Dict[str, float] = {}
    for o in ops_in(tr, lo, hi):
        key = o.name[:160]
        tot[key] = tot.get(key, 0.0) + (o.end - o.start)
    return sorted(tot.items(), key=lambda kv: -kv[1])[:n]
