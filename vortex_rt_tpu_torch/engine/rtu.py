"""RT-unit instruction-level facade: traceRay / getWork / getAttr / commit
(port of ``vortex_rt_tpu/engine/rtu.py``).

The reference's programming model is four custom instructions backed by
the per-core RT unit: traceRay allocates a ray id and starts its walk;
rays that stop park in per-shader-type queues; getWork pops up to
``lanes`` ids from the longest queue, encoded as
``(1 << (28 + type)) | rayID``; getAttr reads ray and hit state by
VX_RT_* id; commit resumes or ends a ray.  This module keeps that
contract at batch granularity — each call takes arrays of ray ids — so
code shaped like the reference's persistent kernel loop ports directly.
The wavefront engine is the fast path; this facade is the programmable
one and the executable specification of the queue and commit semantics.

Ray ids start at 1 and grow by one a ray, as the JAX facade allocates
them; 0 means "no work".  Unlike the JAX facade, which keeps a Python
record per ray, the ray state lives in tensors on the tables' device, one
row a live ray: origins and directions, the per-ray walk state
(``WideState``), the last walk's hit.  An id maps to its row through a
table on the host (``_row_of``, the window of ids from the oldest live
one); TERM frees the row onto a free list, ``trace_ray`` takes rows from
the free list first, and the tensors grow only when a batch needs more
rows than are free, by doubling, with one copy.  So the rows stay within
twice the peak of live rays and one batch, as the JAX facade's records
stay with its live rays.  Only the queues (NumPy id arrays), the id table
and three fields a row (walked, hit pending, payload) are on the host.
Each batch of walks is one ``trace_lanes`` call — K3 on a card — over a
copy of the rays' state, written back after it, and one read of the
suspended and missed flags to route the rays to their queues.  Fresh and
resumed rays walk in separate batches, in queue order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from vortex_rt_tpu_torch.ops.traverse_wide import (
    WideArrays, WideState, commit as _commit_state, state_dtype, trace_lanes,
)
from vortex_rt_tpu_torch.utils.config import (
    COMMIT_ACCEPT, COMMIT_CONT, COMMIT_TERM, LARGE_FLOAT,
)

# shader / work types, the RT unit's ShaderType order
SHADER_MISS = 0
SHADER_CLOSEST = 1
SHADER_INTERSECTION = 2  # reserved (procedural primitives), unused
SHADER_ANY = 3
NUM_SHADER_TYPES = 4

# VX_RT_* attribute ids (hw/VX_types.toml:270-285)
VX_RT_RAY_RO_X = 0xFD0
VX_RT_RAY_RO_Y = 0xFD1
VX_RT_RAY_RO_Z = 0xFD2
VX_RT_RAY_RD_X = 0xFD3
VX_RT_RAY_RD_Y = 0xFD4
VX_RT_RAY_RD_Z = 0xFD5
VX_RT_HIT_DIST = 0xFD6
VX_RT_HIT_BX = 0xFD7
VX_RT_HIT_BY = 0xFD8
VX_RT_HIT_BZ = 0xFD9
VX_RT_HIT_BLAS_IDX = 0xFDA
VX_RT_HIT_TRI_IDX = 0xFDB
VX_RT_RAY_PAYLOAD_ADDR = 0xFDC
VX_RT_COMMIT_CONT = 0xFDD
VX_RT_COMMIT_ACCEPT = 0xFDE
VX_RT_COMMIT_TERM = 0xFDF

_COMMIT_MAP = {
    VX_RT_COMMIT_CONT: COMMIT_CONT,
    VX_RT_COMMIT_ACCEPT: COMMIT_ACCEPT,
    VX_RT_COMMIT_TERM: COMMIT_TERM,
}
_ID_MASK = 0x0FFFFFFF


def decode_work(ret: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """type = ctz(ret >> 28); id = ret & 0x0FFFFFFF (NumPy uint32: torch
    has no unsigned 32-bit arithmetic)."""
    ret = np.asarray(ret, np.uint32)
    hi = ret >> 28
    # count trailing zeros of the (one-hot) type nibble
    t = np.zeros_like(hi)
    for b in range(4):
        t = np.where(hi == (1 << b), b, t)
    return t.astype(np.int32), (ret & _ID_MASK).astype(np.int32)


def _empty_ids() -> np.ndarray:
    return np.zeros(0, np.int64)


class RTUnit:
    """Per-scene RT engine with the reference's 4-op interface.

    ``anyhit=True`` sends every strictly closer candidate to the ANY
    queue (suspension), as the hardware does; ``anyhit=False`` accepts
    it and rays land directly in MISS or CLOSEST.  The tables need the
    4-wide TLAS build for suspension (``trace_lanes``)."""

    def __init__(self, wa: WideArrays, lanes: int = 4096,
                 anyhit: bool = True, queue_capacity: int = 1024):
        self.wa = wa
        self.lanes = int(lanes)
        self.anyhit = bool(anyhit)
        # ShaderQueue capacity.  The hardware ring overwrites its oldest
        # entry on overflow; the facade must not lose rays, so overflow
        # spills to a side list that refills the queue as get_work drains
        # it
        self.queue_capacity = int(queue_capacity)
        self._next_id = 1  # 0 is invalid
        # id -> row of the ids [_id_base, _next_id); -1 once terminated
        self._id_base = 1
        self._row_of = np.zeros(0, np.int64)
        self._free = np.zeros(0, np.int64)  # rows freed by TERM
        self._used = 0  # rows [0, _used) were handed out at least once
        dev = wa.device
        self._o = torch.zeros((0, 3), dtype=torch.float32, device=dev)
        self._d = torch.zeros((0, 3), dtype=torch.float32, device=dev)
        self._state = WideState(*(
            torch.zeros(0, dtype=state_dtype(f), device=dev)
            for f in WideState._fields))
        # the last walk's hit (the accepted one after an ACCEPT)
        self._dist = torch.zeros(0, dtype=torch.float32, device=dev)
        self._bx = torch.zeros_like(self._dist)
        self._by = torch.zeros_like(self._dist)
        self._bz = torch.zeros_like(self._dist)
        self._blas = torch.zeros(0, dtype=torch.int32, device=dev)
        self._tri = torch.zeros_like(self._blas)
        # per row
        self._payload = np.zeros(0, np.int64)
        self._walked = np.zeros(0, bool)    # has a walk state
        self._has_pend = np.zeros(0, bool)  # suspended at a candidate
        self._queues: List[np.ndarray] = [_empty_ids()
                                          for _ in range(NUM_SHADER_TYPES)]
        self._spill: List[np.ndarray] = [_empty_ids()
                                         for _ in range(NUM_SHADER_TYPES)]
        self._pending_trace: List[np.ndarray] = []  # ids to (re)walk

    def _enqueue(self, ty: int, ids: np.ndarray) -> None:
        """Append ids to queue ``ty`` while it has room, the rest to its
        spill, in order."""
        room = max(self.queue_capacity - len(self._queues[ty]), 0)
        self._queues[ty] = np.concatenate([self._queues[ty], ids[:room]])
        self._spill[ty] = np.concatenate([self._spill[ty], ids[room:]])

    @property
    def capacity(self) -> int:
        """Rows of per-ray state held on the device."""
        return int(self._dist.shape[0])

    def _reserve(self, n: int) -> None:
        """Make room for ``n`` rows beyond those ever handed out: double
        the capacity (or more, to what is needed), copying once."""
        cap = self.capacity
        need = self._used + n
        if need <= cap:
            return
        new_cap = max(need, 2 * cap)

        def more(a: torch.Tensor, fill=0) -> torch.Tensor:
            out = a.new_full((new_cap, *a.shape[1:]), fill)
            out[:cap] = a
            return out

        self._o, self._d = more(self._o), more(self._d)
        self._state = WideState(*(more(a) for a in self._state))
        self._dist = more(self._dist, LARGE_FLOAT)
        self._bx, self._by, self._bz = (more(a) for a in (self._bx, self._by,
                                                          self._bz))
        self._blas, self._tri = more(self._blas), more(self._tri)
        pad = new_cap - cap
        self._payload = np.concatenate([self._payload,
                                        np.zeros(pad, np.int64)])
        self._walked = np.concatenate([self._walked, np.zeros(pad, bool)])
        self._has_pend = np.concatenate([self._has_pend,
                                         np.zeros(pad, bool)])

    def _alloc(self, n: int) -> np.ndarray:
        """``n`` rows for new rays: freed rows first, then fresh ones.  A
        reused row's walk state and hit are reset to a fresh row's."""
        k = min(n, len(self._free))
        reused, self._free = self._free[:k], self._free[k:]
        self._reserve(n - k)
        fresh = np.arange(self._used, self._used + n - k, dtype=np.int64)
        self._used += n - k
        if k:
            idx = torch.as_tensor(reused, device=self.wa.device)
            for f in self._state:
                f[idx] = 0
            self._dist[idx] = LARGE_FLOAT
            for a in (self._bx, self._by, self._bz, self._blas, self._tri):
                a[idx] = 0
        return np.concatenate([reused, fresh])

    def _rows(self, ids: np.ndarray) -> np.ndarray:
        """Row of each id; -1 for an id that was terminated or never
        allocated."""
        k = ids - self._id_base
        ok = (k >= 0) & (ids < self._next_id)
        rows = np.full(ids.shape, -1, np.int64)
        rows[ok] = self._row_of[k[ok]]
        return rows

    # ---- traceRay ----

    def trace_ray(self, o: np.ndarray, d: np.ndarray,
                  payload_addr: Optional[np.ndarray] = None) -> np.ndarray:
        """Allocate ray ids for a batch and enqueue its walk."""
        dev = self.wa.device
        o = torch.as_tensor(np.asarray(o, np.float32).reshape(-1, 3),
                            device=dev)
        d = torch.as_tensor(np.asarray(d, np.float32).reshape(-1, 3),
                            device=dev)
        n = o.shape[0]
        if payload_addr is None:
            payload_addr = np.zeros(n, np.int64)
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._next_id += n
        rows = self._alloc(n)
        self._row_of = np.concatenate([self._row_of, rows])
        idx = torch.as_tensor(rows, device=dev)
        self._o[idx] = o
        self._d[idx] = d
        self._payload[rows] = np.asarray(payload_addr, np.int64).reshape(n)
        self._walked[rows] = False
        self._has_pend[rows] = False
        self._pending_trace.append(ids)
        return ids.astype(np.uint32)

    # ---- internal: walk the pending rays, route them to queues ----

    def _run_pending(self) -> None:
        if not self._pending_trace:
            return
        pend = np.concatenate(self._pending_trace)
        self._pending_trace = []
        pend = pend[self._rows(pend) >= 0]  # (terminated since queued)
        if not len(pend):
            return
        # fresh and resumed rays walk in separate batches
        walked = self._walked[self._rows(pend)]
        fresh, resumed = pend[~walked], pend[walked]
        if len(fresh) and len(resumed):
            self._run_batch(fresh, False)
            self._run_batch(resumed, True)
            return
        self._run_batch(pend, bool(walked[0]))

    def _run_batch(self, ids: np.ndarray, resume: bool) -> None:
        if not len(ids):
            return
        rows = self._rows(ids)
        idx = torch.as_tensor(rows, device=self.wa.device)
        o, d = self._o[idx], self._d[idx]
        lanes = tuple(a[:, k].contiguous() for a in (o, d) for k in range(3))
        state = (WideState(*(f[idx] for f in self._state)) if resume
                 else None)
        hits, st, _ = trace_lanes(self.wa, *lanes, state=state,
                                  suspend=self.anyhit)
        for f, v in zip(self._state, st):
            f[idx] = v
        self._dist[idx] = hits.dist
        self._bx[idx] = hits.bx
        self._by[idx] = hits.by
        self._bz[idx] = hits.bz
        self._blas[idx] = hits.inst
        self._tri[idx] = hits.tri
        self._walked[rows] = True
        sus, miss = torch.stack([st.suspended,
                                 hits.dist >= LARGE_FLOAT]).cpu().numpy()
        self._has_pend[rows] = sus
        ty = np.where(sus, SHADER_ANY,
                      np.where(miss, SHADER_MISS, SHADER_CLOSEST))
        for t in (SHADER_MISS, SHADER_CLOSEST, SHADER_ANY):
            self._enqueue(t, ids[ty == t])

    # ---- getWork ----

    def get_work(self) -> np.ndarray:
        """Pop <= lanes ray ids from the longest queue; returns encoded
        words ``(1 << (28+type)) | rayID`` (empty array when no work)."""
        self._run_pending()
        lengths = [len(q) for q in self._queues]
        if max(lengths) == 0:
            return np.zeros(0, np.uint32)
        ty = int(np.argmax(lengths))  # the longest queue wins
        take = self._queues[ty][: self.lanes]
        self._queues[ty] = self._queues[ty][self.lanes:]
        # drain spilled rays into the freed queue slots
        room = self.queue_capacity - len(self._queues[ty])
        if room > 0 and len(self._spill[ty]):
            self._queues[ty] = np.concatenate([self._queues[ty],
                                               self._spill[ty][:room]])
            self._spill[ty] = self._spill[ty][room:]
        return ((np.uint32(1) << np.uint32(28 + ty))
                | np.asarray(take, np.uint32))

    # ---- getAttr ----

    def _ids(self, ray_ids) -> np.ndarray:
        return np.asarray(ray_ids).ravel().astype(np.int64) & _ID_MASK

    def get_attr(self, ray_ids: np.ndarray, attr: int) -> np.ndarray:
        """One attribute of each ray: the ray's origin, direction and
        payload, or its hit — the pending candidate while the ray is
        suspended at one, else its walk's hit.  Hit distances and
        barycentrics come back as float64 and ids as int64, as the JAX
        facade's; a terminated or unknown id raises KeyError."""
        k = self._rows(self._ids(ray_ids))
        if (k < 0).any():
            raise KeyError("get_attr of an unknown or terminated ray id")
        if attr == VX_RT_RAY_PAYLOAD_ADDR:
            return self._payload[k]
        idx = torch.as_tensor(k, device=self.wa.device)
        ray = {VX_RT_RAY_RO_X: (self._o, 0), VX_RT_RAY_RO_Y: (self._o, 1),
               VX_RT_RAY_RO_Z: (self._o, 2), VX_RT_RAY_RD_X: (self._d, 0),
               VX_RT_RAY_RD_Y: (self._d, 1), VX_RT_RAY_RD_Z: (self._d, 2)}
        if attr in ray:
            a, c = ray[attr]
            return a[idx, c].cpu().numpy()
        st = self._state
        pend = self._has_pend[k]
        if attr == VX_RT_HIT_BZ:
            bx, by, bz = (a[idx].cpu().numpy() for a in (st.pend_bx,
                                                         st.pend_by, self._bz))
            # a pending candidate has no bz of its own: 1 - bx - by
            return np.where(pend, 1.0 - bx.astype(np.float64)
                            - by.astype(np.float64), bz.astype(np.float64))
        fields = {VX_RT_HIT_DIST: (st.pend_t, self._dist),
                  VX_RT_HIT_BX: (st.pend_bx, self._bx),
                  VX_RT_HIT_BY: (st.pend_by, self._by),
                  VX_RT_HIT_BLAS_IDX: (st.pend_inst, self._blas),
                  VX_RT_HIT_TRI_IDX: (st.pend_tri, self._tri)}
        if attr not in fields:
            raise KeyError(f"unknown attribute 0x{attr:03x}")
        p, h = (a[idx].cpu().numpy() for a in fields[attr])
        out = np.where(pend, p, h)
        return out.astype(np.float64 if out.dtype.kind == "f" else np.int64)

    # ---- commit ----

    def commit(self, ray_ids: np.ndarray, action: int) -> None:
        """action: VX_RT_COMMIT_* (or config.COMMIT_*).  TERM frees the
        rays; CONT and ACCEPT apply the action to their walk state
        (ACCEPT also takes the pending candidate as their hit) and queue
        them to resume.  Unknown and terminated ids are skipped."""
        act = _COMMIT_MAP.get(action, action)
        ids = self._ids(ray_ids)
        rows = self._rows(ids)
        ids, rows = ids[rows >= 0], rows[rows >= 0]
        if not len(ids):
            return
        if act == COMMIT_TERM:
            self._terminate(ids, rows)  # free all per-ray state
            return
        dev = self.wa.device
        idx = torch.as_tensor(rows, device=dev)
        old = WideState(*(f[idx] for f in self._state))
        new = _commit_state(old, torch.full((len(ids),), act,
                                            dtype=torch.int32, device=dev))
        if act == COMMIT_ACCEPT:
            pend = torch.as_tensor(self._has_pend[rows], device=dev)
            for rec, p in ((self._dist, old.pend_t), (self._bx, old.pend_bx),
                           (self._by, old.pend_by),
                           (self._blas, old.pend_inst),
                           (self._tri, old.pend_tri)):
                rec[idx] = torch.where(pend, p, rec[idx])
        for f, v in zip(self._state, new):
            f[idx] = v
        self._has_pend[rows] = False
        self._pending_trace.append(ids)  # resume the walk

    def _terminate(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Free the rows of live ``ids`` (an id given twice is freed once)
        and drop the id table's prefix of terminated ids."""
        self._row_of[ids - self._id_base] = -1
        self._free = np.concatenate([self._free, np.unique(rows)])
        live = np.flatnonzero(self._row_of >= 0)
        cut = int(live[0]) if len(live) else len(self._row_of)
        if cut:
            self._row_of = self._row_of[cut:].copy()
            self._id_base += cut

    # ---- convenience ----

    def active_rays(self) -> int:
        return int((self._row_of >= 0).sum())
