"""The work of K1's walk over a wave's rays, counted by a frozen copy of
the port's plain walk (``ops/traverse_packet.py``'s ``walk_work`` at
widths 8 and 16, neither alpha nor predicate mode), so that a change to
the program cannot move the work its K1 roofline is held to.

It reads the program's table (``WideArrays``: its fused rows, width,
leaf size and depth), as K1 does, and walks it the way the kernel does:
8 or 16 slab tests a node, the hit children ordered far to near by the
same sorting network, the deferred ones pushed as one packed entry, up
to ``max_leaf_tris`` Moller-Trumbore tests a leaf, ties to the lower
triangle id; occlusion rays stop at their first hit closer than their
clamp.  It counts per ray the internal steps and their child slots, the
leaf steps and their triangle slots, and per row the bytes the kernel
reads of it.  Where the table is not laid out as this copy knows,
``count`` returns None and the metric is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

LARGE_FLOAT = 1e30
MT_EPSILON = 1e-6
MAX_STEPS = 400_000
MISS = -LARGE_FLOAT
TRI_SLOT_BYTES = 40
F23 = 0x4B000000
INT_MAX = 2 ** 31 - 1
# (qlo, qhi, meta, leaf count, base) word offsets of a node row, its
# words, and the meta word's (left_first bits, child count mask)
LAYOUT = {8: (6, 14, 22, 23, 24), 16: (6, 22, 38, 39, 40)}
ROW_WORDS = {8: 32, 16: 40}
META_BITS = {8: (25, 15), 16: (24, 31)}


def batcher_pairs(n: int) -> tuple:
    """Batcher's odd-even merge network over ``n`` inputs, as (a, b)
    comparators in order, used descending (swap when d[a] < d[b])."""
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


SORT_NETS = {
    8: ((0, 2), (1, 3), (4, 6), (5, 7), (0, 4), (1, 5), (2, 6), (3, 7),
        (0, 1), (2, 3), (4, 5), (6, 7), (2, 4), (3, 5), (1, 4), (3, 6),
        (1, 2), (3, 4), (5, 6)),
    16: batcher_pairs(16),
}


@dataclasses.dataclass
class Work:
    """Per ray ((R,) int64): internal steps, their child slots, leaf
    steps, their triangle slots; per row the bytes read of it.  The
    instance and any-hit counts ``bounds.k1_bound`` also reads are 0."""

    internal: torch.Tensor
    child_slots: torch.Tensor
    leaf: torch.Tensor
    tri_slots: torch.Tensor
    row_bytes: torch.Tensor

    @property
    def instance(self):
        return torch.zeros_like(self.internal)

    alpha_lookups = instance
    texel_reads = instance


def _qbyte(w, sh):
    bits = (((w >> sh) & 255) | F23).to(torch.int32)
    return bits.view(torch.float32) - 8388608.0


def _rcp(d):
    tiny = torch.where(d < 0, torch.full_like(d, -1e-20),
                       torch.full_like(d, 1e-20))
    return 1.0 / torch.where(d.abs() < 1e-20, tiny, d)


def count(wa, o: torch.Tensor, d: torch.Tensor,
          active: Optional[torch.Tensor] = None,
          t_max: Optional[torch.Tensor] = None, occlusion: bool = False,
          occl_split: int = 0, max_steps: int = MAX_STEPS
          ) -> Optional[Work]:
    """The work of the walk of rays ``o``, ``d`` over ``wa``; rays
    [0, occl_split) (all with ``occlusion``) are occlusion rays."""
    width = int(getattr(wa, "width", 0))
    fused = getattr(wa, "fused", None)
    lmax = max(int(getattr(wa, "max_leaf_tris", 0)), 1)
    if (width not in LAYOUT or fused is None or fused.dtype != torch.int32
            or fused.dim() != 2
            or fused.shape[1] != ROW_WORDS[width] + 16 * lmax
            or getattr(wa, "num_tlas", 1) != 0):
        return None
    dev = o.device
    r = o.shape[0]
    split = r if occlusion else int(occl_split)
    occ = torch.arange(r, device=dev) < split
    limit = (torch.full((r,), LARGE_FLOAT, dtype=torch.float32, device=dev)
             if t_max is None else t_max)
    on = (torch.ones(r, dtype=torch.bool, device=dev) if active is None
          else active)
    n_nodes = fused.shape[0]
    stack_n = int(wa.depth) + 4
    q_lo, q_hi, m_off, l_off, base = LAYOUT[width]
    nw = ROW_WORDS[width]
    lb, n_mask = META_BITS[width]
    wide16 = width == 16

    def f32(v):
        return torch.full((r,), v, dtype=torch.float32, device=dev)

    def i64():
        return torch.zeros(r, dtype=torch.int64, device=dev)

    large = f32(LARGE_FLOAT)
    miss_key = f32(MISS)
    ox, oy, oz = (o[:, k].contiguous() for k in range(3))
    dx, dy, dz = (d[:, k].contiguous() for k in range(3))
    ivx, ivy, ivz = _rcp(dx), _rcp(dy), _rcp(dz)
    best_t = torch.where(on, limit, -large)
    tri, node, sc = i64(), i64(), i64()
    steps = torch.zeros(r, dtype=torch.int32, device=dev)
    st0 = torch.zeros((r, stack_n), dtype=torch.int64, device=dev)
    st1 = torch.zeros((r, stack_n), dtype=torch.int64, device=dev)
    st2 = (torch.zeros((r, stack_n), dtype=torch.int64, device=dev)
           if wide16 else None)
    alive = best_t > 0.0
    work = Work(i64(), i64(), i64(), i64(),
                torch.zeros(n_nodes, dtype=torch.int64, device=dev))

    while bool(alive.any()):
        node_c = node.clamp(0, n_nodes - 1)
        raw = fused[node_c]
        row_f = raw.view(torch.float32)
        row = raw.to(torch.int64) & 0xFFFFFFFF
        meta = row[:, m_off]
        kind = meta >> 29
        nch = (meta >> lb) & n_mask
        left = meta & ((1 << lb) - 1)
        leaf_n = raw[:, l_off].to(torch.int64)
        is_int = alive & (kind == 0)
        is_tri = alive & (kind == 1)

        # internal: slab tests, far -> near network, push the deferred
        gx, gy, gz = row_f[:, 0], row_f[:, 1], row_f[:, 2]
        sx, sy, sz = row_f[:, 3], row_f[:, 4], row_f[:, 5]
        ds, ix = [], []
        for c in range(width):
            ql = row[:, q_lo + c]
            qh = row[:, q_hi + c]
            t1x = (gx + _qbyte(ql, 0) * sx - ox) * ivx
            t2x = (gx + _qbyte(qh, 0) * sx - ox) * ivx
            t1y = (gy + _qbyte(ql, 8) * sy - oy) * ivy
            t2y = (gy + _qbyte(qh, 8) * sy - oy) * ivy
            t1z = (gz + _qbyte(ql, 16) * sz - oz) * ivz
            t2z = (gz + _qbyte(qh, 16) * sz - oz) * ivz
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
        m = sum((dc > MISS).to(torch.int64) for dc in ds)
        descend = is_int & (m >= 1)
        child = torch.stack(ix, 1).gather(
            1, (m - 1).clamp(0, width - 1).unsqueeze(1)).squeeze(1)
        cnt_def = (m - 1).clamp(0, width - 1)
        word0 = (left << 4) | cnt_def
        if wide16:
            word1 = ix[0] & 15
            for j in range(1, 8):
                word1 = word1 | ((ix[j] & 15) << (4 * j))
            word2 = ix[8] & 15
            for j in range(9, 15):
                word2 = word2 | ((ix[j] & 15) << (4 * (j - 8)))
        else:
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

        # triangle leaf: up to lmax tests, folded to the leaf's best
        tr = row_f[:, nw:]
        tr_i = raw[:, nw:].to(torch.int64)
        t_min = large
        tid_sel = torch.full((r,), INT_MAX, dtype=torch.int64, device=dev)
        for c in range(lmax):
            b0 = 16 * c
            v0x, v0y, v0z = tr[:, b0 + 0], tr[:, b0 + 1], tr[:, b0 + 2]
            e1x, e1y, e1z = tr[:, b0 + 3], tr[:, b0 + 4], tr[:, b0 + 5]
            e2x, e2y, e2z = tr[:, b0 + 6], tr[:, b0 + 7], tr[:, b0 + 8]
            tid = tr_i[:, b0 + 9]
            hx = dy * e2z - dz * e2y
            hy = dz * e2x - dx * e2z
            hz = dx * e2y - dy * e2x
            a = e1x * hx + e1y * hy + e1z * hz
            small = a.abs() < MT_EPSILON
            fba = 1.0 / torch.where(small, torch.ones_like(a), a)
            px, py, pz = ox - v0x, oy - v0y, oz - v0z
            w1 = fba * (px * hx + py * hy + pz * hz)
            qx = py * e1z - pz * e1y
            qy = pz * e1x - px * e1z
            qz = px * e1y - py * e1x
            w2 = fba * (dx * qx + dy * qy + dz * qz)
            t = fba * (e2x * qx + e2y * qy + e2z * qz)
            ok = (~small & (w1 >= 0.0) & (w1 <= 1.0) & (w2 >= 0.0)
                  & (w1 + w2 <= 1.0) & (t > MT_EPSILON) & (c < leaf_n))
            t = torch.where(ok, t, large)
            better = (t < t_min) | ((t == t_min) & (t < LARGE_FLOAT)
                                    & (tid < tid_sel))
            t_min = torch.where(better, t, t_min)
            tid_sel = torch.where(better, tid, tid_sel)
        occ_hit = is_tri & occ & (t_min < best_t)
        upd = is_tri & ~occ & (
            (t_min < best_t) | ((t_min == best_t) & (t_min < LARGE_FLOAT)
                                & (tid_sel < tri)))
        best_t = torch.where(upd, t_min, best_t)
        best_t = torch.where(occ_hit, -large, best_t)
        tri = torch.where(upd, tid_sel, tri)

        slots = leaf_n.clamp(0, lmax)
        work.internal.add_(is_int.to(torch.int64))
        work.child_slots.add_(torch.where(is_int, nch, 0))
        work.leaf.add_(is_tri.to(torch.int64))
        work.tri_slots.add_(torch.where(is_tri, slots, 0))
        # the kernel's reads: the row's meta quarter at every step, the
        # other boxes at an internal node, the triangle slots at a leaf
        nbytes = torch.where(is_int, 4 * base, torch.where(
            is_tri, 16 + TRI_SLOT_BYTES * slots, 16))
        work.row_bytes.scatter_reduce_(0, node_c[alive], nbytes[alive],
                                       reduce="amax")

        # pop when we did not descend; an empty stack ends the ray
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
    return work
