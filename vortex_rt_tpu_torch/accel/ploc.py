"""On-device PLOC build and level refit (port of
``vortex_rt_tpu/accel/ploc.py``, K4).

PLOC (Meister & Bittner 2018) builds the tree by clustering: the
triangles start as clusters in Morton order, and every round each live
cluster finds, within ``radius`` positions either side, the neighbour
whose union box has the smallest half area; mutual nearest neighbours
merge.  Two leaf clusters whose triangles fit one leaf just join their
lists; any other merge writes the leaf rows of its leaf-cluster sides
and allocates an internal node.  Leaves and splits are both chosen by
the clustering, so leaf rows hold arbitrary triangle sets, not Morton
ranges.  The result reuses the LBVH's depth-stride wide collapse and its
quantized packer (``accel/lbvh.py``), so the walks read the same format.

Pipeline (``build_ploc_topo``):

1. Morton codes over the scene box and a stable sort (``lbvh.scene_codes``
   and ``torch.sort``, as ``build_lbvh_topo``);
2. the merge loop (``_ploc_merge``, K4a), whole on the card: a
   cooperative grid runs the rounds while more than ``tail_size(leaf)``
   clusters live, then one block runs the rest with the clusters in its
   shared memory; a round runs over the live clusters only, and the loop
   stops at one cluster or at the JAX package's round cap.  Nothing is
   read back unless the caller asks for the round log (``live``);
3. creation order -> the packer's ids (root = 0) and the parent of
   every node, then the collapse, which also gives the tree's real wide
   depth (ROADMAP H8): ``_remap_collapse_ploc`` (K4b), one launch;
4. the leaf-row boxes (``_row_boxes``, K4c) beside the merge's internal
   boxes, and the pack (``lbvh._pack_rows`` with ``leaf_tids``: the
   survivor records by K5's kernel, the leaf rows from the explicit ids
   by its leaf kernel, K4d — the JAX package's ``_rows_from_tids``).

``refit_ploc`` keeps the topology and recomputes every box (K4c: the
leaf rows reduce over their triangle ids, then climb the parents with
one arrival counter per internal, kept with the topology and reset by
the second arriver; the kernel writes the zeros of the internals never
created, so a refit frame is one launch into unfilled outputs) before
the same pack.

Every step has two versions.  On CUDA tensors it launches a hand-written
kernel (``csrc/ploc_merge.cu``, ``ploc_collapse.cu``, ``ploc_refit.cu``
and the ``leaf_tids`` mode of ``lbvh_pack.cu``, built by
``runtime/kernels.py``) or raises; on CPU tensors it runs the plain
PyTorch version (``*_ref``), which is the JAX arithmetic in torch ops.
There is no fallback between the two.  Every output equals the JAX
package's word for word (run op by op; jitted, XLA:CPU may contract the
merge cost into an FMA: ROADMAP H9).

The plain merge runs each round over the live prefix of the clusters:
positions at or past the live count ``m`` never reach an output in the
JAX loop (their costs are ``_BIG``, they neither merge nor are
absorbed), so dropping them changes no word.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vortex_rt_tpu_torch.accel.lbvh import (
    LBVHNodes, LBVHTopo, _check_i32, _check_verts, _cuda, _half_area,
    _launch, _pack_rows, pad_tris, scene_codes, topo_state,
    wide_arrays_from_lbvh, wide_depth_of,
)
from vortex_rt_tpu_torch.ops import packet_walk, traverse_packet
from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays
from vortex_rt_tpu_torch.runtime import kernels

_I32 = torch.int32
_I64 = torch.int64
_F32 = torch.float32
_BIG = 3e38           # the JAX package's "no neighbour" cost (not inf)
DEPTH_CAP = 256       # the JAX collapse's depth propagation rounds
# the merge's state words (csrc/ploc_merge.cu): the rounds run, the
# any-merge flags, the fallback flag and the counters of the two round
# parities, then the final counters [live, internals, rounds], then the
# round log (the live count at the start of each round)
_ST_CTR, _ST_FINAL, _ST_LOG = 4, 12, 16
# shared memory one block may take on the card (the H100's 227 KB), less
# what the merge's tail kernel declares for itself
TAIL_SMEM = 232_448 - 1_024


class PLOCTopo(NamedTuple):
    """Fixed PLOC topology for the level refit: the JAX package's fields
    (``topo`` is the port's ``LBVHTopo`` with ``parent`` filled in and
    ``lo``, ``hi``, ``row_lo`` zero), plus ``wide_depth``, which only the
    port keeps."""

    topo: LBVHTopo
    leaf_tids: torch.Tensor   # (l, leaf) sorted-order slot per row (-1 pad)
    level: torch.Tensor       # (l-1,) creation round per old internal
    n_int: torch.Tensor       # () live internal count
    n_levels: torch.Tensor    # () rounds the merge loop ran
    wide_depth: torch.Tensor  # () the collapsed tree's depth, root = 1,
                              # leaves counted (the host builder's depth)


def round_cap(l: int) -> int:
    """The merge loop's round cap, as the JAX package computes it."""
    return 4 * int(np.log2(max(l, 2))) + 192


# ------------------------------------------------------------------ K4a

def _merge_tids(tids_i, cnt_i, tids_j, lmax: int) -> torch.Tensor:
    """Join two leaf clusters' id lists (n, lmax) -> (n, lmax): slot s
    takes tids_i[s] while s < cnt_i, else tids_j[s - cnt_i] (-1 where
    that slot does not exist)."""
    s = torch.arange(lmax, dtype=_I64, device=tids_i.device)[None, :]
    c = cnt_i.to(_I64)[:, None]
    t = s - c
    pick = tids_j.gather(1, t.clamp(0, lmax - 1))
    v = torch.where((t >= 0) & (t <= s), pick, torch.full_like(pick, -1))
    return torch.where(s < c, tids_i, v)


def _ploc_merge_ref(cmin, cmax, tids, m0: int, l: int, lmax: int,
                    radius: int, live: Optional[List[int]] = None):
    """Plain version of ``_ploc_merge``: the JAX loop body in torch ops,
    over the live prefix."""
    dev = cmin.device
    big = torch.tensor(_BIG, dtype=_F32, device=dev)
    lk = torch.zeros(l - 1, dtype=_I32, device=dev)
    rk, lvl = torch.zeros_like(lk), torch.zeros_like(lk)
    bmn = torch.zeros((l - 1, 3), dtype=_F32, device=dev)
    bmx = torch.zeros_like(bmn)
    row_tids = torch.full((l, lmax), -1, dtype=_I32, device=dev)
    row_cnt = torch.zeros(l, dtype=_I32, device=dev)
    m = int(m0)
    cmin, cmax, tids = cmin[:m], cmax[:m], tids[:m]
    cnt = torch.ones(m, dtype=_I32, device=dev)
    nid = torch.full((m,), -1, dtype=_I32, device=dev)
    k_int = k_leaf = it = 0
    cap = round_cap(l)
    while m > 1 and it < cap:
        if live is not None:
            live.append(m)
        pos = torch.arange(m, dtype=_I64, device=dev)
        # costs[o-1][p]: union half area of (p, p+o), _BIG past m
        costs = []
        for o in range(1, radius + 1):
            c = torch.full((m,), _BIG, dtype=_F32, device=dev)
            if o < m:
                c[: m - o] = _half_area(
                    torch.minimum(cmin[: m - o], cmin[o:]),
                    torch.maximum(cmax[: m - o], cmax[o:]))
            costs.append(c)
        f_cost = big.expand(m).clone()
        f_off = torch.zeros(m, dtype=_I64, device=dev)
        for o in range(1, radius + 1):
            better = costs[o - 1] < f_cost
            f_cost = torch.where(better, costs[o - 1], f_cost)
            f_off = torch.where(better, o, f_off)
        b_cost = big.expand(m).clone()
        b_off = torch.zeros(m, dtype=_I64, device=dev)
        for o in range(1, radius + 1):
            shifted = torch.cat([big.expand(min(o, m)),
                                 costs[o - 1][: max(m - o, 0)]])
            better = shifted < b_cost
            b_cost = torch.where(better, shifted, b_cost)
            b_off = torch.where(better, o, b_off)
        use_b = b_cost < f_cost
        nn = torch.where(use_b, pos - b_off, pos + f_off).clamp(0, l - 1)
        mutual = nn[nn] == pos
        mg_nn = mutual & (nn > pos)
        ab_nn = mutual & (nn < pos)
        # progress guarantee: past a soft round cap, or on a round with
        # no merge (cost ties), halve by even/odd neighbours instead
        if it >= 128 or not bool(mg_nn.any()):
            mg = (pos % 2 == 0) & (pos + 1 < m)
            absorbed = pos % 2 == 1
            nn = (pos + 1).clamp(max=l - 1)
        else:
            mg, absorbed = mg_nn, ab_nn

        j = torch.where(mg, nn, pos)
        u_min = torch.minimum(cmin, cmin[j])
        u_max = torch.maximum(cmax, cmax[j])
        u_cnt = cnt + torch.where(mg, cnt[j], 0)
        i_leaf = nid < 0
        j_leaf = i_leaf[j]
        stay_leaf = mg & i_leaf & j_leaf & (u_cnt <= lmax)
        make_int = mg & ~stay_leaf

        # leaf rows of the leaf-cluster sides of internal-creating merges
        need_i = make_int & i_leaf
        need_j = make_int & j_leaf
        n_rows = need_i.to(_I64) + need_j.to(_I64)
        r_base = k_leaf + torch.cumsum(n_rows, 0) - n_rows
        row_i = r_base
        row_j = r_base + need_i.to(_I64)
        row_tids[row_i[need_i]] = tids[need_i]
        row_cnt[row_i[need_i]] = cnt[need_i]
        row_tids[row_j[need_j]] = tids[j[need_j]]
        row_cnt[row_j[need_j]] = cnt[j[need_j]]

        # internal records in creation order (children: leaf row r ->
        # (l-1)+r, internal k -> -(k+1))
        ni = make_int.to(_I64)
        k_slot = k_int + torch.cumsum(ni, 0) - ni
        child_i = torch.where(i_leaf, (l - 1) + row_i, -(nid.to(_I64) + 1))
        child_j = torch.where(j_leaf, (l - 1) + row_j,
                              -(nid[j].to(_I64) + 1))
        tgt = k_slot[make_int]
        lk[tgt] = child_i[make_int].to(_I32)
        rk[tgt] = child_j[make_int].to(_I32)
        lvl[tgt] = it
        bmn[tgt] = u_min[make_int]
        bmx[tgt] = u_max[make_int]

        # merged clusters in place (the lower position), then compact
        # the survivors to the front, in order
        m_cnt = cnt
        cmin = torch.where(mg[:, None], u_min, cmin)
        cmax = torch.where(mg[:, None], u_max, cmax)
        cnt = torch.where(mg, u_cnt, cnt)
        tids = torch.where(stay_leaf[:, None],
                           _merge_tids(tids, m_cnt, tids[j], lmax), tids)
        nid = torch.where(make_int, k_slot.to(_I32), nid)
        keep = ~absorbed
        cmin, cmax, cnt, tids, nid = (a[keep] for a in
                                      (cmin, cmax, cnt, tids, nid))
        m = int(cnt.shape[0])
        k_int += int(ni.sum())
        k_leaf += int(n_rows.sum())
        it += 1
    if live is not None:
        live.append(m)
    return (lk, rk, lvl, bmn, bmx, row_tids, row_cnt,
            torch.tensor(k_int, dtype=_I32, device=dev),
            torch.tensor(it, dtype=_I32, device=dev))


def tail_size(lmax: int) -> int:
    """T: the live count at and below which the merge's rounds run in
    one block with the clusters in its shared memory: ``TAIL_SMEM`` over
    44 + 4 * lmax B a cluster (box, count, internal id and id list, then
    the list's home, the nearest neighbour and the plan bits)."""
    return TAIL_SMEM // (44 + 4 * lmax)


def decode_round_log(state: List[int]) -> List[int]:
    """``live`` from the merge's state words (host ints): the live count
    at the start of each round, then the count the loop stopped at."""
    rounds = state[_ST_FINAL + 2]
    return list(state[_ST_LOG:_ST_LOG + rounds]) + [state[_ST_FINAL]]


def _merge_buffers(cmin0, cmax0, tids0, m0: int, l: int, lmax: int):
    """What ``vrt_ploc_merge`` starts from -> (work, state, the seven
    record and leaf-row outputs): the m0 start clusters in the first
    cluster buffer (count 1, internal id -1, home = position), the id
    lists, the first counters [m0, 0, 0], and the output words no round
    writes (zero; -1 ids)."""
    dev = cmin0.device
    tiles = (l + 255) // 256
    # two cluster buffers [cmin (l, 3) | cmax (l, 3) | cnt | nid | home],
    # the id lists by home, nn, code, the tile totals and offsets
    work = torch.empty(20 * l + l * lmax + 9 * tiles, dtype=_I32, device=dev)
    work[: 3 * l].view(_F32).view(l, 3).copy_(cmin0)
    work[3 * l: 6 * l].view(_F32).view(l, 3).copy_(cmax0)
    work[6 * l: 7 * l].fill_(1)
    work[7 * l: 8 * l].fill_(-1)
    torch.arange(l, dtype=_I32, device=dev, out=work[8 * l: 9 * l])
    work[18 * l: 18 * l + l * lmax].view(l, lmax).copy_(tids0)
    state = torch.zeros(_ST_LOG + round_cap(l), dtype=_I32, device=dev)
    state[_ST_CTR:_ST_CTR + 1].fill_(m0)
    lk = torch.zeros(l - 1, dtype=_I32, device=dev)
    rk, lvl = torch.zeros_like(lk), torch.zeros_like(lk)
    bmn = torch.zeros((l - 1, 3), dtype=_F32, device=dev)
    bmx = torch.zeros_like(bmn)
    row_tids = torch.full((l, lmax), -1, dtype=_I32, device=dev)
    row_cnt = torch.zeros(l, dtype=_I32, device=dev)
    return work, state, (lk, rk, lvl, bmn, bmx, row_tids, row_cnt)


def _merge_on_card(cmin0, cmax0, tids0, m0: int, l: int, lmax: int,
                   radius: int, tail: int):
    """One call of ``vrt_ploc_merge`` with the tail from ``tail`` clusters
    down -> (the seven record and leaf-row outputs, the state words on the
    card).  ``_ploc_merge`` passes ``tail_size(lmax)``."""
    lib = kernels.load("ploc_merge")
    work, state, out = _merge_buffers(cmin0, cmax0, tids0, m0, l, lmax)
    # the cooperative grid only when the first round is above the tail
    _launch(lib, "vrt_ploc_merge", cmin0.device, work.data_ptr(),
            state.data_ptr(), *(a.data_ptr() for a in out), m0, l, lmax,
            radius, round_cap(l), tail, n_kernels=2 if m0 > tail else 1)
    return out, state


def _ploc_merge(cmin0, cmax0, tids0, m0: int, l: int, lmax: int,
                radius: int, live: Optional[List[int]] = None):
    """The PLOC merge loop over ``m0`` clusters in Morton order: boxes
    (l, 3) float32, id lists (l, lmax) int32 (sorted slots, -1 padded).
    Returns the JAX package's outputs: per internal in creation order
    ``lk, rk, lvl`` (l-1,) int32 (children: leaf row r -> (l-1)+r,
    internal k -> -(k+1)) and ``bmn, bmx`` (l-1, 3); the leaf rows
    ``row_tids`` (l, lmax), ``row_cnt`` (l,); ``n_int`` and ``n_levels``
    (0-dim int32).  ``live``, when given, receives each round's live
    cluster count and then the count the loop ended with (1, or more when
    it stopped at the round cap).  On the card the loop makes no copy to
    the host; ``live`` costs one."""
    if not _cuda(cmin0):
        return _ploc_merge_ref(cmin0, cmax0, tids0, m0, l, lmax, radius,
                               live)
    dev = cmin0.device
    for name, a, shape in (("cmin0", cmin0, (l, 3)), ("cmax0", cmax0, (l, 3))):
        if a.dtype != _F32 or tuple(a.shape) != shape or a.device != dev:
            raise ValueError(f"{name} must be a float32 {shape} tensor on "
                             f"{dev}")
    _check_i32(dev, tids0=(tids0, (l, lmax)))
    if not (1 <= radius and 1 <= lmax and 1 <= m0 <= l):
        raise ValueError(f"radius {radius}, leaf {lmax}, m0 {m0} out of "
                         f"range")
    if l < 2:
        raise ValueError(f"the merge takes 2 or more clusters, got {l}")
    out, state = _merge_on_card(cmin0, cmax0, tids0, int(m0), l, lmax, radius,
                                tail_size(lmax))
    if live is not None:
        live.extend(decode_round_log(state.tolist()))
    return (*out, state[_ST_FINAL + 1].clone(), state[_ST_FINAL + 2].clone())


# ------------------------------------------------------------------ K4b

def _ploc_parents_ref(lchild, rchild, n_int: int, l: int) -> torch.Tensor:
    """(2l-1,) parent of every node: live internals (old id < n_int)
    scatter themselves onto their children; the rest keep 0."""
    dev = lchild.device
    n = int(n_int)
    i_idx = torch.arange(n, dtype=_I32, device=dev)
    parent = torch.zeros(2 * l - 1, dtype=_I32, device=dev)
    parent[lchild[:n].to(_I64)] = i_idx
    parent[rchild[:n].to(_I64)] = i_idx
    return parent


def _remap_ploc_ref(lk, rk, lvl, bmn, bmx, n_int, l: int):
    """Plain version of the remap: creation order -> the packer's old ids
    (old = n_int-1-k; dead rows n_int.. zero) -> (lchild, rchild, level,
    imin, imax, parent)."""
    dev = lk.device
    n = int(n_int)
    kk = torch.arange(l - 1, dtype=_I64, device=dev)
    tgt = torch.where(kk < n, n - 1 - kk, l - 1)

    def remap(c):
        c = c.to(_I64)
        return torch.where(c >= l - 1, c, n + c)

    def put(src, shape, dtype):
        out = torch.zeros((l,) + shape, dtype=dtype, device=dev)
        out[tgt] = src.to(dtype)
        return out[: l - 1].contiguous()

    lchild = put(remap(lk), (), _I32)
    rchild = put(remap(rk), (), _I32)
    return (lchild, rchild, put(lvl, (), _I32), put(bmn, (3,), _F32),
            put(bmx, (3,), _F32), _ploc_parents_ref(lchild, rchild, n, l))


def _collapse_ploc_ref(lchild, rchild, parent, n_int, l: int, width: int):
    """Plain version: the JAX package's ready propagation from the root
    (``DEPTH_CAP`` rounds), depth-stride survivors, and the 4/8-wide
    child lists where a leaf row (id >= l-1) takes one slot."""
    dev = lchild.device
    n_nodes = 2 * l - 1
    n = int(n_int)
    lchild, rchild = lchild.to(_I64), rchild.to(_I64)
    i_idx = torch.arange(l - 1, dtype=_I64, device=dev)
    vi = i_idx < n
    p = parent[: l - 1].to(_I64).clamp(0, max(l - 2, 0))
    depth = torch.zeros(l - 1, dtype=_I64, device=dev)
    ready = (i_idx == 0) & vi
    it = 0
    while bool(((~ready) & vi).any()) and it < DEPTH_CAP:
        can = vi & ready[p] & ~ready & (i_idx != 0)
        depth = torch.where(can, depth[p] + 1, depth)
        ready = ready | can
        it += 1
    # deepest live internal; DEPTH_CAP + 1 when some were never reached
    unreached = bool(((~ready) & vi).any())
    max_depth = DEPTH_CAP + 1 if unreached else int(depth[vi].max()) if n else 0

    stride = 2 if width == 4 else 3
    surv = vi & ((depth % stride) == 0)
    is_leaf_l = lchild >= l - 1
    is_leaf_r = rchild >= l - 1
    lc_s = lchild.clamp(0, l - 2)
    rc_s = rchild.clamp(0, l - 2)
    a_left = torch.where(is_leaf_l, 1, 2)
    a_right = torch.where(is_leaf_r, 1, 2)
    arity4 = a_left + a_right
    none = torch.full_like(lchild, -1)
    left0 = torch.where(is_leaf_l, lchild, lchild[lc_s])
    left1 = torch.where(is_leaf_l, none, rchild[lc_s])
    right0 = torch.where(is_leaf_r, rchild, lchild[rc_s])
    right1 = torch.where(is_leaf_r, none, rchild[rc_s])

    def slot4(t):
        li = left0 if t == 0 else left1
        u = t - a_left
        ri = torch.where(u == 0, right0, torch.where(u == 1, right1, none))
        return torch.where(t < a_left, li, torch.where(t < arity4, ri, none))

    ch4 = torch.stack([slot4(t) for t in range(4)], 1)
    if width == 4:
        ch_old, arity = ch4, arity4
    else:
        a_l8 = torch.where(is_leaf_l, 1, arity4[lc_s])
        a_r8 = torch.where(is_leaf_r, 1, arity4[rc_s])
        arity = a_l8 + a_r8
        ch4_l, ch4_r = ch4[lc_s], ch4[rc_s]

        def sel4(mtx, t):
            return mtx.gather(1, t.clamp(0, 3).unsqueeze(1)).squeeze(1)

        def slot8(t):
            tt = torch.full_like(lchild, t)
            lt = torch.where(is_leaf_l, lchild if t == 0 else none,
                             sel4(ch4_l, tt))
            u = tt - a_l8
            rt = torch.where(is_leaf_r, torch.where(u == 0, rchild, none),
                             sel4(ch4_r, u))
            return torch.where(tt < a_l8, lt, torch.where(tt < arity, rt, none))

        ch_old = torch.stack([slot8(t) for t in range(8)], 1)

    contrib = torch.where(surv, arity, 0)
    base = 1 + torch.cumsum(contrib, 0) - contrib
    newid = torch.full((n_nodes + 1,), -1, dtype=_I64, device=dev)
    newid[0] = 0
    for t in range(width):
        idx = ch_old[:, t]
        ok = surv & (idx >= 0)
        # (index n_nodes is a spare slot: the JAX scatter's mode="drop")
        newid[torch.where(ok, idx, n_nodes)] = torch.where(ok, base + t, -1)
    return (surv, ch_old.to(_I32), arity.to(_I32), base.to(_I32),
            newid[:n_nodes].to(_I32),
            torch.tensor(max_depth, dtype=_I32, device=dev))


def _remap_collapse_ploc(lk, rk, lvl, bmn, bmx, n_int, l: int, width: int):
    """The merge's records in creation order -> the packer's old ids and
    the depth-stride wide collapse: (lchild, rchild, level, imin, imax,
    parent) as ``_remap_ploc_ref`` gives them (old = n_int-1-k: the root,
    created last, is 0; dead rows n_int.. zero; ``parent`` (2l-1,) as
    ``LBVHTopo`` keeps it, unused leaf rows and the root 0), then (surv,
    ch_old, arity, base, newid) as the JAX package's ``_collapse_ploc``
    and the deepest live internal's binary depth (0-dim int32;
    DEPTH_CAP + 1 when the JAX propagation would not reach it), as
    ``_collapse_ploc_ref`` gives them.  On the card one cooperative
    launch writes every word of outputs allocated unfilled."""
    if width not in (4, 8):
        raise ValueError(f"unsupported BVH width {width}")
    if not _cuda(lk):
        rm = _remap_ploc_ref(lk, rk, lvl, bmn, bmx, n_int, l)
        return (*rm, *_collapse_ploc_ref(rm[0], rm[1], rm[5], n_int, l,
                                         width))
    lib = kernels.load("ploc_collapse")
    dev = lk.device
    _check_i32(dev, lk=(lk, (l - 1,)), rk=(rk, (l - 1,)),
               lvl=(lvl, (l - 1,)), n_int=(n_int, ()))
    bmn, bmx = bmn.contiguous(), bmx.contiguous()
    n, m = l - 1, 2 * l - 1

    def i32(*shape):
        return torch.empty(shape, dtype=_I32, device=dev)

    lchild, rchild, level, arity, base = (i32(n) for _ in range(5))
    imin, imax = (torch.empty((n, 3), dtype=_F32, device=dev)
                  for _ in range(2))
    parent, newid, ch_old, max_depth = i32(m), i32(m), i32(n, width), i32()
    surv = torch.empty(n, dtype=torch.bool, device=dev)
    out = (lchild, rchild, level, imin, imax, parent, surv, ch_old, arity,
           base, newid, max_depth)
    totals = i32((n + 255) // 256)   # a block's survivors' arities
    _launch(lib, "vrt_ploc_remap_collapse", dev, lk.data_ptr(),
            rk.data_ptr(), lvl.data_ptr(), bmn.data_ptr(), bmx.data_ptr(),
            n_int.data_ptr(), l, width, *(a.data_ptr() for a in out),
            totals.data_ptr())
    return out


# ------------------------------------------------------------------ K4c

def _row_boxes_ref(v0, v1, v2, order, row_tids, row_cnt):
    t = v0.shape[0]
    tmin = torch.minimum(torch.minimum(v0, v1), v2)
    tmax = torch.maximum(torch.maximum(v0, v1), v2)
    lmax = row_tids.shape[1]
    k = torch.arange(lmax, dtype=_I64, device=v0.device)
    valid = (k[None, :] < row_cnt.to(_I64)[:, None])[..., None]
    tri = order.to(_I64)[row_tids.to(_I64).clamp(0, t - 1)]
    big = torch.tensor(_BIG, dtype=_F32, device=v0.device)
    bmin = torch.where(valid, tmin[tri], big).amin(1)
    bmax = torch.where(valid, tmax[tri], -big).amax(1)
    return bmin, bmax


def _box_launch(v0, v1, v2, order, leaf_tids, row_cnt, bmin, bmax,
                climb=None) -> None:
    """One launch of ``csrc/ploc_refit.cu``: leaf-row boxes into
    ``bmin``/``bmax`` at row offset 0 (``climb`` None) or l-1 with the
    climb over ``climb`` = (lchild, rchild, parent, n_int, arrived), the
    zeros of the internals never created written too."""
    l = v0.shape[0]
    lmax = leaf_tids.shape[1]
    lib = kernels.load("ploc_refit")
    dev = v0.device
    v0, v1, v2 = (v.contiguous() for v in (v0, v1, v2))
    _check_i32(dev, order=(order, (l,)), leaf_tids=(leaf_tids, (l, lmax)),
               row_cnt=(row_cnt, (l,)))
    ptrs = (0,) * 5 if climb is None else tuple(a.data_ptr() for a in climb)
    _launch(lib, "vrt_ploc_boxes", dev, v0.data_ptr(), v1.data_ptr(),
            v2.data_ptr(), order.data_ptr(), leaf_tids.data_ptr(),
            row_cnt.data_ptr(), l, lmax, *ptrs, bmin.data_ptr(),
            bmax.data_ptr())


def _row_boxes(v0, v1, v2, order, row_tids, row_cnt):
    """(l, 3) min and max box of each leaf row from its explicit sorted
    slots; unused rows get (_BIG, -_BIG), a box that never wins a
    union."""
    l = _check_verts(v0, v1, v2)
    if not _cuda(v0):
        return _row_boxes_ref(v0, v1, v2, order, row_tids, row_cnt)
    bmin = torch.empty((l, 3), dtype=_F32, device=v0.device)
    bmax = torch.empty_like(bmin)
    _box_launch(v0, v1, v2, order, row_tids, row_cnt, bmin, bmax)
    return bmin, bmax


def _refit_boxes_ploc_ref(ptopo: PLOCTopo, v0, v1, v2):
    topo = ptopo.topo
    l = v0.shape[0]
    cmin, cmax = _row_boxes_ref(v0, v1, v2, topo.order, ptopo.leaf_tids,
                                topo.row_cnt)
    vi = torch.arange(l - 1, device=v0.device) < ptopo.n_int
    imin = torch.zeros((l - 1, 3), dtype=_F32, device=v0.device)
    imax = torch.zeros_like(imin)

    def child_box(c, imn, imx):
        c = c.to(_I64)
        leaf = (c >= l - 1)[:, None]
        ci = (c - (l - 1)).clamp(0, l - 1)
        cc = c.clamp(0, l - 2)
        return (torch.where(leaf, cmin[ci], imn[cc]),
                torch.where(leaf, cmax[ci], imx[cc]))

    # children are created in strictly earlier rounds: ascending
    # creation level is bottom-up
    for lev in range(int(ptopo.n_levels)):
        at = (vi & (ptopo.level == lev))[:, None]
        lmn, lmx = child_box(topo.lchild, imin, imax)
        rmn, rmx = child_box(topo.rchild, imin, imax)
        imin = torch.where(at, torch.minimum(lmn, rmn), imin)
        imax = torch.where(at, torch.maximum(lmx, rmx), imax)
    return torch.cat([imin, cmin]), torch.cat([imax, cmax])


def _refit_boxes_ploc(ptopo: PLOCTopo, v0, v1, v2):
    """Boxes of every node -> ((2l-1, 3) bmin, bmax) in old ids
    (internals, dead ones zero; then the leaf rows): the plain version
    sweeps by creation level as the JAX package does, the kernel climbs
    the parents, in one launch into outputs allocated unfilled; min and
    max make both equal to the bit.  The climb's counters are made zero
    at a topology's first refit and kept in ``topo_state``: the kernel
    leaves them zero.  A launch that raises drops them, so the next
    refit starts from new zeros (ROADMAP hazard H18)."""
    l = _check_verts(v0, v1, v2)
    topo = ptopo.topo
    if not _cuda(v0):
        return _refit_boxes_ploc_ref(ptopo, v0, v1, v2)
    dev = v0.device
    _check_i32(dev, lchild=(topo.lchild, (l - 1,)),
               rchild=(topo.rchild, (l - 1,)),
               parent=(topo.parent, (2 * l - 1,)), n_int=(ptopo.n_int, ()))
    st = topo_state(topo)
    if st.ploc_arrived is None:
        st.ploc_arrived = torch.zeros(l - 1, dtype=_I32, device=dev)
    bmin = torch.empty((2 * l - 1, 3), dtype=_F32, device=dev)
    bmax = torch.empty_like(bmin)
    try:
        _box_launch(v0, v1, v2, topo.order, ptopo.leaf_tids, topo.row_cnt,
                    bmin, bmax, climb=(topo.lchild, topo.rchild, topo.parent,
                                       ptopo.n_int, st.ploc_arrived))
    except RuntimeError:
        st.ploc_arrived = None
        raise
    return bmin, bmax


# ---------------------------------------------------------- entry points

def _pack(ptopo: PLOCTopo, bmin, bmax, v0, v1, v2, leaf_size: int,
          width: int) -> LBVHNodes:
    topo = ptopo.topo
    nodes, rows, fz = _pack_rows(topo, bmin, bmax, v0, v1, v2, leaf_size,
                                 width, fused=width == 8,
                                 leaf_tids=ptopo.leaf_tids)
    return LBVHNodes(nodes=nodes, tri_rows=rows,
                     num_leaves=topo_state(topo).num_leaves, fused=fz)


def seed_clusters(v0, v1, v2, leaf_size: int):
    """The merge loop's start: (order, cmin0, cmax0, tids0) — the Morton
    order of the triangles (int32), and one cluster per triangle in that
    order, with its box and its id list (its sorted slot, then -1; the
    refit re-gathers moved vertices through ``order``)."""
    l = v0.shape[0]
    order = torch.sort(scene_codes(v0, v1, v2)[0], stable=True)[1].to(_I32)
    o = order.to(_I64)
    tmin = torch.minimum(torch.minimum(v0, v1), v2)[o]
    tmax = torch.maximum(torch.maximum(v0, v1), v2)[o]
    tids0 = torch.full((l, leaf_size), -1, dtype=_I32, device=v0.device)
    tids0[:, 0] = torch.arange(l, dtype=_I32, device=v0.device)
    return order, tmin, tmax, tids0


def build_ploc_topo(v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor,
                    leaf_size: int = 4, width: int = 4, radius: int = 16
                    ) -> Tuple[LBVHNodes, PLOCTopo]:
    """Device PLOC build over (T, 3) float32 vertices -> (LBVHNodes,
    PLOCTopo) on the vertices' device.  The Morton order seeds the
    neighbour window only; every split and every leaf is chosen by the
    clustering.  8-wide tables come with their fused rows."""
    l = _check_verts(v0, v1, v2)
    if width not in (4, 8):
        raise ValueError(f"unsupported BVH width {width}")
    if l <= leaf_size:
        raise ValueError("scene smaller than one leaf")
    if radius < 1:
        raise ValueError(f"radius must be >= 1, got {radius}")
    dev = v0.device
    order, tmin, tmax, tids0 = seed_clusters(v0, v1, v2, leaf_size)
    (lk, rk, lvl, bmn, bmx, row_tids, row_cnt, n_int,
     n_levels) = _ploc_merge(tmin, tmax, tids0, l, l, leaf_size, radius)
    (lchild, rchild, level, imin, imax, parent, surv, ch_old, arity, base,
     newid, max_depth) = _remap_collapse_ploc(lk, rk, lvl, bmn, bmx, n_int,
                                              l, width)
    zi = torch.zeros(l, dtype=_I32, device=dev)
    topo = LBVHTopo(order=order, lchild=lchild, rchild=rchild, surv=surv,
                    ch_old=ch_old, arity=arity, base=base, newid=newid,
                    row_lo=zi, row_cnt=row_cnt, leaf_newid=newid[l - 1:],
                    lo=zi[: l - 1], hi=zi[: l - 1], parent=parent)
    ptopo = PLOCTopo(topo=topo, leaf_tids=row_tids, level=level,
                     n_int=n_int, n_levels=n_levels,
                     wide_depth=wide_depth_of(max_depth, width))
    cmin, cmax = _row_boxes(v0, v1, v2, order, row_tids, row_cnt)
    return _pack(ptopo, torch.cat([imin, cmin]), torch.cat([imax, cmax]),
                 v0, v1, v2, leaf_size, width), ptopo


def refit_ploc(ptopo: PLOCTopo, v0, v1, v2, leaf_size: int = 4,
               width: int = 4) -> LBVHNodes:
    """Keep the PLOC topology, recompute every box, requantize and
    repack (full pools, as the JAX package's): the per-frame update of
    a moving mesh.  8-wide tables come with their fused rows.  Nothing
    is copied to the host on the card."""
    bmin, bmax = _refit_boxes_ploc(ptopo, v0, v1, v2)
    return _pack(ptopo, bmin, bmax, v0, v1, v2, leaf_size, width)


def wide_arrays_from_ploc(lb: LBVHNodes, ptopo: PLOCTopo,
                          leaf_size: int = 4, width: int = 4) -> WideArrays:
    """``wide_arrays_from_lbvh`` with the depth the tree really has: a
    PLOC tree's depth is not bounded by the Morton key's length, so
    ``depth`` is the larger of the LBVH bound and the collapsed tree's
    depth (one scalar read), and a tree the card's walk cannot hold
    raises here rather than overflowing its stack (ROADMAP H8)."""
    wa = wide_arrays_from_lbvh(lb, leaf_size, width=width)
    real = int(ptopo.wide_depth)
    wa = dataclasses.replace(wa, depth=max(wa.depth, real))
    walk = traverse_packet if width == 8 else packet_walk
    cap = walk.STACK_MAX
    if walk.stack_entries(wa) > cap:
        raise ValueError(f"the PLOC tree is {real} levels deep; a "
                         f"{width}-wide walk on the card holds {cap} stack "
                         f"entries, it needs {walk.stack_entries(wa)}")
    return wa


def build_wide_ploc(sb, leaf_size: int = 4, width: int = 4,
                    radius: int = 16, *, device) -> WideArrays:
    """Scene buffers -> traversal-ready ``WideArrays`` via the on-device
    PLOC build, on ``device`` (the contract of
    ``lbvh.build_wide_from_tris``); 8-wide tables come fused.  For
    scenes of one identity instance."""
    if not (sb.inst_transform.shape[0] == 1
            and np.allclose(sb.inst_transform[0], np.eye(4))):
        raise ValueError("LBVH direct build needs a single identity instance")
    v0, v1, v2 = (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for v in pad_tris(sb.v0, sb.v1, sb.v2, leaf_size))
    lb, ptopo = build_ploc_topo(v0, v1, v2, leaf_size=leaf_size,
                                width=width, radius=radius)
    return wide_arrays_from_ploc(lb, ptopo, leaf_size, width)
