"""4-, 8- and 16-wide packed node and leaf tables (port of
``WideArrays``, ``WideArrays.from_scene`` and ``WideArrays.fuse`` of
``vortex_rt_tpu/ops/traverse_wide.py``).

The tables are built on the host with NumPy, bit-identical to the JAX
package's, and held as torch tensors:

* ``nodes`` (N, W) int32 — one row per node of ``row_words(width)``
  words (W = 32, 128 B, at widths 4 and 8; 40, 160 B, at width 16), the
  u32 words stored as int32: words 0..2 fp32 origin, 3..5 fp32
  power-of-two scale, then per-child quantized lo / hi boxes (3 bytes
  each), the meta word and the leaf count at the offsets of
  ``row_layout(width)``:

  ========  ======  ======  =====  =====  ===========================
  width     lo      hi      meta   leaf   meta word
  ========  ======  ======  =====  =====  ===========================
  4         6..9    10..13  14     15     left | nchild<<26 | kind<<29
  8         6..13   14..21  22     23     left | nchild<<25 | kind<<29
  16        6..21   22..37  38     39     left | nchild<<24 | kind<<29
  ========  ======  ======  =====  =====  ===========================

  4-wide instance nodes carry their inverse transform in words 16..27
  and their BLAS root in word 28 (8- and 16-wide builds are flat: no
  instance nodes).  Float fields are read through
  ``nodes.view(torch.float32)``.
* ``tri_rows`` (L, 16*lmax) float32 — one row per triangle leaf, up to
  lmax slots of (v0, e1, e2, tid bits, pad) 16 floats.  Flat builds pack
  the tid as ``(inst << tri_bits) | tri``.
* ``fused`` (N, W + 16*lmax) int32, flat builds only (``fuse()``):
  each node row followed by its own leaf slots (zeros for internal
  nodes), so one row read serves both node kinds.
* ``alpha_rows`` (L, 8*lmax) float32 and ``alpha_pool`` (X + M,) float32
  (``with_alpha(sb)``, for alpha-cutout any-hit inside the walk): per
  leaf slot the triangle's uv triple, its texture's offset in the pool
  and ``tw << 16 | th`` (bits); the pool holds the luminance of every
  texel, then of every material's diffuse colour (an untextured
  material reads as a 1x1 texture).  A fused table built with them
  carries each leaf's alpha fields after its triangle slots:
  (N, W + 24*lmax) words.

The 4-wide walk over ``nodes``/``tri_rows`` is ``ops/packet_walk.py``
(K2); the 8- and 16-wide walks over ``fused`` are
``ops/traverse_packet.py`` (K1); both test the alpha cutout in the walk
when asked.  The per-ray walk with a restart trail and any-hit
suspension (``trace_lanes`` and ``commit``, K3) is below; its kernel is
``csrc/traverse_wide.cu``.  The on-device builds (``accel/lbvh.py``,
``accel/ploc.py``) and the scene shards write 4- and 8-wide rows only, as
the JAX package's do: 16-wide tables are built on the host.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vortex_rt_tpu_torch.accel import qbvh
from vortex_rt_tpu_torch.models.scene import SceneBuffers
from vortex_rt_tpu_torch.ops.traverse2 import Hits, PerfCounters
from vortex_rt_tpu_torch.runtime import kernels
from vortex_rt_tpu_torch.utils.config import (
    COMMIT_ACCEPT, COMMIT_TERM, LARGE_FLOAT, MT_EPSILON,
)

WIDTH = 4
# words of a node row at widths 4 and 8 (the on-device builds, the scene
# shards and the bridge's 4- and 8-wide tables); row_words(width) for any
ROW_WORDS = 32
# 4-wide meta word layout (word 14): left_first | nchild << 26 | kind << 29
LEFT_BITS = 26
LEFT_MASK = (1 << LEFT_BITS) - 1
QLO, QHI, META, LEAF = 6, 10, 14, 15
INST_XFORM, INST_ROOT = 16, 28
# 8-wide meta word (word 22): left_first | nchild << 25 | kind << 29
LEFT_BITS8 = 25
# 16-wide meta word (word 38): left_first | nchild << 24 | kind << 29
# (nchild takes 5 bits; left_first 24 bits, 16M nodes)
LEFT_BITS16 = 24
# (left_first bits, nchild mask) of the meta word, and words of a node
# row, by width
_META_BITS = {4: (LEFT_BITS, 7), 8: (LEFT_BITS8, 15), 16: (LEFT_BITS16, 31)}
_ROW_WORDS = {4: 32, 8: 32, 16: 40}


def row_layout(width: int):
    """(qlo_off, qhi_off, meta_off, leaf_off, base) of a packed node row:
    ``base`` is the first word after the node fields (a fused row's leaf
    slots start there at widths 8 and 16)."""
    if width == 4:
        return QLO, QHI, META, LEAF, 16
    if width == 8:
        return 6, 14, 22, 23, 24
    if width == 16:
        return 6, 22, 38, 39, 40
    raise ValueError(f"no row layout for width {width}")


def row_words(width: int) -> int:
    """Words of a packed node row: 32 at widths 4 and 8, 40 at 16."""
    if width not in _ROW_WORDS:
        raise ValueError(f"no row layout for width {width}")
    return _ROW_WORDS[width]


def left_bits(width: int) -> int:
    """Bits of left_first in the meta word (nchild sits above them)."""
    return _META_BITS[width][0]


def nchild_mask(width: int) -> int:
    """Mask of the meta word's child count, above its left_first bits."""
    return _META_BITS[width][1]


def fuse_rows(nodes: torch.Tensor, tri_rows: torch.Tensor,
              width: int, alpha_rows: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """(N, W + 16*lmax) int32 (W = ``row_words(width)``): each node row
    of a flat build followed by its own leaf slots (zeros for internal
    nodes), and by its leaf's alpha fields when ``alpha_rows`` is given:
    (N, W + 24*lmax)."""
    meta = nodes[:, row_layout(width)[2]]
    kind = (meta >> 29) & 7
    left = (meta & ((1 << left_bits(width)) - 1)).to(torch.int64)
    is_tris = (kind == qbvh.KIND_TRIS).unsqueeze(1)
    parts = [nodes]
    for rows in (tri_rows, alpha_rows):
        if rows is None:
            continue
        rows = rows.view(torch.int32)
        own = rows[left.clamp(0, rows.shape[0] - 1)]
        parts.append(torch.where(is_tris, own, torch.zeros_like(own)))
    return torch.cat(parts, 1).contiguous()


@dataclasses.dataclass
class WideArrays:
    """Packed wide TLAS+BLAS pool + slot-ordered triangle rows."""

    nodes: torch.Tensor     # (N, row_words(width)) int32 node records
    tri_rows: torch.Tensor  # (L, 16*lmax) float32 leaf rows
    num_tlas: int           # nodes [0, num_tlas) are TLAS nodes
    max_leaf_tris: int      # triangles tested per leaf row
    depth: int              # max descend depth (TLAS + BLAS)
    tri_bits: int = 0       # flat builds: leaf tids pack (inst << bits) | tri
    width: int = WIDTH
    fused: Optional[torch.Tensor] = None  # (N, W + 16*lmax) int32,
                                          # + 8*lmax with alpha fields
    alpha_rows: Optional[torch.Tensor] = None  # (L, 8*lmax) float32
    alpha_pool: Optional[torch.Tensor] = None  # (X + M,) float32

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def _tables(self):
        return (self.nodes, self.tri_rows, self.fused, self.alpha_rows,
                self.alpha_pool)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._tables()
                   if t is not None)

    def to(self, device) -> "WideArrays":
        def mv(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, nodes=self.nodes.to(device),
            tri_rows=self.tri_rows.to(device), fused=mv(self.fused),
            alpha_rows=mv(self.alpha_rows), alpha_pool=mv(self.alpha_pool))

    def fuse(self) -> "WideArrays":
        """A copy with the fused node+leaf table built (flat builds
        only), word for word the JAX package's ``WideArrays.fuse``: with
        the alpha fields when the tables carry them."""
        if not (self.num_tlas == 0 and self.tri_bits > 0):
            raise ValueError("fused rows require the flattened build")
        return dataclasses.replace(
            self, fused=fuse_rows(self.nodes, self.tri_rows, self.width,
                                  self.alpha_rows))

    # ---- host-side unpacked views of the node rows (tests, debugging),
    # the JAX package's, as NumPy arrays of the same dtypes ----
    def _words(self) -> np.ndarray:
        """(N, W) the node rows' words as uint32 on the host."""
        return self.nodes.cpu().numpy().view(np.uint32)

    @property
    def kind(self) -> np.ndarray:
        meta = self._words()[:, row_layout(self.width)[2]]
        return (meta >> 29).astype(np.int32)

    @property
    def nchild(self) -> np.ndarray:
        meta = self._words()[:, row_layout(self.width)[2]]
        return ((meta >> left_bits(self.width)) & nchild_mask(self.width)
                ).astype(np.int32)

    @property
    def left_first(self) -> np.ndarray:
        meta = self._words()[:, row_layout(self.width)[2]]
        return (meta & ((1 << left_bits(self.width)) - 1)).astype(np.int32)

    @property
    def leaf_data(self) -> np.ndarray:
        return self._words()[:, row_layout(self.width)[3]].view(np.int32)

    @property
    def origin(self) -> np.ndarray:
        return np.ascontiguousarray(self._words()[:, 0:3]).view(np.float32)

    @property
    def scale(self) -> np.ndarray:
        return np.ascontiguousarray(self._words()[:, 3:6]).view(np.float32)

    def _quant(self, lo: int, hi: int) -> np.ndarray:
        q = self._words()[:, lo:hi]
        return np.stack([(q >> s) & 255 for s in (0, 8, 16)], axis=-1
                        ).reshape(-1, self.width * 3).astype(np.uint8)

    @property
    def qlo(self) -> np.ndarray:
        qoff, hoff = row_layout(self.width)[:2]
        return self._quant(qoff, hoff)

    @property
    def qhi(self) -> np.ndarray:
        _, hoff, moff = row_layout(self.width)[:3]
        return self._quant(hoff, moff)

    @property
    def leaf_tids(self) -> np.ndarray:
        """(L, slots) global triangle id of each leaf slot (-1 = empty;
        packed ``inst << tri_bits | tri`` on flat builds)."""
        r = self.tri_rows.cpu().numpy()
        return np.stack([r[:, 16 * c + 9] for c in range(r.shape[1] // 16)],
                        axis=1).view(np.int32)

    def with_alpha(self, sb: SceneBuffers) -> "WideArrays":
        """A copy with the alpha-cutout tables (host-side NumPy, word for
        word the JAX package's ``WideArrays.with_alpha``), fused again when
        the tables are fused.

        The alpha of a candidate hit is the luminance of the surface
        colour ``shade_point`` computes there (the point-sampled texel,
        or the material's diffuse colour when untextured), in the same
        float32 operations, so a walk that tests it decides as
        ``alpha_test_anyhit`` does through the suspension protocol."""
        lum = (np.float32(0.2126), np.float32(0.7152), np.float32(0.0722))
        texels = np.asarray(sb.texels).astype(np.uint32)
        s = np.float32(1.0 / 256.0)
        tr = ((texels >> 16) & 255).astype(np.float32) * s
        tg = ((texels >> 8) & 255).astype(np.float32) * s
        tb = (texels & 255).astype(np.float32) * s
        a_tex = lum[0] * tr + lum[1] * tg + lum[2] * tb
        md = np.asarray(sb.mat_diffuse, np.float32)
        a_mat = lum[0] * md[:, 0] + lum[1] * md[:, 1] + lum[2] * md[:, 2]
        pool = np.concatenate([a_tex, a_mat]).astype(np.float32)
        n_tex = int(texels.shape[0])

        tids = self.leaf_tids
        lmax = tids.shape[1]
        tri = tids & ((1 << self.tri_bits) - 1) if self.tri_bits else tids
        tri = np.clip(tri, 0, sb.v0.shape[0] - 1)
        mat = np.asarray(sb.mat_id)[tri]
        toff = np.asarray(sb.mat_tex_offset)[mat].astype(np.int64)
        has_tex = toff >= 0
        tw = np.where(has_tex, np.asarray(sb.mat_tex_w)[mat], 1)
        th = np.where(has_tex, np.asarray(sb.mat_tex_h)[mat], 1)
        toff = np.where(has_tex, toff, n_tex + mat).astype(np.int32)
        # empty slots point at material 0's constant; no walk reads them
        rows = np.zeros((tids.shape[0], 8 * lmax), np.float32)
        uv0 = np.asarray(sb.uv0, np.float32)
        uv1 = np.asarray(sb.uv1, np.float32)
        uv2 = np.asarray(sb.uv2, np.float32)
        for c in range(lmax):
            rows[:, 8 * c + 0: 8 * c + 2] = uv0[tri[:, c]]
            rows[:, 8 * c + 2: 8 * c + 4] = uv1[tri[:, c]]
            rows[:, 8 * c + 4: 8 * c + 6] = uv2[tri[:, c]]
            rows[:, 8 * c + 6] = toff[:, c].view(np.float32)
            rows[:, 8 * c + 7] = ((tw[:, c].astype(np.int32) << 16)
                                  | th[:, c].astype(np.int32)).view(
                                      np.float32)
        dev = self.device
        out = dataclasses.replace(
            self, alpha_rows=torch.from_numpy(rows).to(dev),
            alpha_pool=torch.from_numpy(pool).to(dev))
        if self.fused is not None:
            out = out.fuse()
        return out

    @staticmethod
    def from_scene(sb: SceneBuffers, width: int = WIDTH) -> "WideArrays":
        """Build the tables on the CPU (move them with ``.to(device)``).
        Widths 8 and 16 need the flattened build; a 16-wide pool holds
        fewer than 2**24 nodes (the walk's 24-bit node ids)."""
        if width not in (4, 8, 16):
            raise ValueError(f"unsupported BVH width {width}")
        flat = bool(sb.flat)
        if width != 4 and not flat:
            raise ValueError("8/16-wide nodes require the flattened build "
                             "(RTConfig.flatten)")
        tri_bits = 0
        if flat:
            # ONE world-space BLAS, no TLAS/instance nodes; leaf tids pack
            # (inst << tri_bits) | tri so hits keep per-instance ids
            wb = qbvh.collapse_flat(
                sb.bvh_min, sb.bvh_max, sb.bvh_left, sb.bvh_count,
                roots=[0], leaf_kind=qbvh.KIND_TRIS, width=width,
            )
            k = 0
            origin = wb.origin.astype(np.float32)
            scale = wb.scale.astype(np.float32)
            qlo = wb.qlo.astype(np.uint32)
            qhi = wb.qhi.astype(np.uint32)
            nchild = wb.nchild.astype(np.uint32)
            kind = wb.kind.astype(np.uint32)
            left = wb.left_first.astype(np.int64)
            leaf = wb.leaf_data.astype(np.int64)
            depth = int(wb.depth)
            t = int(sb.v0.shape[0])
            tri_bits = max(int(np.ceil(np.log2(max(t, 2)))), 1)
            n_inst = int(sb.inst_bvh_root.shape[0])
            if ((n_inst - 1) << tri_bits) | (t - 1) >= (1 << 31):
                raise ValueError(
                    "inst << tri_bits exceeds the i32 leaf-id budget")
            tid_pack = ((sb.tri_inst.astype(np.int64) << tri_bits)
                        | np.arange(t, dtype=np.int64)).astype(np.int32)
        else:
            # wide TLAS over the binary TLAS (leaves -> instance ids)
            wt = qbvh.collapse_flat(
                sb.tlas_min, sb.tlas_max, sb.tlas_left, sb.tlas_count,
                roots=[0], leaf_kind=qbvh.KIND_INSTANCE,
                leaf_payload=sb.tlas_inst_idx,
            )
            # wide BLAS pool over the packed per-mesh binary trees
            mesh_roots = sorted(set(int(r) for r in sb.inst_bvh_root))
            wb = qbvh.collapse_flat(
                sb.bvh_min, sb.bvh_max, sb.bvh_left, sb.bvh_count,
                roots=mesh_roots, leaf_kind=qbvh.KIND_TRIS,
            )
            k = wt.num_nodes
            root_of = {r: int(wb.roots[i]) + k
                       for i, r in enumerate(mesh_roots)}
            inst_root = np.asarray(
                [root_of[int(r)] for r in sb.inst_bvh_root], np.int32)

            def cat(a, b):
                return np.concatenate([a, b])

            origin = cat(wt.origin, wb.origin).astype(np.float32)
            scale = cat(wt.scale, wb.scale).astype(np.float32)
            qlo = cat(wt.qlo, wb.qlo).astype(np.uint32)
            qhi = cat(wt.qhi, wb.qhi).astype(np.uint32)
            nchild = cat(wt.nchild, wb.nchild).astype(np.uint32)
            kind = cat(wt.kind, wb.kind).astype(np.uint32)
            left = cat(
                wt.left_first,
                np.where(wb.kind == qbvh.KIND_INTERNAL,
                         wb.left_first + k, wb.left_first),
            ).astype(np.int64)
            leaf = cat(wt.leaf_data, wb.leaf_data).astype(np.int64)
            depth = int(wt.depth + wb.depth)
        n = origin.shape[0]

        max_leaf = max(int(sb.bvh_count.max()), 1)

        # ---- one packed row per triangle leaf ----
        is_leaf = kind == qbvh.KIND_TRIS
        leaf_ids = np.nonzero(is_leaf)[0]
        n_leaves = max(len(leaf_ids), 1)
        first = left[leaf_ids].astype(np.int64)
        cnt = leaf[leaf_ids].astype(np.int64)
        lmax = max(max_leaf, 4)
        slots = np.clip(first[:, None] + np.arange(lmax)[None, :], 0,
                        sb.bvh_tri_idx.shape[0] - 1)
        valid = np.arange(lmax)[None, :] < cnt[:, None]
        tid = sb.bvh_tri_idx[slots].astype(np.int32)
        tid_out = tid_pack[tid] if flat else tid  # packed (inst|tri) ids
        v0 = sb.v0[tid]
        e1 = sb.v1[tid] - v0
        e2 = sb.v2[tid] - v0
        zero = ~valid[..., None]
        v0 = np.where(zero, 0.0, v0)
        e1 = np.where(zero, 0.0, e1)  # degenerate: |a| < eps, never hits
        e2 = np.where(zero, 0.0, e2)
        tri_rows = np.zeros((n_leaves, 16 * lmax), np.float32)
        for c in range(lmax):
            tri_rows[: len(leaf_ids), 16 * c : 16 * c + 3] = v0[:, c]
            tri_rows[: len(leaf_ids), 16 * c + 3 : 16 * c + 6] = e1[:, c]
            tri_rows[: len(leaf_ids), 16 * c + 6 : 16 * c + 9] = e2[:, c]
            tri_rows[: len(leaf_ids), 16 * c + 9] = np.where(
                valid[:, c], tid_out[:, c], -1).astype(np.int32).view(np.float32)
        # rebase tri-leaf left_first to the leaf-row index
        leaf_row_of = np.zeros(n, np.int64)
        leaf_row_of[leaf_ids] = np.arange(len(leaf_ids))
        left = np.where(is_leaf, leaf_row_of, left)
        lb = left_bits(width)
        if not ((left >= 0).all() and (left < (1 << lb)).all()):
            raise ValueError(
                f"node/leaf pool exceeds the {lb}-bit left_first budget")
        if width == 16 and n >= 1 << LEFT_BITS16:
            raise ValueError(f"a 16-wide pool of {n} nodes exceeds the "
                             f"walk's {LEFT_BITS16}-bit node ids")

        qoff, hoff, moff, loff, _ = row_layout(width)
        nodes = np.zeros((n, row_words(width)), np.uint32)
        nodes[:, 0:3] = origin.view(np.uint32)
        nodes[:, 3:6] = scale.view(np.uint32)
        for c in range(width):
            nodes[:, qoff + c] = (qlo[:, 3 * c] | (qlo[:, 3 * c + 1] << 8)
                                  | (qlo[:, 3 * c + 2] << 16))
            nodes[:, hoff + c] = (qhi[:, 3 * c] | (qhi[:, 3 * c + 1] << 8)
                                  | (qhi[:, 3 * c + 2] << 16))
        nodes[:, moff] = (left.astype(np.uint32)
                          | (nchild << lb) | (kind << 29))
        nodes[:, loff] = leaf.astype(np.uint32)
        if not flat:
            # instance leaves carry their inverse transform + BLAS root
            is_inst = kind == qbvh.KIND_INSTANCE
            iids = left[is_inst].astype(np.int64)
            nodes[is_inst, INST_XFORM:INST_ROOT] = \
                sb.inst_inv_transform[iids, :3, :].reshape(-1, 12) \
                .astype(np.float32).view(np.uint32)
            nodes[is_inst, INST_ROOT] = inst_root[iids].view(np.uint32)

        return WideArrays(
            nodes=torch.from_numpy(nodes.view(np.int32)),
            tri_rows=torch.from_numpy(tri_rows),
            num_tlas=int(k),
            max_leaf_tris=max_leaf,
            depth=depth,
            tri_bits=tri_bits,
            width=width,
        )


# ---------------------------------------------------------------------------
# K3: the per-ray walk with a restart trail, a short stack and any-hit
# suspension (port of ``trace_lanes`` and ``commit``)
# ---------------------------------------------------------------------------

# trail: 4 bits a level, 8 levels per u32 word, 8 words = 64 levels
TRAIL_WORDS = 8
TRAIL_LEVELS = 8 * TRAIL_WORDS
STACK_ENTRIES = 5               # the short stack (ShortStack<., 5>)
LAST_FLAG = 1 << 30             # a stack entry's 'last deferred child' bit
ID_MASK = (1 << 30) - 1
MAX_LANE_STEPS = 200_000        # per-ray cap on steps (never reached)
_U32_ALL = 0xFFFFFFFF
_INT_MAX32 = 2**31 - 1
_MISS_KEY = -LARGE_FLOAT        # sort key of a culled child (desc sort)
_SORT_NET4 = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))  # descending


class WideState(NamedTuple):
    """Per-ray walk state of ``trace_lanes``, every field an (R,) tensor:
    where the ray stands (node, level, the trail words ``tr0..tr7`` as
    int32 bits, the short stack ``s0..s4`` with ``s0`` on top and its
    count), its instance-space ray, its best hit, the any-hit barrier
    and pending hit, whether it is suspended or done, and the counts of
    the steps it took (``nodes_visited``) and the triangles it tested.
    The JAX package's ``WideState`` less its loop counter ``steps``."""

    node: torch.Tensor
    level: torch.Tensor
    tr0: torch.Tensor; tr1: torch.Tensor; tr2: torch.Tensor
    tr3: torch.Tensor; tr4: torch.Tensor; tr5: torch.Tensor
    tr6: torch.Tensor; tr7: torch.Tensor
    s0: torch.Tensor; s1: torch.Tensor; s2: torch.Tensor
    s3: torch.Tensor; s4: torch.Tensor
    scount: torch.Tensor
    inst: torch.Tensor
    lox: torch.Tensor; loy: torch.Tensor; loz: torch.Tensor
    ldx: torch.Tensor; ldy: torch.Tensor; ldz: torch.Tensor
    lix: torch.Tensor; liy: torch.Tensor; liz: torch.Tensor
    best_t: torch.Tensor
    bx: torch.Tensor; by: torch.Tensor
    tri: torch.Tensor
    best_inst: torch.Tensor
    bar_t: torch.Tensor; bar_tid: torch.Tensor; bar_leaf: torch.Tensor
    pend_t: torch.Tensor; pend_bx: torch.Tensor; pend_by: torch.Tensor
    pend_tri: torch.Tensor; pend_inst: torch.Tensor
    suspended: torch.Tensor
    done: torch.Tensor
    nodes_visited: torch.Tensor
    tri_tests: torch.Tensor


# dtype of each WideState field (the kernel reads float32, int32 and bool)
_F32_FIELDS = frozenset({"lox", "loy", "loz", "ldx", "ldy", "ldz", "lix",
                         "liy", "liz", "best_t", "bx", "by", "bar_t",
                         "pend_t", "pend_bx", "pend_by"})
_BOOL_FIELDS = frozenset({"suspended", "done"})


def state_dtype(field: str) -> torch.dtype:
    if field in _F32_FIELDS:
        return torch.float32
    return torch.bool if field in _BOOL_FIELDS else torch.int32


def rcp_lane(d: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """1/d with |d| < eps clamped to +-eps (the JAX ``_rcp_lane``)."""
    tiny = torch.where(d < 0, torch.full_like(d, -eps),
                       torch.full_like(d, eps))
    return 1.0 / torch.where(d.abs() < eps, tiny, d)


def init_state_lanes(ox, oy, oz, dx, dy, dz,
                     t_max: float = LARGE_FLOAT) -> WideState:
    """A fresh walk of the rays (every lane at the root, no hit)."""
    r = ox.shape[0]
    dev = ox.device

    def full(v, dtype):
        return torch.full((r,), v, dtype=dtype, device=dev)

    f = {name: full(0, state_dtype(name)) for name in WideState._fields}
    f.update(lox=ox.clone(), loy=oy.clone(), loz=oz.clone(), ldx=dx.clone(),
             ldy=dy.clone(), ldz=dz.clone(), lix=rcp_lane(dx),
             liy=rcp_lane(dy), liz=rcp_lane(dz),
             best_t=full(t_max, torch.float32),
             bar_t=full(-LARGE_FLOAT, torch.float32),
             bar_tid=full(-1, torch.int32), bar_leaf=full(-1, torch.int32),
             pend_t=full(LARGE_FLOAT, torch.float32))
    return WideState(**f)


def init_state(r: int, o: torch.Tensor, d: torch.Tensor,
               t_max: float = LARGE_FLOAT) -> WideState:
    """``init_state_lanes`` of (R, 3) origins and directions."""
    return init_state_lanes(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                            d[:, 2], t_max)


def lanes_hits(wa: WideArrays, st: WideState) -> Hits:
    """The hit records of a walk's state (flat builds unpack ids)."""
    if wa.tri_bits:
        tri = st.tri & ((1 << wa.tri_bits) - 1)
        inst = st.tri >> wa.tri_bits
    else:
        tri, inst = st.tri, st.best_inst
    return Hits(dist=st.best_t, bx=st.bx, by=st.by, bz=1.0 - st.bx - st.by,
                tri=tri, inst=inst)


def _check_lanes(wa: WideArrays, lanes, state: Optional[WideState],
                 suspend: bool) -> None:
    if wa.width != 4:
        raise ValueError("the per-ray walk reads 4-wide tables (its trail "
                         "nibbles hold 0..4); 8-wide tables go to K1")
    if wa.tri_bits and suspend:
        raise ValueError("any-hit suspension needs the TLAS build: a "
                         "flattened build packs instance ids into leaf ids, "
                         "which cannot go through an any-hit shader")
    if int(wa.depth) > TRAIL_LEVELS:
        raise ValueError(f"BVH depth {wa.depth} exceeds the trail's "
                         f"{TRAIL_LEVELS} levels")
    dev = wa.nodes.device
    r = lanes[0].shape[0]
    for a in lanes:
        if a.dtype != torch.float32 or a.shape != (r,) or a.device != dev:
            raise ValueError("ray lanes must be (R,) float32 tensors on the "
                             "tables' device")
    if state is not None:
        for name, a in zip(WideState._fields, state):
            if (a.dtype != state_dtype(name) or a.shape != (r,)
                    or a.device != dev):
                raise ValueError(f"state field {name} must be an (R,) "
                                 f"{state_dtype(name)} tensor on {dev}")


def trace_rays_wide(wa: WideArrays, o: torch.Tensor, d: torch.Tensor,
                    state: Optional[WideState] = None, suspend: bool = False,
                    max_steps: int = MAX_LANE_STEPS,
                    t_max: float = LARGE_FLOAT):
    """``trace_lanes`` of (R, 3) origins and directions."""
    return trace_lanes(wa, o[:, 0].contiguous(), o[:, 1].contiguous(),
                       o[:, 2].contiguous(), d[:, 0].contiguous(),
                       d[:, 1].contiguous(), d[:, 2].contiguous(),
                       state=state, suspend=suspend, max_steps=max_steps,
                       t_max=t_max)


def trace_lanes(wa: WideArrays, ox, oy, oz, dx, dy, dz,
                state: Optional[WideState] = None, suspend: bool = False,
                max_steps: int = MAX_LANE_STEPS, t_max: float = LARGE_FLOAT
                ) -> Tuple[Hits, WideState, PerfCounters]:
    """Walk every ray of the 4-wide tables to its end, or, with
    ``suspend=True``, to its next candidate hit strictly closer than its
    best: the ray then stops with the candidate in its ``pend_*``
    fields and ``suspended`` set; ``commit`` applies the any-hit
    shader's action and passing the state back resumes the walk where it
    stopped.  Without suspension every closer hit is accepted.  Returns
    (Hits, the new state, PerfCounters).  The input state is not changed.

    CUDA tensors launch ``csrc/traverse_wide.cu`` (K3) or raise; CPU
    tensors run ``trace_lanes_ref``.  The JAX ``max_steps`` caps the
    loop's iterations over all lanes; here ``max_steps`` caps each ray's
    own steps (``nodes_visited``), which no walk reaches."""
    lanes = (ox, oy, oz, dx, dy, dz)
    if state is None:
        state = init_state_lanes(*lanes, t_max)
    st = walk_lanes(wa, *lanes, state=WideState(*(a.clone() for a in state)),
                    suspend=suspend, max_steps=max_steps)
    return lanes_hits(wa, st), st, _perf(state, st)


def walk_lanes(wa: WideArrays, ox, oy, oz, dx, dy, dz,
               state: Optional[WideState] = None, suspend: bool = False,
               max_steps: int = MAX_LANE_STEPS, t_max: float = LARGE_FLOAT
               ) -> WideState:
    """The walk of ``trace_lanes`` alone, in place: it writes ``state`` (a
    fresh one if None) and returns it (on a card, one K3 launch and
    nothing else: a lane that is done or suspended reads its two flags
    and nothing more, a lane that walks writes only the fields it
    changed).  The pool path's suspension rounds call this on the state
    they own; its fields must be distinct tensors."""
    lanes = (ox, oy, oz, dx, dy, dz)
    if state is None:
        state = init_state_lanes(*lanes, t_max)
    if ox.shape[0] and len({a.data_ptr() for a in state}) != len(state):
        raise ValueError("an in-place walk needs distinct state fields")
    if ox.device.type == "cpu":
        new = _lanes_ref(wa, lanes, state, suspend, max_steps, False)[0]
        for a, b in zip(state, new):
            a.copy_(b)
        return state
    return kernel_call(wa, ox, oy, oz, dx, dy, dz, state, suspend, max_steps,
                       t_max)()


def kernel_call(wa: WideArrays, ox, oy, oz, dx, dy, dz,
                state: Optional[WideState] = None, suspend: bool = False,
                max_steps: int = MAX_LANE_STEPS, t_max: float = LARGE_FLOAT):
    """The K3 launch of ``walk_lanes`` for CUDA tensors, inputs checked.
    Each call of the returned function walks ``state`` (a fresh one if
    None) in place and returns it, and launches nothing else; a timing
    loop puts the input state back between calls (``copy_``), or CUDA
    events around many calls time walks of an already walked state."""
    lanes = (ox, oy, oz, dx, dy, dz)
    if state is None:
        state = init_state_lanes(*lanes, t_max)
    _check_lanes(wa, lanes, state, suspend)
    if ox.device.type != "cuda":
        raise ValueError(f"no CUDA walk for device {ox.device}")
    lib = kernels.load("traverse_wide")
    r = ox.shape[0]
    if r >= 2**31:
        raise ValueError("ray count exceeds the kernel's int32 index")
    if wa.nodes.data_ptr() % 16 or wa.tri_rows.data_ptr() % 16:
        raise ValueError("the kernel reads table rows as 16-byte vectors: "
                         "nodes and tri_rows must be 16-byte aligned")
    if not all(a.is_contiguous() for a in state):
        raise ValueError("an in-place walk needs a contiguous state")
    lanes = tuple(a.contiguous() for a in lanes)
    ptr_t = ctypes.c_void_p * len(WideState._fields)
    dev = ox.device

    def launch() -> WideState:
        # the closure holds the state and the lanes: their addresses are
        # taken here, at each launch, never kept past the tensors
        ptrs = ptr_t(*(a.data_ptr() for a in state))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.lib.vrt_traverse_wide(
                wa.nodes.data_ptr(), wa.tri_rows.data_ptr(),
                *(a.data_ptr() for a in lanes), ptrs, r,
                wa.nodes.shape[0], wa.tri_rows.shape[0],
                wa.tri_rows.shape[1], max(int(wa.max_leaf_tris), 1),
                int(wa.num_tlas), int(bool(suspend)), int(max_steps), stream)
        if err != 0:
            raise RuntimeError(f"traverse_wide launch failed: "
                               f"{lib.error_string(err)} ({err})")
        if r > 0:
            kernels.LAUNCHES["traverse_wide"] += 1
        return state

    return launch


def _perf(st_in: WideState, st_out: WideState) -> PerfCounters:
    taken = st_out.nodes_visited - st_in.nodes_visited
    return PerfCounters(st_out.nodes_visited, st_out.tri_tests,
                        taken.max() if taken.numel() else taken.sum())


def commit(state: WideState, action: torch.Tensor) -> WideState:
    """Apply per-ray any-hit actions to a suspended walk (the JAX
    ``commit``, RTUnit::commit semantics): ``action`` (R,) int32 of
    COMMIT_CONT / COMMIT_ACCEPT / COMMIT_TERM; only suspended rays are
    affected.  ACCEPT takes the pending hit as the best; CONT and ACCEPT
    resume the walk past the presented candidate (the barrier), TERM
    ends the ray.  Elementwise selects on the state's device."""
    sus = state.suspended
    acc = sus & (action == COMMIT_ACCEPT)
    term = sus & (action == COMMIT_TERM)
    moved = sus & (action != COMMIT_TERM)
    return state._replace(
        best_t=torch.where(acc, state.pend_t, state.best_t),
        bx=torch.where(acc, state.pend_bx, state.bx),
        by=torch.where(acc, state.pend_by, state.by),
        tri=torch.where(acc, state.pend_tri, state.tri),
        best_inst=torch.where(acc, state.pend_inst, state.best_inst),
        # the presented intersection is consumed either way
        bar_t=torch.where(moved, state.pend_t, state.bar_t),
        bar_tid=torch.where(moved, state.pend_tri, state.bar_tid),
        bar_leaf=torch.where(moved, state.node, state.bar_leaf),
        suspended=state.suspended & ~sus,
        done=state.done | term)


# ---- the plain version: trail and short stack as lanes (the JAX helpers)

def _trail_get(tr, level):
    sh = (level & 7) * 4
    widx = level >> 3
    w = tr[0]
    for i in range(1, TRAIL_WORDS):
        w = torch.where(widx == i, tr[i], w)
    return (w >> sh) & 0xF


def _trail_set(tr, level, val, mask):
    sh = (level & 7) * 4
    widx = level >> 3
    return [torch.where(mask & (widx == i),
                        (tr[i] & ~(0xF << sh)) | (val << sh), tr[i])
            for i in range(TRAIL_WORDS)]


def _trail_clear_above(tr, p, mask):
    """Zero every level > p."""
    out = []
    for i in range(TRAIL_WORDS):
        k = (p + 1 - 8 * i).clamp(0, 8)
        keep = torch.where(k >= 8, torch.full_like(k, _U32_ALL),
                           (1 << (k * 4).clamp_max(31)) - 1)
        out.append(torch.where(mask, tr[i] & keep, tr[i]))
    return out


def _trail_find_parent(tr, level):
    """Deepest l < level with trail[l] != 4, else -1 (a nibble is 4 iff
    its bit 2 is set)."""
    best = torch.full_like(level, -1)
    for i in range(TRAIL_WORDS):
        k = (level - 8 * i).clamp(0, 8)
        limit = torch.where(k >= 8, torch.full_like(k, _U32_ALL),
                            (1 << (k * 4).clamp_max(31)) - 1)
        cand = (~tr[i]) & 0x44444444 & limit
        top = torch.full_like(level, -1)
        for j in range(8):
            top = torch.where((cand >> (4 * j + 2)) & 1 == 1,
                              torch.full_like(top, j), top)
        best = torch.where(cand != 0, 8 * i + top, best)
    return best


def _stack_push(st, count, entry, mask):
    s0, s1, s2, s3, s4 = st
    ns = [torch.where(mask, entry, s0), torch.where(mask, s0, s1),
          torch.where(mask, s1, s2), torch.where(mask, s2, s3),
          torch.where(mask, s3, s4)]  # the oldest falls off on overflow
    return ns, torch.where(mask, (count + 1).clamp_max(STACK_ENTRIES), count)


def _stack_pop(st, count, mask):
    s0, s1, s2, s3, s4 = st
    ns = [torch.where(mask, s1, s0), torch.where(mask, s2, s1),
          torch.where(mask, s3, s2), torch.where(mask, s4, s3),
          torch.where(mask, torch.zeros_like(s4), s4)]
    return s0, ns, torch.where(mask, count - 1, count)


def trace_lanes_ref(wa: WideArrays, ox, oy, oz, dx, dy, dz,
                    state: Optional[WideState] = None, suspend: bool = False,
                    max_steps: int = MAX_LANE_STEPS,
                    t_max: float = LARGE_FLOAT
                    ) -> Tuple[Hits, WideState, PerfCounters]:
    """Plain PyTorch version of ``trace_lanes``, on any device: the JAX
    loop body over all lanes with masks, every lane stepping until it is
    done or suspended, in the JAX order of operations, so its hits and
    per-ray ``nodes_visited`` and ``tri_tests`` are the JAX lane's."""
    lanes = (ox, oy, oz, dx, dy, dz)
    if state is None:
        state = init_state_lanes(*lanes, t_max)
    st, _ = _lanes_ref(wa, lanes, state, suspend, max_steps, False)
    return lanes_hits(wa, st), st, _perf(state, st)


def lanes_work(wa: WideArrays, ox, oy, oz, dx, dy, dz,
               state: Optional[WideState] = None, suspend: bool = False,
               max_steps: int = MAX_LANE_STEPS):
    """The plain walk of these lanes with what it computes per ray:
    (new state, WalkWork).  ``tools/walk_bounds.k3_bound`` turns the
    work into a bound."""
    lanes = (ox, oy, oz, dx, dy, dz)
    if state is None:
        state = init_state_lanes(*lanes)
    return _lanes_ref(wa, lanes, state, suspend, max_steps, True)


def _lanes_ref(wa: WideArrays, lanes, state: WideState, suspend: bool,
               max_steps: int, count: bool):
    """(new state, WalkWork or None) of the plain per-ray walk."""
    from vortex_rt_tpu_torch.ops.packet_walk import (  # (imports us)
        TRI_SLOT_BYTES, WalkWork)

    ox, oy, oz, dx, dy, dz = lanes
    _check_lanes(wa, lanes, state, suspend)
    dev = ox.device
    r = ox.shape[0]
    nodes = wa.nodes.to(torch.int64) & _U32_ALL
    nodes_f = wa.nodes.view(torch.float32)
    rows, rows_i = wa.tri_rows, wa.tri_rows.view(torch.int32)
    n_pool, n_rows = nodes.shape[0], rows.shape[0]
    lmax = max(int(wa.max_leaf_tris), 1)
    eps = MT_EPSILON
    ivx, ivy, ivz = rcp_lane(dx), rcp_lane(dy), rcp_lane(dz)
    large = torch.full((r,), LARGE_FLOAT, dtype=torch.float32, device=dev)
    miss_key = torch.full_like(large, _MISS_KEY)
    work = WalkWork.zeros(r, n_pool + n_rows, dev) if count else None

    s = {k: v.clone() for k, v in state._asdict().items()}
    for k in ("node", "level", "scount", "inst", "tri", "best_inst",
              "bar_tid", "bar_leaf", "pend_tri", "pend_inst",
              "s0", "s1", "s2", "s3", "s4"):
        s[k] = s[k].to(torch.int64)
    trail = [s[f"tr{i}"].to(torch.int64) & _U32_ALL
             for i in range(TRAIL_WORDS)]
    stack = [s[f"s{i}"] for i in range(STACK_ENTRIES)]
    scount = s["scount"]
    while True:
        active = ~s["done"] & ~s["suspended"] & (s["nodes_visited"]
                                                  < max_steps)
        if not bool(active.any()):
            break
        node = s["node"].clamp(0, n_pool - 1)
        row, row_f = nodes[node], nodes_f[node]
        meta = row[:, META]
        kind = meta >> 29
        nch = (meta >> LEFT_BITS) & 7
        left = meta & LEFT_MASK
        leaf_data = row[:, LEAF]
        is_int = active & (kind == qbvh.KIND_INTERNAL)
        is_tri = active & (kind == qbvh.KIND_TRIS)
        is_ins = active & (kind == qbvh.KIND_INSTANCE)
        in_tlas = node < wa.num_tlas
        rox = torch.where(in_tlas, ox, s["lox"])
        roy = torch.where(in_tlas, oy, s["loy"])
        roz = torch.where(in_tlas, oz, s["loz"])
        rix = torch.where(in_tlas, ivx, s["lix"])
        riy = torch.where(in_tlas, ivy, s["liy"])
        riz = torch.where(in_tlas, ivz, s["liz"])

        # ---- internal node: 4 slab tests, far -> near network ----
        gx, gy, gz = row_f[:, 0], row_f[:, 1], row_f[:, 2]
        sx, sy, sz = row_f[:, 3], row_f[:, 4], row_f[:, 5]
        dists, idxs = [], []
        for c in range(WIDTH):
            ql, qh = row[:, QLO + c], row[:, QHI + c]

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
            hc = ((tmax >= tmin) & (tmax > 0.0) & (c < nch)
                  & (tmin < s["best_t"]))
            dists.append(torch.where(hc, tmin, miss_key))
            idxs.append(torch.full((r,), c, dtype=torch.int64, device=dev))
        m = sum((dd > _MISS_KEY).to(torch.int64) for dd in dists)
        for a_i, b_i in _SORT_NET4:
            swap = dists[a_i] < dists[b_i]
            da, db = dists[a_i], dists[b_i]
            ia, ib = idxs[a_i], idxs[b_i]
            dists[a_i] = torch.where(swap, db, da)
            dists[b_i] = torch.where(swap, da, db)
            idxs[a_i] = torch.where(swap, ib, ia)
            idxs[b_i] = torch.where(swap, ia, ib)
        k_tr = _trail_get(trail, s["level"])
        drop = torch.where(k_tr == WIDTH, (m - 1).clamp_min(0),
                           torch.minimum(k_tr, m))
        remaining = m - drop
        pos_closest = m - 1 - drop
        descend = is_int & (remaining >= 1)
        want_pop_int = is_int & (remaining < 1)
        child_slot = idxs[0]
        for i in range(1, WIDTH):
            child_slot = torch.where(pos_closest == i, idxs[i], child_slot)
        next_int = left + child_slot
        # pushes: sorted positions 0..pos_closest-1, the farthest first
        # and flagged 'last'
        for pm, pe in ((descend & (pos_closest >= 1),
                        (left + idxs[0]) | LAST_FLAG),
                       (descend & (pos_closest >= 2), left + idxs[1]),
                       (descend & (pos_closest >= 3), left + idxs[2])):
            stack, scount = _stack_push(stack, scount, pe, pm)
        trail = _trail_set(trail, s["level"], torch.full_like(m, WIDTH),
                           descend & (remaining == 1))

        # ---- instance leaf: inverse transform + BLAS root inline ----
        mm = [row_f[:, INST_XFORM + k] for k in range(12)]
        nlox = mm[0] * ox + mm[1] * oy + mm[2] * oz + mm[3]
        nloy = mm[4] * ox + mm[5] * oy + mm[6] * oz + mm[7]
        nloz = mm[8] * ox + mm[9] * oy + mm[10] * oz + mm[11]
        nldx = mm[0] * dx + mm[1] * dy + mm[2] * dz
        nldy = mm[4] * dx + mm[5] * dy + mm[6] * dz
        nldz = mm[8] * dx + mm[9] * dy + mm[10] * dz
        inst = torch.where(is_ins, left, s["inst"])
        lox = torch.where(is_ins, nlox, s["lox"])
        loy = torch.where(is_ins, nloy, s["loy"])
        loz = torch.where(is_ins, nloz, s["loz"])
        ldx = torch.where(is_ins, nldx, s["ldx"])
        ldy = torch.where(is_ins, nldy, s["ldy"])
        ldz = torch.where(is_ins, nldz, s["ldz"])
        lix = torch.where(is_ins, rcp_lane(nldx), s["lix"])
        liy = torch.where(is_ins, rcp_lane(nldy), s["liy"])
        liz = torch.where(is_ins, rcp_lane(nldz), s["liz"])
        next_ins = row[:, INST_ROOT]

        # ---- triangle leaf: one row, Moller-Trumbore per slot ----
        leaf_row = left.clamp(0, n_rows - 1)
        lrow, lrow_i = rows[leaf_row], rows_i[leaf_row]
        cnt = leaf_data
        barrier = node == s["bar_leaf"]
        t_min = large
        tid_sel = torch.full((r,), _INT_MAX32, dtype=torch.int64, device=dev)
        w1_sel = torch.zeros_like(large)
        w2_sel = torch.zeros_like(large)
        for c in range(lmax):
            b0 = 16 * c
            v0x, v0y, v0z = lrow[:, b0], lrow[:, b0 + 1], lrow[:, b0 + 2]
            e1x, e1y, e1z = lrow[:, b0 + 3], lrow[:, b0 + 4], lrow[:, b0 + 5]
            e2x, e2y, e2z = lrow[:, b0 + 6], lrow[:, b0 + 7], lrow[:, b0 + 8]
            tid = lrow_i[:, b0 + 9].to(torch.int64)
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
                  & (w1 + w2 <= 1.0) & (t > eps) & (c < cnt) & is_tri)
            if suspend:
                beyond = (~barrier | (t > s["bar_t"])
                          | ((t == s["bar_t"]) & (tid > s["bar_tid"])))
                ok = ok & (t < s["best_t"]) & beyond
            t = torch.where(ok, t, large)
            better = (t < t_min) | ((t == t_min) & (t < LARGE_FLOAT)
                                    & (tid < tid_sel))
            t_min = torch.where(better, t, t_min)
            tid_sel = torch.where(better, tid, tid_sel)
            w1_sel = torch.where(better, w1, w1_sel)
            w2_sel = torch.where(better, w2, w2_sel)

        if suspend:
            found = is_tri & (t_min < LARGE_FLOAT)
            s["pend_t"] = torch.where(found, t_min, s["pend_t"])
            s["pend_bx"] = torch.where(found, w1_sel, s["pend_bx"])
            s["pend_by"] = torch.where(found, w2_sel, s["pend_by"])
            s["pend_tri"] = torch.where(found, tid_sel, s["pend_tri"])
            s["pend_inst"] = torch.where(found, inst, s["pend_inst"])
            s["suspended"] = s["suspended"] | found
            # the stack is cleared at suspension (rt_traversal.cpp:151)
            stack = [torch.where(found, torch.zeros_like(e), e)
                     for e in stack]
            scount = torch.where(found, torch.zeros_like(scount), scount)
            want_pop_tri = is_tri & ~found
        else:
            closer = is_tri & (t_min < s["best_t"])
            tie = is_tri & (t_min == s["best_t"]) & (t_min < LARGE_FLOAT)
            tie_better = tie & ((inst < s["best_inst"])
                                | ((inst == s["best_inst"])
                                   & (tid_sel < s["tri"])))
            upd = closer | tie_better
            s["best_t"] = torch.where(upd, t_min, s["best_t"])
            s["bx"] = torch.where(upd, w1_sel, s["bx"])
            s["by"] = torch.where(upd, w2_sel, s["by"])
            s["tri"] = torch.where(upd, tid_sel, s["tri"])
            s["best_inst"] = torch.where(upd, inst, s["best_inst"])
            want_pop_tri = is_tri

        # ---- choose the next node, or pop ----
        nxt = torch.where(is_int, torch.where(descend, next_int, s["node"]),
                          torch.where(is_ins, next_ins, s["node"]))
        level = torch.where(descend, s["level"] + 1, s["level"])
        want_pop = want_pop_int | want_pop_tri
        p = _trail_find_parent(trail, level)
        dead = want_pop & (p < 0)
        do_pop = want_pop & (p >= 0)
        p_safe = p.clamp_min(0)
        kp = _trail_get(trail, p_safe)
        trail = _trail_set(trail, p_safe, kp + 1, do_pop)
        trail = _trail_clear_above(trail, p_safe, do_pop)
        empty = scount == 0
        restart = do_pop & empty
        from_stack = do_pop & ~empty
        entry, stack, scount = _stack_pop(stack, scount, from_stack)
        is_last = (entry & LAST_FLAG) != 0
        trail = _trail_set(trail, p_safe, torch.full_like(p_safe, WIDTH),
                           from_stack & is_last)
        zero = torch.zeros_like(nxt)
        s["node"] = torch.where(restart, zero, torch.where(
            from_stack, entry & ID_MASK, nxt))
        s["level"] = torch.where(restart, zero, torch.where(
            from_stack, p_safe + 1, level))
        s["done"] = s["done"] | dead
        s.update(inst=inst, lox=lox, loy=loy, loz=loz, ldx=ldx, ldy=ldy,
                 ldz=ldz, lix=lix, liy=liy, liz=liz)
        s["nodes_visited"] = s["nodes_visited"] + active.to(torch.int32)
        s["tri_tests"] = s["tri_tests"] + torch.where(
            is_tri, cnt, zero).to(torch.int32)
        if count:
            slots = cnt.clamp(0, lmax)
            work.add(is_int, nch, is_tri, slots, is_ins)
            # the kernel's reads: a node's meta quarter (16 B) at every
            # step, then its child boxes (48 B) or its transform and BLAS
            # root (64 B); a leaf's triangle slots in its tri row
            work.read(node, torch.where(is_int, 64, torch.where(
                is_ins, 80, 16)), active)
            work.read(n_pool + leaf_row, TRI_SLOT_BYTES * slots, is_tri)

    for i in range(TRAIL_WORDS):
        s[f"tr{i}"] = trail[i]
    for i in range(STACK_ENTRIES):
        s[f"s{i}"] = stack[i]
    s["scount"] = scount
    out = WideState(**{k: _to_field(k, v) for k, v in s.items()})
    return out, work


def _to_field(name: str, v: torch.Tensor) -> torch.Tensor:
    """A working lane back to its WideState dtype (u32 bits as int32)."""
    dt = state_dtype(name)
    if dt == torch.int32 and v.dtype == torch.int64:
        v = torch.where(v >= 2**31, v - 2**32, v)
    return v.to(dt)
