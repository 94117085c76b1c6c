"""4- and 8-wide packed node and leaf tables (port of ``WideArrays``,
``WideArrays.from_scene`` and ``WideArrays.fuse`` of
``vortex_rt_tpu/ops/traverse_wide.py``).

The tables are built on the host with NumPy, bit-identical to the JAX
package's, and held as torch tensors:

* ``nodes`` (N, 32) int32 — one 128-byte row per node, the u32 words
  stored as int32: words 0..2 fp32 origin, 3..5 fp32 power-of-two scale,
  then per-child quantized lo / hi boxes (3 bytes each), the meta word
  and the leaf count at the offsets of ``row_layout(width)``:

  ========  ======  ======  =====  =====  ===========================
  width     lo      hi      meta   leaf   meta word
  ========  ======  ======  =====  =====  ===========================
  4         6..9    10..13  14     15     left | nchild<<26 | kind<<29
  8         6..13   14..21  22     23     left | nchild<<25 | kind<<29
  ========  ======  ======  =====  =====  ===========================

  4-wide instance nodes carry their inverse transform in words 16..27
  and their BLAS root in word 28 (8-wide builds are flat: no instance
  nodes).  Float fields are read through ``nodes.view(torch.float32)``.
* ``tri_rows`` (L, 16*lmax) float32 — one row per triangle leaf, up to
  lmax slots of (v0, e1, e2, tid bits, pad) 16 floats.  Flat builds pack
  the tid as ``(inst << tri_bits) | tri``.
* ``fused`` (N, 32 + 16*lmax) int32, flat builds only (``fuse()``):
  each node row followed by its own leaf slots (zeros for internal
  nodes), so one row read serves both node kinds.

The 4-wide walk over ``nodes``/``tri_rows`` is ``ops/packet_walk.py``
(K2); the 8-wide walk over ``fused`` is ``ops/traverse_packet.py`` (K1).
The JAX module's per-ray restart-trail engine (``trace_lanes``/``commit``,
K3 in ROADMAP), 16-wide rows and the alpha tables are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vortex_rt_tpu_torch.accel import qbvh
from vortex_rt_tpu_torch.models.scene import SceneBuffers

WIDTH = 4
ROW_WORDS = 32
# 4-wide meta word layout (word 14): left_first | nchild << 26 | kind << 29
LEFT_BITS = 26
LEFT_MASK = (1 << LEFT_BITS) - 1
QLO, QHI, META, LEAF = 6, 10, 14, 15
INST_XFORM, INST_ROOT = 16, 28
# 8-wide meta word (word 22): left_first | nchild << 25 | kind << 29
LEFT_BITS8 = 25


def row_layout(width: int):
    """(qlo_off, qhi_off, meta_off, leaf_off) of a packed node row."""
    if width == 4:
        return QLO, QHI, META, LEAF
    if width == 8:
        return 6, 14, 22, 23
    raise ValueError(f"no row layout for width {width}")


def left_bits(width: int) -> int:
    """Bits of left_first in the meta word (nchild sits above them)."""
    return LEFT_BITS if width == 4 else LEFT_BITS8


def fuse_rows(nodes: torch.Tensor, tri_rows: torch.Tensor,
              width: int) -> torch.Tensor:
    """(N, 32 + 16*lmax) int32: each node row of a flat build followed by
    its own leaf slots (zeros for internal nodes)."""
    meta = nodes[:, row_layout(width)[2]]
    kind = (meta >> 29) & 7
    left = (meta & ((1 << left_bits(width)) - 1)).to(torch.int64)
    rows = tri_rows.view(torch.int32)
    is_tris = (kind == qbvh.KIND_TRIS).unsqueeze(1)
    own = rows[left.clamp(0, rows.shape[0] - 1)]
    leaf_part = torch.where(is_tris, own, torch.zeros_like(own))
    return torch.cat([nodes, leaf_part], 1).contiguous()


@dataclasses.dataclass
class WideArrays:
    """Packed wide TLAS+BLAS pool + slot-ordered triangle rows."""

    nodes: torch.Tensor     # (N, 32) int32 packed node records
    tri_rows: torch.Tensor  # (L, 16*lmax) float32 leaf rows
    num_tlas: int           # nodes [0, num_tlas) are TLAS nodes
    max_leaf_tris: int      # triangles tested per leaf row
    depth: int              # max descend depth (TLAS + BLAS)
    tri_bits: int = 0       # flat builds: leaf tids pack (inst << bits) | tri
    width: int = WIDTH
    fused: Optional[torch.Tensor] = None  # (N, 32 + 16*lmax) int32

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.nodes, self.tri_rows, self.fused)
                   if t is not None)

    def to(self, device) -> "WideArrays":
        return dataclasses.replace(
            self, nodes=self.nodes.to(device),
            tri_rows=self.tri_rows.to(device),
            fused=None if self.fused is None else self.fused.to(device))

    def fuse(self) -> "WideArrays":
        """A copy with the fused node+leaf table built (flat builds
        only), word for word the JAX package's ``WideArrays.fuse``."""
        if not (self.num_tlas == 0 and self.tri_bits > 0):
            raise ValueError("fused rows require the flattened build")
        return dataclasses.replace(
            self, fused=fuse_rows(self.nodes, self.tri_rows, self.width))

    @staticmethod
    def from_scene(sb: SceneBuffers, width: int = WIDTH) -> "WideArrays":
        """Build the tables on the CPU (move them with ``.to(device)``).
        Width 8 needs the flattened build."""
        if width == 16:
            raise NotImplementedError(
                "width=16: 16-wide rows are not ported (ROADMAP Queue 1, "
                "'Not ported')")
        if width not in (4, 8):
            raise ValueError(f"unsupported BVH width {width}")
        flat = bool(sb.flat)
        if width == 8 and not flat:
            raise ValueError("8-wide nodes require the flattened build "
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

        qoff, hoff, moff, loff = row_layout(width)
        nodes = np.zeros((n, ROW_WORDS), np.uint32)
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
