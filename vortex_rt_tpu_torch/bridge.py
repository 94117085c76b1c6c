"""Carry the JAX package's tables across to the port, bit for bit.

The inputs are NumPy arrays (``np.asarray`` of the JAX package's
``WideArrays.nodes``/``tri_rows`` and its static ints, of
``ShadeArrays.*``, and of the camera and light vectors); the outputs are
the port's tables on a given device.  This module imports neither JAX
nor ``vortex_rt_tpu``: it only reads arrays.

4-, 8- and 16-wide ``nodes``/``tri_rows``, the fused node+leaf rows and the
alpha-cutout tables (``alpha_rows``, ``alpha_pool``) are carried, and the
LBVH and PLOC topologies (``lbvh_topo``, ``ploc_topo``: the arrays of the
JAX package's ``LBVHTopo`` and ``PLOCTopo``), so both packages can refit
one tree, and a per-ray walk's state (``wide_state``: the JAX
``WideState``), so a walk the JAX package suspended can resume in the
port, and the merged TLAS+BLAS pool of the binary walk
(``traversal_arrays``: the JAX ``TraversalArrays``), so both packages walk
one pool.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vortex_rt_tpu_torch.accel import ploc
from vortex_rt_tpu_torch.accel.lbvh import LBVHTopo, _parents_ref
from vortex_rt_tpu_torch.engine.megakernel import CameraArrays, LightArrays
from vortex_rt_tpu_torch.ops.shade_lanes import ShadeArrays
from vortex_rt_tpu_torch.ops.traverse2 import TraversalArrays
from vortex_rt_tpu_torch.ops.traverse_wide import (
    WideArrays, WideState, row_words, state_dtype,
)


def _as_i32(a: np.ndarray) -> torch.Tensor:
    """u32/i32 words -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize != 4 or a.dtype.kind not in "ui":
        raise ValueError(f"expected 32-bit integer words, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy())


def _as_f32(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype != np.float32:
        raise ValueError(f"expected float32, got {a.dtype}")
    return torch.from_numpy(a.copy())


def wide_arrays(nodes: np.ndarray, tri_rows: np.ndarray, *, num_tlas: int,
                max_leaf_tris: int, depth: int, tri_bits: int, width: int,
                device, fused: Optional[np.ndarray] = None,
                alpha_rows: Optional[np.ndarray] = None,
                alpha_pool: Optional[np.ndarray] = None) -> WideArrays:
    """JAX ``WideArrays`` fields -> the port's ``WideArrays`` (node rows
    of 32 words at widths 4 and 8, 40 at width 16)."""
    if width not in (4, 8, 16):
        raise ValueError(f"unsupported BVH width {width}")
    nw = row_words(width)
    if nodes.ndim != 2 or nodes.shape[1] != nw:
        raise ValueError(f"nodes must be (N, {nw}), got {nodes.shape}")
    if (alpha_rows is None) != (alpha_pool is None):
        raise ValueError("alpha_rows and alpha_pool come together")
    alpha_words = 0
    if alpha_rows is not None:
        if (alpha_rows.ndim != 2 or alpha_rows.shape[0] != tri_rows.shape[0]
                or alpha_rows.shape[1] * 2 != tri_rows.shape[1]
                or alpha_pool.ndim != 1):
            raise ValueError(f"alpha_rows must be (L, 8*k) beside tri_rows "
                             f"(L, 16*k) and alpha_pool 1-D, got "
                             f"{alpha_rows.shape}, {alpha_pool.shape}")
        alpha_words = alpha_rows.shape[1]
    if fused is not None and (fused.ndim != 2 or fused.shape[0] !=
                              nodes.shape[0] or fused.shape[1] !=
                              nw + tri_rows.shape[1] + alpha_words):
        raise ValueError(f"fused must be (N, {nw} + leaf row words "
                         f"(+ alpha words)), got {fused.shape}")
    return WideArrays(nodes=_as_i32(nodes), tri_rows=_as_f32(tri_rows),
                      num_tlas=int(num_tlas),
                      max_leaf_tris=int(max_leaf_tris), depth=int(depth),
                      tri_bits=int(tri_bits), width=int(width),
                      fused=None if fused is None else _as_i32(fused),
                      alpha_rows=(None if alpha_rows is None
                                  else _as_f32(alpha_rows)),
                      alpha_pool=(None if alpha_pool is None
                                  else _as_f32(alpha_pool))).to(device)


def wide_state(*, device, steps=None, **fields) -> WideState:
    """JAX ``WideState`` fields (``state._asdict()`` as NumPy arrays) ->
    the port's ``WideState``.  The JAX loop counter ``steps`` has no
    counterpart (the port counts steps per ray) and is dropped."""
    del steps
    missing = set(WideState._fields) - set(fields)
    extra = set(fields) - set(WideState._fields)
    if missing or extra:
        raise ValueError(f"WideState fields: missing {sorted(missing)}, "
                         f"unknown {sorted(extra)}")
    out = {}
    for name in WideState._fields:
        a = np.ascontiguousarray(fields[name])
        dt = state_dtype(name)
        if dt == torch.float32:
            t = _as_f32(a)
        elif dt == torch.bool:
            t = torch.from_numpy(a.astype(np.bool_))
        else:
            t = _as_i32(a)
        out[name] = t.to(device)
    return WideState(**out)


def lbvh_topo(*, order, lchild, rchild, surv, ch_old, arity, base, newid,
              row_lo, row_cnt, leaf_newid, lo, hi, device) -> LBVHTopo:
    """JAX ``LBVHTopo`` fields (``topo._asdict()`` as NumPy arrays) -> the
    port's ``LBVHTopo``, so both packages can refit the same topology.
    ``parent``, which only the port keeps, is derived from the children."""
    ints = {k: torch.from_numpy(np.array(v, dtype=np.int32))
            for k, v in dict(order=order, lchild=lchild, rchild=rchild,
                             ch_old=ch_old, arity=arity, base=base,
                             newid=newid, row_lo=row_lo, row_cnt=row_cnt,
                             leaf_newid=leaf_newid, lo=lo, hi=hi).items()}
    surv_t = torch.from_numpy(np.array(surv, dtype=np.bool_))
    parent = _parents_ref(ints["lchild"], ints["rchild"],
                          ints["order"].shape[0])
    return LBVHTopo(surv=surv_t, parent=parent,
                    **ints)._replace(**{k: v.to(device) for k, v in dict(
                        ints, surv=surv_t, parent=parent).items()})


def ploc_topo(*, topo: dict, leaf_tids, level, n_int, n_levels,
              device) -> ploc.PLOCTopo:
    """JAX ``PLOCTopo`` fields as NumPy arrays (``topo`` the dict of its
    ``LBVHTopo``'s fields) -> the port's ``PLOCTopo``, so both packages
    can refit one PLOC tree.  ``parent`` is derived from the live
    internals' children, and ``wide_depth`` from the parents, as the
    port's build computes them (the plain versions)."""
    n = int(np.asarray(n_int))
    width = int(np.asarray(topo["ch_old"]).shape[-1])
    ints = {k: torch.from_numpy(np.array(topo[k], dtype=np.int32))
            for k in LBVHTopo._fields if k not in ("surv", "parent")}
    l = ints["order"].shape[0]
    parent = ploc._ploc_parents_ref(ints["lchild"], ints["rchild"], n, l)
    max_depth = ploc._collapse_ploc_ref(ints["lchild"], ints["rchild"],
                                        parent, n, l, width)[-1]
    lt = LBVHTopo(surv=torch.from_numpy(np.array(topo["surv"], np.bool_)),
                  parent=parent, **ints)
    lt = LBVHTopo(*(a.to(device) for a in lt))
    return ploc.PLOCTopo(
        topo=lt,
        leaf_tids=torch.from_numpy(np.array(leaf_tids, np.int32)).to(device),
        level=torch.from_numpy(np.array(level, np.int32)).to(device),
        n_int=torch.tensor(n, dtype=torch.int32, device=device),
        n_levels=torch.tensor(int(np.asarray(n_levels)), dtype=torch.int32,
                              device=device),
        wide_depth=ploc.wide_depth_of(max_depth, width).to(device))


def traversal_arrays(*, nmin, nmax, left, count, kind, tri_idx, v0, v1, v2,
                     inst_inv, inst_root, inst_refl, max_leaf_tris, num_tlas,
                     device) -> TraversalArrays:
    """JAX ``TraversalArrays`` fields (``dataclasses.asdict`` as NumPy
    arrays and ints) -> the port's ``TraversalArrays``."""
    ints = dict(left=left, count=count, kind=kind, tri_idx=tri_idx,
                inst_root=inst_root)
    floats = dict(nmin=nmin, nmax=nmax, v0=v0, v1=v1, v2=v2,
                  inst_inv=inst_inv, inst_refl=inst_refl)
    return TraversalArrays(
        **{k: _as_i32(np.asarray(v)) for k, v in ints.items()},
        **{k: _as_f32(np.asarray(v)) for k, v in floats.items()},
        max_leaf_tris=int(max_leaf_tris),
        num_tlas=int(num_tlas)).to(device)


def shade_arrays(shade_rows: np.ndarray, mat_rows: np.ndarray,
                 inst_shade: np.ndarray, texels: np.ndarray, *,
                 device) -> ShadeArrays:
    """JAX ``ShadeArrays`` fields -> the port's ``ShadeArrays``."""
    return ShadeArrays(shade_rows=_as_f32(shade_rows),
                       mat_rows=_as_f32(mat_rows),
                       inst_shade=_as_f32(inst_shade),
                       texels=_as_i32(texels)).to(device)


def camera_arrays(pos, forward, right, up, viewplane, *,
                  device) -> CameraArrays:
    return CameraArrays(*(_as_f32(np.asarray(a, np.float32)).to(device)
                          for a in (pos, forward, right, up, viewplane)))


def light_arrays(light_pos, light_color, ambient, background, *,
                 device) -> LightArrays:
    return LightArrays(*(_as_f32(np.asarray(a, np.float32)).to(device)
                         for a in (light_pos, light_color, ambient,
                                   background)))
