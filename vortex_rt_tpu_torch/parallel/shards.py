"""Scene-sharded multi-device rendering, the "sp" axis for scenes beyond
one device's memory (port of ``vortex_rt_tpu/parallel/shards.py``) on
``torch.distributed``.

The ranks form a ``(dp, sp)`` mesh (``parallel.mesh.Mesh``).  Each rank
holds

* the rays of its image row block (``dp``, as ``parallel.tiles``), and
* ONE scene shard (``sp``): the 4-wide TLAS over the instances it owns
  and those instances' BLAS nodes and leaf rows, the memory that
  dominates a scene's cost.

``build_sharded`` bin-packs the instances and packs every shard in the
JAX layout (the pools stacked on a leading shard axis, padded to one
shape); a rank keeps its own row of it (``ShardedArrays.shard``).  The
shading tables and the instances' world boxes and owners are replicated.

Two schedules of the sp axis (``make_sharded_wavefront(schedule=...)``),
each a ``walk`` for ``frame_body`` that traces with the 4-wide walk
(``ops/packet_walk.trace_packets_walk``: K2 on a card, its plain version
on the CPU) on the rank's shard, maps local instances to global ones
(``inst_map``) and combines across ``sp``:

* ``"replicate"`` (default): every sp peer makes the same rays (no
  communication) and traces them all on its shard; the closest hits
  combine by the lexicographic (t, global instance, triangle) minimum,
  three ``MIN`` reductions, then the winner's barycentrics broadcast by a
  ``SUM``.  Shadow waves take one ``MIN`` of the distance.
* ``"alltoall"``: each ray visits only the shards its TLAS candidates
  touch (slab tests against the replicated instance boxes), near to far;
  wave k sends each ray of the peer's home slice to its k-th owner with
  one ``all_to_all_single``, the owner traces what it received, a second
  exchange returns (t, barycentrics, global ids), and the per-ray
  lexicographic minimum updates best_t, which prunes later waves; the
  home slices' results are broadcast by a ``SUM`` at the end.

Instances are partitioned, so a hit (t, instance, triangle) exists on
exactly one shard and the minimum reproduces one device's tie-break;
shading runs on every peer with global ids.  The image and ray counts
are the single-device frame's.

Steps: the port's walk steps, ray by ray, summed over every rank
(ROADMAP hazard H19: the JAX package counts packed loop iterations, or
with ``accounting=True`` live rays per iteration; the port counts its
own walk's steps either way).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from vortex_rt_tpu_torch.accel import qbvh
from vortex_rt_tpu_torch.engine.megakernel import CameraArrays, LightArrays
from vortex_rt_tpu_torch.engine.shaders import ShaderTable, pathtrace_closest
from vortex_rt_tpu_torch.engine.wavefront import frame_body
from vortex_rt_tpu_torch.models.scene import (
    Camera, RenderParams, Scene, SceneBuffers,
)
from vortex_rt_tpu_torch.ops.intersect import safe_rcp
from vortex_rt_tpu_torch.ops.packet_walk import trace_packets_walk
from vortex_rt_tpu_torch.ops.shade_lanes import ShadeArrays
from vortex_rt_tpu_torch.ops.traverse2 import Hits
from vortex_rt_tpu_torch.ops.traverse_wide import (
    INST_ROOT, LEFT_BITS, LEFT_MASK, META, ROW_WORDS, WideArrays,
)
from vortex_rt_tpu_torch.parallel.mesh import Mesh
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT, RTConfig

_I32MAX = 2**31 - 1


def bin_pack_instances(scene: Scene, n_shards: int) -> List[List[int]]:
    """Greedy least-loaded bin-pack of the instances by their mesh's
    triangle count (nodes and leaf rows both scale with it): per shard
    its global instance ids, ascending (the shard's walk then breaks ties
    in the global order)."""
    insts = scene._instances
    if len(insts) < n_shards:
        raise ValueError(f"need >= {n_shards} instances to fill {n_shards} "
                         "shards")
    weights = [scene._meshes[mi].num_tris for (mi, _, _) in insts]
    order = np.argsort(-np.asarray(weights), kind="stable")
    load = np.zeros(n_shards, np.int64)
    owner = np.zeros(len(insts), np.int32)
    for i in order:
        s = int(load.argmin())
        owner[i] = s
        load[s] += weights[i]
    return [sorted(int(i) for i in np.nonzero(owner == s)[0])
            for s in range(n_shards)]


def _pad_tlas_region(nodes: np.ndarray, k_old: int, k_new: int
                     ) -> np.ndarray:
    """Grow the TLAS region of a 4-wide pool's (N, 32) int32 node rows
    from ``k_old`` to ``k_new`` rows, so that every shard has one
    ``num_tlas``: the BLAS internal links (the meta word's left_first)
    and the instance rows' BLAS roots shift by the pad; the pad rows are
    zero-count triangle leaves no walk reaches."""
    pad = k_new - k_old
    if pad == 0:
        return nodes
    w = np.asarray(nodes).view(np.uint32).copy()
    n = w.shape[0]
    meta = w[:, META]
    kind = meta >> 29
    left = (meta & LEFT_MASK).astype(np.int64)
    nch = (meta >> LEFT_BITS) & 7
    blas_int = (kind == qbvh.KIND_INTERNAL) & (np.arange(n) >= k_old)
    left = np.where(blas_int, left + pad, left)
    w[:, META] = left.astype(np.uint32) | (nch << LEFT_BITS) | (kind << 29)
    is_inst = kind == qbvh.KIND_INSTANCE
    roots = w[is_inst, INST_ROOT].view(np.int32) + pad
    w[is_inst, INST_ROOT] = roots.view(np.uint32)
    dead = np.zeros((pad, ROW_WORDS), np.uint32)
    dead[:, META] = np.uint32(qbvh.KIND_TRIS) << 29
    return np.concatenate([w[:k_old], dead, w[k_old:]]).view(np.int32)


@dataclasses.dataclass
class ShardedArrays:
    """Per-shard traversal pools stacked on a leading shard axis (the JAX
    layout), or the one shard a rank holds (``shard``), and the
    replicated routing tables."""

    nodes: torch.Tensor      # (S, Nmax, 32) int32, or (1, ...) one shard
    tri_rows: torch.Tensor   # (S, Lmax, 16*lmax) float32
    inst_map: torch.Tensor   # (S, Imax) int32 local -> global instance id
    inst_aabb: torch.Tensor  # (I, 6) float32 world lo.xyz, hi.xyz
    inst_owner: torch.Tensor  # (I,) int32 owner shard of each instance
    num_tlas: int
    max_leaf_tris: int
    depth: int
    n_shards: int
    shard_ids: Tuple[int, ...]  # the shards the rows hold, in order

    def shard(self, s: int, device=None) -> "ShardedArrays":
        """Shard ``s`` alone (a copy of its row, on ``device``), with the
        routing tables."""
        row = self.shard_ids.index(s)
        dev = self.nodes.device if device is None else device

        def one(t):
            return t[row:row + 1].to(dev, copy=True)

        return dataclasses.replace(
            self, nodes=one(self.nodes), tri_rows=one(self.tri_rows),
            inst_map=one(self.inst_map), inst_aabb=self.inst_aabb.to(dev),
            inst_owner=self.inst_owner.to(dev), shard_ids=(s,))

    def local(self) -> Tuple[WideArrays, torch.Tensor]:
        """(WideArrays, inst_map) of the one shard held."""
        if len(self.shard_ids) != 1:
            raise ValueError("local() needs the arrays of one shard "
                             "(ShardedArrays.shard)")
        return WideArrays(
            nodes=self.nodes[0], tri_rows=self.tri_rows[0],
            num_tlas=self.num_tlas, max_leaf_tris=self.max_leaf_tris,
            depth=self.depth), self.inst_map[0]

    def bytes_per_shard(self) -> int:
        """Scene bytes one rank holds: one padded row of the pools and
        of ``inst_map``."""
        return int(self.nodes.shape[1] * self.nodes.shape[2] * 4
                   + self.tri_rows.shape[1] * self.tri_rows.shape[2] * 4
                   + self.inst_map.shape[1] * 4)


def memory_table(sharded: ShardedArrays, sb_full: SceneBuffers) -> dict:
    """Scene bytes a rank holds, replicated against sharded: the whole
    4-wide pool (``replicated_bytes``), one padded shard
    (``sharded_per_chip_bytes``), and their ratio."""
    wa = WideArrays.from_scene(sb_full)
    replicated = int(wa.nodes.numel() * 4 + wa.tri_rows.numel() * 4)
    per_chip = sharded.bytes_per_shard()
    return {
        "replicated_bytes": replicated,
        "sharded_per_chip_bytes": per_chip,
        "n_shards": sharded.n_shards,
        "ratio": per_chip / max(replicated, 1),
    }


def build_sharded(scene: Scene, n_shards: int,
                  config: Optional[RTConfig] = None
                  ) -> Tuple[ShardedArrays, SceneBuffers]:
    """Bin-pack the instances and pack every shard on the host: (the
    stacked ``ShardedArrays`` on the CPU, the whole scene's buffers).
    Each shard's sub-scene adds every mesh (so leaf rows keep global
    triangle ids) but only its own instances (so its pool holds only
    their BLASes); the pools are padded to one TLAS region, one leaf row
    width and one row count."""
    shards = bin_pack_instances(scene, n_shards)
    sb_full = scene.build(config)

    # the replicated routing tables: each instance's world box (its
    # mesh box's eight corners transformed) and owner shard
    n_inst = len(scene._instances)
    inst_aabb = np.zeros((n_inst, 6), np.float32)
    inst_owner = np.zeros(n_inst, np.int32)
    for s, owned in enumerate(shards):
        for gi in owned:
            inst_owner[gi] = s
    for gi, (mi, tf, _) in enumerate(scene._instances):
        lo, hi = scene._meshes[mi].aabb()
        corners = np.array([[x, y, z, 1.0]
                            for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1])
                            for z in (lo[2], hi[2])], np.float32)
        wc = corners @ np.asarray(tf, np.float32).T
        inst_aabb[gi, :3] = wc[:, :3].min(0)
        inst_aabb[gi, 3:] = wc[:, :3].max(0)

    was, imaps = [], []
    for owned in shards:
        sub = Scene()
        for m in scene._meshes:
            sub.add_mesh(m)
        for gi in owned:
            mi, tf, refl = scene._instances[gi]
            sub.add_instance(mi, tf, refl)
        was.append(WideArrays.from_scene(sub.build(config)))
        imaps.append(np.asarray(owned, np.int32))
    num_tlas = max(wa.num_tlas for wa in was)
    max_leaf = max([1] + [wa.max_leaf_tris for wa in was])
    depth = max(wa.depth for wa in was)

    nodes_l, rows_l = [], []
    for wa in was:
        nodes_l.append(_pad_tlas_region(wa.nodes.numpy(), wa.num_tlas,
                                        num_tlas))
        rows = wa.tri_rows.numpy()
        if wa.max_leaf_tris < max_leaf:
            rows = np.concatenate(
                [rows, np.zeros((rows.shape[0],
                                 16 * (max_leaf - wa.max_leaf_tris)),
                                np.float32)], axis=1)
        rows_l.append(rows)

    def stack_pad(arrs):
        nmax = max(a.shape[0] for a in arrs)
        out = np.zeros((len(arrs), nmax) + arrs[0].shape[1:], arrs[0].dtype)
        for i, a in enumerate(arrs):
            out[i, :a.shape[0]] = a
        return torch.from_numpy(out)

    return ShardedArrays(
        nodes=stack_pad(nodes_l), tri_rows=stack_pad(rows_l),
        inst_map=stack_pad(imaps), inst_aabb=torch.from_numpy(inst_aabb),
        inst_owner=torch.from_numpy(inst_owner), num_tlas=num_tlas,
        max_leaf_tris=max_leaf, depth=depth, n_shards=n_shards,
        shard_ids=tuple(range(n_shards))), sb_full


def _hits(dist, bx, by, tri, inst) -> Hits:
    return Hits(dist=dist, bx=bx, by=by, bz=1.0 - bx - by, tri=tri,
                inst=inst)


def _f32_bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _replicate_walk(mesh: Mesh, sp_axis: str, wa_local: WideArrays,
                    inst_map: torch.Tensor):
    """The ``replicate`` schedule's walk: every peer traces every ray on
    its shard, and the hits combine by the lexicographic (t, global
    instance, triangle) minimum over ``sp_axis``."""
    n_inst = inst_map.shape[0]

    def walk(wa, o, d, active=None, t_max=None, occlusion=False):
        h, st = trace_packets_walk(wa_local, o, d, active=active,
                                   t_max=t_max, occlusion=occlusion)
        steps = st.sum()
        if occlusion:
            # an occluded ray reports a distance inside its clamp
            dist = mesh.all_reduce(h.dist, "min", sp_axis)
            return _hits(dist, h.bx, h.by, h.tri, h.inst), steps
        ginst = inst_map[h.inst.clamp(0, n_inst - 1).long()]
        tmin = mesh.all_reduce(h.dist, "min", sp_axis)
        is_hit = tmin < LARGE_FLOAT
        on_min = (h.dist == tmin) & is_hit
        imin = mesh.all_reduce(torch.where(on_min, ginst, _I32MAX), "min",
                               sp_axis)
        on_min = on_min & (ginst == imin)
        trimin = mesh.all_reduce(torch.where(on_min, h.tri, _I32MAX), "min",
                                 sp_axis)
        win = on_min & (h.tri == trimin)
        # one peer holds the winner: the sum of its bits and zeros is it
        bxy = mesh.all_reduce(torch.where(
            win, torch.stack([_f32_bits(h.bx), _f32_bits(h.by)]), 0),
            "sum", sp_axis).view(torch.float32)
        zero = torch.zeros_like(trimin)
        return _hits(torch.where(is_hit, tmin, LARGE_FLOAT), bxy[0], bxy[1],
                     torch.where(is_hit, trimin, zero),
                     torch.where(is_hit, imin, zero)), steps

    return walk


def _alltoall_walk(mesh: Mesh, sp_axis: str, wa_local: WideArrays,
                   inst_map: torch.Tensor, inst_aabb: torch.Tensor,
                   inst_owner: torch.Tensor):
    """The ``alltoall`` schedule's walk: each ray of this peer's home
    slice visits the owners of its TLAS candidates near to far, one
    exchange there and one back a visit, and the home values are
    broadcast over ``sp_axis`` at the end."""
    S = mesh.shape[sp_axis]
    me = mesh.coords[sp_axis]
    n_inst = inst_map.shape[0]
    lo, hi = inst_aabb[:, :3], inst_aabb[:, 3:]

    def walk(wa, o, d, active=None, t_max=None, occlusion=False):
        r, dev = o.shape[0], o.device
        big = torch.full((r,), LARGE_FLOAT, dtype=torch.float32, device=dev)
        act = (torch.ones(r, dtype=torch.bool, device=dev) if active is None
               else active)
        tc = big if t_max is None else t_max
        ox, oy, oz = o.unbind(1)
        dx, dy, dz = d.unbind(1)

        # candidates: slab tests of every ray against every instance's
        # world box (I is small), with the walks' reciprocal clamp
        inv = safe_rcp(d)
        t1 = (lo[:, None, :] - o[None]) * inv[None]      # (I, R, 3)
        t2 = (hi[:, None, :] - o[None]) * inv[None]
        tmin_i = torch.minimum(t1, t2).amax(-1)
        tmax_i = torch.maximum(t1, t2).amin(-1)
        cand = ((tmax_i >= tmin_i) & (tmax_i > 0.0) & (tmin_i < tc[None])
                & act[None])
        enter = torch.where(cand, tmin_i.clamp_min(0.0), LARGE_FLOAT)
        # nearest candidate entry of each owner (S, R), owners near to far
        # (a stable sort: ties in owner order)
        d_owner = torch.stack([
            torch.where((inst_owner == s)[:, None], enter, LARGE_FLOAT)
            .amin(0) for s in range(S)])
        d_sorted, owner_sorted = torch.sort(d_owner, dim=0, stable=True)

        best_t = big.clone()
        best_i = torch.full((r,), _I32MAX, dtype=torch.int32, device=dev)
        best_tri = best_i.clone()
        best_bx = torch.zeros_like(big)
        best_by = torch.zeros_like(big)
        occluded = torch.zeros(r, dtype=torch.bool, device=dev)
        steps = torch.zeros((), dtype=torch.int64, device=dev)
        s_ids = torch.arange(S, device=dev)[:, None]
        # every peer makes the same rays; each routes only its own
        # contiguous home slice
        lane = torch.arange(r, device=dev)
        home = (lane * S) // r == me
        for k in range(S):
            dest = owner_sorted[k]
            # a settled hit (or occlusion) before this owner's nearest
            # candidate box prunes the visit
            want = (act & home & (d_sorted[k] < LARGE_FLOAT)
                    & (d_sorted[k] < best_t) & ~occluded)
            m = (dest[None] == s_ids) & want[None]               # (S, R)
            zero, one = torch.zeros_like(big), torch.ones_like(big)
            send = torch.stack([
                torch.where(m, ox, zero), torch.where(m, oy, zero),
                torch.where(m, oz, zero), torch.where(m, dx, zero),
                torch.where(m, dy, one), torch.where(m, dz, zero),
                torch.where(m, tc, -one), m.to(torch.float32)], 2)
            f = mesh.all_to_all(send, sp_axis).reshape(S * r, 8)
            r_act = f[:, 7] > 0.5
            h, st = trace_packets_walk(
                wa_local, f[:, 0:3].contiguous(), f[:, 3:6].contiguous(),
                active=r_act, t_max=f[:, 6].contiguous(),
                occlusion=occlusion)
            steps = steps + st.sum()
            ginst = inst_map[h.inst.clamp(0, n_inst - 1).long()]
            ret = torch.stack([h.dist, h.bx, h.by,
                               h.tri.view(torch.float32),
                               ginst.view(torch.float32)], 1)
            back = mesh.all_to_all(ret.reshape(S, r, 5), sp_axis)
            mine = back.gather(0, dest.view(1, r, 1).expand(1, r, 5))[0]
            t_k = torch.where(want, mine[:, 0], big)
            if occlusion:
                occluded = occluded | (want & (t_k < tc))
                continue
            tri_k = mine[:, 3].contiguous().view(torch.int32)
            i_k = mine[:, 4].contiguous().view(torch.int32)
            hit_k = t_k < LARGE_FLOAT
            better = (t_k < best_t) | (
                (t_k == best_t) & hit_k
                & ((i_k < best_i) | ((i_k == best_i) & (tri_k < best_tri))))
            best_t = torch.where(better, t_k, best_t)
            best_i = torch.where(better, i_k, best_i)
            best_tri = torch.where(better, tri_k, best_tri)
            best_bx = torch.where(better, mine[:, 1], best_bx)
            best_by = torch.where(better, mine[:, 2], best_by)

        # broadcast each home slice's values to every peer: one peer adds
        # its bits, the others zeros
        zero_i = torch.zeros(r, dtype=torch.int32, device=dev)
        if occlusion:
            occ = mesh.all_reduce(torch.where(home & occluded, 1, zero_i),
                                  "sum", sp_axis) > 0
            return _hits(torch.where(occ, 0.0, big), torch.zeros_like(big),
                         torch.zeros_like(big), zero_i, zero_i), steps
        is_hit = best_t < LARGE_FLOAT
        packed = torch.stack([
            _f32_bits(torch.where(is_hit, best_t, 0.0)), _f32_bits(best_bx),
            _f32_bits(best_by), torch.where(is_hit, best_tri, zero_i),
            torch.where(is_hit, best_i, zero_i), is_hit.to(torch.int32)])
        tot = mesh.all_reduce(torch.where(home[None], packed, 0), "sum",
                              sp_axis)
        hit_all = tot[5] > 0
        return _hits(torch.where(hit_all, tot[0].view(torch.float32), big),
                     tot[1].view(torch.float32), tot[2].view(torch.float32),
                     tot[3], tot[4]), steps

    return walk


def make_sharded_wavefront(mesh: Mesh, width: int, height: int,
                           max_depth: int = 2, spp: int = 1,
                           shadow: bool = False, pathtrace: bool = False,
                           packet: int = 256, tile_w: int = 16,
                           tile_h: int = 8, dp_axis: str = "dp",
                           sp_axis: str = "sp",
                           schedule: str = "replicate",
                           accounting: bool = False):
    """The frame over the ``(dp, sp)`` mesh: step(sharded, sa, cam,
    light) -> ((rows, W, 3) radiance of this rank's row block, the rays
    of the frame, the walk steps of every rank), the counts as 0-dim
    int64 tensors; ``sharded`` holds this rank's shard
    (``ShardedArrays.shard``).  ``schedule`` is "replicate" or "alltoall"
    (the module docstring).  ``accounting`` is the JAX package's switch
    from loop iterations to live-ray steps; the port's steps are its
    per-ray walk steps either way (H19)."""
    del accounting
    n_dp = mesh.shape[dp_axis]
    if height % n_dp:
        raise ValueError(f"height {height} not divisible by {n_dp} row "
                         "blocks")
    if schedule not in ("replicate", "alltoall"):
        raise ValueError(f"unknown schedule {schedule!r}")
    rows_local = height // n_dp
    n_pix_local = rows_local * width
    table = (ShaderTable(closest=pathtrace_closest) if pathtrace
             else ShaderTable())

    def step(sharded: ShardedArrays, sa, cam: CameraArrays,
             light: LightArrays):
        if sharded.shard_ids != (mesh.coords[sp_axis],):
            raise ValueError("the rank must hold its own shard "
                             f"({mesh.coords[sp_axis]}), not "
                             f"{sharded.shard_ids}")
        wa_local, inst_map = sharded.local()
        if schedule == "alltoall":
            walk = _alltoall_walk(mesh, sp_axis, wa_local, inst_map,
                                  sharded.inst_aabb, sharded.inst_owner)
        else:
            walk = _replicate_walk(mesh, sp_axis, wa_local, inst_map)
        img, rays, steps = frame_body(
            wa_local, sa, cam, light, width, height, max_depth=max_depth,
            spp=spp, table=table, seed=0, shadow=shadow, tile_w=tile_w,
            tile_h=tile_h, walk=walk, packet=packet, n_pix=n_pix_local,
            pix_offset=mesh.coords[dp_axis] * n_pix_local)
        # every sp peer counts the same rays; the steps are each rank's own
        return (img.reshape(3, rows_local, width).permute(1, 2, 0),
                mesh.all_reduce(rays, "sum", dp_axis),
                mesh.all_reduce(steps, "sum", None))

    return step


def render_sharded(scene: Scene, cam: Camera, params: RenderParams,
                   width: int, height: int, n_shards: int,
                   mesh: Optional[Mesh] = None, packet: int = 256,
                   schedule: str = "replicate", return_steps: bool = False,
                   accounting: bool = False,
                   config: Optional[RTConfig] = None, device=None):
    """Host API: bin-pack, shard and render over a ``(dp, sp)`` mesh of
    every rank (``dp = world // n_shards``, each rank on ``device``;
    ``parallel.mesh.default_device`` when None) -> ((H, W, 3) image,
    rays), and the steps of every rank third with ``return_steps``, on
    every rank.  ``config`` builds the scene (4-wide TLAS)."""
    import torch.distributed as dist

    if mesh is None:
        world = dist.get_world_size()
        if world % n_shards:
            raise ValueError(f"{world} ranks do not divide into "
                             f"{n_shards} shards")
        mesh = Mesh.create(("dp", "sp"), (world // n_shards, n_shards),
                           device=device)
    if mesh.shape["sp"] != n_shards:
        raise ValueError(f"the mesh has {mesh.shape['sp']} shards, not "
                         f"{n_shards}")
    sharded, sb_full = build_sharded(scene, n_shards, config)
    mine = sharded.shard(mesh.coords["sp"], mesh.device)
    del sharded
    dev = mesh.device
    step = make_sharded_wavefront(
        mesh, width, height, params.max_depth, params.spp,
        shadow=params.shadow, pathtrace=params.pathtrace, packet=packet,
        schedule=schedule, accounting=accounting)
    img, total, steps = step(mine, ShadeArrays.from_scene(sb_full).to(dev),
                             CameraArrays.from_camera(cam, dev),
                             LightArrays.from_params(params, dev))
    img = mesh.all_gather(img, "dp").cpu().numpy()
    if return_steps:
        return img, int(total), int(steps)
    return img, int(total)
