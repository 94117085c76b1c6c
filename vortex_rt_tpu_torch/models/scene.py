"""Scene assembly: meshes -> packed global SoA buffers + BLAS/TLAS + camera
(port of ``vortex_rt_tpu/models/scene.py``).

Host-side NumPy, as in the JAX package: ``Scene.build`` packs per-mesh
triangle/material/texture data into global buffers with running offsets
and builds the binary BVHs; :class:`SceneBuffers` is the packed result.
The BLAS builds go to the native C++ builder by default, as in the JAX
package; with ``RTConfig(use_native_build=False)`` on both sides the
builds are bit-identical to the JAX package's NumPy builder.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from vortex_rt_tpu_torch.accel.bvh2 import (
    BVH2, build_bvh2_aabbs, build_bvh2_auto,
)
from vortex_rt_tpu_torch.utils import vecmath as vm
from vortex_rt_tpu_torch.utils.config import RTConfig


@dataclasses.dataclass
class Material:
    """Material record (the reference's material_info_t)."""

    ambient: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    diffuse: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    shininess: float = 0.0
    ior: float = 1.0
    dissolve: float = 1.0
    reflectivity: float = 0.0
    illum: int = 2
    diffuse_tex: Optional[np.ndarray] = None  # (h, w) uint32 0xRRGGBB texels


@dataclasses.dataclass
class MeshData:
    """Triangle soup for one mesh.  All arrays are (T, ...) float32/int32;
    mat_id is local to this mesh's material list until Scene.build
    rebases it."""

    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    n0: np.ndarray
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray
    uv1: np.ndarray
    uv2: np.ndarray
    mat_id: np.ndarray
    materials: List[Material]

    @property
    def num_tris(self) -> int:
        return int(self.v0.shape[0])

    def validate(self) -> "MeshData":
        t = self.num_tris
        for name in ("v0", "v1", "v2", "n0", "n1", "n2"):
            if getattr(self, name).shape != (t, 3):
                raise ValueError(f"{name}: shape {getattr(self, name).shape}")
        for name in ("uv0", "uv1", "uv2"):
            if getattr(self, name).shape != (t, 2):
                raise ValueError(f"{name}: shape {getattr(self, name).shape}")
        if self.mat_id.shape != (t,):
            raise ValueError(f"mat_id: shape {self.mat_id.shape}")
        if self.mat_id.max(initial=0) >= max(len(self.materials), 1):
            raise ValueError("mat_id out of range of the material list")
        return self

    def aabb(self) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.minimum(np.minimum(self.v0, self.v1), self.v2).min(0)
        hi = np.maximum(np.maximum(self.v0, self.v1), self.v2).max(0)
        return lo, hi


def flat_normals(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Geometric normals for meshes without vertex normals."""
    n = vm.cross(v1 - v0, v2 - v0)
    return vm.normalize(n)


def make_mesh(
    v0, v1, v2, n0=None, n1=None, n2=None, uv0=None, uv1=None, uv2=None,
    mat_id=None, materials=None,
) -> MeshData:
    v0, v1, v2 = (np.asarray(a, np.float32) for a in (v0, v1, v2))
    t = v0.shape[0]
    if n0 is None:
        n0 = n1 = n2 = flat_normals(v0, v1, v2)
    zuv = np.zeros((t, 2), np.float32)
    return MeshData(
        v0=v0, v1=v1, v2=v2,
        n0=np.asarray(n0, np.float32),
        n1=np.asarray(n1, np.float32),
        n2=np.asarray(n2, np.float32),
        uv0=zuv if uv0 is None else np.asarray(uv0, np.float32),
        uv1=zuv if uv1 is None else np.asarray(uv1, np.float32),
        uv2=zuv if uv2 is None else np.asarray(uv2, np.float32),
        mat_id=(np.zeros(t, np.int32) if mat_id is None
                else np.asarray(mat_id, np.int32)),
        materials=list(materials) if materials else [Material()],
    ).validate()


@dataclasses.dataclass
class Camera:
    pos: np.ndarray       # (3,)
    forward: np.ndarray   # (3,)
    right: np.ndarray     # (3,)
    up: np.ndarray        # (3,)
    viewplane: np.ndarray  # (2,) = (width, height) at unit distance

    @staticmethod
    def look_at(pos, target, up, vfov_deg: float, aspect: float) -> "Camera":
        """Camera + viewplane setup (vfov in degrees)."""
        pos = np.asarray(pos, np.float32)
        forward = np.asarray(vm.normalize(np.asarray(target, np.float32) - pos))
        right = np.asarray(vm.normalize(vm.cross(forward, np.asarray(up, np.float32))))
        true_up = np.asarray(vm.cross(right, forward), np.float32)
        vh = 2.0 * np.tan(np.deg2rad(vfov_deg) * 0.5)
        vw = vh * aspect
        return Camera(pos, forward.astype(np.float32), right.astype(np.float32),
                      true_up, np.array([vw, vh], np.float32))

    def as_arrays(self):
        return (self.pos, self.forward, self.right, self.up, self.viewplane)


@dataclasses.dataclass
class RenderParams:
    """Lighting + integrator parameters."""

    light_pos: Tuple[float, float, float] = (0.0, 100.0, 0.0)
    light_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    ambient_color: Tuple[float, float, float] = (0.2, 0.2, 0.2)
    background_color: Tuple[float, float, float] = (0.2, 0.3, 0.5)
    spp: int = 1
    max_depth: int = 2
    shadow: bool = False     # occlusion-tested direct lighting (shadow rays)
    pathtrace: bool = False  # sampled diffuse bounces (path-traced GI)


@dataclasses.dataclass
class SceneBuffers:
    """Every host array the render step's tables are built from (NumPy)."""

    # triangle soup (global, all meshes packed)
    v0: np.ndarray; v1: np.ndarray; v2: np.ndarray          # (T, 3)
    n0: np.ndarray; n1: np.ndarray; n2: np.ndarray          # (T, 3)
    uv0: np.ndarray; uv1: np.ndarray; uv2: np.ndarray       # (T, 2)
    mat_id: np.ndarray                                       # (T,) i32 global

    # materials SoA
    mat_ambient: np.ndarray; mat_diffuse: np.ndarray        # (M, 3)
    mat_specular: np.ndarray; mat_emissive: np.ndarray      # (M, 3)
    mat_shininess: np.ndarray; mat_ior: np.ndarray          # (M,)
    mat_dissolve: np.ndarray; mat_reflectivity: np.ndarray  # (M,)
    mat_tex_offset: np.ndarray                               # (M,) i32, -1 = none
    mat_tex_w: np.ndarray; mat_tex_h: np.ndarray            # (M,) i32

    # texel pool
    texels: np.ndarray                                       # (X,) uint32 0xRRGGBB

    # per-mesh binary BVHs packed into one node pool (leaf tri ids global)
    bvh_min: np.ndarray; bvh_max: np.ndarray                # (N, 3)
    bvh_left: np.ndarray; bvh_count: np.ndarray             # (N,) i32
    bvh_tri_idx: np.ndarray                                  # (T,) i32

    # instances
    inst_transform: np.ndarray       # (I, 4, 4)
    inst_inv_transform: np.ndarray   # (I, 4, 4)
    inst_inv_transpose: np.ndarray   # (I, 4, 4) — normal matrix
    inst_reflectivity: np.ndarray    # (I,)
    inst_bvh_root: np.ndarray        # (I,) i32 node index into bvh pool
    inst_aabb_min: np.ndarray        # (I, 3) world-space bounds
    inst_aabb_max: np.ndarray        # (I, 3)

    # TLAS: binary BVH over instance world AABBs (leaves = instance ids)
    tlas_min: np.ndarray; tlas_max: np.ndarray              # (K, 3)
    tlas_left: np.ndarray; tlas_count: np.ndarray           # (K,) i32
    tlas_inst_idx: np.ndarray                                # (I,) i32

    # flattened build (RTConfig.flatten): world-space geometry, identity
    # instance transforms, ONE tree over all tris; tri_inst maps each
    # global tri to its owning instance
    flat: bool = False
    tri_inst: Optional[np.ndarray] = None                    # (T,) i32

    @property
    def num_tris(self) -> int:
        return int(self.v0.shape[0])

    @property
    def num_instances(self) -> int:
        return int(self.inst_bvh_root.shape[0])

    def scene_aabb(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.inst_aabb_min.min(0), self.inst_aabb_max.max(0)


class Scene:
    """Mesh registry + instancing + build."""

    def __init__(self) -> None:
        self._meshes: List[MeshData] = []
        self._instances: List[Tuple[int, np.ndarray, float]] = []

    def add_mesh(self, mesh: MeshData) -> int:
        self._meshes.append(mesh.validate())
        return len(self._meshes) - 1

    def add_instance(self, mesh_index: int, transform: Optional[np.ndarray] = None,
                     reflectivity: float = 0.0) -> int:
        if transform is None:
            transform = vm.mat4_identity()
        self._instances.append(
            (mesh_index, np.asarray(transform, np.float32), float(reflectivity))
        )
        return len(self._instances) - 1

    def build(self, config: Optional[RTConfig] = None) -> SceneBuffers:
        cfg = config or RTConfig()
        if not self._meshes:
            raise ValueError("no meshes")
        if not self._instances:
            for i in range(len(self._meshes)):
                self.add_instance(i)

        meshes, instances = self._meshes, self._instances
        if cfg.flatten:
            # bake every instance transform into a world-space mesh copy;
            # one instance per mesh, in instance order
            ident = vm.mat4_identity()
            meshes, instances = [], []
            for mi, T, refl in self._instances:
                m = self._meshes[mi]
                if np.array_equal(T, ident):
                    meshes.append(m)
                else:
                    inv = vm.mat4_inverse(T)
                    nmat = inv[:3, :3]  # rows: n' = n @ inv = (inv^T) n
                    meshes.append(dataclasses.replace(
                        m,
                        v0=vm.transform_point(T, m.v0),
                        v1=vm.transform_point(T, m.v1),
                        v2=vm.transform_point(T, m.v2),
                        n0=(m.n0 @ nmat).astype(np.float32),
                        n1=(m.n1 @ nmat).astype(np.float32),
                        n2=(m.n2 @ nmat).astype(np.float32)))
                instances.append((len(meshes) - 1, ident, refl))

        # ---- pack triangle + material + texture buffers with offsets ----
        tri_arrays = {k: [] for k in
                      ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2")}
        mat_ids, mats = [], []
        texels: List[np.ndarray] = []
        tex_cursor = 0
        mat_tex = []  # (offset, w, h) per material
        mesh_tri_offset = []
        tri_cursor = mat_cursor = 0
        for mesh in meshes:
            mesh_tri_offset.append(tri_cursor)
            for k in tri_arrays:
                tri_arrays[k].append(getattr(mesh, k))
            mat_ids.append(mesh.mat_id + mat_cursor)
            for m in mesh.materials:
                mats.append(m)
                if m.diffuse_tex is not None:
                    th, tw = m.diffuse_tex.shape
                    mat_tex.append((tex_cursor, tw, th))
                    texels.append(np.ascontiguousarray(m.diffuse_tex, np.uint32).ravel())
                    tex_cursor += tw * th
                else:
                    mat_tex.append((-1, 0, 0))
            tri_cursor += mesh.num_tris
            mat_cursor += len(mesh.materials)

        tri_inst = None
        if cfg.flatten:
            # ---- ONE world-space BLAS over every instance's triangles ----
            allv0 = np.concatenate(tri_arrays["v0"]).astype(np.float32)
            allv1 = np.concatenate(tri_arrays["v1"]).astype(np.float32)
            allv2 = np.concatenate(tri_arrays["v2"]).astype(np.float32)
            b = build_bvh2_auto(
                allv0, allv1, allv2,
                max_leaf_tris=cfg.max_leaf_tris, sah_bins=cfg.sah_bins,
                prefer_native=cfg.use_native_build)
            bvh_min, bvh_max = b.node_min, b.node_max
            bvh_left = b.left_first.astype(np.int32)
            bvh_count = b.tri_count
            bvh_tri_idx = b.tri_idx.astype(np.int32)
            mesh_bvh_root = [0] * len(meshes)
            tri_inst = np.concatenate([
                np.full(meshes[mi].num_tris, i, np.int32)
                for i, (mi, _, _) in enumerate(instances)])
        else:
            # ---- per-mesh BLAS builds into one node pool ----
            node_pools: List[BVH2] = []
            mesh_bvh_root = []
            node_cursor = 0
            for mesh in meshes:
                b = build_bvh2_auto(
                    mesh.v0, mesh.v1, mesh.v2,
                    max_leaf_tris=cfg.max_leaf_tris, sah_bins=cfg.sah_bins,
                    prefer_native=cfg.use_native_build)
                mesh_bvh_root.append(node_cursor)
                node_pools.append(b)
                node_cursor += b.num_nodes

            bvh_min = np.concatenate([b.node_min for b in node_pools])
            bvh_max = np.concatenate([b.node_max for b in node_pools])
            # rebase child links by node offset; leaf first-slots and tri
            # ids by the mesh's global tri offset
            lefts, counts, tri_perm = [], [], []
            for b, noff, toff in zip(node_pools, mesh_bvh_root,
                                     mesh_tri_offset):
                internal = b.tri_count == 0
                lefts.append(np.where(internal, b.left_first + noff,
                                      b.left_first + toff).astype(np.int32))
                counts.append(b.tri_count)
                tri_perm.append(b.tri_idx + toff)
            bvh_left = np.concatenate(lefts)
            bvh_count = np.concatenate(counts)
            bvh_tri_idx = np.concatenate(tri_perm).astype(np.int32)

        # ---- instances ----
        n_inst = len(instances)
        inst_T = np.zeros((n_inst, 4, 4), np.float32)
        inst_invT = np.zeros((n_inst, 4, 4), np.float32)
        inst_invTt = np.zeros((n_inst, 4, 4), np.float32)
        inst_refl = np.zeros(n_inst, np.float32)
        inst_root = np.zeros(n_inst, np.int32)
        inst_amin = np.zeros((n_inst, 3), np.float32)
        inst_amax = np.zeros((n_inst, 3), np.float32)
        for i, (mi, T, refl) in enumerate(instances):
            inv = vm.mat4_inverse(T)
            inst_T[i] = T
            inst_invT[i] = inv
            inst_invTt[i] = inv.T
            inst_refl[i] = refl
            inst_root[i] = mesh_bvh_root[mi]
            # world AABB from the 8 transformed local corners
            lo, hi = meshes[mi].aabb()
            corners = vm.transform_point(T, vm.aabb_corners(lo, hi))
            inst_amin[i] = corners.min(0)
            inst_amax[i] = corners.max(0)

        # ---- TLAS over instance world AABBs ----
        tlas = build_bvh2_aabbs(inst_amin, inst_amax, max_leaf_tris=1,
                                sah_bins=cfg.sah_bins)

        def f32(x):
            return np.asarray(x, np.float32)

        return SceneBuffers(
            v0=f32(np.concatenate(tri_arrays["v0"])),
            v1=f32(np.concatenate(tri_arrays["v1"])),
            v2=f32(np.concatenate(tri_arrays["v2"])),
            n0=f32(np.concatenate(tri_arrays["n0"])),
            n1=f32(np.concatenate(tri_arrays["n1"])),
            n2=f32(np.concatenate(tri_arrays["n2"])),
            uv0=f32(np.concatenate(tri_arrays["uv0"])),
            uv1=f32(np.concatenate(tri_arrays["uv1"])),
            uv2=f32(np.concatenate(tri_arrays["uv2"])),
            mat_id=np.concatenate(mat_ids).astype(np.int32),
            mat_ambient=f32([m.ambient for m in mats]),
            mat_diffuse=f32([m.diffuse for m in mats]),
            mat_specular=f32([m.specular for m in mats]),
            mat_emissive=f32([m.emissive for m in mats]),
            mat_shininess=f32([m.shininess for m in mats]),
            mat_ior=f32([m.ior for m in mats]),
            mat_dissolve=f32([m.dissolve for m in mats]),
            mat_reflectivity=f32([m.reflectivity for m in mats]),
            mat_tex_offset=np.asarray([t[0] for t in mat_tex], np.int32),
            mat_tex_w=np.asarray([t[1] for t in mat_tex], np.int32),
            mat_tex_h=np.asarray([t[2] for t in mat_tex], np.int32),
            texels=(np.concatenate(texels).astype(np.uint32) if texels
                    else np.zeros(1, np.uint32)),
            bvh_min=bvh_min, bvh_max=bvh_max,
            bvh_left=bvh_left, bvh_count=bvh_count, bvh_tri_idx=bvh_tri_idx,
            inst_transform=inst_T,
            inst_inv_transform=inst_invT,
            inst_inv_transpose=inst_invTt,
            inst_reflectivity=inst_refl,
            inst_bvh_root=inst_root,
            inst_aabb_min=inst_amin,
            inst_aabb_max=inst_amax,
            tlas_min=tlas.node_min, tlas_max=tlas.node_max,
            tlas_left=tlas.left_first.astype(np.int32),
            tlas_count=tlas.tri_count.astype(np.int32),
            tlas_inst_idx=tlas.tri_idx.astype(np.int32),
            flat=bool(cfg.flatten),
            tri_inst=tri_inst,
        )

    def arrange_around_y(self, margin: float = 0.0) -> None:
        """Position each instance on a circle around Y
        (Scene::arrangeMeshesAroundY): circle radius chosen so adjacent
        footprints don't overlap."""
        n = len(self._instances)
        if n <= 1:
            return
        radii = []
        for mi, T, _ in self._instances:
            lo, hi = self._meshes[mi].aabb()
            corners = vm.transform_point(T, vm.aabb_corners(lo, hi))
            d = corners.max(0) - corners.min(0)
            radii.append(0.5 * float(np.hypot(d[0], d[2])) + margin)
        max_pair = max(radii[i] + radii[(i + 1) % n] for i in range(n))
        step = 2.0 * np.pi / n
        big_r = max_pair / (2.0 * np.sin(step / 2.0))
        for i, (mi, T, refl) in enumerate(self._instances):
            theta = step * i
            shift = vm.mat4_translate(
                [big_r * np.cos(theta), 0.0, big_r * np.sin(theta)])
            self._instances[i] = (mi, (shift @ T).astype(np.float32), refl)

    def apply_transform(self, transform: np.ndarray) -> None:
        """Pre-multiply every instance (Scene::applyTransform)."""
        t = np.asarray(transform, np.float32)
        for i, (mi, T, refl) in enumerate(self._instances):
            self._instances[i] = (mi, (t @ T).astype(np.float32), refl)

    @staticmethod
    def framing_camera(buffers: SceneBuffers, vfov_deg: float, aspect: float,
                       zoom: float = 1.0) -> Camera:
        """Camera on -z looking at the scene's bounding-box center, far
        enough back to frame its bounding sphere."""
        bmin, bmax = buffers.scene_aabb()
        center = (bmin + bmax) * 0.5
        radius = float(vm.length(bmax - center))
        vfov = np.deg2rad(vfov_deg)
        distance = radius / max(np.tan(vfov), 1e-6) * zoom
        pos = center - np.array([0.0, 0.0, 1.0], np.float32) * distance
        return Camera.look_at(pos, center, [0.0, 1.0, 0.0], vfov_deg, aspect)
