"""The port's scene-sharded rendering (``vortex_rt_tpu_torch/parallel/
shards.py``) against the JAX ``parallel.shards``: the shard tables word
for word in process, and the frames on gloo ranks on the CPU.

Tables (the NumPy builder on both sides): ``bin_pack_instances`` on the
scenes of ``tests/test_shards.py``; ``build_sharded``'s stacked
``nodes``, ``tri_rows``, ``inst_map``, ``inst_aabb`` and ``inst_owner``;
``_pad_tlas_region`` on every shard's pool; ``memory_table``'s bytes.

Frames at 64x32 (``render_sharded``, 4-wide TLAS through K2's plain
version), one launch of ranks a world size (``parallel/launch.spawn``:
spawned, a ``file://`` store under pytest's temporary directory, one
torch thread a rank); the JAX images once a module on conftest's 8
virtual devices.  64x32 and not test_shards.py's 64x48: XLA compiles the
JAX camera's ``y / 48`` into ``y * 0.020833334``, an ulp off the true
division for some rows (ROADMAP hazard H20), and on the Cornell box two
such rays meet the exact tie of two walls at a corner and take the other
wall; a power-of-two height divides exactly on both sides.  At 64x48 the
sharded frame is held to the port's own single-device frame and the JAX
ray count, and ``test_h20_jax_camera_is_not_true_division`` pins down
the difference:

* 4 ranks, ``replicate`` at dp=2 x sp=2 on the Cornell scene with a
  sphere, without and with shadow rays, and path traced (spp 2, depth 3,
  shadow rays); ``replicate`` and ``alltoall`` at dp=1 x sp=4 on the
  separated spheres;
* 2 ranks, ``replicate`` and ``alltoall`` at dp=1 x sp=2 on the Cornell
  scene with shadow rays;

each within RMSE 1e-5 of the JAX sharded image and of the port's
single-device frame, with equal rays, the two schedules' totals equal;
and the accounting gate as the JAX test states it, alltoall's per-ray
walk steps below 0.8 of replicate's on the separated spheres at sp=4.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh as JMesh

from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu.models.scene import (
    RenderParams as JParams, Scene as JScene,
)
from vortex_rt_tpu.ops.traverse_wide import WideArrays as JWide
from vortex_rt_tpu.parallel import shards as jshards
from vortex_rt_tpu.utils import vecmath as jvm
from vortex_rt_tpu.utils.config import RTConfig as JCfg

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays as TWide
from vortex_rt_tpu_torch.parallel import launch, shards
from vortex_rt_tpu_torch.utils import vecmath as tvm

W, H = 64, 32
LIGHT = (0, 0.8, -0.5)


def _scene(Scene, proc):
    sc = Scene()
    for mesh, refl in proc.cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    si = sc.add_mesh(proc.uv_sphere((0.0, -0.2, 0.3), 0.25, 8, 12))
    sc.add_instance(si, reflectivity=0.4)
    return sc


def _separated_scene(Scene, proc, vm):
    sc = Scene()
    si = sc.add_mesh(proc.uv_sphere((0.0, 0.0, 0.0), 0.45, 8, 12))
    for i in range(8):
        sc.add_instance(si, vm.mat4_translate(
            [(i % 4) * 1.4 - 2.1, (i // 4) * 1.4 - 0.7, 0.0]),
            reflectivity=0.2 if i % 3 == 0 else 0.0)
    return sc


def _scenes():
    return {"cornell": (_scene(JScene, jproc), _scene(pt.Scene, tproc)),
            "separated": (_separated_scene(JScene, jproc, jvm),
                          _separated_scene(pt.Scene, tproc, tvm))}


# frame cases: (params, scene, shards, world, schedules, size)
PARAMS = {
    "plain": dict(max_depth=2, spp=1, shadow=False),
    "shadow": dict(max_depth=2, spp=1, shadow=True),
    "pathtrace": dict(max_depth=3, spp=2, shadow=True, pathtrace=True,
                      light_pos=LIGHT),
    "separated": dict(max_depth=2, spp=1, shadow=True, light_pos=LIGHT),
}
CASES = [
    ("plain", "cornell", 2, 4, ("replicate",), (W, H)),
    ("shadow", "cornell", 2, 4, ("replicate",), (W, H)),
    ("pathtrace", "cornell", 2, 4, ("replicate",), (W, H)),
    ("separated", "separated", 4, 4, ("replicate", "alltoall"), (W, H)),
    ("shadow", "cornell", 2, 2, ("replicate", "alltoall"), (W, H)),
    ("shadow", "cornell", 2, 2, ("replicate",), (64, 48)),
]


@pytest.fixture(scope="module")
def scenes():
    return _scenes()


@pytest.mark.parametrize("name,n", [("cornell", 3), ("cornell", 2),
                                    ("separated", 4), ("separated", 3)])
def test_bin_pack_matches_jax(scenes, name, n):
    jsc, tsc = scenes[name]
    got = shards.bin_pack_instances(tsc, n)
    assert got == jshards.bin_pack_instances(jsc, n)
    assert sorted(i for s in got for i in s) == list(range(
        len(tsc._instances)))


@pytest.mark.parametrize("name,n", [("cornell", 2), ("separated", 4)])
def test_build_sharded_matches_jax(scenes, name, n):
    jsc, tsc = scenes[name]
    jsh, jsb = jshards.build_sharded(jsc, n, JCfg(use_native_build=False))
    tsh, tsb = shards.build_sharded(tsc, n, pt.RTConfig(
        use_native_build=False))
    assert (tsh.num_tlas, tsh.max_leaf_tris, tsh.depth) == (
        jsh.num_tlas, jsh.max_leaf_tris, jsh.depth)
    assert tsh.n_shards == n and tsh.shard_ids == tuple(range(n))
    for f in ("nodes", "tri_rows", "inst_map", "inst_aabb", "inst_owner"):
        got, want = getattr(tsh, f).numpy(), np.asarray(getattr(jsh, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=f)
    want = jshards.memory_table(jsh, jsb)
    assert shards.memory_table(tsh, tsb) == want
    # one rank's shard: its row, and the bytes it holds
    mine = tsh.shard(1)
    wa, imap = mine.local()
    assert mine.shard_ids == (1,) and mine.bytes_per_shard() == \
        want["sharded_per_chip_bytes"]
    np.testing.assert_array_equal(wa.nodes.numpy(), tsh.nodes[1].numpy())
    np.testing.assert_array_equal(imap.numpy(), tsh.inst_map[1].numpy())
    with pytest.raises(ValueError):
        tsh.local()


@pytest.mark.parametrize("name,n", [("cornell", 2), ("separated", 4)])
def test_pad_tlas_region_matches_jax(scenes, name, n):
    """Every shard's pool padded to a larger TLAS region, word for word
    the JAX padding of the same pool."""
    jsc, tsc = scenes[name]
    for owned in shards.bin_pack_instances(tsc, n):
        subs = []
        for sc, Scene, Wide, cfg in (
                (jsc, JScene, JWide,
                 JCfg(use_native_build=False)),
                (tsc, pt.Scene, TWide, pt.RTConfig(use_native_build=False))):
            sub = Scene()
            for m in sc._meshes:
                sub.add_mesh(m)
            for gi in owned:
                mi, tf, refl = sc._instances[gi]
                sub.add_instance(mi, tf, refl)
            subs.append(Wide.from_scene(sub.build(cfg)))
        jwa, twa = subs
        k = twa.num_tlas
        for pad in (0, 3):
            want = jshards._pad_tlas_region(np.asarray(jwa.nodes), k,
                                            k + pad)
            got = shards._pad_tlas_region(twa.nodes.numpy(), k, k + pad)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.fixture(scope="module")
def frames(scenes, tmp_path_factory):
    """Per case: the JAX sharded image and rays, the port's single-device
    frame, and every rank's results of each schedule; one launch a world
    size."""
    out = {}
    for world in (4, 2):
        calls, keys = [], []
        for name, scene, n, w_, schedules, (w, h) in CASES:
            if w_ != world:
                continue
            jsc, tsc = scenes[scene]
            jsb = jsc.build()
            jcam = JScene.framing_camera(jsb, 45.0, w / h)
            jp = JParams(**PARAMS[name])
            devs = np.array(jax.devices()[:8]).reshape(8 // n, n)
            jimg, jrays = jshards.render_sharded(
                jsc, jcam, jp, w, h, n_shards=n,
                mesh=JMesh(devs, ("dp", "sp")), schedule=schedules[-1])
            tsb = tsc.build()
            tcam = pt.Scene.framing_camera(tsb, 45.0, w / h)
            tp = pt.RenderParams(**PARAMS[name])
            ref = pt.WavefrontRenderer.from_buffers(tsb, device="cpu") \
                .render(tcam, tp, w, h)
            for schedule in schedules:
                calls.append((shards.render_sharded,
                              (tsc, tcam, tp, w, h, n),
                              dict(schedule=schedule, return_steps=True,
                                   accounting=True, device="cpu")))
                keys.append((name, world, schedule, h))
                out[keys[-1]] = dict(jax=(np.asarray(jimg), jrays), ref=ref)
        res = launch.spawn(launch.call_all, world, (calls,), threads=1,
                           store_dir=str(tmp_path_factory.mktemp("store")),
                           timeout=600)
        for i, key in enumerate(keys):
            out[key]["ranks"] = [r[i] for r in res]
    return out


def _rmse(a, b):
    return float(np.sqrt(((np.asarray(a) - np.asarray(b)) ** 2).mean()))


@pytest.mark.parametrize("name,world,schedule", [
    ("plain", 4, "replicate"), ("shadow", 4, "replicate"),
    ("pathtrace", 4, "replicate"), ("separated", 4, "replicate"),
    ("separated", 4, "alltoall"), ("shadow", 2, "replicate"),
    ("shadow", 2, "alltoall")])
def test_sharded_matches_jax_and_one_device(frames, name, world, schedule):
    case = frames[(name, world, schedule, H)]
    img, rays, steps = case["ranks"][0]
    for r in case["ranks"][1:]:  # every rank gathered the same frame
        np.testing.assert_array_equal(r[0], img)
        assert r[1:] == (rays, steps)
    jimg, jrays = case["jax"]
    ref, ref_rays = case["ref"]
    assert img.shape == (H, W, 3) and steps > 0
    assert rays == jrays == ref_rays
    if name == "pathtrace":
        assert rays > W * H * 2  # bounce and shadow rays traced
    assert _rmse(img, jimg) < 1e-5
    assert _rmse(img, ref) < 1e-5


@pytest.mark.parametrize("name,world", [("separated", 4), ("shadow", 2)])
def test_schedules_agree_and_alltoall_cuts_steps(frames, name, world):
    """Equal totals across the two schedules; on the separated spheres at
    sp=4 the routed schedule walks fewer steps (the JAX gate: below 0.8
    of replicate's)."""
    a = frames[(name, world, "alltoall", H)]["ranks"][0]
    r = frames[(name, world, "replicate", H)]["ranks"][0]
    assert a[1] == r[1]
    assert _rmse(a[0], r[0]) < 1e-5
    if name == "separated":
        assert a[2] < 0.8 * r[2], (a[2], r[2])
    else:
        assert a[2] <= r[2], (a[2], r[2])


def test_sharded_at_64x48_matches_one_device(frames):
    """test_shards.py's size: the sharded frame equals the port's
    single-device frame, with the JAX frame's rays (its image differs at
    the corner rays of H20)."""
    case = frames[("shadow", 2, "replicate", 48)]
    img, rays, _ = case["ranks"][0]
    ref, ref_rays = case["ref"]
    assert img.shape == (48, 64, 3)
    assert rays == ref_rays == case["jax"][1]
    assert _rmse(img, ref) < 1e-5


@pytest.mark.parametrize("h,differs", [(48, True), (32, False)])
def test_h20_jax_camera_is_not_true_division(h, differs):
    """The camera's normalised row coordinate ``(py + 0.5) / h - 0.5``:
    the port divides truly (``_camera_from_pix`` divides by a 0-dim
    tensor, H6), as the JAX expression does op by op; jitted, XLA
    multiplies by the rounded reciprocal of the height, which moves some
    rows by an ulp unless the height is a power of two."""
    import jax.numpy as jnp
    import torch

    def ndc(y):
        return (y + 0.5) / h - 0.5

    y = np.arange(h, dtype=np.float32)
    eager = np.asarray(ndc(jnp.asarray(y)))
    jitted = np.asarray(jax.jit(ndc)(jnp.asarray(y)))
    port = ((torch.from_numpy(y) + 0.5)
            / torch.tensor(float(h), dtype=torch.float32) - 0.5).numpy()
    np.testing.assert_array_equal(port.view(np.uint32),
                                  eager.view(np.uint32))
    assert (jitted != eager).any() == differs
