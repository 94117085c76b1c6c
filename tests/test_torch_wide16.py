"""16-wide BVH rows in the port (``RTConfig(bvh_width=16)``) against the
JAX package, on the CPU.

* Tables: the port's ``WideArrays.from_scene(sb, 16)`` rows (40-word
  nodes, the leaf rows, ``fuse()``'s 40 + 16*k words and
  ``with_alpha()``'s 40 + 24*k, the alpha rows and pool) word for word
  against the JAX package's, on the scene of ``tests/test_wide16.py``
  (a box, a sphere and a 300-triangle random soup as three instances of
  one flattened build) and on the textured cutout scene of
  ``tests/test_torch_anyhit.py``; the bridge carries the JAX tables
  across to the same words; the meta word's views (kind, nchild,
  left_first) read 5-bit child counts.
* The port's copy of Batcher's 16-slot network equals the JAX one and
  sorts 100 seeded permutations.
* The plain walk at width 16 (``trace_packets`` on CPU tensors) against
  the JAX ``trace_packets(..., packet=32)`` at width 16: 32x32 camera
  rays, 512 incoherent rays, occlusion with ``t_max`` and a mixed
  ``occl_split`` wave; the alpha cutout and the checker predicate on the
  cutout scene.  ``dist``, ``bx``, ``by``, ``tri`` and ``inst`` equal to
  the bit, and equal to the port's 8-wide walk.  The JAX side runs in a
  subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (no FMA
  contraction, ROADMAP hazard H2), started when the module's first test
  starts.
* Statistics: the frame's rays and wave keys of ``perf_trace`` against
  the JAX ``perf_trace`` at width 16, and the walk's internal steps
  below the 8-wide walk's.
* ``walk_work`` and ``k1_bound`` at width 16 against a count by hand.
* Frames with ``RTConfig(bvh_width=16, flatten=True)``: a 32x32 Whitted
  frame at depth 1 (within 1e-5 of the JAX frame, every pixel) and a depth-3
  path-traced frame with shadow rays (the merged wave; README
  "Fidelity": 99% of the pixels within 1e-5 and RMSE under 1e-3), each
  with the JAX frame's rays, and equal to the port's 8-wide frame.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu.models.scene import Scene as JScene
from vortex_rt_tpu.ops.traverse_packet import _SORT_NET
from vortex_rt_tpu.ops.traverse_wide import WideArrays as JWide
from vortex_rt_tpu.utils import vecmath as jvm
from vortex_rt_tpu.utils.config import RTConfig as JCfg

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch import bridge
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.models.scene import Material as TMat
from vortex_rt_tpu_torch.ops import traverse_packet as tp
from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays
from vortex_rt_tpu_torch.tools import walk_bounds as wb
from vortex_rt_tpu_torch.tools.bench_ladder import checker_pred
from vortex_rt_tpu_torch.utils import vecmath as tvm
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

from tests import test_torch_anyhit as anyhit_tests
from tests.test_torch_anyhit import EYE as CUT_EYE, LIGHT, cutout_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HITS = ("dist", "bx", "by", "tri", "inst")
EYE = ([0.3, -0.6, -7], [0, 0, 0.5], [0, 1, 0], 45.0, 1.0)
W = H = 32


def flat_scene(scene_cls, proc, vm, ntris=300):
    """tests/test_wide16.py::_flat_scene (seed 0), with either package."""
    rng = np.random.default_rng(0)
    sc = scene_cls()
    mb = sc.add_mesh(proc.box((0, 0, 0), 1.0))
    ms = sc.add_mesh(proc.uv_sphere((0, 0, 0), 1.0, 10, 14))
    mr = sc.add_mesh(proc.random_soup(rng, ntris))
    sc.add_instance(mb, vm.mat4_translate([-3, 0, 0]))
    sc.add_instance(ms, vm.mat4_translate([3, 0, 0]) @ vm.mat4_scale(1.5))
    sc.add_instance(mr, vm.mat4_translate([0, 0, 4]))
    return sc


# The JAX subprocesses' preamble: JAX on the CPU, and the scenes, cameras
# and predicate of this module and of tests/test_torch_anyhit.py (their
# sources, so that the subprocesses import neither torch nor the port).
_PREAMBLE = "\n".join([
    "import sys",
    "import jax",
    'jax.config.update("jax_platforms", "cpu")',
    "import jax.numpy as jnp",
    "import numpy as np",
    f"EYE, CUT_EYE, LIGHT, W, H = {EYE!r}, {CUT_EYE!r}, {LIGHT!r}, {W}, {H}",
    *(inspect.getsource(f) for f in (
        flat_scene, anyhit_tests._texture, anyhit_tests.cutout_scene,
        anyhit_tests._checker_pred_jax))])

# Runs in a fresh interpreter: both scenes' 16-wide tables (the cutout
# scene's with the alpha fields), the ray sets and the per-mode inputs
# made with NumPy, traced through trace_packets(packet=32), and saved.
_JAX_REFERENCE = _PREAMBLE + r"""
from vortex_rt_tpu.golden.renderer import generate_rays
from vortex_rt_tpu.models import procedural as proc
from vortex_rt_tpu.models.scene import Camera, Material, Scene
from vortex_rt_tpu.ops.traverse_packet import trace_packets
from vortex_rt_tpu.ops.traverse_wide import WideArrays
from vortex_rt_tpu.utils import vecmath as vm
from vortex_rt_tpu.utils.config import LARGE_FLOAT, RTConfig

cfg = RTConfig(flatten=True, use_native_build=False)
out = {}
sb = flat_scene(Scene, proc, vm).build(cfg)
sbc = cutout_scene(Scene, proc, Material).build(cfg)
tables = {"flat": WideArrays.from_scene(sb, width=16).fuse(),
          "cut": WideArrays.from_scene(sbc, width=16).fuse().with_alpha(sbc)}
for name, wa in tables.items():
    for k in ("nodes", "tri_rows", "fused", "alpha_rows", "alpha_pool"):
        if getattr(wa, k) is not None:
            out[f"{name}/{k}"] = np.asarray(getattr(wa, k))
    for k in ("num_tlas", "max_leaf_tris", "depth", "tri_bits", "width"):
        out[f"{name}/{k}"] = np.int64(getattr(wa, k))
rng = np.random.default_rng(1)
cam = tuple(np.asarray(a) for a in generate_rays(Camera.look_at(*EYE), 32, 32))
o = rng.uniform(-10, 10, (512, 3)).astype(np.float32)
d = rng.normal(size=(512, 3)).astype(np.float32)
d /= np.linalg.norm(d, axis=-1, keepdims=True)
t_occ = rng.uniform(0.5, 12.0, 512).astype(np.float32)
n = cam[0].shape[0]
split_o = np.concatenate([o[:256], cam[0]])
split_d = np.concatenate([d[:256], cam[1]])
split_t = np.concatenate([t_occ[:256], np.full(n, LARGE_FLOAT, np.float32)])
cut = tuple(np.asarray(a)
            for a in generate_rays(Camera.look_at(*CUT_EYE), 32, 32))
cases = {
    "camera": ("flat", cam, {}),
    "incoherent": ("flat", (o, d), {}),
    "occlusion": ("flat", (o, d), dict(t_max=t_occ, occlusion=True)),
    "occl_split": ("flat", (split_o, split_d),
                   dict(t_max=split_t, occl_split=256)),
    "alpha": ("cut", cut, dict(alpha_ref=0.35)),
    "pred": ("cut", cut, dict(anyhit_pred=_checker_pred_jax)),
}
# (the two closest-hit ray sets of the flat table in one walk: one
# compile fewer)
both = trace_packets(tables["flat"], np.concatenate([cam[0], o]),
                     np.concatenate([cam[1], d]), packet=32)[0]
for case, (table, (co, cd), kw) in cases.items():
    out[f"{case}/o"], out[f"{case}/d"] = co, cd
    for k, v in kw.items():
        if isinstance(v, np.ndarray):
            out[f"{case}/arg/{k}"] = v
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    if case in ("camera", "incoherent"):
        part = slice(0, n) if case == "camera" else slice(n, None)
        h = type(both)(*(x[part] for x in both))
    else:
        h, _ = trace_packets(tables[table], co, cd, packet=32, **jkw)
    for k in ("dist", "bx", "by", "tri", "inst"):
        out[f"{case}/{k}"] = np.asarray(getattr(h, k))
np.savez(sys.argv[1], **out)
"""
# the port's keywords of each case (the arrays come from the .npz)
CASES = {"camera": ("flat", {}), "incoherent": ("flat", {}),
         "occlusion": ("flat", dict(occlusion=True)),
         "occl_split": ("flat", dict(occl_split=256)),
         "alpha": ("cut", dict(alpha_ref=0.35)),
         "pred": ("cut", dict(anyhit_pred=checker_pred))}


# Runs in two more fresh interpreters, beside the first: a JAX frame of
# the flat scene with bvh_width=16 (spp 2, shadow rays; argv[3]
# "whitted": depth 1, then perf_trace's wave keys and rays of a 16x16
# frame at depth 1; "pathtrace": path traced at depth 3, the merged
# wave), its image and rays saved.
_JAX_FRAME = _PREAMBLE + r"""
import json
from vortex_rt_tpu.engine import wavefront as jwf
from vortex_rt_tpu.models import procedural as proc
from vortex_rt_tpu.models.scene import Camera, RenderParams, Scene
from vortex_rt_tpu.utils import vecmath as vm
from vortex_rt_tpu.utils.config import RTConfig

cfg = RTConfig(flatten=True, bvh_width=16, use_native_build=False)
jr = jwf.WavefrontRenderer.from_buffers(flat_scene(Scene, proc, vm).build(cfg),
                                        cfg)
pathtrace = sys.argv[2] == "pathtrace"
img, rays = jr.render(Camera.look_at(*EYE), RenderParams(
    light_pos=LIGHT, max_depth=3 if pathtrace else 1, spp=2, shadow=True,
    pathtrace=pathtrace), W, H)
out = dict(img=np.asarray(img), rays=np.int64(rays))
if not pathtrace:
    st = jr.perf_trace(Camera.look_at(*EYE), RenderParams(
        light_pos=LIGHT, max_depth=1, shadow=True), 16, 16)
    out["perf"] = np.array(json.dumps(
        {k: (list(v) if isinstance(v, dict) else None) for k, v in st.items()}
        | {"rays": int(st["rays"])}))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_started(tmp_path_factory):
    """Starts the JAX walks' and the two JAX frames' subprocesses when
    the module's first test starts (they run beside each other and the
    tests that need none of them); ``jax_ref`` and ``jax_frames`` wait
    for them."""
    d = tmp_path_factory.mktemp("wide16")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    procs = {}
    for name, script in (("walks", _JAX_REFERENCE), ("whitted", _JAX_FRAME),
                         ("pathtrace", _JAX_FRAME)):
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", script, str(d / f"{name}.npz"), name],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            d / f"{name}.npz")
    try:
        yield procs
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


def _result(procs, name):
    proc, path = procs[name]
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jax_ref(_jax_started):
    return _result(_jax_started, "walks")


@pytest.fixture(scope="module")
def jax_frames(_jax_started):
    return {k: _result(_jax_started, k) for k in ("whitted", "pathtrace")}


def _cfg(**kw):
    return pt.RTConfig(flatten=True, use_native_build=False, **kw)


@pytest.fixture(scope="module")
def tables():
    """The port's own 16-wide and 8-wide tables of both scenes."""
    sb = flat_scene(pt.Scene, tproc, tvm).build(_cfg())
    sbc = cutout_scene(pt.Scene, tproc, TMat).build(_cfg())
    return {"flat": WideArrays.from_scene(sb, 16).fuse(),
            "flat8": WideArrays.from_scene(sb, 8).fuse(),
            "cut": WideArrays.from_scene(sbc, 16).fuse().with_alpha(sbc),
            "cut8": WideArrays.from_scene(sbc, 8).fuse().with_alpha(sbc)}


def _words(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def _np_words(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.int32)


@pytest.fixture(scope="module")
def frame_pair():
    """(16-wide renderer, 8-wide renderer) of the flat scene."""
    sb = flat_scene(pt.Scene, tproc, tvm).build(_cfg(bvh_width=16))
    r16 = pt.WavefrontRenderer.from_buffers(sb, _cfg(bvh_width=16),
                                            device="cpu")
    r8 = pt.WavefrontRenderer.from_buffers(sb, _cfg(), device="cpu")
    assert r16.wa.width == 16 and r16.walk is tp.trace_packets
    assert r16.wa.fused is not None and r8.wa.width == 8
    return r16, r8


def test_batcher_network_sorts_and_equals_jax():
    net = tp.SORT_NETS[16]
    assert net == tuple(_SORT_NET[16]) and len(net) == 63
    assert tp.SORT_NETS[8] == tuple(_SORT_NET[8])
    rng = np.random.default_rng(0)
    for _ in range(100):
        vals = list(rng.permutation(16))
        for a, b in net:
            if vals[a] < vals[b]:  # descending
                vals[a], vals[b] = vals[b], vals[a]
        assert vals == list(range(15, -1, -1))


def test_walk_work_and_bound_match_a_count_by_hand():
    """Three unit quads at x = -6, 0, 6: at width 16 a root of two
    children (the quad at -6; the quads at 0 and 6) over two leaves."""
    sc = pt.Scene()
    for x in (-6.0, 0.0, 6.0):
        sc.add_instance(sc.add_mesh(tproc.quad(
            (x - 0.5, -0.5, 0), (x + 0.5, -0.5, 0), (x + 0.5, 0.5, 0),
            (x - 0.5, 0.5, 0))))
    wa = WideArrays.from_scene(sc.build(_cfg()), 16).fuse()
    assert wa.fused.shape == (3, 40 + 16 * 4)
    assert wa.kind.tolist() == [0, 1, 1] and wa.nchild[0] == 2
    assert wa.leaf_data[1:].tolist() == [2, 4]
    o = torch.tensor([[-6.0, 0.1, -5.0], [0.0, 0.1, -5.0], [6.0, 0.1, -5.0],
                      [1.5, 0.0, -5.0], [0.0, 3.0, -5.0], [0.0, 0.0, -5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]] * 6)
    active = torch.tensor([True] * 5 + [False])
    hits, steps, work = tp.walk_work(wa, o, d, active=active)
    assert (hits.dist[:3] == 5.0).all() and (hits.dist[3:] >= LARGE_FLOAT).all()
    assert steps.tolist() == [2, 2, 2, 2, 1, 0]
    assert work.child_slots.tolist() == [2] * 5 + [0]
    assert work.tri_slots.tolist() == [2, 4, 4, 4, 0, 0]
    # the root's 40 node words (160 B), each leaf's meta quarter (16 B)
    # and its triangle slots (40 B each)
    assert work.row_bytes.tolist() == [160, 16 + 2 * 40, 16 + 4 * 40]
    b = wb.k1_bound(work, width=16)
    assert b.ops == 37 * 10 + 63 * 5 + 53 * 14  # 1,427
    assert b.bytes == 5 * 29 + 5 + 6 * 28 + 160 + 96 + 176  # 750
    assert wb.k1_bound(work).ops == 37 * 10 + 19 * 5 + 53 * 14


def test_meta_views_read_five_bit_counts(tables):
    """The host views of the meta word at width 16: 24 left bits, a
    5-bit child count (up to 16 children) and the kind, as the JAX
    package's views read them."""
    sb = flat_scene(JScene, jproc, jvm).build(JCfg(flatten=True,
                                                   use_native_build=False))
    jwa = JWide.from_scene(sb, width=16)
    wa = tables["flat"]
    for view in ("kind", "nchild", "left_first", "leaf_data", "qlo", "qhi",
                 "origin", "scale", "leaf_tids"):
        np.testing.assert_array_equal(getattr(wa, view),
                                      np.asarray(getattr(jwa, view)),
                                      err_msg=view)
    assert wa.nchild.max() > 8  # wider than an 8-wide node
    assert int((wa.kind == 0).sum()) < int((tables["flat8"].kind == 0).sum())


def test_stats_rays_and_keys_match_jax(frame_pair, tables, jax_frames):
    """``perf_trace`` at width 16 holds the JAX frame's rays and wave
    keys (its counters are defined over the port's walk, ROADMAP H19),
    and the 16-wide walk takes fewer internal steps than the 8-wide one
    on the same rays, with the same hits."""
    r16, _ = frame_pair
    want = json.loads(str(jax_frames["whitted"]["perf"]))
    got = r16.perf_trace(pt.Camera.look_at(*EYE), pt.RenderParams(
        light_pos=LIGHT, max_depth=1, shadow=True), 16, 16)
    assert set(got) == set(want) and got["rays"] == want["rays"]
    for k, v in want.items():
        if isinstance(v, list):  # a wave's counters, by name
            assert list(got[k]) == v, k
    assert got["trace0"]["int_steps"] > 0
    rng = np.random.default_rng(2)
    o = torch.from_numpy(rng.uniform(-10, 10, (512, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(512, 3)).astype(np.float32)))
    h16, s16, w16 = tp.walk_work(tables["flat"], o, d)
    h8, s8, w8 = tp.walk_work(tables["flat8"], o, d)
    for x, y in zip(h16, h8):
        assert torch.equal(x, y)
    assert int(w16.internal.sum()) < int(w8.internal.sum())
    assert int(s16.sum()) < int(s8.sum())


def _case(jax_ref, case):
    kw = dict(CASES[case][1])
    pre = f"{case}/arg/"
    for k, v in jax_ref.items():
        if k.startswith(pre):
            kw[k[len(pre):]] = torch.from_numpy(v)
    return (torch.from_numpy(jax_ref[f"{case}/o"]),
            torch.from_numpy(jax_ref[f"{case}/d"]), kw)


@pytest.mark.parametrize("case", list(CASES))
def test_walk_matches_jax_and_the_8wide_walk(jax_ref, tables, case):
    table = CASES[case][0]
    o, d, kw = _case(jax_ref, case)
    got, steps = tp.trace_packets(tables[table], o, d, **kw)
    assert bool((steps > 0).any())
    for k in HITS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      jax_ref[f"{case}/{k}"], err_msg=k)
    h8, _ = tp.trace_packets(tables[table + "8"], o, d, **kw)
    for a, b in zip(got, h8):
        assert torch.equal(a, b)
    dist = got.dist.numpy()
    if case in ("occlusion", "occl_split"):
        k = o.shape[0] if case == "occlusion" else kw["occl_split"]
        assert 10 < (dist[:k] == 0.0).sum() < k  # occluded and free rays
    if case != "occlusion":
        assert (dist[-256:] < LARGE_FLOAT).sum() > 10
    if case in ("alpha", "pred"):  # the test rejects hits
        h0, _ = tp.trace_packets(tables["cut"], o, d)
        assert bool((h0.dist != got.dist).any())


@pytest.mark.parametrize("name", ["flat", "cut"])
def test_tables_equal_jax_word_for_word(jax_ref, tables, name):
    wa = tables[name]
    assert wa.width == 16 and wa.nodes.shape[1] == 40
    k = wa.tri_rows.shape[1] // 16
    fields = ("nodes", "tri_rows", "fused") + (
        ("alpha_rows", "alpha_pool") if name == "cut" else ())
    assert wa.fused.shape[1] == 40 + (24 if name == "cut" else 16) * k
    for f in fields:
        np.testing.assert_array_equal(_words(getattr(wa, f)),
                                      _np_words(jax_ref[f"{name}/{f}"]),
                                      err_msg=f)
    for f in ("num_tlas", "max_leaf_tris", "depth", "tri_bits", "width"):
        assert getattr(wa, f) == int(jax_ref[f"{name}/{f}"]), f
    # the bridge carries the JAX tables across to the same words
    kw = {f: int(jax_ref[f"{name}/{f}"]) for f in (
        "num_tlas", "max_leaf_tris", "depth", "tri_bits", "width")}
    got = bridge.wide_arrays(
        jax_ref[f"{name}/nodes"], jax_ref[f"{name}/tri_rows"],
        fused=jax_ref[f"{name}/fused"], device="cpu",
        alpha_rows=jax_ref.get(f"{name}/alpha_rows"),
        alpha_pool=jax_ref.get(f"{name}/alpha_pool"), **kw)
    for f in fields:
        assert torch.equal(getattr(got, f).view(torch.int32),
                           getattr(wa, f).view(torch.int32)), f


def test_bridge_refuses_rows_of_another_width(jax_ref):
    nodes, rows = jax_ref["flat/nodes"], jax_ref["flat/tri_rows"]
    kw = dict(num_tlas=0, max_leaf_tris=4, depth=4, tri_bits=9,
              device="cpu")
    with pytest.raises(ValueError, match="40"):
        bridge.wide_arrays(nodes[:, :32], rows, width=16, **kw)
    with pytest.raises(ValueError, match="32"):
        bridge.wide_arrays(nodes, rows, width=8, **kw)


def _port_frame(r16, r8, p):
    """The 16-wide frame (its waves' kinds recorded), checked against the
    8-wide frame: equal rays and images."""
    waves = []

    def walk(*a, **kw):
        waves.append("mixed" if kw.get("occl_split", 0) else
                     "occlusion" if kw.get("occlusion") else "closest")
        return tp.trace_packets(*a, **kw)

    img, rays = dataclasses.replace(r16, walk=walk).render(
        pt.Camera.look_at(*EYE), p, W, H)
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    img8, rays8 = r8.render(pt.Camera.look_at(*EYE), p, W, H)
    assert rays8 == rays
    np.testing.assert_array_equal(img, img8)
    return img, rays, waves


def test_whitted_frame_matches_jax(frame_pair, jax_frames):
    """Depth 1, spp 2, shadow rays: every pixel within 1e-5 of the JAX
    frame, the same rays."""
    r16, r8 = frame_pair
    img, rays, waves = _port_frame(r16, r8, pt.RenderParams(
        light_pos=LIGHT, max_depth=1, spp=2, shadow=True))
    assert waves == ["closest", "occlusion"] * 2
    assert rays == int(jax_frames["whitted"]["rays"])
    assert float(np.abs(img - jax_frames["whitted"]["img"]).max()) <= 1e-5


def test_pathtraced_frame_matches_jax(frame_pair, jax_frames):
    """Depth 3, spp 2, shadow rays, path traced: the merged shadow+bounce
    wave runs at width 16; README "Fidelity" against the JAX frame (99%
    of the pixels within 1e-5, RMSE under 1e-3), the same rays."""
    r16, r8 = frame_pair
    img, rays, waves = _port_frame(r16, r8, pt.RenderParams(
        light_pos=LIGHT, max_depth=3, spp=2, shadow=True, pathtrace=True))
    assert waves == ["closest", "occlusion", "closest", "mixed",
                     "occlusion"] * 2
    jimg = jax_frames["pathtrace"]["img"]
    assert rays == int(jax_frames["pathtrace"]["rays"])
    diff = np.abs(img - jimg).max(-1)
    assert (diff <= 1e-5).mean() >= 0.99
    assert float(np.sqrt(((img - jimg) ** 2).mean())) < 1e-3
