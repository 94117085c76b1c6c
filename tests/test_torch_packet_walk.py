"""The port's BVH walk (``trace_packets_walk`` on CPU tensors, i.e. its
plain PyTorch version) against the JAX package's Pallas kernel
``trace_packets_pallas`` run through the Pallas interpreter.

The four modes of ``tests/test_pallas_walk.py`` — closest hit, active
mask, t_max clamp, occlusion — on the TLAS scene used there and on a
flat build.  ``dist``, ``bx``, ``by``, ``tri`` and ``inst`` are compared
for equality, which is tighter than the rtol 1e-6 the port must meet.

The JAX side runs in a subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``.
On hosts with FMA, XLA:CPU otherwise contracts ``a*b+c`` into one fused
op (``jit(a*b+c)`` then differs from ``fl(fl(a*b)+c)``), while the port
and its CUDA kernel (``-fmad=false``) round every product: the same
Moller-Trumbore terms then differ by a few ulps, up to 1.3e-6 relative
in ``dist`` on these scenes (ROADMAP hazard H2).  Capped below FMA, the
JAX kernel and the port agree bit for bit.

The port walks each ray's own path where the TPU kernel walked a
1024-ray packet's union, so an exact-t tie could resolve differently
(pruning is a strict ``tmin < best_t``); no lane of these scenes is such
a tie, and the hit ids are asserted equal."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vortex_rt_tpu_torch import bridge
from vortex_rt_tpu_torch.ops import packet_walk as pw
from vortex_rt_tpu_torch.ops.packet_walk import (
    trace_packets_walk, trace_packets_walk_ref,
)
from vortex_rt_tpu_torch.runtime import kernels
from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("tlas", "flat")
MODES = ("closest", "active", "t_max", "occlusion")
HITS = ("dist", "bx", "by", "tri", "inst")

# Runs in a fresh interpreter: builds both scenes with the JAX package,
# makes the rays and per-mode inputs with NumPy, traces them through
# trace_packets_pallas(interpret=True) and saves everything to an .npz.
_JAX_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from vortex_rt_tpu.golden.renderer import generate_rays
from vortex_rt_tpu.models import procedural as proc
from vortex_rt_tpu.models.scene import Camera, Scene
from vortex_rt_tpu.ops.pallas.packet_walk import P, trace_packets_pallas
from vortex_rt_tpu.ops.traverse_wide import WideArrays
from vortex_rt_tpu.utils.config import LARGE_FLOAT, RTConfig

out = {}
for kind in ("tlas", "flat"):
    sc = Scene()
    if kind == "tlas":  # the tests/test_pallas_walk.py scene and camera
        sc.add_mesh(proc.uv_sphere((0, 0, 0), 1.0, 12, 16))
        sc.add_mesh(proc.box((0.5, 0.3, 0.5), 0.4))
        sb = sc.build(RTConfig(use_native_build=False))
        cam = Camera.look_at([0.3, -0.2, -4], [0, 0.05, 0], [0, 1, 0],
                             40.0, 1.0)
    else:
        for mesh, refl in proc.cornell_box():
            sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
        sb = sc.build(RTConfig(flatten=True, bvh_width=4,
                               use_native_build=False))
        cam = Camera.look_at([0.05, 0.02, -3.2], [0, -0.05, 0], [0, 1, 0],
                             45.0, 1.0)
    wa = WideArrays.from_scene(sb, width=4)
    o, d = generate_rays(cam, 64, 2 * P // 64)
    n = o.shape[0]
    free, _ = trace_packets_pallas(wa, o, d, interpret=True)
    ref = np.asarray(free.dist)
    hit = ref < LARGE_FLOAT
    cut = hit & (np.arange(n) % 2 == 0)
    t_max = np.full(n, LARGE_FLOAT, np.float32)
    t_max[cut] = ref[cut] * 0.5
    args = {
        "closest": {},
        "active": dict(active=np.arange(n) % 3 != 0),
        "t_max": dict(t_max=t_max),
        "occlusion": dict(
            active=np.arange(n) % 5 != 0,
            t_max=np.where(hit, ref * 1.5, np.float32(8.0)).astype(
                np.float32),
            occlusion=True),
    }
    for k in ("nodes", "tri_rows"):
        out[f"{kind}/{k}"] = np.asarray(getattr(wa, k))
    for k in ("num_tlas", "max_leaf_tris", "depth", "tri_bits", "width"):
        out[f"{kind}/{k}"] = np.int64(getattr(wa, k))
    out[f"{kind}/o"], out[f"{kind}/d"] = o, d
    for mode, kw in args.items():
        hits, _ = trace_packets_pallas(wa, o, d, interpret=True, **kw)
        for k, v in kw.items():
            if k != "occlusion":
                out[f"{kind}/{mode}/arg/{k}"] = np.asarray(v)
        for k in ("dist", "bx", "by", "tri", "inst"):
            out[f"{kind}/{mode}/{k}"] = np.asarray(getattr(hits, k))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("walk") / "jax_walk.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _JAX_REFERENCE, str(path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module", params=KINDS)
def case(request, jax_reference):
    kind = request.param
    ref = {k[len(kind) + 1:]: v for k, v in jax_reference.items()
           if k.startswith(kind + "/")}
    twa = bridge.wide_arrays(
        ref["nodes"], ref["tri_rows"], device="cpu",
        **{k: int(ref[k]) for k in ("num_tlas", "max_leaf_tris", "depth",
                                    "tri_bits", "width")})
    return dict(kind=kind, twa=twa, ref=ref, o=ref["o"], d=ref["d"])


def _mode_args(ref, mode):
    kw = {k.split("/")[-1]: torch.from_numpy(v) for k, v in ref.items()
          if k.startswith(f"{mode}/arg/")}
    if mode == "occlusion":
        kw["occlusion"] = True
    return kw


@pytest.mark.parametrize("mode", MODES)
def test_walk_matches_pallas_kernel(case, mode):
    ref = case["ref"]
    kw = _mode_args(ref, mode)
    launches = dict(kernels.LAUNCHES)
    got, steps = trace_packets_walk(case["twa"], torch.from_numpy(case["o"]),
                                    torch.from_numpy(case["d"]), **kw)
    assert kernels.LAUNCHES == launches  # CPU tensors never launch
    assert steps.dtype == torch.int32 and bool((steps > 0).any())
    for k in HITS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      ref[f"{mode}/{k}"], err_msg=k)
    dist = got.dist.numpy()
    if "active" in kw:  # dead rays report a miss
        assert (dist[~kw["active"].numpy()] >= LARGE_FLOAT).all()
    if mode == "occlusion":
        assert (dist == 0.0).any() and (dist >= LARGE_FLOAT).any()
        return
    hit = dist < LARGE_FLOAT
    assert hit.sum() > 100
    if mode == "t_max":  # clamped rays find nothing before their clamp
        assert (dist[kw["t_max"].numpy() < LARGE_FLOAT] >= LARGE_FLOAT).all()
    if case["kind"] == "tlas":
        assert len(np.unique(got.inst.numpy()[hit])) == 2


def test_wrapper_and_plain_version_agree_on_cpu(case):
    o, d = torch.from_numpy(case["o"]), torch.from_numpy(case["d"])
    a, sa = trace_packets_walk(case["twa"], o, d)
    b, sb = trace_packets_walk_ref(case["twa"], o, d)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(sa, sb)


@pytest.mark.parametrize("bad", ["o_dtype", "o_shape", "active_dtype",
                                 "t_max_shape", "nodes_dtype"])
def test_wrapper_rejects_bad_inputs(case, bad):
    twa = case["twa"]
    o, d = torch.from_numpy(case["o"]), torch.from_numpy(case["d"])
    kw = {}
    if bad == "o_dtype":
        o = o.double()
    elif bad == "o_shape":
        o = o[:, :2]
    elif bad == "active_dtype":
        kw["active"] = torch.ones(o.shape[0], dtype=torch.int32)
    elif bad == "t_max_shape":
        kw["t_max"] = torch.ones(o.shape[0] + 1)
    else:
        twa = dataclasses.replace(twa, nodes=twa.nodes.to(torch.int64))
    with pytest.raises(ValueError):
        trace_packets_walk(twa, o, d, **kw)


def test_kernel_stack_entries_against_its_refusal(case):
    """The kernel keeps one packed entry per descended level: depth + 4
    entries of its 48 (``STACK_MAX``; the first version kept 3 * (depth
    + 2) + 8 of 128).  ``kernel_call`` takes a tree at the cap (it then
    refuses only because the tensors lie on the CPU) and refuses one
    level more before anything else; the plain walk is unchanged by
    ``depth`` while its own stack holds the tree."""
    twa = case["twa"]
    assert pw.STACK_MAX == 48
    assert pw.stack_entries(twa) == int(twa.depth) + 4 <= pw.STACK_MAX
    o, d = torch.from_numpy(case["o"]), torch.from_numpy(case["d"])
    at_cap = dataclasses.replace(twa, depth=pw.STACK_MAX - 4)
    assert pw.check_stack(at_cap) == pw.STACK_MAX
    with pytest.raises(ValueError, match="no CUDA walk"):
        pw.kernel_call(at_cap, o, d)
    deeper = dataclasses.replace(twa, depth=pw.STACK_MAX - 3)
    with pytest.raises(ValueError, match="stack entries"):
        pw.kernel_call(deeper, o, d)
    a, sa = trace_packets_walk_ref(twa, o[:512], d[:512])
    b, sb = trace_packets_walk_ref(at_cap, o[:512], d[:512])
    assert all(torch.equal(x, y) for x, y in zip((*a, sa), (*b, sb)))
