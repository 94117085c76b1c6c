"""Stateless any-hit predicates inside the walks (K1's and K2's predicate
modes) against the JAX package, on the CPU.

* The compiler (``ops/anyhit_pred.py``): one case per op and form of its
  set (``tests/torch_pred_cases.py``), the emitted ``vrt_pred`` compiled
  as host C++ with ``$CXX`` (a shim defines the CUDA qualifiers,
  ``__fdiv_rn``, ``__fsqrt_rn`` and ``__double2float_rn`` away; the
  double functions are the C library's; ``-ffp-contract=off``, so no
  FMA) equal bit for bit to the compiled predicate's plain version and,
  for a case of exact ops, to the torch callable, on a seeded grid of u,
  v and alpha with negative values, values past 1, exact cell edges,
  values past int32 and past 1e5, values near exp's overflow, signed
  zeros, subnormals, infinities and NaN (all cases in one program, one
  compile); and its refusals: ``cumsum``, ``rand_like``, a captured
  tensor that is not 0-dim, a value-dependent ``if``, a result that is
  not a bool, and at ``from_buffers``.
* The plain walks with ``anyhit_pred=_checker_pred``: K1's (8-wide
  flattened: closest, occlusion, ``occl_split``) and K2's (4-wide TLAS:
  closest, occlusion) against the JAX ``trace_packets(anyhit_pred=...)``
  on the cutout scene of ``tests/test_anyhit_inline.py``, every hit field
  to the bit (the JAX side in a subprocess with
  ``XLA_FLAGS=--xla_cpu_max_isa=AVX``, ROADMAP hazard H2, started when
  the module's first test starts, so that it runs beside the frames);
  and with ``bench_ladder.perforated_pred`` (``sqrt``, ``sin``, ``cos``,
  ``**``: K1 closest, occlusion and ``occl_split``, K2 TLAS closest),
  where XLA's float32 functions are not correctly rounded: a ray whose
  hit differs from JAX's must be traced to a candidate whose compared
  value lies within 4 float32 ulps of its threshold (printed).
* 48x48 ``stateless_anyhit`` frames with shadows, depth 2, flat 8-wide
  and 4-wide TLAS through the walks' predicate modes: against the JAX
  in-walk frame (in process, atol 1e-5, equal rays) and against the
  port's own suspension frame (``packet_size=0``, K3's plain rounds)
  within 2e-6, the JAX test's bound; and a depth-3 flat frame (the merged
  wave) against the JAX frame (atol 1e-5, equal rays) and the suspension
  frame (2e-6); and a perforated flat frame at depth 2 against both.
* A ``collect_stats`` frame whose rays and wave keys equal the JAX
  frame's.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vortex_rt_tpu.engine import shaders as jsh
from vortex_rt_tpu.engine import wavefront as jwf
from vortex_rt_tpu.models.scene import (
    Camera as JCam, RenderParams as JParams,
)
from vortex_rt_tpu.utils.config import RTConfig as JCfg

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch import bridge
from vortex_rt_tpu_torch.engine import shaders as tsh
from vortex_rt_tpu_torch.engine import wavefront as twf
from vortex_rt_tpu_torch.ops import anyhit_pred as ap
from vortex_rt_tpu_torch.ops.packet_walk import trace_packets_walk_ref
from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets_ref
from vortex_rt_tpu_torch.runtime import native

from vortex_rt_tpu_torch.tools.bench_ladder import perforated_pred

from tests.test_torch_anyhit import (
    EYE, LIGHT, _checker_pred, _checker_pred_jax,  # noqa: F401
    _perforated_pred_jax, builds,
)
from tests.torch_pred_cases import OPS as _OPS, grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 48
WALKS = ("flat8/closest", "flat8/occlusion", "flat8/occl_split",
         "tlas4/closest", "tlas4/occlusion", "perf/flat8/closest",
         "perf/flat8/occlusion", "perf/flat8/occl_split",
         "perf/tlas4/closest")
ULPS = 4  # the disagreement with XLA's float32 functions a test may have


OPS = {**_OPS, "checker": _checker_pred}

_SHIM = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#define __device__
#define __forceinline__ inline
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return sqrtf(a); }
static inline float __double2float_rn(double a) { return (float)a; }
static inline float __int_as_float(int x) {
    float f;
    memcpy(&f, &x, sizeof f);
    return f;
}
"""


@pytest.fixture(scope="module")
def host_preds(tmp_path_factory):
    """Every op case's ``vrt_pred`` run on the grid by one host program:
    {case: (R,) bool}, and the grid."""
    d = tmp_path_factory.mktemp("pred")
    u, v, a = grid()
    compiled = {name: ap.compile_predicate(fn) for name, fn in OPS.items()}
    src = [_SHIM]
    for i, (name, c) in enumerate(compiled.items()):
        c.write(d)
        src.append(f'namespace c{i} {{\n#include "{c.header_name}"\n}}\n')
    calls = "\n".join(
        f"    for (long i = 0; i < n; ++i) out[{i} * n + i] = "
        f"c{i}::vrt_pred(u[i], v[i], a[i]);" for i in range(len(compiled)))
    src.append(f"""
int main(int argc, char** argv) {{
    FILE* f = fopen(argv[1], "rb");
    long n;
    if (fread(&n, sizeof n, 1, f) != 1) return 1;
    float* u = (float*)malloc(3 * n * sizeof(float));
    if (fread(u, sizeof(float), 3 * n, f) != (size_t)(3 * n)) return 1;
    fclose(f);
    const float* v = u + n;
    const float* a = u + 2 * n;
    unsigned char* out = (unsigned char*)malloc({len(compiled)} * n);
{calls}
    f = fopen(argv[2], "wb");
    fwrite(out, 1, {len(compiled)} * n, f);
    fclose(f);
    return 0;
}}
""")
    (d / "main.cpp").write_text("".join(src))
    exe = d / "preds"
    proc = subprocess.run(
        [native.cxx_path(), "-std=c++17", "-O1", "-ffp-contract=off",
         "-fno-fast-math", "-I", str(d), "-o", str(exe), str(d / "main.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n = u.shape[0]
    with open(d / "in.bin", "wb") as f:
        f.write(np.int64(n).tobytes())
        f.write(np.concatenate([u, v, a]).tobytes())
    subprocess.run([str(exe), str(d / "in.bin"), str(d / "out.bin")],
                   check=True, timeout=60)
    got = np.fromfile(d / "out.bin", np.uint8).reshape(len(compiled), n)
    return {name: got[i].astype(bool)
            for i, name in enumerate(compiled)}, (u, v, a), compiled


@pytest.mark.parametrize("op", list(OPS))
def test_emitted_predicate_equals_torch(host_preds, op):
    """The emitted C (compiled for the host) decides as the compiled
    predicate's plain version does (its correctly rounded ops in float64,
    rounded once), on every point of the grid; for a case of exact ops
    that is the torch callable's decision too."""
    got, (u, v, a), compiled = host_preds
    c = compiled[op]
    uva = [torch.from_numpy(x) for x in (u, v, a)]
    want = c.plain(*uva)
    assert want.dtype == torch.bool
    want = want.numpy()
    bad = np.flatnonzero(got[op] != want)
    assert bad.size == 0, (f"{op}: {bad.size} of {want.size} differ, e.g. "
                           f"u={u[bad[:3]]} v={v[bad[:3]]} a={a[bad[:3]]}")
    assert 0 < want.sum() < want.size  # the grid reaches both answers
    if c.exact:
        assert np.array_equal(OPS[op](*uva).numpy(), want)
    assert c.n_ops == len(c.ops) > 0 and "vrt_pred" in c.text
    assert c.header_name == f"vrt_pred_{c.digest}.cuh"


_CAPTURED = torch.tensor([0.5, 0.25])


def _branch(u, v, a):
    if u.sum() > 0:
        return u > v
    return v > u


@pytest.mark.parametrize("fn,match", [
    pytest.param(lambda u, v, a: torch.cumsum(u, 0) > 0.5, "cumsum",
                 id="cumsum"),
    pytest.param(lambda u, v, a: torch.rand_like(u) < a, "rand_like",
                 id="rand_like"),
    pytest.param(lambda u, v, a: u < _CAPTURED, "captured tensor",
                 id="captured"),
    pytest.param(_branch, "value-dependent Python branch", id="branch"),
    pytest.param(lambda u, v, a: u * 2.0, "not a bool", id="not_bool"),
])
def test_refusals(builds, fn, match):
    """What the compiler refuses raises NotImplementedError naming it, by
    itself and at ``from_buffers`` (the CPU as the card): no route takes
    it quietly; the suspension engine (``packet_size=0``) still runs any
    callable."""
    with pytest.raises(NotImplementedError, match=match):
        ap.compile_predicate(fn)
    _, flat_sb = builds[True]
    table = tsh.ShaderTable(anyhit=tsh.stateless_anyhit(fn))
    with pytest.raises(NotImplementedError, match=match):
        pt.WavefrontRenderer.from_buffers(
            flat_sb, pt.RTConfig(flatten=True, use_native_build=False),
            table, device="cpu")
    _, tlas_sb = builds[False]
    pool = pt.WavefrontRenderer.from_buffers(
        tlas_sb, pt.RTConfig(flatten=False, use_native_build=False,
                             packet_size=0), table, device="cpu")
    assert twf._route(table, pool.wa, 0) == ("pool", None)


def test_compiled_once_and_predicate_wins():
    """A callable compiles once (the same object after); a compiled
    predicate passes through; the predicate wins over ``alpha_ref``."""
    c = ap.compile_predicate(_checker_pred)
    assert ap.compile_predicate(_checker_pred) is c
    assert ap.compile_predicate(c) is c
    assert c.ops == ("mul", "floor", "to", "mul", "floor", "to", "add", "mod",
                     "eq", "ge", "and")
    from vortex_rt_tpu_torch.ops.packet_walk import anyhit_mode
    assert anyhit_mode(0.3, _checker_pred) == (None, c)
    assert anyhit_mode(0.3, None) == (0.3, None)


def _jax_frame(builds, flat: bool, render: bool = True,
               pred=_checker_pred_jax, **params):
    """The JAX renderer with ``stateless_anyhit(pred)`` (the checker's by
    default), and its frame (when ``render``)."""
    jsb, _ = builds[flat]
    jr = jwf.WavefrontRenderer.from_buffers(
        jsb, JCfg(flatten=flat, use_native_build=False),
        table=jsh.ShaderTable(anyhit=jsh.stateless_anyhit(pred, "pred")))
    return jr, (jr.render(JCam.look_at(*EYE), JParams(**params), W, H)
                if render else None)


def _port(builds, flat: bool, pred=_checker_pred, **cfg):
    _, tsb = builds[flat]
    return pt.WavefrontRenderer.from_buffers(
        tsb, pt.RTConfig(flatten=flat, use_native_build=False, **cfg),
        tsh.ShaderTable(anyhit=tsh.stateless_anyhit(pred, "pred")),
        device="cpu")


@pytest.fixture(scope="module")
def pool_frames(builds):
    """The port's suspension frames (``packet_size=0``: the TLAS build's
    pool path, K3's plain rounds running the callable) at depth 2 and 3:
    {depth: (image, rays)}."""
    slow = _port(builds, False, packet_size=0)
    return {depth: slow.render(pt.Camera.look_at(*EYE), pt.RenderParams(
        light_pos=LIGHT, max_depth=depth, shadow=True), W, H)
        for depth in (2, 3)}


@pytest.mark.parametrize("build", ["flat8", "tlas4"])
def test_stateless_frame_in_walk_matches_jax(builds, pool_frames, build):
    """``stateless_anyhit`` frames through the walks' predicate modes (K1
    on the flattened 8-wide build, K2 on the 4-wide TLAS build) against
    the JAX in-walk frame; and against the port's own suspension frame,
    within the JAX test's 2e-6."""
    flat = build == "flat8"
    params = dict(light_pos=LIGHT, max_depth=2, shadow=True)
    _, (jimg, jrays) = _jax_frame(builds, flat, **params)
    r = _port(builds, flat)
    assert r.wa.alpha_rows is not None
    route, inline = twf._route(r.table, r.wa, r.config.packet_size)
    assert route == "walk" and isinstance(inline, ap.CompiledPredicate)
    img, rays = r.render(pt.Camera.look_at(*EYE), pt.RenderParams(**params),
                         W, H)
    assert rays == jrays
    np.testing.assert_allclose(img, np.asarray(jimg), atol=1e-5)
    img_s, rays_s = pool_frames[2]
    assert rays_s == rays
    np.testing.assert_allclose(img, img_s, atol=2e-6)


def test_merged_wave_frame_matches_suspension(builds, pool_frames):
    """A depth-3 flat frame runs the merged shadow + bounce wave
    (``occl_split``) with the predicate; it equals the JAX in-walk frame
    within 1e-5 and the suspension frame within 2e-6, with the same
    rays."""
    params = dict(light_pos=LIGHT, max_depth=3, shadow=True)
    _, (jimg, jrays) = _jax_frame(builds, True, **params)
    r = _port(builds, True)
    calls = []
    real = r.walk

    def walk(wa, o, d, **kw):
        calls.append((kw.get("occl_split", 0), "anyhit_pred" in kw))
        return real(wa, o, d, **kw)

    img, rays = dataclasses.replace(r, walk=walk).render(
        pt.Camera.look_at(*EYE), pt.RenderParams(**params), W, H)
    assert max(calls)[0] > 0 and all(p for _, p in calls)
    assert rays == jrays
    np.testing.assert_allclose(img, np.asarray(jimg), atol=1e-5)
    img_s, rays_s = pool_frames[3]
    assert rays == rays_s
    np.testing.assert_allclose(img, img_s, atol=2e-6)


def test_perforated_frame_matches_jax_and_suspension(builds):
    """A 48x48 flat frame (K1's predicate mode, depth 2, shadows) with
    ``perforated_pred`` (correctly rounded ``sqrt``, ``sin``, ``cos``,
    ``**``) against the JAX in-walk frame (atol 1e-5, equal rays) and the
    port's suspension frame (the TLAS build at ``packet_size=0``, K3's
    plain rounds, the shader deciding with the compiled predicate's plain
    version) within 2e-6."""
    params = dict(light_pos=LIGHT, max_depth=2, shadow=True)
    _, (jimg, jrays) = _jax_frame(builds, True, pred=_perforated_pred_jax,
                                  **params)
    r = _port(builds, True, pred=perforated_pred)
    route, inline = twf._route(r.table, r.wa, r.config.packet_size)
    assert route == "walk" and inline is ap.compile_predicate(
        perforated_pred)
    cam, p = pt.Camera.look_at(*EYE), pt.RenderParams(**params)
    img, rays = r.render(cam, p, W, H)
    assert rays == jrays
    np.testing.assert_allclose(img, np.asarray(jimg), atol=1e-5)
    slow = _port(builds, False, pred=perforated_pred, packet_size=0)
    assert twf._route(slow.table, slow.wa, 0) == ("pool", None)
    img_s, rays_s = slow.render(cam, p, W, H)
    assert rays_s == rays
    np.testing.assert_allclose(img, img_s, atol=2e-6)
    solid, _ = pt.WavefrontRenderer.from_buffers(
        builds[True][1], pt.RTConfig(flatten=True, use_native_build=False),
        device="cpu").render(cam, p, W, H)
    assert np.abs(img - solid).max() > 0.1  # the predicate cuts out


def test_stats_frame_matches_jax(builds):
    """A ``collect_stats`` frame (``perf_trace``: the sequential pipeline
    through the counting walks, in predicate mode) whose rays and wave
    keys equal the JAX frame's."""
    p = dict(light_pos=LIGHT, max_depth=2, shadow=True)
    jr, _ = _jax_frame(builds, True, render=False)
    want = jr.perf_trace(JCam.look_at(*EYE), JParams(**p), W, H)
    got = _port(builds, True).perf_trace(pt.Camera.look_at(*EYE),
                                         pt.RenderParams(**p), W, H)
    assert got["rays"] == want["rays"]
    assert set(got) == set(want)
    waves = {k for k, v in want.items() if isinstance(v, dict)}
    assert waves == {"trace0", "trace1", "shadow0", "shadow1"}


def test_header_written_whole_by_concurrent_writers(tmp_path):
    """Many writers of one compiled predicate's header at once (K1's and
    K2's builds start together) all succeed and leave the whole text."""
    import threading

    c = ap.compile_predicate(_checker_pred)
    errors, start = [], threading.Barrier(16)

    def write():
        start.wait()
        try:
            c.write(tmp_path)
        except OSError as e:  # (a lost rename)
            errors.append(e)

    for _ in range(5):
        for f in tmp_path.iterdir():
            f.unlink()
        threads = [threading.Thread(target=write) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors
        assert [f.name for f in tmp_path.iterdir()] == [c.header_name]
        assert (tmp_path / c.header_name).read_text() == c.text


# Runs in a fresh interpreter: the cutout scene's tables with the alpha
# fields, camera rays, and trace_packets(anyhit_pred=_checker_pred_jax) in
# each mode (and with _perforated_pred_jax, keys under "perf/").
_JAX_WALKS = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, sys.argv[2])
from test_torch_anyhit import (EYE, _checker_pred_jax, _perforated_pred_jax,
                               cutout_scene)
from vortex_rt_tpu.golden.renderer import generate_rays
from vortex_rt_tpu.models import procedural as proc
from vortex_rt_tpu.models.scene import Camera, Material, Scene
from vortex_rt_tpu.ops.traverse_packet import trace_packets
from vortex_rt_tpu.ops.traverse_wide import WideArrays
from vortex_rt_tpu.utils.config import RTConfig

sc = cutout_scene(Scene, proc, Material)
o, d = (np.asarray(a) for a in generate_rays(Camera.look_at(*EYE), 48, 48))
n = o.shape[0]
out = {"o": o, "d": d}
t_occ = np.full(n, 10.0, np.float32)
split_t = np.where(np.arange(n) < n // 2, np.float32(10.0),
                   np.float32(1e30)).astype(np.float32)
modes = {"closest": {}, "occlusion": dict(t_max=t_occ, occlusion=True),
         "occl_split": dict(t_max=split_t, occl_split=n // 2)}
for build, flat, width, names in (
        ("flat8", True, 8, ("closest", "occlusion", "occl_split")),
        ("tlas4", False, 4, ("closest", "occlusion"))):
    sb = sc.build(RTConfig(flatten=flat, use_native_build=False))
    wa = WideArrays.from_scene(sb, width=width)
    if width == 8:
        wa = wa.fuse()
    wa = wa.with_alpha(sb)
    for k in ("nodes", "tri_rows", "alpha_rows", "alpha_pool") + (
            ("fused",) if width == 8 else ()):
        out[f"{build}/{k}"] = np.asarray(getattr(wa, k))
    for k in ("num_tlas", "max_leaf_tris", "depth", "tri_bits", "width"):
        out[f"{build}/{k}"] = np.int64(getattr(wa, k))
    for pre, pred, pred_names in (
            ("", _checker_pred_jax, names),
            ("perf/", _perforated_pred_jax, names if flat else ("closest",))):
        for mode in pred_names:
            kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                  for k, v in modes[mode].items()}
            for name, v in modes[mode].items():
                out[f"{build}/{mode}/arg/{name}"] = np.asarray(v)
            h, _ = trace_packets(wa, o, d, packet=64, anyhit_pred=pred, **kw)
            for k in ("dist", "bx", "by", "tri", "inst"):
                out[f"{pre}{build}/{mode}/{k}"] = np.asarray(getattr(h, k))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_walks_started(tmp_path_factory):
    """Starts the JAX walks' subprocess when the module's first test
    starts (it runs beside the compiler's and the frames' tests);
    ``jax_walks`` waits for it."""
    path = tmp_path_factory.mktemp("pred_walks") / "jax_pred.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_WALKS, str(path),
         os.path.join(REPO, "tests")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        yield proc, path
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_walks(_jax_walks_started):
    proc, path = _jax_walks_started
    out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _margin_ulps(u, v, a) -> np.ndarray:
    """Per candidate, the least distance of ``perforated_pred``'s three
    compared values (the hole's radius, the band's product, alpha**2.2),
    evaluated in float64, from their float32 thresholds, in float32 ulps
    of the threshold."""
    u, v, a = (np.asarray(x, np.float32) for x in (u, v, a))
    du = ((u * np.float32(12)) % np.float32(1) - np.float32(0.5)).astype(
        np.float64)
    dv = ((v * np.float32(12)) % np.float32(1) - np.float32(0.5)).astype(
        np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        vals = [(np.sqrt(du * du + dv * dv), 0.3),
                (np.sin(np.float64(u * np.float32(25)))
                 * np.cos(np.float64(v * np.float32(25))), 0.8),
                (np.float64(a) ** np.float64(np.float32(2.2)), 0.002)]
        return np.fmin.reduce([np.abs(x - np.float32(t))
                               / np.spacing(np.float32(t)) for x, t in vals])


def _explain(walk, wa, o, d, kw, rays) -> list:
    """The rays whose hits differ from JAX's, each walked alone with a
    plain version that records every candidate it decides: (ray, the
    closest any candidate's compared value comes to its threshold, in
    float32 ulps, that candidate's u, v, alpha)."""
    comp = ap.compile_predicate(perforated_pred)
    out = []
    for i in rays:
        seen = []

        def record(u, v, a):
            seen.append(torch.stack([u, v, a], 1))
            return comp.plain(u, v, a)

        one = {k: (x[i:i + 1] if torch.is_tensor(x) else x)
               for k, x in kw.items()}
        if "occl_split" in one:
            one["occl_split"] = int(i < kw["occl_split"])
        walk(wa, o[i:i + 1], d[i:i + 1],
             anyhit_pred=dataclasses.replace(comp, plain=record), **one)
        cands = torch.cat(seen).numpy() if seen else np.zeros((0, 3))
        m = _margin_ulps(*cands.T) if len(cands) else np.array([np.inf])
        j = int(np.argmin(m))
        out.append((int(i), float(m[j]),
                    tuple(cands[j]) if len(cands) else None))
    return out


@pytest.mark.parametrize("case", WALKS)
def test_pred_walk_matches_jax(jax_walks, case):
    """K1's (8-wide) and K2's (4-wide TLAS) plain predicate modes against
    the JAX ``trace_packets(anyhit_pred=...)``: every hit field to the
    bit; the predicate changes many hits.  With the perforated predicate
    a ray may differ only where a candidate's compared value lies within
    ``ULPS`` float32 ulps of its threshold (XLA's float32 ``sin``, ``cos``
    and ``pow`` are not correctly rounded; the port's are): each such ray
    is traced to that candidate and printed."""
    ref = jax_walks
    perf = case.startswith("perf/")
    build, mode = case.split("/")[-2:]
    pre = "perf/" if perf else ""
    pred = perforated_pred if perf else _checker_pred
    wa = bridge.wide_arrays(
        ref[f"{build}/nodes"], ref[f"{build}/tri_rows"], device="cpu",
        fused=ref.get(f"{build}/fused"),
        alpha_rows=ref[f"{build}/alpha_rows"],
        alpha_pool=ref[f"{build}/alpha_pool"],
        **{k: int(ref[f"{build}/{k}"]) for k in (
            "num_tlas", "max_leaf_tris", "depth", "tri_bits", "width")})
    arg = f"{build}/{mode}/arg/"
    kw = {k[len(arg):]: torch.from_numpy(v) for k, v in ref.items()
          if k.startswith(arg)}
    if mode == "occlusion":
        kw["occlusion"] = True
    if mode == "occl_split":
        kw["occl_split"] = ref["o"].shape[0] // 2
    walk = trace_packets_ref if wa.width == 8 else trace_packets_walk_ref
    o, d = torch.from_numpy(ref["o"]), torch.from_numpy(ref["d"])
    hits, _ = walk(wa, o, d, anyhit_pred=pred, **kw)
    differ = np.zeros(o.shape[0], bool)
    for k in ("dist", "bx", "by", "tri", "inst"):
        if mode != "closest" and k != "dist":
            continue  # occlusion lanes carry no hit record
        got = getattr(hits, k).numpy()
        want = ref[f"{pre}{build}/{mode}/{k}"]
        differ |= got.view(np.int32) != want.view(np.int32)
    if differ.any():
        assert perf, f"{case}: {int(differ.sum())} rays differ from JAX's"
        traced = _explain(walk, wa, o, d, kw, np.flatnonzero(differ))
        for ray, ulps, cand in traced:
            print(f"{case}: ray {ray} differs from JAX's; its nearest "
                  f"candidate to a decision (u, v, alpha) = {cand}, "
                  f"{ulps:.2f} ulps from its threshold")
        far = [t for t in traced if not t[1] <= ULPS]
        assert not far, f"{case}: rays differ beyond {ULPS} ulps: {far}"
    solid, _ = walk(wa, o, d, **kw)
    assert (solid.dist.numpy() != ref[f"{pre}{build}/{mode}/dist"]).sum() > 50


def test_op_weights_and_sass_counts():
    """``walk_bounds.pred_ops`` weighs each correctly rounded op by its
    ``PRED_OP_WEIGHTS`` entry (every such op has one) and counts one for
    every other node; ``tools/pred_op_sass`` emits each such op as the
    compiler does, and counts a SASS listing's common path (to the first
    unpredicated ``EXIT``), its FP64 arithmetic, its whole code and its
    calls."""
    from vortex_rt_tpu_torch.tools import pred_op_sass
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    assert set(wb.PRED_OP_WEIGHTS) == set(ap._CORRECTLY_ROUNDED)
    c = ap.compile_predicate(perforated_pred)
    rounded = ("sqrt", "sin", "cos", "pow")
    assert sorted(k for k in c.ops if k in rounded) == sorted(rounded)
    assert wb.pred_ops(c) == len(c.ops) - 4 + sum(
        wb.PRED_OP_WEIGHTS[k] for k in rounded)
    assert wb.pred_ops(ap.compile_predicate(_checker_pred)) == 11
    src = pred_op_sass.source()
    assert src.count("__global__") == len(ap._CORRECTLY_ROUNDED) + 1
    assert "out[i] = __fsqrt_rn(x[i]);" in src
    assert ("out[i] = __double2float_rn(pow((double)(x[i]), "
            "(double)(y[i])));") in src
    sass = """
        Function : k_x
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   ISETP.GE.AND P0, PT, R0, c[0x0][0x218], PT ;
        /*0020*/               @P0 EXIT ;
        /*0030*/                   DADD R2, R2, R4 ;
        /*0040*/                   CALL.REL.NOINC 0xa0 ;
        /*0050*/               @P1 BRA 0x70 ;
        /*0060*/                   CALL.REL.NOINC 0xc0 ;
        /*0070*/                   EXIT ;
        /*0080*/                   BRA 0x80;
        /*0090*/                   NOP;
        /*00a0*/                   DMUL R2, R2, R2 ;
        /*00b0*/                   RET.REL.NODEC R20 0x0 ;
        /*00c0*/                   DFMA R2, R2, R2, R4 ;
        /*00d0*/                   DFMA R2, R2, R2, R4 ;
        /*00e0*/                   RET.REL.NODEC R20 0x0 ;
    """
    # the call at 0x40 always runs (its body: 2), the one at 0x60 is
    # jumped over by the branch at 0x50
    assert pred_op_sass.counts(sass) == {
        "k_x": dict(main=10, dp=2, total=14, calls=2)}
