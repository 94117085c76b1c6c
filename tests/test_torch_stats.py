"""Per-wave walk statistics and staged profiling of the port's frame
(``frame_body(collect_stats=..., stage_limit=...)``, ``render_stats``,
``render_profile_burst``, ``WavefrontRenderer.perf_trace``,
``frame_profile`` and ``scope_trace``) on the CPU, where the walks count
in their plain versions (``walk_work`` / ``walk_work_4``).

The port's ``PacketStats`` are defined over its per-ray walk, not over
the JAX package's lockstep packets (ROADMAP hazard H19), so only the
frame's rays and the wave keys are held to JAX ``perf_trace`` (one JAX
frame, cornell at 16x16, depth 2, shadow rays, the 8-wide flat build);
each counter is held to the sums and maxima of the plain walk's
per-ray counts over the same waves, captured from the frame, on the
8-wide and 4-wide flat builds and the 4-wide TLAS build (instance
steps).  A stats frame gives the plain frame's image and rays (at depth
3 the plain frame merges its shadow and bounce waves, the stats frame
does not); a frame cut at its last stage is the whole frame.
``frame_profile``'s labels equal the JAX method's (computed with the
JAX bursts stubbed out: no JAX frame runs) at depth 1 and 2, with and
without shadow rays.
"""

import numpy as np
import pytest
import torch

from vortex_rt_tpu.engine import wavefront as jwf
from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu.models.scene import (
    RenderParams as JParams, Scene as JScene,
)
from vortex_rt_tpu.utils.config import RTConfig as JCfg

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch.engine import wavefront as twf
from vortex_rt_tpu_torch.engine.megakernel import CameraArrays, LightArrays
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.ops.packet_walk import StepKinds, walk_work_4
from vortex_rt_tpu_torch.ops.traverse_packet import (
    WARP, PacketStats, packet_stats, walk_work,
)

W = H = 16
FIELDS = ("steps", "packet_steps", "ray_steps", "rays_per_live_packet",
          "int_steps", "tri_steps", "ins_steps")


def _cornell(scene_cls, proc, cfg):
    sc = scene_cls()
    for mesh, refl in proc.cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    return sc.build(cfg)


def _renderer(flatten=True, width=0):
    cfg = pt.RTConfig(flatten=flatten, bvh_width=width,
                      use_native_build=False)
    sb = _cornell(pt.Scene, tproc, cfg)
    return (pt.WavefrontRenderer.from_buffers(sb, cfg, device="cpu"),
            pt.Scene.framing_camera(sb, 45.0, 1.0))


def test_perf_trace_keys_and_rays_match_jax():
    p = dict(max_depth=2, shadow=True)
    jsb = _cornell(JScene, jproc, JCfg(flatten=True, use_native_build=False))
    jr = jwf.WavefrontRenderer.from_buffers(jsb, JCfg(flatten=True))
    want = jr.perf_trace(JScene.framing_camera(jsb, 45.0, 1.0),
                         JParams(**p), W, H)
    r, cam = _renderer()
    got = r.perf_trace(cam, pt.RenderParams(**p), W, H)
    assert set(got) == set(want)
    assert got["rays"] == want["rays"]
    assert got["packet_size"] == WARP
    waves = {k for k, v in want.items() if isinstance(v, dict)}
    assert waves == {"trace0", "trace1", "shadow0", "shadow1"}
    for k in waves:
        assert list(got[k]) == list(want[k]) == list(FIELDS)


def _captured(r, cam, p, w, h):
    """perf_trace of a frame and the inputs of its walk waves, in order."""
    waves = []
    walk = r.walk

    def capture(wa, o, d, **kw):
        waves.append((o.clone(), d.clone(), dict(kw)))
        return walk(wa, o, d, **kw)

    r.walk = capture
    try:
        out = r.perf_trace(cam, p, w, h)
    finally:
        r.walk = walk
    return out, waves


@pytest.mark.parametrize("flatten,width", [(True, 8), (True, 4),
                                           (False, 4)])
def test_stats_counters_equal_plain_walk(flatten, width):
    r, cam = _renderer(flatten, width)
    p = pt.RenderParams(max_depth=2, shadow=True, spp=2)
    out, waves = _captured(r, cam, p, W, H)
    names = ["trace0", "shadow0", "trace1", "shadow1"] * 2  # two passes
    assert len(waves) == len(names)
    want = {}
    work_fn = walk_work if width == 8 else walk_work_4
    for name, (o, d, kw) in zip(names, waves):
        assert kw.pop("stats") is True
        _, steps, work = work_fn(r.wa, o, d, **kw)
        s = steps.to(torch.int64)
        pad = torch.cat([s, s.new_zeros((-len(s)) % WARP)])
        st = dict(steps=int(s.max()),
                  packet_steps=int(pad.reshape(-1, WARP).max(1).values.sum()),
                  ray_steps=int(s.sum()), int_steps=int(work.internal.sum()),
                  tri_steps=int(work.leaf.sum()),
                  ins_steps=int(work.instance.sum()))
        want[name] = {k: want.get(name, {}).get(k, 0) + v
                      for k, v in st.items()}
    for name, st in want.items():
        got = out[name]
        for k, v in st.items():
            assert got[k] == v, (name, k)
        assert got["rays_per_live_packet"] == round(
            st["ray_steps"] / max(st["packet_steps"], 1), 2)
    assert out["steps"] == sum(v["ray_steps"] for v in want.values())
    assert (out["trace0"]["ins_steps"] > 0) == (not flatten)


def test_packet_stats_reductions():
    steps = torch.tensor([3, 0, 7] + [1] * 30 + [5, 2], dtype=torch.int32)
    kinds = StepKinds(internal=steps // 2, instance=(steps > 4).int())
    st = packet_stats(steps, kinds)
    assert isinstance(st, PacketStats)
    assert int(st.steps) == 7
    assert int(st.packet_steps) == 7 + 5  # a warp of 32, then 3 lanes
    assert int(st.ray_steps) == int(steps.sum())
    assert int(st.int_steps) == int((steps // 2).sum())
    assert int(st.ins_steps) == 2
    assert int(st.tri_steps) == int(steps.sum()) - int(st.int_steps) - 2
    both = st + st
    assert int(both.steps) == 14 and int(both.ray_steps) == 2 * int(
        steps.sum())


@pytest.mark.parametrize("depth", [2, 3])
def test_stats_frame_equals_plain_frame(depth):
    r, cam = _renderer()
    p = pt.RenderParams(max_depth=depth, shadow=True,
                        light_pos=(0.0, 0.8, -0.5))
    ca = CameraArrays.from_camera(cam, "cpu")
    light = LightArrays.from_params(p, "cpu")
    kw = dict(max_depth=depth, shadow=True)
    img, rays, steps = twf.frame_body(r.wa, r.sa, ca, light, W, H, **kw)
    img_s, rays_s, _, ws = twf.frame_body(r.wa, r.sa, ca, light, W, H,
                                          collect_stats=True, **kw)
    assert int(rays_s) == int(rays)
    np.testing.assert_allclose(img_s.numpy(), img.numpy(), atol=1e-6)
    assert set(ws) == {f"{k}{b}" for k in ("trace", "shadow")
                       for b in range(depth)}
    # the last stage's limit is the whole frame
    img_l, rays_l, steps_l = twf.frame_body(
        r.wa, r.sa, ca, light, W, H, stage_limit=3 * depth, **kw)
    assert int(rays_l) == int(rays)
    np.testing.assert_allclose(img_l.numpy(), img.numpy(), atol=1e-6)


def test_stage_limit_rays():
    r, cam = _renderer()
    p = pt.RenderParams(max_depth=2, shadow=True)
    ca = CameraArrays.from_camera(cam, "cpu")
    light = LightArrays.from_params(p, "cpu")
    full = r.perf_trace(cam, p, W, H)
    rays = [int(twf.render_profile_burst(
        r.wa, r.sa, ca, light, W, H, n_frames=1, max_depth=2, shadow=True,
        stage_limit=s)) for s in range(7)]
    assert rays[0] == 0 and rays[1] == W * H
    assert rays[2] > rays[1] and rays[3] == rays[2]
    assert rays[6] == full["rays"]
    assert rays == sorted(rays)
    # two frames of a burst count twice
    assert int(twf.render_profile_burst(
        r.wa, r.sa, ca, light, W, H, n_frames=2, max_depth=2, shadow=True,
        stage_limit=6)) == 2 * full["rays"]
    rays_s, _, ws = twf.render_stats(r.wa, r.sa, ca, light, W, H,
                                     max_depth=2, shadow=True)
    assert int(rays_s) == full["rays"] and "shadow1" in ws


@pytest.mark.parametrize("depth,shadow", [(1, False), (1, True), (2, False),
                                          (2, True)])
def test_frame_profile_labels_match_jax(monkeypatch, depth, shadow):
    monkeypatch.setattr(jwf, "render_profile_burst",
                        lambda *a, **k: np.int32(0))
    jr = object.__new__(jwf.WavefrontRenderer)
    jr.config, jr.table, jr._dev_cache = JCfg(), None, {}
    jr.wa = jr.sa = None
    monkeypatch.setattr(jr, "_dev_args", lambda cam, p: (None, None),
                        raising=False)
    monkeypatch.setattr(jr, "_table_for", lambda p: None, raising=False)
    want = jr.frame_profile(None, JParams(max_depth=depth, shadow=shadow),
                            W, H, n_frames=1)
    r, cam = _renderer()
    got = r.frame_profile(cam, pt.RenderParams(max_depth=depth,
                                               shadow=shadow), 8, 8,
                          n_frames=1)
    assert [g["stage"] for g in got] == [w["stage"] for w in want]
    assert all(set(g) == set(w) for g, w in zip(got, want))
    assert got[-1]["cum_ms"] >= 0.0


def test_scope_trace_structure():
    r, cam = _renderer(False, 4)
    tr = r.scope_trace(cam, pt.RenderParams(max_depth=2, shadow=True), 8, 8,
                       n_frames=1)
    evs = tr.events
    spans = [e for e in evs if e["ph"] == "X"]
    assert [e["name"] for e in spans] == [
        "camera", "trace0", "shadow0", "shade0", "trace1", "shadow1",
        "shade1"]
    assert spans[1]["args"]["steps"] > 0 and spans[1]["args"]["ins_steps"] > 0
    for a, b in zip(spans, spans[1:]):
        assert abs(a["ts"] + a["dur"] - b["ts"]) < 1e-6
    counters = [e for e in evs if e["ph"] == "C"]
    # five tracks stepped at each of the four walk waves
    assert len(counters) == 5 * 4
    assert [e for e in evs if e["ph"] == "i"][0]["args"]["packet_size"] \
        == WARP
