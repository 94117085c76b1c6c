"""The port's ``utils/trace.py`` against the JAX package's: the Chrome
trace format of ``tests/test_runtime.py::test_tracer_chrome_format`` on
both tracers (same event names, phases and keys), the explicit-timeline
events, and ``maybe_span`` under enable and disable (no event while
tracing is off; the chunked frame's spans while it is on)."""

import json

import numpy as np
import pytest

from vortex_rt_tpu.utils import trace as jtrace

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.utils import trace as ttrace


def _fill(t):
    with t.span("build", tris=10):
        with t.span("blas"):
            pass
    t.counter("rays", alive=42)
    t.instant("done")
    t.complete_at("stage", 5.0, 2.5, tid=1, steps=3)
    t.counter_at("mix", 5.0, internal=1, triangle=2)


def _shape(events):
    """Events without their clock readings."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def test_tracer_chrome_format(tmp_path):
    t = ttrace.Tracer()
    _fill(t)
    out = tmp_path / "trace.json"
    t.save(str(out))
    data = json.loads(out.read_text())
    names = [e["name"] for e in data["traceEvents"]]
    assert names == ["blas", "build", "rays", "done", "stage", "mix"]
    assert all("ts" in e for e in data["traceEvents"])
    spans = [e for e in data["traceEvents"] if e["ph"] == "X"]
    assert all(e["dur"] >= 0 for e in spans)
    assert data["displayTimeUnit"] == "ms"

    j = jtrace.Tracer()
    _fill(j)
    j.save(str(tmp_path / "jax.json"))
    jdata = json.loads((tmp_path / "jax.json").read_text())
    assert set(jdata) == set(data)
    assert _shape(data["traceEvents"]) == _shape(jdata["traceEvents"])
    assert _shape(t.events) == _shape(j.events)
    # the explicit-timeline events keep their given clock
    assert [(e["ts"], e.get("dur")) for e in t.events[4:]] == \
        [(e["ts"], e.get("dur")) for e in j.events[4:]]


@pytest.mark.parametrize("mod", [ttrace, jtrace], ids=["port", "jax"])
def test_maybe_span_enable_disable(mod):
    mod.disable_tracing()
    assert mod.global_tracer() is None
    with mod.maybe_span("off", k=1) as t:
        assert t is None
    tr = mod.enable_tracing()
    try:
        assert mod.global_tracer() is tr
        with mod.maybe_span("on", k=2) as t:
            assert t is tr
        assert [(e["name"], e["ph"], e["args"]) for e in tr.events] == \
            [("on", "X", {"k": 2})]
    finally:
        mod.disable_tracing()
    with mod.maybe_span("after"):
        pass
    assert len(tr.events) == 1 and mod.global_tracer() is None


def test_chunked_frame_spans():
    """The chunked frame's compact / trace / shade spans (the JAX
    method's names and order) while tracing is on, none while off."""
    sc = pt.Scene()
    for mesh, refl in tproc.cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sb = sc.build(pt.RTConfig())
    r = pt.WavefrontRenderer.from_buffers(sb, pt.RTConfig(), device="cpu")
    cam = pt.Scene.framing_camera(sb, 45.0, 1.0)
    p = pt.RenderParams(max_depth=2)
    ttrace.disable_tracing()
    img_off, rays_off = r.render(cam, p, 8, 8, mode="chunked")
    tr = ttrace.enable_tracing()
    try:
        img_on, rays_on = r.render(cam, p, 8, 8, mode="chunked")
    finally:
        ttrace.disable_tracing()
    assert [e["name"] for e in tr.events] == ["trace", "shade", "compact",
                                              "trace", "shade"]
    assert [e["args"]["bounce"] for e in tr.events] == [0, 0, 1, 1, 1]
    assert rays_on == rays_off
    np.testing.assert_array_equal(img_on, img_off)
