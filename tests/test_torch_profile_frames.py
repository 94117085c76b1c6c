"""The frame profiler's scene setup on the CPU (its timing needs a card)."""

import pytest
import torch

from vortex_rt_tpu_torch.ops.traverse_packet import trace_packets
from vortex_rt_tpu_torch.tools import profile_frames as pf


def test_config2_is_bench_frame():
    """bench.py's frame: 512x512, spp 2, depth 2, shadow, 8-wide fused."""
    r, cam, p, w, h = pf.build("config2", "cpu")
    assert (w, h, p.spp, p.max_depth, p.shadow) == (512, 512, 2, 2, True)
    assert r.walk is trace_packets
    assert r.wa.width == 8 and r.wa.fused is not None
    assert r.sb.num_tris > 24 * 48  # the box and the 24x48 sphere


@pytest.mark.parametrize("scene,spp,tris", [("config3", 4, 69_938),
                                            ("config4", 8, 259_594)])
def test_ladder_pathtraced_frames(scene, spp, tris):
    """The scale ladder's configs 3 and 4: 1920x1080, depth 3, shadow
    rays, path traced, on the K1 route."""
    r, cam, p, w, h = pf.build(scene, "cpu")
    assert (w, h, p.spp, p.max_depth, p.shadow, p.pathtrace) == (
        1920, 1080, spp, 3, True, True)
    assert r.sb.num_tris == tris
    assert r.walk is trace_packets
    assert r.wa.width == 8 and r.wa.fused is not None


def test_config5_is_the_ladder_refit_scene():
    """The animated mesh: the ladder tool's scene (small here), frame and
    light, on the K1 route."""
    st, cam, p, w, h = pf.build_refit("cpu", grid=10)
    assert (w, h, p.spp, p.max_depth, p.shadow, p.pathtrace) == (
        1920, 1080, 2, 2, True, False)
    assert tuple(p.light_pos) == (0.0, 14.0, 0.0)
    assert st.sb.num_tris == 2 * 9 * 9
    assert st.r.walk is trace_packets
    wa = st.refit_frame(0.2)
    assert wa.width == 8 and wa.fused is not None and wa.depth == 22


def test_unknown_scene_is_refused():
    with pytest.raises(ValueError, match="unknown scene"):
        pf.build("teapot", "cpu")


def test_cli_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        pf.main(["--scene", "config2"])
