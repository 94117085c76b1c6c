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


def test_unknown_scene_is_refused():
    with pytest.raises(ValueError, match="unknown scene"):
        pf.build("teapot", "cpu")


def test_cli_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        pf.main(["--scene", "config2"])
