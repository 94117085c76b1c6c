"""The reference and the frozen copies on the CPU: the reference against
the port's plain route (32x32 frames of a cut-down scene: Whitted and
path traced), what the reference and the run import, the frozen walk
count and bound arithmetic against the port's ``walk_work`` and
``tools/walk_bounds.py``, the scene against its definition.  The card's
test is marked ``gpu``:

    python -m pytest rtbench/tests -q                # here
    python -m pytest rtbench/tests -q -m gpu         # on the card
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rtbench import harness, spec
from rtbench.configs import tetra
from rtbench.reference import bounds, walk
from rtbench.reference.render import frame_pixels

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"tetra": {"levels": 5}}


def whole_frame(workload: str, device, **traffic):
    """(program, frame 3's (n_pix, 3) image and rays through the port's
    route on ``device``, the reference's image and per-pixel rays)."""
    cell = spec.load_cell(ROOT, workload)
    t = dict(cell.traffic, width=32, height=32, **traffic)
    prog = harness.setup(cell, 99, device, SMALL[cell.config["name"]], t)
    img, rays, _ = prog.render(prog.wa, 3)
    ref, cnt = frame_pixels(prog.meshes, prog.cam, prog.light, t,
                            prog.frame_seed(3), np.arange(32 * 32), device)
    return prog, img.T.cpu().numpy(), int(rays), ref, cnt


def test_whitted_frame_matches_the_port():
    _, got, rays, ref, cnt = whole_frame("tetra.shadow1080",
                                         torch.device("cpu"))
    assert np.abs(got - ref).max() <= 1e-6
    assert rays == int(cnt.sum())
    assert (ref > 0).any()


def test_path_traced_frame_matches_the_port():
    _, got, rays, ref, cnt = whole_frame("tetra.pt1080",
                                         torch.device("cpu"))
    err = np.abs(got - ref).max(1)
    assert (err <= 1e-5).mean() >= 0.99
    assert np.sqrt(((got - ref) ** 2).mean()) < 1e-3
    assert abs(rays - int(cnt.sum())) <= 0.01 * rays


def test_bfloat16_reference_departs():
    """The control's precision changes the frame."""
    prog, got, _, ref, _ = whole_frame("tetra.pt1080", torch.device("cpu"),
                                       spp=2)
    bf, _ = frame_pixels(prog.meshes, prog.cam, prog.light, prog.traffic,
                         prog.frame_seed(3), np.arange(32 * 32),
                         torch.device("cpu"), torch.bfloat16)
    assert (np.abs(bf - ref).max(1) > 1e-3).mean() > 0.05


def _modules_after(code: str) -> set:
    p = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    mods = _modules_after(
        "import numpy as np, torch\n"
        "from rtbench import spec, scenes\n"
        "from rtbench.reference import bounds, camera, render, sampler\n"
        "from pathlib import Path\n"
        "cell = spec.load_cell(Path('.'), 'tetra.pt1080')\n"
        "m = cell.scene.meshes(levels=3)\n"
        "cam = camera.framing_camera(m, 45.0, 1.0)\n"
        "t = dict(cell.traffic, width=8, height=8)\n"
        "render.frame_pixels(m, cam, render.Light(), t, 5, np.arange(64),"
        " torch.device('cpu'))\n")
    assert not mods & {"vortex_rt_tpu_torch", "vortex_rt_tpu", "jax",
                       "jaxlib", "flax"}


def test_run_imports_no_jax():
    mods = _modules_after(
        "import torch\nfrom pathlib import Path\n"
        "import rtbench.run, rtbench.calibrate, rtbench.faults\n"
        "from rtbench import harness\n"
        "harness.run(Path('.'), 'tetra.shadow1080', 3, 0.2, True, "
        "torch.device('cpu'), config_params={'levels': 3}, "
        "traffic=dict(__import__('json').load(open('rtbench/traffic/"
        "shadow1080.json')), width=16, height=16, "
        "profile_frames=1))\n")
    assert "vortex_rt_tpu_torch" in mods
    assert not mods & {"vortex_rt_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("workload", ["tetra.pt1080", "tetra.shadow1080"])
def test_frozen_walk_and_bounds_match_the_ports(workload):
    """Every wave of a frame (closest-hit, shadow and bounce waves): the
    frozen walk's counts equal ``walk_work``'s, and the frozen bound
    equals ``walk_bounds.k1_bound``."""
    from vortex_rt_tpu_torch.ops import traverse_packet
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    cell = spec.load_cell(ROOT, workload)
    t = dict(cell.traffic, width=24, height=16)
    prog = harness.setup(cell, 5, torch.device("cpu"), SMALL["tetra"], t)
    waves = []

    def recording(wa, o, d, **kw):
        waves.append((wa, o, d, kw))
        return traverse_packet.trace_packets(wa, o, d, **kw)

    prog.render(prog.wa, 0, walk=recording)
    assert len(waves) >= 4
    for wa, o, d, kw in waves:
        kw = {k: v for k, v in kw.items() if k in (
            "active", "t_max", "occlusion", "occl_split")}
        theirs = traverse_packet.walk_work(wa, o, d, **kw)[2]
        mine = walk.count(wa, o, d, **kw)
        for k in ("internal", "child_slots", "leaf", "tri_slots",
                  "row_bytes"):
            assert torch.equal(getattr(mine, k), getattr(theirs, k)), k
        assert int(theirs.instance.sum()) == 0
        a, b = bounds.k1_bound(mine), wb.k1_bound(theirs)
        assert (a.ops, a.bytes, a.ms) == (b.ops, b.bytes, b.ms)
    assert walk.count(type("Four", (), {"width": 4})(), *waves[0][1:3]) \
        is None


def test_tetra_scene():
    """4^levels congruent equilateral triangles, normals outward from
    their tetrahedron, apex up; the file's counts at its own levels."""
    for levels in (1, 3):
        (m,) = tetra.meshes(levels=levels)
        assert m.num_tris == 4 ** levels
        edge = 2 * np.sqrt(2) * 0.5 ** (levels - 1)
        for a, b in ((m.v0, m.v1), (m.v1, m.v2), (m.v2, m.v0)):
            assert np.allclose(np.linalg.norm(a - b, axis=1), edge,
                               rtol=1e-5)
        # the fourth corner of each face's tetrahedron lies behind it
        c, s = tetra.centres(levels)
        centre = np.repeat(c @ tetra.ROTATION.T, 4, axis=0)
        tri_c = (m.v0 + m.v1 + m.v2) / 3.0
        assert (np.einsum("ij,ij->i", m.n0, tri_c - centre) > 0).all()
        top = max(m.v0[:, 1].max(), m.v1[:, 1].max(), m.v2[:, 1].max())
        assert np.isclose(top, np.sqrt(3.0), rtol=1e-5)
    cfg = spec.load_cell(ROOT, "tetra.pt1080").config
    full = tetra.meshes(**cfg["params"])
    assert (sum(x.num_tris for x in full), len(full)) == (
        cfg["triangles"], cfg["meshes"])


def test_config_counts_are_held():
    cell = spec.load_cell(ROOT, "tetra.shadow1080")
    cell.config = dict(cell.config, triangles=cell.config["triangles"] + 1)
    with pytest.raises(ValueError, match="triangles"):
        harness.setup(cell, 1, torch.device("cpu"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["tetra.shadow1080"])
def test_on_card_frames_match_the_reference(card, workload):
    """The port's K1 route on the card against the reference run on the
    card, and the reference on the card against the reference on the
    CPU, at 32x32."""
    _, got, rays, ref, cnt = whole_frame(workload, card)
    assert np.abs(got - ref).max() <= 1e-5
    assert rays == int(cnt.sum())
    _, _, _, ref_cpu, cnt_cpu = whole_frame(workload, torch.device("cpu"))
    assert np.abs(ref_cpu - ref).max() <= 1e-5
    assert np.array_equal(cnt, cnt_cpu)
