"""The port's config-2 bench entry (``tools/bench.py``) and ladder rows 1, 2
and 4 (``tools/bench_ladder.py``) on the CPU, against the JAX ladder
(``tools/bench_ladder.py`` at the repo root, loaded from its file).

The JAX rows are run with their timing and parity replaced by functions
that keep what they are given, so each test holds the port's row to the
JAX row's own scene buffers, camera and parameters: the same triangles
and vertices to the bit, the same camera and parameters field by field
(row 4 on ``atrium(target_tris=3000)``, the port's ``--atrium4`` shrink).
Rows 1 and 2 then render a 32x32 frame through both renderers: equal ray
counts, images within 1e-5 (the JAX frame runs in-process, with FMA
contraction: ROADMAP hazard H2).  Each row's golden parity passes at a
small size through the port's oracle; config 2's scene is
``bench.py``'s ``bench_scene`` with the sphere (its teapot OBJ read as
absent), and the bench entry's JSON line parses, built from its flags or
on a row built already.  Rows 1 and 2 time one 1-frame burst after a 1-frame warm-up
here (``BURST``, ``REPS``); row 4's frame timing is row 3's
``bench_frames`` (tested in ``test_torch_bench_ladder.py``), replaced
here by a stub, so that row 4 renders only its parity frame.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from vortex_rt_tpu.models import bigscenes as jbig

from vortex_rt_tpu_torch.models import config2
from vortex_rt_tpu_torch.tools import bench, bench_ladder as bl

ROOT = Path(__file__).resolve().parents[1]
W = H = 32
ATRIUM4 = 3000
RES4 = (16, 9)  # 16:9, as 1920x1080


@pytest.fixture(scope="module")
def jbl():
    """The JAX ladder module, loaded from its file (its import puts a
    path on ``sys.path``; that is taken back)."""
    saved = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "jax_bench_ladder", ROOT / "tools" / "bench_ladder.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.fixture
def no_teapot(monkeypatch):
    """``bench.py``'s teapot OBJ reads as absent, so that its scene is the
    port's config 2 (the Cornell box and the sphere) on any machine."""
    real = os.path.exists
    monkeypatch.setattr(os.path, "exists", lambda p: (
        False if str(p).endswith("assets/teapot.obj") else real(p)))


def _jax_row(monkeypatch, jbl, run):
    """``run()`` of a JAX row, its timing and parity replaced: the
    record and {r, cam, p, w, h, sb, n}."""
    got = {}

    def timing(r, cam, p, w, h, *a, **kw):
        got.update(r=r, cam=cam, p=p, w=w, h=h)
        return {}

    def parity(rec, r, sb, cam, p, w, h, n=16, **kw):
        got.update(sb=sb, n=n)
        return rec

    monkeypatch.setattr(jbl, "_bench_burst", timing)
    monkeypatch.setattr(jbl, "_bench_frames", timing)
    monkeypatch.setattr(jbl, "_parity", parity)
    return run(), got


def _same_row(row, jrec, got):
    """The port's row against the JAX row's record and arguments."""
    sb, jsb = row.sb, got["sb"]
    assert sb.num_tris == jsb.num_tris == jrec["tris"]
    assert sb.num_instances == jsb.num_instances
    for f in ("v0", "v1", "v2", "inst_reflectivity"):
        np.testing.assert_array_equal(getattr(sb, f), getattr(jsb, f),
                                      err_msg=f)
    for a, b in zip(row.cam.as_arrays(), got["cam"].as_arrays()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jp = dataclasses.asdict(got["p"])
    for k, v in dataclasses.asdict(row.p).items():
        assert v == jp[k], k
    assert row.r.config.bvh_width == jrec["knobs"]["bvh_width"] == 8
    assert row.r.config.max_leaf_tris == jrec["knobs"]["max_leaf_tris"]
    assert row.r.wa.fused is not None and jrec["knobs"]["fused_rows"]
    assert f"{row.res[0]}x{row.res[1]}" == jrec["res"] == \
        f"{got['w']}x{got['h']}"
    assert (row.p.spp, row.p.max_depth, row.p.shadow) == (
        jrec["spp"], jrec["depth"], jrec["shadow"])


def _same_frame(row, got):
    img, rays = row.r.render(row.cam, row.p, W, H)
    jimg, jrays = got["r"].render(got["cam"], got["p"], W, H)
    assert rays == int(jrays) >= W * H * row.p.spp
    np.testing.assert_allclose(img, np.asarray(jimg), atol=1e-5)


def _run_small(monkeypatch, row):
    monkeypatch.setattr(bl, "BURST", 1)
    monkeypatch.setattr(bl, "REPS", 1)
    return bl.run_row(row)


@pytest.mark.parametrize("num", [1, 2])
def test_rows_1_2_match_the_jax_rows(monkeypatch, jbl, no_teapot, num):
    """The JAX row's scene, camera and parameters; the 32x32 frame
    against the JAX renderer's; the row run with its golden parity."""
    jrec, got = _jax_row(monkeypatch, jbl, functools.partial(
        jbl.config1 if num == 1 else jbl.config2, 0))
    assert got["n"] == 16
    setup = bl.setup1 if num == 1 else bl.setup2
    row = setup("cpu")
    assert jrec["scene"].startswith(row.scene.split("+")[0])
    _same_row(row, jrec, got)
    _same_frame(row, got)
    rec = _run_small(monkeypatch, dataclasses.replace(row, res=(16, 16)))
    assert rec["parity_ok"] and rec["parity_rmse"] < 1e-6
    assert rec["parity_pixels"] == 16 and rec["parity_seed"] == 7
    assert rec["rays_per_frame"] >= 16 * 16 * 2
    assert rec["mrays"] > 0 and rec["ms_per_frame"] > 0
    assert rec["launches_per_frame"] == {}  # the CPU walks launch nothing


def test_row4_matches_the_jax_row(monkeypatch, jbl):
    """Row 4 on ``atrium(target_tris=3000)``: the JAX row's buffers (29
    meshes, each with its reflectivity), camera and parameters, then its
    golden parity at 16x9 and the bench spp."""
    monkeypatch.setattr(jbig, "atrium", functools.partial(
        jbig.atrium, target_tris=ATRIUM4))
    jrec, got = _jax_row(monkeypatch, jbl, functools.partial(
        jbl._scale_cfg, 4, "atrium", 8, 3, 0))
    assert got["n"] == 8 and jrec["pathtrace"]
    row = bl.setup4("cpu", target_tris=ATRIUM4)
    assert row.sb.num_instances == 29
    _same_row(row, jrec, got)
    monkeypatch.setattr(bl, "bench_frames", lambda *a, **kw: dict(
        rays_per_frame=0, mrays=0.0, ms_per_frame=0.0))
    rec = bl.run_row(dataclasses.replace(row, res=RES4))
    assert rec["config"] == 4 and rec["pathtrace"] and rec["spp"] == 8
    assert rec["parity_ok"] and rec["parity_rmse"] < 1e-6
    assert rec["parity_pixels"] == 8


def test_ladder_main_runs_the_rows(monkeypatch, capsys):
    """Rows 1 and 2 through the command line with the shrink flags: one
    JSON line a row."""
    monkeypatch.setattr(bl, "BURST", 1)
    monkeypatch.setattr(bl, "REPS", 1)
    recs = bl.main(["--configs", "1,2", "--device", "cpu", "--res1",
                    "16x16", "--res2", "16x16"])
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert lines == recs and [x["config"] for x in lines] == [1, 2]
    assert all(x["parity_ok"] and x["gpu"] is None for x in lines)
    assert lines[1]["scene"] == config2.SCENE2 == "cornell+sphere"


@pytest.mark.parametrize("flatten,leaf", [(True, 4), (True, 8),
                                          (False, 4)])
def test_config2_scene_is_bench_scene(no_teapot, flatten, leaf):
    """Config 2's scene is ``bench.py``'s ``bench_scene`` on a machine
    without the teapot OBJ, triangle for triangle."""
    import bench as jbench

    jsb = jbench.bench_scene(flatten=flatten, max_leaf_tris=leaf)
    sb, cfg = config2.config2_scene(leaf=leaf, flatten=flatten)
    assert cfg.max_leaf_tris == leaf and sb.num_tris == jsb.num_tris
    assert sb.num_instances == jsb.num_instances
    for f in ("v0", "v1", "v2", "n0", "n1", "n2", "inst_reflectivity"):
        np.testing.assert_array_equal(getattr(sb, f), getattr(jsb, f),
                                      err_msg=f)


@pytest.mark.parametrize("part", ["k1a", "k2", "k6"])
def test_walk_timing_refuses_a_tree_without_config2(tmp_path, part):
    """``walk_timing.py --root`` names the missing module for the parts
    that take config 2 from it, before it imports the tree."""
    from vortex_rt_tpu_torch.tools import walk_timing

    saved = list(sys.path)
    with pytest.raises(RuntimeError, match="models/config2.py"):
        walk_timing.main(["--root", str(tmp_path), "--parts", f"k3,{part}"])
    assert sys.path == saved


@pytest.mark.parametrize("flags,leaf", [([], 4), (["--leaf", "8"], 8),
                                        (None, 4)])
def test_bench_entry_line(monkeypatch, capsys, flags, leaf):
    """The bench entry's line at 16x16 with 1-frame bursts: built from
    its flags, or (``flags`` None) on row 2 built already, as
    ``chip_smoke.py`` runs it."""
    monkeypatch.setattr(bl, "BURST", 1)
    monkeypatch.setattr(bl, "REPS", 1)
    monkeypatch.setattr(config2, "SIZE2", 16)
    if flags is None:
        rec = bench.main([], row=bl.setup2("cpu"))
    else:
        rec = bench.main(["--device", "cpu", *flags])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec
    assert {"metric", "value", "unit", "vs_baseline", "gpu", "scene",
            "knobs"} <= set(line)
    assert line["unit"] == "Mrays/s" and line["value"] > 0
    assert line["vs_baseline"] == line["value"] / 200
    assert line["gpu"] is None and line["scene"] == "cornell+sphere"
    assert line["knobs"] == dict(bvh_width=8, max_leaf_tris=leaf,
                                 fused=True)
    assert "16x16 spp2" in line["metric"]
    assert line["rays_per_frame"] >= 16 * 16 * 2
