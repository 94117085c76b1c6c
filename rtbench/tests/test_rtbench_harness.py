"""The harness on the CPU, no card: files found by name, new files picked
up with no edit, the result line's keys, the contract's name and unit
characters, no fall-back to the CPU, the trace reading, and ``correct``
false under the control and under each planted fault.

    python -m pytest rtbench/tests -q
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rtbench import faults, harness, spec
from rtbench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"tetra": {"levels": 5}}
SEED = 2 ** 31 + 4321
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny(workload: str, root: Path = ROOT, **kw) -> dict:
    """One run of ``workload`` on the CPU at 32x18 on a cut-down scene,
    every pixel checked."""
    cell = spec.load_cell(root, workload)
    t = dict(cell.traffic, width=32, height=18,
             check={"frames": 2, "pixels": 32 * 18},
             profile_frames=1)
    return harness.run(root, workload, kw.pop("seed", SEED),
                       kw.pop("seconds", 0.3), kw.pop("traced", False),
                       torch.device("cpu"),
                       config_params=SMALL[cell.config["name"]],
                       traffic=t, **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = spec.load_cell(ROOT, workload)
    w = next(x for x in BENCH["workloads"] if x["name"] == workload)
    assert cell.config["name"] == w["config"]
    assert cell.traffic["name"] == w["traffic"]
    assert set(cell.checks["limits"]) == {"px_bad_share", "px_rmse",
                                          "rays_gap"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.readers([m])[m["name"]].read)
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (ROOT / cfg["file"]).exists()


def test_new_traffic_and_metric_picked_up(tmp_path):
    """A traffic mix, a cell, its limits and an end-to-end metric added as
    files and entries alone, in a copy, run with no other edit."""
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "vortex_rt_tpu_torch").symlink_to(ROOT / "vortex_rt_tpu_torch")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="tetra.tiny", config="tetra",
                                   traffic="tiny", chips=1, why="a test"))
    bench["end_to_end"].append(dict(name="frames_per_s", unit="frames/s",
                                    better="higher", bound=0.05,
                                    source="host_clock",
                                    workloads=["tetra.tiny"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = tmp_path / "rtbench"
    traffic = json.loads((r / "traffic" / "shadow1080.json").read_text())
    traffic.update(name="tiny", width=16, height=16, spp=1, depth=1,
                   check={"frames": 1, "pixels": 256})
    (r / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    shutil.copy(r / "checks" / "tetra.shadow1080.json",
                r / "checks" / "tetra.tiny.json")
    (r / "metrics" / "frames_per_s.py").write_text(
        "def read(ctx):\n"
        "    w = ctx['window']\n"
        "    return len(w.waits) / w.seconds\n")
    code = (
        "import json, torch\nfrom pathlib import Path\n"
        "from rtbench import harness\n"
        "out = harness.run(Path('.'), 'tetra.tiny', 7, 0.2, False, "
        "torch.device('cpu'), config_params={'levels': 4})\n"
        "print(json.dumps(out))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["metrics"]["frames_per_s"]["value"] > 0
    assert out["metrics"]["frames_per_s"]["unit"] == "frames/s"
    assert out["correct"] is True


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(traced):
    out = tiny("tetra.shadow1080", traced=traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if traced else []
    # the compared numbers, each beside its limit, come last
    assert list(out) == keys + ["checks"]
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(out["metrics"]) == {"scene_build_s"}  # no device trace
    else:
        assert {"mrays_s", "frame_ms_p90", "setup_s"} <= set(out["metrics"])
    assert out["correct"] is True
    json.dumps(out)
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}


def test_names_and_units():
    named = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    names = [x["name"] for x in named]
    assert len(set(x["name"] for x in BENCH["end_to_end"]
                   + BENCH["per_layer"])) == len(BENCH["end_to_end"]) + len(
                       BENCH["per_layer"])
    for n in names + [w["config"] for w in BENCH["workloads"]] + [
            w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for p in (ROOT / "rtbench").rglob("*"):
        if "__pycache__" not in p.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$",
                            str(p.relative_to(ROOT))), p


def test_no_card_no_fallback():
    """Without a CUDA device the command fails and prints no result."""
    code = ("import torch, sys, runpy\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['rtbench.run', '--workload', 'tetra.pt1080', "
            "'--seed', '1', '--seconds', '1', '--trace', '0']\n"
            "runpy.run_module('rtbench.run', run_name='__main__')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "no CUDA device" in p.stderr


def test_trace_reading():
    us = 1e6
    ev = [
        dict(ph="X", cat="user_annotation", name="rtbench.frame", ts=0,
             dur=10),
        dict(ph="X", cat="user_annotation", name="rtbench.image", ts=10,
             dur=5),
        dict(ph="X", cat="kernel", ts=1, dur=3,
             name="void traverse_packet_kernel<8, false>(float const*)"),
        dict(ph="X", cat="kernel", ts=2, dur=4,
             name="void at::native::vectorized_elementwise_kernel<4>()"),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=11, dur=2),
        dict(ph="X", cat="gpu_user_annotation", name="rtbench.frame", ts=0,
             dur=15),
    ]
    t = tr.Trace.from_events(ev)
    lo, hi = t.window()
    assert (lo, hi) == pytest.approx((0, 15 / us))
    assert t.frames()[0] == pytest.approx((0, 15 / us))
    assert tr.busy_s(t, lo, hi) == pytest.approx(7 / us)
    gaps = tr.gaps_by_phase(t, lo, hi)
    assert gaps["rtbench.frame"] == pytest.approx(6 / us)
    assert gaps["rtbench.image"] == pytest.approx(2 / us)
    assert [tr.kernel_of(o.name) for o in t.ops] == [
        "traverse_packet_kernel", None, None]
    assert tr.kernel_of("void at::native::reduce_kernel<512, 1>()") is None
    assert tr.kernel_of("refit_tile_kernel(int*, float*)") == \
        "refit_tile_kernel"


def test_forbidden_modules_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vortex_rt_tpu_torch_x", sys)
    assert "vortex_rt_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vortex_rt_tpu.sub", sys)
    assert harness.forbidden_modules() == ["vortex_rt_tpu"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = tiny(workload)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference in bfloat16 in the program's place."""
    out = tiny(workload, stand_in=harness.control)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault):
    out = tiny(workload, hooks=lambda prog: faults.hooks(fault, prog))
    assert out["correct"] is False, (fault, out["checks"])
