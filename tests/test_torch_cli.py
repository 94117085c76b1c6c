"""The port's command-line renderer (``vortex_rt_tpu_torch/cli.py``) on
the CPU (``--device cpu``: the kernels' plain versions), against the JAX
CLI where the JAX package renders the same frame.

* ``tests/test_runtime.py``'s ``test_cli_*`` cases on the port: ``--perf``
  with ``--trace-out``, ``--compare`` (PASS against the golden oracle) and
  ``--scope-out`` (spans per stage tiling one timeline, counter tracks
  per wave);
* a Whitted 16x16 frame (cornell, depth 2, shadow rays) through both
  CLIs: the images written, captured as floats, within 1e-5 (XLA:CPU
  contracts into FMA in process, ROADMAP hazard H2), the PPM bytes within
  one level, the same ray count printed;
* an OBJ written to ``tmp_path`` and rendered through ``-m``, equal to
  the same mesh rendered by ``WavefrontRenderer`` from memory;
* ``-c``: the port's golden oracle, equal to the JAX ``-c`` frame within
  1e-5 (both NumPy);
* ``--engine megakernel`` against the golden oracle;
* ``--bilinear`` on a textured quad: differs from point sampling in
  ``render``, not in ``--accum`` (the JAX package passes the filter to
  ``render`` alone), and ``--burst``'s image is ``render``'s;
* no card and no ``--device cpu``: an error, not a CPU frame;
* ``--ladder``: the CLI passes the ladder's refusal of a row it does not
  have (row 7; rows 1-6 are all ported) through as its exit code.
"""

import json

import numpy as np
import pytest
import torch

from vortex_rt_tpu import cli as jcli
from vortex_rt_tpu.utils import image as jimage

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch import cli
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.utils import image as timage


@pytest.fixture
def written(monkeypatch):
    """The float images the CLIs write, by output path."""
    out = {}
    for mod in (jimage, timage):
        orig = mod.write_ppm

        def rec(path, img, _orig=orig):
            out[str(path)] = np.asarray(img, np.float32).copy()
            _orig(path, img)

        monkeypatch.setattr(mod, "write_ppm", rec)
    return out


def _run(args, tmp_path, name, capsys, device=True):
    path = str(tmp_path / name)
    rc = cli.main(args + ["-o", path] + (["--device", "cpu"] if device
                                         else []))
    assert rc == 0
    return path, capsys.readouterr().out


def test_cli_perf_and_trace(tmp_path, capsys):
    tr = tmp_path / "t.json"
    path, text = _run(["-m", "sphere", "-w", "16", "-H", "16", "-d", "1",
                       "--engine", "wavefront", "--perf", "--trace-out",
                       str(tr)], tmp_path, "o.ppm", capsys)
    assert (tmp_path / "o.ppm").exists() and tr.exists()
    assert "PERF:" in text and "mrays_per_s=" in text
    trace = {ln.split("=", 1)[0][len("PERF.trace: "):]
             for ln in text.splitlines() if ln.startswith("PERF.trace: ")}
    assert trace == {"rays", "steps", "packet_size", "trace0"}
    assert "packet_size=32" in text
    assert json.loads(tr.read_text())["displayTimeUnit"] == "ms"


def test_cli_compare_flag(tmp_path, capsys):
    _, out = _run(["-m", "sphere", "-w", "16", "-H", "16", "-d", "1",
                   "--compare"], tmp_path, "o.ppm", capsys)
    assert "COMPARE: rmse=" in out and "PASS" in out


def test_cli_scope_trace(tmp_path, capsys):
    """One timeline with per-stage ms spans and per-wave counter tracks
    (``test_cli_scope_trace``'s checks)."""
    sc = tmp_path / "scope.json"
    _run(["-m", "sphere", "-w", "16", "-H", "16", "-d", "2", "--engine",
          "wavefront", "--scope-out", str(sc)], tmp_path, "o.ppm", capsys)
    assert sc.exists()
    evs = json.loads(sc.read_text())["traceEvents"]
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert "camera" in spans and "trace0" in spans and "trace1" in spans
    assert spans["trace0"]["args"].get("steps", 0) > 0
    counters = [e for e in evs if e["ph"] == "C"]
    names = {e["name"] for e in counters}
    assert {"loop_iterations", "live_packet_steps", "live_ray_steps",
            "node_kind_mix"} <= names
    mix = [e for e in counters if e["name"] == "node_kind_mix"]
    assert all({"internal", "triangle", "instance"} <= set(e["args"])
               for e in mix)
    xs = sorted((e["ts"], e["dur"]) for e in evs if e["ph"] == "X")
    for (t0, d0), (t1, _) in zip(xs, xs[1:]):
        assert abs((t0 + d0) - t1) < 1e-6


def _rays(text):
    line = next(ln for ln in text.splitlines() if ln.startswith("rendered"))
    return int(line.split(" rays,")[0].rsplit(" ", 1)[1])


def test_cli_whitted_matches_jax_cli(tmp_path, capsys, written):
    args = ["-m", "cornell", "-w", "16", "-H", "16", "-d", "2", "--shadow"]
    p_port, out = _run(args, tmp_path, "port.ppm", capsys)
    p_jax = str(tmp_path / "jax.ppm")
    assert jcli.main(args + ["-o", p_jax]) == 0
    out_jax = capsys.readouterr().out
    assert _rays(out) == _rays(out_jax)
    np.testing.assert_allclose(written[p_port], written[p_jax], atol=1e-5)
    a = timage.read_ppm(p_port).astype(np.int32)
    b = jimage.read_ppm(p_jax).astype(np.int32)
    assert np.abs(a - b).max() <= 1


def test_cli_golden_matches_jax_cli(tmp_path, capsys, written):
    args = ["-m", "cornell", "-w", "16", "-H", "16", "-d", "2", "--shadow",
            "-c"]
    p_port, out = _run(args, tmp_path, "port.ppm", capsys, device=False)
    p_jax = str(tmp_path / "jax.ppm")
    assert jcli.main(args + ["-o", p_jax]) == 0
    assert _rays(out) == _rays(capsys.readouterr().out)
    np.testing.assert_allclose(written[p_port], written[p_jax], atol=1e-5)
    assert "engine=cpu" in out


def _write_mesh_obj(path, mesh):
    """The mesh's triangles as an OBJ, every float by %.9g (reads back to
    the same float32), with vn and vt lines."""
    lines = []
    for k in range(mesh.num_tris):
        for v, n, uv in ((mesh.v0, mesh.n0, mesh.uv0),
                         (mesh.v1, mesh.n1, mesh.uv1),
                         (mesh.v2, mesh.n2, mesh.uv2)):
            lines.append("v %.9g %.9g %.9g" % tuple(v[k]))
            lines.append("vn %.9g %.9g %.9g" % tuple(n[k]))
            lines.append("vt %.9g %.9g" % tuple(uv[k]))
        lines.append("f -3/-3/-3 -2/-2/-2 -1/-1/-1")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_cli_written_obj(tmp_path, capsys, written):
    mesh = tproc.uv_sphere((0.1, -0.2, 0.3), 0.8, 6, 10)
    obj = tmp_path / "sphere.obj"
    _write_mesh_obj(obj, mesh)
    path, out = _run(["-m", str(obj), "-w", "16", "-H", "16", "-d", "2",
                      "--shadow"], tmp_path, "o.ppm", capsys)
    sc = pt.Scene()
    sc.add_instance(sc.add_mesh(mesh))
    sb = sc.build(pt.RTConfig(flatten=True))
    r = pt.WavefrontRenderer.from_buffers(sb, pt.RTConfig(flatten=True),
                                          device="cpu")
    cam = pt.Scene.framing_camera(sb, 45.0, 1.0)
    img, rays = r.render(cam, pt.RenderParams(max_depth=2, shadow=True),
                         16, 16)
    assert _rays(out) == rays
    np.testing.assert_allclose(written[path], np.clip(img, 0, 1), atol=1e-5)


def test_cli_megakernel(tmp_path, capsys):
    _, out = _run(["-m", "cornell", "-w", "16", "-H", "16", "-d", "2",
                   "--engine", "megakernel", "--compare"], tmp_path,
                  "m.ppm", capsys)
    assert "engine=megakernel" in out and "PASS" in out


def test_cli_bilinear(tmp_path, capsys, written):
    tex = tproc.checkerboard_texture(n=4, cell=3)  # coarse: filters differ
    rgb = np.stack([(tex >> s) & 255 for s in (16, 8, 0)], -1)
    timage.write_ppm(str(tmp_path / "chk.ppm"), rgb.astype(np.uint8))
    (tmp_path / "m.mtl").write_text("newmtl chk\nKd 1 1 1\n"
                                    "map_Kd chk.ppm\n")
    (tmp_path / "q.obj").write_text(
        "mtllib m.mtl\nv -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl chk\n"
        "f 1/1 2/2 3/3 4/4\n")
    base = ["-m", str(tmp_path / "q.obj"), "-w", "16", "-H", "16", "-d",
            "1"]
    img = {}
    for name, extra in (("pt", []), ("bi", ["--bilinear"]),
                        ("acc_pt", ["--accum", "1"]),
                        ("acc_bi", ["--accum", "1", "--bilinear"]),
                        ("burst_bi", ["--burst", "1", "--bilinear"])):
        path, _ = _run(base + extra, tmp_path, f"{name}.ppm", capsys)
        img[name] = written[path]
    assert float(np.abs(img["bi"] - img["pt"]).mean()) > 1e-3
    np.testing.assert_array_equal(img["acc_bi"], img["acc_pt"])
    np.testing.assert_array_equal(img["burst_bi"], img["bi"])


def test_cli_refuses_without_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["-m", "sphere", "-w", "8", "-H", "8", "-o",
                  str(tmp_path / "o.ppm")])
    assert e.value.code != 0
    assert not (tmp_path / "o.ppm").exists()


def test_cli_ladder_refuses_row_1(tmp_path):
    """The CLI passes the ladder's refusal of an unknown row (7) through
    its exit code.  The name is from when row 1 was the refused row; rows
    1-6 all run now, so a row the ladder lacks stands in for it."""
    assert cli.main(["--ladder", "7", "--device", "cpu"]) != 0
