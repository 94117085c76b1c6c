"""The port's ladder tool (``tools/bench_ladder.py``) on the CPU at a small
size: row 5's recipe on ``wavy_grid(n=24)`` at 32x32 (and rows 3 and 6
through the tool's command line).  The t = 0 frame and
one moved frame, rendered from the port's on-device build + per-frame
refit, against the frames the JAX package renders from its own
``build_lbvh_topo`` / ``refit_lbvh`` tree of the same vertices: equal ray
counts, images within 1e-5 (the JAX frame runs in-process with FMA
contraction: ROADMAP hazard H2).  The moved vertices are computed once, by
the port, so both trees bound the same floats (torch's and XLA's sin and
cos differ in the last bits: H5).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vortex_rt_tpu.accel import lbvh as jl
from vortex_rt_tpu.engine import wavefront as jwf
from vortex_rt_tpu.models import bigscenes as jbig
from vortex_rt_tpu.models.scene import RenderParams as JParams, Scene as JScene
from vortex_rt_tpu.utils.config import RTConfig as JCfg

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch.runtime import kernels
from vortex_rt_tpu_torch.tools import bench_ladder as bl

GRID, W, H = 24, 32, 32


@pytest.fixture(scope="module")
def row5():
    cfg = pt.RTConfig(flatten=True, use_native_build=False)
    return bl.setup_config5("cpu", GRID, cfg)


@pytest.fixture(scope="module")
def jax_row5():
    """(JAX renderer, its topology and compact plan, camera)."""
    jcfg = JCfg(flatten=True, use_native_build=False)
    sc = JScene()
    sc.add_instance(sc.add_mesh(jbig.wavy_grid(n=GRID)))
    jsb = sc.build(jcfg)
    jr = jwf.WavefrontRenderer.from_buffers(jsb, jcfg)
    v = jl.pad_tris(jsb.v0, jsb.v1, jsb.v2, 4)
    with jax.disable_jit():
        _, topo = jl.build_lbvh_topo(*(jnp.asarray(x) for x in v),
                                     leaf_size=4, width=8)
    return jr, topo, jl.compact_plan(topo), JScene.framing_camera(
        jsb, 45.0, W / H)


def test_setup_builds_the_topology_on_the_device(row5):
    assert row5.sb.num_tris == 2 * (GRID - 1) ** 2
    assert row5.cfg.bvh_width == 8 and row5.topo.ch_old.shape[1] == 8
    assert row5.pool_rows % 256 == 0 and row5.leaf_rows % 256 == 0
    assert row5.build_ms > 0.0
    # t = 0 gives the rest mesh back to the bit
    for a, b in zip(row5.moved(0.0), row5.verts):
        assert (a == b).all()
    assert not (row5.moved(0.3)[0] == row5.verts[0]).all()


@pytest.mark.parametrize("t", [0.0, 0.3])
def test_refit_frame_matches_jax(row5, jax_row5, t):
    jr, jtopo, (jpool, jrows, jsurv), jcam = jax_row5
    assert (jpool, jrows) == (row5.pool_rows, row5.leaf_rows)
    moved = row5.moved(t)
    launches = dict(kernels.LAUNCHES)
    r = row5.r
    r.wa = row5.refit_frame(t)
    assert kernels.LAUNCHES == launches  # the CPU route launches nothing
    cam, p = bl.camera5(row5.sb, W, H), bl.params5()
    timg, trays = r.render(cam, p, W, H)

    with jax.disable_jit():
        lb = jl.refit_lbvh(jtopo, *(jnp.asarray(v.numpy()) for v in moved),
                           leaf_size=4, width=8, pool_rows=jpool,
                           leaf_rows=jrows, surv_idx=jsurv)
    jr.wa = jl.wide_arrays_from_lbvh(lb, 4, width=8).fuse()
    np.testing.assert_array_equal(np.asarray(jr.wa.fused).view(np.int32),
                                  r.wa.fused.numpy())
    jimg, jrays = jr.render(jcam, JParams(max_depth=2, spp=2, shadow=True,
                                          light_pos=bl.LIGHT5), W, H)
    assert trays == jrays and trays > W * H * 2
    np.testing.assert_allclose(timg, np.asarray(jimg), atol=1e-5)


def test_cli_row5_small(capsys):
    recs = bl.main(["--configs", "5", "--device", "cpu", "--grid", "12",
                    "--res", "16x16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["config"] == 5 and line["tris"] == 242
    assert line["parity_ok"] and line["parity_max_abs"] == 0.0
    assert line["rays_t0"] == line["rays_host_tree"]
    assert line["frame_plus_refit_ms"] == pytest.approx(
        line["ms_per_frame"] + line["refit_ms"])
    assert recs[0]["refit_ms"] > 0.0


def _one_timed_frame(monkeypatch):
    """Row 3's timing turns with one timed frame a turn (on the CPU they
    time nothing that a test reads; the frames they render are the
    tool's)."""
    monkeypatch.setattr(bl, "bench_frames", functools.partial(
        bl.bench_frames, n_timed=1))


def test_row3_hits_equal_host_tree(monkeypatch):
    _one_timed_frame(monkeypatch)
    rec = bl.config3("cpu", method="karras", blob_n=10, res=(16, 16))
    assert rec["parity_ok"] and rec["hits"]["hits"] > 0
    assert rec["rays_device_tree"] == rec["rays_host_tree"]
    assert rec["image_max_abs_vs_host_tree"] == 0.0


def test_row3_ploc_hits_equal_host_tree(capsys, monkeypatch):
    """Row 3 as the ladder defines it: the tree built by PLOC (the
    default), at blob(n=10), 16x16."""
    _one_timed_frame(monkeypatch)
    recs = bl.main(["--configs", "3", "--device", "cpu", "--blob", "10",
                    "--res", "16x16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == recs[0] and line["lbvh"] == "ploc"
    assert line["ploc_radius"] == 16 and line["ploc_rounds"] > 0
    assert 2 <= line["tree_depth"] <= line["walk_depth"] == 22
    assert line["leaf_rows"] > 0 and line["lbvh_build_ms"] > 0.0
    h = line["hits"]
    assert line["parity_ok"] and h["hits"] > 0
    assert h["same_mask"] and h["same_tri"] and h["same_dist"]
    assert h["max_steps_device_tree"] >= h["mean_steps_device_tree"] > 0
    assert line["rays_device_tree"] == line["rays_host_tree"]
    assert line["image_max_abs_vs_host_tree"] == 0.0


def test_row6_small_on_cpu(capsys):
    """Row 6 as the tool runs it, small: a textured atrium of about 4,000
    triangles through the alpha test in the walk (fused rows of 512 B),
    and its parity frame against the suspension engine on the TLAS
    build: the same image (RMSE 0: the same hits) and ray count."""
    recs = bl.main(["--configs", "6", "--device", "cpu", "--atrium", "3000",
                    "--atrium-cols", "2", "--res", "32x18", "--res6",
                    "16x16", "--parity-res", "16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == recs[0] and line["config"] == 6 and line["anyhit"]
    assert line["parity_ok"] and line["parity_rmse"] == 0.0
    assert line["rays_parity"] == line["rays_suspension"] > 16 * 16 * 2
    assert line["fused_bytes"] % 512 == 0 and line["alpha"] == 0.30
    assert line["rays_per_frame_hd"] > line["rays_per_frame"] > 0


@pytest.mark.parametrize("argv,exc", [
    (["--configs", "3", "--lbvh", "sah", "--device", "cpu"], ValueError),
    (["--configs", "4", "--device", "cpu"], NotImplementedError),
    (["--configs", "3", "--lbvh", "median", "--device", "cpu"], ValueError),
])
def test_unported_rows_are_refused(argv, exc):
    with pytest.raises(exc):
        bl.main(argv)
