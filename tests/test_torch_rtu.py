"""The port's RT-unit facade (``engine/rtu.py``) and device API
(``runtime/device.py``) against the JAX package's.

The scenes of ``tests/test_rtu.py``, built with the NumPy builder on both
sides (same tables), driven by the reference's persistent kernel loop
(getWork, then a handler per queue that reads attributes and commits) on
the JAX ``RTUnit`` and on the port's: the same ``get_work`` words in the
same order, round by round, and every ``get_attr`` value within 1e-6
(the walks' float32 hits agree to the bit between the port's plain
per-ray walk and the JAX one up to the last ulp of FMA contraction in
process, ROADMAP hazard H2).  Cases: the kernel loop over a triangle
soup with an any-hit handler that rejects odd triangle ids (CONT) and
accepts even ones, the CONT-rejects two-quad scene, the longest-queue
``get_work`` with lanes 4, and the capacity spill (48 misses through a
16-ray queue).  ``decode_work`` as the JAX test; ``Device`` on "cpu"
with ``test_runtime.py``'s ``test_device_*`` assertions, and
``dev_open()`` refusing without a card.
"""

import numpy as np
import pytest
import torch

from vortex_rt_tpu.engine import rtu as jrtu
from vortex_rt_tpu.models import procedural as jproc
from vortex_rt_tpu.models.scene import Scene as JScene
from vortex_rt_tpu.ops.traverse_wide import WideArrays as JWide
from vortex_rt_tpu.utils.config import RTConfig as JCfg

from vortex_rt_tpu_torch.engine import rtu as trtu
from vortex_rt_tpu_torch.golden.renderer import generate_rays
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.models.scene import Camera, Scene as TScene
from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays as TWide
from vortex_rt_tpu_torch.runtime.device import (
    VX_DCR_BASE_RTX_TLAS_PTR, DeviceError, dev_open,
)
from vortex_rt_tpu_torch.utils.config import RTConfig as TCfg

ATTRS = ("VX_RT_HIT_DIST", "VX_RT_HIT_BX", "VX_RT_HIT_BY", "VX_RT_HIT_BZ",
         "VX_RT_HIT_BLAS_IDX", "VX_RT_HIT_TRI_IDX", "VX_RT_RAY_PAYLOAD_ADDR",
         "VX_RT_RAY_RO_X", "VX_RT_RAY_RD_Z")


def test_decode_work():
    words = np.asarray([(1 << 28) | 5, (1 << 29) | 9, (1 << 31) | 1,
                        (1 << 30) | 0x0FFFFFFF], np.uint32)
    ty, ids = trtu.decode_work(words)
    assert ty.tolist() == [trtu.SHADER_MISS, trtu.SHADER_CLOSEST,
                           trtu.SHADER_ANY, trtu.SHADER_INTERSECTION]
    assert ids.tolist() == [5, 9, 1, 0x0FFFFFFF]
    jt, ji = jrtu.decode_work(words)
    np.testing.assert_array_equal(ty, jt)
    np.testing.assert_array_equal(ids, ji)
    assert ty.dtype == jt.dtype and ids.dtype == ji.dtype


def _units(fill, **kw):
    """The JAX and the port's RTUnit over the same scene."""
    out = []
    for scene, proc, wide, cfg, mod in (
            (JScene, jproc, JWide, JCfg, jrtu),
            (TScene, tproc, TWide, TCfg, trtu)):
        sc = scene()
        fill(sc, proc)
        sb = sc.build(cfg(use_native_build=False))
        out.append(mod.RTUnit(wide.from_scene(sb), **kw))
    return out


def _drive(unit, mod, o, d, payload=None, any_policy="parity",
           max_rounds=512):
    """The reference's persistent kernel loop; returns its log: each
    round's words and, per handler, the attributes it read."""
    ids = unit.trace_ray(o, d, payload_addr=payload)
    log = [("ids", ids.tolist())]
    for _ in range(max_rounds):
        work = unit.get_work()
        if work.size == 0:
            break
        assert all(len(q) <= unit.queue_capacity for q in unit._queues)
        ty, _ = mod.decode_work(work)
        t = int(ty[0])
        assert (ty == t).all()  # one queue per getWork
        vals = {a: np.asarray(unit.get_attr(work, getattr(mod, a)))
                for a in ATTRS}
        log.append(("work", work.tolist(), vals))
        if t == mod.SHADER_ANY:
            if any_policy == "parity":
                cont = vals["VX_RT_HIT_TRI_IDX"] % 2 == 1
            else:  # reject the first instance's candidates
                cont = vals["VX_RT_HIT_BLAS_IDX"] == 0
            unit.commit(work[cont], mod.VX_RT_COMMIT_CONT)
            unit.commit(work[~cont], mod.VX_RT_COMMIT_ACCEPT)
        else:
            unit.commit(work, mod.VX_RT_COMMIT_TERM)
    else:
        raise AssertionError("the kernel loop did not drain")
    log.append(("active", unit.active_rays()))
    return log


def _same_log(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        if g[0] == "work":
            for a in ATTRS:
                assert g[2][a].shape == w[2][a].shape, a
                np.testing.assert_allclose(g[2][a], w[2][a], rtol=1e-6,
                                           atol=1e-6, err_msg=a)


def _soup(sc, proc):
    sc.add_mesh(proc.random_soup(np.random.default_rng(3), 150))


def _quads(sc, proc):
    near = sc.add_mesh(proc.quad((-2, -2, 1), (2, -2, 1), (2, 2, 1),
                                 (-2, 2, 1)))
    far = sc.add_mesh(proc.quad((-2, -2, 3), (2, -2, 3), (2, 2, 3),
                                (-2, 2, 3)))
    sc.add_instance(near)
    sc.add_instance(far)


def _quad(sc, proc):
    sc.add_mesh(proc.quad((-1, -1, 2), (1, -1, 2), (1, 1, 2), (-1, 1, 2)))


def _sphere(sc, proc):
    sc.add_mesh(proc.uv_sphere((0, 0, 0), 1.0, 8, 12))


def test_rtu_kernel_loop_matches_jax():
    cam = Camera.look_at([0.2, -0.1, -25], [0, 0, 0], [0, 1, 0], 30.0, 1.0)
    o, d = generate_rays(cam, 4, 4)
    ju, tu = _units(_soup, anyhit=True)
    want = _drive(ju, jrtu, o, d, payload=np.arange(16))
    got = _drive(tu, trtu, o, d, payload=np.arange(16))
    _same_log(got, want)
    assert got[-1] == ("active", 0)
    assert sum(e[0] == "work" and (np.asarray(e[1]) >> 31).any()
               for e in got) > 0  # the any-hit queue was served


def test_rtu_anyhit_cont_rejects_matches_jax():
    o = np.array([[0.0, 0.1, -1.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    ju, tu = _units(_quads, anyhit=True)
    want = _drive(ju, jrtu, o, d, any_policy="blas")
    got = _drive(tu, trtu, o, d, any_policy="blas")
    _same_log(got, want)
    final = got[-2][2]  # the CLOSEST round
    assert int(final["VX_RT_HIT_BLAS_IDX"][0]) == 1
    assert abs(float(final["VX_RT_HIT_DIST"][0]) - 4.0) < 1e-4


def test_rtu_getwork_longest_queue_matches_jax():
    o = np.zeros((8, 3), np.float32)
    o[:, 2] = -1
    d = np.zeros((8, 3), np.float32)
    d[:3, 2] = 1.0   # toward the quad
    d[3:, 2] = -1.0  # away
    ju, tu = _units(_quad, anyhit=False, lanes=4)
    words = []
    for unit, mod in ((ju, jrtu), (tu, trtu)):
        unit.trace_ray(o, d)
        words.append([unit.get_work().tolist() for _ in range(4)])
        ty, ids = mod.decode_work(np.asarray(words[-1][0], np.uint32))
        assert (ty == mod.SHADER_MISS).all() and len(ids) == 4
    assert words[1] == words[0]


def test_rtu_queue_capacity_spill_matches_jax():
    n = 48  # all miss -> all land in the MISS queue, 3x the capacity
    o = np.tile(np.array([[0, 0, -5]], np.float32), (n, 1))
    d = np.tile(np.array([[0, 1, 0]], np.float32), (n, 1))
    ju, tu = _units(_sphere, anyhit=False, lanes=8, queue_capacity=16)
    seqs = []
    for unit in (ju, tu):
        ids = unit.trace_ray(o, d)
        seq = []
        while True:
            work = unit.get_work()
            if work.size == 0:
                break
            assert all(len(q) <= unit.queue_capacity for q in unit._queues)
            seq.append(work.tolist())
        assert {int(w) & 0x0FFFFFFF for s in seq for w in s} == \
            {int(i) for i in ids}
        seqs.append(seq)
    assert seqs[1] == seqs[0]


def test_rtu_state_is_tensors():
    """The port keeps ray state in tensors indexed by ray id: a batch of
    rays is walked as one batch, whatever its size."""
    _, tu = _units(_sphere, anyhit=False)
    o = np.tile(np.array([[0, 0, -5]], np.float32), (300, 1))
    d = np.tile(np.array([[0, 0, 1]], np.float32), (300, 1))
    tu.trace_ray(o, d)
    work = tu.get_work()
    assert len(work) == 300 and isinstance(tu._dist, torch.Tensor)
    assert tu._state.best_t.shape == (300,)
    tu.commit(work, trtu.VX_RT_COMMIT_TERM)
    assert tu.active_rays() == 0
    with pytest.raises(KeyError):
        tu.get_attr(work[:1], trtu.VX_RT_HIT_DIST)


def test_device_open_and_buffers(rng):
    dev = dev_open("cpu")
    assert dev.platform == "cpu"
    x = rng.standard_normal((64, 3)).astype(np.float32)
    dev.copy_to_dev("tri", x)
    np.testing.assert_array_equal(dev.copy_from_dev(dev.buffer("tri")), x)
    assert dev.mem_info()["tri"] == x.nbytes
    with pytest.raises(DeviceError):
        dev.buffer("nope")


def test_device_dcr_and_kernel_lifecycle(rng):
    dev = dev_open("cpu")
    dev.dcr_write(VX_DCR_BASE_RTX_TLAS_PTR, "tlas")
    assert dev.dcr_read(VX_DCR_BASE_RTX_TLAS_PTR) == "tlas"
    with pytest.raises(DeviceError):
        dev.dcr_read(0x999)

    dev.upload_kernel("double", lambda x: x * 2.0)
    x = dev.copy_to_dev("x", rng.standard_normal(16).astype(np.float32))
    with pytest.raises(DeviceError):
        dev.ready_wait()  # nothing running
    dev.start("double", x)
    with pytest.raises(DeviceError):
        dev.start("double", x)  # busy
    out = dev.ready_wait()
    np.testing.assert_allclose(out.numpy(), x.numpy() * 2.0)
    perf = dev.dump_perf()
    assert perf["kernels_launched"] == 1
    assert perf["uploads"] == 1
    with pytest.raises(DeviceError):
        dev.start("missing", x)
    from vortex_rt_tpu.runtime.device import dev_open as jdev_open

    assert set(perf) == set(jdev_open("cpu").dump_perf())


def test_device_open_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in (None, "cuda"):
        with pytest.raises(DeviceError):
            dev_open(backend)
    with pytest.raises(DeviceError):
        dev_open("tpu")


def test_rtu_reuses_terminated_rows():
    """TERM frees a ray's rows and ``trace_ray`` reuses them: over 50
    batches of 2,000 rays, each batch's rays terminated one batch later
    (so 2,000-4,000 live), the rows never exceed twice the peak of live
    rays plus one batch, and the ids still run from 1 with no gap."""
    _, tu = _units(_quad, anyhit=False, lanes=4096)
    n, batches = 2000, 50
    rng = np.random.default_rng(7)
    ids_all, prev, peak = [], None, 0
    for _ in range(batches):
        o = np.zeros((n, 3), np.float32)
        o[:, :2] = rng.uniform(-2, 2, (n, 2))
        o[:, 2] = -1
        d = np.tile(np.array([[0, 0, 1]], np.float32), (n, 1))
        ids = tu.trace_ray(o, d)
        ids_all.append(ids)
        while tu.get_work().size:
            pass
        peak = max(peak, tu.active_rays())
        assert tu.capacity <= 2 * peak + n
        if prev is not None:
            tu.commit(prev, trtu.VX_RT_COMMIT_TERM)
        prev = ids
    tu.commit(prev, trtu.VX_RT_COMMIT_TERM)
    assert tu.active_rays() == 0 and peak == 2 * n
    assert tu.capacity <= 2 * peak + n
    ids_all = np.concatenate(ids_all)
    assert ids_all.dtype == np.uint32
    np.testing.assert_array_equal(ids_all, np.arange(1, batches * n + 1))
    # a reused row reads as the new ray's, a freed id raises
    o = np.array([[0.5, 0.5, -1.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    rid = tu.trace_ray(o, d)
    assert int(rid[0]) == batches * n + 1
    work = tu.get_work()
    assert abs(float(tu.get_attr(work, trtu.VX_RT_HIT_DIST)[0]) - 3.0) < 1e-5
    assert float(tu.get_attr(work, trtu.VX_RT_RAY_RO_X)[0]) == 0.5
    with pytest.raises(KeyError):
        tu.get_attr(ids_all[:1], trtu.VX_RT_HIT_DIST)
