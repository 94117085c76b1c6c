"""Slot classes of the predicate modes (``ops/pred_classes.py``) on the
CPU.

* (i) Every interval rule against the kernel's value of its node: for
  each op case of ``tests/torch_pred_cases.py`` (one a form of the
  compiler's op set), seeded intervals of u, v and alpha (narrow and
  wide, on cell borders of floor and ``%``, negative and wrapped values,
  values past int32 and 1e20, single values and both zeros, intervals
  reaching infinity, so NaN-prone ones) and seeded points inside them
  (the ends among them): every node's value at the points (the traced
  graph run by torch on the CPU, each correctly rounded op as its
  float64 value rounded once: the kernel's and ``CompiledPredicate.
  plain``'s definition, ROADMAP H22, H23) lies in the node's interval, or
  the interval is tainted; a NaN only where it is tainted.
* (ii) A small textured ``with_alpha`` table (texels on both sides of
  the checker's 0.05 and the perforated predicate's ``alpha ** 2.2 >
  0.002``, an untextured dark material, uv spans across cells, negative
  and wrapped uv), flat 8-wide (K1) and 4-wide TLAS (K2): with the
  checker, the perforated predicate, a predicate that never reads alpha
  and one with an op without a rule (integer ``&``), at seeded
  barycentrics of every real slot, ``pred_keep``'s surface and the plain
  predicate give each kept slot True and each cut slot False, and each
  class-3 slot the same answer with its own texel, the representative
  alpha and any alpha of its range.  A class build that cannot hold the
  rows raises.
* (iii) The plain K1 and K2 predicate walks on that table against the JAX
  ``trace_packets(anyhit_pred=...)``, every hit field to the bit (the JAX
  side in a subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``, started
  with the module's first test, as ``test_torch_anyhit_pred.py`` runs
  it), and ``walk_work``'s class counts (the kernel's tests) against the
  candidates.

About 20 s of CPU time in one process, most of it the JAX subprocess.
"""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import vortex_rt_tpu_torch as pt
from vortex_rt_tpu_torch import bridge
from vortex_rt_tpu_torch.models import procedural as tproc
from vortex_rt_tpu_torch.models.scene import Material as TMat
from vortex_rt_tpu_torch.ops import anyhit_pred as ap
from vortex_rt_tpu_torch.ops import packet_walk as pw
from vortex_rt_tpu_torch.ops import pred_classes as pc
from vortex_rt_tpu_torch.ops import traverse_packet as tp
from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays
from vortex_rt_tpu_torch.tools.bench_ladder import (
    checker_pred, perforated_pred,
)

from tests.torch_pred_cases import OPS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ (i)

def _boxes(rng, s: int = 96):
    """Seeded float32 intervals [lo, hi] (s,) of the kinds the module
    docstring lists."""
    k = rng.integers(-12, 19, s)
    kinds = [
        *((c, c + w) for c, w in zip(rng.uniform(-1.5, 2.5, 30),
                                     10.0 ** rng.uniform(-7, -1, 30))),
        *((float(np.float32(kk / d)) - w, float(np.float32(kk / d)) + w)
          for kk, d, w in zip(k[:16], rng.choice([6, 4, 8, 12], 16),
                              rng.choice([0.0, 1e-6, 1e-3, 0.05], 16))),
        *((c, c + w) for c, w in zip(rng.uniform(-3, 3, 12),
                                     rng.uniform(0.5, 4.0, 12))),
        *((c, c + w) for c, w in zip(rng.uniform(-50, -1, 8),
                                     rng.uniform(0, 0.3, 8))),
        *((c, c * (1 + 1e-6)) for c in (1e5, 3.3e5, 3.5e9, 2e10)),
        *((-c * (1 + 1e-6), -c) for c in (1.5e5, 7e9, 1e20)),
        (88.5, 89.0), (-104.0, -87.5),
        (0.5, math.inf), (-math.inf, -0.25), (-math.inf, math.inf),
        (math.inf, math.inf), (0.0, 0.0), (-0.0, -0.0), (-1e-40, 1e-40),
        (0.0, 1e-3), (-2.0, 0.0), (1.0, 1.0),
        (0.05, 0.05), (0.0595, 0.0598), (0.287, 0.755), (-1.0, 1.0),
    ]
    lo = np.array([a for a, _ in kinds[:s]], np.float32)
    hi = np.array([b for _, b in kinds[:s]], np.float32)
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    order = rng.permutation(len(lo))
    return lo[order], hi[order]


def _points(rng, lo, hi, p: int = 12):
    """(s, p) float32 points inside each [lo, hi]: both ends, random ones
    between (finite stand-ins beyond an infinite end)."""
    lo64, hi64 = lo.astype(np.float64), hi.astype(np.float64)
    flo = np.where(np.isinf(lo64), np.minimum(hi64, 0) - 1e6, lo64)
    fhi = np.where(np.isinf(hi64), np.maximum(lo64, 0) + 1e6, hi64)
    flo = np.where(np.isinf(flo), -1e30, flo)
    fhi = np.where(np.isinf(fhi), 1e30, fhi)
    r = rng.uniform(0, 1, (lo.shape[0], p - 2))
    mid = np.clip((flo[:, None] + (fhi - flo)[:, None] * r).astype(
        np.float32), lo[:, None], hi[:, None])
    return np.concatenate([lo[:, None], hi[:, None], mid], 1)


def _iv(lo, hi) -> pc.Iv:
    s = lo.shape[0]
    no = torch.zeros(s, dtype=torch.bool)
    return pc.Iv(torch.from_numpy(lo).double(), torch.from_numpy(hi).double(),
                 no, no.clone())


class _KernelValues(torch.fx.Interpreter):
    """Each node's value as the kernel computes it: torch's CPU result,
    each correctly rounded op (``rounded``: node names) in float64 on its
    float32 operands, rounded once."""

    def __init__(self, gm, rounded):
        super().__init__(gm)
        self.rounded = rounded
        self.values = {}

    def run_node(self, n):
        kind = self.rounded.get(n.name)
        if kind is None:
            out = super().run_node(n)
        else:
            args = [self.env[a] if isinstance(a, torch.fx.Node) else a
                    for a in n.args]
            x = [a.to(torch.float32).double() if torch.is_tensor(a)
                 else torch.tensor(float(np.float32(a)), dtype=torch.float64)
                 for a in args]
            if kind == "rsqrt":
                y = 1.0 / torch.sqrt(x[0])
            elif kind == "sigmoid":
                y = 1.0 / (1.0 + torch.exp(-x[0]))
            else:
                y = getattr(torch, ap._CORRECTLY_ROUNDED[kind][0])(*x)
            out = y.to(torch.float32)
        self.values[n.name] = out
        return out


@pytest.mark.parametrize("op", sorted(OPS))
def test_interval_rules_hold(op):
    """Every node's kernel value at seeded points of seeded intervals lies
    in its interval (or the interval is tainted; NaN only there)."""
    comp = ap.compile_predicate(OPS[op])
    rng = np.random.default_rng(sum(map(ord, op)))
    boxes = [_boxes(rng) for _ in range(3)]
    pts = [torch.from_numpy(_points(rng, lo, hi)) for lo, hi in boxes]
    s, p = pts[0].shape
    env = {}
    pc.evaluate(comp, *(_iv(lo, hi) for lo, hi in boxes), nodes=env)
    gm, _ = ap._trace(comp.fn)
    rounded = {st.name: st.kind for st in comp.steps
               if st.kind in ap._CORRECTLY_ROUNDED and st.out == torch.float32}
    with np.errstate(all="ignore"):
        run = _KernelValues(gm, rounded)
        run.run(*(x.reshape(-1) for x in pts))
    checked = 0
    for st in comp.steps:
        iv, dt = env[st.name]
        val = run.values[st.name]
        val = val.expand(s * p) if val.dim() == 0 else val
        val = val.reshape(s, p)
        tainted = iv.taint.unsqueeze(1).expand(s, p)
        if dt == torch.float32:
            v = val.double()
            nan = torch.isnan(v)
            assert not (nan & ~tainted).any(), (op, st, "NaN untainted")
            ok = (v >= iv.lo.unsqueeze(1)) & (v <= iv.hi.unsqueeze(1))
        else:
            v = val.to(torch.int64)
            ok = (v >= iv.lo.unsqueeze(1)) & (v <= iv.hi.unsqueeze(1))
        bad = ~ok & ~tainted
        if dt == torch.float32:
            bad &= ~torch.isnan(val.double())
        assert not bad.any(), (
            op, st, [(float(iv.lo[i]), float(iv.hi[i]), val[i].tolist())
                     for i in bad.any(1).nonzero().flatten()[:3].tolist()])
        checked += int((~tainted).sum())
    assert checked > 0


def test_rules_tight_enough():
    """The checker decides a slot inside one cell and the perforated
    predicate's alpha term holds over row 6's two texel values; a
    bitwise ``&`` on integers has no rule (tainted, counted)."""
    def one(lo, hi):
        return _iv(np.float32([lo]), np.float32([hi]))

    c = ap.compile_predicate(checker_pred)
    out, _ = pc.evaluate(c, one(0.20, 0.30), one(0.55, 0.60),
                         one(0.287, 0.755))
    assert int(out.lo[0]) == 1 and not bool(out.taint[0])  # cells 1 + 3
    out, _ = pc.evaluate(c, one(0.20, 0.30), one(0.40, 0.45),
                         one(0.287, 0.755))
    assert int(out.hi[0]) == 0 and not bool(out.taint[0])  # cells 1 + 2
    p = ap.compile_predicate(perforated_pred)
    env = {}
    pc.evaluate(p, one(0.51, 0.52), one(0.33, 0.34), one(0.287, 0.755),
                nodes=env)
    assert int(env["gt_1"][0].lo[0]) == 1  # alpha ** 2.2 > 0.002 always
    n = ap.compile_predicate(
        lambda u, v, a: ((torch.floor(u * 4).int() & 1) == 0) | (a > 0.4))
    out, missing = pc.evaluate(n, one(0.1, 0.2), one(0.0, 0.1),
                               one(0.5, 0.6))
    assert missing == ("and",) and bool(out.taint[0])


# ----------------------------------------------------------------- (ii)

LUMS = (0x050505, 0x0E0E0E, 0x4C4C4C, 0xE6E6E6)  # 0.020, 0.055, 0.297, 0.898


def _texture():
    """8x8 texels in 2x2 cells of the four greys of ``LUMS``."""
    yy, xx = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    return np.asarray(LUMS, np.uint32)[((xx // 2) + (yy // 2) * 3) % 4]


def _uv(mesh, scale, shift):
    return dataclasses.replace(
        mesh, uv0=mesh.uv0 * scale + shift, uv1=mesh.uv1 * scale + shift,
        uv2=mesh.uv2 * scale + shift)


def table_scene(scene_cls, proc, mat_cls):
    """The table's scene, with either package."""
    tex = _texture()
    mat = mat_cls(diffuse=(1, 1, 1), diffuse_tex=tex)
    sc = scene_cls()
    for mesh in (
            proc.quad((-1.5, -1.5, 0), (1.5, -1.5, 0), (1.5, 1.5, 0),
                      (-1.5, 1.5, 0), mat),
            _uv(proc.quad((-2, -2, 1.0), (2, -2, 1.0), (2, 2, 1.0),
                          (-2, 2, 1.0), mat), 3.0, -1.25),
            proc.quad((-0.5, -0.5, 1.7), (0.5, -0.5, 1.7), (0.5, 0.5, 1.7),
                      (-0.5, 0.5, 1.7), mat_cls(diffuse=(0.05, 0.05, 0.05))),
            proc.uv_sphere((0, 0, 2.6), 0.8, 10, 14, mat),
            _uv(proc.uv_sphere((0.9, 0.6, 2.0), 0.4, 8, 12, mat), -2.0, 0.3),
            proc.box((1.2, 1.0, 2.4), 0.5, mat)):
        sc.add_instance(sc.add_mesh(mesh))
    return sc


@pytest.fixture(scope="module")
def tables():
    """{"flat8": fused 8-wide K1 table, "tlas4": 4-wide TLAS K2 table},
    both ``with_alpha``."""
    sc = table_scene(pt.Scene, tproc, TMat)
    out = {}
    for name, flat, width in (("flat8", True, 8), ("tlas4", False, 4)):
        sb = sc.build(pt.RTConfig(flatten=flat, use_native_build=False))
        wa = WideArrays.from_scene(sb, width=width)
        out[name] = (wa.fuse() if width == 8 else wa).with_alpha(sb)
    return out


def _noalpha(u, v, alpha):
    """Never reads alpha: every undecided slot is class 3."""
    return (torch.floor(u * 5.0) + torch.floor(v * 3.0)) % 3.0 != 1.0


def _norule(u, v, alpha):
    """An integer ``&`` (no interval rule) beside an alpha test."""
    return ((torch.floor(u * 4.0).to(torch.int32) & 1) == 0) & (alpha > 0.1)


PREDS = {"checker": checker_pred, "perforated": perforated_pred,
         "noalpha": _noalpha, "norule": _norule}


@pytest.mark.parametrize("build", ["flat8", "tlas4"])
@pytest.mark.parametrize("name", sorted(PREDS))
def test_classes_give_the_test_answer(tables, build, name):
    """At seeded barycentrics of every slot the plain predicate on
    the walk's surface gives each kept slot True, each cut slot False,
    and each class-3 slot the same answer with its own texel, the
    representative alpha and any alpha of its range."""
    wa = tables[build]
    comp = ap.compile_predicate(PREDS[name])
    mod = tp if build == "flat8" else pw
    got = mod.pred_classes(wa, comp)
    k = wa.tri_rows.shape[1] // 16
    if build == "flat8":
        a_off = tp.alpha_offset(wa)
        fields = wa.fused[:, a_off:a_off + 8 * k].contiguous().view(
            torch.float32).reshape(-1, 8)
    else:
        fields = wa.alpha_rows.reshape(-1, 8)
    shift = 2 * torch.arange(k, dtype=torch.int64)
    cls = ((got.cls.long().unsqueeze(1) & 0xFFFFFFFF) >> shift) & 3
    cls = cls.reshape(-1)
    _, _, a_iv = pc.slot_inputs(fields, wa.alpha_pool)
    assert got.counts["kept"] + got.counts["cut"] + got.counts["uv"] \
        + got.counts["test"] > 0
    rng = np.random.default_rng(len(name) * 7 + k)
    f = [fields[:, j] for j in range(6)] + [
        fields.view(torch.int32)[:, j].long() for j in (6, 7)]
    seen = torch.zeros(4, dtype=torch.int64)
    for _ in range(24):
        w1 = torch.from_numpy(rng.uniform(0, 1, fields.shape[0]).astype(
            np.float32))
        w2 = torch.from_numpy(rng.uniform(0, 1, fields.shape[0]).astype(
            np.float32)) * (1.0 - w1)
        w2 = torch.where(w1 + w2 <= 1.0, w2, torch.zeros_like(w2))
        u, v, alpha, _ = pw.candidate_surface(f, w1, w2, wa.alpha_pool)
        keep = comp.plain(u, v, alpha)
        assert not ((cls == pc.CLS_KEPT) & ~keep).any(), name
        assert not ((cls == pc.CLS_CUT) & keep).any(), name
        uv = cls == pc.CLS_UV
        r = torch.from_numpy(rng.uniform(0, 1, fields.shape[0]))
        lo = torch.where(torch.isfinite(a_iv.lo), a_iv.lo, 0.0)
        hi = torch.where(torch.isfinite(a_iv.hi), a_iv.hi, 1.0)
        for a in (torch.full_like(alpha, got.rep), a_iv.lo.float(),
                  a_iv.hi.float(), (lo + (hi - lo) * r).float()):
            assert not (uv & (comp.plain(u, v, a) != keep)).any(), name
        seen += torch.bincount(cls, minlength=4)
    if name == "noalpha":
        assert got.rep == 0.0 and got.counts["test"] == 0
    if name == "norule":
        assert got.no_rule == ("and",) and got.counts["tainted"] > 0
        assert got.counts["kept"] == 0
    if name == "checker":
        assert (seen[1:] > 0).all(), seen  # kept, cut and uv slots


def test_class_build_refuses_wide_rows():
    """No fallback: rows of more than 16 slots raise."""
    comp = ap.compile_predicate(checker_pred)
    with pytest.raises(ValueError, match="16 slots"):
        pc.build(comp, torch.zeros((2, 17, 8), dtype=torch.int32),
                 torch.ones(3), None, "cpu")


# ---------------------------------------------------------------- (iii)

_JAX_WALKS = r"""
import dataclasses
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, sys.argv[2])
from test_torch_pred_classes import table_scene
from vortex_rt_tpu.golden.renderer import generate_rays
from vortex_rt_tpu.models import procedural as proc
from vortex_rt_tpu.models.scene import Camera, Material, Scene
from vortex_rt_tpu.ops.traverse_packet import trace_packets
from vortex_rt_tpu.ops.traverse_wide import WideArrays
from vortex_rt_tpu.utils.config import RTConfig


def checker(u, v, alpha):
    cu = jnp.floor(u * 6.0).astype(jnp.int32)
    cv = jnp.floor(v * 6.0).astype(jnp.int32)
    return (((cu + cv) % 2) == 0) & (alpha >= 0.05)


def noalpha(u, v, alpha):
    return (jnp.floor(u * 5.0) + jnp.floor(v * 3.0)) % 3.0 != 1.0


def norule(u, v, alpha):
    return ((jnp.floor(u * 4.0).astype(jnp.int32) & 1) == 0) & (alpha > 0.1)


sc = table_scene(Scene, proc, Material)
eye = ([0.3, -0.2, -3.0], [0, 0, 1.2], [0, 1, 0], 55.0, 1.0)
o, d = (np.asarray(a) for a in generate_rays(Camera.look_at(*eye), 32, 32))
n = o.shape[0]
out = {"o": o, "d": d}
split = np.where(np.arange(n) < n // 2, np.float32(10.0),
                 np.float32(1e30)).astype(np.float32)
cases = (("flat8", "noalpha", "closest"), ("flat8", "norule", "occl_split"),
         ("tlas4", "checker", "closest"), ("tlas4", "noalpha", "occlusion"))
preds = {"checker": checker, "noalpha": noalpha, "norule": norule}
for build, flat, width in (("flat8", True, 8), ("tlas4", False, 4)):
    sb = sc.build(RTConfig(flatten=flat, use_native_build=False))
    wa = WideArrays.from_scene(sb, width=width)
    wa = (wa.fuse() if width == 8 else wa).with_alpha(sb)
    for k in ("nodes", "tri_rows", "alpha_rows", "alpha_pool") + (
            ("fused",) if width == 8 else ()):
        out[f"{build}/{k}"] = np.asarray(getattr(wa, k))
    for k in ("num_tlas", "max_leaf_tris", "depth", "tri_bits", "width"):
        out[f"{build}/{k}"] = np.int64(getattr(wa, k))
    for b, name, mode in cases:
        if b != build:
            continue
        kw = {"closest": {}, "occlusion": dict(
            t_max=jnp.full(n, 10.0, jnp.float32), occlusion=True),
              "occl_split": dict(t_max=jnp.asarray(split),
                                 occl_split=n // 2)}[mode]
        h, _ = trace_packets(wa, o, d, packet=64, anyhit_pred=preds[name],
                             **kw)
        for k in ("dist", "bx", "by", "tri", "inst"):
            out[f"{build}/{name}/{mode}/{k}"] = np.asarray(getattr(h, k))
np.savez(sys.argv[1], **out)
"""
CASES = ("flat8/noalpha/closest", "flat8/norule/occl_split",
         "tlas4/checker/closest", "tlas4/noalpha/occlusion")


@pytest.fixture(scope="module", autouse=True)
def _jax_walks_started(tmp_path_factory):
    """Starts the JAX walks' subprocess with the module's first test."""
    path = tmp_path_factory.mktemp("pred_cls_walks") / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_WALKS, str(path),
         os.path.join(REPO, "tests")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        yield proc, path
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_walks(_jax_walks_started):
    proc, path = _jax_walks_started
    out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", CASES)
def test_plain_pred_walks_match_jax(jax_walks, case):
    """The plain K1 (flat 8-wide) and K2 (4-wide TLAS) predicate walks on
    the table against the JAX walk, every hit field to the bit; the
    counting walk's tests are the candidates its classes leave, its
    texel reads those classed "test"."""
    ref = jax_walks
    build, name, mode = case.split("/")
    wa = bridge.wide_arrays(
        ref[f"{build}/nodes"], ref[f"{build}/tri_rows"], device="cpu",
        fused=ref.get(f"{build}/fused"),
        alpha_rows=ref[f"{build}/alpha_rows"],
        alpha_pool=ref[f"{build}/alpha_pool"],
        **{k: int(ref[f"{build}/{k}"]) for k in (
            "num_tlas", "max_leaf_tris", "depth", "tri_bits", "width")})
    o, d = torch.from_numpy(ref["o"]), torch.from_numpy(ref["d"])
    n = o.shape[0]
    kw = {"closest": {}, "occlusion": dict(
        t_max=torch.full((n,), 10.0), occlusion=True),
          "occl_split": dict(t_max=torch.where(
              torch.arange(n) < n // 2, 10.0, 1e30).float(),
              occl_split=n // 2)}[mode]
    walk, work_fn = ((tp.trace_packets_ref, tp.walk_work) if build == "flat8"
                     else (pw.trace_packets_walk_ref, pw.walk_work_4))
    hits, steps = walk(wa, o, d, anyhit_pred=PREDS[name], **kw)
    for k in ("dist", "bx", "by", "tri", "inst"):
        if mode != "closest" and k != "dist":
            continue  # occlusion lanes carry no hit record
        got = getattr(hits, k).numpy()
        want = ref[f"{build}/{name}/{mode}/{k}"]
        assert (got.view(np.int32) == want.view(np.int32)).all(), (case, k)
    h2, s2, work = work_fn(wa, o, d, anyhit_pred=PREDS[name], **kw)
    assert torch.equal(s2, steps) and torch.equal(h2.dist, hits.dist)
    cand = int(work.alpha_tests.sum())
    by = work.by_class.tolist()
    assert cand > 0 and sum(by) == cand
    assert int(work.alpha_lookups.sum()) == by[pc.CLS_TEST] + by[pc.CLS_UV]
    assert int(work.texel_reads.sum()) == by[pc.CLS_TEST]
