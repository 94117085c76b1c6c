"""Time the front of the on-device LBVH build and the sweep-SAH tree on
the card, for the copy of the port at ``--root`` (this checkout by
default, or another tree of it to compare in turns): K5 A (the scene box,
the Morton codes and the Karras tree; the sort between them is not
timed), K5 B (the wide collapse, and the refit plan where it is made apart
from the collapse, at a build's first refit) and whole ``build_lbvh_topo``
calls (Karras, 8-wide, leaf 4, as ladder rows 3 and 5 build); with
``--parts sweep``, the sweep-SAH tree (``_sah_sweep_tree`` over the
Morton-sorted leaf boxes: CUDA events around each call, median of
``--builds``; its kernels' device time, its device operations and its
device-to-host copies a call by the profiler; its levels and a digest of
its words) and whole ``build_lbvh_topo(method="sah")`` calls; with
``--parts ploc_boxes``, K4c (``ploc_part``): the PLOC build's leaf-row
boxes, a refit frame's boxes (CUDA events around each call, median of
``--builds``; the kernels' device time and the device operations a call
by the profiler), whole ``refit_ploc`` and ``build_ploc_topo`` calls,
and digests of the boxes.

Meshes: ladder row 3's (``blob(n=187)``, 69,938 triangles) and row 5's
(``wavy_grid(n=708)``, 999,698 triangles), padded to leaf multiples; the
sweep also at 3,000,000 triangles of a random soup (seed 7), where its
range state lives in global memory.  Each
function is timed by CUDA events around ``--reps`` calls after a warm-up
(mean), its kernels alone by ``torch.profiler`` (each kernel's device time
a call), and its device operations counted by the profiler; the build by
CUDA events around each of ``--builds`` builds after a warm-up (median,
all of them listed).  ``--variants`` (this tree only) also builds copies
of ``lbvh_sah.cu`` with another block size (``SWEEP_VARIANTS``), holds
each to the kernel's words and times it in turns with it.  Prints the
ptxas line of each library it builds and one JSON line with the card's
name and power limit.

    python vortex_rt_tpu_torch/tools/build_timing.py [--root DIR]
        [--parts front,sweep,ploc_boxes] [--reps 20] [--builds 10] [--variants]

(run as a file, so that the package imported is the one at ``--root``).

Needs the card; the kernels build under ``DIR/build/torch_kernels/``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# copies of the sweep with one design piece changed: (name, edits)
SWEEP_VARIANTS = {
    # the chunks' range state in global memory (L2), not shared memory
    "sah_state_global": [(
        "return dyn_bytes(nsub) + 12ull * chunk <= VRT_SMEM_MAX;",
        "return false;")],
    # blocks of 1,024 threads (one an SM), sub-tiles of 2,048 positions
    "sah_tile1024": [("#define VRT_TILE 512 ", "#define VRT_TILE 1024")],
    # shared memory up to 200 KB a block: a chunk's state stays in it up to
    # about 16,000 positions at one block an SM; past that the grid is one
    # block an SM with the state in global memory
    "sah_smem200": [("#define VRT_SMEM_MAX (96 * 1024)",
                     "#define VRT_SMEM_MAX (200 * 1024)")],
}


def _events_ms(torch, fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _each_ms(torch, fn, reps: int) -> list:
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _ptxas(log: str) -> str:
    return " | ".join(ln.split("ptxas info    : ")[-1].strip()
                      for ln in log.splitlines()
                      if "registers" in ln or "stack frame" in ln
                      or "spill" in ln)


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _sweep_variants(kernels) -> dict:
    """Build ``SWEEP_VARIANTS`` from this tree's ``lbvh_sah.cu`` under
    ``build/sweep_variants/``: {name: library}."""
    out_dir = kernels.BUILD_DIR.parent / "sweep_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, edits in SWEEP_VARIANTS.items():
        text = (kernels.SRC_DIR / "lbvh_sah.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in lbvh_sah.cu "
                                   f"once")
            text = text.replace(old, new)
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        libs[name] = kernels.load_file("lbvh_sah", src)
    return libs


def sweep_part(args, torch, dev, out: dict) -> None:
    """The sweep-SAH tree and ``method="sah"`` builds at both meshes."""
    import numpy as np

    from vortex_rt_tpu_torch.accel import lbvh
    from vortex_rt_tpu_torch.models import bigscenes
    from vortex_rt_tpu_torch.models.procedural import random_soup
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools.profile_frames import kernel_events

    out["ptxas"]["lbvh_sah"] = _ptxas(kernels.load("lbvh_sah").build_log)
    variants = _sweep_variants(kernels) if args.variants else {}
    for n, lib in variants.items():
        out["ptxas"][n] = _ptxas(lib.build_log)
    for n, line in out["ptxas"].items():
        print(f"{n}: {line}", file=sys.stderr)

    def profiled(fn):
        ev = kernel_events(lambda: [fn() for _ in range(args.reps)])
        kern = [e for e in ev if "Memcpy" not in e.key
                and "Memset" not in e.key]
        return {"device_ops": sum(e.count for e in ev) / args.reps,
                "host_reads": sum(e.count for e in ev
                                  if "DtoH" in e.key) / args.reps,
                "kernel_launches": sum(e.count for e in kern) / args.reps,
                "kernels_ms": sum(e.self_device_time_total for e in kern)
                / 1e3 / args.reps}

    def through(lib, fn):
        if lib is None:
            return fn()
        saved = kernels._loaded.get("lbvh_sah")
        kernels._loaded["lbvh_sah"] = lib
        try:
            return fn()
        finally:
            kernels._loaded["lbvh_sah"] = saved

    for name, make in (
            ("config3", lambda: bigscenes.blob(n=187)),
            ("config5", lambda: bigscenes.wavy_grid(n=708)),
            ("soup3m", lambda: random_soup(np.random.default_rng(7),
                                           3_000_000))):
        mesh = make()
        v = [torch.from_numpy(a).to(dev)
             for a in lbvh.pad_tris(mesh.v0, mesh.v1, mesh.v2, 4)]
        l = v[0].shape[0]
        _, order = torch.sort(lbvh.scene_codes(*v)[0], stable=True)
        lmin, lmax = lbvh._leaf_boxes(*v, order.to(torch.int32))
        versions = {"kernel": None, **variants}
        rec = {"tris": l}
        want = None
        for n in list(versions) + list(reversed(list(versions))):
            lib = versions[n]

            def sweep():
                return through(lib, lambda: lbvh._sah_sweep_tree(
                    lmin, lmax, l))

            got = sweep()
            digest = _digest(got[:4])
            want = want or digest
            if digest != want:
                raise RuntimeError(f"{n}: the sweep's words differ")
            r = rec.setdefault(n, {"sweep_ms_each": [], "turns": []})
            each = _each_ms(torch, sweep, args.builds)
            r["sweep_ms_each"] += each
            r["turns"].append(statistics.median(each))
            r.update(levels=got[-1], digest=digest, **profiled(sweep))
        for n in versions:
            rec[n]["sweep_ms"] = statistics.median(rec[n]["sweep_ms_each"])

        def build():
            lbvh.build_lbvh_topo(*v, leaf_size=4, width=8, method="sah")

        builds = _each_ms(torch, build, args.builds)
        prof = profiled(build)
        rec.update(build_ms=statistics.median(builds), build_ms_each=builds,
                   build_device_ops=prof["device_ops"],
                   build_host_reads=prof["host_reads"])
        out[f"sweep_{name}"] = rec
        print(f"sweep {name} T {l}: " + ", ".join(
            f"{n} {rec[n]['sweep_ms']:.4f} ms ({rec[n]['levels']} levels, "
            f"{rec[n]['device_ops']:.0f} device operations, "
            f"{rec[n]['host_reads']:.0f} host reads)" for n in versions)
            + f"; build median {rec['build_ms']:.4f} ms", file=sys.stderr)
        del v, lmin, lmax, order, mesh


def ploc_part(args, torch, dev, out: dict) -> None:
    """K4c at ladder row 3's and row 5's meshes (PLOC, radius 16, 8-wide,
    leaf 4): the build's leaf-row boxes, a refit frame's boxes at moved
    vertices (twice in a row), whole ``refit_ploc`` and
    ``build_ploc_topo`` calls."""
    from vortex_rt_tpu_torch.accel import lbvh, ploc
    from vortex_rt_tpu_torch.models import bigscenes
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools.profile_frames import kernel_events

    out["ptxas"]["ploc_refit"] = _ptxas(kernels.load("ploc_refit").build_log)

    def profiled(fn):
        ev = kernel_events(lambda: [fn() for _ in range(args.reps)])
        return {"device_ops": sum(e.count for e in ev) / args.reps,
                "kernels_ms": {e.key[:48]: e.self_device_time_total / 1e3
                               / args.reps for e in ev}}

    for name, mesh in (("config3", bigscenes.blob(n=187)),
                       ("config5", bigscenes.wavy_grid(n=708))):
        v = [torch.from_numpy(a).to(dev)
             for a in lbvh.pad_tris(mesh.v0, mesh.v1, mesh.v2, 4)]
        moved = [x + 0.25 * torch.sin(x.flip(1)) for x in v]
        l = v[0].shape[0]
        lb, pt = ploc.build_ploc_topo(*v, leaf_size=4, width=8, radius=16)
        topo = pt.topo

        def rows():
            return ploc._row_boxes(*v, topo.order, pt.leaf_tids,
                                   topo.row_cnt)

        def refit_boxes():
            return ploc._refit_boxes_ploc(pt, *moved)

        def refit():
            return ploc.refit_ploc(pt, *moved, leaf_size=4, width=8)

        def build():
            return ploc.build_ploc_topo(*v, leaf_size=4, width=8, radius=16)

        first, second = refit_boxes(), refit_boxes()
        torch.cuda.synchronize()
        rec = {"tris": l, "live_rows": int((topo.row_cnt > 0).sum()),
               "rows_ms": _events_ms(torch, rows, args.reps),
               "rows": profiled(rows),
               "rows_digest": _digest(rows()),
               "refit_boxes_ms_each": _each_ms(torch, refit_boxes,
                                               args.builds),
               "refit_boxes": profiled(refit_boxes),
               "refit_digest": _digest(first),
               "refit_twice_same": _digest(second) == _digest(first),
               "refit_ploc_ms_each": _each_ms(torch, refit, args.builds),
               "refit_ploc": profiled(refit),
               "build_ms_each": _each_ms(torch, build, args.builds),
               "build": profiled(build)}
        for k in ("refit_boxes", "refit_ploc", "build"):
            rec[f"{k}_ms"] = statistics.median(rec[f"{k}_ms_each"])
        out[f"ploc_{name}"] = rec
        print(f"K4c {name} T {l}: rows {rec['rows_ms']:.4f} ms "
              f"({rec['rows']}), refit boxes median "
              f"{rec['refit_boxes_ms']:.4f} ms ({rec['refit_boxes']}), "
              f"refit_ploc {rec['refit_ploc_ms']:.4f} ms, build "
              f"{rec['build_ms']:.4f} ms ({rec['build']['device_ops']:.0f} "
              f"device operations)", file=sys.stderr)
        del v, moved, lb, pt, topo, first, second


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--parts", default="front,sweep")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--builds", type=int, default=10)
    ap.add_argument("--variants", action="store_true",
                    help="also time SWEEP_VARIANTS (this tree only)")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from vortex_rt_tpu_torch.accel import lbvh
    from vortex_rt_tpu_torch.models import bigscenes
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools.profile_frames import kernel_events

    if not Path(lbvh.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {lbvh.__file__}, not the tree at {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    tile = kernels.load("lbvh_refit").lib.vrt_lbvh_refit_tile()
    # this tree makes the box and the codes in one call and the plan in the
    # collapse; an earlier one in torch ops and at the first refit
    one_call = hasattr(lbvh, "scene_codes")
    out = {"root": str(root), "card": card, "box_in_kernel": one_call,
           "reps": args.reps, "ptxas": {}}
    parts = args.parts.split(",")
    if "sweep" in parts:
        sweep_part(args, torch, dev, out)
    if "ploc_boxes" in parts:
        ploc_part(args, torch, dev, out)
    if "front" not in parts:
        print(json.dumps(out))
        return 0

    def profiled(fn):
        ev = kernel_events(lambda: [fn() for _ in range(args.reps)])
        return {"device_ops": sum(e.count for e in ev) / args.reps,
                "kernels_ms": {e.key[:48]: e.self_device_time_total / 1e3
                               / args.reps for e in ev}}

    for name, mesh in (("config3", bigscenes.blob(n=187)),
                       ("config5", bigscenes.wavy_grid(n=708))):
        v = [torch.from_numpy(a).to(dev)
             for a in lbvh.pad_tris(mesh.v0, mesh.v1, mesh.v2, 4)]
        l = v[0].shape[0]
        if one_call:
            def codes():
                return lbvh.scene_codes(*v)[0]
        else:
            def codes():
                return lbvh.morton_codes(*v, *lbvh._scene_box(*v))
        lcodes, order = torch.sort(codes(), stable=True)
        tree = lbvh._karras(lcodes, l)
        _, topo = lbvh.build_lbvh_topo(*v, leaf_size=4, width=8)

        def front_a():
            codes()
            lbvh._karras(lcodes, l)

        def collapse():
            return lbvh._collapse_wide(*tree, l, 4, 8)

        def front_b():
            collapse()
            if not one_call:
                lbvh._refit_plan(topo, tile)

        def build():
            lbvh.build_lbvh_topo(*v, leaf_size=4, width=8)

        builds = _each_ms(torch, build, args.builds)
        rec = {"tris": l,
               "k5a_ms": _events_ms(torch, front_a, args.reps),
               "k5a": profiled(front_a),
               "k5b_ms": _events_ms(torch, front_b, args.reps),
               "k5b_collapse_ms": _events_ms(torch, collapse, args.reps),
               "k5b": profiled(front_b),
               "build_ms": statistics.median(builds), "build_ms_each": builds,
               "build_device_ops": profiled(build)["device_ops"]}
        out[name] = rec
        print(f"{name} T {l}: K5 A {rec['k5a_ms']:.4f} ms, K5 B "
              f"{rec['k5b_ms']:.4f} ms (collapse {rec['k5b_collapse_ms']:.4f}"
              f"), build median {rec['build_ms']:.4f} ms of {args.builds}, "
              f"{rec['build_device_ops']:.0f} device operations a build",
              file=sys.stderr)
        del v, tree, topo, lcodes, order
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
