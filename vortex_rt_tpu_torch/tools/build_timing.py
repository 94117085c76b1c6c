"""Time the front of the on-device LBVH build on the card, for the copy of
the port at ``--root`` (this checkout by default, or another tree of it
to compare in turns): K5 A (the scene box, the Morton codes and the
Karras tree; the sort between them is not timed), K5 B (the wide collapse,
and the refit plan where it is made apart from the collapse, at a build's
first refit) and whole ``build_lbvh_topo`` calls (Karras, 8-wide, leaf 4,
as ladder rows 3 and 5 build).

Meshes: ladder row 3's (``blob(n=187)``, 69,938 triangles) and row 5's
(``wavy_grid(n=708)``, 999,698 triangles), padded to leaf multiples.  Each
function is timed by CUDA events around ``--reps`` calls after a warm-up
(mean), its kernels alone by ``torch.profiler`` (each kernel's device time
a call), and its device operations counted by the profiler; the build by
CUDA events around each of ``--builds`` builds after a warm-up (median,
all of them listed).  Prints one JSON line with the card's name and power
limit.

    python vortex_rt_tpu_torch/tools/build_timing.py [--root DIR]
        [--reps 20] [--builds 10]

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--builds", type=int, default=10)
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
           "reps": args.reps}

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
