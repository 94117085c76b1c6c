"""The readings the correctness limits are set from, on the card, one
process a cell (the tables are built once; each seed gets its own frame
seeds, pixels and window at the cell's own load):

    python -m rtbench.calibrate --workload tetra.pt1080 \
        --seeds 11,12,...  --control-seeds 21,22,23 [--faults] \
        [--seconds 6]

Each seed's window is the program's sound run: its compared numbers are
the lower readings.  Each control seed runs the window too, then puts the
reference computed in bfloat16 (the precision below the configuration's
float32) in the program's place: the upper readings.  ``--faults`` also
reads each of ``rtbench.faults`` once, on the first control seed.  One
JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from rtbench import faults, harness, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--faults", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rtbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    root = Path(__file__).resolve().parents[1]
    cell = spec.load_cell(root, a.workload)
    seeds = [int(x) for x in a.seeds.split(",") if x]
    ctl = [int(x) for x in a.control_seeds.split(",") if x]
    prog = harness.setup(cell, (seeds or ctl)[0], dev)
    t = prog.traffic
    harness.warm_up(prog, t["warmup_frames"], {})
    print(f"card: {harness.gpu_line()}", flush=True)
    jobs = [("program", s, None) for s in seeds]
    jobs += [("control", s, None) for s in ctl]
    if a.faults and ctl:
        jobs += [(f"fault:{f}", ctl[0], f) for f in faults.NAMES]
    for kind, s, fault in jobs:
        prog.base_seed = harness.frame_seeds(s)
        pixels = harness.sample_pixels(s, t["width"] * t["height"],
                                       t["check"]["pixels"])
        hooks = faults.hooks(fault, prog) if fault else {}
        win = harness.window(prog, a.seconds, pixels, False, hooks)
        t0 = time.perf_counter()
        stand_in = (harness.control(prog, win, cell.config["precision"])
                    if kind == "control" else None)
        checks = harness.check(prog, cell, win, s, program_values=stand_in)
        print(json.dumps(dict(
            workload=a.workload, kind=kind, seed=s, frames=len(win.waits),
            check_s=time.perf_counter() - t0,
            readings={k: v["value"] for k, v in checks.items()})),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
