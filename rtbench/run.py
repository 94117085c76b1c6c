"""Run one cell of ``BENCHMARK.json`` once, on the card:

    python -m rtbench.run --workload tetra.pt1080 --seed 12345 \
        --seconds 50 --trace 0

prints the run's lines, then each compared number beside its limit as the
last lines of standard error, and as the last line of standard output one
JSON object: ``correct``, ``attempted`` (frames), ``failed`` (frames with
a value that is not finite), ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer ones with ``--trace 1``), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``.  Exits 2 without
a CUDA device (or with fewer than the cell asks for), 1 on any other
failure, printing no result either way.
"""

from __future__ import annotations

import os
import sys
import time

T0 = time.perf_counter()


def _age() -> float:
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = _age()


def main(argv=None) -> int:
    import argparse
    import json
    from pathlib import Path

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from rtbench import harness, spec

    root = Path(__file__).resolve().parents[1]
    cell = spec.load_cell(root, a.workload)
    if not torch.cuda.is_available():
        print("rtbench: no CUDA device; the benchmark does not fall back to "
              "the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"rtbench: {a.workload} needs {cell.chips} devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run(root, a.workload, a.seed, a.seconds, bool(a.trace),
                      torch.device("cuda", 0), age0=AGE0, t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"rtbench: sys.modules holds {', '.join(bad)}", file=sys.stderr)
        return 1
    harness.print_checks(out["checks"])
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
