"""Config 2's throughput on the port, the counterpart of the root
``bench.py``: Mrays/s sustained on the main path (flattened 8-wide fused
build, every wave through K1).

    python -m vortex_rt_tpu_torch.tools.bench [--bvh-width 0] [--leaf 4]

The frame is ladder row 2's (``bench_ladder.setup2``, the scene of
``models/config2.py``: the Cornell box with ``bench.py``'s sphere), at
512x512, spp 2, depth 2, shadow rays.  One 16-frame
``render_burst(rays_only=True)`` warms up, then 3 timed 16-frame bursts
(``bench_ladder.bench_bursts``): rays traced (counted exactly from the
live masks) over their wall time, which holds every frame's device work
and the burst's one read of its ray count.  Prints one JSON line:
``metric``, ``value`` (Mrays/s), ``unit``, ``vs_baseline`` (value over
the 200 Mrays/s north-star of ``BASELINE.json``), ``gpu`` (the card's
name and power limit as ``nvidia-smi`` gives them; null on the CPU),
``scene`` and ``knobs`` (the resolved ``bvh_width``, ``max_leaf_tris``
and ``fused``).  Runs on the card unless ``--device cpu`` is given (the
kernels' plain versions; the tests use it with the row's size and the
ladder's ``BURST`` and ``REPS`` cut down).
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import torch

from vortex_rt_tpu_torch.tools import bench_ladder
from vortex_rt_tpu_torch.tools.bench_ladder import Row, bench_bursts, gpu_line

NORTH_STAR_MRAYS = 200.0


def main(argv: Optional[List[str]] = None, row: Optional[Row] = None
         ) -> dict:
    """``row``: row 2 built already (``bench_ladder.setup2``), whose
    renderer the entry then times on its device instead of building its
    own; ``--device`` and the build flags are not read then."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--bvh-width", type=int, default=0,
                    help="0 = auto (8 on the flattened build), 4, 8 or 16")
    ap.add_argument("--leaf", type=int, default=4,
                    help="max_leaf_tris of the build")
    a = ap.parse_args(argv)
    if row is None:
        device = torch.device(a.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the bench runs on the card "
                               "(--device cpu for the plain versions)")
        row = bench_ladder.setup2(device, width=a.bvh_width, leaf=a.leaf)
    (w, h), r = row.res, row.r
    res = bench_bursts(r, row.cam, row.p, w, h, bench_ladder.BURST,
                       bench_ladder.REPS)
    mrays = res["mrays"]
    rec = {
        "metric": (f"Mrays/s sustained (wavefront+packets, {row.scene}, "
                   f"{w}x{h} spp{row.p.spp}, 2-bounce + shadow rays, "
                   f"{bench_ladder.BURST}-frame bursts)"),
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": mrays / NORTH_STAR_MRAYS,
        "gpu": gpu_line() if r.device.type == "cuda" else None,
        "scene": row.scene,
        "knobs": dict(bvh_width=r.wa.width,
                      max_leaf_tris=r.config.max_leaf_tris,
                      fused=r.wa.fused is not None),
        "rays_per_frame": res["rays_per_frame"],
        "ms_per_frame": res["ms_per_frame"],
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
