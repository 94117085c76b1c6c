"""Where the LBVH refit (K5 C, ``csrc/lbvh_refit.cu``) spends its time on
the card.

Builds a copy of the kernel source cut after the leaves' boxes
(``leaf``), the kernel as it is (``full``), and whole copies with other
block shapes (``t<threads>x<leaves a thread>``), and times each with CUDA
events around the bare launch (mean of ``--reps`` after a warm-up) on
config 5's mesh (``wavy_grid(n=708)``, 999,700 triangles) at moved
vertices, on its Karras and sweep-SAH trees.  Each copy makes its own
plan, untimed.  The whole copies' boxes are held to the plain version's
word for word.  Then a copy of each whole one with ``%globaltimer``
stamps runs once: each block's start and the ends of its leaf loads, of
its joins, of its box stores' issue and of its roots' climbs give each
stage's time a block (median and largest, us) and the kernel's span
(``<name>_stages``).  Prints one JSON line per tree.

    python -m vortex_rt_tpu_torch.tools.refit_phases [--reps 20]

Needs the card; the copies are built under ``build/refit_phases/``.
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

from vortex_rt_tpu_torch.accel import lbvh
from vortex_rt_tpu_torch.models.bigscenes import wavy_grid
from vortex_rt_tpu_torch.runtime import kernels

OUT_DIR = kernels.BUILD_DIR.parent / "refit_phases"
STARTED = ("    const int leaf0 = g.l - 1;           // node id of sorted "
           "leaf 0\n")
LEAVES_IN = "    __syncthreads();  // the leaves and the depth range are in\n"
JOINED = ("    // the block's boxes: its leaves, coalesced, and its inner "
          "nodes\n")
STORED = "    // the climbs above the treelets, from their roots\n"
END = "        if (r.x != 0) climb(g, r.x, b, b + 3);\n    }\n"
LEAF_BOXES = """
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int j = t0 + k * kThreads + tid;
        if (j <= t1) put_box(g, leaf0 + j, mn[k], mx[k]);
    }
    return;
"""
SHAPE = "constexpr int kThreads = 128;\nconstexpr int kPer = 2;"
SHAPES = ((512, 2), (256, 4), (256, 2), (128, 4), (64, 2))
STAMP = """
__device__ unsigned long long vrt_stamps[6 * 32768];

__device__ __forceinline__ void vrt_stamp(int k) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    atomicMax(&vrt_stamps[6 * blockIdx.x + k], t);
}

"""
STAMP_COPY = """
extern "C" int vrt_refit_stamps(void* out, int n) {
    return (int)cudaMemcpyFromSymbol(out, vrt_stamps, 8 * (size_t)n);
}
"""
STAGES = ("leaf", "joins", "stores", "climb")


def _patch(text: str, at: str, new: str) -> str:
    if text.count(at) != 1:
        raise RuntimeError(f"lbvh_refit.cu changed: {at!r} found "
                           f"{text.count(at)} times, expected 1")
    return text.replace(at, new)


def stamped(s: str) -> str:
    """A whole copy of the kernel source with the stamps: thread 0 at the
    block's start, after its leaf loads and after its joins; every thread
    after its stores are issued and at its end (the block's last)."""
    s = _patch(s, "namespace {\n", STAMP + "namespace {\n")
    s = _patch(s, STARTED, STARTED + "    if (tid == 0) vrt_stamp(0);\n")
    s = _patch(s, LEAVES_IN, LEAVES_IN + "    if (tid == 0) vrt_stamp(1);\n")
    s = _patch(s, JOINED, "    if (tid == 0) vrt_stamp(2);\n" + JOINED)
    s = _patch(s, STORED, "    vrt_stamp(3);\n" + STORED)
    s = _patch(s, END, END + "    vrt_stamp(4);\n")
    return s + STAMP_COPY


def variants() -> Dict[str, str]:
    """Name -> source of each copy (``full`` is the kernel as it is;
    ``t<threads>x<leaves>`` the kernel with blocks of that many threads of
    that many leaves)."""
    s = (kernels.SRC_DIR / "lbvh_refit.cu").read_text()
    out = {"leaf": _patch(s, LEAVES_IN, LEAVES_IN + LEAF_BOXES), "full": s}
    for threads, per in SHAPES:
        out[f"t{threads}x{per}"] = _patch(
            s, SHAPE, f"constexpr int kThreads = {threads};\n"
            f"constexpr int kPer = {per};")
    return out


def stage_us(lib, blocks: int) -> Dict[str, float]:
    """The stamps of the last launch of a stamped copy -> each stage's
    median and largest time a block and the kernel's span, us (the stamps
    keep the largest value any launch wrote: the last launch's)."""
    import ctypes

    import numpy as np

    if blocks > 32768:
        raise ValueError(f"{blocks} blocks: the stamps hold 32,768")
    f = lib.lib.vrt_refit_stamps
    f.argtypes, f.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    st = np.zeros(6 * blocks, np.uint64)
    if f(st.ctypes.data, st.size) != 0:
        raise RuntimeError("reading the stamps failed")
    st = st.reshape(blocks, 6).astype(np.float64) / 1e3
    t0 = st[:, 0].min()
    out = {"span_us": st[:, 4].max() - t0,
           "last_block_start_us": st[:, 0].max() - t0,
           "last_joins_done_us": st[:, 2].max() - t0}
    for k, name in enumerate(STAGES):
        d = st[:, k + 1] - st[:, k]
        out[f"{name}_us_median"] = float(np.median(d))
        out[f"{name}_us_max"] = float(d.max())
    return out


def _events_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--grid", type=int, default=708)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("refit_phases: no CUDA device")
    dev = torch.device("cuda", 0)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in variants().items():
        pairs = [(name, text)]
        if name != "leaf":
            pairs.append((name + "+stamps", stamped(text)))
        for tag, src in pairs:
            paths[tag] = OUT_DIR / f"lbvh_refit_{tag.replace('+', '_')}.cu"
            paths[tag].write_text(src)
    with ThreadPoolExecutor(max_workers=8) as pool:
        built = {k: pool.submit(kernels.load_file, "lbvh_refit", p)
                 for k, p in paths.items()}
        libs = {k: f.result() for k, f in built.items()}
    m = wavy_grid(n=a.grid)
    v = [torch.from_numpy(x).to(dev) for x in lbvh.pad_tris(m.v0, m.v1,
                                                           m.v2, 4)]
    moved = [x + 0.25 * torch.sin(x.flip(1)) for x in v]
    l = v[0].shape[0]
    for method in ("karras", "sah"):
        _, topo = lbvh.build_lbvh_topo(*v, method=method, width=8)
        want = lbvh._refit_boxes_ref(topo, *moved)
        rec = dict(tree=method, tris=l, gpu=torch.cuda.get_device_name(dev))
        for name, lib in libs.items():
            tile = lib.lib.vrt_lbvh_refit_tile()
            plan = lbvh._refit_plan(topo, tile)
            bmin = torch.empty((2 * l - 1, 3), dtype=torch.float32,
                               device=dev)
            bmax = torch.empty_like(bmin)

            def call(lib=lib, plan=plan, bmin=bmin, bmax=bmax):
                lbvh._launch(lib, "vrt_lbvh_refit_boxes", dev,
                             *(x.data_ptr() for x in moved),
                             topo.order.data_ptr(), topo.lchild.data_ptr(),
                             topo.rchild.data_ptr(), topo.parent.data_ptr(),
                             l, plan.rec.data_ptr(), plan.blocks.data_ptr(),
                             plan.roots.data_ptr(), plan.blocks.shape[0],
                             plan.arrived.data_ptr(), bmin.data_ptr(),
                             bmax.data_ptr())

            ms = _events_ms(call, a.reps)
            torch.cuda.synchronize()
            if name.endswith("+stamps"):
                rec[name[:-7] + "_stages"] = stage_us(lib,
                                                      plan.blocks.shape[0])
                continue
            rec[f"{name}_ms"] = ms
            rec[f"{name}_blocks"] = int(plan.blocks.shape[0])
            if name == "leaf":
                continue
            for got, ref in zip((bmin, bmax), want):
                if not torch.equal(got.view(torch.int32),
                                   ref.view(torch.int32)):
                    raise RuntimeError(f"{name} on the {method} tree: boxes "
                                       f"differ from the plain version's")
            if bool(plan.arrived.any()):
                raise RuntimeError(f"{name}: counters left non-zero")
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
