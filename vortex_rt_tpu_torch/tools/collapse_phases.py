"""Where the front of the LBVH build (K5 A, ``csrc/lbvh_karras.cu``; K5 B,
``csrc/lbvh_collapse.cu``) spends its time on the card.

Builds copies of the two sources and times each bare launch by the
profiler's device time (mean of ``--reps`` after a warm-up) on config 5's
mesh
(``wavy_grid(n=708)``, 999,700 triangles; its Karras tree, 8-wide, leaf
4):

- K5 B as it is (``full``), with other numbers of depth walks in flight a
  thread (``walks<k>``) and with its registers bounded for k blocks of 256
  threads an SM (``blocks<k>``; the kernel's own bound is six); each copy's topology and plan held to
  the kernel's word for word.  Then a copy with ``%globaltimer`` stamps
  runs once: each warp's lane 0 stamps the block's largest time at each
  phase's end and after each grid barrier, and the tool reports, for each
  point, the time from the kernel's first start to the last block
  reaching it (``reach_us``) and the median over the blocks of the time
  from the block's own start (``block_us``);
- K5 A's two kernels: the box and codes launch, and the Karras kernel
  with other halos of staged codes (``halo<k>``: k codes on each side;
  ``halo0`` stages a block's own codes only), each held to the kernel's
  words, and ``window`` (a probe past the staged window counts as
  outside the array, so every search ends inside it: a wrong tree, timed
  to show what the longer searches cost).
- cut copies, whose outputs are wrong and only timed: K5 B without the
  wide expansion (``no_expand``), without the plan's records
  (``no_records``), without the stores of the expansion's rows
  (``no_row_stores``), without the walks of the treelets' roots to the
  tree's root (``no_top_walks``: a root's depth counts 0), with every
  internal walking to the tree's root (``all_top_walks``), and the Karras
  kernel without the searches
  (``no_search``: the staging and the stores alone).

Prints one JSON line with the card's name.

    python -m vortex_rt_tpu_torch.tools.collapse_phases [--reps 20]

Needs the card; the copies are built under ``build/collapse_phases/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch

from vortex_rt_tpu_torch.accel import lbvh
from vortex_rt_tpu_torch.models.bigscenes import wavy_grid
from vortex_rt_tpu_torch.runtime import kernels

OUT_DIR = kernels.BUILD_DIR.parent / "collapse_phases"
WALKS = "constexpr int kWalks = 4;"
BOUNDS = "__launch_bounds__(kBlock, 6) collapse_kernel"
HALO = "constexpr int kHalo = 512;"
PROBE = "        if (j < 0 || j >= l) return -1;\n"
# a probe past the staged window counts as outside the array: every
# search ends inside the window (wrong trees; the cost of the rest)
WINDOW_ONLY = ("        if (j < 0 || j >= l || (unsigned)(j - base) >= "
               "(unsigned)(kBlock + 2 * kHalo)) return -1;\n")
# cut copies, wrong outputs, timed only: K5 B without the wide expansion,
# without the plan's records; K5 A's Karras kernel without the searches
EXPAND = ("        const int ar = expand<W>(g, nx, g.ch_old + (long long)x * W, "
          "&leaves);\n")
RECORDS = ("        if (!sm) {\n"
           "            *(int2*)(g.rec + 2 * q) = make_int2(x | kTop, 0);")
# the walks: a treelet's root walks on to the tree's root (mode 1); every
# internal starts in mode 0 (up its treelet) or 1 (above the treelets)
ROOT_WALKS_ON = "mode[k] = p[k] == x[k] ? 1 : 2;"
MODES = "mode[k] = x[k] < 0 ? 2 : small(g, x[k]) ? 0 : 1;"
ROW_STORE = ("*(int4*)(row + k) = make_int4(a.v[k], a.v[k + 1], a.v[k + 2], "
             "a.v[k + 3]);")
SEARCH = "    const unsigned ci = s_code[i - base];\n"
CUTS = {"no_expand": ("lbvh_collapse", EXPAND,
                      "        const int ar = 0;\n        leaves = 0;\n"),
        "no_records": ("lbvh_collapse", RECORDS, RECORDS.replace(
            "!sm", "true")),
        "no_top_walks": ("lbvh_collapse", ROOT_WALKS_ON, "mode[k] = 2;"),
        "no_row_stores": ("lbvh_collapse", ROW_STORE,
                          "if (a.v[k] == -7) " + ROW_STORE),
        "all_top_walks": ("lbvh_collapse", MODES, "mode[k] = x[k] < 0 ? 2 : 1;"),
        "no_search": ("lbvh_karras", SEARCH, SEARCH + (
            "    lchild[i] = rchild[i] = lo_out[i] = hi_out[i] = (int)ci;\n"
            "    return;\n"))}
SYNC = "    grid.sync();\n"
# the stamped points of K5 B, in order: (anchor, name); an anchor is
# stamped before (the barriers: before and after)
POINTS = (("    // 1. parents,", "start"),
          (SYNC, "parents"),
          ("    int n_max = 0, n_start = 0;\n", "walks"),
          (SYNC, "counts"),
          ("    // 3b. per node", "internals"),
          ("    // 3c. per position", "leaf_rows"),
          (SYNC, "treelet_rows"),
          ("        off += run;\n    }\n}\n", "numbering"))
STAMP = """
__device__ unsigned long long vrt_stamps[16 * 8192];

__device__ __forceinline__ void vrt_stamp(int k) {
    if ((threadIdx.x & 31) != 0) return;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    atomicMax(&vrt_stamps[16 * blockIdx.x + k], t);
}

"""
STAMP_COPY = """
extern "C" int vrt_collapse_stamps(void* out, int n) {
    return (int)cudaMemcpyFromSymbol(out, vrt_stamps, 8 * (size_t)n);
}
"""


def _patch(text: str, at: str, new: str, start: int = 0) -> tuple:
    k = text.find(at, start)
    if k < 0:
        raise RuntimeError(f"the source changed: {at!r} not found")
    return text[:k] + new + text[k + len(at):], k + len(new)


def stamped(s: str) -> tuple:
    """A copy of ``lbvh_collapse.cu`` with the stamps -> (source, names of
    the stamped points in order)."""
    s, _ = _patch(s, "namespace {\n", STAMP + "namespace {\n")
    names, pos, k = [], 0, 0
    for at, name in POINTS:
        if at == SYNC:
            new = (f"    vrt_stamp({k});\n" + at
                   + f"    vrt_stamp({k + 1});\n")
            names += [name, name + "_barrier"]
            k += 2
        elif name == "numbering":
            new = (at[:-2] + f"    vrt_stamp({k});\n" + "}\n")
            names.append(name)
            k += 1
        else:
            new = f"    vrt_stamp({k});\n" + at
            names.append(name)
            k += 1
        s, pos = _patch(s, at, new, pos)
    return s + STAMP_COPY, names


def variants() -> Dict[str, tuple]:
    """Name -> (library, source) of each copy."""
    col = (kernels.SRC_DIR / "lbvh_collapse.cu").read_text()
    kar = (kernels.SRC_DIR / "lbvh_karras.cu").read_text()
    out = {"full": ("lbvh_collapse", col)}
    for k in (1, 2, 8):
        out[f"walks{k}"] = ("lbvh_collapse", _patch(
            col, WALKS, f"constexpr int kWalks = {k};")[0])
    for k in (4, 8):   # (4: no bound, 64 registers)
        bound = "(kBlock)" if k == 4 else f"(kBlock, {k})"
        out[f"blocks{k}"] = ("lbvh_collapse", _patch(
            col, BOUNDS, BOUNDS.replace("(kBlock, 6)", bound))[0])
    out["stamps"] = ("lbvh_collapse", stamped(col)[0])
    out["karras"] = ("lbvh_karras", kar)
    for k in (0, 128, 1024):
        out[f"halo{k}"] = ("lbvh_karras", _patch(
            kar, HALO, f"constexpr int kHalo = {k};")[0])
    out["window"] = ("lbvh_karras", _patch(kar, PROBE, WINDOW_ONLY)[0])
    for name, (lib, at, new) in CUTS.items():
        out[name] = (lib, _patch(col if lib == "lbvh_collapse" else kar, at,
                                 new)[0])
    return out


def _device_ms(fn, reps: int) -> float:
    """Device time a call of ``fn`` (one kernel launch) by the profiler,
    over ``reps`` calls after a warm-up, per launch it recorded: a kernel
    shorter than its launch's host time is not timed by events around
    the calls."""
    from vortex_rt_tpu_torch.tools.profile_frames import kernel_events

    fn()
    torch.cuda.synchronize()
    ev = kernel_events(lambda: [fn() for _ in range(reps)])
    # (per launch recorded: a session may drop some of its events)
    return (sum(e.self_device_time_total for e in ev) / 1e3
            / max(sum(e.count for e in ev), 1))


def collapse_call(lib, tree, l: int, dev):
    """The collapse launch of ``lib`` on ``tree`` (8-wide, leaf 4) into new
    outputs -> (launch, its outputs)."""
    cap = kernels.load("lbvh_refit").lib.vrt_lbvh_refit_tile() // 2
    n = l - 1

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    outs = [i32(2 * l - 1), torch.empty(n, dtype=torch.bool, device=dev),
            i32(n, 8), i32(n), i32(n), i32(2 * l - 1), i32(l), i32(l),
            i32(l), torch.empty((), dtype=torch.int64, device=dev),
            i32(n, 2), i32(-(-l // cap), 4), i32(l, 2), i32(n), i32(n)]
    scratch = i32(lib.lib.vrt_lbvh_collapse_scratch(l, cap))

    def call():
        lbvh._launch(lib, "vrt_lbvh_collapse", dev,
                     *(a.data_ptr() for a in tree), l, 4, 8, cap,
                     *(a.data_ptr() for a in outs), scratch.data_ptr())

    return call, outs


def karras_call(lib, lcodes, l: int, dev):
    outs = [torch.empty(l - 1, dtype=torch.int32, device=dev)
            for _ in range(4)]

    def call():
        lbvh._launch(lib, "vrt_lbvh_karras", dev, lcodes.data_ptr(), l,
                     *(a.data_ptr() for a in outs))

    return call, outs


def box_call(lib, v, dev):
    t = v[0].shape[0]
    box = torch.empty(6, dtype=torch.float32, device=dev)
    part = torch.empty(6 * lib.lib.vrt_lbvh_box_blocks(t),
                       dtype=torch.float32, device=dev)
    codes = torch.empty(t, dtype=torch.int32, device=dev)

    def call():
        lbvh._launch(lib, "vrt_lbvh_box_morton", dev,
                     *(a.data_ptr() for a in v), t, part.data_ptr(),
                     box.data_ptr(), codes.data_ptr())

    return call, [box, codes]


def stamps(lib, names) -> Dict[str, float]:
    f = lib.lib.vrt_collapse_stamps
    f.argtypes, f.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    st = np.zeros(16 * 8192, np.uint64)
    if f(st.ctypes.data, st.size) != 0:
        raise RuntimeError("reading the stamps failed")
    st = st.reshape(8192, 16)
    st = st[st[:, 0] > 0][:, :len(names)].astype(np.float64) / 1e3
    t0 = st[:, 0].min()
    return {"blocks": int(st.shape[0]),
            **{f"{k}_reach_us": float(st[:, i].max() - t0)
               for i, k in enumerate(names)},
            **{f"{k}_block_us": float(np.median(st[:, i] - st[:, 0]))
               for i, k in enumerate(names)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--grid", type=int, default=708)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("collapse_phases: no CUDA device")
    dev = torch.device("cuda", 0)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (lib, text) in variants().items():
        paths[name] = (lib, OUT_DIR / f"{lib}_{name}.cu")
        paths[name][1].write_text(text)
    with ThreadPoolExecutor(max_workers=8) as pool:
        built = {k: pool.submit(kernels.load_file, lib, p)
                 for k, (lib, p) in paths.items()}
        libs = {k: f.result() for k, f in built.items()}
    m = wavy_grid(n=a.grid)
    v = [torch.from_numpy(x).to(dev) for x in lbvh.pad_tris(m.v0, m.v1,
                                                           m.v2, 4)]
    l = v[0].shape[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    rec = {"card": card, "tris": l, "reps": a.reps}
    call, outs = box_call(libs["karras"], v, dev)
    rec["box_morton_ms"] = _device_ms(call, a.reps)
    lcodes = torch.sort(outs[1], stable=True)[0]
    want = None
    for name in ("karras", "halo0", "halo128", "halo1024", "window",
                 "no_search"):
        call, outs = karras_call(libs[name], lcodes, l, dev)
        rec[f"{name}_ms"] = _device_ms(call, a.reps)
        if name in ("window", "no_search"):
            continue
        if want is None:
            want, tree = [x.clone() for x in outs], outs
        elif not all(torch.equal(x, y) for x, y in zip(outs, want)):
            raise RuntimeError(f"{name}: the tree differs from the kernel's")
    want = None
    for name in ("full", "walks1", "walks2", "walks8", "blocks4", "blocks8",
                 "stamps",
                 "no_expand", "no_records", "no_top_walks", "all_top_walks",
                 "no_row_stores"):
        call, outs = collapse_call(libs[name], tree, l, dev)
        rec[f"{name}_ms"] = _device_ms(call, a.reps)
        torch.cuda.synchronize()
        if name in CUTS:
            continue
        if want is None:
            want = [x.clone() for x in outs]
        elif not all(torch.equal(x, y) for x, y in zip(outs, want)):
            raise RuntimeError(f"{name}: the collapse differs from the "
                               f"kernel's")
    rec["stamps"] = stamps(libs["stamps"], stamped(
        (kernels.SRC_DIR / "lbvh_collapse.cu").read_text())[1])
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
