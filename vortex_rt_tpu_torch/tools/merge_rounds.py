"""Where the PLOC merge loop (K4a, ``csrc/ploc_merge.cu``) spends its time,
round by round, on the card.

Builds a copy of the kernel source with ``%globaltimer`` stamps written by
one thread: in the grid phase at the start of a round and after each of
its three grid-wide barriers (phase A: nearest neighbours, mutual test and
tile totals; B: block 0's plan and scan of the tile totals; C: the
writes), in the tail block at the start of each round.  Runs the loop on
a mesh, holds its outputs to the unstamped kernel's word for word, and
prints each round's live count and phase times (us) as one JSON line per
mesh.  ``--min-blocks N`` adds ``__launch_bounds__(256, N)`` to the grid
kernel (N blocks an SM: 65536 / (256 N) registers a thread at most).

    python -m vortex_rt_tpu_torch.tools.merge_rounds [--min-blocks 4]

Needs the card; the copy is built under ``build/merge_rounds/``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

import torch

from vortex_rt_tpu_torch.accel import lbvh, ploc
from vortex_rt_tpu_torch.accel.lbvh import _launch
from vortex_rt_tpu_torch.runtime import kernels

STAMP = """
__device__ __forceinline__ void stamp(const Merge& g, int it, int k) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    long long* ts = (long long*)(g.state + ((kLog + g.cap + 1) & ~1));
    ts[4LL * it + k] = (long long)t;
}
"""
GRID_MARK = "// ------------------------------------------------------------ grid phase"
GRID_KERNEL = "__global__ void __launch_bounds__(kTile) merge_grid_kernel"


def _patch(text: str, at: str, new: str, count: int = 1) -> str:
    if text.count(at) != count:
        raise RuntimeError(f"ploc_merge.cu changed: {at!r} found "
                           f"{text.count(at)} times, expected {count}")
    return text.replace(at, new)


def stamped_source(min_blocks: int = 0) -> str:
    """The merge kernel's source with the stamps (and launch bounds)."""
    s = (kernels.SRC_DIR / "ploc_merge.cu").read_text()
    s = _patch(s, GRID_MARK, STAMP + "\n" + GRID_MARK)
    s = _patch(s, "        if (m <= max(g.tail, 1) || it >= g.cap) break;\n",
               "        if (m <= max(g.tail, 1) || it >= g.cap) break;\n"
               "        if (blockIdx.x == 0 && tid == 0) stamp(g, it, 0);\n")
    parts = s.split("        grid.sync();\n")
    if len(parts) != 4:
        raise RuntimeError("ploc_merge.cu changed: not three grid barriers")
    s = parts[0] + "".join(
        "        grid.sync();\n        if (blockIdx.x == 0 && tid == 0) "
        f"stamp(g, it, {k});\n" + part for k, part in enumerate(parts[1:], 1))
    s = _patch(s, "    while (m > 1 && it < g.cap) {\n        if (tid == 0) {\n",
               "    while (m > 1 && it < g.cap) {\n"
               "        if (tid == 0) stamp(g, it, 0);\n"
               "        if (tid == 0) {\n")
    s = _patch(s, "    if (tid == 0) {\n        g.state[kIt] = it;",
               "    if (tid == 0) stamp(g, it, 0);\n"
               "    if (tid == 0) {\n        g.state[kIt] = it;")
    if min_blocks:
        s = _patch(s, GRID_KERNEL, GRID_KERNEL.replace(
            "(kTile)", f"(kTile, {min_blocks})"))
    return s


def stamped_run(lib, cmin0, cmax0, tids0, l: int, lmax: int, radius: int):
    """One loop through the stamped library -> (seven outputs, live,
    stamps (rounds + 1, 4) ns): ``ploc._merge_on_card`` with a state
    long enough for the stamps after the round log."""
    cap = ploc.round_cap(l)
    base = (ploc._ST_LOG + cap + 1) & ~1   # the stamps' first word
    work, state0, outs = ploc._merge_buffers(cmin0, cmax0, tids0, l, l, lmax)
    state = torch.zeros(base + 8 * (cap + 1), dtype=torch.int32,
                        device=cmin0.device)
    state[: state0.numel()] = state0
    _launch(lib, "vrt_ploc_merge", cmin0.device, work.data_ptr(),
            state.data_ptr(), *(a.data_ptr() for a in outs), l, l, lmax,
            radius, cap, ploc.tail_size(lmax))
    host = state.cpu()
    live = ploc.decode_round_log(host[: ploc._ST_LOG + cap].tolist())
    return outs, live, host[base:].view(torch.int64).view(-1, 4)


def rounds(live: List[int], ts, tail: int) -> dict:
    """Per-round phase times (us) from the stamps."""
    n = len(live) - 1
    g = sum(1 for m in live[:-1] if m > tail)
    us = (ts.double() / 1e3).tolist()
    grid = [dict(m=live[r], a=us[r][1] - us[r][0], b=us[r][2] - us[r][1],
                 c=us[r][3] - us[r][2]) for r in range(g)]
    tail_rounds = [dict(m=live[r], us=us[r + 1][0] - us[r][0])
                   for r in range(g, n)]
    return dict(rounds=n, grid_rounds=g,
                grid_us=us[g - 1][3] - us[0][0] if g else 0.0,
                tail_us=us[n][0] - us[g][0] if n > g else 0.0,
                grid=grid, tail=tail_rounds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--min-blocks", type=int, default=0)
    ap.add_argument("--radius", type=int, default=16)
    ap.add_argument("--leaf", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("merge_rounds needs the card", file=sys.stderr)
        return 1
    from vortex_rt_tpu_torch.models.bigscenes import blob, wavy_grid

    dev = torch.device("cuda", 0)
    src = kernels.BUILD_DIR.parent / "merge_rounds" / "ploc_merge.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(stamped_source(args.min_blocks))
    lib = kernels.load_file("ploc_merge", src)
    ptxas = [ln.split("ptxas info    : ")[-1].strip()
             for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    for name, mesh in (("blob(n=187)", blob(n=187)),
                       ("wavy_grid(n=708)", wavy_grid(n=708))):
        v = [torch.from_numpy(x).to(dev)
             for x in lbvh.pad_tris(mesh.v0, mesh.v1, mesh.v2, args.leaf)]
        l = v[0].shape[0]
        _, cmin0, cmax0, tids0 = ploc.seed_clusters(*v, args.leaf)
        want = ploc._ploc_merge(cmin0, cmax0, tids0, l, l, args.leaf,
                                args.radius)
        for _ in range(3):   # the last of three runs
            outs, live, ts = stamped_run(lib, cmin0, cmax0, tids0, l,
                                         args.leaf, args.radius)
        for a, b in zip(outs, want[:7]):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise RuntimeError("the stamped loop's outputs differ")
        rec = dict(mesh=name, tris=l, leaf=args.leaf, radius=args.radius,
                   tail_size=ploc.tail_size(args.leaf),
                   min_blocks=args.min_blocks,
                   ptxas=ptxas, device=torch.cuda.get_device_name(0),
                   **rounds(live, ts, ploc.tail_size(args.leaf)))
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
