"""Chained row-fetch latency probe (port of ``tools/exp_pallas_hbm.py``).

k interleaved walks over an (n, 128) int32 table whose word 0 holds a
random permutation of the row ids: each step fetches every walk's
current row and takes word 0 of it as the walk's next index, so every
fetch depends on the one before.  ns/step is the latency of one
dependent row fetch, ns/step/walk what k overlapped walks amortize it
to.  ``words`` sets how much of a row a step fetches: 128 words (512 B,
the whole row, as the TPU tool's DMA copies it), 24 (96 B, what K1
reads of a fused row at an internal node) or 4 (16 B, one vector: the
chain's own word).  K1's and K2's row addresses also come from the
previous step, so the curve at the width they read is the floor of
their cost per step.

``run_walks`` launches ``csrc/hbm_walk.cu`` for a CUDA table and runs
``run_walks_ref``, the plain PyTorch chained gather, for a CPU table.

On the card:

    python -m vortex_rt_tpu_torch.tools.exp_hbm_walk --rows 29140 \\
        --steps 2000 --ks 1,4,8,16,32 --words 128

prints the same lines as the TPU tool, the header naming where the rows
lie.  The default pool (29,140 rows x 512 B = 14.2 MiB, the node count
of the ladder's config-3 8-wide table) fits in the H100's 50 MB L2 and
is read into it before each timed run, so it measures L2 latency;
``--rows 1048576`` (512 MiB) does not fit, the L2 is flushed before each
timed run, and it measures device-memory latency.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vortex_rt_tpu_torch.runtime import kernels

W = 128  # row words, as the TPU tool
KS = (1, 4, 8, 16, 32)  # walk counts the kernel is compiled for


def _check(tab: torch.Tensor, steps: int, k: int, words: int) -> None:
    if tab.dtype != torch.int32 or tab.dim() != 2 or not tab.is_contiguous():
        raise ValueError("tab must be a contiguous (n, words) int32 tensor")
    if tab.shape[1] % 4:
        raise ValueError("rows must hold a multiple of 4 words (16 B)")
    if k not in KS:
        raise ValueError(f"k={k}: the walk is compiled for k in {KS}")
    if not k <= tab.shape[0] < 2**31:
        raise ValueError(f"need k <= rows < 2**31, got {tab.shape[0]} rows")
    if words % 4 or not 4 <= words <= min(W, tab.shape[1]):
        raise ValueError(f"words={words}: a multiple of 4 in [4, "
                         f"{min(W, tab.shape[1])}]")
    if steps < 0:
        raise ValueError("steps must be >= 0")


def run_walks(tab: torch.Tensor, steps: int, k: int,
              words: int = W) -> torch.Tensor:
    """k chained walks of ``steps`` steps, each step fetching the first
    ``words`` words of every walk's row -> (1,) int32 sum of the final
    indices.  Word 0 of every row must lie in [0, rows)."""
    _check(tab, steps, k, words)
    if tab.device.type == "cpu":
        return run_walks_ref(tab, steps, k, words)
    if tab.device.type != "cuda":
        raise ValueError(f"no walk for device {tab.device}")
    if tab.data_ptr() % 16:
        raise ValueError("tab must be 16-byte aligned")
    lib = kernels.load("hbm_walk")
    out = torch.empty(1, dtype=torch.int32, device=tab.device)
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        err = lib.lib.vrt_hbm_walk(tab.data_ptr(), tab.shape[0], tab.shape[1],
                                   int(words), int(steps), int(k),
                                   out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hbm_walk launch failed: {lib.error_string(err)} "
                           f"({err})")
    kernels.LAUNCHES["hbm_walk"] += 1
    return out


def run_walks_ref(tab: torch.Tensor, steps: int, k: int,
                  words: int = W) -> torch.Tensor:
    """Plain PyTorch version: a chained gather of the first ``words``
    words of each walk's row over a (k,) index tensor, on any device."""
    _check(tab, steps, k, words)
    n = tab.shape[0]
    idx = torch.arange(k, dtype=torch.int64, device=tab.device) * (n // k)
    part = tab[:, :words]
    for _ in range(steps):
        idx = part[idx][:, 0].to(torch.int64)
    total = int(idx.sum()) & 0xFFFFFFFF  # int32 wrap-around
    return torch.tensor([total - (1 << 32) if total >= 1 << 31 else total],
                        dtype=torch.int32, device=tab.device)


def make_table(rows: int, device, seed: int = 0) -> torch.Tensor:
    """(rows, 128) int32 table, word 0 a random permutation successor (the
    TPU tool's adversarial walk: no locality)."""
    perm = np.random.default_rng(seed).permutation(rows).astype(np.int32)
    tab = torch.zeros((rows, W), dtype=torch.int32, device=device)
    tab[:, 0] = torch.from_numpy(perm).to(device)
    return tab


def l2_resident(tab: torch.Tensor, words: int = W) -> bool:
    """Whether the 128-byte lines a walk reads (the first ``words`` words
    of every row) fit in half the card's L2."""
    l2 = torch.cuda.get_device_properties(tab.device).L2_cache_size
    return tab.shape[0] * -(-words * 4 // 128) * 128 <= l2 // 2


def measure(tab: torch.Tensor, steps: int, ks: Sequence[int],
            words: int = W, reps: int = 3) -> List[Dict]:
    """Time ``run_walks`` on a CUDA table for each k: one warm-up call,
    then ``reps`` calls, each timed alone with CUDA events.  Before each
    timed call an L2-resident table (``l2_resident``) has the first
    ``words`` words of every row read, so the walk finds every row in L2;
    a larger table has the L2 flushed (a buffer of 4x its size written),
    so the walk finds no row there — without that, a call would find the
    rows the previous call visited.  Returns one dict per k (k, words, ms
    per call, ns/step, ns/step/walk, the sum, whether the table was
    L2-resident)."""
    if tab.device.type != "cuda":
        raise ValueError("measure times the CUDA kernel: needs a CUDA table")
    warm = l2_resident(tab, words)
    flush = None if warm else torch.empty(
        torch.cuda.get_device_properties(tab.device).L2_cache_size,
        dtype=torch.int32, device=tab.device)
    out = []
    for k in ks:
        total = run_walks(tab, steps, k, words)
        ms = 0.0
        for _ in range(reps):
            if warm:
                tab[:, :words].sum()
            else:
                flush.fill_(1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run_walks(tab, steps, k, words)
            end.record()
            end.synchronize()
            ms += start.elapsed_time(end) / reps
        ns_step = ms * 1e6 / max(steps, 1)
        out.append(dict(k=k, words=words, ms=ms, ns_step=ns_step,
                        ns_step_walk=ns_step / k, sum=int(total.item()),
                        l2_resident=warm))
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=29140)  # config-3 pool
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--ks", default="1,4,8,16,32")
    ap.add_argument("--words", default=str(W),
                    help="words of a row each step fetches, a comma list "
                         "(128 = the whole 512-B row)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_hbm_walk: no CUDA device (the probe times the "
                         "card and has no CPU path)")
    device = torch.device("cuda", 0)
    tab = make_table(a.rows, device)
    res = []
    for words in (int(x) for x in a.words.split(",")):
        print(f"pool {a.rows} rows x {W} i32 = {a.rows * W * 4 / 2**20:.1f} "
              f"MB (HBM), {a.steps} steps, {words * 4} B per row fetch, "
              f"backend=cuda ({torch.cuda.get_device_name(device)}), "
              + ("L2-resident: rows read into L2 before each run"
                 if l2_resident(tab, words)
                 else "beyond L2: L2 flushed before each run"))
        part = measure(tab, a.steps, [int(x) for x in a.ks.split(",")], words)
        for r in part:
            print(f"k={r['k']:3d}: {r['ms']:8.2f} ms total, "
                  f"{r['ns_step']:9.1f} ns/step, {r['ns_step_walk']:8.1f} "
                  f"ns/step/walk")
        res += part
    return res


if __name__ == "__main__":
    main()
