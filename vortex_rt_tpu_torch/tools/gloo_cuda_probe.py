"""Which collectives the gloo backend runs on CUDA tensors, as
``parallel.mesh`` calls them (each one it refused would have to be
staged through host memory by the port).

    python -m vortex_rt_tpu_torch.tools.gloo_cuda_probe [--ranks 2]

Starts gloo ranks on one card (``cuda:0``), calls each collective once on
CUDA tensors with the reduction ops and dtypes the port uses, checks
every result against the value the ranks' inputs give, and prints one
JSON object: per collective "ok", "wrong" or the error it raised.  Needs
a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import sys


def _probe(rank: int, world: int) -> dict:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    out = {}

    def attempt(name, fn):
        try:
            ok = fn()
            torch.cuda.synchronize(dev)
            out[name] = "ok" if ok else "wrong"
        except (RuntimeError, ValueError, TypeError) as e:
            out[name] = f"{type(e).__name__}: {str(e)[:160]}"

    def all_reduce(op, dtype):
        t = torch.full((5,), rank + 1, dtype=dtype, device=dev)
        dist.all_reduce(t, op)
        want = (sum(range(1, world + 1)) if op == dist.ReduceOp.SUM else 1)
        return bool((t == want).all())

    for op_name, op in (("sum", dist.ReduceOp.SUM),
                        ("min", dist.ReduceOp.MIN)):
        for dtype in (torch.float32, torch.int32, torch.int64):
            attempt(f"all_reduce_{op_name}_{str(dtype)[6:]}",
                    lambda op=op, dtype=dtype: all_reduce(op, dtype))

    def all_to_all():
        t = torch.arange(world * 3, dtype=torch.float32, device=dev) \
            + 100 * rank
        o = torch.empty_like(t)
        dist.all_to_all_single(o, t)
        want = torch.cat([torch.arange(rank * 3, rank * 3 + 3,
                                       dtype=torch.float32) + 100 * s
                          for s in range(world)]).to(dev)
        return bool(torch.equal(o, want))

    def all_gather():
        t = torch.full((2, 3), float(rank), device=dev)
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return all(bool((p == s).all()) for s, p in enumerate(parts))

    attempt("all_to_all_single_float32", all_to_all)
    attempt("all_gather_float32", all_gather)
    return out


def main(argv=None) -> int:
    import torch

    from vortex_rt_tpu_torch.parallel import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    res = launch.spawn(_probe, args.ranks, (args.ranks,), timeout=300)
    print(json.dumps({"torch": torch.__version__, "ranks": args.ranks,
                      "rank0": res[0], "same_on_every_rank":
                      all(r == res[0] for r in res)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
