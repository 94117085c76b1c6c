"""Start ranks of a process group on one host and collect what each
returns: the launcher of the CPU tests (gloo ranks on the CPU) and of
``chip_smoke.py``'s multi-device phases (gloo ranks sharing one card).

``spawn(fn, world)`` starts ``world`` processes by the ``spawn`` method;
each joins the process group through a ``file://`` store in a directory
of its own (no TCP port, so concurrent launches never collide), reads
``fn`` and its arguments from a file there (large arguments, such as a
scene, never go through the pipe that starts a process), calls
``fn(rank, *args)``, writes its result to that directory and leaves the
group.  The parent reads the results in rank order.  A rank that raises
fails the launch, and a launch that outlives ``timeout`` seconds is
stopped: both raise, and no process is left behind.  ``fn`` must be
importable by its module path (a module-level function).
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, store: str, backend: str,
               threads: Optional[int]) -> None:
    if threads:
        torch.set_num_threads(threads)
    fn, args = torch.load(os.path.join(store, "call.pt"), weights_only=False)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(store, 'store')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=600))
    try:
        out = fn(rank, *args)
        path = os.path.join(store, f"rank{rank}.pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (),
          backend: str = "gloo", threads: Optional[int] = None,
          store_dir: Optional[str] = None,
          timeout: float = 900.0) -> List[Any]:
    """``fn(rank, *args)`` on ``world`` ranks -> their results, in rank
    order.  ``store_dir`` (a fresh temporary directory by default) holds
    the store and the results; ``threads`` sets each rank's torch
    threads."""
    with tempfile.TemporaryDirectory(dir=store_dir) as d:
        torch.save((fn, tuple(args)), os.path.join(d, "call.pt"))
        ctx = mp.start_processes(
            _rank_main, args=(world, d, backend, threads), nprocs=world,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def call_all(rank: int, calls: Sequence) -> list:
    """Each ``(function, args, kwargs)`` of ``calls`` called in turn on
    this rank; their results (a rank function for ``spawn``)."""
    del rank
    return [f(*a, **kw) for f, a, kw in calls]
