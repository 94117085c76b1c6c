"""The ranks of a ``torch.distributed`` process group laid out on named
axes: the port's counterpart of the ``jax.sharding.Mesh`` and the
collectives that ``shard_map`` bodies call in the JAX package.

The JAX package runs one program over a mesh of devices; the port runs
one process per rank, each with its own device (``cuda:{LOCAL_RANK %
device_count}`` unless given, ``"cpu"`` when the caller asks for it),
and the caller starts the process group with the backend of its choice
(``nccl`` across GPUs, ``gloo`` on the CPU or for several ranks on one
GPU).  The ranks are laid out row-major on the axes, as
``np.array(devices).reshape(shape)`` lays devices out, so rank ``r`` of a
``("dp", "sp")`` mesh of shape ``(n_dp, n_sp)`` sits at ``(r // n_sp, r %
n_sp)``.  Every rank makes the process group of every line of every axis
(``dist.new_group``), in the same order, and keeps those it belongs to.

The JAX collectives map to these methods: ``axis_index`` to
``coords[axis]``, ``psum`` to ``all_reduce(x, "sum", axis)``, ``pmin`` to
``all_reduce(x, "min", axis)``, ``lax.all_to_all`` to ``all_to_all``, and
the gather a host pull of a sharded output implies to ``all_gather``.
Each returns a new tensor and leaves its input as it was.  A collective
over an axis of one rank is the identity and calls nothing.

Host memory: gloo runs every collective the port calls on CUDA tensors
itself (the tensors' bytes go through pinned host memory inside gloo:
``tools/gloo_cuda_probe.py`` checked each on an H100 with torch 2.11), so
the port stages nothing; ``host_bytes`` counts the bytes that gloo moves
through the host that way, in and out, for the readings of ranks sharing
one card.  NCCL keeps them on the devices.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


def default_device() -> torch.device:
    """The rank's card: ``cuda:{LOCAL_RANK % device_count}`` (the global
    rank when ``LOCAL_RANK`` is not set).  Raises without a card: a rank
    renders on the CPU only when its caller passes ``device="cpu"``."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device for this rank; pass device='cpu' "
                           "to render on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % n)


@dataclasses.dataclass
class Mesh:
    """This rank's place on a mesh of ranks, and the collectives over its
    axes."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]          # ranks along each axis
    coords: Dict[str, int]         # this rank's index along each axis
    groups: Dict[str, object]      # this rank's process group along each
    device: torch.device
    backend: str
    host_bytes: int = 0            # gloo's CUDA bytes through the host

    @staticmethod
    def create(axis_names: Sequence[str] = ("tiles",),
               shape: Optional[Sequence[int]] = None,
               device=None) -> "Mesh":
        """The mesh of every rank of the default process group (started
        by the caller); ``shape`` defaults to all ranks on one axis."""
        if not dist.is_initialized():
            raise RuntimeError("start the process group first "
                               "(torch.distributed.init_process_group)")
        world, rank = dist.get_world_size(), dist.get_rank()
        names = tuple(axis_names)
        shape = (world,) if shape is None else tuple(int(n) for n in shape)
        if len(shape) != len(names) or int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {shape} over axes {names} does not "
                             f"cover the {world} ranks")
        grid = np.arange(world).reshape(shape)
        coords = dict(zip(names, (int(c) for c in
                                  np.unravel_index(rank, shape))))
        groups = {}
        for ax, name in enumerate(names):
            if shape[ax] in (1, world):
                # (an axis of one rank calls no collective)
                groups[name] = dist.group.WORLD if shape[ax] > 1 else None
                continue
            for line in np.moveaxis(grid, ax, -1).reshape(-1, shape[ax]):
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = g
        return Mesh(axis_names=names, shape=dict(zip(names, shape)),
                    coords=coords, groups=groups,
                    device=(default_device() if device is None
                            else torch.device(device)),
                    backend=str(dist.get_backend()))

    def _group(self, axis: Optional[str]):
        """The group of ``axis``, or every rank's for None."""
        return dist.group.WORLD if axis is None else self.groups[axis]

    def _size(self, axis: Optional[str]) -> int:
        return (dist.get_world_size() if axis is None
                else self.shape[axis])

    def _count(self, *ts: torch.Tensor) -> None:
        if self.backend == "gloo" and ts[0].is_cuda:
            self.host_bytes += sum(t.numel() * t.element_size() for t in ts)

    def all_reduce(self, t: torch.Tensor, op: str,
                   axis: Optional[str]) -> torch.Tensor:
        """Elementwise ``op`` ("sum" or "min") of ``t`` over the ranks of
        ``axis`` (every rank for None)."""
        if self._size(axis) == 1:
            return t
        out = t.contiguous().clone()
        dist.all_reduce(out, _OPS[op], group=self._group(axis))
        self._count(out, out)
        return out

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """(S, ...) -> (S, ...): row s of the result is row ``coords[axis]``
        of rank s's ``t`` (``lax.all_to_all(t, axis, 0, 0)``)."""
        if self._size(axis) == 1:
            return t
        src = t.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self._group(axis))
        self._count(src, out)
        return out

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' ``t`` along ``axis`` concatenated on dim 0, in rank
        order."""
        n = self._size(axis)
        if n == 1:
            return t
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self._group(axis))
        out = torch.cat(parts)
        self._count(src, out)
        return out
