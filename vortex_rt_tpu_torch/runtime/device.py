"""Host runtime / device API — the ``vortex.h`` analog (port of
``vortex_rt_tpu/runtime/device.py``).

The reference exposes a C device API (vx_dev_open, vx_mem_alloc,
vx_copy_to_dev, vx_start, vx_ready_wait, vx_dcr_write,
vx_upload_kernel_file, vx_dump_perf) with selectable backends behind one
interface.  Here the backends are ``torch.device``s:

* ``dev_open()`` / ``dev_open("cuda")`` open the card (raising
  ``DeviceError`` when there is none; nothing falls back to the CPU) and
  ``dev_open("cpu")`` is the simulator backend; ``platform`` reports the
  JAX platform names, ``"gpu"`` and ``"cpu"``;
* copy_to_dev = tracked tensors on the device;
* dcr_write = a device-configuration register file (the RTX
  TLAS/BLAS/BVH/TRI base "pointers" — here, names of bound buffers);
* upload_kernel = registering entry points by name;
* start / ready_wait = an asynchronous launch, then a wait on a CUDA
  event recorded after it (on the CPU the launch has already run);
* dump_perf = the counter report (vx_dump_perf).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

# DCR address map (hw/VX_types.toml:16-19)
VX_DCR_BASE_STARTUP_ADDR = 0x001
VX_DCR_BASE_MPM_CLASS = 0x005
VX_DCR_BASE_RTX_TLAS_PTR = 0x006
VX_DCR_BASE_RTX_BLAS_PTR = 0x007
VX_DCR_BASE_RTX_BVH_PTR = 0x008
VX_DCR_BASE_RTX_TRI_PTR = 0x009


class DeviceError(RuntimeError):
    pass


def _torch_device(backend: Optional[str]) -> torch.device:
    """The device of a backend name: None or "cuda" open the card, "cpu"
    the CPU; anything else, or a card that is not there, raises."""
    if backend == "cpu":
        return torch.device("cpu")
    if backend not in (None, "cuda"):
        raise DeviceError(f"cannot open backend {backend!r}: cuda or cpu")
    if not torch.cuda.is_available():
        raise DeviceError(f"cannot open backend {backend!r}: no CUDA "
                          f"device (dev_open('cpu') opens the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


class Device:
    """One accelerator context (the vx_device analog)."""

    def __init__(self, backend: Optional[str] = None):
        self._device = _torch_device(backend)
        self._buffers: Dict[str, torch.Tensor] = {}
        self._dcrs: Dict[int, Any] = {}
        self._kernels: Dict[str, Callable] = {}
        self._pending: Optional[Any] = None
        self._done: Optional[torch.cuda.Event] = None
        self._counters: Dict[str, float] = {
            "uploads": 0, "bytes_to_dev": 0, "bytes_from_dev": 0,
            "kernels_launched": 0, "rays_traced": 0, "device_time_s": 0.0,
        }

    # ---- memory (vx_mem_alloc / vx_copy_to_dev / vx_copy_from_dev) ----

    def copy_to_dev(self, name: str, host: np.ndarray) -> torch.Tensor:
        arr = torch.as_tensor(np.asarray(host)).to(self._device)
        self._buffers[name] = arr
        self._counters["uploads"] += 1
        self._counters["bytes_to_dev"] += arr.nbytes
        return arr

    def buffer(self, name: str) -> torch.Tensor:
        if name not in self._buffers:
            raise DeviceError(f"no buffer named {name!r}")
        return self._buffers[name]

    def copy_from_dev(self, arr) -> np.ndarray:
        out = (arr.detach().cpu().numpy() if torch.is_tensor(arr)
               else np.asarray(arr))
        self._counters["bytes_from_dev"] += out.nbytes
        return out

    def mem_info(self) -> Dict[str, int]:
        """vx_mem_info analog: allocation footprint per buffer."""
        return {k: v.nbytes for k, v in self._buffers.items()}

    # ---- configuration registers (vx_dcr_write) ----

    def dcr_write(self, addr: int, value: Any) -> None:
        self._dcrs[addr] = value

    def dcr_read(self, addr: int) -> Any:
        if addr not in self._dcrs:
            raise DeviceError(f"DCR 0x{addr:03x} not written")
        return self._dcrs[addr]

    # ---- kernels (vx_upload_kernel_* / SBT) ----

    def upload_kernel(self, name: str, fn: Callable) -> None:
        """Register an entry point under ``name``."""
        self._kernels[name] = fn

    # ---- execution (vx_start / vx_ready_wait) ----

    def start(self, kernel: str, *args, **kw) -> None:
        """Launch asynchronously: the entry point enqueues its work on the
        current stream and returns; a CUDA event recorded after it marks
        its end."""
        if self._pending is not None:
            raise DeviceError("device busy (vx_start while running)")
        fn = self._kernels.get(kernel)
        if fn is None:
            raise DeviceError(f"kernel {kernel!r} not uploaded")
        self._t0 = time.perf_counter()
        if self._device.type == "cuda":
            with torch.cuda.device(self._device):
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                self._pending = fn(*args, **kw)
                self._done = torch.cuda.Event(enable_timing=True)
                self._done.record()
            self._started = start
        else:
            self._pending = fn(*args, **kw)
        self._counters["kernels_launched"] += 1

    def ready_wait(self, timeout_s: Optional[float] = None):
        """Block until the launched work completes (vx_ready_wait): on the
        card, a wait on the event recorded after it, and its device time
        from the two events; on the CPU the work ran inside ``start``.
        A wait longer than ``timeout_s`` raises (the work has still
        completed: there is no preemptive timeout)."""
        if self._pending is None:
            raise DeviceError("nothing running")
        out = self._pending
        if self._done is not None:
            self._done.synchronize()
            dt = self._started.elapsed_time(self._done) / 1e3
            self._done = None
        else:
            dt = time.perf_counter() - self._t0
        self._counters["device_time_s"] += dt
        self._pending = None
        if timeout_s is not None and dt > timeout_s:
            raise DeviceError(f"ready_wait exceeded {timeout_s}s ({dt:.3f}s)")
        return out

    # ---- observability (vx_dump_perf / MPM counters) ----

    def add_counter(self, name: str, value: float) -> None:
        self._counters[name] = self._counters.get(name, 0) + value

    def dump_perf(self) -> Dict[str, float]:
        report = dict(self._counters)
        report["buffers"] = len(self._buffers)
        report["buffer_bytes"] = float(sum(self.mem_info().values()))
        return report

    @property
    def platform(self) -> str:
        return "gpu" if self._device.type == "cuda" else "cpu"


def dev_open(backend: Optional[str] = None) -> Device:
    """vx_dev_open analog; backend None or "cuda" (the card), or "cpu"."""
    return Device(backend)
