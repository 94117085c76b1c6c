"""Build and bind the native host BVH builder (port of
``vortex_rt_tpu/runtime/native.py``).

The repo's ``csrc/builder.cpp`` (the binned-SAH binary BVH build, the
host-side hot path of ``Scene.build``) is compiled at first use with
``$CXX`` (default ``g++``) ``-O3 -fPIC -shared`` into
``build/torch_kernels/`` at the root of the checkout, under a file name
keyed by a hash of the source and the flags, and bound with ctypes.  No
``-march=native``: the build directory can travel between machines.  The
JAX package's ``csrc/libvrt.so`` is neither loaded nor written.

There is no fallback: ``build_bvh2_native`` raises when the library
cannot be built or loaded.  ``RTConfig(use_native_build=False)`` is the
explicit NumPy build.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from vortex_rt_tpu_torch.runtime.kernels import BUILD_DIR

SRC = Path(__file__).resolve().parents[2] / "csrc" / "builder.cpp"
CXX_FLAGS: Tuple[str, ...] = ("-O3", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_seconds = 0.0  # the compiler's seconds in this process, 0.0 if reused


def cxx_path() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(
            f"C++ compiler {cxx!r} not found: the native BVH builder is "
            f"compiled from {SRC.name} at first use (set $CXX, or build "
            f"with RTConfig(use_native_build=False))")
    return found


def _build() -> Path:
    """Compile ``csrc/builder.cpp`` unless its build is up to date."""
    global build_seconds
    if not SRC.exists():
        raise RuntimeError(f"native builder source {SRC} is missing")
    h = hashlib.sha256(SRC.read_bytes())
    h.update("\0".join(CXX_FLAGS).encode())
    so = BUILD_DIR / f"builder-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = cxx_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True, timeout=600)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed building {SRC} (rc "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """Build (if stale or missing) and load the library; raises on any
    failure."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.vrt_build_bvh2.restype = ctypes.c_int
            lib.vrt_build_bvh2.argtypes = [
                f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f32p, f32p, i32p, i32p, i32p, ctypes.c_int,
            ]
            _lib = lib
        return _lib


def build_bvh2_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                      max_leaf_tris: int = 4, sah_bins: int = 8):
    """Native binned-SAH build -> ``accel.bvh2.BVH2``.  The same
    algorithm as the NumPy builder, not its tree node for node."""
    from vortex_rt_tpu_torch.accel.bvh2 import BVH2

    lib = load()
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    t = v0.shape[0]
    cap = 2 * t + 2
    nm = np.empty((cap, 3), np.float32)
    nx = np.empty((cap, 3), np.float32)
    lf = np.empty(cap, np.int32)
    tc = np.empty(cap, np.int32)
    ti = np.empty(t, np.int32)
    n = lib.vrt_build_bvh2(v0, v1, v2, t, max_leaf_tris, sah_bins,
                           nm, nx, lf, tc, ti, cap)
    if n < 0:
        raise RuntimeError(f"vrt_build_bvh2 failed ({n})")
    return BVH2(node_min=nm[:n].copy(), node_max=nx[:n].copy(),
                left_first=lf[:n].copy(), tri_count=tc[:n].copy(),
                tri_idx=ti)
