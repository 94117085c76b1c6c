"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with ctypes.
The build happens at first use, into ``build/torch_kernels/`` at the root
of the checkout, under a file name keyed by a hash of the source, of every
header it includes from ``csrc/`` (``#include "..."``, followed through
the headers' own includes) and of the flags — so an edited source or
header is rebuilt and an unchanged one is reused.

Nothing here runs at import: the CPU-only test machine imports every
module and has no ``nvcc``.

Variant libraries: ``load_pred(name, compiled)`` builds K1's or K2's
source (``traverse_packet``, ``packet_walk``) with a stateless any-hit
predicate compiled by ``ops/anyhit_pred.py``: its header is written into
``build/torch_kernels/pred/`` under a name that carries its hash, and
the source is built with ``-DVRT_PRED_HEADER=<that name>`` (no quotes:
the source stringizes it) and ``-I``
that directory, which compiles the walk's predicate-mode entry points
(``vrt_traverse_packet_pred``, ``vrt_packet_walk_pred`` and their
``_stats`` forms) beside the default ones.  The build key also hashes
the defines, the include directories and the generated header's bytes,
so each predicate gets its own library, built at its first use and
reused after (ROADMAP hazard H22); a failed nvcc raises with its log.

``LAUNCHES`` counts kernel launches by library name (and ``ploc_pack``,
``lbvh_pack``'s two kernels in their PLOC mode,
``traverse_packet_alpha`` and ``packet_walk_alpha``, the alpha-cutout
instantiations of K1 and K2, ``traverse_packet_pred`` and
``packet_walk_pred``, their predicate modes, and
``traverse_packet_stats`` and ``packet_walk_stats``, their counting
instantiations in any mode).  Each wrapper adds one per
``__global__`` function it launches (an LBVH or PLOC entry point may
launch several), where it launches and nowhere else, so a caller can
reset the counts, drive the main path and see which kernels it went
through.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

_PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"

# -fmad=false: no a*b+c contraction, so kernels agree with their plain
# PyTorch versions (and the JAX package) to the bit; no --use_fast_math
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each kernel library: {function: (argtypes, restype)}
_SIGNATURES: Dict[str, Dict[str, Tuple[List, object]]] = {
    "packet_walk": {
        "vrt_packet_walk": ([_P] * 12 + [_I] * 10 + [_P], _I),
        "vrt_packet_walk_alpha": ([_P] * 14 + [_I] * 12 + [_F, _P], _I),
        # the counting instantiations (per-wave statistics)
        "vrt_packet_walk_stats": ([_P] * 14 + [_I] * 10 + [_P], _I),
        "vrt_packet_walk_alpha_stats": ([_P] * 16 + [_I] * 12 + [_F, _P],
                                        _I),
        "vrt_packet_walk_stack_max": ([], _I),
        "vrt_error_string": ([_I], ctypes.c_char_p),
    },
    # K1 at width 8 (vrt_traverse_packet*) and width 16
    # (vrt_traverse_packet16*), the same arguments
    "traverse_packet": {
        **{f"vrt_traverse_packet{w}{fn}": sig for w in ("", "16")
           for fn, sig in (
               ("", ([_P] * 12 + [_I] * 8 + [_P], _I)),
               ("_alpha", ([_P] * 14 + [_I] * 10 + [_F, _P], _I)),
               ("_stats", ([_P] * 13 + [_I] * 8 + [_P], _I)),
               ("_alpha_stats", ([_P] * 15 + [_I] * 10 + [_F, _P], _I)),
               ("_stack_max", ([], _I)))},
        "vrt_error_string": ([_I], ctypes.c_char_p),
    },
    # K3, the per-ray walk with any-hit suspension (ops/traverse_wide.py)
    "traverse_wide": {
        "vrt_traverse_wide": ([_P] * 9 + [_I] * 8 + [_P], _I),
        "vrt_traverse_wide_blocks_per_sm": ([], _I),
        "vrt_error_string": ([_I], ctypes.c_char_p),
    },
    # K6, the binary TLAS+BLAS walk of the megakernel (ops/traverse2.py)
    "traverse2": {
        "vrt_traverse2": ([_P] * 6 + [_I] * 8 + [_F, _P], _I),
        "vrt_traverse2_stack_max": ([], _I),
        "vrt_error_string": ([_I], ctypes.c_char_p),
    },
    "hbm_walk": {
        "vrt_hbm_walk": ([_P] + [_I] * 5 + [_P, _P], _I),
        "vrt_error_string": ([_I], ctypes.c_char_p),
    },
    # the on-device LBVH build and refit (accel/lbvh.py)
    "lbvh_karras": {
        "vrt_lbvh_box_morton": ([_P] * 3 + [_I] + [_P] * 4, _I),
        "vrt_lbvh_box_blocks": ([_I], _I),
        "vrt_lbvh_karras": ([_P, _I] + [_P] * 5, _I),
        "vrt_error_string": ([_I], ctypes.c_char_p),
    },
    "lbvh_collapse": {
        "vrt_lbvh_collapse": ([_P] * 4 + [_I] * 4 + [_P] * 17, _I),
        "vrt_lbvh_collapse_scratch": ([_I, _I], ctypes.c_longlong),
        "vrt_error_string": ([_I], ctypes.c_char_p),
    },
    "lbvh_refit": {
        "vrt_lbvh_refit_plan": ([_P] * 5 + [_I] * 2 + [_P] * 3, _I),
        "vrt_lbvh_refit_boxes": ([_P] * 7 + [_I] + [_P] * 3 + [_I]
                                 + [_P] * 4, _I),
        "vrt_lbvh_refit_tile": ([], _I),
        "vrt_error_string": ([_I], ctypes.c_char_p),
    },
    "lbvh_pack": {
        "vrt_lbvh_pack_rows": ([_P] * 6 + [_I] + [_P] * 10 + [_I] * 6
                               + [_P] * 4, _I),
        "vrt_error_string": ([_I], ctypes.c_char_p),
    },
    # the sweep-SAH tree, every level in one launch (accel/lbvh.py,
    # method="sah")
    "lbvh_sah": {
        "vrt_sah_blocks": ([_I], _I),
        "vrt_sah_scratch": ([_I, _I], ctypes.c_longlong),
        "vrt_sah_live_offset": ([_I, _I], ctypes.c_longlong),
        "vrt_sah_sweep": ([_P, _P, _I, _I] + [_P] * 5 + [_P], _I),
        "vrt_error_string": ([_I], ctypes.c_char_p),
    },
    # the on-device PLOC build and level refit (accel/ploc.py)
    "ploc_merge": {
        "vrt_ploc_merge": ([_P] * 9 + [_I] * 6 + [_P], _I),
        "vrt_error_string": ([_I], ctypes.c_char_p),
    },
    "ploc_collapse": {
        "vrt_ploc_remap_collapse": ([_P] * 6 + [_I] * 2 + [_P] * 14, _I),
        "vrt_error_string": ([_I], ctypes.c_char_p),
    },
    "ploc_refit": {
        "vrt_ploc_boxes": ([_P] * 6 + [_I] * 2 + [_P] * 8, _I),
        "vrt_error_string": ([_I], ctypes.c_char_p),
    },
}

# the predicate-mode entry points of a variant library (load_pred), beside
# the default ones
_PRED_SIGNATURES: Dict[str, Dict[str, Tuple[List, object]]] = {
    "traverse_packet": {
        **{f"vrt_traverse_packet{w}{fn}": sig for w in ("", "16")
           for fn, sig in (
               ("_pred", ([_P] * 14 + [_I] * 10 + [_F, _P], _I)),
               ("_pred_stats", ([_P] * 15 + [_I] * 10 + [_F, _P], _I)))},
    },
    "packet_walk": {
        "vrt_packet_walk_pred": ([_P] * 15 + [_I] * 12 + [_F, _P], _I),
        "vrt_packet_walk_pred_stats": ([_P] * 17 + [_I] * 12 + [_F, _P],
                                       _I),
    },
}
PRED_DIR = BUILD_DIR / "pred"

# launch counts: one per kernel library, and "ploc_pack", lbvh_pack's
# survivor records and the leaf rows it writes from explicit triangle ids,
# the alpha-cutout and predicate modes of K1 and K2, and their counting
# instantiations (in any mode); K1's 16-wide entry points apart
# ("traverse_packet16" and its modes)
LAUNCHES: Dict[str, int] = {name: 0 for name in (
    *_SIGNATURES, "ploc_pack", "traverse_packet_alpha", "packet_walk_alpha",
    "traverse_packet_pred", "packet_walk_pred", "traverse_packet_stats",
    "packet_walk_stats", "traverse_packet16", "traverse_packet16_alpha",
    "traverse_packet16_pred", "traverse_packet16_stats")}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass
class KernelLibrary:
    """A built and loaded kernel library."""

    name: str
    path: Path
    lib: ctypes.CDLL
    build_seconds: float  # 0.0 when an up-to-date build was reused
    build_log: str        # nvcc's output (ptxas register/spill report),
                          # kept beside the library for a reused build

    def error_string(self, err: int) -> str:
        return self.lib.vrt_error_string(int(err)).decode()


_loaded: Dict[str, KernelLibrary] = {}
# one lock per library: different libraries build concurrently
_locks: Dict[str, threading.Lock] = {name: threading.Lock()
                                     for name in _SIGNATURES}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def includes(src_path: Path) -> List[Path]:
    """The headers ``src_path`` includes with ``#include "..."``, and
    theirs, resolved beside the including file; a missing header is
    left to nvcc to report."""
    found: List[Path] = []
    todo = [Path(src_path)]
    while todo:
        cur = todo.pop()
        for name in _INCLUDE.findall(cur.read_bytes()):
            hdr = (cur.parent / name.decode()).resolve()
            if hdr.exists() and hdr not in found:
                found.append(hdr)
                todo.append(hdr)
    return sorted(found)


def _digest(src_path: Path, extra: Tuple[str, ...] = (),
            headers: Tuple[Path, ...] = ()) -> str:
    """Hash of a source, every header it includes, the flags, and a
    variant's extra flags and the headers they name (a generated
    header)."""
    h = hashlib.sha256(Path(src_path).read_bytes())
    for hdr in includes(src_path):
        h.update(b"\0" + hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    if extra or headers:
        h.update(b"\0variant\0" + "\0".join(extra).encode())
        for hdr in headers:
            h.update(b"\0" + Path(hdr).read_bytes())
    return h.hexdigest()[:16]


def _build(src_path: Path, defines: Tuple[str, ...] = (),
           include_dirs: Tuple[Path, ...] = (),
           headers: Tuple[Path, ...] = ()) -> Tuple[Path, float, str]:
    """Compile ``src_path`` (with ``-D`` ``defines`` and ``-I``
    ``include_dirs``, whose generated ``headers`` the build key hashes)
    unless its build is up to date; returns the library's path, nvcc's
    seconds (0.0 when reused) and its output."""
    extra = (*(f"-D{d}" for d in defines),
             *(f"-I{Path(p)}" for p in include_dirs))
    so = BUILD_DIR / f"{src_path.stem}-{_digest(src_path, extra, headers)}.so"
    log_path = so.with_name(so.name + ".log")
    seconds, log = 0.0, ""
    if so.exists():
        if log_path.exists():
            log = log_path.read_text()
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(src_path)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed building {src_path} "
                f"(rc {proc.returncode}):\n{log}")
        # (ranks that build at once each write their own files and
        # replace the shared ones whole: a reader never sees half a file)
        tmp_log = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
        tmp_log.write_text(log)
        os.replace(tmp_log, log_path)
        os.replace(tmp, so)
    return so, seconds, log


def load_file(name: str, src_path: Path, require_all: bool = False,
              defines: Tuple[str, ...] = (),
              include_dirs: Tuple[Path, ...] = (),
              headers: Tuple[Path, ...] = ()) -> KernelLibrary:
    """Build and load another source of kernel library ``name`` (another
    version of the kernel, with the same C interface, for comparing the
    two; or a variant built with ``defines`` and ``include_dirs``) with
    the same flags; not cached here.  The functions of ``name``'s C
    interface (and its predicate-mode entry points) that the library
    defines are declared; with ``require_all`` a missing one of its
    default interface raises (an earlier version may lack an entry point
    added since)."""
    so, seconds, log = _build(Path(src_path), defines, include_dirs, headers)
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in {**_SIGNATURES[name],
                                    **_PRED_SIGNATURES.get(name, {})}.items():
        required = require_all and fn in _SIGNATURES[name]
        if not required and not hasattr(lib, fn):
            continue
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return KernelLibrary(name=name, path=so, lib=lib, build_seconds=seconds,
                         build_log=log)


def load(name: str) -> KernelLibrary:
    """Build ``csrc/<name>.cu`` if its build is missing or stale, load
    it, and declare its C signatures.  Raises on any failure."""
    if name not in _SIGNATURES:
        raise KeyError(f"unknown kernel library {name!r}")
    with _locks[name]:
        if name not in _loaded:
            _loaded[name] = load_file(name, SRC_DIR / f"{name}.cu",
                                      require_all=True)
        return _loaded[name]


def load_pred(name: str, compiled) -> KernelLibrary:
    """K1's or K2's library (``traverse_packet``, ``packet_walk``) built
    with the predicate ``compiled`` (an ``ops.anyhit_pred.
    CompiledPredicate``): its header written under ``PRED_DIR``, the
    source built with ``-DVRT_PRED_HEADER`` naming it, at first use, and
    loaded once a process.  Its predicate-mode entry points are
    required."""
    if name not in _PRED_SIGNATURES:
        raise KeyError(f"kernel library {name!r} has no predicate mode")
    key = f"{name}+pred-{compiled.digest}"
    with _locks[name]:
        if key not in _loaded:
            hdr = compiled.write(PRED_DIR)
            lib = load_file(name, SRC_DIR / f"{name}.cu", require_all=True,
                            defines=(f"VRT_PRED_HEADER={hdr.name}",),
                            include_dirs=(PRED_DIR,), headers=(hdr,))
            for fn in _PRED_SIGNATURES[name]:
                if not hasattr(lib.lib, fn):
                    raise RuntimeError(f"{lib.path.name} lacks {fn}")
            _loaded[key] = lib
        return _loaded[key]


def load_all(names=None) -> Dict[str, KernelLibrary]:
    """Build and load several libraries at once: one nvcc process per
    source, all started together.  Raises the first build failure."""
    names = list(_SIGNATURES if names is None else names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = {name: pool.submit(load, name) for name in names}
        return {name: f.result() for name, f in futures.items()}
