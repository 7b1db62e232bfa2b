"""Build and load the hand-written CUDA kernels.

Every ``gfnerf_tpu_torch/csrc/*.cu`` source is compiled by ``nvcc`` into one
shared library with a plain C interface, ``gfnerf_tpu_torch/_build/
libgfnerf_kernels.so``, and loaded with ``ctypes``.  The sources are
compiled in parallel, one ``nvcc`` process each, and linked once.  The build
runs at the first kernel launch (or on an explicit :func:`build_library`
call) and is redone when a source or a header changes: a stamp file beside
the library records the hash of every ``csrc/*.cu`` and ``csrc/*.cuh`` and
of the flags.  Each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` raises if that is not 0.
Building and loading hold one lock, so that two threads that launch their
first kernel at once (the trainer's and the viewer's) build once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_PATH = BUILD_DIR / "libgfnerf_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float
# C entry points: name -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    "gfnerf_composite_fwd": [_P] * 9 + [_I64, _I64, _P],
    "gfnerf_composite_bwd": [_P] * 13 + [_I64, _I64, _I32, _P],
    "gfnerf_packed_hash_fwd": [_P] * 9 + [_I64] + [_I32] * 6 + [_P],
    "gfnerf_packed_hash_bwd": [_P] * 10 + [_I64] + [_I32] * 7 + [_P],
    "gfnerf_packed_hash_routed": [_P] * 10 + [_I64] + [_I32] * 7 + [_P],
    "gfnerf_hash_anchored_fwd": [_P, _I32] + [_P] * 8 + [_I64] + [_I32] * 5
    + [_P],
    "gfnerf_hash_anchored_bwd": [_P] * 9 + [_I64] + [_I32] * 5 + [_P],
    "gfnerf_scan_march": [_P] * 23 + [_I64, _I32, _I32, _I32, _F32, _I32,
                                      _F32, _F32, _P],
    "gfnerf_temporal_grid_fwd": [_P] * 8 + [_I64] + [_I32] * 4
    + [_F32, _I32, _P],
    "gfnerf_temporal_grid_bwd": [_P] * 9 + [_I64, _I64] + [_I32] * 4
    + [_F32, _I32, _P],
}


def _sources():
    """The translation units, one object file each."""
    return sorted(CSRC_DIR.glob("*.cu"))


def _stamped_files():
    """Every file the build reads: the sources and the headers they
    include."""
    return sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")])


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _stamped_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


# held while the library is built or loaded (re-entered by library())
_LOCK = threading.RLock()


def build_library(verbose: bool = False) -> dict:
    """Compile csrc/*.cu into LIB_PATH unless the stamp says it is current.

    Returns {"built": bool, "seconds": float, "log": str}; with ``verbose``
    nvcc also prints each kernel's registers and spills (-Xptxas -v).
    """
    with _LOCK:
        return _build_library(verbose)


def _build_library(verbose: bool) -> dict:
    digest = _source_hash()
    stamp = BUILD_DIR / "libgfnerf_kernels.stamp"
    if (LIB_PATH.exists() and stamp.exists()
            and stamp.read_text() == digest and not verbose):
        return {"built": False, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    compiles = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in compiles:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in compiles]
    tmp = BUILD_DIR / f"libgfnerf_kernels.{tag}.so"
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *[str(o) for o in objs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log[-1]}")
        os.replace(tmp, LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    stamp.write_text(digest)
    _load.cache_clear()
    return {"built": True, "seconds": seconds, "log": "".join(log)}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    with _LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    build_library()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
