"""Build and load the port's CUDA library (nvcc + ctypes).

The sources under ``repro_torch/csrc`` have a plain C interface and are
compiled for ``sm_90a`` with nvcc into ``build/kernels/`` at the root of
the checkout, at first use, and loaded with ``ctypes``. Nothing is built
or loaded when a module is imported: the CPU tests import every module
on a machine without nvcc. The library name carries a hash of the
sources and flags, so an edited source is rebuilt and concurrent
builders (several rank processes) never load a half-written file.
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

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "cellcopy.cu",)
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
# what the last build in this process reported: seconds and nvcc output
BUILD_LOG: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_DIR / f"libreprotorch-{_digest()}.so"


def build() -> Path:
    """Compile the sources unless this exact build exists; return the
    library's path. Safe under concurrent callers: each compiles to its
    own temporary name and renames atomically."""
    out = lib_path()
    if out.exists():
        BUILD_LOG.update(seconds=0.0, cached=True, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG.update(seconds=secs, cached=False,
                     log=(proc.stdout + proc.stderr).strip())
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll = ctypes.c_void_p, ctypes.c_longlong
            lib.cellcopy_bytes.argtypes = [vp, vp, ll, ll, ll, vp, vp]
            lib.cellcopy_bytes.restype = ctypes.c_int
            lib.pool_host_register.argtypes = [vp, ll]
            lib.pool_host_register.restype = ctypes.c_int
            lib.pool_host_unregister.argtypes = [vp]
            lib.pool_host_unregister.restype = ctypes.c_int
            lib.pool_device_pointer.argtypes = [ctypes.POINTER(vp), vp]
            lib.pool_device_pointer.restype = ctypes.c_int
            _lib = lib
        return _lib
