"""Build and load the port's CUDA library (nvcc + ctypes).

The sources under ``repro_torch/csrc`` have a plain C interface and are
compiled for ``sm_90a`` with nvcc into ``build/kernels/`` at the root of
the checkout, at first use, and loaded with ``ctypes``: one nvcc per
source, all started together, then one link into a shared library.
Nothing is built or loaded when a module is imported: the CPU tests
import every module on a machine without nvcc. The library name
carries a hash of the sources and flags, so an edited source is rebuilt
and concurrent builders (several rank processes) never load a
half-written file.
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
SOURCES = tuple(_PKG / "csrc" / f for f in (
    "cellcopy.cu", "flash_attention.cu", "selective_scan.cu", "wkv6.cu"))
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; return their output, or raise with
    it if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    bad = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs)
           if p.returncode != 0]
    if bad:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(c)} ({rc}):\n{o}" for c, rc, o in bad))
    return "\n".join(outs)


def build() -> Path:
    """Compile the sources unless this exact build exists; return the
    library's path. Safe under concurrent callers: each compiles to its
    own temporary names and renames atomically."""
    out = lib_path()
    if out.exists():
        BUILD_LOG.update(seconds=0.0, cached=True, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.name}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    tmp = BUILD_DIR / f"{tag}.tmp"
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                        for src, o in zip(SOURCES, objs)])
        log += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                          *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    BUILD_LOG.update(seconds=time.perf_counter() - t0, cached=False,
                     log=log.strip())
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
            lib.cellcopy_plan.argtypes = [ll, ll, ctypes.POINTER(ll)]
            lib.cellcopy_plan.restype = ctypes.c_int
            lib.pool_host_register.argtypes = [vp, ll]
            lib.pool_host_register.restype = ctypes.c_int
            lib.pool_host_unregister.argtypes = [vp]
            lib.pool_host_unregister.restype = ctypes.c_int
            lib.pool_device_pointer.argtypes = [ctypes.POINTER(vp), vp]
            lib.pool_device_pointer.restype = ctypes.c_int
            i = ctypes.c_int
            lib.flash_attention_fwd.argtypes = [vp] * 4 + [i] * 7 + \
                [ll] * 12 + [vp]
            lib.flash_attention_fwd.restype = ctypes.c_int
            lib.flash_attention_plan.argtypes = [i] * 5 + \
                [ctypes.POINTER(i)]
            lib.flash_attention_plan.restype = ctypes.c_int
            lib.flash_attention_order.argtypes = [i] * 6 + \
                [ctypes.POINTER(i)]
            lib.flash_attention_order.restype = ctypes.c_int
            lib.selective_scan_fwd.argtypes = [vp] * 8 + [i] * 4 + [vp]
            lib.selective_scan_fwd.restype = ctypes.c_int
            lib.selective_scan_plan.argtypes = [i] * 3 + [ctypes.POINTER(i)]
            lib.selective_scan_plan.restype = ctypes.c_int
            lib.wkv6_fwd.argtypes = [vp] * 6 + [i] * 5 + [ll] * 6 + [vp]
            lib.wkv6_fwd.restype = ctypes.c_int
            lib.wkv6_plan.argtypes = [i] * 4 + [ctypes.POINTER(i)]
            lib.wkv6_plan.restype = ctypes.c_int
            lib.wkv6_bwd.argtypes = [vp] * 12 + [i] * 5 + [ll] * 3 + [vp]
            lib.wkv6_bwd.restype = ctypes.c_int
            lib.wkv6_bwd_plan.argtypes = [i] * 5 + [ctypes.POINTER(i)]
            lib.wkv6_bwd_plan.restype = ctypes.c_int
            lib.wkv6_bwd_occupancy.argtypes = [i, i, ctypes.POINTER(i)]
            lib.wkv6_bwd_occupancy.restype = ctypes.c_int
            _lib = lib
        return _lib
