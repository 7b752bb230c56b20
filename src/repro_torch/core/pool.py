"""Memory pools — the 'CXL pooled memory platform' stand-ins.

The paper's platform is an FPGA CXL pooled-memory box (Niagara 2.0) that
multiple hosts map via a dax device. Here a pool is a flat byte region with
three backends:

  * LocalPool        — in-process uint8 tensor; unit tests, thread runtime.
                       On a CUDA comm it is pinned (``pin_memory=True``)
                       and so addressable by the GPU.
  * SharedMemoryPool — multiprocessing.shared_memory; REAL inter-process
                       shared memory. On a CUDA comm every process pins
                       the segment and maps it into the GPU's address
                       space (``cudaHostRegister`` Mapped | Portable) —
                       the CXL-CCL arrangement: the pool stays host
                       memory, and device payloads enter and leave it
                       through the ``cellcopy`` kernel over PCIe.
  * IncoherentPool   — wraps another pool with per-rank write-back caches so
                       that, exactly like the paper's hardware, a store by
                       one rank is INVISIBLE to others until the writer
                       flushes and the reader invalidates. Used to prove the
                       software-coherence protocol necessary and sufficient.
                       It has no device view: a device payload cannot go
                       through a CPU cache model.

All offsets are absolute byte offsets into the pool.

Data motion is buffer-protocol native: ``write`` accepts any object
exporting a C-contiguous buffer (bytes, bytearray, memoryview, numpy
array, CPU tensor), ``readinto`` fills a caller-supplied writable buffer,
and the memory-backed pools expose raw ``memview`` windows (host) and
``device_view`` windows (GPU) so payloads can live IN the pool.
``write_device`` / ``read_device`` move a CUDA tensor's bytes into and
out of the pool with the cellcopy kernel.
"""
from __future__ import annotations

import ctypes
import threading
import warnings
from dataclasses import dataclass
from multiprocessing import shared_memory

import numpy as np
import torch

from repro_torch.kernels.cellcopy import ops as _cc


def is_device(x) -> bool:
    """True for a tensor that does not live in host memory."""
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


def as_u8(buf):
    """Flat uint8 view of a buffer, zero-copy.

    Host buffers (bytes, bytearray, memoryview, numpy arrays, CPU
    tensors) give a ``memoryview``; a tensor on a device gives a flat
    uint8 tensor on that device. Requires C-contiguity (callers pass a
    contiguous copy for strided data) — the same constraint real MPI
    datatypes place on the fast path."""
    if isinstance(buf, torch.Tensor):
        if not buf.is_contiguous():
            raise ValueError("as_u8 needs a contiguous tensor")
        flat = buf.detach().reshape(-1).view(torch.uint8)
        if flat.device.type != "cpu":
            return flat
        return memoryview(flat.numpy())
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    if mv.ndim != 1 or mv.format != "B":
        mv = mv.cast("B")
    return mv


def as_tensor(arr) -> torch.Tensor:
    """A contiguous tensor of an operand (numpy arrays and scalars become
    CPU tensors without a copy where possible)."""
    return torch.as_tensor(arr).contiguous()


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def readonly(v) -> bool:
    """Whether a view from ``as_u8`` refuses writes (tensors never do)."""
    return isinstance(v, memoryview) and v.readonly


def _host_tensor(mv: memoryview) -> torch.Tensor:
    if not mv.readonly:
        return torch.frombuffer(mv, dtype=torch.uint8)
    with warnings.catch_warnings():
        # read-only host bytes (parked payloads) are only ever read here
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(mv, dtype=torch.uint8)


def copy_bytes_into(dst, src) -> None:
    """``dst[:] = src`` for two ``as_u8`` views of equal length.

    host <- host     memoryview assignment
    device <- device the cellcopy kernel (device memory or a mapped
                     pool/scratch window), then a stream sync
    device <- host   host bytes (parked or salvaged payloads) copied
                     host-to-device
    host <- device   device bytes copied device-to-host
    """
    n = len(src)
    if len(dst) != n:
        raise ValueError(f"copy: {len(dst)}B <- {n}B")
    if not n:
        return
    dd, sd = is_device(dst), is_device(src)
    if not dd and not sd:
        dst[:] = src
    elif dd and sd:
        if not (dst.is_cuda and src.is_cuda):
            raise ValueError("device copies run on CUDA tensors")
        _cc.copy_bytes(dst.data_ptr(), src.data_ptr(), n,
                       _cc.DEFAULT_CELL_BYTES, None)
        torch.cuda.current_stream().synchronize()
    elif dd:
        dst.copy_(_host_tensor(src))
    else:
        torch.frombuffer(dst, dtype=torch.uint8).copy_(src)


class _CudaArray:
    """``__cuda_array_interface__`` over a raw device address."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {
            "shape": (n,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 3}


def _lib():
    from repro_torch.kernels.build import load
    return load()


def _mapped_device_pointer(host_ptr: int) -> int:
    out = ctypes.c_void_p()
    rc = _lib().pool_device_pointer(ctypes.byref(out),
                                    ctypes.c_void_p(host_ptr))
    if rc != 0:
        raise RuntimeError(f"cudaHostGetDevicePointer failed: {rc}")
    return out.value


class Registration:
    """A user buffer PINNED for receiver-posted rendezvous (the cMPI
    analogue of MPI-3 memory registration; cf. foMPI registering
    window memory so remote writes can land without target-side work).

    ``Communicator.register`` pairs the user's writable view (a
    memoryview, or a flat uint8 CUDA tensor) with a pool-resident SHADOW
    region. A receive posted on a registration advertises the shadow's
    offset in the matchbox, a claiming sender writes the payload straight
    into the shadow, and completion drains shadow -> user exactly once —
    no per-message staging object, flat arena footprint across
    iterations. Non-posted deliveries (eager, staged fallback) bypass the
    shadow and land in the user view directly. Free with ``.free()`` (or
    ``Communicator.unregister``); the pin is NOT released automatically.
    """

    __slots__ = ("mv", "nbytes", "shadow_off", "_handle", "_owner",
                 "closed")

    def __init__(self, mv, shadow_off: int, handle, owner):
        self.mv = mv
        self.nbytes = len(mv)
        self.shadow_off = shadow_off
        self._handle = handle
        self._owner = owner
        self.closed = False

    def free(self) -> None:
        self._owner.unregister(self)


class Pool:
    """Flat byte region with read/write access."""

    size: int

    def read(self, off: int, n: int) -> bytes:
        raise NotImplementedError

    def write(self, off: int, data) -> None:
        raise NotImplementedError

    def readinto(self, off: int, dst) -> int:
        """Fill the writable buffer ``dst`` from [off, off+len(dst)).
        Subclasses override with a single-copy path."""
        d = as_u8(dst)
        d[:] = self.read(off, len(d))
        return len(d)

    def memview(self, off: int, n: int) -> memoryview:
        """Raw writable window into pool memory (only memory-backed,
        hardware-coherent pools can hand these out)."""
        raise TypeError(f"{type(self).__name__} is not memory-mappable")

    def device_ptr(self, off: int, n: int) -> int:
        """GPU address of pool byte ``off`` (range-checked for ``n``
        bytes); only pools mapped into a GPU have one."""
        raise TypeError(f"{type(self).__name__} is not mapped into a GPU")

    def tensor_view(self, off: int, n: int, device) -> torch.Tensor:
        """uint8 tensor aliasing [off, off+n) for a comm on ``device``:
        the device window on the card, the host window otherwise.
        Zero-copy either way; ``TypeError`` where the pool has no such
        window."""
        if torch.device(device).type == "cuda":
            return self.device_view(off, n)
        mv = self.memview(off, n)
        if not n:
            return torch.empty(0, dtype=torch.uint8)
        return torch.frombuffer(mv, dtype=torch.uint8)

    def device_view(self, off: int, n: int) -> torch.Tensor:
        """CUDA uint8 tensor aliasing [off, off+n) of the mapped pool."""
        ptr = self.device_ptr(off, n)
        if not n:
            return torch.empty(0, dtype=torch.uint8, device="cuda")
        return torch.as_tensor(_CudaArray(ptr, n), device="cuda")

    def _check_dev(self, t: torch.Tensor) -> None:
        if not t.is_cuda:
            raise ValueError(f"device copy needs a CUDA tensor, got "
                             f"{t.device.type}")

    def write_device(self, off: int, src: torch.Tensor) -> None:
        """Launch the kernel copy of a CUDA uint8 tensor into the pool
        (the caller synchronises before publishing)."""
        ptr = self.device_ptr(off, len(src))
        self._check_dev(src)
        _cc.copy_bytes(ptr, src.data_ptr(), len(src),
                       _cc.DEFAULT_CELL_BYTES, None)

    def read_device(self, off: int, dst: torch.Tensor) -> int:
        """Launch the kernel copy of [off, off+len(dst)) into a CUDA
        uint8 tensor (the caller synchronises)."""
        ptr = self.device_ptr(off, len(dst))
        self._check_dev(dst)
        _cc.copy_bytes(dst.data_ptr(), ptr, len(dst),
                       _cc.DEFAULT_CELL_BYTES, None)
        return len(dst)

    def close(self) -> None:
        pass

    def unlink(self) -> None:
        pass


class _Mapped:
    """Device-address bookkeeping shared by the memory-backed pools."""

    size: int
    _dev_base: int | None = None

    def device_ptr(self, off: int, n: int) -> int:
        if self._dev_base is None:
            raise TypeError(f"{type(self).__name__} is not mapped into a "
                            f"GPU (create it with device='cuda')")
        if off < 0 or off + n > self.size:
            raise IndexError(f"pool view [{off}, {off + n}) out of bounds")
        return self._dev_base + off


class LocalPool(_Mapped, Pool):
    """In-process pool over a uint8 tensor; pinned and GPU-addressable
    when ``device="cuda"``."""

    def __init__(self, size: int, device: str = "cpu"):
        self.size = size
        self.device = device
        cuda = torch.device(device).type == "cuda"
        self.tensor = torch.zeros(size, dtype=torch.uint8, pin_memory=cuda)
        self.buf = self.tensor.numpy()
        if cuda and size:
            self._dev_base = _mapped_device_pointer(self.tensor.data_ptr())

    def read(self, off: int, n: int) -> bytes:
        if off < 0 or off + n > self.size:
            raise IndexError(f"pool read [{off}, {off + n}) out of bounds")
        return self.buf[off:off + n].tobytes()

    def write(self, off: int, data) -> None:
        d = as_u8(data)
        if off < 0 or off + len(d) > self.size:
            raise IndexError(f"pool write [{off}, {off + len(d)}) "
                             f"out of bounds")
        memoryview(self.buf)[off:off + len(d)] = d

    def readinto(self, off: int, dst) -> int:
        d = as_u8(dst)
        n = len(d)
        if off < 0 or off + n > self.size:
            raise IndexError(f"pool read [{off}, {off + n}) out of bounds")
        d[:] = memoryview(self.buf)[off:off + n]
        return n

    def memview(self, off: int, n: int) -> memoryview:
        if off < 0 or off + n > self.size:
            raise IndexError(f"pool view [{off}, {off + n}) out of bounds")
        return memoryview(self.buf)[off:off + n]


def pool_from_numpy(img: np.ndarray) -> LocalPool:
    """A LocalPool holding a copy of the pool image ``img`` (any uint8
    array of the pool's bytes, e.g. one the JAX package built): the
    port's ``Arena`` then opens the image's named objects and its
    ``SPSCQueue`` drains the messages queued in it."""
    flat = np.ascontiguousarray(img).reshape(-1).view(np.uint8)
    pool = LocalPool(flat.size)
    pool.buf[:] = flat
    return pool


class SharedMemoryPool(_Mapped, Pool):
    """Real shared memory between processes (CXL SHM host analogue).
    ``device="cuda"`` pins and maps the segment in THIS process; every
    process that moves device payloads maps it itself."""

    def __init__(self, size: int, name: str | None = None,
                 create: bool = True, device: str = "cpu"):
        if create:
            self.shm = shared_memory.SharedMemory(create=True, size=size,
                                                  name=name)
        else:
            self.shm = shared_memory.SharedMemory(name=name)
        self.size = self.shm.size
        self.name = self.shm.name
        self._created = create
        self._host_base = None
        if torch.device(device).type == "cuda":
            arr = np.frombuffer(self.shm.buf, dtype=np.uint8)
            host = arr.ctypes.data
            del arr                      # no buffer export outlives this
            rc = _lib().pool_host_register(ctypes.c_void_p(host),
                                           self.size)
            if rc != 0:
                raise RuntimeError(f"cudaHostRegister of the pool failed: "
                                   f"CUDA error {rc}")
            self._host_base = host
            self._dev_base = _mapped_device_pointer(host)

    def read(self, off: int, n: int) -> bytes:
        return bytes(self.shm.buf[off:off + n])

    def write(self, off: int, data) -> None:
        d = as_u8(data)
        self.shm.buf[off:off + len(d)] = d

    def readinto(self, off: int, dst) -> int:
        d = as_u8(dst)
        n = len(d)
        d[:] = self.shm.buf[off:off + n]
        return n

    def memview(self, off: int, n: int) -> memoryview:
        if off < 0 or off + n > self.size:
            raise IndexError(f"pool view [{off}, {off + n}) out of bounds")
        return self.shm.buf[off:off + n]

    def close(self) -> None:
        if self._host_base is not None:
            torch.cuda.synchronize()     # no kernel still reads the pool
            rc = _lib().pool_host_unregister(
                ctypes.c_void_p(self._host_base))
            self._host_base = None
            self._dev_base = None
            if rc != 0:
                raise RuntimeError(f"cudaHostUnregister failed: {rc}")
        self.shm.close()

    def unlink(self) -> None:
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


# --------------------------------------------------------------------------
# incoherent pool: per-rank write-back caches
# --------------------------------------------------------------------------

CACHELINE = 64


@dataclass
class CacheStats:
    loads: int = 0
    stores: int = 0
    hits: int = 0
    misses: int = 0
    flushes: int = 0            # lines written back + invalidated
    invalidates: int = 0        # lines dropped (clean or forced)
    fences: int = 0
    flushed_bytes: int = 0


@dataclass
class _Line:
    data: bytearray
    dirty: bool = False


class RankCache:
    """A private write-back cache overlay for one rank over a backing pool.

    Fully-associative over line addresses (a dict) — associativity games are
    not the point; VISIBILITY is: dirty lines are invisible to other ranks
    until flushed, and stale clean lines hide remote updates until
    invalidated. That is exactly the hazard the paper's §3.5 protocol
    (flush+fence after write, fence+flush before read) exists to fix.
    """

    def __init__(self, backing: Pool):
        self.backing = backing
        self.lines: dict[int, _Line] = {}
        self.stats = CacheStats()
        self.lock = threading.Lock()   # protects this rank's own structures

    # -- internals ---------------------------------------------------------
    def _line(self, base: int) -> _Line:
        ln = self.lines.get(base)
        if ln is None:
            self.stats.misses += 1
            ln = _Line(bytearray(self.backing.read(base, CACHELINE)))
            self.lines[base] = ln
        else:
            self.stats.hits += 1
        return ln

    @staticmethod
    def _span(off: int, n: int):
        first = off - off % CACHELINE
        last = (off + n - 1) - (off + n - 1) % CACHELINE
        return range(first, last + 1, CACHELINE)

    # -- cached access -----------------------------------------------------
    def load(self, off: int, n: int) -> bytes:
        out = bytearray(n)
        self.load_into(off, out)
        return bytes(out)

    def load_into(self, off: int, dst) -> int:
        d = as_u8(dst)
        n = len(d)
        with self.lock:
            self.stats.loads += 1
            for base in self._span(off, n):
                ln = self._line(base)
                s = max(off, base)
                e = min(off + n, base + CACHELINE)
                d[s - off:e - off] = ln.data[s - base:e - base]
            return n

    def store(self, off: int, data) -> None:
        d = as_u8(data)
        with self.lock:
            self.stats.stores += 1
            n = len(d)
            for base in self._span(off, n):
                ln = self._line(base)
                s = max(off, base)
                e = min(off + n, base + CACHELINE)
                ln.data[s - base:e - base] = d[s - off:e - off]
                ln.dirty = True

    # -- coherence ops (the paper's clflush/clflushopt + fence model) ------
    def flush(self, off: int, n: int) -> int:
        """Write back + invalidate every line covering [off, off+n).
        Returns number of lines flushed (timing model input)."""
        with self.lock:
            count = 0
            for base in self._span(off, n):
                ln = self.lines.pop(base, None)
                if ln is not None:
                    if ln.dirty:
                        self.backing.write(base, bytes(ln.data))
                    count += 1
            self.stats.flushes += count
            self.stats.flushed_bytes += count * CACHELINE
            return count

    def invalidate(self, off: int, n: int) -> int:
        """Drop lines without write-back (reader-side 'flush' of clean
        data). A dirty line here would LOSE data — in the paper's protocol
        readers only invalidate regions they do not own for writing; we
        write back defensively and count it."""
        with self.lock:
            count = 0
            for base in self._span(off, n):
                ln = self.lines.pop(base, None)
                if ln is not None:
                    if ln.dirty:
                        self.backing.write(base, bytes(ln.data))
                    count += 1
            self.stats.invalidates += count
            return count

    def fence(self) -> None:
        self.stats.fences += 1


class IncoherentPool(Pool):
    """Per-rank view of a backing pool through that rank's private cache."""

    def __init__(self, backing: Pool, cache: RankCache):
        self.backing = backing
        self.cache = cache
        self.size = backing.size

    def read(self, off: int, n: int) -> bytes:
        return self.cache.load(off, n)

    def write(self, off: int, data) -> None:
        self.cache.store(off, data)

    def readinto(self, off: int, dst) -> int:
        return self.cache.load_into(off, dst)

    # coherence surface
    def flush(self, off: int, n: int) -> int:
        return self.cache.flush(off, n)

    def invalidate(self, off: int, n: int) -> int:
        return self.cache.invalidate(off, n)

    def fence(self) -> None:
        self.cache.fence()
