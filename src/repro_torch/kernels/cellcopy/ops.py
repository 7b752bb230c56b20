"""Wrappers for the cellcopy kernel (``repro_torch/csrc/cellcopy.cu``).

A tensor on the CPU goes to the plain version in ``ref``; a tensor on the
card launches the kernel, and anything else raises. There is no fallback
from one to the other.

Two surfaces:

* ``cellcopy`` / ``copy_message`` / ``verify`` — the API of the JAX
  package's kernel (``repro.kernels.cellcopy``), cells of 128-word rows.
  The 128-word alignment is a TPU lane constraint kept so that cell
  layouts and test cases match.
* ``copy_bytes`` / ``copy_into`` — the byte-range copy the data plane
  uses: any pointers the card can address (device memory or the mapped
  pool), any alignment, any length.

``LAUNCHES`` counts kernel launches, so a run can show that its path went
through the kernel; ``thread_launches()`` counts the calling thread's, for
the ranks of ``run_threads``, which share one process. Every launch, and
every call of the plain version, charges ``work`` to an active counter
(``kernels.charged``); under the dry run's counter, meta tensors take the
``"meta"`` route, which launches nothing and returns empty outputs.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import COUNTERS, charge, charged, route
from repro_torch.kernels.cellcopy import ref

LANE = 128
THREADS = 256                    # CTA size of the kernel
VECTOR = 16                      # bytes a thread moves per load and store
SLICE_BYTES = THREADS * VECTOR   # a cell's bytes per CTA of its cluster
MAX_CLUSTER = 8                  # the portable thread-block cluster size
DEFAULT_CELL_BYTES = 16384       # data-plane checksum cell (16 KiB)
LAUNCHES = 0
_THREAD = threading.local()


def thread_launches() -> int:
    """Kernel launches made by the calling thread so far."""
    return getattr(_THREAD, "launches", 0)


def work(nbytes: int, cell_bytes: int) -> tuple[int, int]:
    """(flops, bytes) of one copy: no flops counted (the sums' adds are
    not tensor-core or FMA work worth a bound); ``nbytes`` read and
    written, and one u32 sum a cell written."""
    return 0, 2 * nbytes + 4 * -(-nbytes // cell_bytes)


def smem_bytes(block_cells: int, words: int) -> int:
    """Static shared memory one CTA claims: one u32 partial sum per warp
    for the CTA's reduce, and one u32 per CTA of a cluster, of which rank
    0's copy receives every CTA's partial through distributed shared
    memory. Cells stream through registers, so it depends on neither
    ``block_cells`` nor ``words`` (the TPU kernel's VMEM working set
    did)."""
    return (THREADS // 32) * 4 + MAX_CLUSTER * 4


def cluster_size(nbytes: int, cell_bytes: int) -> int:
    """CTAs per cell, all in one cluster: one per ``SLICE_BYTES`` of the
    longest cell of the launch, 1 to ``MAX_CLUSTER``."""
    longest = min(cell_bytes, nbytes)
    return max(1, min(MAX_CLUSTER, -(-longest // SLICE_BYTES)))


def launch_plan(nbytes: int, cell_bytes: int, dst_mod16: int = 0,
                src_mod16: int = 0) -> dict:
    """The kernel's launch and work split for ``nbytes`` from a source at
    ``src_mod16`` to a destination at ``dst_mod16`` (mod 16), as
    ``csrc/cellcopy.cu`` computes them. Returns ``grid`` (CTAs),
    ``cluster`` (CTAs per cell), ``threads``, ``smem_bytes`` and
    ``ctas``: per CTA its ``cell``, its ``rank`` in the cluster, the
    message byte ranges it copies (``head``, ``body`` and ``tail``, each
    ``(lo, hi)`` or None) and the source's misalignment ``shift`` (0: the
    aligned path, else the funnel-shift path). A cell's 16 B vectors to
    aligned destinations are cut into ``cluster`` slices; rank 0 also
    copies the head bytes before the first aligned destination, the last
    rank the tail after the last whole vector."""
    if nbytes <= 0 or cell_bytes <= 0 or cell_bytes % 4:
        raise ValueError(f"launch_plan: nbytes={nbytes} "
                         f"cell_bytes={cell_bytes}")
    n_cells = -(-nbytes // cell_bytes)
    k = cluster_size(nbytes, cell_bytes)
    ctas = []
    for c in range(n_cells):
        s = c * cell_bytes
        ln = min(cell_bytes, nbytes - s)
        head = min((VECTOR - (dst_mod16 + s) % VECTOR) % VECTOR, ln)
        nvec = (ln - head) // VECTOR
        tail0 = head + VECTOR * nvec
        per = -(-nvec // k)
        shift = (src_mod16 + s + head) % VECTOR
        for rank in range(k):
            v0 = min(rank * per, nvec)
            v1 = min(v0 + per, nvec)
            ctas.append({
                "cell": c, "rank": rank, "shift": shift,
                "head": (s, s + head) if rank == 0 and head else None,
                "body": ((s + head + VECTOR * v0, s + head + VECTOR * v1)
                         if v1 > v0 else None),
                "tail": ((s + tail0, s + ln)
                         if rank == k - 1 and ln > tail0 else None)})
    return {"grid": n_cells * k, "cluster": k, "threads": THREADS,
            "smem_bytes": smem_bytes(1, LANE), "ctas": ctas}


_SCRATCH: dict = {}
_LIB = None


def _lib():
    """The kernel library, built and loaded at first use."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.build import load
        _LIB = load()
    return _LIB


def _scratch_sums(n_cells: int) -> torch.Tensor:
    """Per-device sums scratch, grown on demand. Launches are ordered on
    one stream, so reusing it between them is safe."""
    dev = torch.cuda.current_device()
    t = _SCRATCH.get(dev)
    if t is None or t.numel() < n_cells:
        t = torch.empty(max(n_cells, 1024), dtype=torch.uint32,
                        device=f"cuda:{dev}")
        _SCRATCH[dev] = t
    return t


def copy_bytes(dst_ptr: int, src_ptr: int, nbytes: int, cell_bytes: int,
               sums_out: torch.Tensor | None, *,
               block_cells: int = 1) -> None:
    """Launch the kernel on raw device addresses: ``nbytes`` from
    ``src_ptr`` to ``dst_ptr``, and the sum of each ``cell_bytes`` cell
    into ``sums_out`` (a CUDA uint32/int32 tensor of at least
    ceil(nbytes / cell_bytes) elements). With ``sums_out=None`` the sums
    go to a scratch tensor reused across launches: the data plane's wire
    format has no field for them, but the kernel does the same work on
    every path. Runs on PyTorch's current stream and does not
    synchronise. The CTA layout follows the bytes (``launch_plan``);
    ``block_cells`` is only checked."""
    global LAUNCHES
    if nbytes < 0 or cell_bytes <= 0 or cell_bytes % 4 or block_cells < 1:
        raise ValueError(f"copy_bytes: bad nbytes={nbytes} "
                         f"cell_bytes={cell_bytes} block_cells={block_cells}")
    if nbytes == 0:
        return
    n_cells = -(-nbytes // cell_bytes)
    if sums_out is None:
        sums_out = _scratch_sums(n_cells)
    elif not (sums_out.is_cuda and sums_out.is_contiguous()
              and sums_out.dtype in (torch.uint32, torch.int32)
              and sums_out.numel() >= n_cells):
        raise ValueError("copy_bytes: sums_out must be a contiguous "
                         f"CUDA u32 tensor of >= {n_cells} elements")
    if COUNTERS:                     # the launch runs no torch op to pause
        charge("cellcopy", *work(nbytes, cell_bytes))
    rc = _lib().cellcopy_bytes(
        ctypes.c_void_p(dst_ptr), ctypes.c_void_p(src_ptr), nbytes,
        cell_bytes, block_cells, ctypes.c_void_p(sums_out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    LAUNCHES += 1
    _THREAD.launches = thread_launches() + 1
    if rc != 0:
        raise RuntimeError(f"cellcopy launch failed: CUDA error {rc}")


def _flat_u8(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-D uint8 tensor")
    return t


def copy_into(dst: torch.Tensor, src: torch.Tensor,
              cell_bytes: int = DEFAULT_CELL_BYTES) -> torch.Tensor:
    """``dst[:] = src`` for flat uint8 tensors of equal length; returns
    the per-cell sums (uint32). On the card this launches the kernel and
    does not synchronise."""
    _flat_u8(dst, "dst")
    _flat_u8(src, "src")
    if dst.numel() != src.numel():
        raise ValueError(f"copy_into: {dst.numel()}B <- {src.numel()}B")
    where = route("cellcopy", dst, src)
    if where == "cpu":
        with charged("cellcopy", *work(src.numel(), cell_bytes)):
            return ref.copy_bytes_ref(dst, src, cell_bytes)
    n_cells = -(-src.numel() // cell_bytes)
    sums = torch.empty(n_cells, dtype=torch.uint32, device=dst.device)
    if where == "meta":
        with charged("cellcopy", *work(src.numel(), cell_bytes)):
            return sums
    copy_bytes(dst.data_ptr(), src.data_ptr(), src.numel(), cell_bytes,
               sums)
    return sums


def cellcopy(src: torch.Tensor, block_cells: int = 8):
    """Copy ``(n_cells, words)`` int32 cells; returns ``(dst, sums)`` with
    ``sums`` the wrapping u32 sum of each cell."""
    if src.dtype != torch.int32 or src.dim() != 2 \
            or not src.is_contiguous():
        raise ValueError("cellcopy: src must be a contiguous 2-D int32 "
                         "tensor")
    n_cells, words = src.shape
    if n_cells % block_cells:
        raise ValueError(f"n_cells {n_cells} not a multiple of "
                         f"block_cells {block_cells}")
    if words % LANE:
        raise ValueError(f"cell words {words} not {LANE}-aligned")
    where = route("cellcopy", src)
    if where == "cpu":
        with charged("cellcopy", *work(n_cells * words * 4, words * 4)):
            return ref.cellcopy_ref(src)
    dst = torch.empty_like(src)
    sums = torch.empty(n_cells, dtype=torch.uint32, device=src.device)
    if where == "meta":
        with charged("cellcopy", *work(n_cells * words * 4, words * 4)):
            return dst, sums
    copy_bytes(dst.data_ptr(), src.data_ptr(), n_cells * words * 4,
               words * 4, sums, block_cells=block_cells)
    return dst, sums


def _cell_layout(n: int, cell_bytes: int, block_cells: int):
    words = cell_bytes // 4
    words += (-words) % LANE
    cell_bytes = words * 4
    n_cells = -(-n // cell_bytes)
    n_cells += (-n_cells) % block_cells
    return cell_bytes, n_cells


def copy_message(buf, cell_bytes: int = 16384, block_cells: int = 8):
    """Copy a flat uint8 message through cell-granular kernel copies.
    Returns ``(copy of the message, sums)``: one sum per cell of the
    message zero-padded to whole lane-aligned cells and to a multiple of
    ``block_cells`` cells, as the JAX package's ``copy_message`` gives.
    On the card the kernel copies the message as it stands: the ragged
    tail adds zeros to its cell's sum, and whole padding cells keep the
    zero their sum starts at."""
    buf = _flat_u8(torch.as_tensor(buf, dtype=torch.uint8), "buf")
    n = buf.numel()
    cell_bytes, n_cells = _cell_layout(n, cell_bytes, block_cells)
    where = route("cellcopy", buf)
    if where == "cpu":
        with charged("cellcopy", *work(n, cell_bytes)):
            return buf.clone(), ref.cell_sums_ref(buf, cell_bytes, n_cells)
    out = torch.empty_like(buf)
    sums = torch.zeros(n_cells, dtype=torch.int32, device=buf.device)
    if where == "meta":
        with charged("cellcopy", *work(n, cell_bytes)):
            return out, sums.view(torch.uint32)
    copy_bytes(out.data_ptr(), buf.data_ptr(), n, cell_bytes, sums,
               block_cells=block_cells)
    return out, sums.view(torch.uint32)


def verify(cells: torch.Tensor, sums: torch.Tensor) -> bool:
    """Consumer-side validity check: recompute each cell's sum."""
    expect = ref.row_sums(cells)
    return bool(torch.equal(expect.view(torch.int32),
                            sums.view(torch.int32)))
