"""Multi-rank runtimes for the cMPI library.

* ``run_threads``  — N ranks as threads over ONE pool. With
  ``coherent=True`` the pool is a plain LocalPool (threads on one host are
  coherent, like processes on one x86 node). With ``coherent=False`` every
  rank gets a PRIVATE write-back cache over the shared backing pool — the
  executable model of the paper's non-coherent CXL platform; the
  software-coherence protocol in core/* is then load-bearing.

* ``run_processes`` — N ranks as real processes over a
  multiprocessing SharedMemoryPool. This is the measurement configuration
  for the OSU-style benchmarks (real memory fabric vs. real TCP sockets).

Both hand each rank a ``RankEnv`` whose ``comm`` is a v2 ``Comm``
(method collectives, split/dup, persistent requests); pass
``eager_threshold="auto"`` to have every rank micro-probe its
eager/rendezvous crossover at init. Both return per-rank results and
re-raise the first rank failure.

Both run on the card by default (``device="cuda"``): the pool is pinned
and mapped into the GPU in every rank, and CUDA tensors cross it through
the ``cellcopy`` kernel. Without a GPU they raise ``RuntimeError``; pass
``device="cpu"`` to run on the CPU. ``run_processes`` starts its ranks
with ``spawn`` (a CUDA context does not survive ``fork``), so a rank
program must be a module-level, picklable function, and should return
plain Python or CPU data.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.arena import Arena
from repro_torch.core.comm import Comm
from repro_torch.core.pool import IncoherentPool, LocalPool, Pool, RankCache, \
    SharedMemoryPool


@dataclass
class RankEnv:
    rank: int
    size: int
    arena: Arena
    comm: Comm


def _require_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: ranks run on the card by default; pass "
            "device='cpu' to run them on the CPU")


def _make_arena(pool: Pool, rank: int, coherent: bool,
                arena_kw: dict) -> Arena:
    if coherent:
        return Arena(pool, rank, mode="coherent",
                     initialize=(rank == 0), **arena_kw)
    cache = RankCache(pool)
    inc = IncoherentPool(pool, cache)
    return Arena(inc, rank, mode="incoherent",
                 initialize=(rank == 0), **arena_kw)


def run_threads(size: int, fn: Callable[[RankEnv], Any], *,
                pool_bytes: int = 8 << 20, coherent: bool = True,
                cell_size: int = 4096, n_cells: int = 8,
                eager_threshold: int | str | None = None,
                arena_kw: dict | None = None,
                comm_kw: dict | None = None,
                timeout: float = 60.0, device: str = "cuda") -> list[Any]:
    _require_device(device)
    pool = LocalPool(pool_bytes, device)
    arena_kw = arena_kw or {}
    comm_kw = comm_kw or {}
    results: list[Any] = [None] * size
    errors: list[tuple[int, BaseException, str]] = []
    gate = threading.Barrier(size)

    # rank 0 must initialize the arena before others map it
    arenas: list[Arena | None] = [None] * size
    arenas[0] = _make_arena(pool, 0, coherent, arena_kw)
    for r in range(1, size):
        arenas[r] = _make_arena(pool, r, coherent, arena_kw)

    def worker(rank: int):
        try:
            comm = Comm(arenas[rank], rank, size,
                        cell_size=cell_size, n_cells=n_cells,
                        eager_threshold=eager_threshold, device=device,
                        **comm_kw)
            gate.wait(timeout)
            results[rank] = fn(RankEnv(rank, size, arenas[rank], comm))
        except BaseException as e:  # noqa: BLE001 — reported to the caller
            errors.append((rank, e, traceback.format_exc()))

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    alive = [t for t in threads if t.is_alive()]
    if alive:
        raise TimeoutError(f"{len(alive)} ranks still running "
                           f"(deadlock?); errors so far: {errors}")
    if errors:
        rank, e, tb = errors[0]
        raise RuntimeError(f"rank {rank} failed:\n{tb}") from e
    return results


# --------------------------------------------------------------------------
# real processes over real shared memory
# --------------------------------------------------------------------------

def _proc_entry(shm_name: str, rank: int, size: int, fn, cell_size: int,
                n_cells: int, eager_threshold: int | str | None,
                arena_kw: dict, comm_kw: dict, q: mp.Queue, device: str):
    try:
        pool = SharedMemoryPool(0, name=shm_name, create=False,
                                device=device)
        arena = Arena(pool, rank, mode="coherent", initialize=False,
                      **arena_kw)
        comm = Comm(arena, rank, size, cell_size=cell_size,
                    n_cells=n_cells, eager_threshold=eager_threshold,
                    device=device, **comm_kw)
        out = fn(RankEnv(rank, size, arena, comm))
        pool.close()                     # unmaps the pool from the GPU
        q.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001
        q.put((rank, "err", traceback.format_exc()))


def run_processes(size: int, fn: Callable[[RankEnv], Any], *,
                  pool_bytes: int = 64 << 20,
                  cell_size: int = 16384, n_cells: int = 8,
                  eager_threshold: int | str | None = None,
                  arena_kw: dict | None = None,
                  comm_kw: dict | None = None,
                  timeout: float = 120.0, device: str = "cuda") -> list[Any]:
    _require_device(device)
    if torch.device(device).type == "cuda":
        # build the kernel library once, before the ranks race to it
        from repro_torch.kernels.build import build
        build()
    arena_kw = arena_kw or {}
    comm_kw = comm_kw or {}
    # the parent only writes host bytes: it never maps the pool
    pool = SharedMemoryPool(pool_bytes, create=True)
    procs: list = []
    try:
        # rank 0's arena initialization happens in the parent so children
        # never race on the header
        Arena(pool, 0, mode="coherent", initialize=True, **arena_kw)
        ctx = mp.get_context("spawn")
        q: mp.Queue = ctx.Queue()
        procs = [ctx.Process(target=_proc_entry,
                             args=(pool.name, r, size, fn, cell_size,
                                   n_cells, eager_threshold, arena_kw,
                                   comm_kw, q, device),
                             daemon=True)
                 for r in range(size)]
        for p in procs:
            p.start()
        results: list[Any] = [None] * size
        reported: set[int] = set()
        errs = []
        deadline = time.monotonic() + timeout
        lost_at = None
        while len(reported) < size:
            try:
                rank, status, payload = q.get(timeout=0.5)
            except queue.Empty:
                # a rank that died without a report (a crash in native
                # code, a signal) fails the run now, not at the timeout;
                # a short grace lets a report still in the pipe land
                dead = [r for r, p in enumerate(procs)
                        if r not in reported and p.exitcode is not None]
                now = time.monotonic()
                if dead:
                    lost_at = lost_at or now
                    if now - lost_at > 5.0:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                if now > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(size)) - reported)} "
                        f"still running after {timeout} s")
                continue
            reported.add(rank)
            if status == "ok":
                results[rank] = payload
            else:
                errs.append((rank, payload))
        for p in procs:
            p.join(timeout=10)
        if errs:
            raise RuntimeError(
                f"rank {errs[0][0]} failed:\n{errs[0][1]}")
        return results
    finally:
        for p in procs:                  # none outlives the call
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        pool.close()
        pool.unlink()
