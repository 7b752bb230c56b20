"""Start a cell's rank processes over the program's shared memory pool.

Each rank is a ``spawn``ed process that maps the program's
``SharedMemoryPool`` (a POSIX segment the pool itself names), builds the
program's ``Arena`` and ``Comm`` with the configuration's knobs, runs
``target(env, spec)`` and sends back what it returns. The launcher ends
every rank and unlinks the pool on every way out: success, a rank's
error, a rank that dies, and the time limit.
"""
from __future__ import annotations

import importlib
import multiprocessing as mp
import queue
import sys
import time
import traceback
from dataclasses import dataclass

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load:
    JAX and the JAX package, compared whole (``repro_torch`` is not
    ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


@dataclass
class Env:
    rank: int
    size: int
    arena: object
    comm: object


def _rank_main(pool_name: str, rank: int, size: int, target: str,
               spec: dict, comm_kw: dict, device: str, q) -> None:
    pool = None
    try:
        from repro_torch.core import Arena, Comm, SharedMemoryPool
        pool = SharedMemoryPool(0, name=pool_name, create=False,
                                device=device)
        arena = Arena(pool, rank, mode="coherent", initialize=False)
        comm = Comm(arena, rank, size, device=device, **comm_kw)
        mod, fn = target.rsplit(":", 1)
        out = getattr(importlib.import_module(mod), fn)(
            Env(rank, size, arena, comm), spec)
        out["forbidden_modules"] = forbidden_modules()
        q.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 - reported to the launcher
        q.put((rank, "err", traceback.format_exc()))
    finally:
        if pool is not None:
            pool.close()


def run_ranks(size: int, target: str, spec: dict, *, pool_bytes: int,
              comm_kw: dict, device: str, timeout: float) -> list[dict]:
    """Run ``target`` (``"module:function"``) on ``size`` ranks; returns
    their reports in rank order, or raises with the first rank's error.
    No rank process and no pool segment outlives the call."""
    from repro_torch.core import Arena, SharedMemoryPool
    pool = SharedMemoryPool(pool_bytes, create=True)
    procs: list = []
    try:
        Arena(pool, 0, mode="coherent", initialize=True)
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(pool.name, r, size, target, spec,
                                   comm_kw, device, q), daemon=True)
                 for r in range(size)]
        for p in procs:
            p.start()
        results: list = [None] * size
        errors: list = []
        deadline = time.monotonic() + timeout
        lost_at = None
        while sum(r is not None for r in results) + len(errors) < size:
            try:
                rank, status, payload = q.get(timeout=0.5)
            except queue.Empty:
                now = time.monotonic()
                dead = [r for r, p in enumerate(procs)
                        if results[r] is None and p.exitcode is not None]
                if dead:
                    lost_at = lost_at or now
                    if now - lost_at > 5.0:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no report")
                if now > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout:.0f} s")
                continue
            if status == "ok":
                results[rank] = payload
            else:
                errors.append((rank, payload))
                break                     # the others may wait forever
        if errors:
            raise RuntimeError(f"rank {errors[0][0]} failed:\n"
                               f"{errors[0][1]}")
        for p in procs:
            p.join(timeout=30)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        pool.close()
        pool.unlink()
