"""Synchronization without cross-host atomics (paper §3.4).

* SeqBarrier — the paper's refactored init barrier: no shared counter
  (which needs atomic increment); instead a per-rank sequence-number array.
  Entering rank r increments ITS OWN slot and spin-waits until every other
  slot is >= its own sequence. Single writer per slot => plain stores +
  coherence protocol suffice.

* PSCW — Post-Start-Complete-Wait epochs as flag matrices in shared memory
  (one flag per (origin, target) pair, each written by exactly one rank and
  reset by exactly the other after observation — again single-writer-
  per-phase). Replaces the network notification messages of stock MPICH.

* BakeryLock — Lamport's bakery: mutual exclusion from per-rank
  single-writer slots only. Used for MPI_Win_lock(EXCLUSIVE) and arena
  mutations. MPI_Win_lock(SHARED) adds per-rank reader flags.

All memory goes through a CoherentView, so the same code is correct on an
incoherent (CXL-like) pool.
"""
from __future__ import annotations

import time

from repro_torch.core.coherence import CoherentView

_SPIN_SLEEP = 0.0


class SeqBarrier:
    """Per-rank sequence-number barrier. Region: u64[n_ranks]."""

    def __init__(self, view: CoherentView, base: int, n_ranks: int, rank: int,
                 *, initialize: bool = False):
        self.view = view
        self.base = base
        self.n = n_ranks
        self.rank = rank
        self.seq = 0
        if initialize:
            for i in range(n_ranks):
                view.nt_store_u64(base + 8 * i, 0)

    @staticmethod
    def region_bytes(n_ranks: int) -> int:
        return 8 * n_ranks

    def wait(self, timeout: float | None = 30.0) -> None:
        self.seq += 1
        self.view.nt_store_u64(self.base + 8 * self.rank, self.seq)
        t0 = time.monotonic()
        for j in range(self.n):
            if j == self.rank:
                continue
            while self.view.nt_load_u64(self.base + 8 * j) < self.seq:
                if timeout is not None and time.monotonic() - t0 > timeout:
                    raise TimeoutError(
                        f"barrier timeout: rank {j} stuck below seq "
                        f"{self.seq}")
                time.sleep(_SPIN_SLEEP)


class PSCW:
    """Post-Start-Complete-Wait epoch flags.

    Region layout (u8 matrices, row-major [owner][peer]):
      post_flag[origin][target] : set by TARGET's post, cleared by ORIGIN's
                                  start once observed.
      comp_flag[target][origin] : set by ORIGIN's complete, cleared by
                                  TARGET's wait once observed.
    """

    def __init__(self, view: CoherentView, base: int, n_ranks: int, rank: int,
                 *, initialize: bool = False):
        self.view = view
        self.base = base
        self.n = n_ranks
        self.rank = rank
        if initialize:
            view.write_release(base, bytes(2 * n_ranks * n_ranks))

    @staticmethod
    def region_bytes(n_ranks: int) -> int:
        return 2 * n_ranks * n_ranks

    def _post_off(self, origin: int, target: int) -> int:
        return self.base + origin * self.n + target

    def _comp_off(self, target: int, origin: int) -> int:
        return self.base + self.n * self.n + target * self.n + origin

    # -- target side --------------------------------------------------
    def post(self, origin_group: list[int]) -> None:
        """Target exposes its window to each origin in the group."""
        for o in origin_group:
            self.view.write_release(self._post_off(o, self.rank), b"\x01")

    def wait(self, origin_group: list[int],
             timeout: float | None = 30.0) -> None:
        """Target waits for every origin's complete, consuming the flags."""
        t0 = time.monotonic()
        for o in origin_group:
            off = self._comp_off(self.rank, o)
            while self.view.read_acquire(off, 1) != b"\x01":
                if timeout is not None and time.monotonic() - t0 > timeout:
                    raise TimeoutError(f"PSCW wait: origin {o}")
                time.sleep(_SPIN_SLEEP)
            self.view.write_release(off, b"\x00")

    # -- origin side --------------------------------------------------
    def start(self, target_group: list[int],
              timeout: float | None = 30.0) -> None:
        """Origin waits for each target's post, consuming the flags."""
        t0 = time.monotonic()
        for t in target_group:
            off = self._post_off(self.rank, t)
            while self.view.read_acquire(off, 1) != b"\x01":
                if timeout is not None and time.monotonic() - t0 > timeout:
                    raise TimeoutError(f"PSCW start: target {t}")
                time.sleep(_SPIN_SLEEP)
            self.view.write_release(off, b"\x00")

    def complete(self, target_group: list[int]) -> None:
        for t in target_group:
            self.view.write_release(self._comp_off(t, self.rank), b"\x01")


class BakeryLock:
    """Lamport bakery lock over [choosing u8[n] | pad | number u64[n]]."""

    def __init__(self, view: CoherentView, base: int, n_ranks: int, rank: int,
                 *, initialize: bool = False):
        self.view = view
        self.base = base
        self.n = n_ranks
        self.rank = rank
        self._num_off = base + ((n_ranks + 63) // 64) * 64
        if initialize:
            view.write_release(base, bytes(self.region_bytes(n_ranks)))

    @staticmethod
    def region_bytes(n_ranks: int) -> int:
        return ((n_ranks + 63) // 64) * 64 + 8 * n_ranks

    def acquire(self, timeout: float | None = 30.0) -> None:
        v, r = self.view, self.rank
        v.nt_store_u8(self.base + r, 1)
        mx = 0
        for j in range(self.n):
            mx = max(mx, v.nt_load_u64(self._num_off + 8 * j))
        my = mx + 1
        v.nt_store_u64(self._num_off + 8 * r, my)
        v.nt_store_u8(self.base + r, 0)
        t0 = time.monotonic()
        for j in range(self.n):
            if j == r:
                continue
            while v.nt_load_u8(self.base + j):
                if timeout is not None and time.monotonic() - t0 > timeout:
                    raise TimeoutError("bakery: choosing stuck")
                time.sleep(_SPIN_SLEEP)
            while True:
                nj = v.nt_load_u64(self._num_off + 8 * j)
                if nj == 0 or (nj, j) > (my, r):
                    break
                if timeout is not None and time.monotonic() - t0 > timeout:
                    raise TimeoutError("bakery: ticket stuck")
                time.sleep(_SPIN_SLEEP)

    def release(self) -> None:
        self.view.nt_store_u64(self._num_off + 8 * self.rank, 0)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class RWLock:
    """Shared/exclusive lock: bakery for writers + per-rank reader flags.

    Region: [bakery | reader u8[n] (64-aligned)].
    Readers: take bakery briefly to set their flag only if consistent —
    simplified: reader sets flag, then checks writer ticket; if a writer
    holds the bakery, reader backs off. Writer: bakery acquire, then waits
    for all reader flags to clear.
    """

    def __init__(self, view: CoherentView, base: int, n_ranks: int, rank: int,
                 *, initialize: bool = False):
        self.view = view
        self.n = n_ranks
        self.rank = rank
        self.bakery = BakeryLock(view, base, n_ranks, rank,
                                 initialize=initialize)
        self._rd_off = base + BakeryLock.region_bytes(n_ranks)
        self._rd_off += (-self._rd_off) % 64
        if initialize:
            view.write_release(self._rd_off, bytes(n_ranks))

    @staticmethod
    def region_bytes(n_ranks: int) -> int:
        b = BakeryLock.region_bytes(n_ranks)
        b += (-b) % 64
        return b + n_ranks

    def acquire_shared(self, timeout: float | None = 30.0) -> None:
        # serialize flag-set against writers via the bakery, then release it:
        # readers only conflict with writers, not each other.
        self.bakery.acquire(timeout=timeout)
        self.view.write_release(self._rd_off + self.rank, b"\x01")
        self.bakery.release()

    def release_shared(self) -> None:
        self.view.write_release(self._rd_off + self.rank, b"\x00")

    def acquire_excl(self, timeout: float | None = 30.0) -> None:
        self.bakery.acquire(timeout=timeout)
        t0 = time.monotonic()
        for j in range(self.n):
            if j == self.rank:
                continue
            while self.view.read_acquire(self._rd_off + j, 1) != b"\x00":
                if timeout is not None and time.monotonic() - t0 > timeout:
                    self.bakery.release()
                    raise TimeoutError("RWLock: reader stuck")
                time.sleep(_SPIN_SLEEP)

    def release_excl(self) -> None:
        self.bakery.release()
