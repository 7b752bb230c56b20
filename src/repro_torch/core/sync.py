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

from repro_torch.core.coherence import CoherentView
from repro_torch.core.wait import spin


def _spin_peers(peers, ready, timeout: float | None, what) -> None:
    """Spin until ``ready(j)`` holds for each of ``peers`` in turn, under
    one deadline; ``what(j)`` names the peer a timeout found stuck."""
    left = list(peers)[::-1]

    def all_ready() -> bool:
        while left and ready(left[-1]):
            left.pop()
        return not left

    spin(all_ready, timeout, lambda: what(left[-1]))


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
        _spin_peers(
            (j for j in range(self.n) if j != self.rank),
            lambda j: self.view.nt_load_u64(self.base + 8 * j) >= self.seq,
            timeout, lambda j: f"barrier timeout: rank {j} stuck below "
                               f"seq {self.seq}")


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
        _spin_peers(origin_group,
                    lambda o: self._consume(self._comp_off(self.rank, o)),
                    timeout, lambda o: f"PSCW wait: origin {o}")

    # -- origin side --------------------------------------------------
    def start(self, target_group: list[int],
              timeout: float | None = 30.0) -> None:
        """Origin waits for each target's post, consuming the flags."""
        _spin_peers(target_group,
                    lambda t: self._consume(self._post_off(self.rank, t)),
                    timeout, lambda t: f"PSCW start: target {t}")

    def _consume(self, off: int) -> bool:
        """Clear the flag at ``off`` if it is raised; whether it was."""
        if self.view.read_acquire(off, 1) != b"\x01":
            return False
        self.view.write_release(off, b"\x00")
        return True

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
        v, r, n, base, num = (self.view, self.rank, self.n, self.base,
                              self._num_off)
        v.nt_store_u8(base + r, 1)
        mx = 0
        for j in range(n):
            mx = max(mx, v.nt_load_u64(num + 8 * j))
        my = mx + 1
        v.nt_store_u64(num + 8 * r, my)
        v.nt_store_u8(base + r, 0)
        # each other rank in turn: wait out its choosing flag, then its
        # smaller ticket, in one closure (the arena's create and destroy
        # take this lock)
        j, ticket = 0, False         # ticket: j's choosing flag seen down

        def ours() -> bool:
            nonlocal j, ticket
            for j in range(j, n):
                if j == r:
                    continue
                if not ticket and v.nt_load_u8(base + j):
                    return False
                ticket = True
                nj = v.nt_load_u64(num + 8 * j)
                if nj and (nj, j) < (my, r):
                    return False
                ticket = False
            return True

        spin(ours, timeout, lambda: "bakery: ticket stuck" if ticket
             else "bakery: choosing stuck")

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
        try:
            _spin_peers(
                (j for j in range(self.n) if j != self.rank),
                lambda j: self.view.read_acquire(self._rd_off + j, 1)
                == b"\x00",
                timeout, lambda j: "RWLock: reader stuck")
        except TimeoutError:
            self.bakery.release()
            raise

    def release_excl(self) -> None:
        self.bakery.release()
