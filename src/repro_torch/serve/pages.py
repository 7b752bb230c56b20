"""Rank-sharded KV/page cache over pool-resident dynamic-window pages.

Each rank owns ``n_slots`` fixed-size pages allocated straight from the
comm's pool (``comm.alloc_buffer``) and attached to a shared
``DynamicWindow`` — no copy into a window arena, the pool buffer IS the
window segment (satellite 2's ``Win_attach`` model).  A page therefore
has one global name: the absolute pool offset its home rank attached.

Page movement is strictly one-sided against a PASSIVE home:

  fill   ``win.rput(home, addr, page)``   — origin-counted ``rma_put``
  fetch  ``win.rget(home, addr, dst)``    — origin-counted ``rma_get``

(``page`` and ``dst`` are uint8 tensors on the worker's device; on the
card their bytes cross the pool through the ``cellcopy`` kernel.)

The home rank executes nothing and copies nothing (zero receiver-side
drain; the serve bench asserts this through
``ProtocolStats.path_copied_bytes``).  Because the pages live in the
shared pool, they even outlive their home RANK: a worker that
fail-stops mid-decode leaves every page it hosted readable by rget
until the buffers are freed at teardown — the CXL-pool property the
paper builds on.
"""
from __future__ import annotations

import numpy as np


class PageStore:
    """This rank's shard of the page cache: pool buffers + attachments."""

    def __init__(self, comm, win, n_slots: int, page_bytes: int):
        self.comm = comm
        self.win = win
        self.page_bytes = int(page_bytes)
        self.bufs = [comm.alloc_buffer(page_bytes) for _ in range(n_slots)]
        self.addrs = [win.attach(b) for b in self.bufs]

    @property
    def n_slots(self) -> int:
        return len(self.bufs)

    def write_local(self, slot: int, data) -> None:
        """Fill a locally-homed page (one counted local copy)."""
        self.bufs[slot].write(data)

    def read_local_into(self, slot: int, dst) -> None:
        """Drain a locally-homed page into ``dst``, a tensor on any device
        (one counted local copy; the JAX package's ``read_local`` returns
        the bytes instead)."""
        self.comm.arena.view.read_acquire_into(self.bufs[slot].offset, dst)

    def free(self) -> None:
        """Detach and release every page. Collective discipline is the
        caller's: no peer may still be rget-ing these pages."""
        for a in self.addrs:
            self.win.detach(a)
        for b in self.bufs:
            b.free()
        self.bufs = []
        self.addrs = []


class PageDirectory:
    """Global slot -> absolute-address table, allgathered once at
    startup (every rank attaches the same slot count, so the table is
    rectangular).  After this one collective, page addressing is pure
    local arithmetic — the serve hot loop never asks anyone where a
    page lives."""

    def __init__(self, comm, store: PageStore):
        mine = np.asarray(store.addrs, dtype=np.int64)
        flat = comm.allgather(mine)      # a CPU tensor: host addresses
        self.table = flat.numpy().reshape(comm.size, -1)
        self.page_bytes = store.page_bytes

    def addr(self, home: int, slot: int) -> int:
        return int(self.table[home, slot])
