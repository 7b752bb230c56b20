"""SPSC message ring queues + the pairwise queue matrix (paper §3.3).

CXL pooled memory cannot provide cross-host atomic RMW, so MPICH's MPSC /
MPMC lock-free queues (CAS-based) do not work. The paper's fix: one
Single-Producer Single-Consumer ring queue PER (sender, receiver) PAIR.
Enqueue is executed only by the producer (owns ``tail``), dequeue only by
the consumer (owns ``head``) — every control word has exactly one writer,
so plain stores + the coherence protocol suffice.

Queue region layout (cacheline-separated control words to avoid false
sharing; control words use non-temporal access per §3.5):

  0:8     tail   (producer-owned: next cell to fill)
  64:72   head   (consumer-owned: next cell to drain)
  128:    cells  n_cells x cell_stride
            cell: [len u32 | flags u32 | payload cell_size]

Messages larger than ``cell_size`` are split into cell-sized chunks sent
sequentially (paper §4.3 studies the cell-size threshold; default 16 KB,
optimal 64 KB — reproduced in benchmarks/fig9_cellsize.py).

Zero-copy framing: ``try_enqueue_parts`` gathers a header plus any number
of buffer-protocol slices straight into the cell (no intermediate bytes
concatenation), and ``try_dequeue_into`` drains a cell's payload directly
into a caller buffer. Parts and destinations may be CUDA tensors: their
bytes cross through the cellcopy kernel (see ``coherence``), and the
cells stay byte-identical to the JAX package's. ``FLAG_RNDV`` marks a cell that carries a rendezvous
control descriptor instead of payload (see core/pt2pt.py): large messages
bypass the cell pipeline entirely via a pool-resident staging object.
"""
from __future__ import annotations

from repro_torch.core.coherence import CoherentView
from repro_torch.core.pool import CACHELINE, as_u8, copy_bytes_into
from repro_torch.core.wait import spin

_T_TAIL = 0
_T_HEAD = 64
_CELLS = 128

FLAG_FIRST = 1      # first chunk of a message (payload starts with header)
FLAG_LAST = 2
FLAG_RNDV = 4       # cell holds a rendezvous descriptor, not payload
FLAG_POSTED = 8     # rendezvous payload already sits in a RECEIVER-posted
                    # buffer (matchbox entry); descriptor names the entry

DEFAULT_CELL_SIZE = 16 * 1024      # MPICH default (paper §4.3)
OPTIMAL_CELL_SIZE = 64 * 1024      # paper's tuned value

# tags at or above this value are RESERVED for internal traffic (the
# canonical definition — ``repro_torch.core.pt2pt`` re-exports it with the
# full tag-space map; it lives here, in the wire framing layer, so the
# queue's own user-facing send surface can validate without importing
# the communicator above it)
TAG_RESERVED_BASE = 0x7E000000


def cell_stride(cell_size: int) -> int:
    s = 8 + cell_size
    return s + (-s) % CACHELINE


def queue_bytes(cell_size: int, n_cells: int) -> int:
    return _CELLS + n_cells * cell_stride(cell_size)


def _spin_take(poll, timeout: float | None):
    """The first ``poll()`` that finds a cell (is not None)."""
    got = None

    def ready() -> bool:
        nonlocal got
        got = poll()
        return got is not None

    spin(ready, timeout, lambda: "SPSC dequeue timed out")
    return got


class SPSCQueue:
    """One direction of one (sender, receiver) pair.

    The producer instantiates with ``producer=True`` and only enqueues; the
    consumer with ``producer=False`` and only dequeues. Both sides may be
    instantiated in different processes mapping the same pool region.
    """

    def __init__(self, view: CoherentView, base: int, cell_size: int,
                 n_cells: int, *, producer: bool, initialize: bool = False):
        self.view = view
        self.base = base
        self.cell_size = cell_size
        self.n_cells = n_cells
        self.stride = cell_stride(cell_size)
        self.producer = producer
        if initialize:
            view.nt_store_u64(base + _T_TAIL, 0)
            view.nt_store_u64(base + _T_HEAD, 0)
        # the owned index is cached locally (single writer => local copy is
        # authoritative); the foreign index is always nt-loaded.
        self._local_idx = view.nt_load_u64(
            base + (_T_TAIL if producer else _T_HEAD))

    # ---------------- producer ----------------
    def try_enqueue_parts(self, parts, flags: int = 0) -> bool:
        """Gather-enqueue: write each buffer-protocol part straight into
        the cell back-to-back — framing never concatenates into an
        intermediate ``bytes``. The tail is published only after every
        part is flushed (store-release ordering preserved)."""
        assert self.producer
        views = [as_u8(p) for p in parts]
        n = sum(len(v) for v in views)
        assert n <= self.cell_size
        tail = self._local_idx
        head = self.view.nt_load_u64(self.base + _T_HEAD)
        if tail - head >= self.n_cells:
            return False                       # full
        cell = self.base + _CELLS + (tail % self.n_cells) * self.stride
        self.view.write_release_gather(
            cell,
            (n.to_bytes(4, "little") + flags.to_bytes(4, "little"), *views))
        # publish AFTER the cell is flushed (store-release ordering)
        self._local_idx = tail + 1
        self.view.nt_store_u64(self.base + _T_TAIL, tail + 1)
        return True

    def try_enqueue(self, payload, flags: int = 0) -> bool:
        return self.try_enqueue_parts((payload,), flags)

    def enqueue(self, payload, flags: int = 0,
                timeout: float | None = None) -> None:
        self.enqueue_parts((payload,), flags, timeout=timeout)

    def enqueue_parts(self, parts, flags: int = 0,
                      timeout: float | None = None) -> None:
        spin(lambda: self.try_enqueue_parts(parts, flags), timeout,
             lambda: "SPSC enqueue timed out")

    # ---------------- consumer ----------------
    def try_dequeue(self, into=None) -> tuple[bytes, int] | None:
        """Drain one cell: (payload, flags), or None if the queue is
        empty. ``into`` (a writable host buffer of >= cell_size bytes)
        receives the payload instead of a new ``bytes``, which is then a
        view of it — the same one counted copy; a pinned ``into`` lets
        the cellcopy kernel move the payload on to the card."""
        assert not self.producer
        head = self._local_idx
        tail = self.view.nt_load_u64(self.base + _T_TAIL)
        if head >= tail:
            return None                        # empty
        cell = self.base + _CELLS + (head % self.n_cells) * self.stride
        hdr = self.view.read_acquire(cell, 8)
        n = int.from_bytes(hdr[:4], "little")
        flags = int.from_bytes(hdr[4:], "little")
        if into is None:
            payload = self.view.read_acquire(cell + 8, n) if n else b""
        else:
            payload = as_u8(into)[:n]
            if n:
                self.view.read_acquire_into(cell + 8, payload)
        self._local_idx = head + 1
        self.view.nt_store_u64(self.base + _T_HEAD, head + 1)
        return payload, flags

    def try_dequeue_into(self, dst) -> tuple[int, int] | None:
        """Drain one cell's payload straight into ``dst`` (writable
        buffer). Returns (nbytes, flags), or None if the queue is empty.
        Raises ValueError if the cell's payload exceeds ``dst``."""
        assert not self.producer
        head = self._local_idx
        tail = self.view.nt_load_u64(self.base + _T_TAIL)
        if head >= tail:
            return None                        # empty
        cell = self.base + _CELLS + (head % self.n_cells) * self.stride
        hdr = self.view.read_acquire(cell, 8)
        n = int.from_bytes(hdr[:4], "little")
        flags = int.from_bytes(hdr[4:], "little")
        d = as_u8(dst)
        if n > len(d):
            raise ValueError(f"dequeue_into: cell holds {n}B but dst "
                             f"has room for {len(d)}B")
        if n:
            self.view.read_acquire_into(cell + 8, d[:n])
        self._local_idx = head + 1
        self.view.nt_store_u64(self.base + _T_HEAD, head + 1)
        return n, flags

    def dequeue(self, timeout: float | None = None) -> tuple[bytes, int]:
        return _spin_take(self.try_dequeue, timeout)

    def dequeue_into(self, dst, timeout: float | None = None
                     ) -> tuple[int, int]:
        return _spin_take(lambda: self.try_dequeue_into(dst), timeout)

    # ---------------- message framing (chunked, paper §4.3) ----------------
    # first chunk payload: [total_len u64 | tag u64 | data...]
    _MSG_HDR = 16

    def plan_message(self, mv: memoryview, tag: int = 0):
        """Yield one (parts, flags) tuple per cell for framing ``mv`` —
        the single source of truth for the wire layout, shared by
        ``send_message`` and the communicator's eager send generator."""
        total = len(mv)
        first_room = self.cell_size - self._MSG_HDR
        hdr = (total.to_bytes(8, "little") + int(tag).to_bytes(8, "little"))
        yield ((hdr, mv[:first_room]),
               FLAG_FIRST | (FLAG_LAST if total <= first_room else 0))
        for i in range(first_room, total, self.cell_size):
            yield ((mv[i:i + self.cell_size],),
                   FLAG_LAST if i + self.cell_size >= total else 0)

    def send_message(self, data, tag: int = 0,
                     timeout: float | None = None) -> int:
        """Chunk ``data`` (any buffer-protocol object) into cells via
        zero-copy views; returns number of cells used. User-facing:
        reserved tags are rejected (internal traffic frames through
        ``plan_message`` + ``enqueue_parts`` directly)."""
        if int(tag) >= TAG_RESERVED_BASE:
            raise ValueError(f"tag {tag:#x} is in the reserved internal "
                             f"range (>= {TAG_RESERVED_BASE:#x})")
        cells = 0
        for parts, flags in self.plan_message(as_u8(data), tag):
            self.enqueue_parts(parts, flags, timeout=timeout)
            cells += 1
        return cells

    def recv_message(self, timeout: float | None = None) -> tuple[bytes, int]:
        payload, flags = self.dequeue(timeout=timeout)
        if not flags & FLAG_FIRST:
            raise RuntimeError("SPSC framing error: expected FIRST chunk")
        total = int.from_bytes(payload[:8], "little")
        tag = int.from_bytes(payload[8:16], "little")
        out = bytearray(total)
        mv = memoryview(out)
        got = min(len(payload) - 16, total)
        mv[:got] = payload[16:16 + got]
        self.view.count_copy(got)
        while got < total:
            n, _fl = self.dequeue_into(mv[got:], timeout=timeout)
            got += n
        return bytes(out), tag

    def recv_message_into(self, dst, timeout: float | None = None
                          ) -> tuple[int, int]:
        """Receive the next message straight into ``dst``; returns
        (nbytes, tag). Raises ValueError if ``dst`` is too small."""
        payload, flags = self.dequeue(timeout=timeout)
        if not flags & FLAG_FIRST:
            raise RuntimeError("SPSC framing error: expected FIRST chunk")
        total = int.from_bytes(payload[:8], "little")
        tag = int.from_bytes(payload[8:16], "little")
        d = as_u8(dst)
        if total > len(d):
            raise ValueError(f"recv_message_into: message of {total}B "
                             f"exceeds buffer of {len(d)}B")
        got = min(len(payload) - 16, total)
        copy_bytes_into(d[:got], payload[16:16 + got])
        self.view.count_copy(got)
        while got < total:
            n, _fl = self.dequeue_into(d[got:total], timeout=timeout)
            got += n
        return total, tag


class QueueMatrix:
    """n x n SPSC queues in one contiguous region (paper Fig: message queue
    matrix indexed by [receiver][sender]).

    Rank r's RECEIVE queues are row r (r consumes); its SEND queue toward
    rank d is (d, r) (r produces). Any rank locates any queue by address
    arithmetic — the Arena lesson: no data motion, just layout."""

    def __init__(self, view: CoherentView, base: int, n_ranks: int, rank: int,
                 cell_size: int = DEFAULT_CELL_SIZE, n_cells: int = 8,
                 *, initialize: bool = False):
        self.view = view
        self.base = base
        self.n = n_ranks
        self.rank = rank
        self.cell_size = cell_size
        self.n_cells = n_cells
        self.qb = queue_bytes(cell_size, n_cells)
        if initialize:
            for recv in range(n_ranks):
                for send in range(n_ranks):
                    b = self._qbase(recv, send)
                    view.nt_store_u64(b + _T_TAIL, 0)
                    view.nt_store_u64(b + _T_HEAD, 0)
        self._send: dict[int, SPSCQueue] = {}
        self._recv: dict[int, SPSCQueue] = {}

    @staticmethod
    def region_bytes(n_ranks: int, cell_size: int, n_cells: int) -> int:
        return n_ranks * n_ranks * queue_bytes(cell_size, n_cells)

    def _qbase(self, recv: int, send: int) -> int:
        return self.base + (recv * self.n + send) * self.qb

    def send_queue(self, dest: int) -> SPSCQueue:
        q = self._send.get(dest)
        if q is None:
            q = SPSCQueue(self.view, self._qbase(dest, self.rank),
                          self.cell_size, self.n_cells, producer=True)
            self._send[dest] = q
        return q

    def recv_queue(self, src: int) -> SPSCQueue:
        q = self._recv.get(src)
        if q is None:
            q = SPSCQueue(self.view, self._qbase(self.rank, src),
                          self.cell_size, self.n_cells, producer=False)
            self._recv[src] = q
        return q
