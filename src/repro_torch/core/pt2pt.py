"""Two-sided communication: the cMPI Communicator (paper §3.3).

Send/recv over the SPSC queue matrix: the sender enqueues into queue
(receiver_row, sender_col); the receiver polls its row. In-order delivery
per (src, dst) pair; tag matching uses a local reorder buffer (messages of
other tags are parked, never dropped).

Two data-plane protocols, selected per message by ``eager_threshold``:

  EAGER       payload <= threshold. Chunks flow through the pair's SPSC
              queue cells as memoryview slices (gather-enqueue; no
              intermediate ``bytes`` is ever materialized). Copies per
              message: user -> cell (1) + cell -> user (1).

  RENDEZVOUS  payload > threshold, or any ``PoolBuffer``/``PoolView``
              send. The sender stages the payload ONCE into a
              pool-resident object ([ack 64B | payload]) and enqueues a
              single 32-byte control descriptor
              (total, tag, ack offset, data offset). The receiver
              ``read_acquire_into``s its destination buffer straight from
              the staging object and writes the ack byte; the sender's
              progress engine then reclaims the stager. A ``PoolBuffer``
              (pool-resident application buffer, MPI_Alloc_mem analogue)
              — or a ``PoolView`` slice of one — skips the staging copy
              entirely: zero sender-side copies, the one-sided bulk path
              the paper's CXL fabric enables (cf. foMPI routing large
              transfers through RMA windows). ``Comm``'s method
              collectives (core/comm.py) send ``PoolView`` slices of
              persistent round buffers so ring/Bruck rounds never
              re-stage.

  POSTED      rendezvous, receiver-first (foMPI's lesson: expose the
              DESTINATION, not the source). ``recv_into``/``irecv_into``
              on a pool-resident (``PoolBuffer``/``PoolView``) or
              pool-registered (``Registration``) destination publish a
              MATCHBOX entry ``[post_id | tag | dest_off | capacity]``
              for their (src, dst) pair before the sender's descriptor
              exists. A sender that finds a matching entry writes the
              payload STRAIGHT into the receiver's buffer — one copy
              total, zero receiver-side drain — signals readiness
              through the entry's claim word (the drain-ack byte role,
              reversed), and ships a ``FLAG_POSTED`` descriptor naming
              the entry so per-pair FIFO matching still happens in
              queue order. A posting that finds its strip full SPILLS
              to a per-pair overflow list and is promoted (FIFO) as
              entries retire, so deep pre-post bursts (chunked
              schedules) never lose their postings. A sender-side miss
              or an unregistered destination fall back to the staged
              path above: wire-compatible in both directions (old
              senders never see entries; old receivers never post
              them).

Non-blocking isend/irecv return Request objects driven by an explicit
progress pump (MPI_Test/MPI_Wait semantics — paper §3.4 keeps these
unchanged, as do we: the message path itself is what got optimized).
Every blocking call AND every ``test()``/``wait()`` — receives included —
turns the send progress engine, so ``isend`` + ``irecv().wait()`` loops
cannot deadlock on full queues. ``recv_into``/``irecv_into`` deliver
straight into caller buffers (numpy arrays included) with no
``frombuffer().copy()`` round trip.

Payloads may be CUDA tensors (the port's addition). Their bytes enter and
leave the pool through the ``cellcopy`` kernel on every path — queue
cells, staging objects, posted destinations — and the stream is
synchronised before any control word that publishes them. A self-send
clones on the device. Host payloads on a CUDA communicator move by host
copies exactly as in the JAX package. ``recv()`` returns a uint8 tensor
on the communicator's device, where the JAX package returns ``bytes``.

This module is the pt2pt ENGINE. The user-facing v2 surface — method
collectives, ``split``/``dup`` sub-communicators, persistent requests,
``eager_threshold="auto"`` — is the ``Comm`` facade in
``repro_torch.core.comm``, which subclasses ``Communicator``.

Bootstrap: rank 0 creates the queue-matrix and barrier objects in the
arena; other ranks poll ``open`` until they appear — this mirrors the
paper's 'root rank creates, broadcasts the object name' flow (here the
names are deterministic, which IS the broadcast).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.arena import Arena, ObjHandle
from repro_torch.core.coherence import CoherentView
from repro_torch.core.pool import (LocalPool, Registration, as_u8,
                                   copy_bytes_into, is_device, readonly)
from repro_torch.core.progress import ProgressEngine
from repro_torch.core.progress import testall as _testall
from repro_torch.core.progress import waitall as _waitall
from repro_torch.core.progress import waitany as _waitany
from repro_torch.core.ringqueue import (DEFAULT_CELL_SIZE, FLAG_FIRST, FLAG_LAST,
                                  FLAG_POSTED, FLAG_RNDV,
                                  TAG_RESERVED_BASE, QueueMatrix)
from repro_torch.core.rma import DynamicWindow, Window
from repro_torch.core.sync import SeqBarrier
from repro_torch.core.trace import (EV_MB_CLAIM, EV_MB_CONSUME, EV_MB_POST,
                              EV_MB_PROMOTE, EV_MB_RETRACT, EV_MB_SPILL,
                              EV_PT2PT_EAGER, EV_PT2PT_POSTED,
                              EV_PT2PT_STAGED, NULL_TRACER, PATH_EAGER,
                              PATH_POSTED, PATH_SELF, PATH_STAGED, SP_ACK,
                              SP_ACK_SEEN, SP_QUEUE_WAIT, SP_RECV, SP_SEND,
                              SP_STAGER, SP_WAIT, as_tracer)
from repro_torch.core.wait import Waitable, spin

ANY_TAG = -1

# tags at or above TAG_RESERVED_BASE are RESERVED for internal traffic
# (collective schedule rounds live at 0x7E??????, the legacy collective
# tag space at 0x7F000000+). ANY_TAG receives — and ANY_TAG matchbox
# wildcards — never match reserved tags, so in-flight user wildcard
# receives cannot steal a collective round (MPI's separate communication
# contexts, enforced through tag-space partitioning). The constant is
# defined in the wire layer (``ringqueue``) and re-exported here.
# per-launch tag window for collective schedules (see Communicator.
# _alloc_coll_tags): sequence-numbered windows of MAX_ROUNDS tags
_TAG_SCHED_BASE = 0x7E000000
_TAG_SCHED_SEQS = 2048
# persistent collectives lease windows from a separate, longer-lived
# sequence space so a long-lived allreduce_init never collides with the
# wrapping transient windows
_TAG_PERSIST_BASE = 0x7E800000


def _open_poll(make, timeout: float):
    """``make()``, retried every 0.5 ms while the arena objects it opens
    do not exist yet (rank 0 creates them); the ``FileNotFoundError``
    stands once ``timeout`` seconds have passed."""
    t0 = time.monotonic()
    while True:
        try:
            return make()
        except FileNotFoundError:
            if time.monotonic() - t0 > timeout:
                raise
            time.sleep(0.0005)


def _tag_match(want: int, got: int) -> bool:
    """Receive-side tag matching: exact, or ANY_TAG against any USER
    tag (reserved internal tags are never wildcard-matched)."""
    if want == ANY_TAG:
        return got < TAG_RESERVED_BASE
    return want == got

# rendezvous staging object layout: [ctrl 64B | payload]; ctrl byte 0 is
# the receiver-written ack ("drained, reclaim/reuse me")
_RNDV_CTRL = 64

# --------------------------------------------------------------------------
# matchbox: receiver-posted rendezvous entries (one strip per ordered pair)
# --------------------------------------------------------------------------
# Entry layout (one cacheline, every field accessed non-temporally so no
# rank ever caches another rank's control words):
#
#   0:8    post_id   receiver-written; 0 = empty, else a per-pair
#                    monotonically increasing id (published LAST)
#   8:16   tag       receiver-written; 2^64-1 = ANY_TAG wildcard
#   16:24  dest_off  receiver-written; absolute pool offset of the
#                    destination payload region
#   24:32  capacity  receiver-written
#   32:40  claim     sender-written; (post_id << 2) | state — the
#                    drain-ack byte of the staged path, role-reversed:
#                    the SENDER acks delivery into the receiver's buffer
#   40:48  fill      sender-written; delivered payload bytes
#
# Single-writer discipline (CXL pooled memory has no cross-host atomic
# RMW, paper §3.5): the receiver only writes the first four words, the
# sender only the last two. The claim/retract race is resolved
# Dekker-style: the sender publishes a PENDING claim, re-reads post_id,
# and only then commits (after the payload write) or aborts; a receiver
# retracting a posting waits out a PENDING claim and salvages a
# committed one (see Communicator._mb_retract).
_MB_ENTRY = 64
_MB_TAG = 8
_MB_DEST = 16
_MB_CAP = 24
_MB_CLAIM = 32
_MB_FILL = 40
_MB_ANY = (1 << 64) - 1
_CLAIM_PENDING, _CLAIM_COMMIT, _CLAIM_ABORT = 1, 2, 3
DEFAULT_MB_SLOTS = 4


class Matchbox:
    """The per-pair strips of receiver-posted entries, addressed like the
    queue matrix: the strip for (receiver, sender) holds ``n_slots``
    entries the receiver posts and the sender scans."""

    def __init__(self, view: CoherentView, base: int, n_ranks: int,
                 n_slots: int, *, initialize: bool = False):
        self.view = view
        self.base = base
        self.n = n_ranks
        self.n_slots = n_slots
        if initialize:
            # derived comms recycle dirty heap: zero every entry before
            # the communicator's :ok publication makes them findable
            view.write_release(
                base, bytes(self.region_bytes(n_ranks, n_slots)))

    @staticmethod
    def region_bytes(n_ranks: int, n_slots: int) -> int:
        return n_ranks * n_ranks * n_slots * _MB_ENTRY

    def entry_off(self, recv: int, send: int, slot: int) -> int:
        return self.base + ((recv * self.n + send) * self.n_slots
                            + slot) * _MB_ENTRY

    # mb-writer: receiver
    def post(self, recv: int, send: int, slot: int, post_id: int,
             tag: int, dest_off: int, capacity: int) -> None:
        v = self.view
        off = self.entry_off(recv, send, slot)
        v.nt_store_u64(off + _MB_TAG,
                       _MB_ANY if tag == ANY_TAG else int(tag) & _MB_ANY)
        v.nt_store_u64(off + _MB_DEST, dest_off)
        v.nt_store_u64(off + _MB_CAP, capacity)
        v.nt_store_u64(off, post_id)          # publish last


@dataclass
class _PostRecord:
    """Receiver-side bookkeeping for one live matchbox posting."""
    src: int
    slot: int
    post_id: int
    tag: int                                 # the receive's criterion
    dest: "_RecvDest"
    owner: Any                               # the posting Request


@dataclass
class _PendingPost:
    """A postable receive's matchbox intent, live from irecv to
    completion. ``rec`` is None while the posting waits in the per-pair
    OVERFLOW list (every strip slot occupied); consuming or retracting
    an entry promotes the oldest overflow posting into the freed slot,
    so postings reach the matchbox in FIFO order no matter how deep a
    chunked pre-post burst runs — no lazy retry, no capacity miss."""
    src: int
    tag: int
    dest: "_RecvDest"
    owner: Any                               # the posting Request
    rec: Optional[_PostRecord] = None
    closed: bool = False


class _RecvDest:
    """Resolved destination of a ``*_into`` receive: a writable sink for
    the eager/staged delivery paths plus, when the destination is
    pool-addressable, the coordinates a matchbox posting advertises.

      plain buffer          sink = the user view; not postable
      PoolBuffer/PoolView   sink aliases pool memory (or a bounce temp on
                            pools without raw views); postable
      Registration          sink = the user view (eager/staged bypass the
                            shadow); postable at the shadow's offset,
                            with a shadow -> user drain on posted
                            completion
    """

    __slots__ = ("mv", "capacity", "post_off", "postable", "indirect",
                 "reg")

    def __init__(self, mv: memoryview, *, post_off: int = -1,
                 postable: bool = False, indirect: bool = False,
                 reg: Registration | None = None):
        self.mv = mv
        self.capacity = len(mv)
        self.post_off = post_off
        self.postable = postable
        self.indirect = indirect
        self.reg = reg

    def flush(self, view: CoherentView, n: int) -> None:
        """Indirect pool destination: move the bounce temp into the pool
        through the coherence protocol (counted)."""
        if self.indirect and n:
            view.write_release(self.post_off, self.mv[:n])

    def finish_posted(self, view: CoherentView, n: int) -> None:
        """Posted completion landed at ``post_off``; for a registration
        that is the shadow — drain it into the user view once."""
        if self.reg is not None and n:
            view.read_acquire_into(self.post_off, self.mv[:n])
            view.count_path("rndv_posted", n)


class PoolBuffer:
    """Message buffer RESIDENT in the shared pool (the MPI_Alloc_mem /
    CXL-resident application buffer of the paper).

    Sending one takes the rendezvous path with ZERO sender-side payload
    copies: the control descriptor points at this object and the receiver
    pulls straight from it. The send completes (synchronous-mode send)
    once the receiver acks the drain, after which the buffer is reusable.

    Arena object layout: [ctrl 64B | payload nbytes].
    """

    def __init__(self, comm: "Communicator", handle: ObjHandle):
        self._comm = comm
        self._handle = handle
        self.nbytes = handle.size - _RNDV_CTRL
        # one ack byte => at most ONE outstanding send per buffer
        self._in_flight = False

    @property
    def offset(self) -> int:
        """Absolute payload offset in the pool."""
        return self._handle.offset + _RNDV_CTRL

    def view(self) -> memoryview:
        """Writable zero-copy window into pool memory (memory-backed,
        hardware-coherent pools only — on incoherent pools use write)."""
        return self._comm.arena.pool.memview(self.offset, self.nbytes)

    def tensor(self) -> torch.Tensor:
        """uint8 tensor aliasing the payload on the communicator's device:
        the pool's device window on a CUDA communicator, the host window
        otherwise. Zero-copy either way: the device side of ``view()``,
        the caller's own buffer until a send publishes it."""
        return self._comm.arena.pool.tensor_view(  # lint: raw-ok (own buffer)
            self.offset, self.nbytes, self._comm.device)

    def write(self, data, off: int = 0) -> None:
        """Protocol-correct fill (valid on every pool mode)."""
        mv = as_u8(data)
        if off < 0 or off + len(mv) > self.nbytes:
            raise IndexError("write beyond PoolBuffer")
        self._comm.arena.view.write_release(self.offset + off, mv)

    def read(self, off: int = 0, n: int | None = None) -> bytes:
        n = self.nbytes - off if n is None else n
        return self._comm.arena.view.read_acquire(self.offset + off, n)

    def free(self) -> None:
        self._comm.arena.destroy(self._handle)

    def slice(self, off: int = 0, nbytes: int | None = None) -> "PoolView":
        """A sendable window [off, off+nbytes) of this buffer. Slices
        share the buffer's single ack slot, so at most one send per
        underlying buffer may be in flight at a time."""
        nbytes = self.nbytes - off if nbytes is None else nbytes
        if off < 0 or nbytes < 0 or off + nbytes > self.nbytes:
            raise IndexError(
                f"slice [{off}, {off + nbytes}) beyond PoolBuffer "
                f"of {self.nbytes}B")
        return PoolView(self, off, nbytes)


@dataclass(frozen=True)
class PoolView:
    """A contiguous slice of a PoolBuffer, sendable with zero sender-side
    copies: the rendezvous descriptor points the receiver straight at
    pool memory. Produced by ``PoolBuffer.slice``; the ``Comm`` method
    collectives send these for every ring/Bruck round."""
    buffer: PoolBuffer
    off: int
    nbytes: int


@dataclass
class Request(Waitable):
    kind: str                        # send | recv
    done: bool = False
    cancelled: bool = False          # done via cancel(): no data arrived
    data: Any = None                 # recv result: uint8 tensor on the
                                     # comm's device (bytes-mode receives)
    nbytes: int = 0                  # payload size delivered/accepted
    tag: int = 0
    src: int = -1
    _gen: Any = field(default=None, repr=False)
    _comm: Any = field(default=None, repr=False)
    _error: Optional[BaseException] = field(default=None, repr=False)
    # True while the receive generator is suspended MID-MESSAGE (eager
    # multi-chunk drain): closing it there would strand the message's
    # tail chunks in the pair queue and corrupt framing
    _draining: bool = field(default=False, repr=False)
    # completion callback feeding the shared progress engine: schedule
    # executions hang a node-retirement hook here so a finishing pt2pt
    # request immediately readies its dependents (core/progress.py)
    _on_done: Any = field(default=None, repr=False)
    # tracing (core/trace.py): the request's span (pt2pt.send or
    # pt2pt.recv; -1 untraced) and the span its work runs under (a
    # receive's deliver span once its message is dequeued), which the
    # progress engine makes the tracer's ``cur`` while it turns it
    _span: int = field(default=-1, repr=False)
    _cur: int = field(default=-1, repr=False)

    def _finish(self) -> None:
        """Mark complete exactly once and fire the completion callback."""
        if self.done:
            return
        self.done = True
        cb = self._on_done
        if cb is not None:
            self._on_done = None
            cb(self)

    def cancel(self) -> None:
        """Withdraw a pending receive (MPI_Cancel, receives only):
        closes the generator — which retracts any live matchbox posting
        — and unlinks it from the posted-receive FIFO. A no-op on
        completed requests. On success the request reports done with
        ``cancelled=True`` (the MPI_Test_cancelled observable): no data
        arrived, and any completion callback is dropped, never fired.
        BEST-EFFORT, per MPI: a receive already draining a multi-chunk
        eager message cannot be cancelled (closing it mid-message would
        strand tail chunks in the pair queue and corrupt framing) — it
        is left to complete normally, ``cancelled`` stays False."""
        if self.done or self.kind != "recv" or self._draining:
            return
        if self._gen is not None:
            self._gen.close()
        self.cancelled = True
        self._on_done = None
        self.done = True
        fifo = self._comm._recv_fifo.get(self.src) \
            if self._comm is not None else None
        if fifo is not None:
            try:
                fifo.remove(self)
            except ValueError:
                pass

    def test(self) -> bool:
        if self._error is not None:
            raise self._error
        if self.done:
            return True
        if self.kind == "send":
            # sends are pumped ONLY through the per-destination FIFO —
            # chunks of different messages must never interleave in one
            # SPSC queue (framing is contiguous per message)
            self._comm._progress()
            return self.done
        # a receive must ALSO turn the full progress engine: a bare
        # isend-to-peer + irecv().wait() loop would otherwise deadlock
        # once the pair queue fills (each rank blocked in a recv that
        # never advances its own outstanding send), and a synchronous
        # send waited before a posted receive needs that receive matched
        # passively (MPI posted-receive semantics)
        tr = NULL_TRACER
        if self._comm is not None:
            tr = self._comm.tracer
            self._comm._progress()
            if self.done:                # completed by the engine
                return True
            if self._error is not None:
                raise self._error
        up = -1
        if tr.enabled:
            up, tr.cur = tr.cur, self._cur
        try:
            next(self._gen)
        except StopIteration:
            self._finish()
            self._unpost()
        except BaseException:
            self._unpost()               # keep the FIFO draining
            raise
        finally:
            if tr.enabled:
                tr.cur = up
        return self.done

    def _unpost(self) -> None:
        if self._comm is None or self.kind != "recv":
            return
        fifo = self._comm._recv_fifo.get(self.src)
        if fifo and fifo[0] is self:
            fifo.popleft()

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def _outcome(self):
        return self.data

    def _stuck(self) -> str:
        return f"{self.kind} request timed out"


class Communicator:
    """MPI_COMM_WORLD-alike over one arena."""

    def __init__(self, arena: Arena, rank: int, size: int, *,
                 cell_size: int = DEFAULT_CELL_SIZE, n_cells: int = 8,
                 eager_threshold: int | None = None,
                 mb_slots: int = DEFAULT_MB_SLOTS,
                 matchbox_slots: int | None = None,
                 name: str = "world", open_timeout: float = 30.0,
                 trace=None, device: str = "cuda"):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        if cuda and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the communicator runs on the card by "
                "default; pass device='cpu' to run it on the CPU")
        self.arena = arena
        self.rank = rank
        self.size = size
        self.name = name
        self.cell_size = cell_size
        self.n_cells = n_cells
        # flight recorder (core/trace.py): off by default — every hot
        # path checks ``self.tracer.enabled`` and nothing else. Must
        # exist before the engine and the init barrier below run.
        self.tracer = as_tracer(trace, rank)
        # the comm's name as the tracer knows it (its spans' ``comm``),
        # and whether a traced collective call of this comm is running
        self._tsid = self.tracer.intern(name)
        self._in_coll = False
        if arena.view.tracer is NULL_TRACER:
            arena.view.tracer = self.tracer
        # protocol switch: payloads <= threshold go through queue cells
        # (eager), larger ones through a pool staging object (rendezvous)
        self.eager_threshold = (cell_size if eager_threshold is None
                                else eager_threshold)
        self.eager_sends = 0
        self.rndv_sends = 0
        self.posted_sends = 0         # rendezvous sends that hit an entry
        if matchbox_slots is not None:
            # preferred spelling; ``mb_slots`` stays as the historical
            # alias. Pre-posted schedules size this to schedule depth
            # (2x the deepest per-peer receive count for persistent
            # collectives — two iterations' entries coexist).
            mb_slots = matchbox_slots
        self.mb_slots = mb_slots      # posted entries per (src, dst); 0 off
        region = QueueMatrix.region_bytes(size, cell_size, n_cells)
        bar_bytes = SeqBarrier.region_bytes(size)
        mb_bytes = Matchbox.region_bytes(size, mb_slots) if mb_slots else 0
        self._mb_obj: Optional[ObjHandle] = None
        self._ok_obj: Optional[ObjHandle] = None
        if rank == 0:
            self._mq_obj = arena.create(f"{name}:mq", region)
            self._bar_obj = arena.create(f"{name}:bar", bar_bytes)
            self.mq = QueueMatrix(arena.view, self._mq_obj.offset, size, rank,
                                  cell_size, n_cells, initialize=True)
            self._barrier = SeqBarrier(arena.view, self._bar_obj.offset, size,
                                       rank, initialize=True)
            if mb_bytes:
                self._mb_obj = arena.create(f"{name}:mb", mb_bytes)
                self._mb = Matchbox(arena.view, self._mb_obj.offset, size,
                                    mb_slots, initialize=True)
            else:
                self._mb = None
            # publication flag LAST: arena.create makes a name findable
            # before its contents are initialized, and derived comms
            # (split/dup) recycle dirty heap — a member must never map
            # control words rank 0 has not zeroed yet. Its 64 bytes
            # double as free()'s per-rank exit-fence flags — zero them
            # (dirty heap) before the init barrier lets anyone proceed.
            self._ok_obj = arena.create(f"{name}:ok", max(64, size))
            arena.view.write_release(self._ok_obj.offset,
                                     bytes(max(64, size)))
        else:
            self._ok_obj, self._mq_obj, self._bar_obj, self._mb_obj = \
                _open_poll(lambda: (
                    arena.open(f"{name}:ok"), arena.open(f"{name}:mq"),
                    arena.open(f"{name}:bar"),
                    arena.open(f"{name}:mb") if mb_bytes else None),
                    open_timeout)
            self.mq = QueueMatrix(arena.view, self._mq_obj.offset, size, rank,
                                  cell_size, n_cells)
            self._barrier = SeqBarrier(arena.view, self._bar_obj.offset, size,
                                       rank)
            self._mb = (Matchbox(arena.view, self._mb_obj.offset, size,
                                 mb_slots) if mb_bytes else None)
        # tag reorder buffers per src: (payload, tag, rndv) — rndv
        # records whether the payload arrived via a rendezvous path
        # (the capacity-miss accounting needs the DELIVERY path, not a
        # size heuristic: pool-resident sends are rendezvous at any
        # size)
        self._parked: dict[int, deque[tuple[bytes, int, bool]]] = {
            s: deque() for s in range(size)}
        # matchbox state. Receiver side: live postings by (src, slot),
        # per-src post_id counters, and payloads salvaged out of postings
        # that were retracted after the sender had already committed.
        # Sender side: the last post_id claimed per (dst, slot), so a
        # consumed-but-not-yet-recycled entry is never claimed twice.
        self._mb_records: dict[tuple[int, int], _PostRecord] = {}
        # per-source FIFO of postings that found every strip slot
        # occupied; promoted (oldest first) whenever a slot frees
        self._mb_overflow: dict[int, deque[_PendingPost]] = {}
        self._mb_next_id: dict[int, int] = {}
        self._mb_salvage: dict[tuple[int, int, int], bytes] = {}
        self._mb_claimed: dict[tuple[int, int], int] = {}
        # claim cursor per destination strip: the slot AFTER the last
        # successful claim (the receiver promotes spilled postings into
        # the slot the previous claim freed, so the next-oldest entry
        # usually lands there) plus the retire frontier — the highest
        # post_id F with every pid <= F known dead or claimed by us.
        # pid == F+1 at the cursor slot proves oldest-live without a
        # scan; see _mb_claim.
        self._mb_cursor: dict[int, int] = {}
        self._mb_frontier: dict[int, int] = {}
        self._aliasable: Optional[bool] = None
        # pinned, GPU-mapped landing buffer for a queue cell whose
        # payload goes on to the card (first eager chunk): the cell is
        # read into it (the one counted pool read) and the kernel moves
        # the payload from there
        self._cell_scratch = LocalPool(cell_size, device) if cuda else None
        self._reg_seq = 0
        self._freed = False
        # the SHARED PROGRESS CORE (core/progress.py): owns the send/
        # recv FIFOs, the stager reclaim list AND every active
        # collective schedule execution; every blocking call and every
        # test()/wait() turns it (MPI progress rule — without it, two
        # ranks that isend to each other then recv would deadlock on
        # full queues, and an iallreduce would never advance)
        self._engine = ProgressEngine(self)
        # collective-schedule state: compiled-DAG cache (one entry per
        # (op, size, topology)) and the launch sequence counters that
        # hand each collective a disjoint tag window
        self._sched_cache: dict = {}
        self._coll_seq = 0
        self._persist_seq = 0
        self._rndv_seq = 0
        self._pbuf_seq = 0
        # init barrier (paper §3.4: creation of shared queues synchronized
        # by the seq-number barrier)
        self.barrier()

    # engine-owned state, re-exposed under the historical names
    @property
    def _send_fifo(self) -> dict[int, deque]:
        return self._engine.send_fifo

    @property
    def _recv_fifo(self) -> dict[int, deque]:
        return self._engine.recv_fifo

    @property
    def _stagers(self) -> list:
        return self._engine.stagers

    def _progress(self) -> None:
        """One tick of the shared progress engine."""
        self._engine.tick()

    def progress(self) -> None:
        """Explicit progress tick: advances outstanding sends, posted
        receives, stager reclaim and every active collective schedule.
        Call this from compute loops between ``iallreduce`` start and
        ``wait`` to keep payloads moving — the engine is cooperative,
        there is no progress thread."""
        self._engine.tick()

    def _alloc_coll_tags(self, persistent: bool = False) -> int:
        """A per-launch window of ``sched.MAX_ROUNDS`` reserved tags.
        The sequence counters advance identically on every rank
        (collectives are issued in the same order everywhere — the MPI
        calling convention), so windows agree without communication.
        Persistent collectives draw from a separate sequence: their
        windows live as long as the request does and must not collide
        with the wrapping transient ones."""
        from repro_torch.core.sched import MAX_ROUNDS
        if persistent:
            seq = self._persist_seq
            self._persist_seq += 1
            return _TAG_PERSIST_BASE + (seq % _TAG_SCHED_SEQS) * MAX_ROUNDS
        seq = self._coll_seq
        self._coll_seq += 1
        return _TAG_SCHED_BASE + (seq % _TAG_SCHED_SEQS) * MAX_ROUNDS

    # ------------------------------------------------------------------
    # pool-resident buffers (zero-copy sends)
    # ------------------------------------------------------------------
    def alloc_buffer(self, nbytes: int) -> PoolBuffer:
        """Allocate a pool-resident message buffer (MPI_Alloc_mem)."""
        h = self.arena.create(f"pb:{self.name}:{self.rank}:{self._pbuf_seq}",
                              _RNDV_CTRL + nbytes)
        self._pbuf_seq += 1
        return PoolBuffer(self, h)

    def register(self, buf) -> Registration:
        """Pin a writable user buffer for receiver-posted rendezvous:
        allocates its pool-resident shadow once; receives posted on the
        registration advertise the shadow in the matchbox and drain it
        into the user buffer on completion. Release with ``.free()``."""
        mv = as_u8(buf)
        if readonly(mv):
            raise ValueError("register needs a writable buffer")
        h = self.arena.create(f"rg:{self.name}:{self.rank}:{self._reg_seq}",
                              max(len(mv), 1))
        self._reg_seq += 1
        return Registration(mv, h.offset, h, self)

    def unregister(self, reg: Registration) -> None:
        if reg.closed:
            return
        reg.closed = True
        self.arena.destroy(reg._handle)

    def _pool_aliasable(self) -> bool:
        """True when the pool hands out raw memoryview windows (memory-
        backed, hardware-coherent) — pool-resident payloads can then be
        moved with a single protocol copy."""
        if self._aliasable is None:
            try:
                self.arena.pool.memview(0, 1)
                self._aliasable = True
            except TypeError:
                self._aliasable = False
        return self._aliasable

    def _resolve_dest(self, buf) -> _RecvDest:
        """Classify a ``*_into`` destination (see _RecvDest)."""
        if isinstance(buf, Registration):
            if buf.closed:
                raise ValueError("registration already freed")
            return _RecvDest(buf.mv, post_off=buf.shadow_off,
                             postable=self._mb is not None, reg=buf)
        if isinstance(buf, PoolBuffer):
            buf = PoolView(buf, 0, buf.nbytes)
        if isinstance(buf, PoolView):
            off = buf.buffer.offset + buf.off
            if self._pool_aliasable():
                mv = self.arena.pool.memview(off, buf.nbytes)
                indirect = False
            else:
                mv = memoryview(bytearray(buf.nbytes))
                indirect = True
            return _RecvDest(mv, post_off=off,
                             postable=self._mb is not None,
                             indirect=indirect)
        mv = as_u8(buf)
        if readonly(mv):
            raise ValueError("irecv_into needs a writable buffer")
        return _RecvDest(mv)

    # ------------------------------------------------------------------
    # matchbox: receiver side
    # ------------------------------------------------------------------
    def _new_payload(self, n: int) -> torch.Tensor:
        """Fresh uint8 result buffer for a bytes-mode receive."""
        return torch.empty(n, dtype=torch.uint8, device=self.device)

    def _as_payload(self, d) -> torch.Tensor:
        """A parked or salvaged payload (host ``bytes`` or a device
        tensor) as a bytes-mode receive's result on this comm's device;
        host bytes bound for the card are copied host-to-device."""
        if is_device(d) and d.device == self.device:
            return d
        out = self._new_payload(len(d))
        copy_bytes_into(as_u8(out), as_u8(d), self.tracer)
        return out

    def _next_pid(self, src: int) -> int:
        """Per-pair monotonically increasing post_id (the matchbox's
        freshness token: claim re-checks, salvage keys and oldest-entry
        selection all key off it)."""
        pid = self._mb_next_id.get(src, 1)
        self._mb_next_id[src] = pid + 1
        return pid

    def _mb_post(self, src: int, tag: int, dest: _RecvDest,
                 req: "Request") -> Optional[_PostRecord]:
        """Publish a posted-rendezvous entry for ``req``; None when every
        slot of the pair is occupied."""
        for slot in range(self._mb.n_slots):
            if (src, slot) in self._mb_records:
                continue
            pid = self._next_pid(src)
            self._mb.post(self.rank, src, slot, pid, tag,
                          dest.post_off, dest.capacity)
            rec = _PostRecord(src, slot, pid, tag, dest, req)
            self._mb_records[(src, slot)] = rec
            tr = self.tracer
            if tr.enabled:
                tr.emit(EV_MB_POST, pid, src, dest.capacity)
            return rec
        return None

    def _mb_post_or_spill(self, src: int, tag: int, dest: _RecvDest,
                          req: "Request") -> _PendingPost:
        """Publish an entry, or SPILL the posting to the pair's overflow
        list when the strip is full (promoted FIFO as slots free). A
        posting behind a non-empty overflow spills too — it must not
        overtake earlier receives in the matchbox."""
        pend = _PendingPost(src, tag, dest, req)
        ovf = self._mb_overflow.get(src)
        if not ovf:
            pend.rec = self._mb_post(src, tag, dest, req)
            if pend.rec is not None:
                return pend
        self._mb_overflow.setdefault(src, deque()).append(pend)
        tr = self.tracer
        if tr.enabled:
            tr.emit(EV_MB_SPILL, 0, src)
        return pend

    def _mb_promote(self, src: int) -> None:
        """A (src -> us) slot freed: move the oldest spilled posting of
        that pair into the matchbox."""
        ovf = self._mb_overflow.get(src)
        while ovf:
            pend = ovf[0]
            if pend.closed:
                ovf.popleft()
                continue
            rec = self._mb_post(src, pend.tag, pend.dest, pend.owner)
            if rec is None:
                return
            pend.rec = rec
            ovf.popleft()
            tr = self.tracer
            if tr.enabled:
                tr.emit(EV_MB_PROMOTE, rec.post_id, src)

    def _mb_withdraw(self, pend: Optional[_PendingPost], *,
                     fallback_delivery: bool = False) -> None:
        """The receive behind ``pend`` is completing some way other than
        its own posted entry: retract a live posting (salvaging any
        committed claim) or unlink a still-spilled one. A fallback
        DELIVERY that finds the posting still spilled is the one true
        capacity miss left — the strip was too shallow for the posting
        to reach the matchbox in time — and is what
        ``ProtocolStats.mb_capacity_misses`` now counts."""
        if pend is None or pend.closed:
            return
        pend.closed = True
        if pend.rec is not None:
            self._mb_retract(pend.rec)
            pend.rec = None
            return
        ovf = self._mb_overflow.get(pend.src)
        if ovf:
            try:
                ovf.remove(pend)
            except ValueError:
                pass
        if fallback_delivery:
            self.arena.view.count_mb_miss()

    # mb-writer: receiver
    def _mb_retract(self, rec: _PostRecord) -> None:
        """Withdraw a posting whose receive is completing another way
        (eager, staged, parked, error). If the sender committed a claim
        concurrently, the payload it delivered belongs to a LATER message
        whose FLAG_POSTED descriptor is already in flight — salvage it
        out of the buffer before the owner reuses it."""
        key = (rec.src, rec.slot)
        if self._mb_records.get(key) is not rec:
            return                            # consumed or already gone
        del self._mb_records[key]
        try:
            v = self.arena.view
            off = self._mb.entry_off(self.rank, rec.src, rec.slot)
            v.nt_store_u64(off, 0)
            # yield (a syscall) between our store and the claim load: a
            # sender that read the stale post_id issued its PENDING store
            # BEFORE that read, so after the yield any such claim is
            # visible — closing the StoreLoad window a bare store+load
            # would leave (on the paper's hardware the nt store is
            # followed by sfence)
            time.sleep(0)
            w = v.nt_load_u64(off + _MB_CLAIM)
            if (w >> 2) != rec.post_id:
                return
            if (w & 3) == _CLAIM_PENDING:     # sender mid-claim: wait out

                def settled() -> bool:
                    nonlocal w
                    w = v.nt_load_u64(off + _MB_CLAIM)
                    return (w & 3) != _CLAIM_PENDING

                try:
                    spin(settled, 10.0, lambda: "matchbox retract: peer "
                         "claim stuck PENDING")
                except TimeoutError as e:
                    raise RuntimeError(*e.args) from None
            if (w & 3) == _CLAIM_COMMIT:
                n = v.nt_load_u64(off + _MB_FILL)
                data = bytes(v.read_acquire(rec.dest.post_off, n)) \
                    if n else b""
                v.count_path("rndv_posted", n)
                self._mb_salvage[(rec.src, rec.slot, rec.post_id)] = data
        finally:
            tr = self.tracer
            if tr.enabled:
                tr.emit(EV_MB_RETRACT, rec.post_id, rec.src)
            self._mb_promote(rec.src)         # the slot is free again

    # mb-writer: receiver
    def _mb_consume(self, rec: _PostRecord) -> None:
        """A posted delivery completed in place: recycle the entry and
        promote the pair's oldest spilled posting into the slot."""
        off = self._mb.entry_off(self.rank, rec.src, rec.slot)
        self.arena.view.nt_store_u64(off, 0)
        self._mb_records.pop((rec.src, rec.slot), None)
        tr = self.tracer
        if tr.enabled:
            tr.emit(EV_MB_CONSUME, rec.post_id, rec.src)
        self._mb_promote(rec.src)

    def _mb_repost(self, rec: _PostRecord) -> None:
        """The sender delivered a message that MPI order routes to a
        DIFFERENT receive: after salvaging the payload, re-arm the entry
        for its still-pending owner (whose buffer is undefined until
        completion, so the scribble was legal)."""
        pid = self._next_pid(rec.src)
        rec.post_id = pid
        self._mb.post(self.rank, rec.src, rec.slot, pid,
                      rec.tag, rec.dest.post_off, rec.dest.capacity)

    def _mb_take(self, src: int, slot: int, pid: int, total: int,
                 req: "Request") -> Optional[bytes]:
        """Resolve a FLAG_POSTED descriptor. Returns None when the
        payload was consumed IN PLACE by ``req`` (its own posting —
        zero receiver-side copies), else the payload bytes salvaged from
        a retracted or foreign posting."""
        sal = self._mb_salvage.pop((src, slot, pid), None)
        if sal is not None:
            return sal[:total]
        rec = self._mb_records.get((src, slot))
        if rec is None or rec.post_id != pid:
            raise RuntimeError(
                f"cMPI matchbox error: FLAG_POSTED descriptor for unknown "
                f"posting (src={src}, slot={slot}, post_id={pid})")
        v = self.arena.view
        if rec.owner is req:
            rec.dest.finish_posted(v, total)
            self._mb_consume(rec)
            return None
        data = bytes(v.read_acquire(rec.dest.post_off, total)) \
            if total else b""
        v.count_path("rndv_posted", total)
        self._mb_repost(rec)
        return data

    # ------------------------------------------------------------------
    # matchbox: sender side
    # ------------------------------------------------------------------
    def _mb_match(self, v, off: int, tag: int, wtag: int,
                  nbytes: int) -> bool:
        """Tag + capacity filter for one live strip entry."""
        etag = v.nt_load_u64(off + _MB_TAG)
        if etag == _MB_ANY:
            # a wildcard posting belongs to a USER receive — it must
            # never swallow reserved-tag traffic (collective rounds)
            if int(tag) >= TAG_RESERVED_BASE:
                return False
        elif etag != wtag:
            return False
        return v.nt_load_u64(off + _MB_CAP) >= nbytes

    # mb-writer: sender
    def _mb_commit_claim(self, dest: int, slot: int, pid: int,
                         off: int) -> Optional[tuple[int, int, int, int]]:
        """PENDING -> re-check -> owned on one chosen entry; advances
        the claim cursor on success. Returns the claim tuple or None
        when the receiver retracted the entry mid-claim."""
        v = self.arena.view
        self._mb_claimed[(dest, slot)] = pid
        v.nt_store_u64(off + _MB_CLAIM, (pid << 2) | _CLAIM_PENDING)
        if v.nt_load_u64(off) != pid:         # receiver retracted mid-claim
            v.nt_store_u64(off + _MB_CLAIM, (pid << 2) | _CLAIM_ABORT)
            return None
        self._mb_cursor[dest] = (slot + 1) % self._mb.n_slots
        tr = self.tracer
        if tr.enabled:
            tr.emit(EV_MB_CLAIM, pid, dest)
        return slot, pid, v.nt_load_u64(off + _MB_DEST), off

    def _mb_claim(self, dest: int, tag: int, nbytes: int,
                  pool_src: bool) -> Optional[tuple[int, int, int, int]]:
        """Claim the OLDEST matching posted entry of the (dest, self)
        strip (PENDING -> re-check -> owned). Returns
        (slot, post_id, dest_off, entry_off) or None on miss.

        Fast path first: a chunked send stream claims a strip's entries
        in strictly increasing post_id order, and the receiver promotes
        spilled postings into the slot the previous claim freed — so
        the next-oldest entry is usually at the cursor slot. Per-strip
        post_ids are monotone and never reused, so an entry there with
        ``pid == frontier + 1`` is PROVABLY the oldest live entry; if
        it also matches, claiming it without scanning preserves the
        oldest-match FIFO rule. Anything else falls back to the full
        scan. Every slot probed is counted in
        ``ProtocolStats.mb_slots_scanned``."""
        mb = self._mb
        if mb is None or (pool_src and not self._pool_aliasable()):
            # a pool-resident source on a pool without raw views would
            # need a bounce read+write (2 copies) — staged is cheaper
            return None
        v = self.arena.view
        st = v.stats
        wtag = int(tag) & _MB_ANY
        cur = self._mb_cursor.get(dest)
        fr = self._mb_frontier.get(dest, 0)
        if cur is not None:
            off = mb.entry_off(dest, self.rank, cur)
            st.mb_slots_scanned += 1
            pid = v.nt_load_u64(off)
            if (pid == fr + 1
                    and self._mb_claimed.get((dest, cur)) != pid
                    and self._mb_match(v, off, tag, wtag, nbytes)):
                got = self._mb_commit_claim(dest, cur, pid, off)
                if got is not None:
                    self._mb_frontier[dest] = pid
                    return got
        # ---- full scan: oldest matching post_id wins ----
        best = None
        lo = None                     # lowest LIVE unclaimed pid seen
        for slot in range(mb.n_slots):
            off = mb.entry_off(dest, self.rank, slot)
            st.mb_slots_scanned += 1
            pid = v.nt_load_u64(off)
            if not pid or self._mb_claimed.get((dest, slot)) == pid:
                continue
            if lo is None or pid < lo:
                lo = pid
            if not self._mb_match(v, off, tag, wtag, nbytes):
                continue
            if best is None or pid < best[1]:
                best = (slot, pid, off)
        if lo is not None:
            # every pid below the lowest live unclaimed one is retired —
            # re-arms the fast path across gaps left by receiver
            # retractions or tag-mismatched claims
            self._mb_frontier[dest] = max(fr, lo - 1)
        if best is None:
            return None
        slot, pid, off = best
        got = self._mb_commit_claim(dest, slot, pid, off)
        if got is not None and pid == self._mb_frontier.get(dest, 0) + 1:
            self._mb_frontier[dest] = pid
        return got

    # ------------------------------------------------------------------
    # teardown
    # ------------------------------------------------------------------
    def free(self) -> None:
        """Collective communicator teardown: every rank calls it.
        Retracts this rank's live matchbox postings (their destination
        buffers die with the caller), fences so no rank is still mid-
        message, then rank 0 destroys the queue matrix, barrier,
        matchbox and publication objects. Idempotent on every rank."""
        if self._freed:
            return
        self._freed = True
        self._engine.colls.clear()     # abandoned schedule executions
        if self._mb is not None:
            # close spilled postings FIRST: retraction frees slots and
            # would otherwise promote them into a dying matchbox
            for ovf in self._mb_overflow.values():
                for pend in ovf:
                    pend.closed = True
                ovf.clear()
            for rec in list(self._mb_records.values()):
                self._mb_retract(rec)
            self._mb_salvage.clear()
        self.barrier()
        # every rank is out of the data plane: reclaim rendezvous
        # stagers (acked ones were awaiting a _progress sweep that will
        # never come; unacked ones carry messages that die with the
        # communicator)
        for h in self._stagers:
            try:
                self.arena.destroy(h)
            except FileNotFoundError:
                pass
        self._stagers.clear()
        # exit fence: SeqBarrier.wait lets fast ranks return while a
        # laggard is still SCANNING the seq words, so destroying the
        # barrier region right after the barrier could hang it once the
        # heap recycles. Each rank raises its single-writer done byte in
        # the :ok object only AFTER leaving the barrier; rank 0 destroys
        # nothing until every byte is up.
        v = self.arena.view
        v.nt_store_u8(self._ok_obj.offset + self.rank, 1)
        if self.rank == 0:
            spin(lambda: all(v.nt_load_u8(self._ok_obj.offset + r)
                             for r in range(self.size)), 30.0,
                 lambda: "free(): peers never left the teardown fence")
            for h in (self._mq_obj, self._bar_obj, self._mb_obj,
                      self._ok_obj):
                if h is None:               # matchbox may be disabled
                    continue
                try:
                    self.arena.destroy(h)
                except FileNotFoundError:
                    pass

    # ------------------------------------------------------------------
    # blocking pt2pt (implemented over the non-blocking path so every
    # blocking call keeps the progress engine turning)
    # ------------------------------------------------------------------
    def send(self, dest: int, data, tag: int = 0,
             timeout: float | None = 30.0, *,
             _internal: bool = False) -> None:
        """``data``: any buffer-protocol object, a CPU or CUDA tensor,
        or a PoolBuffer/PoolView."""
        self._block(self.isend(dest, data, tag, _internal=_internal),
                    timeout, "send(dest", dest, tag)

    def recv(self, src: int, tag: int = ANY_TAG,
             timeout: float | None = 30.0, *,
             _internal: bool = False) -> tuple[torch.Tensor, int]:
        """Receive the next matching message as a uint8 tensor on this
        communicator's device; returns (payload, tag)."""
        req = self.irecv(src, tag, _internal=_internal)
        self._block(req, timeout, "recv(src", src, tag)
        return req.data, req.tag

    def recv_into(self, src: int, buf, tag: int = ANY_TAG,
                  timeout: float | None = 30.0, *,
                  _internal: bool = False) -> tuple[int, int]:
        """Receive straight into ``buf`` (a CPU or CUDA tensor, a numpy
        array or any writable buffer); returns (nbytes, tag). If the arriving
        message exceeds ``buf`` it is consumed and DISCARDED, and a
        ValueError raised (MPI truncation semantics) — the communicator
        stays usable."""
        req = self.irecv_into(src, buf, tag, _internal=_internal)
        self._block(req, timeout, "recv_into(src", src, tag)
        return req.nbytes, req.tag

    def _block(self, req: Request, timeout: float | None, call: str,
               peer: int, tag: int) -> None:
        """The blocking calls' loop: test ``req`` (each test runs one
        progress sweep) and yield until it completes. While the tracer
        records, the yields and sweeps are counted on the request's
        span."""
        spin(req.test, timeout, lambda: f"{call}={peer}, tag={tag})",
             self.tracer, req._span)

    # numpy convenience — ndarray views end to end, no tobytes/frombuffer
    def send_array(self, dest: int, arr: np.ndarray, tag: int = 0) -> None:
        self.send(dest, np.ascontiguousarray(arr), tag)

    def recv_array(self, src: int, shape, dtype,
                   tag: int = ANY_TAG) -> np.ndarray:
        out = np.empty(shape, dtype)
        n, _ = self.recv_into(src, out, tag)
        if n != out.nbytes:
            raise ValueError(
                f"recv_array: expected {out.nbytes}B for shape {shape} "
                f"dtype {np.dtype(dtype)}, got {n}B")
        return out

    # ------------------------------------------------------------------
    # non-blocking pt2pt
    # ------------------------------------------------------------------
    def isend(self, dest: int, data, tag: int = 0, *,
              _prestaged: Optional[PoolBuffer] = None,
              _internal: bool = False,
              _await_claim: float = 0.0) -> Request:
        """``_prestaged``: a persistent staging buffer (owned by a
        ``PersistentRequest``) refilled in place on a matchbox miss —
        the plan stays claim-aware without per-iteration arena churn.
        ``_internal``: schedule/probe traffic may use the reserved tag
        space user code is fenced out of.
        ``_await_claim``: seconds to keep retrying a missed matchbox
        claim before falling back to the staged path. Persistent CYCLIC
        schedules set it: their pre-post handshake guarantees the
        posting exists (possibly still in the receiver's overflow list
        awaiting promotion into a depth-capped strip), so waiting keeps
        the one-copy path deterministic; the deadline preserves
        liveness if the guarantee is ever violated."""
        tr = self.tracer
        t_in = time.monotonic_ns() if tr.enabled else 0   # the entry
        if int(tag) < 0:
            # ANY_TAG is a receive-side wildcard; a negative wire tag
            # would never match (fail fast on every protocol path alike)
            raise ValueError(f"send tag must be non-negative, got {tag}")
        if int(tag) >= TAG_RESERVED_BASE and not _internal:
            # reserved for collective schedules / probes: ANY_TAG
            # receives skip these tags, so a user send here would park
            # forever against a wildcard receive — reject at the source
            raise ValueError(
                f"tag {tag:#x} is in the reserved internal tag space "
                f"(>= {TAG_RESERVED_BASE:#x})")
        req = Request(kind="send", tag=tag)
        if isinstance(data, PoolBuffer):
            pview: Optional[PoolView] = PoolView(data, 0, data.nbytes)
        elif isinstance(data, PoolView):
            pview = data
        else:
            pview = None
        pbuf = pview.buffer if pview is not None else None
        if pbuf is not None:
            if pbuf._in_flight:
                raise ValueError(
                    "PoolBuffer already has an in-flight send; wait for "
                    "it to complete before sending the buffer again "
                    "(one ack slot per buffer)")
            pbuf._in_flight = True
        mv = None if pview is not None else as_u8(data)
        nbytes = pview.nbytes if pview is not None else len(mv)
        req.nbytes = nbytes
        sp = -1
        if tr.enabled:
            sp = tr.open_span(SP_SEND, tr.cur, self._tsid, self.rank, dest,
                              tr.send_seq(self._tsid, dest), nbytes, t=t_in)
        req._span = req._cur = sp

        def gen():  # mb-writer: sender
            if dest == self.rank:
                if pview is not None:
                    payload = bytes(self.arena.view.read_acquire(
                        pbuf.offset + pview.off, nbytes)) if nbytes else b""
                    pbuf._in_flight = False
                elif is_device(mv):
                    # a device payload stays on the card: clone it there
                    payload = torch.empty_like(mv)
                    copy_bytes_into(payload, mv, tr)
                else:
                    payload = mv.tobytes()
                self._parked[self.rank].append((payload, tag, False))
                if tr.enabled:
                    tr.end_send(sp, PATH_SELF)
                return
            q = self.mq.send_queue(dest)
            v = self.arena.view
            if pview is None and nbytes <= self.eager_threshold:
                # ---- eager: memoryview slices through queue cells ----
                self.eager_sends += 1
                if tr.enabled:
                    tr.emit(EV_PT2PT_EAGER, dest, nbytes, tag)
                for parts, flags in q.plan_message(mv, tag):
                    yield from self._enqueue(q, parts, flags, sp)
                v.count_path("eager", nbytes)
                if tr.enabled:
                    tr.end_send(sp, PATH_EAGER)
                return
            self.rndv_sends += 1
            # ---- posted rendezvous: the receiver advertised its
            # destination — write the payload straight into it (the ONE
            # copy of the whole transfer) and name the entry in the
            # descriptor; per-pair FIFO matching still happens in queue
            # order on the receiver
            claim = self._mb_claim(dest, tag, nbytes, pview is not None)
            if claim is None and _await_claim > 0.0 \
                    and self._mb is not None:
                deadline = time.monotonic() + _await_claim
                while claim is None and time.monotonic() < deadline:
                    yield
                    claim = self._mb_claim(dest, tag, nbytes,
                                           pview is not None)
            if claim is not None:
                slot, pid, dst_off, eoff = claim
                try:
                    if nbytes:
                        src_mv = (self.arena.pool.memview(
                            pbuf.offset + pview.off, nbytes)
                            if pview is not None else mv)
                        v.write_release(dst_off, src_mv)
                        v.count_path("rndv_posted", nbytes)
                except BaseException:
                    v.nt_store_u64(eoff + _MB_CLAIM,
                                   (pid << 2) | _CLAIM_ABORT)
                    raise
                v.nt_store_u64(eoff + _MB_FILL, nbytes)
                # commit AFTER the payload write: the claim word is the
                # staged path's drain-ack byte with the roles reversed
                v.nt_store_u64(eoff + _MB_CLAIM,
                               (pid << 2) | _CLAIM_COMMIT)
                self.posted_sends += 1
                if tr.enabled:
                    tr.emit(EV_PT2PT_POSTED, dest, nbytes, tag)
                # wire: [total u64 | tag u64 | slot u64 | post_id u64]
                desc = (nbytes.to_bytes(8, "little")
                        + (int(tag) & _MB_ANY).to_bytes(8, "little")
                        + slot.to_bytes(8, "little")
                        + pid.to_bytes(8, "little"))
                yield from self._enqueue(
                    q, (desc,),
                    FLAG_FIRST | FLAG_LAST | FLAG_RNDV | FLAG_POSTED, sp)
                if tr.enabled:
                    tr.end_send(sp, PATH_POSTED)
                if pview is not None:
                    # the payload left the source at the write above
                    pbuf._in_flight = False
                return
            # ---- staged rendezvous: stage once, ship a descriptor ----
            if tr.enabled:
                tr.emit(EV_PT2PT_STAGED, dest, nbytes, tag)
            sync_done = None
            if pview is not None:
                # pool-resident source: no staging copy at all
                ack_off = pbuf._handle.offset
                data_off = pbuf.offset + pview.off
                v.nt_store_u8(ack_off, 0)           # arm the ack

                def sync_done():
                    pbuf._in_flight = False
            elif _prestaged is not None:
                # persistent plan: refill the caller's long-lived stager
                ack_off = _prestaged._handle.offset
                data_off = _prestaged.offset
                v.nt_store_u8(ack_off, 0)
                if nbytes:
                    v.write_release(data_off, mv)
                    v.count_path("rndv_staged", nbytes)

                def sync_done():
                    pass
            else:
                ap = -1
                if tr.enabled:
                    ap = tr.open_child(SP_STAGER, sp)
                h = self.arena.create(
                    f"rv:{self.name}:{self.rank}:{dest}:{self._rndv_seq}",
                    _RNDV_CTRL + nbytes)
                if tr.enabled:
                    tr.close_span(ap)
                self._rndv_seq += 1
                ack_off = h.offset
                data_off = h.offset + _RNDV_CTRL
                v.nt_store_u8(ack_off, 0)           # heap memory is dirty
                if nbytes:
                    v.write_release(data_off, mv)
                    v.count_path("rndv_staged", nbytes)
            # wire descriptor: [total u64 | tag u64 | ack u64 | data u64]
            desc = (nbytes.to_bytes(8, "little")
                    + (int(tag) & _MB_ANY).to_bytes(8, "little")
                    + ack_off.to_bytes(8, "little")
                    + data_off.to_bytes(8, "little"))
            yield from self._enqueue(
                q, (desc,), FLAG_FIRST | FLAG_LAST | FLAG_RNDV, sp)
            if tr.enabled:
                tr.end_send(sp, PATH_STAGED)
            if sync_done is not None:
                # synchronous-mode: complete when the receiver drained
                # the staging memory (it is then reusable)
                while not v.nt_load_u8(ack_off):
                    yield
                if tr.enabled:
                    tr.mark(SP_ACK_SEEN, sp)
                sync_done()
            else:
                self._stagers.append(h)             # reclaimed on ack
                if tr.enabled:
                    tr.staged(h.offset, sp)
        req._gen = gen()
        req._comm = self
        self._send_fifo.setdefault(dest, deque()).append(req)
        self._progress()                         # start eagerly (in order)
        return req

    def _enqueue(self, q, parts, flags: int, sp: int):
        """Yield until ``parts`` (one cell's worth) enter the pair queue
        ``q``; while the tracer records, a wait for a free cell is a
        ``pt2pt.queue_full`` span under the send's span ``sp``."""
        tr = self.tracer
        qw = -1
        while not q.try_enqueue_parts(parts, flags):
            if tr.enabled and qw < 0:
                qw = tr.open_child(SP_QUEUE_WAIT, sp)
            yield
        if tr.enabled and qw >= 0:
            tr.close_span(qw)

    def irecv(self, src: int, tag: int = ANY_TAG, *,
              _internal: bool = False) -> Request:
        t_in = time.monotonic_ns() if self.tracer.enabled else 0
        return self._irecv_impl(src, tag, None, _internal=_internal,
                                t_in=t_in)

    def irecv_into(self, src: int, buf, tag: int = ANY_TAG, *,
                   _internal: bool = False) -> Request:
        """``buf``: any writable buffer-protocol object, a PoolBuffer /
        PoolView (pool-resident destination), or a Registration (pinned
        user buffer). Pool-addressable destinations are PUBLISHED in the
        matchbox so a matching sender can deliver the payload with one
        copy and no receiver-side drain (posted rendezvous)."""
        t_in = time.monotonic_ns() if self.tracer.enabled else 0
        return self._irecv_impl(src, tag, self._resolve_dest(buf),
                                _internal=_internal, t_in=t_in)

    def _irecv_impl(self, src: int, tag: int,
                    dest: Optional[_RecvDest], *,
                    _internal: bool = False, t_in: int = 0) -> Request:
        """``t_in``: the post's time where the tracer records (the
        receive's spans start there)."""
        if tag != ANY_TAG and int(tag) >= TAG_RESERVED_BASE \
                and not _internal:
            # mirror of the isend fence: a user receive on a reserved
            # tag could steal a collective schedule round
            raise ValueError(
                f"tag {tag:#x} is in the reserved internal tag space "
                f"(>= {TAG_RESERVED_BASE:#x})")
        req = Request(kind="recv", tag=tag, src=src)
        dst = dest.mv if dest is not None else None
        cap = dest.capacity if dest is not None else 0
        tr = self.tracer
        rsp = wsp = -1
        if tr.enabled:
            rsp = tr.open_span(SP_RECV, tr.cur, self._tsid, src, self.rank,
                               t=t_in)
            wsp = tr.open_span(SP_WAIT, rsp, self._tsid, src, self.rank,
                               t=t_in)
        req._span = req._cur = rsp

        def deliver_bytes(d, t: int) -> None:
            """Parked / staged-pull / salvaged payload (host bytes or a
            device tensor) -> destination."""
            if dest is not None:
                if len(d) > cap:
                    raise ValueError(
                        f"recv_into: message of {len(d)}B exceeds "
                        f"buffer of {cap}B")
                copy_bytes_into(dst[:len(d)], as_u8(d), tr)
                self.arena.view.count_copy(len(d))
                dest.flush(self.arena.view, len(d))
            else:
                req.data = self._as_payload(d)
            req.nbytes, req.tag = len(d), t

        def gen():
            pend = None              # our matchbox intent (live/spilled)

            def secure_dst(rndv: bool):
                """About to deliver a NON-posted payload into the
                destination: withdraw our posting FIRST. A sender may
                already have committed a claim into the same buffer —
                retracting salvages that payload before the delivery
                below overwrites it (the salvage-before-scribble
                ordering the matchbox protocol requires). A posting
                still in the overflow list is unlinked; that counts as
                a capacity miss only when the payload actually RODE a
                rendezvous path (``rndv``) — an eager delivery never
                had a one-copy path to lose, so it must not inflate
                the matchbox sizing signal."""
                self._mb_withdraw(pend, fallback_delivery=rndv)

            try:
                park = self._parked[src]
                while True:
                    for i, (d, t, rv) in enumerate(park):
                        if _tag_match(tag, t):
                            del park[i]
                            secure_dst(rv)
                            deliver_bytes(d, t)
                            return
                    if src == self.rank:
                        yield
                        continue
                    # publish the destination BEFORE draining: a sender
                    # arriving from now on can deliver straight into it.
                    # A full strip SPILLS the posting to the pair's
                    # overflow list (promoted FIFO as entries retire) —
                    # never a lazy retry, never a lost posting.
                    if pend is None and dest is not None \
                            and dest.postable:
                        pend = self._mb_post_or_spill(src, tag, dest,
                                                      req)
                    # per-source matching is ordered: only the EFFECTIVE
                    # HEAD posted receive may drain the pair queue (it
                    # parks foreign tags; two generators interleaving one
                    # message's chunks would corrupt the framing).
                    # Non-head receives above still complete from parked
                    # messages.
                    fifo = self._recv_fifo.get(src)
                    if fifo:
                        while fifo and (fifo[0].done
                                        or fifo[0]._error is not None):
                            fifo.popleft()
                        if fifo and fifo[0] is not req:
                            yield
                            continue
                    q = self.mq.recv_queue(src)
                    scratch = self._cell_scratch
                    out = q.try_dequeue(
                        None if scratch is None else scratch.memview(
                            0, scratch.size))
                    if out is None:
                        yield
                        continue
                    payload, flags = out
                    if not flags & FLAG_FIRST:
                        raise RuntimeError(
                            "cMPI framing error: expected FIRST chunk")
                    total = int.from_bytes(payload[:8], "little")
                    t = int.from_bytes(payload[8:16], "little")
                    match = _tag_match(tag, t)
                    if tr.enabled:
                        dsp = tr.dequeued(rsp, wsp, self._tsid, src,
                                          self.rank, total, match)
                        if dsp >= 0:
                            req._cur = tr.cur = dsp
                    v = self.arena.view
                    # an undersized dst is a truncation error (MPI_ERR_
                    # TRUNCATE): the message is still fully consumed (so
                    # the pair queue stays framed and rendezvous stagers
                    # get ack'd) and then discarded before raising
                    truncate = (match and dest is not None
                                and total > cap)
                    if flags & FLAG_POSTED:
                        # ---- posted rendezvous: the payload already
                        # sits in a buffer THIS rank posted
                        slot = int.from_bytes(payload[16:24], "little")
                        pid = int.from_bytes(payload[24:32], "little")
                        d = self._mb_take(src, slot, pid, total, req)
                        if d is None:
                            # consumed in place by our own posting:
                            # zero receiver-side copies (_mb_take
                            # already recycled the entry)
                            if pend is not None:
                                pend.closed = True
                                pend.rec = None
                            req.nbytes, req.tag = total, t
                            return
                        # salvaged from a foreign/retracted posting —
                        # route it exactly like a parked payload
                        if match:
                            secure_dst(True)
                            deliver_bytes(d, t)
                            return
                        park.append((d, t, True))
                        continue
                    if flags & FLAG_RNDV:
                        # ---- staged rendezvous: bulk-pull from the
                        # pool-resident source (staging object or
                        # PoolBuffer/PoolView)
                        ack_off = int.from_bytes(payload[16:24], "little")
                        data_off = int.from_bytes(payload[24:32], "little")
                        if match and dest is not None and not truncate:
                            secure_dst(True)
                            if total:
                                v.read_acquire_into(data_off, dst[:total])
                                v.count_path("rndv_staged", total)
                            dest.flush(v, total)
                            v.nt_store_u8(ack_off, 1)    # ack the drain
                            if tr.enabled:
                                tr.mark(SP_ACK, req._cur)
                            req.nbytes, req.tag = total, t
                            return
                        if truncate:
                            v.nt_store_u8(ack_off, 1)  # release the sender
                            raise ValueError(
                                f"recv_into: message of {total}B exceeds "
                                f"buffer of {cap}B (message discarded)")
                        if match:
                            # bytes-mode receive: pull straight into the
                            # result buffer (the same one counted read)
                            d = self._new_payload(total)
                            if total:
                                v.read_acquire_into(data_off, d)
                        else:
                            d = (bytes(v.read_acquire(data_off, total))
                                 if total else b"")
                        v.nt_store_u8(ack_off, 1)
                        if tr.enabled and match:
                            tr.mark(SP_ACK, req._cur)
                        if total:
                            v.count_path("rndv_staged", total)
                        if match:
                            req.data = d
                            req.nbytes, req.tag = total, t
                            return
                        park.append((d, t, True))
                        continue
                    # ---- eager: drain chunk cells straight into the sink
                    result = None
                    if match and dest is not None and not truncate:
                        secure_dst(False)
                        sink = dst
                    elif match and dest is None:
                        result = self._new_payload(total)
                        sink = as_u8(result)
                    else:
                        sink = memoryview(bytearray(total))
                    k = min(len(payload) - 16, total)
                    # a device sink takes the chunk from the pinned
                    # landing buffer through the kernel: a rank-private
                    # LocalPool that try_dequeue filled through the
                    # protocol above
                    copy_bytes_into(sink[:k], scratch.device_view(
                        16, k)  # lint: raw-ok (private landing buffer)
                                    if is_device(sink) else
                                    payload[16:16 + k], tr)
                    v.count_copy(k)
                    req._draining = True     # mid-message: not cancellable
                    while k < total:
                        got = q.try_dequeue_into(sink[k:total])
                        if got is None:
                            yield
                            continue
                        k += got[0]
                    req._draining = False
                    v.count_path("eager", total)
                    if truncate:
                        raise ValueError(
                            f"recv_into: message of {total}B exceeds "
                            f"buffer of {cap}B (message discarded)")
                    if match and dest is not None:
                        dest.flush(v, total)
                        req.nbytes, req.tag = total, t
                        return
                    if match:
                        req.data = result
                        req.nbytes, req.tag = total, t
                        return
                    park.append((bytes(sink), t, False))
            finally:
                # completing any way other than our own posted entry
                # (eager, staged, parked, salvage, error, abandonment)
                # leaves that entry live (or spilled) — withdraw it
                # before the user buffer changes owner
                self._mb_withdraw(pend)
                if tr.enabled:
                    tr.recv_done(rsp, wsp, req._cur)
        req._gen = gen()
        req._comm = self        # wait()/test() must pump the send engine
        self._recv_fifo.setdefault(src, deque()).append(req)
        # prime once: a parked match completes immediately, and a
        # postable destination is published before control returns to
        # the caller (the matchbox contract: entries exist BEFORE the
        # sender's descriptor does)
        up = -1
        if tr.enabled:
            up, tr.cur = tr.cur, rsp
        try:
            next(req._gen)
        except StopIteration:
            req._finish()
            req._unpost()
        except BaseException as e:
            req._error = e
            req._unpost()
        finally:
            if tr.enabled:
                tr.cur = up
        return req

    def waitall(self, reqs: list, timeout: float | None = 30.0) -> None:
        """Complete every request — plain pt2pt ``Request``s, persistent
        requests and ``CollRequest``s may be mixed freely. Each sweep
        pumps the SHARED progress engine through every still-pending
        request once, so no request starves behind an earlier one."""
        _waitall(reqs, timeout)

    def waitany(self, reqs: list,
                timeout: float | None = 30.0) -> tuple[int, Any]:
        """Block until ANY of the (mixed-kind) requests completes;
        returns ``(index, request)``."""
        return _waitany(reqs, timeout)

    def testall(self, reqs: list) -> bool:
        """One fair engine sweep across the (mixed-kind) requests;
        True iff all have completed."""
        return _testall(reqs)

    # ------------------------------------------------------------------
    def barrier(self) -> None:
        self._barrier.wait()

    def _collective_window(self, make):
        """Collective window creation: rank 0 creates (``make(True)``),
        the others open-poll until the objects exist, then a barrier."""
        w = make(True) if self.rank == 0 else _open_poll(
            lambda: make(False), 30.0)
        self.barrier()
        return w

    def win_allocate(self, name: str, win_size: int) -> Window:
        """Collective window creation: root creates, others open-poll.

        The window is bound to this communicator, enabling the full RMA
        v2 surface: request-based ``rput``/``rget`` (engine-pumped,
        composable with pt2pt requests in ``waitall``), notified access
        (``put_notify``/``wait_notify``), passive-target
        ``lock_all``/``flush``, and the schedule-compiled window
        collectives (``Window.allgather``/``bcast``). Every RMA byte is
        accounted under ``stats().path_copied_bytes["rma_*"]``."""
        return self._collective_window(lambda create: Window(
            self.arena, name, self.size, self.rank, win_size,
            create=create, comm=self))

    def win_create_dynamic(self, name: str,
                           attach_slots: int = 32) -> DynamicWindow:
        """Collective MPI_Win_create_dynamic: a window with no backing
        arena object. Each rank ``attach``-es pool-resident buffers
        (``PoolBuffer``/``PoolView``/``ObjHandle``) and peers address
        them by the ABSOLUTE pool offset ``attach`` returned — an
        existing KV page is served one-sided without copying it into a
        window arena, and attach/detach themselves move zero payload
        bytes. ``attach_slots`` bounds the per-rank live-region count
        (it sizes the shared attach table, so pass the same value on
        every rank)."""
        return self._collective_window(lambda create: DynamicWindow(
            self.arena, name, self.size, self.rank, create=create,
            comm=self, attach_slots=attach_slots))
