"""The shared progress core: one cooperative engine per communicator.

Every outstanding non-blocking operation — pt2pt sends, posted receives,
rendezvous stager reclaim AND collective schedule executions — is owned
by this engine, and every ``test()`` / ``wait()`` / explicit
``comm.progress()`` turns it. That single rule is what makes the system
composable: a rank blocked in ``recv()`` still advances its neighbour's
``iallreduce``; compute injected between ``iallreduce`` start and
``wait`` needs only an occasional ``comm.progress()`` tick to keep
payloads moving (the overlap column in ``benchmarks/fig5_8_osu.py``).

Layout:

* ``ProgressEngine`` — the per-destination send FIFOs, per-source posted
  receive FIFOs and stager reclaim previously embedded in
  ``Communicator._progress``, plus the list of active schedule
  executions. ``tick()`` is reentrancy-guarded: nodes issued mid-tick
  (a schedule issuing ``isend``) are picked up on the next turn.
* ``_SchedExec`` — one execution of a compiled ``repro_torch.core.sched``
  Schedule: dependency counts, ready queue, in-flight request map.
  Request completion CALLBACKS (``Request._on_done``) retire nodes and
  release their dependents; ``advance()`` issues whatever became ready.
  Receives are issued before sends at every step so pool-resident
  destinations publish their matchbox entries as early as possible.
* ``CollRequest`` — the user-facing handle ``comm.iallreduce`` & friends
  return: ``test()/wait()`` with MPI semantics, ``wait()`` yielding the
  collective's result.
* ``_HeapBufs`` / ``_ResidentBufs`` — the two buffer backends a
  schedule can bind to. Wire format is identical (same tags, sizes,
  rounds), so ranks may disagree on backend choice per collective and
  still interoperate — the same contract the hand-rolled loops kept.

Buffers are torch tensors. A collective over CUDA tensors keeps its
heap slots on the card and views its pool-resident slots through the
pool's device window, so ``ReduceOp`` runs as a torch op on the card
(the reduce never leaves it) and every payload byte between tensor and
pool crosses through the ``cellcopy`` kernel. The stream is synchronised
after each local op, before a send can publish what it wrote.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.pool import (as_u8, copy_bytes_into, device_sync,
                                   is_device)
from repro_torch.core.sched import (BufRef, CopyOp, GetOp, PutOp, RecvOp,
                              ReduceOp, Schedule, SendOp)
from repro_torch.core.trace import (EV_SCHED_ABORT, EV_SCHED_BEGIN,
                              EV_SCHED_DONE, EV_SCHED_END,
                              EV_SCHED_ISSUE, EV_TICK, NULL_TRACER,
                              SP_STAGER_FREE, SP_WAITALL)
from repro_torch.core.wait import Waitable, spin

__all__ = ["ProgressEngine", "CollRequest", "waitall", "waitany",
           "testall"]

# reduce ops given as numpy ufuncs run as their torch counterparts
_NP_TO_TORCH = {np.add: torch.add, np.maximum: torch.maximum,
                np.minimum: torch.minimum, np.multiply: torch.mul}


def torch_op(op):
    """The torch reduce op for ``op`` (a torch binary op taking
    ``out=``, or a numpy ufunc with a torch counterpart)."""
    return _NP_TO_TORCH.get(op, op)


def _copy(dst: torch.Tensor, src: torch.Tensor, tr=NULL_TRACER) -> None:
    copy_bytes_into(as_u8(dst), as_u8(src), tr)


class ProgressEngine:
    """Cooperative progress for one communicator (no threads: progress
    happens inside the caller's test/wait/progress calls, the explicit
    MPI_Test/MPI_Wait model the paper keeps — §3.4)."""

    def __init__(self, comm):
        self.comm = comm
        # one FIFO per destination: a message's chunks must occupy the
        # pair queue CONTIGUOUSLY, so only the head request of each
        # destination is ever pumped
        self.send_fifo: dict[int, deque] = {}
        # posted receives, one FIFO per source (the MPI posted-receive
        # queue): the head drains the pair queue; non-heads may still
        # complete from parked messages or in-place posted deliveries
        self.recv_fifo: dict[int, deque] = {}
        # rendezvous stagers awaiting the receiver's ack
        self.stagers: list = []
        # active collective schedule executions
        self.colls: list[_SchedExec] = []
        self._in_tick = False

    # ------------------------------------------------------------------
    def tick(self) -> None:
        """One cooperative sweep: advance the head send of every
        destination, pump every posted receive, reclaim acked stagers,
        then advance every active collective execution. Reentrant calls
        (a schedule node issuing isend mid-tick) are no-ops."""
        if self._in_tick:
            return
        self._in_tick = True
        tr = self.comm.tracer
        t0 = 0
        up = -1
        if tr.enabled:
            # the sweep turns each request under its own span
            up = tr.cur
            # record only ticks with work in flight — idle spin turns
            # would evict every interesting record from the ring
            if (self.colls or self.stagers
                    or any(self.send_fifo.values())
                    or any(self.recv_fifo.values())):
                t0 = time.monotonic_ns()
        try:
            self._tick_sends()
            self._tick_recvs()
            if self.stagers:
                self._reclaim_stagers()
            if self.colls:
                for ex in list(self.colls):
                    if tr.enabled:
                        tr.cur = ex._sp
                    ex.advance()
                    if ex.finished:
                        try:
                            self.colls.remove(ex)
                        except ValueError:
                            pass
        finally:
            self._in_tick = False
            if tr.enabled:
                tr.cur = up
                if t0:
                    tr.emit(EV_TICK, time.monotonic_ns() - t0)

    def _tick_sends(self) -> None:
        tr = self.comm.tracer
        for fifo in list(self.send_fifo.values()):
            while fifo:
                head = fifo[0]
                if tr.enabled:
                    tr.cur = head._cur
                try:
                    next(head._gen)
                    break                    # blocked on queue space
                except StopIteration:
                    head._finish()
                    fifo.popleft()           # next message may start
                except BaseException as e:
                    # a failed send (e.g. ArenaFullError while staging)
                    # must not be reported done: record it on the
                    # request, unblock the FIFO, surface it to the
                    # caller that pumped progress
                    head._error = e
                    fifo.popleft()
                    raise

    def _tick_recvs(self) -> None:
        tr = self.comm.tracer
        for src, fifo in list(self.recv_fifo.items()):
            while fifo and (fifo[0].done or fifo[0]._error is not None):
                fifo.popleft()
            if not fifo:
                continue
            # Only the effective HEAD of a pair's FIFO can drain the
            # pair queue; a non-head receive can complete solely from
            # PARKED payloads (out-of-order tag matches, salvages, self
            # sends). So the tick pumps the head always, and sweeps the
            # rest only while parked data exists — keeping the per-tick
            # cost O(sources), not O(posted receives). Chunk-granular
            # schedules pre-post dozens of sub-receives per peer; a
            # spin-wait that pumped every one of them each tick would
            # eat the pipelining it exists to drive.
            parked = self._parked_nonempty(src)
            for req in list(fifo) if parked else [fifo[0]]:
                if req.done or req._error is not None:
                    continue
                if tr.enabled:
                    tr.cur = req._cur
                try:
                    next(req._gen)
                except StopIteration:
                    req._finish()            # matched passively
                except BaseException as e:
                    # a failed receive (e.g. truncation) is recorded on
                    # its own request — never surfaced to the innocent
                    # caller that happened to pump progress
                    req._error = e
            while fifo and (fifo[0].done or fifo[0]._error is not None):
                fifo.popleft()

    def _parked_nonempty(self, src: int) -> bool:
        park = getattr(self.comm, "_parked", None)
        if park is None:
            return True                      # unknown comm: pump all
        q = park.get(src)
        return bool(q)

    def _reclaim_stagers(self) -> None:
        v = self.comm.arena.view
        tr = self.comm.tracer
        still = []
        for h in self.stagers:
            if v.nt_load_u8(h.offset):       # receiver ack'd the drain
                fp = -1
                if tr.enabled:
                    fp = tr.open_child(SP_STAGER_FREE, tr.ack_seen(h.offset))
                self.comm.arena.destroy(h)
                if tr.enabled:
                    tr.close_span(fp)
            else:
                still.append(h)
        self.stagers[:] = still

    def add_coll(self, ex: "_SchedExec") -> None:
        self.colls.append(ex)
        ex.advance()                 # pre-post receives before returning


# --------------------------------------------------------------------------
# buffer backends
# --------------------------------------------------------------------------

class _HeapBufs:
    """Plain slots (uint8 tensors on the collective's device): sends are
    tensor views (eager or staged rendezvous on the wire), receives land
    via ``recv_into``. ``bind`` may alias a slot to a caller-owned
    tensor (ibcast receives straight into the user buffer — no
    round-buffer detour)."""

    resident = False
    tr = NULL_TRACER                     # the comm's, for the copies

    def __init__(self, slot_sizes: dict[int, int], device="cpu"):
        self._slots: dict[int, torch.Tensor] = {
            i: torch.zeros(sz, dtype=torch.uint8, device=device)
            for i, sz in slot_sizes.items()}
        self._owned = True               # release() may drop the slots

    @classmethod
    def from_slots(cls, slots: dict[int, torch.Tensor]) -> "_HeapBufs":
        """Wrap CALLER-OWNED slot tensors without copying (persistent
        collectives keep their double-buffered sets across starts) —
        release() must leave them intact for the next iteration."""
        self = cls({})
        self._slots = slots
        self._owned = False
        return self

    def alias(self, slot: int, arr: torch.Tensor) -> None:
        self._slots[slot] = arr.reshape(-1).view(torch.uint8)

    def fill(self, slot: int, data: torch.Tensor, pad_to: int = 0) -> None:
        u8 = data.reshape(-1).view(torch.uint8)
        dst = self._slots[slot]
        _copy(dst[:u8.numel()], u8, self.tr)
        if pad_to > u8.numel():
            dst[u8.numel():pad_to] = 0

    def fill_at(self, slot: int, off: int, data: torch.Tensor) -> None:
        u8 = data.reshape(-1).view(torch.uint8)
        _copy(self._slots[slot][off:off + u8.numel()], u8, self.tr)

    def release(self) -> None:
        if self._owned:
            self._slots = {}

    def send_payload(self, ref: BufRef):
        return self._slots[ref.slot][ref.off:ref.off + ref.nbytes]

    def recv_dest(self, ref: BufRef):
        return self._slots[ref.slot][ref.off:ref.off + ref.nbytes]

    def ndview(self, ref: BufRef, dtype) -> torch.Tensor:
        return self._slots[ref.slot][ref.off:ref.off + ref.nbytes] \
            .view(dtype)


class _ResidentBufs:
    """Pool-resident slots (PoolBuffers): sends are zero-copy PoolView
    slices, receives publish matchbox entries (posted rendezvous — the
    one-copy path). Buffers are leased from the communicator's round
    pool and returned at release, or owned outright (persistent
    collectives pass their own long-lived set). On ``device="cuda"``
    fills, reduces and results go through the pool's device window."""

    resident = True
    tr = NULL_TRACER                     # the comm's, for the copies

    def __init__(self, bufs: dict[int, Any],
                 release_cb: Optional[Callable] = None, device="cpu"):
        self._bufs = bufs
        self._release_cb = release_cb
        self._dev = torch.device(device).type != "cpu"

    def _window(self, slot: int, off: int, n: int, dev: bool):
        pb = self._bufs[slot]
        if dev:
            # the device side of pb.view(): a slot of the rank's own
            # round buffers, filled before a send node publishes it and
            # read after a recv node's acquire
            return pb._comm.arena.pool.device_view(  # lint: raw-ok (own slot)
                pb.offset + off, n)
        return pb.view()[off:off + n]

    def fill(self, slot: int, data: torch.Tensor, pad_to: int = 0) -> None:
        u8 = as_u8(data)
        n = len(u8)
        copy_bytes_into(self._window(slot, 0, n, is_device(u8)), u8,
                        self.tr)
        if pad_to > n:
            self._bufs[slot].view()[n:pad_to] = b"\0" * (pad_to - n)

    def fill_at(self, slot: int, off: int, data: torch.Tensor) -> None:
        u8 = as_u8(data)
        copy_bytes_into(self._window(slot, off, len(u8), is_device(u8)),
                        u8, self.tr)

    def send_payload(self, ref: BufRef):
        return self._bufs[ref.slot].slice(ref.off, ref.nbytes)

    def recv_dest(self, ref: BufRef):
        return self._bufs[ref.slot].slice(ref.off, ref.nbytes)

    def ndview(self, ref: BufRef, dtype) -> torch.Tensor:
        w = self._window(ref.slot, ref.off, ref.nbytes, self._dev)
        if self._dev:
            return w.view(dtype)
        if not ref.nbytes:
            return torch.empty(0, dtype=dtype)
        return torch.frombuffer(w, dtype=dtype)

    def release(self) -> None:
        if self._release_cb is not None:
            self._release_cb()
            self._release_cb = None


# --------------------------------------------------------------------------
# schedule execution
# --------------------------------------------------------------------------

class _SchedExec:
    """One run of a compiled Schedule over a bound buffer backend.

    ``bound_recvs`` (persistent mode) maps recv node idx -> an ALREADY
    POSTED Request from the round-synchronized pre-post handshake; those
    nodes skip issue entirely and complete when their request does.
    ``finalize`` runs once after the last node retires and produces
    ``result``; ``on_abort`` runs once if the execution fails instead (a
    node's request fails, or a node raises as it is issued: a failed
    launch on the card), so a resource held across the execution (the
    window lock of ``raccumulate``) is released either way.
    """

    def __init__(self, comm, sched: Schedule, bufs, tag_base: int,
                 dtype=None, op=None,
                 finalize: Optional[Callable] = None,
                 bound_recvs: Optional[dict[int, Any]] = None,
                 await_claim: float = 0.0, win=None, win_disp: int = 0,
                 rma_path: str = "rma_coll", rma_budget: int = 0,
                 rma_path_put: Optional[str] = None,
                 rma_path_get: Optional[str] = None,
                 on_abort: Optional[Callable] = None):
        self.comm = comm
        self.sched = sched
        self.bufs = bufs
        self.tag_base = tag_base
        self.dtype = dtype
        self.op = torch_op(op)
        # one-sided bindings: Put/Get nodes execute against ``win`` at
        # node.disp + ``win_disp``; their payload bytes are attributed
        # to the ``rma_path`` ProtocolStats bucket. ``rma_budget`` > 0
        # caps Put/Get executions per advance() — a chunked rput/rget
        # then moves one chunk per engine tick instead of memcpy'ing
        # the whole payload inside the first test()/progress() call,
        # which is what lets it overlap the caller's compute.
        self.win = win
        self.win_disp = win_disp
        self.rma_path = rma_path
        # mixed-direction schedules (raccumulate's read-modify-write)
        # attribute their Get chunks and Put chunks to DIFFERENT
        # ProtocolStats buckets; plain rput/rget leave these None and
        # everything lands in ``rma_path``
        self.rma_path_put = rma_path_put or rma_path
        self.rma_path_get = rma_path_get or rma_path
        self.rma_budget = rma_budget
        # persistent cyclic schedules: seconds each send may wait for
        # its guaranteed (but possibly spilled) matchbox posting before
        # falling back to staged — see Communicator.isend(_await_claim)
        self.await_claim = await_claim
        self._finalize = finalize
        self._on_abort = on_abort
        self.finished = False
        self.result = None
        self.error: Optional[BaseException] = None
        nodes = sched.nodes
        # flight recorder: one exec id + interned kind per execution so
        # hot-path records carry ints only; a chunked schedule's nodes
        # then render as per-chunk lanes keyed (exec, node idx)
        # a comm without a tracer (tests building _SchedExec by hand)
        # records into the never-enabled one
        tr = getattr(comm, "tracer", NULL_TRACER)
        self._tr = tr
        bufs.tr = tr
        self._trace_exec = 0
        self._trace_kind = 0
        # the span the execution's work runs under: the collective call
        # that launched it
        self._sp = -1
        if tr.enabled:
            self._sp = tr.cur
            self._trace_exec = tr.next_exec_id()
            self._trace_kind = tr.intern(sched.kind)
            tr.emit(EV_SCHED_BEGIN, self._trace_exec, self._trace_kind,
                    len(nodes))
        self._n_left = len(nodes)
        self._pending = [len(nd.deps) for nd in nodes]
        self._dependents: list[list[int]] = [[] for _ in nodes]
        for nd in nodes:
            for d in nd.deps:
                self._dependents[d].append(nd.idx)
        self._ready: deque[int] = deque()
        # receives first: pool-resident destinations publish their
        # matchbox entries before any send of ours (or, symmetrically,
        # our peer's) goes looking for them
        for nd in nodes:
            if self._pending[nd.idx] == 0 and isinstance(nd, RecvOp):
                self._ready.append(nd.idx)
        for nd in nodes:
            if self._pending[nd.idx] == 0 and not isinstance(nd, RecvOp):
                self._ready.append(nd.idx)
        self._inflight: dict[int, Any] = {}
        self._bound = bound_recvs or {}
        for idx, req in self._bound.items():
            self._watch(idx, req)
        if not nodes:
            self._complete()

    # ------------------------------------------------------------------
    def _watch(self, idx: int, req) -> None:
        self._inflight[idx] = req
        if req.done:
            self._node_done(idx)
        else:
            req._on_done = lambda _r, i=idx: self._node_done(i)  # noqa: E731

    def _node_done(self, idx: int) -> None:
        self._inflight.pop(idx, None)
        tr = self._tr
        if tr.enabled:
            tr.emit(EV_SCHED_DONE, self._trace_exec, idx)
        self._n_left -= 1
        for j in self._dependents[idx]:
            self._pending[j] -= 1
            if self._pending[j] == 0:
                self._ready.append(j)
        if self._n_left == 0:
            self._complete()

    def _complete(self) -> None:
        self.finished = True
        # the finalizer now owns the release: an error raised from here
        # on must not run on_abort a second time
        self._on_abort = None
        tr = self._tr
        if tr.enabled:
            tr.emit(EV_SCHED_END, self._trace_exec)
        try:
            if self._finalize is not None:
                self.result = self._finalize(self.bufs)
        finally:
            self.bufs.release()

    def _abort(self, err: BaseException) -> None:
        """A node's request failed (e.g. truncation): cancel the
        schedule's other in-flight receives — retracting their matchbox
        postings and unlinking them from the posted-receive FIFOs, so
        no stale entry points into these buffers and no dead head
        receive parks later traffic. The buffer set is NOT returned to
        the round pool: a straggler send of the failed collective may
        still land in it, and recycling it would hand that write to an
        unrelated collective."""
        self.error = err
        tr = self._tr
        if tr.enabled:
            tr.emit(EV_SCHED_ABORT, self._trace_exec)
        for req in list(self._inflight.values()):
            if req.kind == "recv" and not req.done:
                req._on_done = None
                req.cancel()
        self._inflight.clear()
        try:
            self.comm._engine.colls.remove(self)
        except ValueError:
            pass
        if self._on_abort is not None:
            cb, self._on_abort = self._on_abort, None
            cb()

    def advance(self) -> None:
        """Issue every ready node. Local nodes (reduce/copy) retire
        immediately and may ready further nodes — the loop drains until
        quiescent. In-flight requests are checked for recorded errors
        so a truncated receive fails the collective, not a bystander."""
        if self.finished or self.error is not None:
            return
        for req in list(self._inflight.values()):
            if req._error is not None:
                self._abort(req._error)
                return
        rma_left = self.rma_budget
        tr = self._tr
        while self._ready:
            idx = self._ready.popleft()
            nd = self.sched.nodes[idx]
            if self.rma_budget and isinstance(nd, (PutOp, GetOp)):
                if rma_left == 0:
                    self._ready.appendleft(idx)   # next tick's chunk
                    break
                rma_left -= 1
            if idx in self._bound:
                continue     # pre-posted: completes via its callback
            if tr.enabled:
                tr.emit(EV_SCHED_ISSUE, self._trace_exec, idx)
            try:
                if isinstance(nd, RecvOp):
                    req = self.comm.irecv_into(
                        nd.peer, self.bufs.recv_dest(nd.buf),
                        tag=self.tag_base + nd.round, _internal=True)
                    self._watch(idx, req)
                elif isinstance(nd, SendOp):
                    req = self.comm.isend(nd.peer,
                                          self.bufs.send_payload(nd.buf),
                                          tag=self.tag_base + nd.round,
                                          _internal=True,
                                          _await_claim=self.await_claim)
                    self._watch(idx, req)
                elif isinstance(nd, ReduceOp):
                    dst = self.bufs.ndview(nd.dst, self.dtype)
                    src = self.bufs.ndview(nd.src, self.dtype)
                    self.op(dst, src, out=dst)
                    if is_device(dst):
                        # the next send publishes these bytes from the pool
                        device_sync(tr)
                    self._node_done(idx)
                elif isinstance(nd, CopyOp):
                    _copy(self.bufs.ndview(nd.dst, torch.uint8),
                          self.bufs.ndview(nd.src, torch.uint8), tr)
                    self._node_done(idx)
                elif isinstance(nd, PutOp):
                    self.win._exec_put(nd.target, self.win_disp + nd.disp,
                                       self.bufs.ndview(nd.buf, torch.uint8),
                                       path=self.rma_path_put)
                    self._node_done(idx)
                elif isinstance(nd, GetOp):
                    self.win._exec_get(nd.target, self.win_disp + nd.disp,
                                       self.bufs.ndview(nd.buf, torch.uint8),
                                       path=self.rma_path_get)
                    self._node_done(idx)
            except Exception as e:
                # a node that cannot be issued fails the whole execution
                self._abort(e)
                raise


class CollRequest(Waitable):
    """Handle for a non-blocking collective (``comm.iallreduce`` and
    friends). ``test()`` pumps the shared progress engine; ``wait()``
    blocks until completion and returns the collective's result (the
    reduced array, the gathered flat array, ``None`` for ibarrier).
    The default ``wait`` timeout scales with the schedule's round
    count (30 s per round, the per-round budget the pre-engine
    blocking loops had). ``Schedule.rounds`` counts SUB-rounds on a
    chunked schedule, so a round that chunking turned into N chunk
    sub-rounds gets N budgets, not one — a multi-GB pipelined
    collective is no longer capped at the message-granular budget.
    Pass ``timeout=None`` to wait forever."""

    kind = "coll"

    def __init__(self, comm, ex: _SchedExec):
        self._comm = comm
        self._ex = ex

    @property
    def default_timeout(self) -> float:
        """30 s per (sub-)round — ``sched.rounds`` is the tag span, which
        chunking expands to the real message count."""
        return 30.0 * max(1, self._ex.sched.rounds)

    @property
    def done(self) -> bool:
        return self._ex.finished

    @property
    def error(self) -> Optional[BaseException]:
        return self._ex.error

    @property
    def result(self):
        return self._ex.result

    def test(self) -> bool:
        if self._ex.error is not None:
            raise self._ex.error
        if not self._ex.finished:
            self._comm._progress()
            if self._ex.error is not None:
                raise self._ex.error
            if not self._ex.finished:
                return False
        tr = self._ex._tr
        if tr.enabled and self._span >= 0:
            tr.close_span(self._span)    # the result is the caller's
            self._span = -1
        return True

    def _outcome(self):
        return self._ex.result

    def _stuck(self) -> str:
        return f"collective {self._ex.sched.kind} timed out"


# --------------------------------------------------------------------------
# fair multi-request completion helpers (pt2pt, persistent, collective)
# --------------------------------------------------------------------------

def _tick_engines(reqs: list) -> None:
    """One tick per DISTINCT engine among the requests (mixed-comm
    request lists are legal): the engine completes every request kind
    in one sweep, so the per-request polls below never need to pump."""
    engines = {id(r._comm._engine): r._comm._engine
               for r in reqs if r._comm is not None}
    for eng in engines.values():
        eng.tick()


def _req_done(r: Waitable) -> bool:
    """Non-pumping completion poll (the engines were already ticked
    this sweep). Raises the request's recorded error, if any."""
    if r.error is not None:
        raise r.error
    return r.done


def waitall(reqs: list, timeout: float | None = 60.0) -> None:
    """Complete every request, pumping the shared engine fairly: each
    sweep ticks each involved engine ONCE, then checks every
    still-pending request (mixed pt2pt / persistent / collective
    requests welcome) — no request starves behind an earlier one and
    no sweep re-pumps the engine per request."""
    pending = list(reqs)
    tr = next((r._comm.tracer for r in pending if r._comm is not None),
              NULL_TRACER)
    sp = -1
    if tr.enabled:
        sp = tr.push_span(SP_WAITALL)

    def swept() -> bool:
        nonlocal pending
        _tick_engines(pending)
        pending = [r for r in pending if not _req_done(r)]
        return not pending

    try:
        spin(swept, timeout, lambda: f"waitall: {len(pending)} pending",
             tr, sp)
    finally:
        if tr.enabled:
            tr.pop_span(sp)


def waitany(reqs: list, timeout: float | None = 60.0) -> tuple[int, Any]:
    """Block until ANY request completes; returns ``(index, request)``.
    Sweeps the whole list each turn — no request starves behind an
    earlier-listed laggard."""
    if not reqs:
        raise ValueError("waitany of an empty request list")
    hit = -1

    def swept() -> bool:
        nonlocal hit
        _tick_engines(reqs)
        hit = next((i for i, r in enumerate(reqs) if _req_done(r)), -1)
        return hit >= 0

    spin(swept, timeout, lambda: "waitany: no request completed")
    return hit, reqs[hit]


def testall(reqs: list) -> bool:
    """One fair sweep: each involved engine ticks once, then every
    request is polled; True iff all have completed."""
    _tick_engines(reqs)
    return all([_req_done(r) for r in reqs])
