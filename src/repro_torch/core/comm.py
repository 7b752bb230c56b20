"""Comm: the cMPI v2 user-facing communicator facade.

The paper presents cMPI as an MPI library; this module is that library's
public surface. ``Comm`` subclasses the pt2pt engine (``Communicator``)
and adds everything an MPI application expects from a first-class
communicator object:

* **Method collectives** — ``comm.bcast / reduce / allreduce / allgather
  / reduce_scatter / alltoall / barrier``. Large payloads are routed
  through a per-comm pool of persistent pool-resident ROUND BUFFERS
  (``_RoundPool``): every ring/Bruck round sends a ``PoolView`` slice of
  a resident buffer, so exchanges ride the zero-sender-copy rendezvous
  path instead of re-staging into a fresh arena object each round (the
  foMPI lesson: route bulk transfers through window/pool-resident
  memory). On pools without raw views (incoherent mode) the methods fall
  back to the protocol-correct view-based algorithms in
  ``core/collectives``.

* **Sub-communicators** — ``comm.split(color, key)`` and ``comm.dup()``
  derive new communicators over the SAME arena with namespaced queue
  matrices and remapped ranks (``sub.parent_ranks`` maps sub-rank ->
  parent rank). Tag spaces are disjoint by construction: each derived
  comm owns its own SPSC queue matrix.

* **Hierarchical allreduce** — ``comm.ihier_allreduce`` compiles
  intra-group ring reduce-scatter -> inter-group recursive doubling ->
  intra-group ring allgather into ONE fused schedule over the parent
  communicator (no sub-comm phase barriers), auto-selected by
  ``allreduce``/``iallreduce`` for large payloads on hier-shaped
  sizes. ``chunk_bytes`` (int or ``"auto"``) additionally pipelines
  every large round at chunk granularity — see ``core/sched.py``.

* **Persistent requests** (MPI-4 style) — ``comm.send_init`` /
  ``comm.recv_init`` return a ``PersistentRequest`` whose
  ``start()/wait()`` pair can be reused across iterations. The wire plan
  (eager vs staged vs pool-resident) is decided ONCE at init; a staged
  persistent send allocates its staging object once and reuses it every
  ``start()`` — no arena create/destroy churn in steady state.

* **Auto-tuned eager threshold** — ``eager_threshold="auto"`` runs a
  one-shot micro-probe at init measuring the eager cell path against the
  rendezvous staging path on this host and records the measured
  crossover (``comm.probed_crossover``).

Tensors in, tensors out: method collectives take CPU or CUDA tensors
(numpy arrays are taken as CPU tensors) and return tensors on the same
device. ``Comm(device="cuda")`` — the default — runs on the card and
raises without one; pass ``device="cpu"`` to run on the CPU. The
one-sided windows (``comm.win_allocate``, ``comm.win_create_dynamic``)
are in ``core/rma.py``.
"""
from __future__ import annotations

import functools
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import collectives as _coll
from repro_torch.core import profile as _profile
from repro_torch.core.arena import Arena, _hash_name
from repro_torch.core.collectives import _is_pow2
from repro_torch.core.pool import (Registration, as_u8, copy_bytes_into,
                                   is_device, readonly)
from repro_torch.core.progress import (CollRequest, _DEFAULT_TIMEOUT, _HeapBufs,
                                 _ResidentBufs, _SchedExec)
from repro_torch.core.pt2pt import (ANY_TAG, DEFAULT_MB_SLOTS, Communicator,
                              PoolBuffer, PoolView, Request, _RNDV_CTRL)
from repro_torch.core.ringqueue import DEFAULT_CELL_SIZE
from repro_torch.core.sched import compile_schedule
from repro_torch.core.trace import (SP_ALLGATHER, SP_ALLREDUCE, SP_ALLTOALL,
                                    SP_BARRIER, SP_BCAST, SP_IALLGATHER,
                                    SP_IALLREDUCE, SP_IBARRIER, SP_IBCAST,
                                    SP_IREDUCE_SCATTER, SP_REDUCE,
                                    SP_REDUCE_SCATTER)

_T = 0x7F000000          # collectives tag space (shared with collectives.py)
_NAME_BUDGET = 24        # derived comm names are hashed beyond this length


def _payload_bytes(args: tuple) -> int:
    """Bytes of a collective call's first argument (a tensor, an array,
    a list of them, or None)."""
    x = args[0] if args else None
    if isinstance(x, (list, tuple)):
        return sum(_payload_bytes((b,)) for b in x)
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(getattr(x, "nbytes", 0))


def _traced(name: int, blocking: bool = True):
    """A collective method that, while the tracer records, is a span:
    ``name``, the communicator's name and the call's number on it (the
    id its members share), the payload's bytes; from entry to the
    result's return (a non-blocking call's span is its request's until
    ``wait`` returns). A call made inside another of the same
    communicator's is part of it. Off, it costs the wrapper's call and
    one check."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(self, *a, **k):
            tr = self.tracer
            if tr.enabled and not self._in_coll:
                sid = self._tsid
                sp = tr.push_span(name, sid, tr.call_seq(sid),
                                  _payload_bytes(a))
                self._in_coll = True
                try:
                    out = fn(self, *a, **k)
                except BaseException:
                    tr.pop_span(sp)
                    raise
                finally:
                    self._in_coll = False
                if blocking:
                    tr.pop_span(sp)
                else:
                    tr.leave_span(sp)
                    out._sp = sp
                return out
            return fn(self, *a, **k)
        return call
    return wrap


def _derived_name(parent: str, suffix: str) -> str:
    """Deterministic (rank-independent) name for a derived communicator,
    kept short enough that pb:/rv: object names stay under NAME_MAX."""
    name = f"{parent}.{suffix}"
    if len(name) > _NAME_BUDGET:
        name = f"c{_hash_name(name.encode(), 0):016x}"
    return name


def _hier_group(n: int, group_size: int | None = None,
                ratio: float | None = None) -> int | None:
    """Group size for the FUSED hierarchical allreduce schedule: must
    divide n with a power-of-two group COUNT (the inter phase is
    recursive doubling), 2 <= g < n. Auto picks the valid divisor
    closest to sqrt(n) — or, when a measured intra/inter tier bandwidth
    ``ratio`` is supplied (machine profile, ``tuning="auto"``), closest
    to sqrt(n * ratio): a faster intra tier carries proportionally more
    of the work, so groups grow with the measured advantage instead of
    assuming the tiers are equal. None when no valid grouping exists
    (primes, odd composites without a power-of-two cofactor, or an
    explicit ``group_size`` the fused schedule cannot honor) — those
    cases run single-level."""
    if group_size is not None:
        g = int(group_size)
        if g < 2 or g >= n or n % g or not _is_pow2(n // g):
            return None
        return g
    cands = [g for g in range(2, n) if n % g == 0 and _is_pow2(n // g)]
    if not cands:
        return None
    target = (n * max(1.0, float(ratio))) ** 0.5 if ratio else n ** 0.5
    return min(cands, key=lambda g: abs(g - target))


class _RoundPool:
    """Per-comm pool of persistent pool-resident round buffers.

    Two allocation styles share it:

    * ``buf`` — role-indexed buffers (0 = working buffer,
      1 = incoming block, 2.. = per-peer alltoall lanes), used by
      ``alltoall``.
    * ``lease``/``release`` — whole SLOT SETS for schedule executions:
      a leased set maps a schedule's slot indices to PoolBuffers and is
      returned to the free list when the execution finalizes, so
      back-to-back collectives reuse one set (flat arena footprint)
      while overlapping collectives (``iallreduce`` alongside an
      ``iallgather``) each hold their own.

    Capacity grows to the high-water mark (rounded to a power of two)
    and is then REUSED — steady-state iterative workloads do zero arena
    create/destroy work.
    """

    def __init__(self, comm: "Comm"):
        self._comm = comm
        self._bufs: dict[int, PoolBuffer] = {}
        self._free_sets: list[dict[int, PoolBuffer]] = []

    def _grow(self, bufs: dict[int, PoolBuffer], idx: int,
              nbytes: int) -> PoolBuffer:
        pb = bufs.get(idx)
        if pb is None or pb.nbytes < nbytes:
            if pb is not None:
                pb.free()
            cap = 1 << max(6, (max(nbytes, 1) - 1).bit_length())
            pb = self._comm.alloc_buffer(cap)
            bufs[idx] = pb
        return pb

    def buf(self, idx: int, nbytes: int) -> PoolBuffer:
        return self._grow(self._bufs, idx, nbytes)

    def lease(self, slot_sizes: dict[int, int]
              ) -> tuple[dict[int, PoolBuffer], Any]:
        """Borrow a slot set sized for ``slot_sizes``; returns
        ``(bufs, release)`` where calling ``release()`` puts the set
        back on the free list."""
        bufs = self._free_sets.pop() if self._free_sets else {}
        for idx, sz in slot_sizes.items():
            self._grow(bufs, idx, sz)

        def release(_b=bufs):
            self._free_sets.append(_b)
        return bufs, release

    def free_all(self) -> None:
        for bufs in [self._bufs] + self._free_sets:
            for pb in bufs.values():
                try:
                    pb.free()
                except FileNotFoundError:
                    pass
            bufs.clear()
        self._free_sets.clear()


class PersistentRequest:
    """MPI-4-style persistent communication request.

    Created by ``Comm.send_init`` / ``Comm.recv_init``; ``start()``
    launches one operation over the pre-planned wire layout, ``wait()``
    (or ``test()``) completes it, and the pair may be repeated any number
    of times. The buffer handed to ``*_init`` is captured as a live view:
    mutate it between iterations, never replace it.

    Send plans, fixed at init time:
      eager   payload <= eager_threshold: chunk through queue cells
      staged  payload  > threshold: ONE persistent pool staging buffer,
              refilled (one counted copy) and re-sent each start() — the
              per-iteration arena create/destroy of a plain ``isend`` is
              gone, so the arena slot count stays constant across
              iterations
      pool    a PoolBuffer/PoolView source: zero sender-side copies
    """

    def __init__(self, comm: "Comm", kind: str, peer: int, buf,
                 tag: int):
        self._comm = comm
        self.kind = kind
        self.peer = peer
        self.tag = tag
        self.started = 0
        self._active: Optional[Request] = None
        self._stager: Optional[PoolBuffer] = None
        self._reg: Optional[Registration] = None
        if kind == "send":
            if isinstance(buf, (PoolBuffer, PoolView)):
                self._mode = "pool"
                self._payload = buf
                self._mv = None
            else:
                self._mv = as_u8(buf)
                if len(self._mv) > comm.eager_threshold:
                    self._mode = "staged"
                    self._stager = comm.alloc_buffer(len(self._mv))
                else:
                    self._mode = "eager"
        else:
            if isinstance(buf, (PoolBuffer, PoolView, Registration)):
                # pool-addressable destination: every start() re-arms a
                # matchbox entry pointing straight at it
                self._dest = buf
                self._mv = None
            else:
                self._mv = as_u8(buf)
                if readonly(self._mv):
                    raise ValueError("recv_init needs a writable buffer")
                if len(self._mv) > comm.eager_threshold \
                        and comm._mb is not None:
                    # pre-post pinning: register the user buffer ONCE so
                    # each start() re-arms the same shadow-backed entry —
                    # flat arena footprint, one receiver-side copy
                    # (shadow -> user) per iteration
                    self._reg = comm.register(self._mv)
                    self._dest = self._reg
                else:
                    self._dest = self._mv
            self._mode = "recv"

    @property
    def active(self) -> bool:
        return self._active is not None and not self._active.done

    def start(self) -> "PersistentRequest":
        if self.active:
            raise RuntimeError(
                "persistent request already active; wait() before "
                "restarting")
        if self.kind == "send":
            if self._mode == "pool":
                self._active = self._comm.isend(self.peer, self._payload,
                                                self.tag)
            elif self._mode == "staged":
                # claim-aware persistent plan: a matchbox hit writes the
                # user buffer straight into the receiver's posted
                # destination (one copy, stager untouched); a miss
                # refills the persistent stager in place — either way,
                # no arena churn per iteration
                self._active = self._comm.isend(
                    self.peer, self._mv, self.tag,
                    _prestaged=self._stager)
            else:
                self._active = self._comm.isend(self.peer, self._mv,
                                                self.tag)
        else:
            self._active = self._comm.irecv_into(self.peer, self._dest,
                                                 self.tag)
        self.started += 1
        return self

    def test(self) -> bool:
        if self._active is None:
            raise RuntimeError("persistent request not started")
        return self._active.test()

    def wait(self, timeout: float | None = 30.0) -> int:
        if self._active is None:
            raise RuntimeError("persistent request not started")
        self._active.wait(timeout)
        return self._active.nbytes

    def cancel(self) -> None:
        """MPI_Cancel on the active iteration (receives only): retracts
        any live matchbox posting and unlinks the posted receive, after
        which ``free()`` is legal.  Best-effort like ``Request.cancel``
        — a receive already draining an eager message completes
        normally.  No-op when idle or on sends."""
        if self._active is not None:
            self._active.cancel()

    def free(self) -> None:
        if self.active:
            raise RuntimeError("cannot free an active persistent request")
        if self._stager is not None:
            self._stager.free()
            self._stager = None
        if self._reg is not None:
            self._reg.free()
            self._reg = None


def startall(reqs: list) -> list:
    """MPI_Startall: start every persistent request in order (pt2pt and
    collective persistent requests may be mixed)."""
    for r in reqs:
        r.start()
    return reqs


class PersistentCollRequest:
    """MPI-4 persistent collective (``comm.allreduce_init(...)``,
    ``comm.bcast_init(...)``, ``comm.allgather_init(...)``).

    The schedule is compiled ONCE at init; buffers are dedicated,
    DOUBLE-BUFFERED pool-resident sets (parity = iteration mod 2); and
    every iteration's receives are posted one iteration AHEAD — the
    round-synchronized pre-post handshake that turns one-shot
    receives' opportunistic matchbox hits into deterministic ones:

    * ``*_init`` (collective) posts iteration 0's receives on every
      rank, then barriers — entries exist before any rank can
      ``start()``.
    * ``start(k)`` posts iteration k+1's receives (parity-swapped
      buffers, parity-salted tags) BEFORE issuing any iteration-k send.

    For CYCLIC schedules — allreduce, ring allgather — a peer can only
    reach its iteration-k+1 sends after its ``wait(k)``, which requires
    receiving data this rank sent in iteration k, i.e. after this
    rank's ``start(k)`` pre-posts. So every rendezvous send of every
    iteration finds its posted entry: a 100% posted-hit rate, asserted
    in ``fig5_8_osu --smoke``. A persistent BCAST has no such cycle
    (the root never receives, so it can outrun a slow subtree by more
    than one iteration); its pre-posting is best-effort — correctness
    is untouched (per-pair FIFO keeps iterations ordered; overruns fall
    back to the staged path), only the hit rate is opportunistic.

    Cross-iteration buffer safety: an iteration-k+1 entry may only be
    claimed by a peer already executing iteration k+1, and any send of
    ours that SOURCES the same parity buffer completed in iteration
    k-1 (its payload left the buffer at stage/claim time before the
    receive that unblocked the peer completed).

    Sizing: full determinism needs ``matchbox_slots >= 2 *
    max-receives-per-peer`` (two iterations' entries coexist) —
    exposed as ``.matchbox_demand``; shallower strips spill postings to
    the per-pair overflow list and promote them FIFO (misses only when
    a payload outruns its promotion, counted in
    ``ProtocolStats.mb_capacity_misses``).

    The bound tensor is captured as a live view: refill it between
    iterations, never replace it. ``wait()`` returns the collective's
    result (the reduced tensor / ``arr`` / the flat gathered payload).
    A C-contiguous numpy array is bound through ``torch.from_numpy``
    (shared memory, so the live view holds).
    """

    def __init__(self, comm: "Comm", arr, op=torch.add,
                 algo: str = "auto", *, kind: str = "allreduce",
                 root: int = 0, chunk_bytes=None):
        self._comm = comm
        if isinstance(arr, np.ndarray) and arr.flags.c_contiguous:
            arr = torch.from_numpy(arr)
        if not (isinstance(arr, torch.Tensor) and arr.is_contiguous()):
            # a list or strided array would silently bind a one-time
            # SNAPSHOT — the per-iteration refills the live-view
            # contract promises would never be seen
            raise ValueError(f"{kind}_init needs a contiguous tensor "
                             "(it is re-read on every start())")
        self._arr = arr
        self.kind = kind
        self.op = op
        self.root = root
        n = comm.size
        rank = comm.rank
        if kind == "allreduce":
            if algo == "auto":
                # same cutoff as every other allreduce surface;
                # recursive doubling additionally doubles the dedicated
                # buffer memory here, so large persistent payloads ride
                # the ring
                algo = _coll.auto_allreduce_algo(n, arr.numel())
            sched_kind = ("allreduce_rd" if algo == "rd"
                          else "allreduce_ring")
        elif kind == "allgather":
            if algo == "auto":
                algo = "bruck" if n >= 8 else "ring"
            sched_kind = ("allgather_bruck" if algo == "bruck"
                          else "allgather_ring")
        elif kind == "bcast":
            algo = "binomial"
            sched_kind = "bcast"
        else:
            raise ValueError(f"unknown persistent collective: {kind}")
        self.algo = algo
        self.started = 0
        self._iter = 0
        self._active: Optional[CollRequest] = None
        self.matchbox_demand = 0
        if n == 1:
            self._sched = None
            return
        nb = _coll.nbytes(arr)
        self._sched = compile_schedule(
            comm, sched_kind, nb, arr.element_size(), root=root,
            chunk_bytes=_coll._resolve_chunk(comm, chunk_bytes, nb))
        # two iterations' postings coexist (double-buffered slots), so
        # demand is twice the schedule's own per-peer pre-post depth
        self.matchbox_demand = 2 * self._sched.required_matchbox_depth()
        # per-iteration fill + finalize, fixed at init like the wire plan
        sched = self._sched
        shape, dtype, count = arr.shape, arr.dtype, arr.numel()
        take = _coll.take
        if kind == "allreduce":
            self._fill = lambda b: b.fill(       # noqa: E731
                0, arr, pad_to=sched.slot_sizes[0])

            def fin(b):
                flat = b.ndview(sched.result, dtype)[:count]
                return take(flat).reshape(shape)
        elif kind == "allgather":
            per_b = nb
            off = 0 if algo == "bruck" else rank * per_b
            self._fill = lambda b: b.fill_at(0, off, arr)  # noqa: E731
            if algo == "bruck":
                def fin(b):
                    work = take(b.ndview(sched.result, dtype)) \
                        .reshape(n, count)
                    return _coll.bruck_to_rank_order(work, rank, n)
            else:
                fin = lambda b: take(              # noqa: E731
                    b.ndview(sched.result, dtype))
        else:                                # bcast
            u8 = arr.reshape(-1).view(torch.uint8)
            self._fill = ((lambda b: b.fill(0, arr)) if rank == root
                          else (lambda b: None))

            def fin(b):
                if rank != root:
                    copy_bytes_into(as_u8(u8), as_u8(
                        b.ndview(sched.result, torch.uint8)))
                return arr
        self._fin = fin
        self._resident = comm._resident
        # CYCLIC schedules (allreduce, allgather) make the pre-post
        # handshake a guarantee: the matching posting always exists by
        # the time a send looks for it, possibly still spilled behind a
        # depth-capped strip. Such sends WAIT for promotion instead of
        # burning the one-copy path — that is what keeps the posted-hit
        # rate deterministically 100% at any matchbox depth. Bcast has
        # no cycle (the root can outrun a slow subtree), so its sends
        # keep the opportunistic claim-or-stage behavior.
        self._await_claim = (5.0 if self._resident and kind != "bcast"
                             else 0.0)
        # parity-salted tag windows: both iterations' receives are
        # posted concurrently, so their tags must differ
        self._bases = (comm._alloc_coll_tags(persistent=True),
                       comm._alloc_coll_tags(persistent=True))
        # dedicated double-buffered slot sets (never shared with the
        # round pool: they must stay stable across iterations)
        self._sets: list[dict] = []
        for _ in range(2):
            if self._resident:
                self._sets.append({
                    i: comm.alloc_buffer(sz)
                    for i, sz in self._sched.slot_sizes.items()})
            else:
                self._sets.append({
                    i: torch.zeros(sz, dtype=torch.uint8, device=arr.device)
                    for i, sz in self._sched.slot_sizes.items()})
        # iteration 0's receives, posted before the init barrier: every
        # rank's entries exist before any rank can start()
        self._next_recvs = self._post_recvs(0)
        comm.barrier()

    def _post_recvs(self, it: int) -> dict[int, Request]:
        """Post every RecvOp of iteration ``it`` (parity buffers,
        parity tags). Pool-resident destinations publish matchbox
        entries immediately."""
        p = it % 2
        base = self._bases[p]
        slots = self._sets[p]
        reqs: dict[int, Request] = {}
        for nd in self._sched.recv_nodes():
            if self._resident:
                dst = slots[nd.buf.slot].slice(nd.buf.off, nd.buf.nbytes)
            else:
                dst = slots[nd.buf.slot][nd.buf.off:
                                         nd.buf.off + nd.buf.nbytes]
            reqs[nd.idx] = self._comm.irecv_into(nd.peer, dst,
                                                 tag=base + nd.round,
                                                 _internal=True)
        return reqs

    @property
    def active(self) -> bool:
        """In flight: started, not finished, and not failed — an
        errored iteration leaves the request inactive so it can be
        restarted or freed (the failed exec already cancelled its
        receives)."""
        return (self._active is not None and not self._active.done
                and self._active.error is None)

    def start(self) -> "PersistentCollRequest":
        if self.active:
            raise RuntimeError("persistent collective already active; "
                               "wait() before restarting")
        comm = self._comm
        if self._sched is None:          # size-1 communicator
            result = (self._arr if self.kind == "bcast"
                      else self._arr.reshape(-1).clone()
                      if self.kind == "allgather" else self._arr.clone())
            self._active = _coll.immediate(comm, result)
            self.started += 1
            return self
        k = self._iter
        self._iter += 1
        p = k % 2
        # THE HANDSHAKE: iteration k+1's receives go up before any
        # iteration-k send is issued (the exec below is what issues
        # sends), so peers that finish k and race into k+1 always find
        # posted entries
        cur = self._next_recvs
        self._next_recvs = self._post_recvs(k + 1)
        slots = self._sets[p]
        bufs = (_ResidentBufs(slots, device=self._arr.device)
                if self._resident else _HeapBufs.from_slots(slots))
        self._fill(bufs)
        ex = _SchedExec(comm, self._sched, bufs, self._bases[p],
                        dtype=self._arr.dtype, op=self.op,
                        finalize=self._fin, bound_recvs=cur,
                        await_claim=self._await_claim)
        comm._engine.add_coll(ex)
        self._active = CollRequest(comm, ex)
        self.started += 1
        return self

    def test(self) -> bool:
        if self._active is None:
            raise RuntimeError("persistent collective not started")
        return self._active.test()

    def wait(self, timeout=_DEFAULT_TIMEOUT) -> torch.Tensor:
        """Default timeout matches CollRequest: 30 s per schedule
        round; pass ``None`` to wait forever."""
        if self._active is None:
            raise RuntimeError("persistent collective not started")
        return self._active.wait(timeout)

    def free(self) -> None:
        """Cancel the pre-posted next-iteration receives (retracting
        their matchbox entries) and release the dedicated buffers.
        Local — but every rank should free before the communicator
        dies."""
        if self.active:
            raise RuntimeError("cannot free an active persistent "
                               "collective")
        if self._sched is None:
            return
        for req in self._next_recvs.values():
            req.cancel()
        self._next_recvs = {}
        if self._resident:
            for slots in self._sets:
                for pb in slots.values():
                    try:
                        pb.free()
                    except FileNotFoundError:
                        pass
        self._sets = []


class Comm(Communicator):
    """First-class cMPI communicator (the v2 public API): method
    collectives, ``split``/``dup``, persistent requests, chunking and
    ``tuning="auto"``, and the one-sided windows (``win_allocate``,
    ``win_create_dynamic``; ``core/rma``)."""

    def __init__(self, arena: Arena, rank: int, size: int, *,
                 cell_size: int = DEFAULT_CELL_SIZE, n_cells: int = 8,
                 eager_threshold: int | str | None = None,
                 mb_slots: int = DEFAULT_MB_SLOTS,
                 matchbox_slots: int | None = None,
                 name: str = "world", open_timeout: float = 30.0,
                 tuning: str | None = None,
                 profile_path: str | None = None,
                 trace=None, device: str = "cuda",
                 _inherit: Optional[dict] = None):
        if tuning not in (None, "auto"):
            raise ValueError(f"tuning must be None or 'auto', "
                             f"got {tuning!r}")
        auto = eager_threshold == "auto"
        self.tuning = tuning
        self._profile_path = profile_path
        # ``tuning="auto"``: load the measured machine profile
        # (benchmarks/roofline.py --profile) and derive every tuned
        # constant from it — eager threshold, chunk floor, hier group
        # ratio, matchbox depth. Missing/stale profiles warn (in
        # load_profile_info) and fall back to the heuristic policies;
        # the rejection REASON is kept (``tuning_status``,
        # ``trace_report()``) so a long-lived process can see why it is
        # running untuned and ``retune()`` after refreshing the profile.
        # Derived comms (split/dup) inherit the parent's state instead.
        prof, prof_reason = (
            _profile.load_profile_info(profile_path)
            if tuning == "auto" and _inherit is None else (None, None))
        if (_inherit is None and prof is not None
                and matchbox_slots is None
                and mb_slots == DEFAULT_MB_SLOTS):
            # matchbox depth from measured strip-scan vs spill-promote
            # cost. The depth sizes the SHARED region before any
            # collective agreement is possible, so it comes
            # deterministically from the shared profile file; the
            # agreement check below hard-fails if ranks diverged (a
            # depth mismatch is a region-layout mismatch).
            matchbox_slots = prof.mb_depth
        super().__init__(arena, rank, size, cell_size=cell_size,
                         n_cells=n_cells,
                         eager_threshold=None if auto else eager_threshold,
                         mb_slots=mb_slots, matchbox_slots=matchbox_slots,
                         name=name, open_timeout=open_timeout, trace=trace,
                         device=device)
        self._derived_seq = 0
        self._rounds = _RoundPool(self)
        self._resident_ok: Optional[bool] = None
        self._chunk_base: Optional[int] = None
        # sub-rank -> parent-comm rank (identity for a root communicator)
        self.parent_ranks: tuple[int, ...] = tuple(range(size))
        self.probed_crossover: Optional[int] = None
        self.probe_mode: Optional[str] = None
        self.profile = prof
        self._tuned: Optional[dict] = None
        # ``retune()`` may re-derive the eager threshold from a fresh
        # profile only when the caller did not pin one explicitly
        self._eager_pinned = not (auto or eager_threshold is None)
        # the ranks that lease round buffers from this arena's pool: the
        # world's size, handed down to split()/dup() children
        self._arena_ranks = (_inherit or {}).get("arena_ranks", size)
        if _inherit is not None:
            # sub-communicators never re-probe or re-agree: the parent
            # already measured (or loaded) the crossover and agreed the
            # wire-shaping values, and the child group is a subset of
            # the ranks that agreed
            self.profile = _inherit.get("profile")
            self.probed_crossover = _inherit.get("probed_crossover")
            self.probe_mode = "inherited"
            self._chunk_base = _inherit.get("chunk_base")
            self._tuned = _inherit.get("tuned")
            self._set_tuning_status(_inherit.get("tuning_reason"))
            return
        if prof is not None:
            # the profile REPLACES the init-time ping-pong probe
            self.probe_mode = "profile"
            self.probed_crossover = prof.eager_crossover
            if auto or eager_threshold is None:
                self.eager_threshold = prof.eager_threshold
        elif auto:
            self.eager_threshold = self._probe_eager_threshold()
        if tuning == "auto":
            self._agree_tuning(prof)
        self._set_tuning_status(prof_reason)

    def _lease_round_bufs(self, slot_sizes: dict[int, int]):
        """Schedule-execution hook (core/collectives launch layer):
        borrow a pool-resident slot set from the round pool."""
        return self._rounds.lease(slot_sizes)

    def _chunk_probe_base(self) -> int:
        """Rank-AGREED basis for ``chunk_bytes="auto"``: the communicator
        maximum of each rank's probed crossover (or eager threshold).
        Per-rank probes may measure different crossovers, but chunk
        counts become sub-round wire tags, so every rank must derive
        the SAME chunk size. Resolved by a tiny max-allreduce the first
        time any collective resolves "auto" — a collective call itself,
        so every rank reaches it together (the MPI calling convention)
        — then cached for the communicator's lifetime."""
        if self._chunk_base is None:
            mine = float(self.probed_crossover or self.eager_threshold)
            if self.size == 1:
                self._chunk_base = int(mine)
            else:
                agreed = _coll.icoll_allreduce(
                    self, torch.tensor([mine], dtype=torch.float64),
                    op=torch.maximum, algo="ring").wait()
                self._chunk_base = int(agreed[0])
        return self._chunk_base

    def _agree_tuning(self, prof) -> None:
        """Rank-agree the profile-derived tuning at init (the
        ``_chunk_probe_base`` idiom, run eagerly): one max-allreduce of
        [crossover, chunk_floor, tier_ratio*1024, mb_depth, -mb_depth].
        Chunk size and matchbox depth shape the wire (sub-round tags /
        shared-region layout), so every rank must hold the SAME values.
        The +depth/-depth pair detects divergence in one max-allreduce
        (max(-d) = -min(d)); a depth mismatch means the shared matchbox
        region was sized differently per rank — unrecoverable, so it
        raises. Ranks whose profile load failed contribute zeros and
        adopt the agreed values, keeping the collective rank-symmetric
        (no deadlock when profile visibility diverges)."""
        vec = torch.tensor([
            float(prof.eager_crossover) if prof else 0.0,
            float(prof.chunk_floor) if prof else 0.0,
            prof.tier_ratio * 1024.0 if prof else 0.0,
            float(self.mb_slots), -float(self.mb_slots)],
            dtype=torch.float64)
        if self.size > 1:
            vec = _coll.icoll_allreduce(self, vec, op=torch.maximum,
                                        algo="ring").wait()
        vec = vec.tolist()
        if vec[3] != -vec[4]:
            raise RuntimeError(
                f"matchbox depth diverged across ranks under "
                f"tuning='auto' (saw depths {int(-vec[4])}..{int(vec[3])})"
                f": the shared strip region layout is inconsistent — "
                f"regenerate artifacts/bench/machine_profile.json or "
                f"pass matchbox_slots explicitly")
        if vec[0] <= 0:
            return                       # no rank had a fresh profile
        self._tuned = {"crossover": int(vec[0]),
                       "chunk_floor": int(vec[1]),
                       "tier_ratio": float(vec[2]) / 1024.0,
                       "mb_depth": int(vec[3])}
        # pre-seed the chunk-agreement base: no later lazy collective
        self._chunk_base = int(vec[0])

    def _set_tuning_status(self, reason: Optional[str]) -> None:
        """Record WHY this communicator is tuned the way it is — the
        state a stale profile used to leave behind only as one
        RuntimeWarning. ``tuning_status["mode"]``:

          off        tuning=None (heuristics by choice)
          profile    fresh machine profile loaded on this rank
          agreed     no local profile, but a peer had one — the agreed
                     wire-shaping values were adopted
          heuristic  tuning="auto" but no rank had a fresh profile
                     (``reason`` says why: missing / stale / unreadable)

        Also mirrored into the Metrics registry (``trace_report()``):
        the ``tuning_profile_loaded`` gauge and, on fallback, the
        ``tuning_heuristic_fallback`` counter."""
        if self.tuning != "auto":
            mode = "off"
        elif self.profile is not None:
            mode = "profile"
        elif self._tuned is not None:
            mode = "agreed"
        else:
            mode = "heuristic"
        self.tuning_status = {"mode": mode, "reason": reason}
        m = self.tracer.metrics
        m.gauge("tuning_profile_loaded",
                1.0 if self.profile is not None else 0.0)
        if mode == "heuristic":
            m.counter("tuning_heuristic_fallback")

    def retune(self, profile_path: str | None = None) -> dict:
        """Collective: re-load the machine profile and re-agree the
        tuned constants — the explicit re-profile path for long-lived
        (serving) processes whose ``Comm(tuning="auto")`` init found a
        stale profile and fell back to heuristics. Run
        ``python -m benchmarks.roofline --profile`` (any time after
        init), then call ``retune()`` on EVERY rank of this
        communicator, in the same order relative to other collectives.

        Re-derives the eager threshold (unless one was pinned at init)
        and re-agrees crossover / chunk floor / tier ratio. The
        matchbox DEPTH cannot change — the shared strip region was
        sized at init — and does not need to: depth only shapes the
        region layout, which stays valid; the agreement check still
        verifies all ranks hold the same depth. Returns the new
        ``tuning_status``."""
        if self.tuning != "auto":
            raise RuntimeError(
                "retune() is only meaningful on a Comm(tuning='auto') "
                "communicator")
        prof, reason = _profile.load_profile_info(
            profile_path if profile_path is not None
            else self._profile_path)
        self.profile = prof
        self._tuned = None
        self._chunk_base = None
        if prof is not None:
            self.probe_mode = "profile"
            self.probed_crossover = prof.eager_crossover
            if not self._eager_pinned:
                self.eager_threshold = prof.eager_threshold
        self._agree_tuning(prof)
        self._set_tuning_status(reason)
        return dict(self.tuning_status)

    def _inherit_state(self) -> dict:
        """Tuning state handed to split()/dup() children: the agreed
        values stay valid on any subset of the agreeing ranks."""
        return {"profile": self.profile,
                "probed_crossover": self.probed_crossover,
                "chunk_base": self._chunk_base,
                "tuned": self._tuned,
                "tuning_reason": getattr(self, "tuning_status",
                                         {}).get("reason"),
                "arena_ranks": self._arena_ranks}

    @property
    def _hier_ratio(self) -> Optional[float]:
        """Measured intra/inter tier bandwidth ratio (None untuned)."""
        return self._tuned["tier_ratio"] if self._tuned else None

    # ------------------------------------------------------------------
    # auto-tuned eager threshold (one-shot init-time micro-probe)
    # ------------------------------------------------------------------
    def _probe_eager_threshold(self, reps: int = 3) -> int:
        """Measure the eager/rendezvous crossover and return the largest
        probed size at which eager still wins.

        With a real peer up (size >= 2), adjacent rank pairs (2i, 2i+1)
        ping-pong each probe size over the ACTUAL wire paths — the eager
        cell walk against the posted-rendezvous matchbox path — so the
        crossover reflects end-to-end cost (descriptor round trip, entry
        scan, claim) rather than the local staging model. The odd rank
        of an odd-sized communicator, and size-1 communicators, fall
        back to the local model. Per-rank and one-shot; thresholds may
        legitimately differ across ranks (the protocol is
        self-describing per message, so asymmetric thresholds are
        safe)."""
        if self.size >= 2 and self.rank < self.size - (self.size % 2):
            self.probe_mode = "peer"
            return self._probe_threshold_peer(reps)
        self.probe_mode = "local"
        return self._probe_threshold_local(reps)

    def _probe_threshold_peer(self, reps: int) -> int:
        """Real-peer probe: for each size, time an eager exchange and a
        posted-rendezvous exchange with the pair partner. The receive is
        posted (pool-resident destination, matchbox entry) BEFORE the
        zero-byte credit that releases the partner's send, so the
        rendezvous leg deterministically measures the posted path when
        the matchbox is enabled."""
        peer = self.rank ^ 1
        cell = self.cell_size
        sizes = [max(64, cell // 4), cell, 2 * cell, 4 * cell, 8 * cell]
        saved = self.eager_threshold
        scratch = memoryview(bytearray(sizes[-1]))
        dst = self.alloc_buffer(sizes[-1]) if self._pool_aliasable() \
            else bytearray(sizes[-1])
        _PRB = _T + 0x4000           # reserved probe tag window

        def exchange(s: int) -> None:
            rreq = self.irecv_into(peer, dst, tag=_PRB + 1,
                                   _internal=True)
            self.send(peer, b"", tag=_PRB + 2, _internal=True)  # credit
            self.recv(peer, tag=_PRB + 2, _internal=True)
            sreq = self.isend(peer, scratch[:s], tag=_PRB + 1,
                              _internal=True)
            rreq.wait()
            sreq.wait()

        def timed(s: int, threshold: int) -> float:
            self.eager_threshold = threshold
            exchange(s)                                  # warm / sync
            t0 = time.perf_counter()
            for _ in range(reps):
                exchange(s)
            return (time.perf_counter() - t0) / reps

        try:
            # probe EVERY size on both ranks (a rank must not stop early
            # — its partner would hang mid-sweep), then decide locally
            timings = [(timed(s, 1 << 40), timed(s, 0)) for s in sizes]
        finally:
            self.eager_threshold = saved
            if isinstance(dst, PoolBuffer):
                dst.free()
        threshold = sizes[-1]            # eager everywhere probed
        for i, (te, tr) in enumerate(timings):
            if tr <= te:
                self.probed_crossover = sizes[i]
                threshold = sizes[i - 1] if i else max(64, sizes[i] // 2)
                break
        return threshold

    def _probe_threshold_local(self, reps: int = 3) -> int:
        """Local staging model: eager (per-cell chunk copies) vs
        rendezvous (arena create + one stage + one bulk read + destroy)
        against this rank's own pool view."""
        v = self.arena.view
        cell = self.cell_size
        sizes = [max(64, cell // 4), cell, 2 * cell, 4 * cell, 8 * cell]
        scratch = memoryview(bytearray(sizes[-1]))
        h = self.arena.create(f"prb:{self.name}:{self.rank}",
                              _RNDV_CTRL + sizes[-1])

        def eager_cost(s: int) -> float:
            t0 = time.perf_counter()
            for _ in range(reps):
                for off in range(0, s, cell):
                    chunk = scratch[off:off + min(cell, s - off)]
                    v.write_release(h.offset + _RNDV_CTRL, chunk)
                    v.read_acquire_into(h.offset + _RNDV_CTRL, chunk)
            return (time.perf_counter() - t0) / reps

        def rndv_cost(s: int) -> float:
            t0 = time.perf_counter()
            for i in range(reps):
                hh = self.arena.create(
                    f"prv:{self.name}:{self.rank}:{i}", _RNDV_CTRL + s)
                v.write_release(hh.offset + _RNDV_CTRL, scratch[:s])
                v.read_acquire_into(hh.offset + _RNDV_CTRL, scratch[:s])
                self.arena.destroy(hh)
            return (time.perf_counter() - t0) / reps

        try:
            eager_cost(sizes[0])                 # warm the path once
            rndv_cost(sizes[0])
            threshold = sizes[-1]                # eager everywhere probed
            for i, s in enumerate(sizes):
                if rndv_cost(s) <= eager_cost(s):
                    self.probed_crossover = s
                    threshold = sizes[i - 1] if i else max(64, s // 2)
                    break
        finally:
            self.arena.destroy(h)
        return threshold

    # ------------------------------------------------------------------
    # sub-communicators
    # ------------------------------------------------------------------
    def split(self, color: int | None, key: int = 0) -> Optional["Comm"]:
        """MPI_Comm_split: collective over this comm. Ranks supplying the
        same ``color`` form a new communicator (ranked by ``(key, parent
        rank)``) over the same arena with its own namespaced queue matrix
        — tag spaces of parent and siblings are disjoint by construction.
        ``color=None`` (MPI_UNDEFINED) participates but receives None."""
        seq = self._derived_seq
        self._derived_seq += 1
        if color is not None and int(color) < 0:
            raise ValueError("color must be a non-negative int or None")
        c = -1 if color is None else int(color)
        mine = torch.tensor([c, int(key), self.rank], dtype=torch.int64)
        table = _coll.allgather_ring(self, mine).reshape(self.size, 3)
        if color is None:
            return None
        members = sorted((k, r) for cc, k, r in table.tolist() if cc == c)
        ranks = [r for _, r in members]
        sub = Comm(self.arena, ranks.index(self.rank), len(ranks),
                   cell_size=self.cell_size, n_cells=self.n_cells,
                   eager_threshold=self.eager_threshold,
                   mb_slots=self.mb_slots,
                   name=_derived_name(self.name, f"s{seq}.{c}"),
                   tuning=self.tuning, trace=self.tracer,
                   device=self.device, _inherit=self._inherit_state())
        sub.parent_ranks = tuple(ranks)
        return sub

    def dup(self) -> "Comm":
        """MPI_Comm_dup: a congruent communicator (same group, same rank
        order) with an independent queue matrix, hence a fully disjoint
        tag/message space."""
        seq = self._derived_seq
        self._derived_seq += 1
        sub = Comm(self.arena, self.rank, self.size,
                   cell_size=self.cell_size, n_cells=self.n_cells,
                   eager_threshold=self.eager_threshold,
                   mb_slots=self.mb_slots,
                   name=_derived_name(self.name, f"d{seq}"),
                   tuning=self.tuning, trace=self.tracer,
                   device=self.device, _inherit=self._inherit_state())
        sub.parent_ranks = self.parent_ranks
        return sub

    def free(self) -> None:
        """Collective MPI_Comm_free: every rank calls it. Releases the
        persistent round buffers, retracts this rank's matchbox postings
        (spilled ones are unlinked first), fences, and finally destroys
        the queue matrix / barrier / matchbox / publication arena
        objects (rank 0, after the fence — no rank is still draining
        them). Idempotent on every rank; the communicator is unusable
        afterwards."""
        if self._freed:
            return
        self._rounds.free_all()
        super().free()

    # ------------------------------------------------------------------
    # observability (core/trace.py)
    # ------------------------------------------------------------------
    def trace_report(self) -> dict:
        """Unified observability view for this rank: flight-recorder
        event counters, the live latency histograms (engine-tick
        duration, posted-rendezvous hit latency, ``wait_notify`` spin),
        registry metrics and the aggregate ``ProtocolStats`` snapshot.
        Meaningful content requires ``Comm(trace=True)`` (or an int
        capacity / injected ``Tracer``); a disabled tracer reports
        zeroes. The ``tuning`` section is always present: mode
        (profile / agreed / heuristic / off) and, on fallback, the
        reason the machine profile was rejected — so an untuned
        long-lived process is visible, not just one init-time
        warning."""
        out = self.tracer.report(stats=self.arena.view.stats)
        out["tuning"] = dict(self.tuning_status)
        return out

    def trace_dump(self, path) -> str:
        """Write this rank's flight-recorder ring + report as a JSON
        dump for ``python -m repro_torch.trace merge|summarize``. Returns the
        written path. Each rank dumps its own file; the CLI stitches
        them into one Chrome/Perfetto timeline (CLOCK_MONOTONIC is
        shared across processes on one host, so no clock alignment is
        needed)."""
        return self.tracer.dump(path, stats=self.arena.view.stats)

    # ------------------------------------------------------------------
    # persistent requests (MPI-4)
    # ------------------------------------------------------------------
    def send_init(self, dest: int, buf, tag: int = 0) -> PersistentRequest:
        return PersistentRequest(self, "send", dest, buf, tag)

    def recv_init(self, src: int, buf, tag: int = ANY_TAG
                  ) -> PersistentRequest:
        return PersistentRequest(self, "recv", src, buf, tag)

    def allreduce_init(self, arr, op=torch.add,
                       algo: str = "auto",
                       chunk_bytes=None) -> PersistentCollRequest:
        """MPI_Allreduce_init: a persistent allreduce over dedicated
        double-buffered round buffers whose receives are pre-posted one
        iteration ahead (deterministic posted-rendezvous hits — see
        ``PersistentCollRequest``). ``chunk_bytes`` (int or "auto")
        pipelines each round at chunk granularity; with the pre-posted
        entries, chunk sends stay on the one-copy path even when a peer
        is late — the receiver reduces each chunk as it lands instead
        of idling until the whole payload arrived. Collective: every
        rank must call it, in the same order relative to other
        collectives. For guaranteed 100% hits size the communicator's
        matchbox to the schedule:
        ``Comm(matchbox_slots=req.matchbox_demand)``."""
        return PersistentCollRequest(self, arr, op, algo,
                                     chunk_bytes=chunk_bytes)

    def bcast_init(self, arr, root: int = 0
                   ) -> PersistentCollRequest:
        """MPI_Bcast_init: persistent binomial-tree broadcast over the
        same double-buffered pre-posting machinery as
        ``allreduce_init``. ``arr`` must be a contiguous tensor of
        identical shape/dtype on every rank; the root refills it
        between iterations, non-roots receive into it in place
        (``wait()`` returns it). Collective."""
        return PersistentCollRequest(self, arr, kind="bcast", root=root)

    def allgather_init(self, shard, algo: str = "auto"
                       ) -> PersistentCollRequest:
        """MPI_Allgather_init: persistent all-gather (``algo``: ring |
        bruck | auto). Refill ``shard`` between iterations; ``wait()``
        returns the flat rank-ordered concatenation. The ring flavour
        is cyclic, so its one-iteration-ahead pre-posting gives the
        same deterministic posted-hit rate as ``allreduce_init``.
        Collective."""
        return PersistentCollRequest(self, shard, algo=algo,
                                     kind="allgather")

    # ------------------------------------------------------------------
    # pool-resident collective machinery
    # ------------------------------------------------------------------
    @property
    def _resident(self) -> bool:
        """True when round buffers can be aliased as raw numpy views:
        memory-backed pool AND hardware-coherent mode. Otherwise the
        methods fall back to the protocol-correct view-based algorithms."""
        if self._resident_ok is None:
            ok = self.arena.view.mode == "coherent"
            if ok:
                try:
                    self.arena.pool.memview(0, 1)
                except TypeError:
                    ok = False
            self._resident_ok = ok
        return self._resident_ok

    def _use_resident(self, nbytes: int) -> bool:
        # small payloads stay on the eager cell path — a descriptor
        # round-trip per round would cost more than it saves
        return self._resident and self.size > 1 \
            and nbytes > self.eager_threshold

    @property
    def lease_cap(self) -> int:
        """Payload bytes that one blocking ``allreduce``,
        ``reduce_scatter`` or ``allgather`` hands to one schedule on the
        pool-resident path: an eighth of a rank's share of the pool.
        Every rank of the arena leases its round buffers from that one
        pool, each communicator keeps slot sets of its own, and a set
        holds about twice its payload rounded up to a power of two. A
        larger payload runs as pieces of at most this size, one after
        another, with the same result layout."""
        return max(1 << 16, self.arena.pool.size // (8 * self._arena_ranks))

    def _piece_elems(self, arr: torch.Tensor, nbytes: int) -> int | None:
        """Elements of ``arr`` a piece holds where a payload of
        ``nbytes`` would lease more than ``lease_cap`` of the pool;
        None where it runs whole."""
        if not (self._use_resident(nbytes) and nbytes > self.lease_cap):
            return None
        return max(1, self.lease_cap // arr.element_size())

    # ------------------------------------------------------------------
    # method collectives: blocking = i*(...).wait() over the SAME
    # compiled schedules (core/sched.py) the non-blocking forms use
    # ------------------------------------------------------------------
    @_traced(SP_BARRIER)
    def barrier(self) -> None:          # inherited seq-number barrier;
        super().barrier()               # restated here as part of the API

    @_traced(SP_IBARRIER, blocking=False)
    def ibarrier(self) -> CollRequest:
        """Non-blocking dissemination barrier (zero-byte message
        rounds through the schedule engine — the seq-number barrier
        cannot be tested incrementally)."""
        return _coll.icoll_barrier(self)

    @_traced(SP_BCAST)
    def bcast(self, arr, root: int = 0) -> torch.Tensor:
        """Binomial-tree broadcast; non-root ranks pass ``arr=None``
        (shape/dtype travel in a fixed-size metadata round). Large
        payloads land once in a resident round buffer and are forwarded
        to every child with zero sender-side copies."""
        return _coll._bcast_impl(self, arr, root,
                                 use_resident=self._use_resident)

    @_traced(SP_IBCAST, blocking=False)
    def ibcast(self, arr: torch.Tensor, root: int = 0,
               chunk_bytes=None) -> CollRequest:
        """Non-blocking broadcast; ``arr`` must be a contiguous
        tensor present with the SAME shape/dtype on every rank (MPI
        ibcast semantics) and is overwritten in place on non-roots
        (non-contiguous buffers are rejected — a silent copy would
        break the in-place contract). ``chunk_bytes`` pipelines the
        binomial tree: interior ranks forward each chunk as it lands.
        ``wait()`` returns ``arr``."""
        return _coll.icoll_bcast_known(
            self, arr, root,
            resident=self._use_resident(_coll.nbytes(arr)),
            chunk_bytes=chunk_bytes)

    @_traced(SP_REDUCE)
    def reduce(self, arr, op=torch.add, root: int = 0
               ) -> torch.Tensor | None:
        arr = _coll.as_tensor(arr)
        return _coll.icoll_reduce(
            self, arr, op, root,
            resident=self._use_resident(_coll.nbytes(arr))).wait()

    @_traced(SP_ALLREDUCE)
    def allreduce(self, arr, op=torch.add, algo: str = "auto",
                  group_size: int | None = None,
                  chunk_bytes=None) -> torch.Tensor:
        """allreduce with automatic algorithm selection: recursive
        doubling (small, pow2 sizes), the fused hierarchical schedule
        (large payloads on hier-shaped sizes), fused ring reduce-scatter
        + allgather otherwise. ``group_size`` applies to ``algo="hier"``;
        ``chunk_bytes`` (int or "auto") pipelines large payloads at
        chunk granularity."""
        arr = _coll.as_tensor(arr)
        if self.size == 1:
            return arr.clone()
        piece = self._piece_elems(arr, _coll.nbytes(arr))
        if piece is not None:
            flat = arr.reshape(-1)
            return torch.cat([
                self.allreduce(flat[a:a + piece], op, algo, group_size,
                               chunk_bytes)
                for a in range(0, flat.numel(), piece)]).reshape(arr.shape)
        if algo == "hier" or (algo == "auto" and group_size is not None):
            # an explicit grouping is a hier request: honoring it under
            # "auto" matches the pre-fused behavior, where auto-selected
            # hier used the caller's group_size
            return self.ihier_allreduce(
                arr, op, group_size=group_size,
                chunk_bytes=chunk_bytes).wait()
        return self.iallreduce(arr, op, algo,
                               chunk_bytes=chunk_bytes).wait()

    @_traced(SP_IALLREDUCE, blocking=False)
    def iallreduce(self, arr, op=torch.add, algo: str = "auto",
                   chunk_bytes=None) -> CollRequest:
        """Non-blocking allreduce: returns a ``CollRequest`` whose
        ``wait()`` yields the reduced array. Inject compute between
        start and wait — sprinkle ``comm.progress()`` ticks through it
        — and the schedule engine overlaps the round exchanges with it
        (``benchmarks/fig5_8_osu.py`` measures the overlap efficiency).
        ``algo``: rd | ring | hier | auto — auto selects the fused
        hierarchical schedule on hier-shaped comms (n >= 4 with a
        power-of-two group count available) for large payloads.
        ``chunk_bytes`` (int or "auto") re-cuts the schedule so every
        round's payload pipelines in chunks — "auto" derives the chunk
        from the init-time eager/posted crossover probe."""
        arr = _coll.as_tensor(arr)
        if algo == "auto":
            if self.size >= 4 and arr.numel() >= 4096 \
                    and _hier_group(self.size,
                                    ratio=self._hier_ratio) is not None:
                algo = "hier"
            else:
                algo = _coll.auto_allreduce_algo(self.size, arr.numel())
        if algo == "hier":
            return self.ihier_allreduce(arr, op, chunk_bytes=chunk_bytes)
        return _coll.icoll_allreduce(
            self, arr, op, algo,
            resident=self._use_resident(_coll.nbytes(arr)),
            chunk_bytes=chunk_bytes)

    @_traced(SP_IALLREDUCE, blocking=False)
    def ihier_allreduce(self, arr, op=torch.add,
                        group_size: int | None = None,
                        chunk_bytes=None) -> CollRequest:
        """Non-blocking HIERARCHICAL allreduce as one fused schedule:
        intra-group ring reduce-scatter -> inter-group recursive
        doubling on the shards -> intra-group ring allgather, all in a
        single DAG over the parent communicator (a blocking sub-comm
        composition would serialize the three phases; here a rank's
        allgather rounds overlap its neighbours' inter-group rounds,
        and chunking pipelines within each phase too). Groups are
        contiguous rank blocks of ``group_size`` (auto: the divisor of
        n closest to sqrt(n) with a power-of-two group count — the
        recursive-doubling requirement). A ``group_size`` the fused
        schedule cannot honor, and sizes with no valid grouping, fall
        back to the single-level fused ring (with a warning when the
        grouping was explicit — the pre-fused sub-comm path accepted
        any divisor)."""
        arr = _coll.as_tensor(arr)
        g = _hier_group(self.size, group_size, ratio=self._hier_ratio)
        if g is None:
            if group_size is not None:
                warnings.warn(
                    f"hier group_size {group_size} needs 2 <= g < n, "
                    f"g | n and a power-of-two group count (n="
                    f"{self.size}); falling back to the single-level "
                    f"fused ring", UserWarning, stacklevel=3)
            return _coll.icoll_allreduce(
                self, arr, op, "ring",
                resident=self._use_resident(_coll.nbytes(arr)),
                chunk_bytes=chunk_bytes)
        return _coll.icoll_allreduce_hier(
            self, arr, op, group=g,
            resident=self._use_resident(_coll.nbytes(arr)),
            chunk_bytes=chunk_bytes)

    @_traced(SP_REDUCE_SCATTER)
    def reduce_scatter(self, arr, op=torch.add,
                       chunk_bytes=None) -> torch.Tensor:
        """Ring reduce-scatter; returns this rank's reduced shard (chunk
        ``(rank+1) % size`` of the zero-padded flat payload). Above
        ``lease_cap`` the (size, chunk) rows run in column pieces."""
        arr = _coll.as_tensor(arr)
        piece = self._piece_elems(arr, _coll.nbytes(arr))
        if piece is None:
            return self.ireduce_scatter(arr, op,
                                        chunk_bytes=chunk_bytes).wait()
        n, flat = self.size, arr.reshape(-1)
        per = -(-flat.numel() // n)
        rows = torch.cat([flat, flat.new_zeros(n * per - flat.numel())]
                         ).reshape(n, per)
        cols = max(1, piece // n)
        return torch.cat([
            self.ireduce_scatter(rows[:, a:a + cols].contiguous(), op,
                                 chunk_bytes=chunk_bytes).wait()
            for a in range(0, per, cols)])

    @_traced(SP_IREDUCE_SCATTER, blocking=False)
    def ireduce_scatter(self, arr, op=torch.add,
                        chunk_bytes=None) -> CollRequest:
        """Non-blocking ring reduce-scatter."""
        arr = _coll.as_tensor(arr)
        return _coll.icoll_reduce_scatter(
            self, arr, op, resident=self._use_resident(_coll.nbytes(arr)),
            chunk_bytes=chunk_bytes)

    @_traced(SP_ALLGATHER)
    def allgather(self, shard, algo: str = "auto",
                  chunk_bytes=None) -> torch.Tensor:
        """All-gather; returns the flat concatenation in rank order.
        ``algo``: ring | bruck | auto (ring for few ranks, Bruck's
        ceil(log2 n) rounds beyond that). Above ``lease_cap`` the shard
        runs in pieces, each gathered into its columns of the (size,
        shard) result."""
        shard = _coll.as_tensor(shard)
        piece = self._piece_elems(shard, _coll.nbytes(shard) * self.size)
        if piece is None:
            return self.iallgather(shard, algo,
                                   chunk_bytes=chunk_bytes).wait()
        flat, n = shard.reshape(-1), self.size
        out = flat.new_empty((n, flat.numel()))
        cols = max(1, piece // n)
        for a in range(0, flat.numel(), cols):
            got = self.iallgather(flat[a:a + cols].contiguous(), algo,
                                  chunk_bytes=chunk_bytes).wait()
            out[:, a:a + cols] = got.reshape(n, -1)
        return out.reshape(-1)

    @_traced(SP_IALLGATHER, blocking=False)
    def iallgather(self, shard, algo: str = "auto",
                   chunk_bytes=None) -> CollRequest:
        """Non-blocking all-gather; ``wait()`` returns the flat
        rank-ordered concatenation."""
        shard = _coll.as_tensor(shard)
        if algo == "auto":
            algo = "bruck" if self.size >= 8 else "ring"
        return _coll.icoll_allgather(
            self, shard, algo,
            resident=self._use_resident(_coll.nbytes(shard) * self.size),
            chunk_bytes=chunk_bytes)

    @_traced(SP_ALLTOALL)
    def alltoall(self, blocks: list) -> list[torch.Tensor]:
        """Pairwise exchange; ``blocks[i]`` goes to rank i. Resident
        path: one persistent round-buffer lane per peer, so all n-1
        sends are outstanding zero-copy PoolViews at once."""
        n, r = self.size, self.rank
        if len(blocks) != n:
            raise ValueError(f"alltoall needs {n} blocks, "
                             f"got {len(blocks)}")
        blocks = [_coll.as_tensor(b) for b in blocks]
        same = all(b.shape == blocks[0].shape and b.dtype == blocks[0].dtype
                   and b.device == blocks[0].device for b in blocks)
        total = sum(_coll.nbytes(b) for b in blocks)
        if n == 1:
            return [blocks[0].clone()]
        if not (same and self._use_resident(total)):
            return _coll.alltoall(self, blocks)
        out: list = [None] * n
        out[r] = _coll.take(blocks[r], self.tracer)
        reqs = []
        for off in range(1, n):
            dst = (r + off) % n
            src = as_u8(blocks[dst])
            pb = self._rounds.buf(1 + off, len(src))
            # the device side of pb.view(): this rank's own round buffer,
            # filled (kernel, then a stream sync) before the isend below
            # publishes it
            lane = (self.arena.pool.device_view(  # lint: raw-ok (own buffer)
                pb.offset, len(src)) if is_device(src)
                else pb.view()[:len(src)])
            copy_bytes_into(lane, src, self.tracer)
            reqs.append(self.isend(dst, pb.slice(0, len(src)),
                                   tag=_T + 1024 + off, _internal=True))
        for off in range(1, n):
            src = (r - off) % n
            out[src] = torch.empty_like(blocks[src])
            self.recv_into(src, out[src], tag=_T + 1024 + off,
                           _internal=True)
        self.waitall(reqs)
        return out
