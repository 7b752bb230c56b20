"""One-sided communication over shared memory (paper §3.2, §3.4) — v2,
rebuilt on the shared schedule/progress core.

A window is ONE arena object sized ``n_ranks * win_size`` laid out
contiguously across ranks (rank i's segment = [i*win_size, (i+1)*win_size)),
exactly the MPI_Win_allocate_shared layout — so any rank computes any other
rank's window address from local information only (base + rank * win_size).

``MPI_Put`` is a plain write_release into the target segment; ``MPI_Get`` a
read_acquire from it. No network, no protocol stack, no target-side
involvement — the entire point of the paper. Every RMA byte is attributed
to a ``ProtocolStats.path_copied_bytes`` bucket:

  ``rma_put``     blocking put/put_from/put_array, rput chunks,
                  the accumulate write-back
  ``rma_get``     blocking get/get_into/get_array, rget chunks,
                  the accumulate read
  ``rma_notify``  the payload of ``put_notify`` (the notified-access
                  fast path — zero receiver-side copies by construction)
  ``rma_coll``    Put/Get nodes of the window collectives
                  (``allgather``/``bcast`` compiled as Schedule DAGs)

Request-based RMA (the foMPI recipe, Gerstenberger et al.): ``rput`` /
``rget`` compile a one-node ``rput``/``rget`` schedule, re-cut by the
standard chunking post-pass (``Comm(tuning="auto")`` chunk policy via
``chunk_bytes="auto"``), and return an engine-pumped ``CollRequest`` —
one chunk moves per progress tick, so a large transfer overlaps the
caller's compute and mixes freely with pt2pt requests in ``waitall``.
Completion is LOCAL completion: the source (rput) or destination (rget)
buffer is free for reuse; because the window is shared memory and every
chunk is a ``write_release``, local completion here also implies the
data is globally visible (``flush`` is still the portable spelling).

Notified access (foMPI's ``MPI_Put_notify`` analogue): ``put_notify``
writes the payload into the target segment and bumps a per-(target,
origin) monotonic u64 notification counter — single-writer, SeqBarrier
discipline, non-temporal stores only. The target's ``wait_notify``
spins on an ``nt_load`` (no payload copy, no matchbox, no descriptor)
and then consumes the data IN PLACE via ``local_view`` — the receiver
side of the transfer copies exactly zero payload bytes.

Synchronization (paper §3.4) lives in a companion object created with the
window: PSCW flag matrices, a seq-number fence barrier, an RW window
lock — all atomics-free — plus the notify counter matrix. Passive-target
epochs come in both MPI flavors: ``lock``/``unlock`` (exclusive or
shared) and ``lock_all``/``unlock_all`` with ``flush``/``flush_local``
completing outstanding requests mid-epoch.

Epoch semantics cheat-sheet (docs/architecture.md has the long form):

  fence        collective; separates epochs for everyone at once
  PSCW         post/start/complete/wait — pairwise exposure/access epochs
  lock(_all)   passive target: the target does not participate at all
  flush        completes OUTSTANDING requests (rput/rget) — an epoch
               boundary for data, not for synchronization

Tensors in, tensors out (the port's idiom). A CUDA tensor put into or
read out of a window crosses the pool through the coherence layer's
``cellcopy`` path (``CoherentView.write_release`` /
``read_acquire_into``, which synchronise the stream before returning),
never through a host bounce; host buffers (bytes, numpy arrays, CPU
tensors) move by host copies exactly as in the JAX package.
``get_array`` returns a tensor on the communicator's device and
``local_view`` a uint8 tensor aliasing this rank's segment there (the
pool's device window on the card). The window and notify-matrix layouts
are the JAX package's, byte for byte.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.arena import Arena, ObjHandle
from repro_torch.core.pool import (Registration, _host_tensor, as_tensor,
                                   as_u8, nbytes, readonly)
from repro_torch.core.progress import (CollRequest, _HeapBufs, _SchedExec,
                                       torch_op)
from repro_torch.core.sched import compile_schedule
from repro_torch.core.sync import PSCW, RWLock, SeqBarrier
from repro_torch.core.trace import (EV_RMA_FENCE_BEGIN, EV_RMA_FENCE_END,
                                    EV_RMA_FLUSH_BEGIN, EV_RMA_FLUSH_END,
                                    EV_RMA_GET, EV_RMA_LOCK_ALL,
                                    EV_RMA_NOTIFY, EV_RMA_PUT,
                                    EV_RMA_UNLOCK_ALL, EV_RMA_WAIT_BEGIN,
                                    EV_RMA_WAIT_END, NULL_TRACER)


def _u8_tensor(buf) -> torch.Tensor:
    """Flat uint8 tensor over a buffer, zero-copy: a tensor's own bytes
    (on its device), or host bytes (bytes, bytearray, memoryview, numpy
    arrays) as a CPU tensor."""
    if isinstance(buf, torch.Tensor):
        if not buf.is_contiguous():
            raise ValueError("a window transfer needs a contiguous tensor")
        return buf.detach().reshape(-1).view(torch.uint8)
    mv = as_u8(buf)
    if not len(mv):
        return torch.empty(0, dtype=torch.uint8)
    return _host_tensor(mv)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype for a torch or numpy dtype (``np.float64``,
    ``"int64"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _notify_bytes(n_ranks: int) -> int:
    """The notify counter matrix: one u64 per (target, origin) pair.
    Word (t, o) is written ONLY by origin o (monotonic increment) and
    read ONLY by target t — the same single-writer discipline as the
    SeqBarrier words, so no atomics are needed."""
    return 8 * n_ranks * n_ranks


class Window:
    """cMPI RMA window for a communicator of ``n_ranks``.

    Construct via ``comm.win_allocate(name, win_size)`` (collective;
    wires the communicator in so the request-based operations and the
    window collectives can use the shared progress engine), or directly
    when only the blocking put/get surface is needed. ``free()`` is
    collective and idempotent.
    """

    # DynamicWindow flips this: no backing ``{name}:w`` arena object —
    # displacements address ATTACHED pool regions instead of segments
    dynamic = False

    def __init__(self, arena: Arena, name: str, n_ranks: int, rank: int,
                 win_size: int, *, create: bool, comm=None):
        self.arena = arena
        self.name = name
        self.n = n_ranks
        self.rank = rank
        self.win_size = win_size
        self._comm = comm
        # windows built without a communicator (direct construction)
        # trace into the never-enabled tracer
        self._tr = getattr(comm, "tracer", None) or NULL_TRACER
        # where get_array results and local views live
        self.device = (torch.device("cpu") if comm is None
                       else comm.device)
        sync_bytes = (SeqBarrier.region_bytes(n_ranks)
                      + PSCW.region_bytes(n_ranks)
                      + RWLock.region_bytes(n_ranks)
                      + _notify_bytes(n_ranks)
                      + self._extra_sync_bytes(n_ranks) + 256)
        if create:
            self.data: ObjHandle | None = (
                None if self.dynamic
                else arena.create(f"{name}:w", n_ranks * win_size))
            self.sync: ObjHandle = arena.create(f"{name}:s", sync_bytes)
        else:
            self.data = None if self.dynamic else arena.open(f"{name}:w")
            self.sync = arena.open(f"{name}:s")
        v = arena.view
        b = self.sync.offset
        fence_off = b
        b += SeqBarrier.region_bytes(n_ranks)
        b += (-b) % 64
        pscw_off = b
        b += PSCW.region_bytes(n_ranks)
        b += (-b) % 64
        lock_off = b
        b += RWLock.region_bytes(n_ranks)
        b += (-b) % 64
        self._notify_off = b
        # subclass region (DynamicWindow's attach table) directly after
        # the notify matrix — 8*n*n bytes keeps it u64-aligned
        self._extra_off = self._notify_off + _notify_bytes(n_ranks)
        self._fence = SeqBarrier(v, fence_off, n_ranks, rank,
                                 initialize=create)
        self._pscw = PSCW(v, pscw_off, n_ranks, rank, initialize=create)
        self._lock = RWLock(v, lock_off, n_ranks, rank, initialize=create)
        if create:
            for i in range(n_ranks * n_ranks):
                v.nt_store_u64(self._notify_off + 8 * i, 0)
        # local notification bookkeeping (single-writer counters):
        # _notify_sent[t] = how many notifies I pushed toward target t;
        # _notify_seen[o] = how many of origin o's notifies I consumed
        self._notify_sent = [0] * n_ranks
        self._notify_seen = [0] * n_ranks
        # outstanding request-based operations, for flush(): (target,
        # CollRequest) pairs, pruned opportunistically
        self._reqs: list = []
        self._freed = False

    def _extra_sync_bytes(self, n_ranks: int) -> int:
        """Bytes a subclass appends to the sync object (laid out at
        ``self._extra_off``); the base window appends none."""
        return 0

    # ------------------------------------------------------------------
    # address arithmetic (the MPI_Win_allocate_shared layout)
    # ------------------------------------------------------------------
    def _addr(self, target: int, disp: int, n: int) -> int:
        if not 0 <= target < self.n:
            raise IndexError(f"target {target}")
        if disp < 0 or disp + n > self.win_size:
            raise IndexError(f"displacement [{disp}, {disp + n}) beyond "
                             f"window of {self.win_size}")
        return self.data.offset + target * self.win_size + disp

    def _notify_word(self, target: int, origin: int) -> int:
        return self._notify_off + 8 * (target * self.n + origin)

    def _require_comm(self):
        if self._comm is None:
            raise RuntimeError(
                "this Window has no communicator attached — create it "
                "via comm.win_allocate() to use request-based RMA and "
                "window collectives")
        return self._comm

    # ------------------------------------------------------------------
    # engine hooks: how a window-bound _SchedExec executes Put/Get nodes
    # ------------------------------------------------------------------
    def _exec_put(self, target: int, disp: int, src,
                  path: str = "rma_coll") -> None:
        mv = as_u8(src)
        n = len(mv)
        self.arena.view.write_release(self._addr(target, disp, n), mv)
        self.arena.view.count_path(path, n)
        tr = self._tr
        if tr.enabled:
            tr.emit(EV_RMA_PUT, target, n)

    def _exec_get(self, target: int, disp: int, dst,
                  path: str = "rma_coll") -> int:
        mv = as_u8(dst)
        n = self.arena.view.read_acquire_into(
            self._addr(target, disp, len(mv)), mv)
        self.arena.view.count_path(path, n)
        tr = self._tr
        if tr.enabled:
            tr.emit(EV_RMA_GET, target, n)
        return n

    # ------------------------------------------------------------------
    # blocking RMA operations
    # ------------------------------------------------------------------
    def put(self, target: int, disp: int, data) -> None:
        """MPI_Put: store ``data`` into rank ``target``'s segment at
        byte displacement ``disp``. Blocking and remotely visible on
        return (write_release). Counts the payload under
        ``path_copied_bytes["rma_put"]``. Epoch precondition: inside
        any access epoch (fence/PSCW start/lock/lock_all) covering
        ``target``."""
        self.put_from(target, disp, data)

    def put_from(self, target: int, disp: int, buf) -> None:
        """``put`` from any C-contiguous buffer-protocol object or tensor
        — the payload moves user buffer -> window exactly once (a CUDA
        tensor's through the ``cellcopy`` kernel)."""
        self._exec_put(target, disp, buf, path="rma_put")

    def get(self, target: int, disp: int, n: int) -> bytes:
        """MPI_Get: load ``n`` bytes from rank ``target``'s segment at
        ``disp``. Blocking; returns fresh ``bytes``. Counts under
        ``path_copied_bytes["rma_get"]``. Same epoch preconditions as
        ``put``."""
        out = self.arena.view.read_acquire(self._addr(target, disp, n), n)
        self.arena.view.count_path("rma_get", n)
        return out

    def get_into(self, target: int, disp: int, dst) -> int:
        """MPI_Get straight into a writable caller buffer; returns bytes
        read. The payload moves window -> destination exactly once.

        ``dst`` accepts the same destination kinds the matchbox posting
        path does (the pt2pt reply-path reuse): a plain writable buffer
        or a CPU or CUDA tensor, a ``PoolBuffer``/``PoolView``
        (pool-resident reply buffer — window -> pool in one protocol
        copy, a host copy inside the pool on every device), or a
        ``Registration`` (pinned user buffer; the get bypasses the
        shadow since the window is locally addressable). Counts the
        payload under ``path_copied_bytes["rma_get"]``."""
        from repro_torch.core.pt2pt import PoolBuffer, PoolView  # cycle
        v = self.arena.view
        if isinstance(dst, PoolBuffer):
            dst = PoolView(dst, 0, dst.nbytes)
        if isinstance(dst, PoolView):
            off = dst.buffer.offset + dst.off
            n = dst.nbytes
            src_addr = self._addr(target, disp, n)
            try:
                alias = self.arena.pool.memview(off, n)
            except TypeError:
                # no raw views (incoherent pool): bounce once, protocol-
                # correct on both legs
                v.write_release(off, v.read_acquire(src_addr, n))
                v.count_path("rma_get", n)
                return n
            n = v.read_acquire_into(src_addr, alias)
            v.count_path("rma_get", n)
            return n
        mv = dst.mv if isinstance(dst, Registration) else as_u8(dst)
        return self._exec_get(target, disp, mv, path="rma_get")

    def put_array(self, target: int, disp: int, arr) -> None:
        """``put`` a tensor or ndarray (made contiguous if needed)."""
        self.put_from(target, disp, as_tensor(arr))

    def get_array(self, target: int, disp: int, shape,
                  dtype) -> torch.Tensor:
        """``get`` into a fresh tensor of ``shape``/``dtype`` (a torch or
        numpy dtype) on the communicator's device."""
        out = torch.empty(shape, dtype=_torch_dtype(dtype),
                          device=self.device)
        self.get_into(target, disp, out)
        return out

    def accumulate(self, target: int, disp: int, arr,
                   op=torch.add) -> None:
        """MPI_Accumulate. CXL pooled memory has no cross-host atomics, so
        atomicity comes from the window lock (paper §3.5 motivation) —
        the read-op-write runs under the EXCLUSIVE window lock and is
        atomic against any other locked access. Counts one ``rma_get``
        plus one ``rma_put`` of the payload. Do not call while already
        holding the window lock (not reentrant).

        Thin blocking wrapper over :meth:`raccumulate` on comm-attached
        windows; a window built without a communicator falls back to
        the synchronous read-op-write (no engine to pump), which runs on
        ``arr``'s device: a CUDA operand's get and put cross the pool
        through ``cellcopy``. ``op`` is a torch binary op or a numpy ufunc
        with a torch counterpart."""
        if self._comm is None:
            arr = as_tensor(arr)
            self._lock.acquire_excl()
            try:
                cur = torch.empty(arr.shape, dtype=arr.dtype,
                                  device=arr.device)
                self.get_into(target, disp, cur)
                self.put_from(target, disp, torch_op(op)(cur, arr))
            finally:
                self._lock.release_excl()
            return
        self.raccumulate(target, disp, arr, op=op).wait()

    def raccumulate(self, target: int, disp: int, arr,
                    op=torch.add, *, chunk_bytes="auto") -> CollRequest:
        """Request-based MPI_Raccumulate: the engine-pumped spelling of
        ``accumulate``. Compiles a three-node ``raccumulate`` schedule
        (GetOp target region -> ReduceOp with the local operand -> PutOp
        the result back), re-cut by the standard chunking post-pass, and
        returns a ``CollRequest`` with the same local-completion/flush
        semantics as ``rput`` — one chunk's read-modify-write per engine
        tick, so a large accumulate overlaps the caller's compute
        instead of stalling the progress engine for the whole reduction.

        Atomicity: the EXCLUSIVE window lock is acquired when the
        request is issued and released when it completes, so the whole
        read-modify-write stays atomic against any other locked access —
        but the lock is held until the request finishes: complete it
        promptly (``wait()``/``flush``/engine pumping), and do not issue
        one while already holding the window lock (not reentrant, like
        ``accumulate``). Counts Get chunks under
        ``path_copied_bytes["rma_get"]`` and Put chunks under
        ``["rma_put"]`` — the same buckets as the blocking form. Do not
        modify ``arr`` before completion. Needs a comm-attached window
        (``comm.win_allocate``).

        The read-modify-write runs on ``arr``'s device: a CUDA operand's
        chunks cross the pool through ``cellcopy`` and the reduce is a
        torch op on the card; a numpy or CPU operand stays on the host.
        ``op`` goes through ``torch_op``, so ``np.add`` and torch ops
        both work."""
        comm = self._require_comm()
        from repro_torch.core.collectives import _resolve_chunk  # cycle
        arr = as_tensor(arr)
        u8 = arr.reshape(-1).view(torch.uint8)
        nbytes = u8.numel()
        self._addr(target, disp, nbytes)     # bounds check BEFORE locking
        cb = _resolve_chunk(comm, chunk_bytes, nbytes)
        sched = compile_schedule(comm, "raccumulate", nbytes,
                                 itemsize=arr.element_size(),
                                 root=target, chunk_bytes=cb)
        bufs = _HeapBufs({1: sched.slot_sizes.get(1, nbytes)},
                         device=arr.device)
        bufs.alias(0, u8)
        self._lock.acquire_excl()

        def fin(_b, n=nbytes):
            # runs in _SchedExec._complete's try/finally after the last
            # node retired; a node that raises instead (a failed launch
            # on the card) aborts the execution, which releases the lock
            # through on_abort and re-raises to the caller
            self._lock.release_excl()
            return n

        ex = _SchedExec(comm, sched, bufs, 0, dtype=arr.dtype, op=op,
                        win=self, win_disp=disp, rma_budget=1,
                        rma_path_put="rma_put", rma_path_get="rma_get",
                        finalize=fin, on_abort=self._lock.release_excl)
        comm._engine.add_coll(ex)
        req = CollRequest(comm, ex)
        self._track(target, req)
        return req

    def local_view(self, disp: int, nbytes: int) -> torch.Tensor:
        """Writable uint8 tensor aliasing THIS rank's own window segment
        on the communicator's device (the pool's device window on the
        card, its host window otherwise) — the in-place consumption path
        for notified access (read the payload where the origin's
        ``put_notify`` left it: zero receiver-side copies, and none
        counted). Raises ``TypeError`` when the backing pool cannot hand
        out raw views (incoherent test pools) — fall back to
        ``get_into`` there. Its bytes are the rank's own segment, which
        the origin's put published before the notification or epoch the
        caller synchronised on."""
        return self.arena.pool.tensor_view(  # lint: raw-ok (own segment)
            self._addr(self.rank, disp, nbytes), nbytes, self.device)

    # ------------------------------------------------------------------
    # request-based RMA (rput/rget — local-completion requests)
    # ------------------------------------------------------------------
    def rput(self, target: int, disp: int, src, *,
             chunk_bytes="auto") -> CollRequest:
        """Request-based put: returns an engine-pumped ``CollRequest``.

        The payload is compiled as a one-node ``rput`` schedule and
        re-cut by the standard chunking post-pass (``chunk_bytes="auto"``
        follows the communicator's tuned chunk policy; pass ``None`` to
        force one monolithic store, or an int byte size). One chunk
        moves per engine tick, so the transfer overlaps compute between
        ``rput`` and ``wait()`` and mixes with pt2pt requests in
        ``comm.waitall``. LOCAL completion: when the request is done the
        source buffer is reusable — and, window memory being shared, the
        data is also already visible at the target (``flush`` is the
        portable spelling of that guarantee). Do not modify ``src``
        before completion. Counts chunks under
        ``path_copied_bytes["rma_put"]``. Needs a comm-attached window
        (``comm.win_allocate``)."""
        comm = self._require_comm()
        from repro_torch.core.collectives import _resolve_chunk  # cycle
        u8 = _u8_tensor(src)
        nbytes = u8.numel()
        self._addr(target, disp, nbytes)     # bounds check up front
        cb = _resolve_chunk(comm, chunk_bytes, nbytes)
        sched = compile_schedule(comm, "rput", nbytes, root=target,
                                 chunk_bytes=cb)
        bufs = _HeapBufs({})
        bufs.alias(0, u8)
        ex = _SchedExec(comm, sched, bufs, 0, win=self, win_disp=disp,
                        rma_path="rma_put", rma_budget=1,
                        finalize=lambda b: nbytes)
        comm._engine.add_coll(ex)
        req = CollRequest(comm, ex)
        self._track(target, req)
        return req

    def rget(self, target: int, disp: int, dst, *,
             chunk_bytes="auto") -> CollRequest:
        """Request-based get into a writable buffer (a CPU or CUDA
        tensor, ndarray, bytearray, memoryview or ``Registration``): the
        chunked mirror of ``rput``. On completion ``dst`` holds the data
        (``wait()`` also returns it). Counts chunks under
        ``path_copied_bytes["rma_get"]``."""
        comm = self._require_comm()
        from repro_torch.core.collectives import _resolve_chunk  # cycle
        mv = dst.mv if isinstance(dst, Registration) else as_u8(dst)
        if readonly(mv):
            raise ValueError("rget needs a writable destination")
        u8 = _u8_tensor(mv)
        nbytes = u8.numel()
        self._addr(target, disp, nbytes)
        cb = _resolve_chunk(comm, chunk_bytes, nbytes)
        sched = compile_schedule(comm, "rget", nbytes, root=target,
                                 chunk_bytes=cb)
        bufs = _HeapBufs({})
        bufs.alias(0, u8)
        ex = _SchedExec(comm, sched, bufs, 0, win=self, win_disp=disp,
                        rma_path="rma_get", rma_budget=1,
                        finalize=lambda b: dst)
        comm._engine.add_coll(ex)
        req = CollRequest(comm, ex)
        self._track(target, req)
        return req

    def _track(self, target: int, req: CollRequest) -> None:
        self._reqs = [(t, r) for t, r in self._reqs if not r.done]
        self._reqs.append((target, req))

    # ------------------------------------------------------------------
    # notified access (foMPI's put_notify analogue)
    # ------------------------------------------------------------------
    def notify(self, target: int) -> None:
        """Bump this origin's notification counter at ``target`` (one
        non-temporal u64 store — no payload, no copies counted). Use
        after ``rput(...).wait()`` + data already in place, or let
        ``put_notify`` pair it with the payload write."""
        self._notify_sent[target] += 1
        self.arena.view.nt_store_u64(
            self._notify_word(target, self.rank),
            self._notify_sent[target])

    def put_notify(self, target: int, disp: int, data) -> None:
        """Notified put: store ``data`` into ``target``'s segment, then
        bump the (target, origin) notification counter the target's
        ``wait_notify`` spins on. The payload moves exactly once
        (origin -> window, counted under
        ``path_copied_bytes["rma_notify"]``); the target consumes it IN
        PLACE via ``local_view`` — the receiver side copies zero bytes,
        deterministically (no matchbox, no descriptor, no drain). The
        counter is monotonic and single-writer (only this origin writes
        this word), so back-to-back notifies queue naturally — but
        successive payloads to the SAME displacement overwrite, so wait
        for the consumer (e.g. a reply notify) before reusing a slot."""
        mv = as_u8(data)
        n = len(mv)
        self.arena.view.write_release(self._addr(target, disp, n), mv)
        self.arena.view.count_path("rma_notify", n)
        self.notify(target)
        tr = self._tr
        if tr.enabled:
            tr.emit(EV_RMA_NOTIFY, target, n)

    def test_notify(self, origin: int) -> int:
        """Number of UNCONSUMED notifications from ``origin`` (does not
        consume; one nt_load)."""
        cur = self.arena.view.nt_load_u64(
            self._notify_word(self.rank, origin))
        return cur - self._notify_seen[origin]

    def wait_notify(self, origin: int, *, count: int = 1,
                    timeout: float | None = 30.0) -> int:
        """Block until ``count`` notifications from ``origin`` arrived;
        consumes and returns them. Spins on one non-temporal load —
        zero payload copies on this side — while pumping the attached
        communicator's progress engine (if any) so outstanding requests
        keep moving."""
        tr = self._tr
        if tr.enabled:
            tr.emit(EV_RMA_WAIT_BEGIN, origin)
        t0 = time.monotonic()
        while True:
            pending = self.test_notify(origin)
            if pending >= count:
                self._notify_seen[origin] += count
                if tr.enabled:
                    tr.emit(EV_RMA_WAIT_END, origin)
                return count
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"wait_notify: {pending}/{count} notifications "
                    f"from rank {origin}")
            if self._comm is not None:
                self._comm._progress()
            time.sleep(0)

    # ------------------------------------------------------------------
    # window collectives (RMA-based, compiled as Schedule DAGs)
    # ------------------------------------------------------------------
    def iallgather(self, shard, *, chunk_bytes=None) -> CollRequest:
        """Nonblocking get-based allgather over the window: each rank
        publishes its shard into its OWN segment (disp 0), then every
        rank GETS every other segment directly — payloads never ride
        the wire, only zero-byte ready/done tokens do (2(n-1) empty
        messages). ``wait()`` returns the rank-ordered flat tensor, on
        the shard's device.
        Needs ``shard.nbytes <= win_size``; Put/Get bytes land in
        ``path_copied_bytes["rma_coll"]``. Collective: all ranks call
        with equal-size shards, in the same order relative to every
        other collective on this communicator (shared tag sequence)."""
        comm = self._require_comm()
        from repro_torch.core.collectives import (_launch, _resolve_chunk,
                                                  immediate, take)
        shard = as_tensor(shard)
        per_b, dtype = nbytes(shard), shard.dtype
        if per_b > self.win_size:
            raise ValueError(f"shard of {per_b} B exceeds window "
                             f"segment of {self.win_size} B")
        if comm.size == 1:
            return immediate(comm, shard.reshape(-1).clone())
        cb = _resolve_chunk(comm, chunk_bytes, per_b)
        sched = compile_schedule(comm, "allgather_get", per_b,
                                 shard.element_size(), chunk_bytes=cb)
        bufs = _HeapBufs(sched.slot_sizes, device=shard.device)
        bufs.fill_at(0, comm.rank * per_b, shard)
        fin = lambda b: take(b.ndview(sched.result, dtype))  # noqa: E731
        return _launch(comm, sched, bufs, dtype, None, fin, win=self)

    def allgather(self, shard) -> torch.Tensor:
        """Blocking wrapper over ``iallgather``."""
        return self.iallgather(shard).wait()

    def ibcast(self, arr, root: int = 0, *,
               chunk_bytes=None) -> CollRequest:
        """Nonblocking put-based binomial-tree bcast over the window:
        each parent PUTS the payload into its child's own segment and
        follows with a zero-byte token; the child lands it from its
        segment into ``arr`` IN PLACE and forwards. ``arr`` must be a
        contiguous tensor (or a C-contiguous ndarray, wrapped without a
        copy) of identical shape/dtype on every rank (MPI bcast-known
        semantics); ``wait()`` returns it as a tensor. Chunked, a child
        forwards chunk c the moment chunk c landed — the pipelined tree.
        Needs ``arr.nbytes <= win_size``. Same calling-order contract as
        ``iallgather``."""
        comm = self._require_comm()
        from repro_torch.core.collectives import (_launch, _resolve_chunk,
                                                  immediate)
        if isinstance(arr, np.ndarray) and arr.flags.c_contiguous:
            arr = torch.from_numpy(arr)      # shares the caller's memory
        if not (isinstance(arr, torch.Tensor) and arr.is_contiguous()):
            raise ValueError("ibcast needs a contiguous tensor "
                             "(the payload is delivered in place)")
        nb = nbytes(arr)
        if nb > self.win_size:
            raise ValueError(f"payload of {nb} B exceeds window "
                             f"segment of {self.win_size} B")
        if comm.size == 1:
            return immediate(comm, arr)
        cb = _resolve_chunk(comm, chunk_bytes, nb)
        sched = compile_schedule(comm, "bcast_put", nb,
                                 arr.element_size(), root=root,
                                 chunk_bytes=cb)
        bufs = _HeapBufs({})                 # slot 0 IS the user tensor
        bufs.alias(0, arr)
        return _launch(comm, sched, bufs, arr.dtype, None,
                       lambda b: arr, win=self)

    def bcast(self, arr, root: int = 0) -> torch.Tensor:
        """Blocking wrapper over ``ibcast``."""
        return self.ibcast(arr, root).wait()

    # ------------------------------------------------------------------
    # synchronization (paper §3.4)
    # ------------------------------------------------------------------
    def fence(self) -> None:
        """Collective epoch separator (MPI_Win_fence): completes this
        rank's outstanding requests (local flush), then joins the
        seq-number barrier. On return, every rank's RMA ops from the
        previous epoch are globally visible."""
        tr = self._tr
        if tr.enabled:
            tr.emit(EV_RMA_FENCE_BEGIN)
        self.flush()
        self._fence.wait()
        if tr.enabled:
            tr.emit(EV_RMA_FENCE_END)

    # PSCW
    def post(self, origins: list[int]) -> None:
        """Open an EXPOSURE epoch toward ``origins`` (MPI_Win_post):
        they may access this rank's segment once their ``start``
        returns. Pair with ``wait``."""
        self._pscw.post(origins)

    def start(self, targets: list[int]) -> None:
        """Open an ACCESS epoch toward ``targets`` (MPI_Win_start):
        blocks until each has posted. Pair with ``complete``."""
        self._pscw.start(targets)

    def complete(self, targets: list[int]) -> None:
        """Close the access epoch (MPI_Win_complete): flushes this
        rank's outstanding requests first so the targets observe
        everything issued inside the epoch."""
        self.flush()
        self._pscw.complete(targets)

    def wait(self, origins: list[int]) -> None:
        """Close the exposure epoch (MPI_Win_wait): returns once every
        origin called ``complete``."""
        self._pscw.wait(origins)

    # lock-unlock (passive target)
    def lock(self, shared: bool = False) -> None:
        """Passive-target epoch on the window lock (MPI_Win_lock;
        window-global, not per-rank): exclusive by default, ``shared``
        for concurrent readers/accumulators. The target rank does not
        participate."""
        if shared:
            self._lock.acquire_shared()
        else:
            self._lock.acquire_excl()

    def unlock(self, shared: bool = False) -> None:
        """Close a ``lock`` epoch; flushes outstanding requests first
        (MPI unlock completion semantics)."""
        self.flush()
        if shared:
            self._lock.release_shared()
        else:
            self._lock.release_excl()

    def lock_all(self) -> None:
        """Passive-target epoch on ALL ranks at once (MPI_Win_lock_all:
        shared mode by definition — concurrent lock_all epochs on
        different ranks proceed in parallel; exclusive access still
        goes through ``lock()``). Complete individual transfers inside
        the epoch with ``flush``/``flush_local``."""
        self._lock.acquire_shared()
        tr = self._tr
        if tr.enabled:
            tr.emit(EV_RMA_LOCK_ALL)

    def unlock_all(self) -> None:
        """Close the ``lock_all`` epoch: flushes every outstanding
        request, then releases the shared lock."""
        self.flush()
        self._lock.release_shared()
        tr = self._tr
        if tr.enabled:
            tr.emit(EV_RMA_UNLOCK_ALL)

    def flush(self, target: int | None = None,
              timeout: float | None = 60.0) -> None:
        """Complete outstanding ``rput``/``rget`` requests to ``target``
        (all targets when ``None``), pumping the progress engine. On a
        shared-memory window remote completion and local completion
        coincide — when ``flush`` returns, the data IS in the target
        segment (each chunk was a write_release)."""
        tr = self._tr
        tgt = -1 if target is None else target
        if tr.enabled:
            tr.emit(EV_RMA_FLUSH_BEGIN, tgt)
        keep = []
        for t, r in self._reqs:
            if target is None or t == target:
                r.wait(timeout)
            elif not r.done:
                keep.append((t, r))
        self._reqs = keep
        if tr.enabled:
            tr.emit(EV_RMA_FLUSH_END, tgt)

    def flush_local(self, target: int | None = None,
                    timeout: float | None = 60.0) -> None:
        """MPI_Win_flush_local: completes the LOCAL side (source/dest
        buffers reusable). Identical to ``flush`` here — shared-memory
        chunks are remotely visible the instant they complete locally —
        kept as a distinct spelling so programs stay portable to
        transports where the two differ."""
        self.flush(target, timeout)

    def free(self) -> None:
        """Collective MPI_Win_free: every rank calls it. Completes this
        rank's outstanding requests, fences so no rank is still inside
        an access/exposure epoch when the backing objects go away, then
        rank 0 destroys them. Idempotent on every rank (a second call
        is a no-op), and safe for ranks that are mid-epoch — a held
        lock or an un-waited PSCW epoch is plain shared state that dies
        with the sync object, and the fence orders every rank's last
        RMA op before the destroy. Note: the destroy itself happens
        after the final sync point, so do not re-create a window under
        the same name without an external barrier."""
        if self._freed:
            return
        self._freed = True
        self.flush()
        self._fence.wait()
        if self.rank == 0:
            try:
                if self.data is not None:
                    self.arena.destroy(self.data)
                self.arena.destroy(self.sync)
            except FileNotFoundError:
                pass


class DynamicWindow(Window):
    """MPI_Win_create_dynamic analogue: a window with NO backing arena
    object — displacements are ABSOLUTE pool offsets into regions the
    owning rank has ``attach``-ed, so an existing pool-resident buffer
    (a ``PoolBuffer`` KV page, an ``ObjHandle``) is exposed one-sided
    WITHOUT copying it into a window arena. The whole pool being one
    flat shared mapping is exactly MPI's dynamic-window absolute-address
    model: ``attach`` returns the region's pool offset, peers use that
    offset as ``disp`` in put/get/rput/rget/raccumulate.

    The attach table lives in the shared sync object: per-rank rows of
    ``attach_slots`` (offset u64, len u64) entries, single-writer (only
    the owning rank stores its row) like the notify matrix — so
    ``_addr`` gives REAL remote bounds checking by scanning the target's
    published row (an unattached or detached address raises
    ``IndexError``, the same contract as a static window's bounds
    check). Publication order is offset-then-len and detach tombstones
    the len word, so a concurrent reader never sees a torn live entry.
    Attach/detach are pure nt-word stores: no payload moves, nothing is
    counted in ``ProtocolStats`` (regression-tested).

    The full sync surface (fence/PSCW/lock/notify) and the request-based
    operations work unchanged; the window COLLECTIVES
    (``iallgather``/``ibcast``) need per-rank segments and therefore a
    ``win_allocate`` window. ``local_view(disp, nbytes)`` aliases any
    region attached by THIS rank. Construct via
    ``comm.win_create_dynamic(name)``."""

    dynamic = True

    def __init__(self, arena: Arena, name: str, n_ranks: int, rank: int,
                 *, create: bool, comm=None, attach_slots: int = 32):
        if attach_slots < 1:
            raise ValueError(f"attach_slots must be >= 1, "
                             f"got {attach_slots}")
        self._attach_slots = attach_slots
        super().__init__(arena, name, n_ranks, rank, 0, create=create,
                         comm=comm)
        self._attach_off = self._extra_off
        # local mirror of this rank's row: slot -> (offset, len)
        self._mine: list = [None] * attach_slots
        if create:
            v = arena.view
            for i in range(2 * n_ranks * attach_slots):
                v.nt_store_u64(self._attach_off + 8 * i, 0)

    def _extra_sync_bytes(self, n_ranks: int) -> int:
        return 16 * n_ranks * self._attach_slots

    def _row(self, rank: int) -> int:
        return self._attach_off + 16 * self._attach_slots * rank

    @staticmethod
    def _resolve_region(buf) -> tuple[int, int]:
        """(pool offset, nbytes) of an attachable object: PoolBuffer,
        PoolView, ObjHandle, an ``(offset, nbytes)`` pair, or anything
        with ``.offset`` and ``.nbytes``/``.size``."""
        from repro_torch.core.pt2pt import PoolBuffer, PoolView  # cycle
        if isinstance(buf, PoolView):
            return buf.buffer.offset + buf.off, buf.nbytes
        if isinstance(buf, PoolBuffer):
            return buf.offset, buf.nbytes
        if isinstance(buf, tuple) and len(buf) == 2:
            return int(buf[0]), int(buf[1])
        off = getattr(buf, "offset", None)
        n = getattr(buf, "nbytes", getattr(buf, "size", None))
        if off is None or n is None:
            raise TypeError(
                f"cannot attach {type(buf).__name__}: need a pool-"
                f"resident object (PoolBuffer/PoolView/ObjHandle) or "
                f"an (offset, nbytes) pair")
        return int(off), int(n)

    def attach(self, buf) -> int:
        """MPI_Win_attach: publish a pool-resident region so every rank
        may target it. Returns the region's absolute pool offset — the
        ``disp`` peers pass to put/get/rput/rget. Zero payload copies;
        reuses tombstoned (detached) entries. Raises ``RuntimeError``
        when the per-rank table (``attach_slots`` entries) is full."""
        off, nbytes = self._resolve_region(buf)
        if nbytes <= 0:
            raise ValueError(f"cannot attach empty region ({nbytes} B)")
        v = self.arena.view
        base = self._row(self.rank)
        for k in range(self._attach_slots):
            if self._mine[k] is None:
                # offset first, len last: the len store PUBLISHES the
                # entry, so a remote scan never sees a torn live row
                v.nt_store_u64(base + 16 * k, off)
                v.nt_store_u64(base + 16 * k + 8, nbytes)
                self._mine[k] = (off, nbytes)
                return off
        raise RuntimeError(
            f"attach table full ({self._attach_slots} regions attached "
            f"by rank {self.rank}); detach one or raise attach_slots")

    def detach(self, addr: int) -> None:
        """MPI_Win_detach: tombstone the entry attached at pool offset
        ``addr`` (one nt-word store — the len word goes to 0). The
        caller is responsible for quiescing peers first, as in MPI:
        a concurrent remote access to a detaching region races."""
        base = self._row(self.rank)
        for k, ent in enumerate(self._mine):
            if ent is not None and ent[0] == addr:
                self.arena.view.nt_store_u64(base + 16 * k + 8, 0)
                self._mine[k] = None
                return
        raise KeyError(f"no region attached at pool offset {addr}")

    def _addr(self, target: int, disp: int, n: int) -> int:
        """Resolve an absolute pool offset against ``target``'s
        PUBLISHED attach row — the dynamic window's bounds check. The
        scan costs ``attach_slots`` nt-loads; serving hot paths should
        cache the returned base and issue rput/rget against it (the
        engine re-validates per chunk, keeping detach visible)."""
        if not 0 <= target < self.n:
            raise IndexError(f"target {target}")
        if n < 0 or disp < 0:
            raise IndexError(f"bad region [{disp}, {disp + n})")
        v = self.arena.view
        base = self._row(target)
        for k in range(self._attach_slots):
            ln = v.nt_load_u64(base + 16 * k + 8)
            if not ln:
                continue
            off = v.nt_load_u64(base + 16 * k)
            if off <= disp and disp + n <= off + ln:
                return disp
        raise IndexError(
            f"[{disp}, {disp + n}) is not inside any region attached "
            f"by rank {target}")
