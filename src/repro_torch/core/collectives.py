"""Collective ALGORITHMS built on cMPI point-to-point (paper §3.6).

The paper leaves collectives as future work but notes they decompose into
pt2pt via standard algorithms (recursive doubling [5], Bruck [20]). Since
the schedule-DAG subsystem (``repro_torch.core.sched`` + ``repro_torch.core.progress``)
landed, the algorithms live in ONE place — the schedule compilers — and
this module is the launch layer: it binds a compiled schedule to a buffer
backend, hands the execution to the communicator's shared progress
engine, and returns a ``CollRequest``. The deprecated free-function
surface (``bcast(comm, arr)``-style) is a set of blocking wrappers over
the same launches with the plain-heap backend; the ``Comm`` method
collectives (core/comm.py) call the identical ``icoll_*`` launchers with
the pool-resident backend when the pool supports it. Backends are
wire-compatible round for round (same tags, sizes, order), so ranks may
disagree on backend choice within one collective and still interoperate.

NOTE (Comm API v2): the free-function surface here is DEPRECATED as a
public API — use the method collectives on ``repro_torch.core.Comm``
(``comm.bcast(arr)``, ``comm.allreduce(...)``, ...) and their
non-blocking forms (``comm.iallreduce(...)`` returning a request).
Importing the free functions via ``repro_torch.core`` emits a
``DeprecationWarning`` while continuing to work.

Tensors in, tensors out: a collective over CUDA tensors returns CUDA
tensors, computed on the card (see ``core/progress``); numpy arrays are
accepted and taken as CPU tensors. Results are exact: every reduce is the
same elementwise op in the same schedule order as in the JAX package.

Algorithms (n = comm size):
  barrier         dissemination (log n rounds of pairwise messages)
  bcast           binomial tree
  reduce          binomial tree (op applied bottom-up)
  allreduce       recursive doubling (pow2) | fused ring RS+AG (any n)
  allgather       Bruck | ring
  reduce_scatter  ring
  alltoall        pairwise exchange
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pool import as_tensor, as_u8, copy_bytes_into, nbytes
from repro_torch.core.progress import (CollRequest, _HeapBufs, _ResidentBufs,
                                 _SchedExec)
from repro_torch.core.pt2pt import Communicator
from repro_torch.core.sched import Schedule, SendOp, compile_schedule
from repro_torch.core.trace import NULL_TRACER

_T = 0x7F000000   # legacy tag space (alltoall pairwise lanes)
_META_BYTES = 192  # fixed-size dtype/shape descriptor for bcast


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def auto_allreduce_algo(n: int, nelem: int) -> str:
    """The ONE rd-vs-ring cutoff, shared by every allreduce surface
    (blocking, nonblocking, persistent, deprecated free function):
    recursive doubling ships the full payload log2(n) times, so it only
    wins for small payloads on power-of-two sizes."""
    return "rd" if (_is_pow2(n) and nelem < 4096) else "ring"


def auto_chunk_bytes(comm, nbytes: int) -> int | None:
    """The ``chunk_bytes="auto"`` policy. Two forces bound the chunk:

    * FLOOR — 8x the probed eager/posted crossover (64 KiB minimum):
      every sub-message must sit well inside one-copy rendezvous
      territory, where the descriptor + matchbox round-trip amortizes
      (measured: 128 KiB chunks at 8 MiB run as slow as unchunked —
      per-message overhead eats the pipeline).
    * DEPTH CAP — nbytes/8: at most ~8 chunks per payload. Pipelining
      saturates at a handful of in-flight chunks; beyond that, extra
      sub-messages only add posting/claim traffic.

    Payloads under two chunks have nothing to pipeline — None keeps
    them message-granular.

    A TUNED comm (``Comm(tuning="auto")`` with a fresh machine profile)
    replaces the fixed nbytes/8 rule with the measured bandwidth knee:
    the chunk is the rank-agreed ``chunk_floor`` — half the largest
    working set that still runs at peak copy bandwidth (two operands
    stream through a reduce round), floored at 8x the measured
    crossover — so every sub-message stays inside the fast cache tier
    regardless of payload size, instead of scaling with it.

    The probe basis must be RANK-AGREED: chunk counts become sub-round
    wire tags, and per-rank probes (``eager_threshold="auto"``) may
    measure different crossovers. ``Comm`` exposes the agreed maximum
    (``_chunk_probe_base``, a one-time collective; tuned comms agree
    once at init); bare communicators fall back to the local value
    (their thresholds are constructor arguments, identical on every
    rank by construction)."""
    if nbytes <= 2 * 64 * 1024:
        # the 64 KiB floor alone forces None here — decide before the
        # (blocking, collective) probe agreement below, which would
        # stall a nonblocking call for a provably-None answer. Exact
        # and rank-uniform: nbytes agrees across ranks by MPI contract.
        return None
    tuned = getattr(comm, "_tuned", None)
    if tuned is not None:
        cb = int(tuned["chunk_floor"])
        if cb <= 0:          # measured sweep: unchunked won everywhere
            return None
        return cb if nbytes > 2 * cb else None
    agree = getattr(comm, "_chunk_probe_base", None)
    if agree is not None:
        base = agree()
    else:
        base = (getattr(comm, "probed_crossover", None)
                or comm.eager_threshold)
    cb = max(64 * 1024, 8 * int(base), nbytes // 8)
    return cb if nbytes > 2 * cb else None


def _resolve_chunk(comm, chunk_bytes, nbytes: int) -> int | None:
    return (auto_chunk_bytes(comm, nbytes) if chunk_bytes == "auto"
            else chunk_bytes)


def bruck_to_rank_order(work: torch.Tensor, rank: int, n: int
                        ) -> torch.Tensor:
    """Bruck allgather accumulates blocks contiguously in BRUCK order
    (own block first, then +k neighbours): rotate ``work`` (n rows, one
    per block) back to rank order. Shared by the one-shot launcher and
    the persistent init — one definition of the block layout."""
    return torch.roll(work, shifts=rank, dims=0).reshape(-1)


def shards_to_chunk_order(flat: torch.Tensor, n: int) -> torch.Tensor:
    """After a ring reduce-scatter + allgather, rank i's reduced shard is
    CHUNK (i+1) % n of the padded payload — reorder the allgathered flat
    vector from rank order into chunk order. (The FUSED ring and fused
    hierarchical allreduce schedules receive chunks in place and never
    need this; it remains a utility for hand-rolled RS+AG
    compositions.)"""
    per = flat.numel() // n
    parts = [flat[i * per:(i + 1) * per] for i in range(n)]
    return torch.cat([parts[(c - 1) % n] for c in range(n)])


def take(view: torch.Tensor, tr=NULL_TRACER) -> torch.Tensor:
    """A private copy of a result view (a slot or a pool window). On the
    card the bytes move through the cellcopy kernel (a ``pool.copy``
    span of ``tr``)."""
    out = torch.empty(view.shape, dtype=view.dtype, device=view.device)
    copy_bytes_into(as_u8(out), as_u8(view), tr)
    return out


# --------------------------------------------------------------------------
# launch layer: bind a compiled schedule to buffers, hand it to the engine
# --------------------------------------------------------------------------

def _make_bufs(comm: Communicator, sched: Schedule, resident: bool,
               device):
    """Pool-resident round buffers (leased from the communicator's round
    pool — ``Comm`` provides ``_lease_round_bufs``) or plain heap slots,
    on the input's device."""
    if resident:
        bufs, release = comm._lease_round_bufs(sched.slot_sizes)
        out = _ResidentBufs(bufs, release, device)
    else:
        out = _HeapBufs(sched.slot_sizes, device)
    out.tr = comm.tracer
    return out


def _launch(comm: Communicator, sched: Schedule, bufs, dtype, op,
            finalize, *, win=None, win_disp: int = 0,
            rma_path: str = "rma_coll") -> CollRequest:
    """Bind a compiled schedule to its buffers and hand it to the shared
    progress engine. ``win`` attaches an RMA window for schedules with
    Put/Get nodes (the one-sided collectives launched from
    ``repro_torch.core.rma``); their payload bytes land in the
    ``rma_path`` ``ProtocolStats`` bucket."""
    ex = _SchedExec(comm, sched, bufs, comm._alloc_coll_tags(),
                    dtype=dtype, op=op, finalize=finalize, win=win,
                    win_disp=win_disp, rma_path=rma_path)
    comm._engine.add_coll(ex)
    return CollRequest(comm, ex)


def immediate(comm: Communicator, result) -> CollRequest:
    """A pre-completed CollRequest (size-1 communicators)."""
    ex = _SchedExec(comm, Schedule("noop", comm.size, comm.rank),
                    _HeapBufs({}), 0, finalize=lambda b: result)
    return CollRequest(comm, ex)


def icoll_allreduce(comm: Communicator, arr, op=torch.add,
                    algo: str = "ring", resident: bool = False,
                    chunk_bytes=None) -> CollRequest:
    arr = as_tensor(arr)
    if comm.size == 1:
        return immediate(comm, arr.clone())
    nb = nbytes(arr)
    cb = _resolve_chunk(comm, chunk_bytes, nb)
    shape, dtype, count = arr.shape, arr.dtype, arr.numel()
    if algo == "rd":
        sched = compile_schedule(comm, "allreduce_rd", nb,
                                 arr.element_size(), chunk_bytes=cb)
        fin = (lambda b: take(b.ndview(sched.result, dtype), b.tr)
               .reshape(shape))
    else:
        sched = compile_schedule(comm, "allreduce_ring", nb,
                                 arr.element_size(), chunk_bytes=cb)
        # fused RS+AG: slot 0 finishes in CHUNK order — truncate the
        # zero padding and reshape, no reorder pass
        fin = (lambda b: take(b.ndview(sched.result, dtype)[:count], b.tr)
               .reshape(shape))
    bufs = _make_bufs(comm, sched, resident, arr.device)
    bufs.fill(0, arr, pad_to=sched.slot_sizes[0])
    return _launch(comm, sched, bufs, dtype, op, fin)


def icoll_allreduce_hier(comm: Communicator, arr, op=torch.add,
                         group: int = 2, resident: bool = False,
                         chunk_bytes=None) -> CollRequest:
    """Nonblocking hierarchical allreduce: ONE fused schedule (intra
    ring RS -> inter recursive doubling -> intra ring AG) over the
    parent communicator — no sub-communicators, no phase barriers."""
    arr = as_tensor(arr)
    if comm.size == 1:
        return immediate(comm, arr.clone())
    nb = nbytes(arr)
    cb = _resolve_chunk(comm, chunk_bytes, nb)
    shape, dtype, count = arr.shape, arr.dtype, arr.numel()
    sched = compile_schedule(comm, "allreduce_hier", nb,
                             arr.element_size(), group=group,
                             chunk_bytes=cb)
    fin = (lambda b: take(b.ndview(sched.result, dtype)[:count], b.tr)
           .reshape(shape))
    bufs = _make_bufs(comm, sched, resident, arr.device)
    bufs.fill(0, arr, pad_to=sched.slot_sizes[0])
    return _launch(comm, sched, bufs, dtype, op, fin)


def icoll_reduce_scatter(comm: Communicator, arr, op=torch.add,
                         resident: bool = False,
                         chunk_bytes=None) -> CollRequest:
    arr = as_tensor(arr)
    if comm.size == 1:
        return immediate(comm, arr.reshape(-1).clone())
    dtype, nb = arr.dtype, nbytes(arr)
    sched = compile_schedule(comm, "reduce_scatter_ring", nb,
                             arr.element_size(),
                             chunk_bytes=_resolve_chunk(
                                 comm, chunk_bytes, nb))
    bufs = _make_bufs(comm, sched, resident, arr.device)
    bufs.fill(0, arr, pad_to=sched.slot_sizes[0])
    fin = lambda b: take(b.ndview(sched.result, dtype), b.tr)  # noqa: E731
    return _launch(comm, sched, bufs, dtype, op, fin)


def icoll_allgather(comm: Communicator, shard,
                    algo: str = "ring", resident: bool = False,
                    chunk_bytes=None) -> CollRequest:
    shard = as_tensor(shard)
    n, rank = comm.size, comm.rank
    if n == 1:
        return immediate(comm, shard.reshape(-1).clone())
    dtype, per_b = shard.dtype, nbytes(shard)
    kind = "allgather_bruck" if algo == "bruck" else "allgather_ring"
    sched = compile_schedule(comm, kind, per_b, shard.element_size(),
                             chunk_bytes=_resolve_chunk(
                                 comm, chunk_bytes, per_b))
    bufs = _make_bufs(comm, sched, resident, shard.device)
    # own shard: bruck block 0, ring chunk `rank`
    bufs.fill_at(0, 0 if algo == "bruck" else rank * per_b, shard)
    if algo == "bruck":
        per = shard.numel()

        def fin(b):
            work = take(b.ndview(sched.result, dtype), b.tr).reshape(n, per)
            return bruck_to_rank_order(work, rank, n)
    else:
        fin = lambda b: take(b.ndview(sched.result, dtype), b.tr)  # noqa: E731
    return _launch(comm, sched, bufs, dtype, None, fin)


def icoll_bcast_known(comm: Communicator, arr: torch.Tensor,
                      root: int = 0, resident: bool = False,
                      chunk_bytes=None) -> CollRequest:
    """ibcast with the payload buffer KNOWN on every rank (MPI
    semantics: same shape/dtype everywhere; non-root buffers are
    overwritten in place). The heap backend aliases slot 0 to the user
    tensor — leaves receive straight into it with no round-buffer
    detour; the resident backend lands the payload once in a round
    buffer and forwards zero-copy PoolViews."""
    if not (isinstance(arr, torch.Tensor) and arr.is_contiguous()):
        # a contiguous copy would silently detach from the caller's
        # buffer — it would never see the broadcast, violating the
        # in-place contract
        raise ValueError("ibcast needs a contiguous tensor "
                         "(the payload is delivered in place)")
    if comm.size == 1:
        return immediate(comm, arr)
    nb = nbytes(arr)
    # a chunked bcast PIPELINES the binomial tree: an interior rank
    # forwards chunk c to its children the moment chunk c lands
    sched = compile_schedule(comm, "bcast", nb,
                             arr.element_size(), root=root,
                             chunk_bytes=_resolve_chunk(
                                 comm, chunk_bytes, nb))
    # a leaf (no forwarding sends) gains nothing from a round buffer —
    # it would just pay an extra pool -> user drain
    resident = resident and any(isinstance(nd, SendOp)
                                for nd in sched.nodes)
    is_root = comm.rank == root
    if resident:
        bufs = _make_bufs(comm, sched, True, arr.device)
        if is_root:
            bufs.fill(0, arr)
        u8 = arr.reshape(-1).view(torch.uint8)

        def fin(b):
            if not is_root:
                copy_bytes_into(as_u8(u8),
                                as_u8(b.ndview(sched.result, torch.uint8)),
                                b.tr)
            return arr
    else:
        bufs = _HeapBufs({})             # slot 0 IS the user tensor
        bufs.alias(0, arr)
        fin = lambda b: arr              # noqa: E731
    return _launch(comm, sched, bufs, arr.dtype, None, fin)


def icoll_reduce(comm: Communicator, arr, op=torch.add,
                 root: int = 0, resident: bool = False) -> CollRequest:
    arr = as_tensor(arr)
    if comm.size == 1:
        return immediate(comm, arr.clone())
    shape, dtype = arr.shape, arr.dtype
    sched = compile_schedule(comm, "reduce", nbytes(arr),
                             arr.element_size(), root=root)
    bufs = _make_bufs(comm, sched, resident, arr.device)
    bufs.fill(0, arr)
    if comm.rank == root:
        fin = (lambda b: take(b.ndview(sched.result, dtype), b.tr)
               .reshape(shape))
    else:
        fin = lambda b: None             # noqa: E731
    return _launch(comm, sched, bufs, dtype, op, fin)


def icoll_barrier(comm: Communicator) -> CollRequest:
    if comm.size == 1:
        return immediate(comm, None)
    sched = compile_schedule(comm, "barrier")
    return _launch(comm, sched, _HeapBufs(sched.slot_sizes), None, None,
                   lambda b: None)


# --------------------------------------------------------------------------
# bcast metadata phase (dtype/shape travel ahead of the payload)
# --------------------------------------------------------------------------

def _dtype_str(dtype: torch.dtype) -> str:
    """numpy's dtype string where numpy has the type (the JAX package's
    metadata format, so both packages read each other's bcasts), else
    torch's name (bfloat16)."""
    try:
        return torch.empty(0, dtype=dtype).numpy().dtype.str
    except TypeError:
        return str(dtype)


def _dtype_of(s: str) -> torch.dtype:
    if s.startswith("torch."):
        return getattr(torch, s[len("torch."):])
    return torch.from_numpy(np.empty(0, np.dtype(s))).dtype


def _bcast_impl(comm: Communicator, arr, root: int,
                use_resident=None) -> torch.Tensor:
    """Blocking bcast where only the root knows shape/dtype: a
    fixed-size metadata bcast (eager, one cell) announces them, then the
    payload rides ``icoll_bcast_known``. ``use_resident``: optional
    ``nbytes -> bool`` predicate evaluated per rank once the payload
    size is known (each rank picks its own path — the wire protocol is
    self-describing per message). Non-roots allocate the result on the
    communicator's device."""
    if comm.size == 1:
        return as_tensor(arr).clone()
    meta = torch.zeros(_META_BYTES, dtype=torch.uint8)
    if comm.rank == root:
        a = as_tensor(arr)
        # ';' separator: numpy's dtype string may contain '|' ("|u1")
        desc = (f"{_dtype_str(a.dtype)};"
                f"{','.join(map(str, a.shape))}").encode()
        if len(desc) > _META_BYTES:
            raise ValueError(f"bcast metadata over {_META_BYTES}B "
                             f"(shape rank too large)")
        meta[:len(desc)] = torch.frombuffer(bytearray(desc),
                                            dtype=torch.uint8)
    icoll_bcast_known(comm, meta, root).wait()
    if comm.rank == root:
        out = a
    else:
        dts, shs = bytes(meta.numpy()).rstrip(b"\0").decode().split(";")
        shape = tuple(int(x) for x in shs.split(",") if x)
        out = torch.empty(shape, dtype=_dtype_of(dts), device=comm.device)
    resident = bool(use_resident(nbytes(out))) if use_resident else False
    icoll_bcast_known(comm, out, root, resident=resident).wait()
    return out.clone() if comm.rank == root else out


# --------------------------------------------------------------------------
# blocking wrappers over the launchers (plain-heap backend)
# --------------------------------------------------------------------------

def barrier_dissemination(comm: Communicator) -> None:
    icoll_barrier(comm).wait()


def bcast(comm: Communicator, arr, root: int = 0) -> torch.Tensor:
    """Binomial tree broadcast. Non-root ranks pass arr=None; shape/dtype
    metadata travels with the data."""
    return _bcast_impl(comm, arr, root)


def reduce(comm: Communicator, arr, op=torch.add, root: int = 0):
    return icoll_reduce(comm, arr, op, root).wait()


def allreduce_rd(comm: Communicator, arr, op=torch.add) -> torch.Tensor:
    """Recursive doubling (pow2 sizes) — paper's cited algorithm [5]."""
    if not _is_pow2(comm.size):
        raise ValueError("recursive doubling needs power-of-two size")
    return icoll_allreduce(comm, arr, op, algo="rd").wait()


def reduce_scatter_ring(comm: Communicator, arr, op=torch.add
                        ) -> torch.Tensor:
    """Ring reduce-scatter; returns this rank's reduced shard (flat)."""
    return icoll_reduce_scatter(comm, arr, op).wait()


def allgather_ring(comm: Communicator, shard) -> torch.Tensor:
    return icoll_allgather(comm, shard, algo="ring").wait()


def allgather_bruck(comm: Communicator, shard) -> torch.Tensor:
    """Bruck all-gather — paper's cited algorithm [20]; ceil(log2 n)
    rounds."""
    return icoll_allgather(comm, shard, algo="bruck").wait()


def allreduce(comm: Communicator, arr, op=torch.add,
              algo: str = "auto") -> torch.Tensor:
    arr = as_tensor(arr)
    n = comm.size
    if n == 1:
        return arr.clone()
    if algo == "auto":
        algo = auto_allreduce_algo(n, arr.numel())
    return icoll_allreduce(comm, arr, op, algo=algo).wait()


def alltoall(comm: Communicator, blocks: list) -> list[torch.Tensor]:
    """blocks[i] goes to rank i; returns what each rank sent to us."""
    n, r = comm.size, comm.rank
    if len(blocks) != n:
        raise ValueError(f"alltoall needs {n} blocks, got {len(blocks)}")
    blocks = [as_tensor(b) for b in blocks]
    out: list = [None] * n
    out[r] = take(blocks[r], comm.tracer)
    reqs = []
    for off in range(1, n):
        dst = (r + off) % n
        reqs.append(comm.isend(dst, blocks[dst],
                               tag=_T + 1024 + off, _internal=True))
    for off in range(1, n):
        src = (r - off) % n
        out[src] = torch.empty_like(blocks[src])
        comm.recv_into(src, out[src], tag=_T + 1024 + off,
                       _internal=True)
    comm.waitall(reqs)
    return out
