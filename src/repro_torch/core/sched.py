"""Collective schedules: a DAG IR compiled once per (op, size, topology).

Hand-rolled blocking round loops — ``irecv_into; isend; wait; wait;
reduce`` per round — leave the CPU idle at every ``wait``. This module
factors the ALGORITHM out of the execution:
a collective is compiled into a small dependency DAG of four node kinds

  SendOp    ship a buffer region to a peer (one message, one round tag)
  RecvOp    receive a peer's message into a buffer region
  ReduceOp  dst[...] = op(dst, src) over two regions (local compute)
  CopyOp    dst[...] = src (local data movement)

plus two ONE-SIDED node kinds for schedules bound to an RMA window
(``repro_torch.core.rma.Window``):

  PutOp     store a local buffer region into rank ``target``'s window
            segment at byte displacement ``disp`` (write_release — no
            target-side involvement, no wire message, no tag)
  GetOp     load rank ``target``'s window segment at ``disp`` into a
            local buffer region (read_acquire)

Put/Get are LOCAL nodes to the progress engine (the window is shared
memory — the store IS the transfer); cross-rank ordering in RMA-based
collectives comes from zero-byte Send/Recv token pairs, which keeps the
one-sided schedules inside the same verified matching/deadlock/hazard
discipline as the two-sided ones.

over SYMBOLIC buffer slots (``BufRef``): the IR names `(slot, offset,
nbytes)` regions, never concrete memory, so one compiled schedule serves
the pool-resident backend (PoolBuffer round buffers, posted-rendezvous
receives), the plain-heap backend (numpy scratch, eager/staged wire) and
the persistent double-buffered backend alike. Compilation is pure —
``compile_schedule`` depends only on (kind, algo, n, rank, nbytes,
itemsize, root) — and cached per communicator, so iterative workloads
pay the DAG construction once.

Execution lives in ``repro_torch.core.progress``: the shared progress engine
issues every node whose dependencies have completed, which is what turns
``comm.iallreduce(x)`` + user compute + ``wait()`` into actual
communication/computation overlap, and what lets MPI-4 persistent
collectives pre-post every round's matchbox entry before any sender
needs it (the round-synchronized pre-post handshake).

Dependency discipline (why each edge exists):

* a SendOp sourcing region R depends on the node that produced R's
  final-for-this-send value (a ReduceOp, RecvOp or the initial fill);
* consecutive SendOps from the same slot are chained — a ``PoolBuffer``
  has ONE drain-ack word, so at most one send per underlying buffer may
  be in flight (the heap backend keeps the same order for wire parity);
* a ReduceOp that writes the accumulator depends on the SendOp that
  last sourced it (a staged-rendezvous peer reads our memory until it
  acks — mutating the region earlier would corrupt the wire);
* RecvOps into private regions carry NO deps: the engine pre-posts them
  all at start, which is what primes the matchbox.

Tags: every node carries a ROUND index; the executor adds a per-launch
``tag_base`` from the communicator's collective sequence number, so
concurrent collectives (an ``iallreduce`` overlapping an ``ibarrier``)
never cross-match. Ranks must issue collectives in the same order —
the MPI calling convention — for the sequence numbers to agree.

Chunking (``compile_schedule(..., chunk_bytes=...)``): a compiled
schedule can be re-cut at CHUNK granularity — every Send/Recv/Reduce/
Copy node whose payload exceeds ``chunk_bytes`` is split into a chain
of per-chunk sub-nodes, and dependencies are mapped CHUNK-WISE wherever
the dependency is about the same buffer region (a send of chunk c waits
only for the reduce that produced chunk c, a pipelined bcast forwards
chunk c the moment it arrived). That converts the engine from
message-granular to chunk-granular progress: round k+1's receive for
chunk c is in flight while round k is still reducing chunk c+1 — the
intra-round overlap that takes large-payload collectives to peak
shared-pool bandwidth (CXL-CCL's pipelining lesson). Each sub-message
gets its own sub-round (hence its own wire tag), so ``Schedule.rounds``
counts SUB-rounds after chunking — timeout scaling and tag windows stay
correct automatically. ``chunk_bytes`` is widened as needed so the
sub-round count never exceeds ``MAX_ROUNDS``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["BufRef", "SendOp", "RecvOp", "ReduceOp", "CopyOp",
           "PutOp", "GetOp", "Schedule", "ScheduleInvariantError",
           "compile_schedule", "chunk_schedule", "MAX_ROUNDS"]

# rounds per schedule are capped so per-launch tag windows stay disjoint
MAX_ROUNDS = 256


class ScheduleInvariantError(ValueError):
    """A compiled schedule violates a structural invariant.

    Raised by ``Schedule.validate()`` (and reused by the cross-rank
    verifier in ``repro.analysis.verify``) instead of ``assert`` so the
    checks survive ``python -O``. Carries enough context — kind, rank,
    offending node index and its deps — to locate the bad node without
    a debugger."""

    def __init__(self, message: str, *, kind: str | None = None,
                 rank: int | None = None, node: int | None = None,
                 deps: tuple[int, ...] | None = None):
        where = []
        if kind is not None:
            where.append(f"kind={kind}")
        if rank is not None:
            where.append(f"rank={rank}")
        if node is not None:
            where.append(f"node={node}")
        if deps is not None:
            where.append(f"deps={deps}")
        if where:
            message = f"{message} [{', '.join(where)}]"
        super().__init__(message)
        self.kind = kind
        self.rank = rank
        self.node = node
        self.deps = deps


@dataclass(frozen=True)
class BufRef:
    """A symbolic buffer region: ``nbytes`` at ``off`` inside slot
    ``slot``. Slot 0 is the working/accumulator buffer by convention;
    higher slots hold per-round incoming blocks."""
    slot: int
    off: int
    nbytes: int


@dataclass
class _Node:
    idx: int = field(init=False, default=-1)
    deps: tuple[int, ...] = ()


@dataclass
class SendOp(_Node):
    peer: int = -1
    buf: BufRef = None
    round: int = 0


@dataclass
class RecvOp(_Node):
    peer: int = -1
    buf: BufRef = None
    round: int = 0


@dataclass
class ReduceOp(_Node):
    dst: BufRef = None
    src: BufRef = None


@dataclass
class CopyOp(_Node):
    dst: BufRef = None
    src: BufRef = None


@dataclass
class PutOp(_Node):
    """One-sided store: local region ``buf`` -> rank ``target``'s window
    segment at byte displacement ``disp`` (plus the execution's
    ``win_disp`` base). Local to the engine — no wire message, no tag;
    ``round`` is informational only."""
    target: int = -1
    buf: BufRef = None
    disp: int = 0
    round: int = 0


@dataclass
class GetOp(_Node):
    """One-sided load: rank ``target``'s window segment at ``disp`` ->
    local region ``buf``. Local to the engine, like PutOp."""
    target: int = -1
    buf: BufRef = None
    disp: int = 0
    round: int = 0


@dataclass
class Schedule:
    """A compiled collective for ONE rank of an n-rank communicator."""
    kind: str
    n: int
    rank: int
    nodes: list = field(default_factory=list)
    slot_sizes: dict = field(default_factory=dict)   # slot -> bytes
    rounds: int = 0                                  # tag span (SUB-rounds
    #                                                  once chunked)
    result: BufRef | None = None
    chunk_bytes: int | None = None     # None = message-granular

    def _add(self, node) -> int:
        node.idx = len(self.nodes)
        self.nodes.append(node)
        for s in self._refs(node):
            need = s.off + s.nbytes
            if need > self.slot_sizes.setdefault(s.slot, 0):
                self.slot_sizes[s.slot] = need
        return node.idx

    @staticmethod
    def _refs(node):
        if isinstance(node, (SendOp, RecvOp, PutOp, GetOp)):
            return (node.buf,)
        return (node.dst, node.src)

    # ------------------------------------------------------------------
    # derived metadata
    # ------------------------------------------------------------------
    def recv_nodes(self) -> list[RecvOp]:
        return [nd for nd in self.nodes if isinstance(nd, RecvOp)]

    def required_matchbox_depth(self, peer: int | None = None) -> int:
        """Matchbox depth a FULLY pre-posted execution of this schedule
        needs toward ``peer``: the number of RecvOps whose postings can
        coexist (the engine pre-posts every receive at start, so that is
        simply the per-peer receive count). ``peer=None`` returns the
        max over all peers. This is the single source of truth for the
        matchbox-demand derivation in ``comm.py`` and for the resource-
        bound check in ``repro.analysis.verify``."""
        per: dict[int, int] = {}
        for nd in self.recv_nodes():
            per[nd.peer] = per.get(nd.peer, 0) + 1
        if peer is not None:
            return per.get(peer, 0)
        return max(per.values(), default=0)

    def max_recvs_per_peer(self) -> int:
        """Largest number of receives this schedule posts toward one
        peer (persistent mode needs twice this: two iterations' entries
        coexist). Alias of ``required_matchbox_depth()``."""
        return self.required_matchbox_depth()

    def validate(self) -> None:
        """Compile-time sanity: deps in range and strictly backward
        (construction order is a topological order), rounds in span.

        Raises ``ScheduleInvariantError`` — not ``assert`` — so the
        checks hold under ``python -O`` too."""
        for nd in self.nodes:
            if not all(0 <= d < nd.idx for d in nd.deps):
                raise ScheduleInvariantError(
                    "forward/self/negative dep", kind=self.kind,
                    rank=self.rank, node=nd.idx, deps=nd.deps)
            if isinstance(nd, (SendOp, RecvOp)):
                if not 0 <= nd.round < self.rounds:
                    raise ScheduleInvariantError(
                        f"round {nd.round} outside span {self.rounds}",
                        kind=self.kind, rank=self.rank, node=nd.idx)


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


# --------------------------------------------------------------------------
# schedule-level chunking (post-pass over any compiled schedule)
# --------------------------------------------------------------------------

def _n_chunks(nbytes: int, chunk_bytes: int) -> int:
    return max(1, -(-nbytes // chunk_bytes))


def _sub_region(ref: BufRef, c: int, chunk_bytes: int) -> BufRef:
    off = c * chunk_bytes
    return BufRef(ref.slot, ref.off + off, min(chunk_bytes,
                                               ref.nbytes - off))


def chunk_schedule(base: Schedule, chunk_bytes: int) -> Schedule:
    """Re-cut ``base`` at chunk granularity: every node whose payload
    exceeds ``chunk_bytes`` becomes a chain of per-chunk sub-nodes.

    Dependency mapping:

    * CHUNK-WISE when the dep shares a buffer region with the node and
      splits into the same number of pieces — sub-node c depends only on
      the dep's sub-node c. This is what pipelines: the producer/anti-
      hazard edges of the compilers above are all about one region, so
      chunk c of a round is independent of chunk c+1 (a ring send of
      chunk c starts while chunk c+1 is still being reduced; a binomial
      bcast forwards chunk c the moment it landed).
    * CONSERVATIVE otherwise (disjoint regions or different piece
      counts, e.g. Bruck's growing blocks): every sub-node depends on
      every piece of the dep — exactly the base schedule's semantics.
    * SendOps sourcing the same slot are additionally chained globally
      (one drain-ack word per underlying PoolBuffer: at most one send
      per slot in flight), which also serializes a node's own sub-sends.

    Each sub-message takes its own SUB-round — its own wire tag — so
    per-pair matching never depends on claim-order luck and
    ``Schedule.rounds`` (tag span, timeout scaling) counts the real
    message count. Sub-round numbering must agree ACROSS ranks (a
    sender's sub-round is the receiver's), but a rank only sees its own
    nodes — and e.g. a binomial-tree leaf participates in a strict
    subset of the rounds. So every base round gets one UNIFORM window
    of ``ceil(max message size / chunk_bytes)`` sub-rounds: the largest
    message size is a pure function of (kind, n, nbytes) — identical on
    every rank for every compiler above — which makes the numbering
    rank-independent by construction. Dependency-free receives stay
    dependency-free per chunk: a chunked execution PRE-POSTS every
    sub-receive (the matchbox overflow spill keeps postings FIFO
    beyond strip capacity)."""
    s = Schedule(base.kind, base.n, base.rank, chunk_bytes=chunk_bytes)
    span = max((_n_chunks(nd.buf.nbytes, chunk_bytes)
                for nd in base.nodes if isinstance(nd, (SendOp, RecvOp))),
               default=1)
    round_off = {r: r * span for r in range(base.rounds)}
    acc = base.rounds * span
    pieces: dict[int, list[int]] = {}       # base idx -> sub-node idxs
    last_send_in_slot: dict[int, int] = {}  # slot -> last sub-SendOp idx

    def refs(nd):
        return [b for b in Schedule._refs(nd) if b is not None]

    def map_deps(nd, m: int, c: int) -> tuple[int, ...]:
        out = []
        mine = set(refs(nd))
        for d in nd.deps:
            dep = base.nodes[d]
            if len(pieces[d]) == m and mine & set(refs(dep)):
                out.append(pieces[d][c])
            else:
                out.extend(pieces[d])
        return tuple(out)

    for nd in base.nodes:
        if isinstance(nd, (SendOp, RecvOp)):
            m = _n_chunks(nd.buf.nbytes, chunk_bytes)
            subs = []
            for c in range(m):
                buf = _sub_region(nd.buf, c, chunk_bytes)
                rnd = round_off[nd.round] + c
                deps = map_deps(nd, m, c)
                if isinstance(nd, SendOp):
                    prev = last_send_in_slot.get(buf.slot)
                    if prev is not None and prev not in deps:
                        deps = deps + (prev,)
                    idx = s._add(SendOp(deps=deps, peer=nd.peer,
                                        buf=buf, round=rnd))
                    last_send_in_slot[buf.slot] = idx
                else:
                    idx = s._add(RecvOp(deps=deps, peer=nd.peer,
                                        buf=buf, round=rnd))
                subs.append(idx)
            pieces[nd.idx] = subs
        elif isinstance(nd, (PutOp, GetOp)):
            # one-sided: no wire tag, so no sub-round — the local buf
            # region AND the window displacement split in lockstep
            m = _n_chunks(nd.buf.nbytes, chunk_bytes)
            subs = []
            cls = PutOp if isinstance(nd, PutOp) else GetOp
            for c in range(m):
                buf = _sub_region(nd.buf, c, chunk_bytes)
                deps = map_deps(nd, m, c)
                subs.append(s._add(cls(deps=deps, target=nd.target,
                                       buf=buf,
                                       disp=nd.disp + c * chunk_bytes,
                                       round=nd.round)))
            pieces[nd.idx] = subs
        else:                                # ReduceOp / CopyOp
            m = _n_chunks(nd.dst.nbytes, chunk_bytes)
            subs = []
            for c in range(m):
                dst = _sub_region(nd.dst, c, chunk_bytes)
                src = _sub_region(nd.src, c, chunk_bytes)
                deps = map_deps(nd, m, c)
                cls = ReduceOp if isinstance(nd, ReduceOp) else CopyOp
                subs.append(s._add(cls(deps=deps, dst=dst, src=src)))
            pieces[nd.idx] = subs
    s.slot_sizes = dict(base.slot_sizes)
    s.rounds = max(acc, 1)
    s.result = base.result
    s.validate()
    return s


# --------------------------------------------------------------------------
# compilers (one per collective kind; pure functions of the key)
# --------------------------------------------------------------------------

def _compile_allreduce_rd(n: int, rank: int, nbytes: int) -> Schedule:
    """Recursive doubling: log2(n) rounds, whole-payload exchanges.
    Round r peers with rank^2^r; each round's incoming block lands in
    its OWN slot so every receive pre-posts at start."""
    if not _is_pow2(n):
        raise ValueError("recursive doubling needs power-of-two size, "
                         f"got {n}")
    s = Schedule("allreduce_rd", n, rank)
    acc = BufRef(0, 0, nbytes)
    prev_send = prev_red = None
    r = 0
    k = 1
    while k < n:
        peer = rank ^ k
        inc = BufRef(1 + r, 0, nbytes)
        recv = s._add(RecvOp(deps=(), peer=peer, buf=inc, round=r))
        sdeps = tuple(d for d in (prev_red, prev_send) if d is not None)
        send = s._add(SendOp(deps=sdeps, peer=peer, buf=acc, round=r))
        rdeps = (recv, send) + ((prev_red,) if prev_red is not None
                                else ())
        prev_red = s._add(ReduceOp(deps=rdeps, dst=acc, src=inc))
        prev_send = send
        k <<= 1
        r += 1
    s.rounds = r
    s.result = acc
    s.validate()
    return s


def _compile_allreduce_ring(n: int, rank: int, nbytes: int,
                            itemsize: int) -> Schedule:
    """Fused ring reduce-scatter + allgather in ONE working buffer of n
    chunks: RS rounds reduce incoming blocks into their chunks, AG
    rounds receive final chunks IN PLACE (no re-pack, no reorder pass —
    at completion slot 0 holds the reduced payload in chunk order)."""
    count = nbytes // itemsize
    per = -(-count // n)
    per_b = per * itemsize
    s = Schedule("allreduce_ring", n, rank)
    right, left = (rank + 1) % n, (rank - 1) % n
    chunk = lambda c: BufRef(0, (c % n) * per_b, per_b)   # noqa: E731
    rs_send: list[int] = []
    rs_red: list[int] = []
    prev_send = None
    for st in range(n - 1):
        inc = BufRef(1 + st, 0, per_b)
        recv = s._add(RecvOp(deps=(), peer=left, buf=inc, round=st))
        sdeps = tuple(d for d in ((rs_red[-1] if st else None),
                                  prev_send) if d is not None)
        send = s._add(SendOp(deps=sdeps, peer=right,
                             buf=chunk(rank - st), round=st))
        red = s._add(ReduceOp(deps=(recv,), dst=chunk(rank - st - 1),
                              src=inc))
        rs_send.append(send)
        rs_red.append(red)
        prev_send = send
    prev_recv = None
    for st in range(n - 1):
        rnd = (n - 1) + st
        # the chunk being received was last SOURCED by RS send `st`
        recv = s._add(RecvOp(deps=(rs_send[st],), peer=left,
                             buf=chunk(rank - st), round=rnd))
        sdeps = ((rs_red[-1], prev_send) if st == 0
                 else (prev_recv, prev_send))
        send = s._add(SendOp(deps=tuple(sdeps), peer=right,
                             buf=chunk(rank + 1 - st), round=rnd))
        prev_recv, prev_send = recv, send
    s.rounds = 2 * (n - 1)
    s.result = BufRef(0, 0, n * per_b)
    s.validate()
    return s


def _compile_allreduce_hier(n: int, rank: int, nbytes: int,
                            itemsize: int, group: int) -> Schedule:
    """Hierarchical allreduce as ONE fused schedule (no sub-comm phase
    composition): contiguous groups of ``group`` ranks run an intra-group
    ring reduce-scatter over ``group`` chunks, ranks holding the same
    chunk across groups run an inter-group recursive doubling on their
    shard, and the intra-group ring allgather lands the final chunks in
    place. Because the three phases share one DAG, a rank's allgather
    traffic overlaps its neighbours' inter-group rounds — the blocking
    sub-comm version serialized the phases at every rank.

    Needs ``n % group == 0`` and a power-of-two group COUNT (the
    recursive-doubling requirement). Result: slot 0 in chunk order,
    like the fused ring."""
    g = group
    if g < 1 or n % g:
        raise ValueError(f"group size {g} must divide comm size {n}")
    m = n // g
    if not _is_pow2(m):
        raise ValueError(f"hier needs a power-of-two group count, "
                         f"got {m} groups")
    count = nbytes // itemsize
    per = -(-count // g)
    per_b = per * itemsize
    s = Schedule("allreduce_hier", n, rank)
    grp, l = divmod(rank, g)
    right = grp * g + (l + 1) % g
    left = grp * g + (l - 1) % g
    chunk = lambda c: BufRef(0, (c % g) * per_b, per_b)   # noqa: E731
    rs_send: list[int] = []
    rs_red: list[int] = []
    prev_send = None
    rnd = 0
    for st in range(g - 1):                  # intra ring reduce-scatter
        inc = BufRef(1 + st, 0, per_b)
        recv = s._add(RecvOp(deps=(), peer=left, buf=inc, round=rnd))
        sdeps = tuple(d for d in ((rs_red[-1] if st else None),
                                  prev_send) if d is not None)
        send = s._add(SendOp(deps=sdeps, peer=right,
                             buf=chunk(l - st), round=rnd))
        rs_red.append(s._add(ReduceOp(deps=(recv,),
                                      dst=chunk(l - st - 1), src=inc)))
        rs_send.append(send)
        prev_send = send
        rnd += 1
    shard = chunk(l + 1)                     # this rank's reduced shard
    last_red = rs_red[-1] if rs_red else None
    slot = g                                 # RS used slots 1..g-1
    k = 1
    while k < m:                             # inter recursive doubling
        peer = (grp ^ k) * g + l
        inc = BufRef(slot, 0, per_b)
        slot += 1
        recv = s._add(RecvOp(deps=(), peer=peer, buf=inc, round=rnd))
        sdeps = tuple(d for d in (last_red, prev_send) if d is not None)
        send = s._add(SendOp(deps=sdeps, peer=peer, buf=shard,
                             round=rnd))
        rdeps = (recv, send) + ((last_red,) if last_red is not None
                                else ())
        last_red = s._add(ReduceOp(deps=rdeps, dst=shard, src=inc))
        prev_send = send
        k <<= 1
        rnd += 1
    prev_recv = None
    for st in range(g - 1):                  # intra ring allgather
        # the chunk being received was last SOURCED by RS send `st`
        # (the inter phase only touches this rank's own shard)
        recv = s._add(RecvOp(deps=(rs_send[st],), peer=left,
                             buf=chunk(l - st), round=rnd))
        sdeps = ((last_red, prev_send) if st == 0
                 else (prev_recv, prev_send))
        send = s._add(SendOp(deps=tuple(d for d in sdeps
                                        if d is not None),
                             peer=right, buf=chunk(l + 1 - st),
                             round=rnd))
        prev_recv, prev_send = recv, send
        rnd += 1
    s.slot_sizes[0] = max(s.slot_sizes.get(0, 0), g * per_b)
    s.rounds = max(rnd, 1)
    s.result = BufRef(0, 0, g * per_b)
    s.validate()
    return s


def _compile_reduce_scatter_ring(n: int, rank: int, nbytes: int,
                                 itemsize: int) -> Schedule:
    """The RS phase alone; the result is this rank's reduced shard,
    chunk ``(rank+1) % n`` of the zero-padded payload."""
    count = nbytes // itemsize
    per = -(-count // n)
    per_b = per * itemsize
    s = Schedule("reduce_scatter_ring", n, rank)
    right, left = (rank + 1) % n, (rank - 1) % n
    chunk = lambda c: BufRef(0, (c % n) * per_b, per_b)   # noqa: E731
    prev_send = prev_red = None
    for st in range(n - 1):
        inc = BufRef(1 + st, 0, per_b)
        recv = s._add(RecvOp(deps=(), peer=left, buf=inc, round=st))
        sdeps = tuple(d for d in (prev_red, prev_send) if d is not None)
        send = s._add(SendOp(deps=sdeps, peer=right,
                             buf=chunk(rank - st), round=st))
        prev_red = s._add(ReduceOp(deps=(recv,),
                                   dst=chunk(rank - st - 1), src=inc))
        prev_send = send
    s.rounds = max(n - 1, 1)
    s.result = chunk(rank + 1)
    s.validate()
    return s


def _compile_allgather_ring(n: int, rank: int, per_b: int) -> Schedule:
    """Ring allgather straight into the rank-ordered output buffer;
    every receive targets a private chunk, so ALL of them pre-post."""
    s = Schedule("allgather_ring", n, rank)
    right, left = (rank + 1) % n, (rank - 1) % n
    chunk = lambda c: BufRef(0, (c % n) * per_b, per_b)   # noqa: E731
    prev_send = prev_recv = None
    for st in range(n - 1):
        recv = s._add(RecvOp(deps=(), peer=left,
                             buf=chunk(rank - st - 1), round=st))
        sdeps = tuple(d for d in (prev_recv, prev_send) if d is not None)
        s._add(SendOp(deps=sdeps, peer=right, buf=chunk(rank - st),
                      round=st))
        prev_send = s.nodes[-1].idx
        prev_recv = recv
    s.rounds = max(n - 1, 1)
    s.result = BufRef(0, 0, n * per_b)
    s.validate()
    return s


def _compile_allgather_bruck(n: int, rank: int, per_b: int) -> Schedule:
    """Bruck allgather: ceil(log2 n) rounds, blocks accumulate
    contiguously in bruck order (the executor's finalizer rotates to
    rank order). Receives land in fresh regions — all pre-postable."""
    s = Schedule("allgather_bruck", n, rank)
    prev_send = prev_recv = None
    k = 1
    have = 1
    rnd = 0
    while k < n:
        count = min(k, n - k)
        recv = s._add(RecvOp(deps=(), peer=(rank + k) % n,
                             buf=BufRef(0, have * per_b, count * per_b),
                             round=rnd))
        sdeps = tuple(d for d in (prev_recv, prev_send) if d is not None)
        s._add(SendOp(deps=sdeps, peer=(rank - k) % n,
                      buf=BufRef(0, 0, count * per_b), round=rnd))
        prev_send = s.nodes[-1].idx
        prev_recv = recv
        have += count
        k <<= 1
        rnd += 1
    s.slot_sizes[0] = max(s.slot_sizes.get(0, 0), n * per_b)
    s.rounds = max(rnd, 1)
    s.result = BufRef(0, 0, n * per_b)
    s.validate()
    return s


def _compile_bcast(n: int, rank: int, root: int, nbytes: int) -> Schedule:
    """Binomial tree: one receive from the parent, then forwards to
    every child (chained — one ack slot per buffer)."""
    s = Schedule("bcast", n, rank)
    buf = BufRef(0, 0, nbytes)
    vr = (rank - root) % n
    recv = None
    if vr:
        k = 1
        while k * 2 <= vr:
            k *= 2
        recv = s._add(RecvOp(deps=(), peer=(vr - k + root) % n,
                             buf=buf, round=0))
    prev_send = None
    k = 1
    while k < n:
        if vr < k and vr + k < n:
            deps = tuple(d for d in (recv, prev_send) if d is not None)
            prev_send = s._add(SendOp(deps=deps,
                                      peer=(vr + k + root) % n,
                                      buf=buf, round=0))
        k *= 2
    s.slot_sizes[0] = max(s.slot_sizes.get(0, 0), nbytes)
    s.rounds = 1
    s.result = buf
    s.validate()
    return s


def _compile_reduce(n: int, rank: int, root: int, nbytes: int) -> Schedule:
    """Binomial tree, op applied bottom-up; each incoming partial gets
    its own slot so the receives pre-post."""
    s = Schedule("reduce", n, rank)
    acc = BufRef(0, 0, nbytes)
    vr = (rank - root) % n
    prev_red = None
    j = 0
    k = 1
    r = 0
    while k < n:
        if vr % (2 * k) == 0:
            if vr + k < n:
                inc = BufRef(1 + j, 0, nbytes)
                recv = s._add(RecvOp(deps=(), peer=(vr + k + root) % n,
                                     buf=inc, round=r))
                rdeps = (recv,) + ((prev_red,) if prev_red is not None
                                   else ())
                prev_red = s._add(ReduceOp(deps=rdeps, dst=acc, src=inc))
                j += 1
        elif vr % (2 * k) == k:
            deps = (prev_red,) if prev_red is not None else ()
            s._add(SendOp(deps=deps, peer=(vr - k + root) % n, buf=acc,
                          round=r))
            break
        k *= 2
        r += 1
    s.slot_sizes[0] = max(s.slot_sizes.get(0, 0), nbytes)
    # FULL tree depth on every rank (a leaf breaks out early, but
    # rounds must be rank-UNIFORM: chunking derives its widening and
    # sub-round layout from it, and ranks must agree on wire tags)
    s.rounds = max((n - 1).bit_length(), 1)
    s.result = acc if rank == root else None
    s.validate()
    return s


def _compile_barrier(n: int, rank: int) -> Schedule:
    """Dissemination barrier as zero-byte messages: round r talks to
    ranks +-2^r; a round's send waits for the previous round's recv."""
    s = Schedule("barrier", n, rank)
    empty = BufRef(0, 0, 0)
    prev_recv = None
    r = 0
    k = 1
    while k < n:
        deps = (prev_recv,) if prev_recv is not None else ()
        s._add(SendOp(deps=deps, peer=(rank + k) % n, buf=empty,
                      round=r))
        prev_recv = s._add(RecvOp(deps=(), peer=(rank - k) % n,
                                  buf=empty, round=r))
        k <<= 1
        r += 1
    s.rounds = max(r, 1)
    s.result = None
    s.validate()
    return s


# --------------------------------------------------------------------------
# one-sided (RMA window) kinds — executed by a window-bound _SchedExec
# --------------------------------------------------------------------------

def _compile_rput(n: int, rank: int, nbytes: int, target: int) -> Schedule:
    """Request-based put: one PutOp of the whole payload; the chunking
    post-pass splits it into a per-chunk chain the engine pumps
    incrementally (local-completion semantics: the request completes
    when the last chunk left the source buffer)."""
    s = Schedule("rput", n, rank)
    s._add(PutOp(deps=(), target=target, buf=BufRef(0, 0, nbytes),
                 disp=0))
    s.rounds = 1
    s.result = None
    s.validate()
    return s


def _compile_rget(n: int, rank: int, nbytes: int, target: int) -> Schedule:
    """Request-based get: one GetOp, chunked like ``rput``."""
    s = Schedule("rget", n, rank)
    s._add(GetOp(deps=(), target=target, buf=BufRef(0, 0, nbytes),
                 disp=0))
    s.rounds = 1
    s.result = BufRef(0, 0, nbytes)
    s.validate()
    return s


def _compile_raccumulate(n: int, rank: int, nbytes: int,
                         target: int) -> Schedule:
    """Request-based accumulate: GetOp the target region into a scratch
    slot, ReduceOp the local operand (slot 0) into it, PutOp the result
    back — the read-modify-write as a three-node chain the engine pumps
    like any other schedule. Chunked, each chunk's get/reduce/put chain
    is independent (the regions split in lockstep), so a large
    accumulate moves one chunk per tick instead of stalling the engine
    for the whole reduction. Atomicity is the CALLER's job: the window
    holds the exclusive lock across the request's lifetime (acquired at
    issue, released on completion — see ``Window.raccumulate``)."""
    s = Schedule("raccumulate", n, rank)
    operand = BufRef(0, 0, nbytes)
    acc = BufRef(1, 0, nbytes)
    get = s._add(GetOp(deps=(), target=target, buf=acc, disp=0))
    red = s._add(ReduceOp(deps=(get,), dst=acc, src=operand))
    s._add(PutOp(deps=(red,), target=target, buf=acc, disp=0))
    s.rounds = 1
    s.result = None
    s.validate()
    return s


def _compile_allgather_get(n: int, rank: int, per_b: int) -> Schedule:
    """Get-based allgather over a window: each rank PUBLISHES its block
    into its OWN window segment (a self-put), announces readiness to
    every peer with a zero-byte token (round 0), then GETS every peer's
    block straight into the rank-ordered output slot the moment that
    peer's token arrives. A closing zero-byte token (round 1) tells each
    peer its segment has been read, so the collective is safe to repeat
    on the same window immediately. Data never rides the wire — only
    2(n-1) empty tokens do."""
    s = Schedule("allgather_get", n, rank)
    empty = BufRef(0, 0, 0)
    chunk = lambda t: BufRef(0, (t % n) * per_b, per_b)   # noqa: E731
    pub = s._add(PutOp(deps=(), target=rank, buf=chunk(rank), disp=0))
    for off in range(1, n):
        t = (rank + off) % n
        s._add(SendOp(deps=(pub,), peer=t, buf=empty, round=0))
    for off in range(1, n):
        t = (rank + off) % n
        rdy = s._add(RecvOp(deps=(), peer=t, buf=empty, round=0))
        get = s._add(GetOp(deps=(rdy,), target=t, buf=chunk(t), disp=0))
        s._add(SendOp(deps=(get,), peer=t, buf=empty, round=1))
    for off in range(1, n):
        t = (rank + off) % n
        s._add(RecvOp(deps=(), peer=t, buf=empty, round=1))
    s.slot_sizes[0] = max(s.slot_sizes.get(0, 0), n * per_b)
    s.rounds = 2
    s.result = BufRef(0, 0, n * per_b)
    s.validate()
    return s


def _compile_bcast_put(n: int, rank: int, root: int,
                       nbytes: int) -> Schedule:
    """Put-based binomial-tree bcast: the parent PUTS the payload into
    this rank's own window segment and follows with a zero-byte token;
    on token arrival the rank GETS the payload from its own segment into
    slot 0 (the landing copy), forwards by putting into each child's
    segment, and finally acks the parent (round 1) so the parent's
    completion implies its subtree no longer reads any segment it wrote
    — back-to-back bcasts on one window cannot overwrite in-flight
    data."""
    s = Schedule("bcast_put", n, rank)
    buf = BufRef(0, 0, nbytes)
    empty = BufRef(0, 0, 0)
    vr = (rank - root) % n
    land = None
    parent = None
    if vr:
        k = 1
        while k * 2 <= vr:
            k *= 2
        parent = (vr - k + root) % n
        tok = s._add(RecvOp(deps=(), peer=parent, buf=empty, round=0))
        land = s._add(GetOp(deps=(tok,), target=rank, buf=buf, disp=0))
    prev_send = None
    acks = []
    k = 1
    while k < n:
        if vr < k and vr + k < n:
            child = (vr + k + root) % n
            deps = tuple(d for d in (land, prev_send) if d is not None)
            put = s._add(PutOp(deps=deps, target=child, buf=buf, disp=0))
            prev_send = s._add(SendOp(deps=(put,), peer=child, buf=empty,
                                      round=0))
            acks.append(s._add(RecvOp(deps=(), peer=child, buf=empty,
                                      round=1)))
        k *= 2
    if parent is not None:
        deps = (land,) + (tuple(acks) if acks else ())
        s._add(SendOp(deps=deps, peer=parent, buf=empty, round=1))
    s.slot_sizes[0] = max(s.slot_sizes.get(0, 0), nbytes)
    s.rounds = 2
    s.result = buf
    s.validate()
    return s


_COMPILERS = {
    "allreduce_rd": lambda n, rank, nbytes, itemsize, root, group:
        _compile_allreduce_rd(n, rank, nbytes),
    "allreduce_ring": lambda n, rank, nbytes, itemsize, root, group:
        _compile_allreduce_ring(n, rank, nbytes, itemsize),
    "allreduce_hier": lambda n, rank, nbytes, itemsize, root, group:
        _compile_allreduce_hier(n, rank, nbytes, itemsize, group),
    "reduce_scatter_ring": lambda n, rank, nbytes, itemsize, root, group:
        _compile_reduce_scatter_ring(n, rank, nbytes, itemsize),
    "allgather_ring": lambda n, rank, nbytes, itemsize, root, group:
        _compile_allgather_ring(n, rank, nbytes),
    "allgather_bruck": lambda n, rank, nbytes, itemsize, root, group:
        _compile_allgather_bruck(n, rank, nbytes),
    "bcast": lambda n, rank, nbytes, itemsize, root, group:
        _compile_bcast(n, rank, root, nbytes),
    "reduce": lambda n, rank, nbytes, itemsize, root, group:
        _compile_reduce(n, rank, root, nbytes),
    "barrier": lambda n, rank, nbytes, itemsize, root, group:
        _compile_barrier(n, rank),
    # one-sided kinds: ``root`` carries the TARGET rank for rput/rget
    # (the schedule is per-(nbytes, target) and cached like any other)
    "rput": lambda n, rank, nbytes, itemsize, root, group:
        _compile_rput(n, rank, nbytes, root),
    "rget": lambda n, rank, nbytes, itemsize, root, group:
        _compile_rget(n, rank, nbytes, root),
    "raccumulate": lambda n, rank, nbytes, itemsize, root, group:
        _compile_raccumulate(n, rank, nbytes, root),
    "allgather_get": lambda n, rank, nbytes, itemsize, root, group:
        _compile_allgather_get(n, rank, nbytes),
    "bcast_put": lambda n, rank, nbytes, itemsize, root, group:
        _compile_bcast_put(n, rank, root, nbytes),
}


def compile_schedule(comm, kind: str, nbytes: int = 0, itemsize: int = 1,
                     root: int = 0, *, group: int = 0,
                     chunk_bytes: int | None = None,
                     verify: bool = False) -> Schedule:
    """Compile (or fetch from the communicator's cache) the schedule for
    ``kind`` at this (size, rank, payload) — the once-per-(op, size,
    topology) contract. ``nbytes`` is the slot-0 payload for whole-
    buffer ops, the per-shard size for allgather kinds. ``group`` is
    the intra-group size for ``allreduce_hier``. ``chunk_bytes`` re-cuts
    the schedule at chunk granularity (see ``chunk_schedule``); it is
    widened — never narrowed — until the sub-round count fits the
    per-launch tag window, and the widened value is what the returned
    schedule's ``chunk_bytes`` reports.

    ``verify=True`` (debug hook) additionally runs the cross-rank
    static verifier over this config — compiling ALL ranks' schedules
    and checking send/recv matching, deadlock freedom, buffer hazards
    and resource bounds — and raises ``ScheduleInvariantError`` on any
    finding. Costs O(size) compilations; meant for tests and bring-up
    of new compilers, not hot paths."""
    if verify:
        from repro_torch.analysis import verify as _verify
        _verify.verify_config(kind, comm.size, nbytes=nbytes,
                              itemsize=itemsize, root=root, group=group,
                              chunk_bytes=chunk_bytes).raise_if_failed()
    if chunk_bytes is not None:
        # itemsize-align so no ReduceOp sub-region splits an element
        chunk_bytes = max(itemsize, chunk_bytes - chunk_bytes % itemsize)
    key = (kind, nbytes, itemsize, root, group, chunk_bytes)
    cache = comm._sched_cache
    sched = cache.get(key)
    if sched is None:
        sched = _COMPILERS[kind](comm.size, comm.rank, nbytes, itemsize,
                                 root, group)
        if sched.rounds > MAX_ROUNDS:
            raise ValueError(
                f"{kind} at size {comm.size} needs {sched.rounds} rounds"
                f" > MAX_ROUNDS={MAX_ROUNDS}")
        if chunk_bytes is not None:
            chunked = chunk_schedule(sched, chunk_bytes)
            if chunked.rounds > MAX_ROUNDS:
                # widen by the MINIMAL integer factor that fits the tag
                # window (sub-rounds scale ~1/chunk, so start at the
                # ceiling ratio and step by one base unit): doubling
                # here could overshoot a knee-derived chunk by nearly
                # 2x, pushing tuned sub-messages out of the cache tier
                # the profile chose them to fit
                base_cb = chunk_bytes
                factor = -(-chunked.rounds // MAX_ROUNDS)
                chunked = chunk_schedule(sched, base_cb * factor)
                while chunked.rounds > MAX_ROUNDS:
                    factor += 1
                    chunked = chunk_schedule(sched, base_cb * factor)
            sched = chunked
        cache[key] = sched
    return sched
