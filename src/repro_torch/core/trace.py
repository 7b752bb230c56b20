"""Flight recorder + metrics registry for the comm core.

An always-compiled, off-by-default tracer: every hot path in the comm
core (engine ticks, schedule-node issue/complete, pt2pt protocol
decisions, matchbox lifecycle, RMA epoch edges) carries an
instrumentation point of the form::

    tr = self.tracer
    if tr.enabled:
        tr.emit(EV_..., a0, a1, a2)

so the *disabled* cost is exactly one attribute load and one branch per
site (LP005 in ``repro.analysis.lint_protocol`` enforces the shape:
every ``emit`` call in a tick path must sit under an ``.enabled`` guard
and must not build f-strings or dicts in its arguments).

The recorder is a fixed-capacity ring of binary event records — five
``int64`` words per record ``(t_ns, event_id, a0, a1, a2)`` in one
preallocated ``array('q')`` that is NEVER reallocated; wraparound
overwrites the oldest records, keeping the newest ``capacity`` events
(flight-recorder semantics). Timestamps are ``time.monotonic_ns()``,
which on Linux is CLOCK_MONOTONIC — one epoch for every process on the
host; a dump carries them on the epoch clock (below), so per-rank dumps
from a multi-process run merge into one timeline with the card's.

Beside the ring, a tracer keeps SPANS while it records: intervals of
work with a name, a start, an end, a parent span and an id, stored whole
(never overwritten) as ``_SPAN_WORDS`` int64 words each in one growable
``array('q')`` up to ``span_capacity`` spans, beyond which they are
counted in ``spans_dropped``. The spans of one message carry its id
``(comm, src, dst, seq)`` on both ranks: ``seq`` is the per-pair count
of messages that the sender keeps as it sends and the receiver as it
dequeues first parts, equal on both sides because the pair queue is
FIFO. The spans of one collective call carry ``(comm, seq)``, the call's
number on its communicator, equal on every member because members call
collectives in one order. Both counts start from 0 at ``start``, which
the ranks call at the same point of their programs with no message in
flight. Sites open and close spans under the same ``.enabled`` guard as
``emit``. ``cur`` is the innermost span of the call chain that is
running: a span opened without a parent takes it, and the progress
engine sets it to a request's span while it turns that request, so the
device copies a message makes land under the message. Spans and ring
records are exported on the epoch clock (``time.time_ns``, the clock of
``torch.profiler``'s kineto events) through one anchor pair taken when
recording starts; the hot path reads ``time.monotonic_ns`` only.

On top of the ring sits a small metrics registry (``Metrics``:
counters, gauges, log2-bucket latency histograms). ``emit`` keeps
three histograms live while tracing is enabled — engine-tick duration,
posted-rendezvous hit latency (matchbox post -> consume), and
``wait_notify`` spin latency — and ``Tracer.report`` unifies them with
the aggregate ``ProtocolStats`` counters into one observable view
(``comm.trace_report()``).

Exporters:

* ``chrome_events(dump)`` / ``merge_dumps(dumps)`` — Chrome
  trace-event JSON (load in Perfetto / chrome://tracing): one process
  lane per rank; engine ticks and schedule executions as duration
  slices; every schedule NODE gets its own sub-lane (so a chunked
  iallreduce renders as per-chunk lanes); pt2pt decisions and matchbox
  lifecycle as instants; RMA fence/flush/wait as nested B/E slices;
  then each rank's spans in lanes of their own (``span_events``).
* ``summarize_dumps(dumps)`` — text top-N event summary + histogram
  percentiles.
* ``python -m repro_torch.trace merge|summarize`` — stitch per-rank
  dump files from a multi-process run (see ``repro_torch/trace.py``).

Thread safety: a tracer is written by its owning rank's cooperative
engine only (one writer); ``split()``/``dup()`` children share the
parent's tracer so a rank's whole comm tree lands in one ring.
"""
from __future__ import annotations

import json
import time
from array import array
from pathlib import Path

__all__ = [
    "Tracer", "Metrics", "as_tracer", "chrome_events", "merge_dumps",
    "summarize_dumps", "load_dump", "EV_NAMES", "SPAN_NAMES", "NULL_TRACER",
    "span_events",
]

_REC_WORDS = 5
DEFAULT_CAPACITY = 1 << 15          # 32768 records x 40 B = 1.25 MiB
DEFAULT_SPAN_CAPACITY = 1 << 22     # spans kept whole, 96 B each
_SPAN_CHUNK = 1 << 14               # spans allocated at a time, at least

# ---------------------------------------------------------------------------
# event taxonomy (ids are wire-stable within a dump via EV_NAMES)
# ---------------------------------------------------------------------------

EV_TICK = 1                 # engine tick with work    a0=duration_ns
EV_PT2PT_EAGER = 10         # eager send decision      a0=peer a1=nbytes a2=tag
EV_PT2PT_STAGED = 11        # staged-rendezvous send   a0=peer a1=nbytes a2=tag
EV_PT2PT_POSTED = 12        # posted-rendezvous send   a0=peer a1=nbytes a2=tag
EV_MB_POST = 20             # matchbox entry posted    a0=post_id a1=peer a2=cap
EV_MB_CLAIM = 21            # sender claimed an entry  a0=post_id a1=peer a2=nbytes
EV_MB_SPILL = 22            # posting spilled to FIFO  a0=post_id a1=peer
EV_MB_PROMOTE = 23          # spilled posting promoted a0=post_id a1=peer
EV_MB_RETRACT = 24          # receiver retracted       a0=post_id
EV_MB_CONSUME = 25          # posted data consumed     a0=post_id a1=peer a2=nbytes
EV_SCHED_BEGIN = 30         # schedule exec started    a0=exec a1=kind_sid a2=nodes
EV_SCHED_END = 31           # schedule exec complete   a0=exec
EV_SCHED_ISSUE = 32         # node issued              a0=exec a1=node_idx
EV_SCHED_DONE = 33          # node retired             a0=exec a1=node_idx
EV_SCHED_ABORT = 34         # exec aborted             a0=exec a1=node_idx
EV_RMA_PUT = 40             # window put executed      a0=target a1=nbytes
EV_RMA_GET = 41             # window get executed      a0=target a1=nbytes
EV_RMA_NOTIFY = 42          # put_notify payload+bump  a0=target a1=nbytes
EV_RMA_WAIT_BEGIN = 43      # wait_notify spin entered a0=source
EV_RMA_WAIT_END = 44        # wait_notify satisfied    a0=source
EV_RMA_FENCE_BEGIN = 45     # fence entered
EV_RMA_FENCE_END = 46       # fence passed
EV_RMA_FLUSH_BEGIN = 47     # flush entered            a0=target(-1=all)
EV_RMA_FLUSH_END = 48       # flush complete           a0=target(-1=all)
EV_RMA_LOCK_ALL = 49        # passive epoch opened
EV_RMA_UNLOCK_ALL = 50      # passive epoch closed

EV_NAMES = {
    EV_TICK: "engine.tick",
    EV_PT2PT_EAGER: "pt2pt.eager",
    EV_PT2PT_STAGED: "pt2pt.staged",
    EV_PT2PT_POSTED: "pt2pt.posted",
    EV_MB_POST: "mb.post",
    EV_MB_CLAIM: "mb.claim",
    EV_MB_SPILL: "mb.spill",
    EV_MB_PROMOTE: "mb.promote",
    EV_MB_RETRACT: "mb.retract",
    EV_MB_CONSUME: "mb.consume",
    EV_SCHED_BEGIN: "sched.begin",
    EV_SCHED_END: "sched.end",
    EV_SCHED_ISSUE: "sched.issue",
    EV_SCHED_DONE: "sched.done",
    EV_SCHED_ABORT: "sched.abort",
    EV_RMA_PUT: "rma.put",
    EV_RMA_GET: "rma.get",
    EV_RMA_NOTIFY: "rma.notify",
    EV_RMA_WAIT_BEGIN: "rma.wait_notify.begin",
    EV_RMA_WAIT_END: "rma.wait_notify.end",
    EV_RMA_FENCE_BEGIN: "rma.fence.begin",
    EV_RMA_FENCE_END: "rma.fence.end",
    EV_RMA_FLUSH_BEGIN: "rma.flush.begin",
    EV_RMA_FLUSH_END: "rma.flush.end",
    EV_RMA_LOCK_ALL: "rma.lock_all",
    EV_RMA_UNLOCK_ALL: "rma.unlock_all",
}

# span taxonomy (ids wire-stable within a dump via SPAN_NAMES). No name
# starts with "collective:", the prefix of the benchmark's own wrappers.
SP_SEND = 1           # isend entry -> the message's last part committed
SP_RECV = 2           # post -> completion
SP_WAIT = 3           # post -> first dequeue of the message's first part
SP_DELIVER = 4        # first dequeue -> completion
SP_QUEUE_WAIT = 5     # a send's wait for a free cell of the pair queue
SP_STAGER = 6         # arena.create of a staged send's stager
SP_STAGER_FREE = 12   # arena.destroy of it, once the sender saw the ack
SP_ACK = 7            # instant: the receiver's ack store (staged path)
SP_ACK_SEEN = 8       # instant: the sender sees the ack
SP_COPY = 9           # a device copy to or from the pool: launch -> sync
SP_SYNC = 10          # torch.cuda.current_stream().synchronize()
SP_WAITALL = 11       # progress.waitall
SP_BARRIER = 20       # collective calls, entry -> the result's return
SP_IBARRIER = 21
SP_BCAST = 22
SP_IBCAST = 23
SP_REDUCE = 24
SP_ALLREDUCE = 25
SP_IALLREDUCE = 26
SP_REDUCE_SCATTER = 27
SP_IREDUCE_SCATTER = 28
SP_ALLGATHER = 29
SP_IALLGATHER = 30
SP_ALLTOALL = 31
SP_PREFILL = 40       # one serve step
SP_DECODE = 41
SP_MOE_DISPATCH = 42  # moe_apply_ep: route + dispatch
SP_MOE_EXPERTS = 43   # its experts
SP_MOE_COMBINE = 44   # combine and the sum over ``model``
SP_MAMBA_MIXER = 45   # blocks.mamba_apply: one Mamba layer's mixer
SP_MAMBA_SCAN = 46    # its selective scan (a full sequence)
SP_STATE_FILL = 47    # lm.prefill writing the decode state

SPAN_NAMES = {
    SP_SEND: "pt2pt.send",
    SP_RECV: "pt2pt.recv",
    SP_WAIT: "pt2pt.wait",
    SP_DELIVER: "pt2pt.deliver",
    SP_QUEUE_WAIT: "pt2pt.queue_full",
    SP_STAGER: "arena.create",
    SP_STAGER_FREE: "arena.destroy",
    SP_ACK: "pt2pt.ack",
    SP_ACK_SEEN: "pt2pt.ack_seen",
    SP_COPY: "pool.copy",
    SP_SYNC: "pool.sync",
    SP_WAITALL: "progress.waitall",
    SP_BARRIER: "coll.barrier",
    SP_IBARRIER: "coll.ibarrier",
    SP_BCAST: "coll.bcast",
    SP_IBCAST: "coll.ibcast",
    SP_REDUCE: "coll.reduce",
    SP_ALLREDUCE: "coll.allreduce",
    SP_IALLREDUCE: "coll.iallreduce",
    SP_REDUCE_SCATTER: "coll.reduce_scatter",
    SP_IREDUCE_SCATTER: "coll.ireduce_scatter",
    SP_ALLGATHER: "coll.allgather",
    SP_IALLGATHER: "coll.iallgather",
    SP_ALLTOALL: "coll.alltoall",
    SP_PREFILL: "serve.prefill",
    SP_DECODE: "serve.decode",
    SP_MOE_DISPATCH: "moe.dispatch",
    SP_MOE_EXPERTS: "moe.experts",
    SP_MOE_COMBINE: "moe.combine",
    SP_MAMBA_MIXER: "mamba.mixer",
    SP_MAMBA_SCAN: "mamba.scan",
    SP_STATE_FILL: "serve.state_fill",
}

# the pt2pt path a send span took
PATH_EAGER, PATH_STAGED, PATH_POSTED, PATH_SELF = 1, 2, 3, 4
PATH_NAMES = {0: "", PATH_EAGER: "eager", PATH_STAGED: "staged",
              PATH_POSTED: "posted", PATH_SELF: "self"}

# a span's words: name, start, end (0 while open), parent (-1: none),
# comm (interned name), src, dst, seq, bytes, yields, ticks, path
_SPAN_WORDS = 12
SPAN_FIELDS = ("name", "start_ns", "end_ns", "parent", "comm", "src", "dst",
               "seq", "bytes", "yields", "ticks", "path")


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

class Histogram:
    """Log2-bucket latency histogram over nanosecond samples.

    Bucket ``b`` holds samples with ``bit_length() == b`` (i.e. values
    in ``[2**(b-1), 2**b)``); percentiles report the bucket's upper
    edge, so they are <= 2x the true value — the right fidelity for a
    "where did this microsecond go" histogram at zero allocation per
    sample.
    """

    __slots__ = ("buckets", "count", "total")

    def __init__(self):
        self.buckets = [0] * 64
        self.count = 0
        self.total = 0

    def record(self, ns: int) -> None:
        if ns < 0:
            ns = 0
        self.buckets[min(ns.bit_length(), 63)] += 1
        self.count += 1
        self.total += ns

    def percentile(self, q: float) -> int:
        """Upper bucket edge at quantile ``q`` in [0, 1]."""
        if self.count == 0:
            return 0
        target = max(1, int(q * self.count + 0.999999))
        cum = 0
        for b, n in enumerate(self.buckets):
            cum += n
            if cum >= target:
                return 1 << b
        return 1 << 63

    def summary(self) -> dict:
        return {
            "count": self.count,
            "total_ns": self.total,
            "avg_ns": self.total // self.count if self.count else 0,
            "p50_ns": self.percentile(0.50),
            "p90_ns": self.percentile(0.90),
            "p99_ns": self.percentile(0.99),
        }


class Metrics:
    """Named counters, gauges and histograms for non-hot-path metrics.

    Hot paths go through ``Tracer.emit`` (int event ids, no string
    keys); this registry is for everything else — subsystem-level
    counters (a future serving tier's admission counts), gauges
    (queue depths), and extra latency histograms.
    """

    def __init__(self):
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str, inc: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, ns: int) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        h.record(ns)

    def view(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.summary()
                           for k, h in self.histograms.items()},
        }


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

class Tracer:
    """Fixed-capacity binary ring of ``(t_ns, ev, a0, a1, a2)`` records.

    ``enabled`` is THE predicate every instrumentation site checks; a
    disabled tracer is a real object (so tests can inject a counting
    recorder and assert zero writes) whose only runtime footprint is
    that one attribute.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, rank: int = 0,
                 enabled: bool = True,
                 span_capacity: int = DEFAULT_SPAN_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = enabled
        self.rank = rank
        self.capacity = capacity
        # one preallocated int64 array; emit never allocates records
        self._buf = array("q", bytes(8 * _REC_WORDS * capacity))
        self._head = 0                  # total records ever written
        self._strings: dict[str, int] = {}
        self._names: dict[int, str] = {}
        self._next_exec = 0
        # keyed (post_id, peer): post_ids are per-pair monotone
        # sequences each starting at 1, so ids alone collide across
        # source ranks
        self._post_t: dict[tuple[int, int], int] = {}
        self._wait_t: dict[int, int] = {}     # source  -> wait-begin t_ns
        self.metrics = Metrics()
        self.counts: dict[int, int] = {}      # event id -> emits
        self.hist_tick = Histogram()
        self.hist_posted_hit = Histogram()
        self.hist_notify_wait = Histogram()
        # spans: grown in chunks, never shrunk, up to span_capacity
        self.span_capacity = span_capacity
        self._sp = array("q")
        self._n_sp = 0
        self.spans_dropped = 0
        self.cur = -1                   # innermost running span
        self.sync_calls = 0             # the core's stream syncs ...
        self.sync_ns = 0                # ... and the time inside them
        self.arena_frees = 0            # the arena's frees ...
        self.arena_merged = 0           # ... those that coalesced
        self.freelist_peak = 0          # the longest free list seen
        self.allreduce_direct = 0       # pieces summed by allreduce_pair
        self._seq_out: dict[int, int] = {}    # (comm, dst) -> next seq
        self._seq_in: dict[int, int] = {}     # (comm, src) -> next seq
        self._call_seq: dict[int, int] = {}   # comm -> next call seq
        self._stagers: dict[int, int] = {}    # stager offset -> send span
        self._anchor()

    # -- recording window --------------------------------------------------

    def _anchor(self) -> None:
        """The epoch clock less the monotonic one: an epoch reading
        between two monotonic ones, the narrowest of a few tries (a try
        the process was switched out in reads wide)."""
        best = None
        for _ in range(5):
            m0 = time.monotonic_ns()
            e = time.time_ns()
            m1 = time.monotonic_ns()
            if best is None or m1 - m0 < best[0]:
                best = (m1 - m0, e - (m0 + m1) // 2)
        self.epoch_offset_ns = best[1]

    def start(self, capacity: int | None = None,
              span_capacity: int | None = None) -> None:
        """Record from now on. The ring (resized to ``capacity`` records
        where given), the spans (up to ``span_capacity``), the counters
        and the message and call counts start empty, and the clocks are
        anchored anew. The communicators that share this tracer (every
        ``split``/``dup`` child) record with it. Call it on every rank
        at the same point of the program, with no message in flight, so
        that the ranks' counts name the same messages and calls."""
        if capacity is not None and capacity != self.capacity:
            if capacity < 1:
                raise ValueError(f"capacity must be >= 1, got {capacity}")
            self.capacity = capacity
            self._buf = array("q", bytes(8 * _REC_WORDS * capacity))
        if span_capacity is not None:
            self.span_capacity = span_capacity
        self.clear()
        self._anchor()
        self.enabled = True

    def stop(self) -> None:
        """Record nothing more; what was recorded stays to be read."""
        self.enabled = False

    # -- hot path ----------------------------------------------------------

    def emit(self, ev: int, a0: int = 0, a1: int = 0, a2: int = 0) -> None:
        """Append one record. Callers in tick paths must guard with
        ``if tracer.enabled:`` (LP005)."""
        t = time.monotonic_ns()
        b = self._buf
        i = (self._head % self.capacity) * _REC_WORDS
        b[i] = t
        b[i + 1] = ev
        b[i + 2] = a0
        b[i + 3] = a1
        b[i + 4] = a2
        self._head += 1
        self.counts[ev] = self.counts.get(ev, 0) + 1
        # live histograms: tick duration, post->consume, wait_notify spin
        if ev == EV_TICK:
            self.hist_tick.record(a0)
        elif ev == EV_MB_POST:
            self._post_t[(a0, a1)] = t
        elif ev == EV_MB_CONSUME:
            t0 = self._post_t.pop((a0, a1), None)
            if t0 is not None:
                self.hist_posted_hit.record(t - t0)
        elif ev == EV_RMA_WAIT_BEGIN:
            self._wait_t[a0] = t
        elif ev == EV_RMA_WAIT_END:
            t0 = self._wait_t.pop(a0, None)
            if t0 is not None:
                self.hist_notify_wait.record(t - t0)

    # -- spans (hot path: callers guard with ``if tracer.enabled:``) -------

    def open_span(self, name: int, parent: int = -1, comm: int = 0,
                  src: int = -1, dst: int = -1, seq: int = -1,
                  nbytes: int = 0, path: int = 0, t: int = 0) -> int:
        """Open a span at ``t`` (now where 0); returns its index, or -1
        where ``span_capacity`` is reached (counted in ``spans_dropped``).
        Its words are ints only: no object is made per span."""
        i = self._n_sp
        if i >= self.span_capacity:
            self.spans_dropped += 1
            return -1
        b = self._sp
        k = i * _SPAN_WORDS
        if k >= len(b):
            grow = min(max(_SPAN_CHUNK, i), self.span_capacity - i)
            b.frombytes(bytes(8 * _SPAN_WORDS * grow))
        b[k] = name
        b[k + 1] = t or time.monotonic_ns()
        b[k + 2] = 0
        b[k + 3] = parent
        b[k + 4] = comm
        b[k + 5] = src
        b[k + 6] = dst
        b[k + 7] = seq
        b[k + 8] = nbytes
        b[k + 9] = 0
        b[k + 10] = 0
        b[k + 11] = path
        self._n_sp = i + 1
        return i

    def open_child(self, name: int, parent: int, nbytes: int = 0,
                   t: int = 0) -> int:
        """Open a span of part of the work of span ``parent`` (a copy,
        a sync, a wait), carrying its parent's id."""
        i = self.open_span(name, parent, nbytes=nbytes, t=t)
        if i >= 0 and parent >= 0:
            b, k, j = self._sp, i * _SPAN_WORDS, parent * _SPAN_WORDS
            for w in range(4, 8):
                b[k + w] = b[j + w]
        return i

    def close_span(self, i: int, t: int = 0) -> int:
        """End span ``i`` (if kept) at ``t`` (now where 0); returns the
        time."""
        t = t or time.monotonic_ns()
        if i >= 0:
            self._sp[i * _SPAN_WORDS + 2] = t
        return t

    def end_send(self, i: int, path: int) -> None:
        """A send's last part is in the pair queue by ``path``."""
        if i >= 0:
            k = i * _SPAN_WORDS
            self._sp[k + 2] = time.monotonic_ns()
            self._sp[k + 11] = path

    def push_span(self, name: int, comm: int = 0, seq: int = -1,
                  nbytes: int = 0) -> int:
        """Open a span under ``cur`` and make it ``cur``: work that runs
        inside the caller's call chain (a collective call, a serve
        step)."""
        i = self.open_span(name, self.cur, comm, -1, -1, seq, nbytes)
        if i >= 0:
            self.cur = i
        return i

    def pop_span(self, i: int) -> None:
        """End a ``push_span`` span; ``cur`` goes back to its parent."""
        if i >= 0:
            k = i * _SPAN_WORDS
            self._sp[k + 2] = time.monotonic_ns()
            self.cur = self._sp[k + 3]

    def leave_span(self, i: int) -> None:
        """``cur`` goes back to the parent of ``push_span`` span ``i``,
        which stays open (a non-blocking call returns; ``close_span``
        ends it)."""
        if i >= 0:
            self.cur = self._sp[i * _SPAN_WORDS + 3]

    def mark(self, name: int, of: int) -> int:
        """An instant (a span of no length) carrying the id of span
        ``of``, its parent."""
        i = self.open_span(name, of)
        if i >= 0:
            b, k = self._sp, i * _SPAN_WORDS
            b[k + 2] = b[k + 1]
            if of >= 0:
                j = of * _SPAN_WORDS
                for w in range(4, 9):
                    b[k + w] = b[j + w]
                b[k + 11] = b[j + 11]
        return i

    def add_waits(self, i: int, yields: int, ticks: int) -> None:
        """Count the yields and progress ticks of a blocking call on its
        span ``i``."""
        if i >= 0:
            k = i * _SPAN_WORDS
            self._sp[k + 9] += yields
            self._sp[k + 10] += ticks

    def send_seq(self, comm: int, dst: int) -> int:
        """The next message's number from this rank to ``dst`` on
        ``comm``."""
        key = (comm << 24) | dst
        seq = self._seq_out.get(key, 0)
        self._seq_out[key] = seq + 1
        return seq

    def call_seq(self, comm: int) -> int:
        """The next collective call's number on ``comm``."""
        seq = self._call_seq.get(comm, 0)
        self._call_seq[comm] = seq + 1
        return seq

    def dequeued(self, rsp: int, wsp: int, comm: int, src: int, dst: int,
                 nbytes: int, match: bool) -> int:
        """The first part of a message from ``src`` was dequeued by the
        receive of span ``rsp`` (its wait span ``wsp``): the message is
        counted; where the receive takes it, its id goes on the receive,
        the wait ends and a deliver span starts, whose index is returned
        (else -1: the message is parked for another receive)."""
        key = (comm << 24) | src
        seq = self._seq_in.get(key, 0)
        self._seq_in[key] = seq + 1
        if not match or rsp < 0:
            return -1
        t = time.monotonic_ns()
        b = self._sp
        for s in (rsp, wsp):
            if s >= 0:
                k = s * _SPAN_WORDS
                b[k + 7] = seq
                b[k + 8] = nbytes
        if wsp >= 0:
            b[wsp * _SPAN_WORDS + 2] = t
        return self.open_span(SP_DELIVER, rsp, comm, src, dst, seq, nbytes,
                              t=t)

    def recv_done(self, rsp: int, wsp: int, dsp: int) -> None:
        """A receive completed (or was withdrawn): its spans still open
        end now."""
        t = time.monotonic_ns()
        b = self._sp
        for s in (dsp, wsp, rsp):
            if s >= 0 and not b[s * _SPAN_WORDS + 2]:
                b[s * _SPAN_WORDS + 2] = t

    def staged(self, off: int, sp: int) -> None:
        """Send span ``sp`` left its stager at pool offset ``off``."""
        self._stagers[off] = sp

    def ack_seen(self, off: int) -> int:
        """The sender saw the ack of the stager at ``off``; returns the
        span of the send that left it (-1 where none is known)."""
        sp = self._stagers.pop(off, -1)
        if sp >= 0:
            self.mark(SP_ACK_SEEN, sp)
        return sp

    def synced(self, i: int, t0: int) -> int:
        """A stream sync begun at ``t0`` returned: counted, and its span
        ``i`` ended; returns the time."""
        t = time.monotonic_ns()
        self.sync_calls += 1
        self.sync_ns += t - t0
        if i >= 0:
            self._sp[i * _SPAN_WORDS + 2] = t
        return t

    # -- span export -------------------------------------------------------

    def span_rows(self) -> list[tuple]:
        """Every kept span, in the order opened, as a tuple of
        ``SPAN_FIELDS``: times on the epoch clock (an open span's end is
        0), the name, the comm's name and the path as strings."""
        off = self.epoch_offset_ns
        b = self._sp
        names = self._names
        out = []
        for i in range(self._n_sp):
            k = i * _SPAN_WORDS
            t1 = b[k + 2]
            out.append((SPAN_NAMES.get(b[k], f"span{b[k]}"), b[k + 1] + off,
                        t1 + off if t1 else 0, b[k + 3],
                        names.get(b[k + 4], ""), b[k + 5], b[k + 6],
                        b[k + 7], b[k + 8], b[k + 9], b[k + 10],
                        PATH_NAMES.get(b[k + 11], "")))
        return out

    def span_counters(self) -> dict:
        return {"spans_kept": self._n_sp,
                "spans_dropped": self.spans_dropped,
                "sync_calls": self.sync_calls, "sync_ns": self.sync_ns,
                "arena_frees": self.arena_frees,
                "arena_merged": self.arena_merged,
                "freelist_peak": self.freelist_peak,
                "allreduce_direct": self.allreduce_direct}

    def intern(self, s: str) -> int:
        """Map a string (schedule kind, lane label) to a small id so
        hot-path records carry ints only. Call once per execution at
        setup time, not per event."""
        sid = self._strings.get(s)
        if sid is None:
            sid = self._strings[s] = len(self._strings) + 1
            self._names[sid] = s
        return sid

    def next_exec_id(self) -> int:
        self._next_exec += 1
        return self._next_exec

    # -- inspection --------------------------------------------------------

    @property
    def recorded(self) -> int:
        """Total records ever written (wraparound does not reset it)."""
        return self._head

    def events(self) -> list[tuple[int, int, int, int, int]]:
        """The newest ``min(recorded, capacity)`` records, oldest
        first."""
        n = min(self._head, self.capacity)
        b = self._buf
        out = []
        for k in range(self._head - n, self._head):
            i = (k % self.capacity) * _REC_WORDS
            out.append((b[i], b[i + 1], b[i + 2], b[i + 3], b[i + 4]))
        return out

    def clear(self) -> None:
        self._head = 0
        self.counts.clear()
        self._post_t.clear()
        self._wait_t.clear()
        self.hist_tick = Histogram()
        self.hist_posted_hit = Histogram()
        self.hist_notify_wait = Histogram()
        self._n_sp = 0
        self.spans_dropped = 0
        self.cur = -1
        self.sync_calls = 0
        self.sync_ns = 0
        self.arena_frees = 0
        self.arena_merged = 0
        self.freelist_peak = 0
        self.allreduce_direct = 0
        self._seq_out.clear()
        self._seq_in.clear()
        self._call_seq.clear()
        self._stagers.clear()

    def report(self, stats=None) -> dict:
        """Unified metrics view: event counters, the live latency
        histograms, registry metrics and (when given) the aggregate
        ``ProtocolStats`` snapshot."""
        reg = self.metrics.view()
        counters = {EV_NAMES.get(ev, f"ev{ev}"): n
                    for ev, n in sorted(self.counts.items())}
        counters.update(reg["counters"])
        hists = {
            "engine_tick_ns": self.hist_tick.summary(),
            "posted_hit_ns": self.hist_posted_hit.summary(),
            "notify_wait_ns": self.hist_notify_wait.summary(),
        }
        hists.update(reg["histograms"])
        out = {
            "rank": self.rank,
            "enabled": self.enabled,
            "events_recorded": self._head,
            "events_kept": min(self._head, self.capacity),
            "counters": counters,
            "gauges": reg["gauges"],
            "histograms": hists,
            "spans": self.span_counters(),
        }
        if stats is not None:
            out["protocol_stats"] = stats.snapshot()
        return out

    def dump(self, path, stats=None) -> str:
        """Write this rank's ring, spans and report as a JSON dump file
        that ``python -m repro_torch.trace merge`` can stitch with its
        peers; every time in it is on the epoch clock."""
        off = self.epoch_offset_ns
        d = {
            "schema": 1,
            "rank": self.rank,
            "strings": {str(k): v for k, v in self._names.items()},
            "events": [[e[0] + off, *e[1:]] for e in self.events()],
            "spans": [list(s) for s in self.span_rows()],
            "report": self.report(stats),
        }
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(d) + "\n")
        return str(p)


def as_tracer(trace, rank: int) -> Tracer:
    """Normalize the ``Comm(trace=...)`` argument.

    None/False -> disabled 1-slot tracer; True -> enabled default
    capacity; int -> enabled with that capacity; a ``Tracer`` instance
    is used as-is (tests inject counting recorders this way; children
    of ``split()``/``dup()`` share the parent's).
    """
    if isinstance(trace, Tracer):
        return trace
    if trace is None or trace is False:
        return Tracer(capacity=1, rank=rank, enabled=False)
    if trace is True:
        return Tracer(rank=rank)
    if isinstance(trace, int):
        return Tracer(capacity=trace, rank=rank)
    raise TypeError(f"trace= must be None, bool, int capacity or a "
                    f"Tracer, got {type(trace).__name__}")


# sites with no communicator's tracer to hand (a copy made outside any
# communicator) record into this one, which is never turned on
NULL_TRACER = Tracer(capacity=1, enabled=False)


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------

# fixed lanes (tid) within each rank's process lane (pid)
LANE_ENGINE = 0
LANE_PT2PT = 1
LANE_MATCHBOX = 2
LANE_RMA = 3
_SCHED_TID_BASE = 100       # exec e -> lane base 100 + e*512; node i at +1+i
_SCHED_LANE_SPAN = 512

_PT2PT_EVS = {EV_PT2PT_EAGER: "eager", EV_PT2PT_STAGED: "staged",
              EV_PT2PT_POSTED: "posted"}
_MB_EVS = {EV_MB_POST: "post", EV_MB_CLAIM: "claim", EV_MB_SPILL: "spill",
           EV_MB_PROMOTE: "promote", EV_MB_RETRACT: "retract",
           EV_MB_CONSUME: "consume"}
_RMA_INSTANTS = {EV_RMA_PUT: "put", EV_RMA_GET: "get",
                 EV_RMA_NOTIFY: "put_notify", EV_RMA_LOCK_ALL: "lock_all",
                 EV_RMA_UNLOCK_ALL: "unlock_all"}
_RMA_BEGINS = {EV_RMA_WAIT_BEGIN: "wait_notify",
               EV_RMA_FENCE_BEGIN: "fence", EV_RMA_FLUSH_BEGIN: "flush"}
_RMA_ENDS = {EV_RMA_WAIT_END: "wait_notify", EV_RMA_FENCE_END: "fence",
             EV_RMA_FLUSH_END: "flush"}


def _meta(pid: int, tid: int, name: str) -> dict:
    return {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": name}}


def chrome_events(dump: dict) -> list[dict]:
    """Convert one rank's dump to Chrome trace-event dicts.

    pid = rank. Fixed lanes: engine (tick duration slices), pt2pt
    (protocol-decision instants), matchbox (lifecycle instants), rma
    (epoch edges as properly nested B/E slices — fence encloses the
    flush it performs). Each schedule execution gets an exec lane (one
    enclosing slice) plus ONE LANE PER NODE, so slices never overlap
    within a lane and a chunked schedule reads as per-chunk rows.
    """
    rank = int(dump["rank"])
    strings = {int(k): v for k, v in dump.get("strings", {}).items()}
    out = [
        {"ph": "M", "name": "process_name", "pid": rank, "tid": 0,
         "args": {"name": f"rank {rank}"}},
        _meta(rank, LANE_ENGINE, "engine"),
        _meta(rank, LANE_PT2PT, "pt2pt"),
        _meta(rank, LANE_MATCHBOX, "matchbox"),
        _meta(rank, LANE_RMA, "rma"),
    ]
    sched_kind: dict[int, str] = {}
    open_sched: dict[int, int] = {}
    open_node: dict[tuple[int, int], int] = {}
    named_lanes: set[int] = set()
    for t, ev, a0, a1, a2 in dump["events"]:
        ts = t / 1000.0                          # Chrome wants us
        if ev == EV_TICK:
            out.append({"name": "tick", "ph": "X", "pid": rank,
                        "tid": LANE_ENGINE, "ts": (t - a0) / 1000.0,
                        "dur": a0 / 1000.0})
        elif ev in _PT2PT_EVS:
            out.append({"name": _PT2PT_EVS[ev], "ph": "i", "s": "t",
                        "pid": rank, "tid": LANE_PT2PT, "ts": ts,
                        "args": {"peer": a0, "bytes": a1, "tag": a2}})
        elif ev in _MB_EVS:
            out.append({"name": _MB_EVS[ev], "ph": "i", "s": "t",
                        "pid": rank, "tid": LANE_MATCHBOX, "ts": ts,
                        "args": {"post_id": a0, "peer": a1, "bytes": a2}})
        elif ev == EV_SCHED_BEGIN:
            sched_kind[a0] = strings.get(a1, f"kind{a1}")
            open_sched[a0] = t
        elif ev == EV_SCHED_ISSUE:
            open_node[(a0, a1)] = t
        elif ev == EV_SCHED_DONE:
            t0 = open_node.pop((a0, a1), None)
            if t0 is None:
                continue                         # issue fell off the ring
            kind = sched_kind.get(a0, "sched")
            base = _SCHED_TID_BASE + (a0 % 1024) * _SCHED_LANE_SPAN
            tid = base + 1 + a1 % (_SCHED_LANE_SPAN - 1)
            if tid not in named_lanes:
                named_lanes.add(tid)
                out.append(_meta(rank, tid, f"{kind}#{a0} nodes"))
            out.append({"name": f"{kind}[{a1}]", "ph": "X", "pid": rank,
                        "tid": tid, "ts": t0 / 1000.0,
                        "dur": max(t - t0, 1) / 1000.0,
                        "args": {"exec": a0, "node": a1}})
        elif ev in (EV_SCHED_END, EV_SCHED_ABORT):
            t0 = open_sched.pop(a0, None)
            if t0 is None:
                continue
            kind = sched_kind.get(a0, "sched")
            tid = _SCHED_TID_BASE + (a0 % 1024) * _SCHED_LANE_SPAN
            if tid not in named_lanes:
                named_lanes.add(tid)
                out.append(_meta(rank, tid, f"{kind}#{a0}"))
            name = f"sched:{kind}" + (" ABORTED"
                                      if ev == EV_SCHED_ABORT else "")
            out.append({"name": name, "ph": "X", "pid": rank, "tid": tid,
                        "ts": t0 / 1000.0, "dur": max(t - t0, 1) / 1000.0,
                        "args": {"exec": a0}})
        elif ev in _RMA_INSTANTS:
            out.append({"name": _RMA_INSTANTS[ev], "ph": "i", "s": "t",
                        "pid": rank, "tid": LANE_RMA, "ts": ts,
                        "args": {"peer": a0, "bytes": a1}})
        elif ev in _RMA_BEGINS:
            out.append({"name": _RMA_BEGINS[ev], "ph": "B", "pid": rank,
                        "tid": LANE_RMA, "ts": ts, "args": {"peer": a0}})
        elif ev in _RMA_ENDS:
            out.append({"name": _RMA_ENDS[ev], "ph": "E", "pid": rank,
                        "tid": LANE_RMA, "ts": ts})
    return out


SPAN_TID_BASE = 1 << 20     # span lanes: tid SPAN_TID_BASE + k


def span_events(dump: dict) -> list[dict]:
    """One rank's spans as Chrome trace events in lanes of their own
    (tid ``SPAN_TID_BASE + k``), after the ring's lanes: each span a
    slice, packed into as few lanes as keep every lane's slices nested
    (a child in its parent's lane where it fits); instants (the staged
    path's acks) in the first lane; a span still open is left out."""
    rank = int(dump["rank"])
    rows = dump.get("spans") or []
    out: list[dict] = []
    lanes: list[list[int]] = []          # per lane: ends of open slices
    order = sorted(range(len(rows)),
                   key=lambda i: (rows[i][1], -rows[i][2]))
    for i in order:
        name, t0, t1, parent, comm, src, dst, seq, nb, yi, ti, path = rows[i]
        if not t1:
            continue
        args = {"span": i, "parent": parent, "comm": comm, "seq": seq}
        if src >= 0:
            args.update(src=src, dst=dst)
        if nb:
            args["bytes"] = nb
        if yi or ti:
            args.update(yields=yi, ticks=ti)
        if path:
            args["path"] = path
        if t1 == t0:
            if not lanes:
                lanes.append([])
            out.append({"name": name, "ph": "i", "s": "t", "pid": rank,
                        "tid": SPAN_TID_BASE, "ts": t0 / 1000.0,
                        "args": args})
            continue
        for lane, stack in enumerate(lanes):
            while stack and stack[-1] <= t0:
                stack.pop()
            if not stack or stack[-1] >= t1:
                break
        else:
            lane = len(lanes)
            lanes.append([])
        lanes[lane].append(t1)
        out.append({"name": name, "ph": "X", "pid": rank,
                    "tid": SPAN_TID_BASE + lane, "ts": t0 / 1000.0,
                    "dur": (t1 - t0) / 1000.0, "args": args})
    meta = [_meta(rank, SPAN_TID_BASE + k, f"spans {k}")
            for k in range(len(lanes))]
    return meta + out


def load_dump(path) -> dict:
    return json.loads(Path(path).read_text())


def merge_dumps(dumps: list[dict]) -> dict:
    """Stitch per-rank dumps into one Perfetto-loadable trace object:
    each rank's ring lanes, then its span lanes."""
    events: list[dict] = []
    for d in sorted(dumps, key=lambda d: int(d.get("rank", 0))):
        events.extend(chrome_events(d))
        events.extend(span_events(d))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def summarize_dumps(dumps: list[dict], top: int = 10) -> str:
    """Text top-N summary across ranks: event counts + histogram
    percentiles, for terminals without a trace viewer."""
    total: dict[str, int] = {}
    lines = []
    for d in sorted(dumps, key=lambda d: int(d.get("rank", 0))):
        rep = d.get("report", {})
        for name, n in rep.get("counters", {}).items():
            total[name] = total.get(name, 0) + n
        lines.append(f"rank {d.get('rank', '?')}: "
                     f"{rep.get('events_recorded', 0)} events recorded, "
                     f"{rep.get('events_kept', 0)} kept")
        for hname, h in rep.get("histograms", {}).items():
            if h.get("count"):
                lines.append(
                    f"  {hname}: n={h['count']} avg={h['avg_ns']}ns "
                    f"p50<={h['p50_ns']}ns p99<={h['p99_ns']}ns")
    lines.append(f"top {top} events across {len(dumps)} rank(s):")
    width = max((len(n) for n in total), default=1)
    for name, n in sorted(total.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {name:<{width}}  {n}")
    return "\n".join(lines)
