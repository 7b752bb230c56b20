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
host, so per-rank dumps from a multi-process run merge into a single
coherent timeline without clock alignment.

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
  lifecycle as instants; RMA fence/flush/wait as nested B/E slices.
* ``summarize_dumps(dumps)`` — text top-N event summary + histogram
  percentiles.
* ``python -m repro.trace merge|summarize`` — stitch per-rank dump
  files from a multi-process run (see ``repro/trace.py``).

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
    "summarize_dumps", "load_dump", "EV_NAMES",
]

_REC_WORDS = 5
DEFAULT_CAPACITY = 1 << 15          # 32768 records x 40 B = 1.25 MiB

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
                 enabled: bool = True):
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
        }
        if stats is not None:
            out["protocol_stats"] = stats.snapshot()
        return out

    def dump(self, path, stats=None) -> str:
        """Write this rank's ring + report as a JSON dump file that
        ``python -m repro.trace merge`` can stitch with its peers."""
        d = {
            "schema": 1,
            "rank": self.rank,
            "strings": {str(k): v for k, v in self._names.items()},
            "events": [list(e) for e in self.events()],
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


def load_dump(path) -> dict:
    return json.loads(Path(path).read_text())


def merge_dumps(dumps: list[dict]) -> dict:
    """Stitch per-rank dumps into one Perfetto-loadable trace object."""
    events: list[dict] = []
    for d in sorted(dumps, key=lambda d: int(d.get("rank", 0))):
        events.extend(chrome_events(d))
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
