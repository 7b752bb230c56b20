"""The program's own spans in a traced benchmark run, and what they read.

The benchmark (``cmpibench/``) leaves the program's tracer off. The
context manager ``recording()`` runs a cell's ranks through
``traced_rank_main`` instead, which, in a traced run only, turns each
rank's tracer on in the benchmark's ``Window.open`` and off in its
``close``. The rank's report then holds ``program_spans`` (rows of
``FIELDS``) and ``program_counters`` (the tracer's ``span_counters``;
kept as ``span_counters`` too, since the hybrid serve loop puts counters
of its own in ``program_counters``), on the window's reading of the
epoch clock, and the rank's ``spans`` gain the program's spans as
innermost segments, so that the harness labels the card's idle gaps by
the program's work. A message's spans carry its id ``(comm, src, dst,
seq)`` on both ranks, a collective call's ``(comm, seq)`` on each
member.

``READINGS`` holds what the spans read, by name; each returns None
where a run has nothing to read. ``tools/span_report.py`` prints them.
"""
from __future__ import annotations

import contextlib
import heapq
import importlib
from collections import defaultdict

from cmpibench import readings, yardstick

FIELDS = ("name", "start_ns", "end_ns", "parent", "comm", "src", "dst",
          "seq", "bytes", "yields", "ticks", "path")
(NAME, T0, T1, PARENT, COMM, SRC, DST, SEQ, BYTES, YIELDS, TICKS,
 PATH) = range(len(FIELDS))


# --------------------------------------------------------------------------
# recording
# --------------------------------------------------------------------------

@contextlib.contextmanager
def recording():
    """Inside it, every ``harness.run_cell`` runs its ranks through
    ``traced_rank_main``."""
    from cmpibench import harness
    run_ranks = harness.run_ranks

    def redirected(size, target, spec, **kw):
        return run_ranks(size, f"{__name__}:traced_rank_main",
                         dict(spec, span_target=target), **kw)

    harness.run_ranks = redirected
    try:
        yield
    finally:
        harness.run_ranks = run_ranks


def traced_rank_main(env, spec: dict) -> dict:
    """The cell's own rank program, under a ``Window`` that records the
    program's spans where the run is traced."""
    mod, fn = spec["span_target"].rsplit(":", 1)
    if spec["trace"]:
        _patch_window()
    return getattr(importlib.import_module(mod), fn)(env, spec)


def _patch_window() -> None:
    from cmpibench.systems import Window
    if getattr(Window, "records_program_spans", False):
        return
    open_, close = Window.open, Window.close

    def opened(self):
        # on before the window's barrier, so both ranks' message and
        # call counts start from the same point of the program
        self.ptrace = self.env.comm.tracer
        self.ptrace.start()
        open_(self)

    def closed(self):
        close(self)
        tr = self.ptrace
        tr.stop()
        # on this window's reading of the epoch clock, as the benchmark's
        # own spans are: a span of the program then starts after the
        # benchmark's span around its call
        shift = self.t0_ns - round(self.t0 * 1e9) - tr.epoch_offset_ns
        rows = rebase(tr.span_rows(), shift)
        self.rep.update(program_spans=rows, program_clock_shift_ns=shift,
                        program_counters=tr.span_counters(),
                        span_counters=tr.span_counters())
        self.spans.items += innermost(rows)

    Window.open, Window.close = opened, closed
    Window.records_program_spans = True


def rebase(rows, shift: int) -> list[tuple]:
    """``rows`` with every time ``shift`` ns later (an open span's end
    stays 0)."""
    return [(r[NAME], r[T0] + shift, r[T1] + shift if r[T1] else 0)
            + tuple(r[PARENT:]) for r in rows]


def innermost(rows) -> list[tuple[str, int, int]]:
    """One rank's spans as ``(name, start_ns, end_ns)`` segments that do
    not overlap: each instant under its innermost span, the one opened
    last of those open then (the rule by which the harness labels an
    idle gap). The harness looks back a bounded number of spans for one
    that covers a gap's midpoint, which thousands of small spans inside
    one long one would defeat; segments need no look-back."""
    bounds = []
    for i, r in enumerate(rows):
        if r[T1] > r[T0]:
            bounds += [(r[T0], 1, i), (r[T1], 0, i)]
    bounds.sort()
    heap: list = []                 # (-start, -index) of the open spans
    closed: set = set()
    out: list = []
    last = 0
    for t, opens, i in bounds:
        while heap and -heap[0][1] in closed:
            heapq.heappop(heap)
        if heap and t > last:
            name = rows[-heap[0][1]][NAME]
            if out and out[-1][0] == name and out[-1][2] == last:
                out[-1] = (name, out[-1][1], t)
            else:
                out.append((name, last, t))
        last = t
        if opens:
            heapq.heappush(heap, (-rows[i][T0], -i))
        else:
            closed.add(i)
    return out


# --------------------------------------------------------------------------
# joining the ranks' spans
# --------------------------------------------------------------------------

def traced(run: dict) -> bool:
    """Whether every rank's report has the program's spans."""
    return bool(run["reports"]) and all(
        "program_spans" in r for r in run["reports"])


def window(report: dict) -> tuple[int, int]:
    lo = report["t0_ns"]
    return lo, lo + int(report["seconds"] * 1e9)


def in_window(report: dict, row) -> bool:
    lo, hi = window(report)
    return lo <= row[T0] <= hi


def messages(run: dict) -> dict:
    """Every message of the window by id: ``{id: {"send": row, "recv":
    row, "wait": row, "deliver": row, "ack_seen": row}}``, each from the
    rank that recorded it (the sender's send and ack_seen, the
    receiver's receive); a message whose send started in the sender's
    window, closed spans only."""
    out: dict = defaultdict(dict)
    keep = set()
    for r in run["reports"]:
        for row in r["program_spans"]:
            name = row[NAME]
            if not name.startswith("pt2pt.") or row[SEQ] < 0:
                continue
            kind = name[6:]
            if kind not in ("send", "recv", "wait", "deliver", "ack_seen"):
                continue
            if kind != "ack_seen" and not row[T1]:
                continue
            key = (row[COMM], row[SRC], row[DST], row[SEQ])
            out[key][kind] = row
            if kind == "send" and in_window(r, row):
                keep.add(key)
    return {k: v for k, v in out.items() if k in keep}


def median_us(values) -> float | None:
    values = list(values)
    if not values:
        return None
    return yardstick.percentile(values, 50) / 1e3


def descendants(rows, roots: set) -> dict:
    """``{root: [rows under it]}`` for the span indices ``roots`` of one
    rank's rows (each row's index is its position)."""
    top: dict = {}
    out: dict = defaultdict(list)
    for i, row in enumerate(rows):
        p = row[PARENT]
        if i in roots:
            top[i] = i
        elif p in top:
            top[i] = top[p]
            out[top[p]].append(row)
    return out


def calls(run: dict) -> dict:
    """Every collective call of the window by id ``(comm, seq)``: the
    rows of its members (one a rank), closed spans only; a call whose
    earliest entry lies in rank 0's window."""
    out: dict = defaultdict(list)
    for r in run["reports"]:
        for row in r["program_spans"]:
            if row[NAME].startswith("coll.") and row[T1] and row[SEQ] >= 0:
                out[(row[COMM], row[SEQ])].append(row)
    lo, hi = window(run["reports"][0])
    return {k: v for k, v in out.items()
            if lo <= min(x[T0] for x in v) <= hi}


# --------------------------------------------------------------------------
# readings
# --------------------------------------------------------------------------

def hop_send_us(run: dict):
    """Median, over the window's messages of both directions, of the
    sender's ``pt2pt.send``: ``isend`` entry to the message's last part
    committed to the pair queue, in microseconds."""
    if not traced(run):
        return None
    return median_us(v["send"][T1] - v["send"][T0]
                     for v in messages(run).values())


def hop_wake_us(run: dict):
    """Median, by message id, of the receiver's first dequeue less the
    sender's commit (the end of its ``pt2pt.send``): how long the
    receiver's polling loop takes to see a message once it is queued."""
    if not traced(run):
        return None
    return median_us(v["deliver"][T0] - v["send"][T1]
                     for v in messages(run).values() if "deliver" in v)


def hop_recv_us(run: dict):
    """Median of the receiver's ``pt2pt.deliver``: the first dequeue of
    the message's first part to the receive's completion (the device
    copy and its sync included)."""
    if not traced(run):
        return None
    return median_us(v["deliver"][T1] - v["deliver"][T0]
                     for v in messages(run).values() if "deliver" in v)


def sync_us_per_msg(run: dict):
    """Microseconds the core spent inside
    ``torch.cuda.current_stream().synchronize()`` (its counter, both
    ranks, the traced window) over the messages received (a cell that
    counts them)."""
    if not traced(run) or any("messages_received" not in r
                              for r in run["reports"]):
        return None
    n = readings.messages(run)
    ns = sum(r["program_counters"]["sync_ns"] for r in run["reports"])
    return ns / 1e3 / n if n else None


def rndv_copy_share(run: dict):
    """Per cent of the staged messages' lives spent inside their own
    device copies: a life runs from the sender's ``isend`` entry to the
    sender seeing the receiver's ack; the copies are the ``pool.copy``
    spans under the message's spans on either rank, merged and clipped
    to the life. Summed over the window's staged messages."""
    if not traced(run):
        return None
    msgs = {k: v for k, v in messages(run).items()
            if "ack_seen" in v and "send" in v}
    if not msgs:
        return None
    copies: dict = defaultdict(list)       # message id -> copy intervals
    for r in run["reports"]:
        rows = r["program_spans"]
        roots = {}
        for i, row in enumerate(rows):
            key = (row[COMM], row[SRC], row[DST], row[SEQ])
            if key in msgs and row[NAME] in ("pt2pt.send", "pt2pt.recv"):
                roots[i] = key
        for root, under in descendants(rows, set(roots)).items():
            copies[roots[root]] += [(x[T0], x[T1]) for x in under
                                    if x[NAME] == "pool.copy" and x[T1]]
    life = inside = 0
    for key, v in msgs.items():
        a, b = v["send"][T0], v["ack_seen"][T0]
        if b <= a:
            continue
        life += b - a
        inside += yardstick.covered(yardstick.clip(copies[key], a, b))
    return 100.0 * inside / life if life else None


def coll_peer_wait_share(run: dict):
    """Per cent of the collectives' time that their members spent
    waiting for the last of them to enter: over every call of the
    window joined across its ranks by id, each member's span before the
    call's last entry, summed, over the members' spans, summed."""
    if not traced(run):
        return None
    wait = total = 0
    for rows in calls(run).values():
        if len(rows) < 2:
            continue
        last = max(x[T0] for x in rows)
        for x in rows:
            total += x[T1] - x[T0]
            wait += max(0, min(last, x[T1]) - x[T0])
    return 100.0 * wait / total if total else None


READINGS = {f.__name__: f for f in (
    hop_send_us, hop_wake_us, hop_recv_us, sync_us_per_msg,
    rndv_copy_share, coll_peer_wait_share)}
