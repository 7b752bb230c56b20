"""Software cache coherence (paper §3.5) as an explicit, testable protocol.

The CXL pooled platform is NOT hardware-coherent across hosts. The paper's
protocol:

  after every write :  cache flush (clwb/clflushopt)  then  sfence
  before every read :  fence                          then  flush/invalidate

plus non-temporal load/store for control words (queue head/tail pointers,
sync flags) so they never linger in cache.

``CoherentView`` wraps a pool and applies that protocol. Three modes:

  * "coherent"    — backing pool is already coherent (LocalPool shared by
                    threads, SharedMemoryPool across processes on one x86
                    host). Protocol calls are COUNTED (for the timing model,
                    calibrated to Fig 11) but are memory no-ops.
  * "incoherent"  — backing pool is an IncoherentPool (per-rank write-back
                    cache). The protocol is REQUIRED for correctness; tests
                    prove omitting it produces stale reads.
  * "uncacheable" — every access bypasses the cache (the paper's MTRR
                    experiment). Correct, counted as uncached accesses, and
                    shown by the perf model to be catastrophically slow
                    beyond 2 KB (PCIe MPS packetization, Fig 11).

The latency model attached to these counters lives in
``repro.perfmodel.interconnects`` — this module only counts events.

``ProtocolStats`` additionally counts DATA COPIES: every byte that moves
through the protocol layer (user buffer -> pool, pool -> user buffer, or
an explicit staging memcpy reported via ``count_copy``). This includes
framing — cell/message headers, rendezvous descriptors — and any arena
metadata traffic issued through the same view; only non-temporal control
words (nt_ops) are excluded. Copies-per-message is the paper's
performance model for CXL messaging, and the eager-vs-rendezvous
benchmark (benchmarks/fig5_8_osu.py) reports the per-message delta.

Device payloads (CUDA tensors) cross the same protocol: their bytes move
between the tensor and the pool's device window through the ``cellcopy``
kernel, and the stream is synchronised before the call returns — the
port's "flush; sfence", so no control word is published before the
payload has landed. The counters are bumped exactly as for a host part.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.pool import (CACHELINE, IncoherentPool, Pool, as_u8,
                                   device_sync, is_device)
from repro_torch.core.trace import NULL_TRACER, SP_COPY

MODES = ("coherent", "incoherent", "uncacheable")


@dataclass
class ProtocolStats:
    writes: int = 0
    reads: int = 0
    written_bytes: int = 0
    read_bytes: int = 0
    flush_lines: int = 0
    fences: int = 0
    nt_ops: int = 0             # non-temporal control-word accesses
    uncached_ops: int = 0
    # every physical data move through the view: payload AND framing/
    # metadata bytes (headers, descriptors, arena slots); nt control
    # words are counted separately as nt_ops
    copies: int = 0
    copied_bytes: int = 0
    # attribution overlay: PAYLOAD bytes of the copies above, broken down
    # by the pt2pt data-plane path that moved them (the messaging layers
    # report via count_path). Not additive to copied_bytes — framing,
    # descriptors and arena metadata stay unattributed.
    path_copied_bytes: dict = field(default_factory=lambda: {
        "eager": 0, "rndv_staged": 0, "rndv_posted": 0,
        # one-sided (RMA) data-plane paths: direct window stores/loads
        # (put/get/rput/rget/accumulate), the notified-put fast path
        # (put_notify — zero receiver-side copies by construction), and
        # the schedule-compiled RMA collectives (PutOp/GetOp nodes)
        "rma_put": 0, "rma_get": 0, "rma_notify": 0, "rma_coll": 0})
    # postable receives whose matchbox posting was still waiting in the
    # per-pair OVERFLOW list when a fallback (eager/staged/parked)
    # delivery completed them — i.e. capacity cost the receive its
    # one-copy path. Postings that spill but get PROMOTED before their
    # payload arrives are not misses (chunked pre-post bursts through
    # shallow strips legitimately measure 0): a non-zero count says the
    # strips are too shallow for the posting pattern in flight. This is
    # a RECEIVER-side signal; a sender that raced past a not-yet-
    # promoted entry and fell back to staged shows up in the sender's
    # ``posted_sends``/``rndv_sends`` hit ratio instead (the complement
    # the benchmarks gate on) — read both when sizing
    # ``Communicator(matchbox_slots=...)``.
    mb_capacity_misses: int = 0
    # SENDER-side matchbox cost: every strip slot a ``_mb_claim`` call
    # probed (fast-path single-slot probes and full scans alike). A
    # chunked send stream through an N-slot strip that keeps rescanning
    # costs ~N slots per chunk; the claim cursor drops that toward 1 —
    # this counter is the proof (tests/test_tuning.py gates the ratio).
    mb_slots_scanned: int = 0

    def lines(self, n: int) -> int:
        return (n + CACHELINE - 1) // CACHELINE

    def snapshot(self) -> dict:
        """Deep-copied point-in-time view of every counter. Pair with
        :meth:`delta` so benchmarks and tests stop hand-diffing fields::

            s0 = view.stats.snapshot()
            ... traffic ...
            d = view.stats.delta(s0)      # {"copied_bytes": ..., ...}
        """
        out = dict(self.__dict__)
        out["path_copied_bytes"] = dict(self.path_copied_bytes)
        return out

    def delta(self, prev: dict) -> dict:
        """Counter-wise difference of the current stats against a prior
        :meth:`snapshot`. ``path_copied_bytes`` is diffed per path and
        keeps only the paths that moved; scalar counters absent from
        ``prev`` (an older snapshot) diff against zero."""
        out = {}
        for k, v in self.snapshot().items():
            if k == "path_copied_bytes":
                pv = prev.get(k, {})
                out[k] = {p: n - pv.get(p, 0) for p, n in v.items()
                          if n - pv.get(p, 0)}
            else:
                out[k] = v - prev.get(k, 0)
        return out


class CoherentView:
    """Protocol-applying accessor for one rank over one pool."""

    def __init__(self, pool: Pool, mode: str = "coherent"):
        assert mode in MODES, mode
        self.pool = pool
        self.mode = mode
        self.stats = ProtocolStats()
        self._inc = isinstance(pool, IncoherentPool)
        # the rank's tracer: the first communicator over this view's
        # arena sets it (its split/dup children share it)
        self.tracer = NULL_TRACER
        if mode == "incoherent" and not self._inc:
            raise ValueError("incoherent mode requires an IncoherentPool")

    # ------------------------------------------------------------------
    # raw (protocol-free) access — used by tests to demonstrate staleness
    # ------------------------------------------------------------------
    def raw_read(self, off: int, n: int) -> bytes:
        return self.pool.read(off, n)

    def raw_write(self, off: int, data: bytes) -> None:
        self.pool.write(off, data)

    # ------------------------------------------------------------------
    # protocol access
    # ------------------------------------------------------------------
    def count_copy(self, nbytes: int, k: int = 1) -> None:
        """Report ``k`` payload copies of ``nbytes`` each that happened
        outside the view (staging memcpys in the messaging layers)."""
        self.stats.copies += k
        self.stats.copied_bytes += k * nbytes

    def count_path(self, path: str, nbytes: int) -> None:
        """Attribute ``nbytes`` of already-counted payload movement to a
        data-plane path: pt2pt (eager / rndv_staged / rndv_posted),
        one-sided (rma_put / rma_get / rma_notify / rma_coll), or any
        new subsystem's bucket — unknown paths upsert (defaultdict
        style), so e.g. a future serving tier can count ``serve_*``
        buckets without editing this file. The core buckets stay
        pre-declared in ``ProtocolStats`` so zero-traffic paths still
        report 0."""
        pc = self.stats.path_copied_bytes
        pc[path] = pc.get(path, 0) + nbytes

    def count_mb_miss(self) -> None:
        """Report a matchbox capacity miss: a postable receive's spilled
        posting never reached the strip before a fallback delivery
        completed it (the strips are too shallow for the pattern)."""
        self.stats.mb_capacity_misses += 1

    def write_release(self, off: int, data) -> None:
        """store; flush; sfence — makes the write globally visible.
        ``data`` is any C-contiguous buffer-protocol object (bytes,
        memoryview slice, numpy array) — moved into the pool exactly
        once. Single-part case of ``write_release_gather``."""
        self.write_release_gather(off, (data,))

    def write_release_gather(self, off: int, parts) -> int:
        """Scatter-gather write_release: store each part back-to-back
        from ``off``, then ONE flush + fence over the whole span —
        exactly how a queue cell is filled on hardware (stores, clwb the
        span, one sfence). Counts one copy per non-empty part. Returns
        total bytes written."""
        views = [as_u8(p) for p in parts]
        n = sum(len(v) for v in views)
        self.stats.writes += 1
        self.stats.written_bytes += n
        self.stats.copies += sum(1 for v in views if len(v))
        self.stats.copied_bytes += n
        o = off
        dev = False
        cp = -1
        for v in views:
            if len(v):
                if is_device(v):
                    tr = self.tracer
                    if tr.enabled and not dev:
                        cp = tr.open_child(SP_COPY, tr.cur, n)
                    self.pool.write_device(o, v)
                    dev = True
                else:
                    self.pool.write(o, v)
                o += len(v)
        if dev:
            device_sync(self.tracer, cp)
        if self.mode == "uncacheable":
            self.stats.uncached_ops += self.stats.lines(n)
            return n
        if self._inc:
            self.pool.flush(off, n)
            self.pool.fence()
        self.stats.flush_lines += self.stats.lines(n)
        self.stats.fences += 1
        return n

    def read_acquire(self, off: int, n: int) -> bytes:
        """lfence; invalidate; load — defeats stale cached/prefetched data."""
        self.stats.reads += 1
        self.stats.read_bytes += n
        self.stats.copies += 1
        self.stats.copied_bytes += n
        if self.mode == "uncacheable":
            self.stats.uncached_ops += self.stats.lines(n)
            return self.pool.read(off, n)
        if self._inc:
            self.pool.fence()
            self.pool.invalidate(off, n)  # drop stale lines
        self.stats.flush_lines += self.stats.lines(n)
        self.stats.fences += 1
        return self.pool.read(off, n)

    def read_acquire_into(self, off: int, dst) -> int:
        """lfence; invalidate; load straight into the caller's writable
        buffer — the pool-to-destination move happens exactly once, with
        no intermediate ``bytes``. Returns bytes read (= len(dst))."""
        d = as_u8(dst)
        n = len(d)
        self.stats.reads += 1
        self.stats.read_bytes += n
        self.stats.copies += 1
        self.stats.copied_bytes += n
        if self.mode == "uncacheable":
            self.stats.uncached_ops += self.stats.lines(n)
            return self._load_into(off, d)
        if self._inc:
            self.pool.fence()
            self.pool.invalidate(off, n)
        self.stats.flush_lines += self.stats.lines(n)
        self.stats.fences += 1
        return self._load_into(off, d)

    def _load_into(self, off: int, d) -> int:
        if not is_device(d):
            return self.pool.readinto(off, d)
        tr = self.tracer
        cp = -1
        if tr.enabled:
            cp = tr.open_child(SP_COPY, tr.cur, len(d))
        n = self.pool.read_device(off, d)
        device_sync(tr, cp)
        return n

    # ------------------------------------------------------------------
    # non-temporal control words (u64 head/tail pointers, flags)
    # ------------------------------------------------------------------
    def nt_store_u64(self, off: int, value: int) -> None:
        self.stats.nt_ops += 1
        data = int(value).to_bytes(8, "little")
        if self._inc:
            # non-temporal: write straight to the pool, bypassing the cache,
            # and kill any stale private copy of that line.
            self.pool.backing.write(off, data)
            self.pool.invalidate(off, 8)
        else:
            self.pool.write(off, data)

    def nt_load_u64(self, off: int) -> int:
        self.stats.nt_ops += 1
        if self._inc:
            self.pool.invalidate(off, 8)
            data = self.pool.backing.read(off, 8)
        else:
            data = self.pool.read(off, 8)
        return int.from_bytes(data, "little")

    def nt_store_u8(self, off: int, value: int) -> None:
        self.stats.nt_ops += 1
        data = bytes([value & 0xFF])
        if self._inc:
            self.pool.backing.write(off, data)
            self.pool.invalidate(off, 1)
        else:
            self.pool.write(off, data)

    def nt_load_u8(self, off: int) -> int:
        self.stats.nt_ops += 1
        if self._inc:
            self.pool.invalidate(off, 1)
            return self.pool.backing.read(off, 1)[0]
        return self.pool.read(off, 1)[0]

    def nt_store_u32(self, off: int, value: int) -> None:
        self.stats.nt_ops += 1
        data = int(value).to_bytes(4, "little")
        if self._inc:
            self.pool.backing.write(off, data)
            self.pool.invalidate(off, 4)
        else:
            self.pool.write(off, data)

    def nt_load_u32(self, off: int) -> int:
        self.stats.nt_ops += 1
        if self._inc:
            self.pool.invalidate(off, 4)
            data = self.pool.backing.read(off, 4)
        else:
            data = self.pool.read(off, 4)
        return int.from_bytes(data, "little")
