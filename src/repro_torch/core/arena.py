"""CXL SHM Arena (paper §3.1): named shared-memory objects over a flat pool.

The dax device gives a flat byte range — no files, no lifecycle. The Arena
adds POSIX-SHM-like named objects without kernel support:

  [ header | bakery lock | free list | metadata (multi-level hash) | heap ]

* metadata is a FIXED-CAPACITY multi-level hash table: ``n_levels`` levels
  whose capacities are consecutive descending primes below ``base_slots``
  (the paper's production config: 10 levels under 200,000 -> 199,999 ...
  199,873, 1,999,260 slots total). A key probes exactly ONE slot per level
  (hash salted by level), so lookup is O(levels), parallelizable across
  levels, and there is no resizing and no probe chains — deleting a slot
  never breaks other keys' probes.
* the heap is a bump allocator with a bounded first-fit free list whose
  frees coalesce: a freed block merges with the free blocks that touch
  it, and one that then ends at the bump pointer lowers it, so the list
  holds about one entry per hole between live objects; every object is
  cacheline(64B)-aligned (paper §3.7: alignment makes the flush protocol
  and non-temporal accesses exact).
* creation/destruction are serialized by a Lamport BAKERY lock
  (``sync.BakeryLock``) in the pool itself — mutual exclusion with only
  per-rank single-writer slots, because CXL pooled memory provides no
  cross-host atomic RMW (paper §3.5). Lookup (open) is lock-free.

All accesses go through ``CoherentView`` so the same code is correct on an
incoherent pool (write_release / read_acquire / non-temporal control words).

APIs mirror the paper's Table 2: create / open / destroy / close /
init / finalize.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.coherence import CoherentView
from repro_torch.core.pool import CACHELINE, Pool
from repro_torch.core.sync import BakeryLock

MAGIC = b"CXLARENA"
VERSION = 1
SLOT_SIZE = 64
NAME_MAX = 47
MAX_RANKS = 64

_HDR_SIZE = 128
# the bakery: choosing u8[MAX_RANKS], then number u64[MAX_RANKS]
_BAKERY_CHOOSING = _HDR_SIZE
_BAKERY_END = _BAKERY_CHOOSING + BakeryLock.region_bytes(MAX_RANKS)

# header fields (absolute offsets)
_H_MAGIC = 0
_H_VERSION = 8
_H_NLEVELS = 12
_H_BASESLOTS = 16
_H_HEAP_OFF = 20
_H_HEAP_CUR = 28
_H_POOL_SIZE = 36
_H_FREELIST_CAP = 44
_H_FREELIST_LEN = 48
_H_FREELIST_OFF = 52
_H_META_OFF = 60


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n % 2 == 0:
        return n == 2
    i = 3
    while i * i <= n:
        if n % i == 0:
            return False
        i += 2
    return True


def level_capacities(base_slots: int, n_levels: int) -> list[int]:
    """The ``n_levels`` largest primes <= base_slots, descending."""
    caps = []
    p = base_slots
    while len(caps) < n_levels and p >= 2:
        if _is_prime(p):
            caps.append(p)
        p -= 1
    if len(caps) < n_levels:
        raise ValueError(f"cannot find {n_levels} primes <= {base_slots}")
    return caps


def _hash_name(name: bytes, level: int) -> int:
    """Deterministic cross-process hash, salted per level (FNV-1a 64)."""
    h = 0xCBF29CE484222325 ^ (0x9E3779B97F4A7C15 * (level + 1)
                              & 0xFFFFFFFFFFFFFFFF)
    for b in name:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclass
class ObjHandle:
    name: str
    offset: int      # absolute offset of the object data in the pool
    size: int
    slot_off: int    # absolute offset of the metadata slot
    closed: bool = False


class ArenaFullError(RuntimeError):
    pass


class Arena:
    """One rank's mapping of the shared arena."""

    def __init__(self, pool: Pool, rank: int = 0, *, mode: str = "coherent",
                 n_levels: int = 10, base_slots: int = 251,
                 freelist_cap: int = 256, initialize: bool | None = None):
        if rank >= MAX_RANKS:
            raise ValueError(f"rank {rank} >= MAX_RANKS {MAX_RANKS}")
        self.pool = pool
        self.rank = rank
        self.view = CoherentView(pool, mode)
        v = self.view
        # creation/destruction lock (no timeout: a create waits its turn)
        self._bakery = BakeryLock(v, _BAKERY_CHOOSING, MAX_RANKS, rank)
        magic = v.read_acquire(_H_MAGIC, 8)
        if initialize is None:
            initialize = magic != MAGIC
        if initialize:
            caps = level_capacities(base_slots, n_levels)
            meta_off = _BAKERY_END + 16 * freelist_cap
            meta_off += (-meta_off) % CACHELINE
            meta_size = sum(caps) * SLOT_SIZE
            heap_off = meta_off + meta_size
            heap_off += (-heap_off) % CACHELINE
            if heap_off >= pool.size:
                raise ValueError(
                    f"pool of {pool.size}B too small: metadata alone needs "
                    f"{heap_off}B (base_slots={base_slots} x {n_levels} "
                    f"levels)")
            # zero bakery + freelist region
            v.write_release(_BAKERY_CHOOSING,
                            bytes(_BAKERY_END + 16 * freelist_cap
                                  - _BAKERY_CHOOSING))
            # zero the 'used' byte of every slot — pre-publication init,
            # no peer can observe the region yet
            for off in range(meta_off, meta_off + meta_size, SLOT_SIZE):
                v.raw_write(off, b"\x00")  # lint: raw-ok (init)
            hdr = bytearray(_HDR_SIZE)
            hdr[_H_VERSION:_H_VERSION + 4] = VERSION.to_bytes(4, "little")
            hdr[_H_NLEVELS:_H_NLEVELS + 4] = n_levels.to_bytes(4, "little")
            hdr[_H_BASESLOTS:_H_BASESLOTS + 4] = base_slots.to_bytes(4, "little")
            hdr[_H_HEAP_OFF:_H_HEAP_OFF + 8] = heap_off.to_bytes(8, "little")
            hdr[_H_HEAP_CUR:_H_HEAP_CUR + 8] = heap_off.to_bytes(8, "little")
            hdr[_H_POOL_SIZE:_H_POOL_SIZE + 8] = pool.size.to_bytes(8, "little")
            hdr[_H_FREELIST_CAP:_H_FREELIST_CAP + 4] = \
                freelist_cap.to_bytes(4, "little")
            hdr[_H_FREELIST_OFF:_H_FREELIST_OFF + 8] = \
                _BAKERY_END.to_bytes(8, "little")
            hdr[_H_META_OFF:_H_META_OFF + 8] = meta_off.to_bytes(8, "little")
            v.write_release(8, bytes(hdr[8:]))
            v.write_release(_H_MAGIC, MAGIC)   # magic last: publication
        else:
            hdr = bytearray(v.read_acquire(0, _HDR_SIZE))
            if bytes(hdr[:8]) != MAGIC:
                raise RuntimeError("arena not initialized")
            n_levels = int.from_bytes(hdr[_H_NLEVELS:_H_NLEVELS + 4], "little")
            base_slots = int.from_bytes(hdr[_H_BASESLOTS:_H_BASESLOTS + 4],
                                        "little")
            freelist_cap = int.from_bytes(
                hdr[_H_FREELIST_CAP:_H_FREELIST_CAP + 4], "little")
            caps = level_capacities(base_slots, n_levels)
        self.n_levels = n_levels
        self.base_slots = base_slots
        self.caps = caps
        self.freelist_cap = freelist_cap
        self.freelist_off = _BAKERY_END
        self.meta_off = int.from_bytes(
            v.read_acquire(_H_META_OFF, 8), "little")
        self.heap_off = int.from_bytes(
            v.read_acquire(_H_HEAP_OFF, 8), "little")
        # level start offsets
        self.level_off = []
        o = self.meta_off
        for c in caps:
            self.level_off.append(o)
            o += c * SLOT_SIZE

    # ------------------------------------------------------------------
    # slots
    # ------------------------------------------------------------------
    def _slot_off(self, name: bytes, level: int) -> int:
        idx = _hash_name(name, level) % self.caps[level]
        return self.level_off[level] + idx * SLOT_SIZE

    def _read_slot(self, off: int) -> tuple[int, bytes, int, int]:
        raw = self.view.read_acquire(off, SLOT_SIZE)
        used = raw[0]
        name = bytes(raw[1:1 + NAME_MAX]).rstrip(b"\x00")
        offset = int.from_bytes(raw[48:56], "little")
        size = int.from_bytes(raw[56:64], "little")
        return used, name, offset, size

    def _write_slot(self, off: int, name: bytes, offset: int,
                    size: int) -> None:
        raw = bytearray(SLOT_SIZE)
        raw[0] = 1
        raw[1:1 + len(name)] = name
        raw[48:56] = offset.to_bytes(8, "little")
        raw[56:64] = size.to_bytes(8, "little")
        self.view.write_release(off, bytes(raw))

    def _find(self, name: bytes) -> tuple[int, int, int] | None:
        """-> (slot_off, offset, size) or None. Probes one slot per level."""
        for lvl in range(self.n_levels):
            so = self._slot_off(name, lvl)
            used, sname, offset, size = self._read_slot(so)
            if used and sname == name:
                return so, offset, size
        return None

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------
    def _freelist(self) -> list[tuple[int, int]]:
        n = self.view.nt_load_u32(_H_FREELIST_LEN)
        out = []
        for i in range(n):
            raw = self.view.read_acquire(self.freelist_off + 16 * i, 16)
            out.append((int.from_bytes(raw[:8], "little"),
                        int.from_bytes(raw[8:], "little")))
        return out

    def _freelist_write(self, entries: list[tuple[int, int]]) -> None:
        for i, (o, s) in enumerate(entries):
            self.view.write_release(
                self.freelist_off + 16 * i,
                o.to_bytes(8, "little") + s.to_bytes(8, "little"))
        self.view.nt_store_u32(_H_FREELIST_LEN, len(entries))

    def _alloc(self, size: int) -> int:
        size = size + (-size) % CACHELINE
        fl = self._freelist()
        tr = self.view.tracer
        if tr.enabled:
            tr.freelist_peak = max(tr.freelist_peak, len(fl))
        for i, (o, s) in enumerate(fl):
            if s >= size:                      # first fit
                rest = s - size
                if rest >= CACHELINE:
                    fl[i] = (o + size, rest)
                else:
                    fl.pop(i)
                self._freelist_write(fl)
                return o
        cur = self.view.nt_load_u64(_H_HEAP_CUR)
        if cur + size > self.pool.size:
            raise ArenaFullError(
                f"heap exhausted: need {size}B at {cur}, pool {self.pool.size}")
        self.view.nt_store_u64(_H_HEAP_CUR, cur + size)
        return cur

    def _free(self, offset: int, size: int) -> None:
        """Give a block back, merged with the free blocks that end at its
        start and start at its end. The list is unsorted and any rank
        (a reference one too) may have appended to it, so it is scanned
        whole; a merged block that ends at the bump pointer lowers it
        and keeps no entry. Each entry taken out of the list is filled
        by the last one."""
        size = size + (-size) % CACHELINE
        fl = self._freelist()
        seen = len(fl)
        end = offset + size
        lo = hi = -1
        for i, (o, s) in enumerate(fl):
            if o + s == offset:
                lo = i
            elif o == end:
                hi = i
        if lo >= 0:
            offset, size = fl[lo][0], size + fl[lo][1]
        if hi >= 0:
            size += fl[hi][1]
        for i in sorted((lo, hi), reverse=True):
            if i >= 0:
                last = fl.pop()
                if i < len(fl):
                    fl[i] = last
        merged = lo >= 0 or hi >= 0
        topped = offset + size == self.view.nt_load_u64(_H_HEAP_CUR)
        if topped:
            self.view.nt_store_u64(_H_HEAP_CUR, offset)
        elif len(fl) < self.freelist_cap:
            fl.append((offset, size))
        # else: leak (bounded metadata — the paper's arena never frees at all)
        if len(fl) != seen or merged:
            self._freelist_write(fl)
        tr = self.view.tracer
        if tr.enabled:
            tr.arena_frees += 1
            tr.arena_merged += merged or topped
            tr.freelist_peak = max(tr.freelist_peak, seen, len(fl))

    # ------------------------------------------------------------------
    # public API (paper Table 2)
    # ------------------------------------------------------------------
    def create(self, name: str, size: int) -> ObjHandle:
        nb = name.encode()
        if not 0 < len(nb) <= NAME_MAX:
            raise ValueError(f"name must be 1..{NAME_MAX} bytes")
        if size <= 0:
            raise ValueError("size must be positive")
        self._bakery.acquire(timeout=None)
        try:
            if self._find(nb) is not None:
                raise FileExistsError(f"object {name!r} exists")
            # claim the first free slot across levels
            for lvl in range(self.n_levels):
                so = self._slot_off(nb, lvl)
                used, _, _, _ = self._read_slot(so)
                if not used:
                    offset = self._alloc(size)
                    self._write_slot(so, nb, offset, size)
                    return ObjHandle(name, offset, size, so)
            raise ArenaFullError(
                f"all {self.n_levels} levels collide for {name!r}")
        finally:
            self._bakery.release()

    def open(self, name: str) -> ObjHandle:
        nb = name.encode()
        hit = self._find(nb)
        if hit is None:
            raise FileNotFoundError(f"object {name!r} not found")
        so, offset, size = hit
        return ObjHandle(name, offset, size, so)

    def destroy(self, handle: ObjHandle) -> None:
        self._bakery.acquire(timeout=None)
        try:
            hit = self._find(handle.name.encode())
            if hit is None:
                raise FileNotFoundError(handle.name)
            so, offset, size = hit
            self.view.write_release(so, b"\x00")   # used = 0
            self._free(offset, size)
            handle.closed = True
        finally:
            self._bakery.release()

    def close(self, handle: ObjHandle) -> None:
        handle.closed = True      # local bookkeeping only (paper semantics)

    def finalize(self) -> None:
        pass

    # ------------------------------------------------------------------
    # data access through the coherence protocol
    # ------------------------------------------------------------------
    def write(self, handle: ObjHandle, off: int, data: bytes) -> None:
        if off < 0 or off + len(data) > handle.size:
            raise IndexError("write beyond object")
        self.view.write_release(handle.offset + off, data)

    def read(self, handle: ObjHandle, off: int, n: int) -> bytes:
        if off < 0 or off + n > handle.size:
            raise IndexError("read beyond object")
        return self.view.read_acquire(handle.offset + off, n)

    def read_into(self, handle: ObjHandle, off: int, dst) -> int:
        """Fill the writable buffer ``dst`` (host memory, or a flat uint8
        CUDA tensor, which the pool's device window fills with the
        ``cellcopy`` kernel) from the object at ``off``."""
        n = len(dst)
        if off < 0 or off + n > handle.size:
            raise IndexError("read beyond object")
        return self.view.read_acquire_into(handle.offset + off, dst)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        used = 0
        for lvl in range(self.n_levels):
            base = self.level_off[lvl]
            for i in range(self.caps[lvl]):
                # advisory stats snapshot: stale reads are acceptable
                if self.view.raw_read(base + i * SLOT_SIZE,
                                      1)[0]:  # lint: raw-ok (stats)
                    used += 1
        return {
            "slots_total": sum(self.caps),
            "slots_used": used,
            "heap_used": self.view.nt_load_u64(_H_HEAP_CUR) - self.heap_off,
            "heap_total": self.pool.size - self.heap_off,
            "level_caps": list(self.caps),
        }


# paper production configuration (§3.7): ~2M slots
PAPER_ARENA = dict(n_levels=10, base_slots=200_000)
