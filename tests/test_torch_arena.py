"""The port's arena coalesces its frees: a freed block merges with the
free blocks that touch it and goes back to the bump pointer when it
ends there. Held against the reference's append-only free list on
sequences whose frees touch no free block, on a pool that ranks of
both packages share, and on the stream sender's create/destroy churn."""
import collections
import os
import uuid

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.core.arena import Arena as RefArena  # noqa: E402
from repro.core.pool import LocalPool as RefLocalPool  # noqa: E402
from repro.core.pool import SharedMemoryPool as RefShm  # noqa: E402
from repro_torch.core.arena import _H_HEAP_CUR  # noqa: E402
from repro_torch.core.arena import Arena, ArenaFullError  # noqa: E402
from repro_torch.core.pool import CACHELINE, LocalPool  # noqa: E402
from repro_torch.core.pool import SharedMemoryPool  # noqa: E402
from repro_torch.core.trace import Tracer  # noqa: E402

POOL = 4 << 20


def _rounded(size: int) -> int:
    return size + (-size) % CACHELINE


def _heap_cur(arena) -> int:
    return arena.view.nt_load_u64(_H_HEAP_CUR)


def _payload(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def _touches_free(arena, offset: int, size: int) -> bool:
    """Whether freeing this block would merge: a free entry ends at its
    start or starts at its end, or it ends at the bump pointer."""
    end = offset + _rounded(size)
    return end == _heap_cur(arena) or any(
        o + s == offset or o == end for o, s in arena._freelist())


def _check_layout(arena, live: dict) -> None:
    """Live objects never overlap and ``open`` finds each; the free
    entries and the live blocks tile the heap up to the bump pointer."""
    spans = sorted((o, _rounded(s)) for o, s in live.values())
    for (o1, s1), (o2, _) in zip(spans, spans[1:]):
        assert o1 + s1 <= o2, "live objects overlap"
    for name, (off, _) in live.items():
        assert arena.open(name).offset == off
    free = arena._freelist()
    blocks = sorted(spans + free)
    for (o1, s1), (o2, _) in zip(blocks, blocks[1:]):
        assert o1 + s1 <= o2, "a free entry overlaps a block"
    assert sum(s for _, s in blocks) == _heap_cur(arena) - arena.heap_off


def test_frees_that_touch_no_free_block_match_the_reference():
    """Where no free merges, the port lays out the pool byte for byte as
    the reference: the same offsets, slots, free list and header."""
    rng = np.random.default_rng(2800)
    ref = RefArena(RefLocalPool(POOL), 0, initialize=True)
    port = Arena(LocalPool(POOL), 0, initialize=True)
    live, destroyed = {}, 0
    for step in range(240):
        isolated = [n for n, (o, s) in live.items()
                    if not _touches_free(ref, o, s)]
        if isolated and rng.random() < 0.45:
            name = isolated[rng.integers(len(isolated))]
            ref.destroy(ref.open(name))
            port.destroy(port.open(name))
            del live[name]
            destroyed += 1
        else:
            name, size = f"o{step}", int(rng.integers(1, 3000))
            data = _payload(size, step)
            h, g = ref.create(name, size), port.create(name, size)
            assert g.offset == h.offset
            ref.write(h, 0, data)
            port.write(g, 0, data)
            live[name] = (h.offset, size)
        if step % 40 == 39:
            assert port.pool.read(0, POOL) == bytes(ref.pool.buf)
    assert destroyed >= 40 and len(ref._freelist()) >= 10
    assert port.pool.read(0, POOL) == bytes(ref.pool.buf)
    _check_layout(port, live)


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(
    st.tuples(st.text(alphabet="abcdefgh", min_size=1, max_size=8),
              st.integers(min_value=1, max_value=2048)),
    min_size=1, max_size=40))
def test_property_coalesced_free_list(ops):
    """As the reference's ``test_property_no_overlap_and_findable``, on
    the port, and the free list stays coalesced: no two entries touch,
    none ends at the bump pointer, and free plus live bytes fill the
    heap up to it."""
    a = Arena(LocalPool(8 << 20), 0, initialize=True)
    live: dict[str, tuple[int, int]] = {}
    for name, size in ops:
        if name in live:
            a.destroy(a.open(name))
            del live[name]
        else:
            try:
                h = a.create(name, size)
            except ArenaFullError:
                continue
            live[name] = (h.offset, size)
    _check_layout(a, live)
    free = a._freelist()
    ends = {o + s for o, s in free}
    assert not ends & {o for o, _ in free}, "two free entries touch"
    assert _heap_cur(a) not in ends, "a free entry ends at the heap top"


def test_stream_churn_keeps_the_list_short_and_the_heap_bounded():
    """The stream sender's pattern, in KiB where it runs MiB: a few
    long-lived objects, then one object of 64 B plus 1, 2, 4 or 8 KiB a
    message, destroyed once ten newer ones are live. An append-only
    list grows on this until it reaches its cap and leaks."""
    a = Arena(LocalPool(2 << 20), 0, initialize=True)
    for name in ("w:mq", "w:bar", "w:mb", "w:ok"):
        a.create(name, 4096)
    rng = np.random.default_rng(2801)
    live = collections.deque()
    top = 0
    for i in range(5000):
        size = 64 + 1024 * int(rng.choice((1, 2, 4, 8)))
        live.append(a.create(f"rv:{i}", size))
        if len(live) > 10:
            a.destroy(live.popleft())
        assert len(a._freelist()) <= len(live) + 4 + 1
        top = max(top, _heap_cur(a) - a.heap_off)
    # at most 15 objects are live (the 11th stager before the oldest
    # goes); the heap stays within twice what they can hold, while the
    # 5000 messages move 24 MiB through it
    assert top <= 2 * (4 * 4096 + 11 * (8192 + 64))
    for h in live:
        a.destroy(h)
    assert a._freelist() == []
    assert _heap_cur(a) == a.heap_off + 4 * 4096


def test_reference_and_port_arenas_share_a_pool():
    """A reference rank and a port rank create and destroy on one pool
    in a seeded order: the reference appends to the list, the port
    merges what touches, and every live object keeps its bytes and is
    found at its offset by both."""
    name = f"ar{os.getpid()}{uuid.uuid4().hex[:8]}"
    ref_pool = RefShm(POOL, name=name, create=True)
    port_pool = SharedMemoryPool(0, name=name, create=False, device="cpu")
    try:
        ref = RefArena(ref_pool, 0, initialize=True)
        port = Arena(port_pool, 1, initialize=False)
        rng = np.random.default_rng(2802)
        live: dict[str, tuple[int, int]] = {}
        merges = 0
        for step in range(400):
            a = (ref, port)[int(rng.integers(2))]
            if live and rng.random() < 0.45:
                name_ = list(live)[rng.integers(len(live))]
                off, size = live.pop(name_)
                merges += a is port and _touches_free(port, off, size)
                a.destroy(a.open(name_))
            else:
                name_, size = f"o{step}", int(rng.integers(1, 3000))
                h = a.create(name_, size)
                a.write(h, 0, _payload(size, step))
                live[name_] = (h.offset, size)
            for n, (off, size) in live.items():
                seed = int(n[1:])
                for b in (ref, port):
                    h = b.open(n)
                    assert h.offset == off
                    assert b.read(h, 0, size) == _payload(size, seed)
        _check_layout(ref, live)
        _check_layout(port, live)
        assert merges >= 20
    finally:
        port_pool.close()
        ref_pool.close()
        ref_pool.unlink()


def test_free_counters():
    """``arena_frees``, ``arena_merged`` and ``freelist_peak`` count the
    frees of a rank whose tracer records, and nothing while it is off."""
    a = Arena(LocalPool(POOL), 0, initialize=True)
    tr = Tracer(rank=0, enabled=False)
    a.view.tracer = tr
    a.destroy(a.create("off", 100))
    assert (tr.arena_frees, tr.arena_merged, tr.freelist_peak) == (0, 0, 0)
    tr.start()
    x, y, z, w = (a.create(n, 128) for n in "xyzw")
    a.destroy(x)                    # between live blocks: an entry
    a.destroy(z)                    # a second
    assert sorted(a._freelist()) == [(x.offset, 128), (z.offset, 128)]
    a.destroy(y)                    # joins both into one
    assert a._freelist() == [(x.offset, 384)]
    a.destroy(w)                    # joins it and ends at the top
    assert a._freelist() == [] and _heap_cur(a) == a.heap_off
    c = tr.span_counters()
    assert (c["arena_frees"], c["arena_merged"], c["freelist_peak"]) \
        == (4, 2, 2)
    tr.stop()
    a.destroy(a.create("after", 100))
    assert tr.arena_frees == 4
    tr.start()
    assert (tr.arena_frees, tr.arena_merged, tr.freelist_peak) == (0, 0, 0)
