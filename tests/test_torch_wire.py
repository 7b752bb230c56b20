"""The wire format is shared: the port reads what the JAX package wrote,
byte for byte, and a reference rank and a port rank talk to each other
over one shared-memory pool on every pt2pt path."""
import os
import threading
import uuid

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Comm as RefComm  # noqa: E402
from repro.core.arena import Arena as RefArena  # noqa: E402
from repro.core.pool import LocalPool as RefLocalPool  # noqa: E402
from repro.core.pool import SharedMemoryPool as RefShm  # noqa: E402
from repro.core.ringqueue import FLAG_FIRST, FLAG_LAST, FLAG_RNDV  # noqa: E402
from repro.core.ringqueue import QueueMatrix as RefQM  # noqa: E402
from repro_torch.core import Comm as PortComm  # noqa: E402
from repro_torch.core.arena import Arena as PortArena  # noqa: E402
from repro_torch.core.pool import SharedMemoryPool as PortShm  # noqa: E402
from repro_torch.core.pool import pool_from_numpy  # noqa: E402
from repro_torch.core.ringqueue import QueueMatrix as PortQM  # noqa: E402

CELL, NCELLS = 4096, 8


def _payload(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def _ref_image():
    """A pool the JAX package built: an arena, a queue matrix, a
    multi-cell eager message and a staged rendezvous message from rank 0
    to rank 1, still queued."""
    pool = RefLocalPool(2 << 20)
    arena = RefArena(pool, 0, initialize=True)
    h = arena.create("w:mq", RefQM.region_bytes(2, CELL, NCELLS))
    q = RefQM(arena.view, h.offset, 2, 0, CELL, NCELLS,
              initialize=True).send_queue(1)
    q.send_message(_payload(10_000, 1), tag=5)
    staged = _payload(50_001, 2)
    s = arena.create("w:rv", 64 + len(staged))
    arena.view.nt_store_u8(s.offset, 0)
    arena.view.write_release(s.offset + 64, staged)
    desc = b"".join(x.to_bytes(8, "little") for x in (
        len(staged), 7, s.offset, s.offset + 64))
    q.enqueue_parts((desc,), FLAG_FIRST | FLAG_LAST | FLAG_RNDV)
    return np.frombuffer(pool.buf, dtype=np.uint8).copy()


def _drain(arena_cls, qm_cls, pool, into):
    """Rank 1 opens the image's named objects and drains both messages:
    the eager one with ``recv_message_into``, the staged one by its
    descriptor; the drain ack is written back as the protocol asks."""
    arena = arena_cls(pool, 1, initialize=False)
    h = arena.open("w:mq")
    q = qm_cls(arena.view, h.offset, 2, 1, CELL, NCELLS).recv_queue(0)
    n, tag = q.recv_message_into(into)
    desc, flags = q.dequeue()
    assert flags & FLAG_RNDV
    total, stag, ack, data = (int.from_bytes(desc[i:i + 8], "little")
                              for i in range(0, 32, 8))
    staged = bytes(arena.view.read_acquire(data, total))
    arena.view.nt_store_u8(ack, 1)
    return (n, tag), (stag, staged), arena.view.stats.snapshot()


def test_port_drains_reference_image():
    img = _ref_image()
    port_pool = pool_from_numpy(img)
    ref_pool = RefLocalPool(img.size)
    ref_pool.buf[:] = img.tobytes()
    port_dst = torch.zeros(10_000, dtype=torch.uint8)
    ref_dst = bytearray(10_000)
    got = _drain(PortArena, PortQM, port_pool, port_dst)
    want = _drain(RefArena, RefQM, ref_pool, ref_dst)
    assert got == want
    assert bytes(port_dst.numpy()) == bytes(ref_dst) == _payload(10_000, 1)
    assert got[1] == (7, _payload(50_001, 2))
    # both drains leave the same pool bytes behind (indices, ack byte)
    assert port_pool.read(0, port_pool.size) == bytes(ref_pool.buf)


def _to_bytes(x) -> bytes:
    return bytes(x.numpy()) if isinstance(x, torch.Tensor) else bytes(x)


# (path, message bytes): eager fits under the 16 KiB threshold in
# several 4 KiB cells; staged and posted ride rendezvous
EXCHANGES = [("eager", 100), ("eager", 10_000), ("staged", 50_000),
             ("posted", 50_000), ("staged", 0)]


def _mixed_rank(comm, rank, wrap):
    peer = 1 - rank
    posted_before = comm.posted_sends
    for i, (path, n) in enumerate(EXCHANGES):
        for sender in (0, 1):
            data = _payload(n, 100 * i + sender)
            if rank == sender:
                if path == "posted":
                    comm.recv(peer, tag=2)          # the receiver's credit
                comm.send(peer, wrap(data), tag=1)
                continue
            if path == "posted":
                pb = comm.alloc_buffer(n)
                req = comm.irecv_into(peer, pb, tag=1)
                comm.send(peer, b"", tag=2)
                req.wait()
                got = bytes(pb.read(0, n))
                pb.free()
            elif path == "staged":
                buf = bytearray(n)
                got_n, _ = comm.recv_into(peer, buf, tag=1)
                assert got_n == n
                got = bytes(buf)
            else:
                got = _to_bytes(comm.recv(peer, tag=1)[0])
            assert got == data, (path, n, sender)
    comm.barrier()
    return comm.posted_sends - posted_before


def test_reference_and_port_ranks_share_a_pool():
    name = f"rt{os.getpid()}{uuid.uuid4().hex[:8]}"
    ref_pool = RefShm(8 << 20, name=name, create=True)
    RefArena(ref_pool, 0, initialize=True)
    port_pool = PortShm(0, name=name, create=False, device="cpu")
    results, errors = {}, []
    kw = dict(cell_size=CELL, eager_threshold=16384)

    def ref_rank():
        comm = RefComm(RefArena(ref_pool, 0, initialize=False), 0, 2, **kw)
        results[0] = _mixed_rank(comm, 0, lambda b: b)

    def port_rank():
        comm = PortComm(PortArena(port_pool, 1, initialize=False), 1, 2,
                        device="cpu", **kw)
        results[1] = _mixed_rank(comm, 1, lambda b: torch.from_numpy(
            np.frombuffer(b, dtype=np.uint8).copy()))

    def guard(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=guard, args=(f,), daemon=True)
               for f in (ref_rank, port_rank)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads), "ranks hung"
        if errors:
            raise errors[0]
        # every FLAG_POSTED exchange hit the receiver's posting
        assert results == {0: 1, 1: 1}
    finally:
        port_pool.close()
        ref_pool.close()
        ref_pool.unlink()


def test_port_reads_the_reference_machine_profile(tmp_path):
    """The machine-profile JSON carries across unchanged: the port's
    loader derives the same policies from a file the reference wrote."""
    from repro.core import profile as ref_prof
    from repro_torch.core import profile as port_prof
    data = {"eager_crossover_bytes": 4096, "copy_knee_bytes": 256 * 1024,
            "best_chunk_bytes": 1 << 20, "cache_gbps": 80.0,
            "dram_gbps": 20.0, "strip_scan_us_per_slot": 2.5,
            "spill_promote_us": 20.0, "yield_cost_us": 0.5}
    path = ref_prof.write_profile(data, tmp_path / "profile.json")
    want, got = ref_prof.load_profile(path), port_prof.load_profile(path)
    assert got is not None
    for field in ("eager_crossover", "eager_threshold", "chunk_floor",
                  "tier_ratio", "mb_depth"):
        assert getattr(got, field) == getattr(want, field), field
