"""One-sided windows of the port (``repro_torch.core.rma``) against the JAX
package's, case by case: every case of ``tests/test_rma_v2.py`` and
``tests/test_sync_rma.py`` runs once under ``repro.core.run_threads`` and
once under ``repro_torch.core.run_threads(..., device="cpu")`` on the same
seeded numpy inputs. Each asserts the reference test's own checks, that the
two packages' results are byte-identical, and that every rank's
``path_copied_bytes`` ``rma_*`` buckets are identical. A last case puts a
reference rank and a port rank on one shared-memory pool: the window and
notify-matrix layouts are the same bytes."""
import os
import threading
import time
import uuid

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as REF  # noqa: E402
import repro_torch.core as PORT  # noqa: E402
from repro.core.arena import Arena as RefArena  # noqa: E402
from repro.core.pool import LocalPool as RefLocalPool  # noqa: E402
from repro.core.pool import SharedMemoryPool as RefShm  # noqa: E402
from repro.core.rma import Window as RefWindow  # noqa: E402
from repro.core.sync import BakeryLock as RefBakery  # noqa: E402
from repro.core.sync import SeqBarrier as RefSeqBarrier  # noqa: E402
from repro_torch.core.arena import Arena as PortArena  # noqa: E402
from repro_torch.core.coherence import CoherentView  # noqa: E402
from repro_torch.core.pool import LocalPool as PortLocalPool  # noqa: E402
from repro_torch.core.pool import SharedMemoryPool as PortShm  # noqa: E402
from repro_torch.core.rma import Window as PortWindow  # noqa: E402
from repro_torch.core.sync import BakeryLock, SeqBarrier  # noqa: E402

RMA = ("rma_put", "rma_get", "rma_notify", "rma_coll")


def _np(x):
    """A result of either package as a numpy array (tensors, bytes-mode
    receive payloads and memoryviews included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(x), np.uint8)
    return np.asarray(x)


def _norm(x):
    """Results in a form that compares byte for byte across packages."""
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor) and x.dim() == 0:
        return x.item()
    if isinstance(x, (torch.Tensor, np.ndarray)):
        a = _np(x)
        return ("array", a.dtype.str, a.shape, a.tobytes())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, memoryview):
        return bytes(x)
    return x


def _run(pkg, n, prog, **kw):
    def rank(env):
        out = prog(env, pkg)
        pc = env.arena.view.stats.path_copied_bytes
        return _norm(out), {k: pc.get(k, 0) for k in RMA}

    if pkg is PORT:
        kw["device"] = "cpu"
    return pkg.run_threads(n, rank, **kw)


def both(n, prog, **kw):
    """Run ``prog(env, pkg)`` on ``n`` ranks under each package; assert
    byte-identical results and identical ``rma_*`` buckets per rank (no
    case here has a timing-dependent one: each rank's one-sided bytes are
    fixed by its own calls). Returns the results."""
    ref = _run(REF, n, prog, **kw)
    port = _run(PORT, n, prog, **kw)
    assert [o for o, _ in port] == [o for o, _ in ref]
    assert [b for _, b in port] == [b for _, b in ref]
    return [o for o, _ in ref]


# --------------------------------------------------------------------------
# tests/test_rma_v2.py
# --------------------------------------------------------------------------

class TestRequestBasedRMA:
    def test_rput_rget_roundtrip(self):
        def prog(env, pkg):
            r, n = env.rank, env.size
            win = env.comm.win_allocate("w", 1 << 16)
            src = (np.arange(4096, dtype=np.uint8) + r).astype(np.uint8)
            win.fence()
            win.rput(r, 0, src).wait()
            win.fence()
            peer = (r + 1) % n
            dst = np.zeros(4096, np.uint8)
            res = win.rget(peer, 0, dst).wait()
            assert res is dst             # wait() returns the dest
            win.free()
            return np.array_equal(
                dst, (np.arange(4096) + peer).astype(np.uint8)), dst

        assert all(ok for ok, _ in both(3, prog, pool_bytes=16 << 20))

    def test_rput_chunked_counts_rma_put(self):
        size = 64 * 1024

        def prog(env, pkg):
            win = env.comm.win_allocate("w", size)
            st = env.arena.view.stats
            c0 = st.path_copied_bytes["rma_put"]
            src = np.full(size, env.rank, np.uint8)
            win.fence()
            win.rput(env.rank, 0, src, chunk_bytes=8 * 1024).wait()
            win.fence()
            put_bytes = st.path_copied_bytes["rma_put"] - c0
            got = win.get_array((env.rank + 1) % env.size, 0,
                                (size,), np.uint8)
            win.free()
            return put_bytes, bool(np.all(_np(got) ==
                                          (env.rank + 1) % env.size))

        for put_bytes, ok in both(2, prog, pool_bytes=16 << 20):
            assert put_bytes == size
            assert ok

    def test_blocking_put_get_count_paths(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 256)
            st = env.arena.view.stats
            win.fence()
            p0, g0 = (st.path_copied_bytes["rma_put"],
                      st.path_copied_bytes["rma_get"])
            win.put(env.rank, 0, b"x" * 100)
            got = win.get(env.rank, 0, 100)
            win.accumulate(env.rank, 128, np.arange(4.0))
            win.fence()
            dp = st.path_copied_bytes["rma_put"] - p0
            dg = st.path_copied_bytes["rma_get"] - g0
            acc = win.get_array(env.rank, 128, (4,), np.float64)
            win.free()
            return dp, dg, got, acc

        for dp, dg, got, _ in both(2, prog, pool_bytes=16 << 20):
            assert dp == 100 + 32        # put + accumulate write-back
            assert dg == 100 + 32        # get + accumulate read
            assert got == b"x" * 100

    def test_mixed_waitall_pt2pt_and_rma(self):
        def prog(env, pkg):
            r, n = env.rank, env.size
            comm = env.comm
            win = comm.win_allocate("w", 1 << 16)
            win.fence()
            peer = (r + 1) % n
            src_rank = (r - 1) % n
            sreq = comm.isend(peer, np.full(512, r, np.uint8), tag=5)
            rreq = comm.irecv(src_rank, tag=5)
            preq = win.rput(r, 0, np.full(2048, r, np.uint8),
                            chunk_bytes=512)
            comm.waitall([sreq, rreq, preq])
            win.fence()
            dst = np.zeros(2048, np.uint8)
            greq = win.rget(peer, 0, dst, chunk_bytes=512)
            comm.waitall([greq])
            msg = _np(rreq.data)
            win.free()
            return bool(np.all(msg == src_rank)), bool(np.all(dst == peer))

        for pt_ok, rma_ok in both(3, prog, pool_bytes=16 << 20):
            assert pt_ok and rma_ok


class TestNotifiedAccess:
    def test_put_notify_zero_receiver_copy(self):
        """The consumer's copied-byte counters do not move at all in
        either package: it spins on one nt word and reads in place."""
        payload = b"sensor-frame-0042"

        def prog(env, pkg):
            win = env.comm.win_allocate("w", 4096)
            st = env.arena.view.stats
            win.fence()
            if env.rank == 0:
                n0 = st.path_copied_bytes["rma_notify"]
                win.put_notify(1, 64, payload)
                out = ("origin", st.path_copied_bytes["rma_notify"] - n0)
            else:
                c0 = st.copied_bytes
                assert win.wait_notify(0) == 1
                got = _np(win.local_view(64, len(payload))).tobytes()
                out = ("consumer", st.copied_bytes - c0, got)
            win.fence()
            win.free()
            return out

        origin, consumer = both(2, prog, pool_bytes=16 << 20)
        assert origin == ("origin", len(payload))
        assert consumer == ("consumer", 0, payload)

    def test_notify_counts_and_test_notify(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 4096)
            win.fence()
            if env.rank == 0:
                for i in range(3):
                    win.put_notify(1, 128 * i, bytes([i]) * 8)
                win.fence()
                win.free()
                return None
            win.wait_notify(0, count=3)
            assert win.test_notify(0) == 0
            vals = [int(win.local_view(128 * i, 8)[0]) for i in range(3)]
            win.fence()
            win.free()
            return vals

        assert both(2, prog, pool_bytes=16 << 20)[1] == [0, 1, 2]

    def test_wait_notify_timeout(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 256)
            win.fence()
            if env.rank == 1:
                with pytest.raises(TimeoutError):
                    win.wait_notify(0, timeout=0.2)
            win.fence()
            win.free()
            return True

        assert all(both(2, prog, pool_bytes=16 << 20))


class TestWindowCollectives:
    def test_allgather_get(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 1 << 16)
            out = win.allgather(np.full(64, float(env.rank) + 0.5))
            win.free()
            return out

        n = 4
        exp = np.repeat(np.arange(n) + 0.5, 64)
        for out in both(n, prog, pool_bytes=32 << 20):
            assert out == _norm(exp)

    def test_allgather_counts_rma_coll_no_wire_payload(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 1 << 16)
            st = env.arena.view.stats
            before = dict(st.path_copied_bytes)
            out = win.allgather(np.arange(128.0) * (env.rank + 1))
            coll = st.path_copied_bytes["rma_coll"] - before["rma_coll"]
            wire = sum(st.path_copied_bytes[k] - before[k]
                       for k in ("eager", "rndv_staged", "rndv_posted"))
            win.free()
            return _np(out).size, coll, wire, out

        for size, coll, wire, _ in both(3, prog, pool_bytes=32 << 20):
            assert size == 3 * 128
            assert coll > 0
            assert wire == 0

    def test_bcast_put_roots_and_chunks(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 1 << 17)
            outs = []
            for root in (0, env.size - 1):
                arr = (np.arange(8192, dtype=np.float64)
                       if env.rank == root else np.zeros(8192))
                win.ibcast(arr, root=root, chunk_bytes=16 * 1024).wait()
                outs.append(bool(np.array_equal(arr, np.arange(8192.0))))
                win.fence()          # bcast completion is local
            win.free()
            return outs

        for outs in both(4, prog, pool_bytes=64 << 20):
            assert outs == [True, True]

    def test_interleaves_with_comm_collectives(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 4096)
            a = env.comm.allreduce(np.full(16, 1.0))
            g = win.allgather(np.full(16, float(env.rank)))
            b = env.comm.allreduce(np.full(16, 2.0))
            win.free()
            return float(a[0]), _np(g).copy(), float(b[0])

        n = 3
        for a0, g, b0 in both(n, prog, pool_bytes=32 << 20):
            assert a0 == n and b0 == 2 * n
            assert g == _norm(np.repeat(np.arange(n, dtype=float), 16))

    def test_size_1_and_bounds(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 128)
            g = win.allgather(np.arange(4.0))
            with pytest.raises(ValueError):
                win.allgather(np.zeros(1024))    # shard > win_size
            with pytest.raises(ValueError):
                win.ibcast(np.zeros(1024), root=0)
            win.free()
            return g

        assert both(1, prog, pool_bytes=8 << 20)[0] == _norm(np.arange(4.0))


class TestPassiveTargetEpochs:
    def test_lock_all_flush(self):
        def prog(env, pkg):
            r, n = env.rank, env.size
            win = env.comm.win_allocate("w", 4096)
            win.fence()
            win.lock_all()
            req = win.rput((r + 1) % n, 0, np.full(1024, r, np.uint8),
                           chunk_bytes=256)
            win.flush((r + 1) % n)
            win.unlock_all()
            win.fence()
            assert req.done
            got = win.get_array(r, 0, (1024,), np.uint8)
            win.free()
            return bool(np.all(_np(got) == (r - 1) % n))

        assert all(both(4, prog, pool_bytes=16 << 20))

    def test_flush_local_and_unlock_complete_requests(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 8192)
            win.fence()
            win.lock(shared=True)
            req = win.rput(env.rank, 0, np.full(4096, 7, np.uint8),
                           chunk_bytes=1024)
            win.unlock(shared=True)     # unlock flushes
            assert req.done
            win.fence()
            win.flush_local()           # no outstanding: no-op
            got = win.get_array(env.rank, 0, (4096,), np.uint8)
            win.free()
            return bool(np.all(_np(got) == 7))

        assert all(both(2, prog, pool_bytes=16 << 20))


class TestWindowLifecycle:
    def test_free_idempotent_mid_epoch(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 4096)
            win.fence()
            if env.rank == 0:
                win.rput(1, 0, np.full(512, 9, np.uint8),
                         chunk_bytes=128)        # left outstanding
            else:
                win.lock_all()                   # left open
            win.free()
            win.free()                           # idempotent
            win.free()
            return True

        assert all(both(2, prog, pool_bytes=16 << 20))

    @pytest.mark.parametrize("pkg", ["ref", "port"])
    def test_detached_window_rejects_requests(self, pkg):
        """A Window built without a communicator still does blocking
        put/get but refuses the engine-backed surface."""
        arena_cls, pool_cls, win_cls = (
            (RefArena, RefLocalPool, RefWindow) if pkg == "ref"
            else (PortArena, PortLocalPool, PortWindow))
        arena = arena_cls(pool_cls(1 << 20), 0, initialize=True)
        win = win_cls(arena, "solo", 1, 0, 1024, create=True)
        win.put(0, 0, b"abc")
        assert win.get(0, 0, 3) == b"abc"
        win.accumulate(0, 8, np.full(2, 1.5))
        win.accumulate(0, 8, np.full(2, 2.0))
        assert _np(win.get_array(0, 8, (2,), np.float64)).tolist() == [
            3.5, 3.5]
        with pytest.raises(RuntimeError):
            win.rput(0, 0, np.zeros(8, np.uint8))
        with pytest.raises(RuntimeError):
            win.allgather(np.zeros(4))
        # the two packages leave the same bytes in the arena
        if pkg == "port":
            ref_arena = RefArena(RefLocalPool(1 << 20), 0, initialize=True)
            ref = RefWindow(ref_arena, "solo", 1, 0, 1024, create=True)
            ref.put(0, 0, b"abc")
            ref.accumulate(0, 8, np.full(2, 1.5))
            ref.accumulate(0, 8, np.full(2, 2.0))
            assert arena.pool.read(0, 1 << 20) == bytes(ref_arena.pool.buf)


class TestRaccumulate:
    def test_blocking_accumulate_still_works(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("acc", 1 << 12)
            if env.rank == 0:
                win.put_array(0, 0, np.zeros(16))
            win.fence()
            win.accumulate(0, 0, np.full(16, float(env.rank + 1)))
            win.fence()
            out = win.get_array(0, 0, (16,), np.float64)
            win.free()
            return float(out[0])

        assert both(3, prog, pool_bytes=16 << 20) == [6.0, 6.0, 6.0]

    def test_raccumulate_atomic_under_contention(self):
        iters = 20

        def prog(env, pkg):
            win = env.comm.win_allocate("racc", 1 << 12)
            if env.rank == 0:
                win.put_array(0, 0, np.zeros(1))
            win.fence()
            for _ in range(iters):
                win.raccumulate(0, 0, np.ones(1)).wait()
            win.fence()
            out = float(win.get_array(0, 0, (1,), np.float64)[0])
            win.free()
            return out

        res = both(4, prog, pool_bytes=16 << 20, timeout=120)
        assert res[0] == 4 * iters

    def test_raccumulate_is_nonblocking_and_releases_lock(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("rnb", 1 << 16)
            if env.rank == 0:
                win.put_array(1, 0, np.zeros(2048))
            win.fence()
            if env.rank == 0:
                req = win.raccumulate(1, 0, np.ones(2048),
                                      chunk_bytes=4096)
                req.wait()
                win.lock()        # released on completion, or deadlock
                win.unlock()
            win.fence()
            out = float(_np(win.get_array(1, 0, (2048,),
                                          np.float64)).sum())
            win.free()
            return out

        assert both(2, prog, pool_bytes=16 << 20) == [2048.0, 2048.0]

    def test_raccumulate_path_buckets_split_get_put(self):
        nbytes = 4096

        def prog(env, pkg):
            win = env.comm.win_allocate("rpb", 1 << 13)
            win.fence()
            before = env.comm.arena.view.stats.snapshot()
            if env.rank == 0:
                win.raccumulate(1, 0, np.zeros(nbytes, np.uint8)).wait()
            win.fence()
            d = env.comm.arena.view.stats.delta(before)
            win.free()
            return {k: v for k, v in d["path_copied_bytes"].items()
                    if k.startswith("rma")}

        origin, target = both(2, prog, pool_bytes=16 << 20)
        assert origin.get("rma_get", 0) == nbytes
        assert origin.get("rma_put", 0) == nbytes
        assert target.get("rma_get", 0) == 0
        assert target.get("rma_put", 0) == 0

    def test_raccumulate_custom_op(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("rop", 1 << 12)
            if env.rank == 0:
                win.put_array(0, 0, np.full(8, 3.0))
            win.fence()
            if env.rank == 1:
                win.raccumulate(0, 0, np.full(8, 5.0),
                                op=np.maximum).wait()
            win.fence()
            out = float(win.get_array(0, 0, (8,), np.float64)[0])
            win.free()
            return out

        assert both(2, prog, pool_bytes=16 << 20) == [5.0, 5.0]


    def test_raccumulate_failure_releases_the_lock(self):
        """Port only: a chunk whose read-modify-write raises (here the
        op; on the card a failed launch) aborts the request, re-raises to
        the caller and releases the exclusive window lock, so the next
        lock() does not wait forever. The JAX package has no such path:
        its host copies do not fail."""
        def bad_op(dst, src, out=None):
            raise RuntimeError("reduce failed")

        def prog(env):
            win = env.comm.win_allocate("rfail", 1 << 12)
            if env.rank == 0:
                win.put_array(1, 0, np.zeros(8))
            win.fence()
            if env.rank == 0:
                with pytest.raises(RuntimeError, match="reduce failed"):
                    win.raccumulate(1, 0, np.ones(8), op=bad_op)
                win.lock()
                win.unlock()
                req = win.raccumulate(1, 0, np.ones(8))   # still usable
                req.wait()
            win.fence()
            out = _np(win.get_array(1, 0, (8,), np.float64))
            win.free()
            return out.tolist()

        res = PORT.run_threads(2, prog, pool_bytes=16 << 20, device="cpu")
        assert res == [[1.0] * 8] * 2


class TestDynamicWindow:
    def test_attach_detach_copies_nothing(self):
        def prog(env, pkg):
            win = env.comm.win_create_dynamic("dw0")
            buf = env.comm.alloc_buffer(4096)
            before = env.comm.arena.view.stats.snapshot()
            addr = win.attach(buf)
            win.detach(addr)
            d = env.comm.arena.view.stats.delta(before)
            env.comm.barrier()
            buf.free()
            win.free()
            return d["copied_bytes"], d["copies"], addr

        res = both(2, prog, pool_bytes=16 << 20)
        assert [r[:2] for r in res] == [(0, 0), (0, 0)]

    def test_rget_of_attached_pool_buffer(self):
        def prog(env, pkg):
            r = env.rank
            win = env.comm.win_create_dynamic("dw1")
            buf = env.comm.alloc_buffer(4096)
            buf.write(np.full(4096, r + 1, np.uint8))
            addr = win.attach(buf)
            addrs = env.comm.allgather(np.asarray([addr], np.int64))
            peer = (r + 1) % env.size
            dst = np.zeros(4096, np.uint8)
            win.rget(peer, int(addrs[peer]), dst).wait()
            env.comm.barrier()
            win.detach(addr)
            buf.free()
            win.free()
            return int(dst[0]), int(dst[-1])

        assert both(3, prog, pool_bytes=16 << 20) == [(2, 2), (3, 3),
                                                      (1, 1)]

    def test_unattached_address_rejected(self):
        def prog(env, pkg):
            win = env.comm.win_create_dynamic("dw2")
            buf = env.comm.alloc_buffer(4096)
            addr = win.attach(buf)
            env.comm.barrier()
            err_unattached = err_straddle = err_detached = False
            if env.rank == 1:
                try:
                    win.rget(0, 12345678, np.zeros(16, np.uint8))
                except IndexError:
                    err_unattached = True
            env.comm.barrier()
            if env.rank == 0:
                try:
                    win.rput(0, addr + 4000, np.zeros(200, np.uint8))
                except IndexError:
                    err_straddle = True
                win.detach(addr)
            env.comm.barrier()
            if env.rank == 1:
                try:                  # tombstoned after detach
                    win.rget(0, addr, np.zeros(16, np.uint8))
                except IndexError:
                    err_detached = True
            env.comm.barrier()
            buf.free()
            win.free()
            return err_unattached, err_straddle, err_detached

        r0, r1 = both(2, prog, pool_bytes=16 << 20)
        assert r1 == (True, False, True)
        assert r0 == (False, True, False)

    def test_attach_table_exhaustion(self):
        def prog(env, pkg):
            win = env.comm.win_create_dynamic("dw3", attach_slots=2)
            bufs = [env.comm.alloc_buffer(64) for _ in range(3)]
            win.attach(bufs[0])
            a1 = win.attach(bufs[1])
            try:
                win.attach(bufs[2])
                full = False
            except RuntimeError:
                full = True
            win.detach(a1)
            win.attach(bufs[2])       # tombstoned slot is reusable
            env.comm.barrier()
            win.free()
            return full

        assert all(both(2, prog, pool_bytes=16 << 20))

    def test_window_collectives_rejected(self):
        def prog(env, pkg):
            win = env.comm.win_create_dynamic("dw4")
            try:
                win.allgather(np.zeros(4))
                ok = False
            except (ValueError, IndexError):
                ok = True
            win.free()
            return ok

        assert all(both(2, prog, pool_bytes=16 << 20))


# --------------------------------------------------------------------------
# tests/test_sync_rma.py
# --------------------------------------------------------------------------

def _threads(n, worker, timeout=10):
    ts = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
        assert not t.is_alive()


class TestSeqBarrier:
    @pytest.mark.parametrize("pkg", ["ref", "port"])
    def test_rendezvous(self, pkg):
        pool_cls, bar_cls = ((RefLocalPool, RefSeqBarrier) if pkg == "ref"
                             else (PortLocalPool, SeqBarrier))
        view = (REF.CoherentView if pkg == "ref" else CoherentView)(
            pool_cls(4096), "coherent")
        n = 4
        bars = [bar_cls(view, 0, n, r, initialize=(r == 0))
                for r in range(n)]
        arrived, seen = [], []
        lock = threading.Lock()

        def worker(r):
            time.sleep(0.01 * r)
            with lock:
                arrived.append(r)
            bars[r].wait()
            with lock:             # after the barrier, everyone arrived
                seen.append(len(arrived))

        _threads(n, worker)
        assert seen == [n] * n

    def test_reusable(self):
        pools = {}
        for pkg, pool_cls, bar_cls, view_cls in (
                ("ref", RefLocalPool, RefSeqBarrier, REF.CoherentView),
                ("port", PortLocalPool, SeqBarrier, CoherentView)):
            pool = pool_cls(4096)
            view = view_cls(pool, "coherent")
            bars = [bar_cls(view, 0, 2, r, initialize=(r == 0))
                    for r in range(2)]

            def worker(r, bars=bars):
                for _ in range(50):
                    bars[r].wait()

            _threads(2, worker)
            pools[pkg] = pool.read(0, 4096)
        assert pools["port"] == pools["ref"]     # the same barrier words


class TestBakery:
    @pytest.mark.parametrize("pkg", ["ref", "port"])
    def test_mutual_exclusion(self, pkg):
        pool_cls, lock_cls, view_cls = (
            (RefLocalPool, RefBakery, REF.CoherentView) if pkg == "ref"
            else (PortLocalPool, BakeryLock, CoherentView))
        pool = pool_cls(4096)
        n = 4
        locks = [lock_cls(view_cls(pool, "coherent"), 0, n, r,
                          initialize=(r == 0)) for r in range(n)]
        counter = {"v": 0}

        def worker(r):
            for _ in range(200):
                locks[r].acquire()
                v = counter["v"]          # racy read-modify-write unless
                time.sleep(0)             # the lock really excludes
                counter["v"] = v + 1
                locks[r].release()

        _threads(n, worker, timeout=30)
        assert counter["v"] == n * 200


class TestRMA:
    def test_put_get_fence(self):
        def prog(env, pkg):
            r, n = env.rank, env.size
            win = env.comm.win_allocate("w", 64)
            win.fence()
            win.put((r + 1) % n, 0, f"from{r}".encode())
            win.fence()
            return bytes(win.get(r, 0, 5))

        for r, got in enumerate(both(3, prog, pool_bytes=8 << 20)):
            assert got == f"from{(r - 1) % 3}".encode()

    def test_put_array_roundtrip(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 1024)
            arr = np.arange(32, dtype=np.float64) * (env.rank + 1)
            win.fence()
            win.put_array(env.rank, 0, arr)
            win.fence()
            peer = (env.rank + 1) % env.size
            return win.get_array(peer, 0, (32,), np.float64)

        res = both(2, prog, pool_bytes=8 << 20)
        assert res[0] == _norm(np.arange(32.0) * 2)
        assert res[1] == _norm(np.arange(32.0))

    def test_accumulate_atomic_under_lock(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 64)
            win.fence()
            for _ in range(25):
                win.accumulate(0, 0, np.array([1.0]))
            win.fence()
            return np.frombuffer(win.get(0, 0, 8))[0]

        assert both(4, prog, pool_bytes=8 << 20, timeout=120)[0] == 100.0

    def test_pscw_epoch(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 64)
            if env.rank == 0:                 # origin
                win.start([1])
                win.put(1, 0, b"epoch-data")
                win.complete([1])
                return b""
            win.post([0])                     # target
            win.wait([0])
            return bytes(win.get(1, 0, 10))

        assert both(2, prog, pool_bytes=8 << 20)[1] == b"epoch-data"

    def test_lock_unlock(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 64)
            win.fence()
            for _ in range(10):
                win.lock()
                cur = np.frombuffer(win.get(0, 0, 8))[0]
                win.put(0, 0, np.float64(cur + 1).tobytes())
                win.unlock()
            win.fence()
            return np.frombuffer(win.get(0, 0, 8))[0]

        assert both(3, prog, pool_bytes=8 << 20, timeout=120)[0] == 30.0

    def test_window_bounds(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("w", 16)
            with pytest.raises(IndexError):
                win.put(0, 12, b"too-long")
            return True

        assert all(both(2, prog, pool_bytes=8 << 20))


class TestGetIntoRegistration:
    def test_get_into_registration_destination(self):
        size = 2048

        def prog(env, pkg):
            win = env.comm.win_allocate("w", 4096)
            st = env.arena.view.stats
            win.fence()
            win.put(env.rank, 0, bytes([env.rank + 1]) * size)
            win.fence()
            peer = (env.rank + 1) % env.size
            dst = np.zeros(size, np.uint8)
            reg = env.comm.register(dst)
            g0 = st.path_copied_bytes["rma_get"]
            got = win.get_into(peer, 0, reg)
            dg = st.path_copied_bytes["rma_get"] - g0
            env.comm.unregister(reg)
            win.fence()
            return got, dg, bool(np.all(dst == peer + 1))

        for got, dg, ok in both(2, prog, pool_bytes=16 << 20):
            assert got == size and dg == size and ok

    def test_get_into_pool_buffer_copies_once(self):
        """A pool-resident destination (PoolBuffer and PoolView): one
        window -> pool copy, exactly one ``rma_get`` of n bytes."""
        size = 1024

        def prog(env, pkg):
            win = env.comm.win_allocate("w", 4096)
            st = env.arena.view.stats
            win.fence()
            win.put(env.rank, 0, bytes(range(256)) * (size // 256))
            win.fence()
            peer = (env.rank + 1) % env.size
            pb = env.comm.alloc_buffer(2 * size)
            s0 = st.snapshot()
            n1 = win.get_into(peer, 0, pb.slice(size, size))
            d1 = st.delta(s0)
            s0 = st.snapshot()
            n2 = win.get_into(peer, 0, pb)
            d2 = st.delta(s0)
            got = pb.read(0, 2 * size)
            env.comm.barrier()
            pb.free()
            win.free()
            return (n1, d1["copies"], d1["path_copied_bytes"], n2,
                    d2["copies"], d2["path_copied_bytes"], got)

        for n1, c1, p1, n2, c2, p2, got in both(2, prog,
                                                 pool_bytes=16 << 20):
            assert (n1, c1, p1) == (1024, 1, {"rma_get": 1024})
            assert (n2, c2, p2) == (2048, 1, {"rma_get": 2048})
            assert got == bytes(range(256)) * 4 + bytes(size)


class TestAccumulateUnderSharedLock:
    def test_accumulate_excluded_by_shared_holders(self):
        iters = 20

        def prog(env, pkg):
            win = env.comm.win_allocate("wacc", 64)
            win.fence()
            if env.rank == 0:
                win.put(0, 0, np.zeros(2).tobytes())
            win.fence()
            if env.rank in (0, 1):           # accumulators
                for _ in range(iters):
                    win.accumulate(0, 0, np.array([1.0, 1.0]))
                win.fence()
                return None
            tears = 0                        # concurrent shared readers
            for _ in range(iters * 3):
                win.lock(shared=True)
                pair = np.frombuffer(win.get(0, 0, 16))
                win.unlock(shared=True)
                if pair[0] != pair[1]:
                    tears += 1
            win.fence()
            return tears, np.frombuffer(win.get(0, 0, 16)).copy()

        res = both(4, prog, pool_bytes=8 << 20, timeout=120)
        for tears, final in res[2:]:
            assert tears == 0                # no torn accumulate seen
            assert final == _norm(np.full(2, 2.0 * iters))

    def test_accumulate_custom_op_with_shared_readers(self):
        def prog(env, pkg):
            win = env.comm.win_allocate("wmax", 64)
            win.fence()
            if env.rank == 0:
                win.put(0, 0, np.zeros(1).tobytes())
            win.fence()
            for i in range(10):
                win.accumulate(0, 0, np.array([float(env.rank * 10 + i)]),
                               op=np.maximum)
                win.lock(shared=True)
                seen = np.frombuffer(win.get(0, 0, 8))[0]
                win.unlock(shared=True)
                assert seen >= float(env.rank * 10 + i)
            win.fence()
            return np.frombuffer(win.get(0, 0, 8))[0]

        assert both(3, prog, pool_bytes=8 << 20, timeout=120) == [29.0] * 3


# --------------------------------------------------------------------------
# a reference rank and a port rank on one window
# --------------------------------------------------------------------------

def _mixed_rank(comm, rank, wrap, unwrap):
    """Rank 0 is one package, rank 1 the other: each puts into the
    other's segment and gets its own back after a fence; then a notified
    put crosses from rank 1 to rank 0, consumed in place."""
    peer = 1 - rank
    win = comm.win_allocate("mixed", 8192)
    data = np.random.default_rng(rank).integers(0, 256, 4096, np.uint8)
    want = np.random.default_rng(peer).integers(0, 256, 4096, np.uint8)
    win.fence()
    win.put(peer, 0, wrap(data))
    win.fence()
    mine = bytes(win.get(rank, 0, 4096))
    got = win.get_array(peer, 0, (4096,), np.uint8)
    win.rput(peer, 4096, wrap(data[:1024])).wait()
    win.fence()
    back = np.zeros(1024, np.uint8)
    win.rget(rank, 4096, back).wait()
    if rank == 1:
        win.put_notify(0, 6000, wrap(data[:100]))
        notified = None
    else:
        st = comm.arena.view.stats
        c0 = st.copied_bytes
        win.wait_notify(1, timeout=30.0)
        notified = (unwrap(win.local_view(6000, 100)).tobytes(),
                    st.copied_bytes - c0)
    win.fence()
    win.free()
    return (mine == want.tobytes(), unwrap(got).tobytes() == data.tobytes(),
            back.tobytes() == want[:1024].tobytes(), notified, want)


def test_reference_and_port_ranks_share_a_window():
    name = f"rw{os.getpid()}{uuid.uuid4().hex[:8]}"
    ref_pool = RefShm(8 << 20, name=name, create=True)
    RefArena(ref_pool, 0, initialize=True)
    port_pool = PortShm(0, name=name, create=False, device="cpu")
    results, errors = {}, []

    def ref_rank():
        comm = REF.Comm(RefArena(ref_pool, 0, initialize=False), 0, 2)
        results[0] = _mixed_rank(comm, 0, lambda a: a, np.asarray)

    def port_rank():
        comm = PORT.Comm(PortArena(port_pool, 1, initialize=False), 1, 2,
                         device="cpu")
        results[1] = _mixed_rank(comm, 1, torch.from_numpy, _np)

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
        for rank in (0, 1):
            assert results[rank][:3] == (True, True, True), rank
        payload = results[0][4][:100].tobytes()   # rank 1's data
        assert results[0][3] == (payload, 0)
    finally:
        port_pool.close()
        ref_pool.close()
        ref_pool.unlink()
