"""The port's one wait (``repro_torch.core.wait``): every blocking surface
of the communication core spins through ``wait.spin``, every request is a
``wait.Waitable``, and the arena's lock is ``sync.BakeryLock``. Held here on
CPU communicators: each surface's timeout error and its message, the four
request kinds mixed in ``waitall``/``waitany``/``testall``, the arena's
lock against the reference's on one pool, and (by AST) that nothing else in
``core/`` sleeps."""
import ast
import os
import time
import uuid
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as PORT  # noqa: E402
from repro.core.arena import _BAKERY_NUMBER as REF_BAKERY_NUMBER  # noqa: E402
from repro.core.arena import Arena as RefArena  # noqa: E402
from repro.core.pool import SharedMemoryPool as RefShm  # noqa: E402
from repro_torch.core import wait  # noqa: E402
from repro_torch.core.arena import Arena  # noqa: E402
from repro_torch.core.comm import (PersistentCollRequest,  # noqa: E402
                                   PersistentRequest)
from repro_torch.core.pool import SharedMemoryPool  # noqa: E402
from repro_torch.core.progress import CollRequest  # noqa: E402
from repro_torch.core.pt2pt import Request  # noqa: E402
from repro_torch.core.ringqueue import SPSCQueue  # noqa: E402
from repro_torch.core.sync import PSCW, BakeryLock, RWLock  # noqa: E402
from repro_torch.core.sync import SeqBarrier  # noqa: E402

CORE = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "core"
T = 0.05          # a wait that cannot complete gives up after this long


def _on_rank0(n: int, prog):
    """``prog(env)`` on rank 0 of an ``n``-rank CPU communicator whose
    other ranks return at once; what it returned."""
    return PORT.run_threads(
        n, lambda env: prog(env) if env.rank == 0 else None,
        pool_bytes=4 << 20, timeout=60, device="cpu")[0]


def _region(env, nbytes: int) -> int:
    return env.arena.create(f"w{uuid.uuid4().hex[:8]}", nbytes).offset


# --------------------------------------------------------------------------
# every surface that spins: a wait that cannot complete raises
# TimeoutError with its own message
# --------------------------------------------------------------------------

def _request_wait(env):
    env.comm.irecv(0, tag=5).wait(timeout=T)


def _recv_into(env):
    env.comm.recv_into(0, bytearray(8), tag=5, timeout=T)


def _send(env):
    # eager sends to a rank that never receives, until its queue is full
    for _ in range(9):
        env.comm.send(1, bytes(4000), tag=5, timeout=T)


def _coll_wait(env):
    env.comm.ibarrier().wait(timeout=T)


def _waitall(env):
    env.comm.waitall([env.comm.irecv(0, tag=5)], timeout=T)


def _waitany(env):
    env.comm.waitany([env.comm.irecv(0, tag=5)], timeout=T)


def _persistent_wait(env):
    env.comm.recv_init(0, bytearray(8), tag=5).start().wait(timeout=T)


def _wait_notify(env):
    env.comm.win_allocate("w", 256).wait_notify(0, timeout=T)


def _seq_barrier(env):
    SeqBarrier(env.arena.view, _region(env, SeqBarrier.region_bytes(2)),
               2, 0, initialize=True).wait(timeout=T)


def _pscw_wait(env):
    PSCW(env.arena.view, _region(env, PSCW.region_bytes(2)), 2, 0,
         initialize=True).wait([1], timeout=T)


def _pscw_start(env):
    PSCW(env.arena.view, _region(env, PSCW.region_bytes(2)), 2, 0,
         initialize=True).start([1], timeout=T)


def _bakery_pair(env):
    v, off = env.arena.view, _region(env, BakeryLock.region_bytes(2))
    return (BakeryLock(v, off, 2, 0, initialize=True),
            BakeryLock(v, off, 2, 1))


def _bakery_ticket(env):
    mine, theirs = _bakery_pair(env)
    theirs.acquire()
    mine.acquire(timeout=T)


def _bakery_choosing(env):
    mine, _ = _bakery_pair(env)
    env.arena.view.nt_store_u8(mine.base + 1, 1)    # rank 1 mid-choosing
    mine.acquire(timeout=T)


def _rwlock(env):
    v, off = env.arena.view, _region(env, RWLock.region_bytes(2))
    mine = RWLock(v, off, 2, 0, initialize=True)
    theirs = RWLock(v, off, 2, 1)
    theirs.acquire_shared()
    try:
        mine.acquire_excl(timeout=T)
    finally:
        # the writer gave the bakery back when it gave up
        theirs.bakery.acquire(timeout=T)


def _queue(env, producer: bool) -> SPSCQueue:
    return SPSCQueue(env.arena.view, _region(env, 1 << 12), 64, 2,
                     producer=producer, initialize=True)


def _dequeue(env):
    _queue(env, False).dequeue(timeout=T)


def _dequeue_into(env):
    _queue(env, False).dequeue_into(bytearray(64), timeout=T)


def _enqueue(env):
    q = _queue(env, True)
    for _ in range(3):                  # two cells: the third never fits
        q.enqueue(b"x", timeout=T)


SURFACES = {
    "Request.wait": (1, _request_wait, "recv request timed out"),
    "recv_into": (1, _recv_into, "recv_into(src=0, tag=5)"),
    "send": (2, _send, "send(dest=1, tag=5)"),
    "CollRequest.wait": (2, _coll_wait, "collective barrier timed out"),
    "waitall": (1, _waitall, "waitall: 1 pending"),
    "waitany": (1, _waitany, "waitany: no request completed"),
    "PersistentRequest.wait": (1, _persistent_wait,
                               "recv request timed out"),
    "Window.wait_notify": (1, _wait_notify,
                           "wait_notify: 0/1 notifications from rank 0"),
    "SeqBarrier.wait": (1, _seq_barrier,
                        "barrier timeout: rank 1 stuck below seq 1"),
    "PSCW.wait": (1, _pscw_wait, "PSCW wait: origin 1"),
    "PSCW.start": (1, _pscw_start, "PSCW start: target 1"),
    "BakeryLock.acquire-ticket": (1, _bakery_ticket, "bakery: ticket stuck"),
    "BakeryLock.acquire-choosing": (1, _bakery_choosing,
                                    "bakery: choosing stuck"),
    "RWLock.acquire_excl": (1, _rwlock, "RWLock: reader stuck"),
    "SPSCQueue.dequeue": (1, _dequeue, "SPSC dequeue timed out"),
    "SPSCQueue.dequeue_into": (1, _dequeue_into, "SPSC dequeue timed out"),
    "SPSCQueue.enqueue": (1, _enqueue, "SPSC enqueue timed out"),
}


@pytest.mark.parametrize("surface", list(SURFACES))
def test_a_wait_that_cannot_complete_times_out_with_its_message(surface):
    n, prog, message = SURFACES[surface]

    def case(env):
        t0 = time.monotonic()
        with pytest.raises(TimeoutError) as e:
            prog(env)
        return str(e.value), time.monotonic() - t0

    got, took = _on_rank0(n, case)
    assert got == message
    assert T <= took < T + 10.0


# --------------------------------------------------------------------------
# the four request kinds, mixed
# --------------------------------------------------------------------------

def _mixed(env):
    c, peer = env.comm, 1 - env.rank
    got, pgot = torch.empty(64), torch.empty(32)
    ps = c.send_init(peer, torch.full((32,), 10.0 + env.rank), tag=2)
    pr = c.recv_init(peer, pgot, tag=2)
    pc = c.allreduce_init(torch.ones(16))
    out = []
    for how in ("waitall", "waitany", "testall"):
        reqs = [c.isend(peer, torch.full((64,), float(env.rank)), tag=1),
                c.irecv_into(peer, got, tag=1),
                c.iallreduce(torch.full((8,), 1.0 + env.rank)),
                ps.start(), pr.start(), pc.start()]
        assert [type(r) for r in reqs] == [
            Request, Request, CollRequest, PersistentRequest,
            PersistentRequest, PersistentCollRequest]
        if how == "waitall":
            c.waitall(reqs)
        elif how == "waitany":
            left, order = list(reqs), []
            while left:
                i, r = c.waitany(left)
                assert r is left[i] and r.done and r.error is None
                left.pop(i)
                order.append(next(k for k, q in enumerate(reqs) if q is r))
            assert sorted(order) == list(range(6))
        else:
            deadline = time.monotonic() + 30.0
            while not c.testall(reqs):
                assert time.monotonic() < deadline
        assert all(r.done and r.error is None for r in reqs)
        out.append((got.tolist(), reqs[2].wait().tolist(), pgot.tolist(),
                    pc.wait().tolist(), ps.wait(), pr.wait()))
    for r in (ps, pr, pc):
        r.free()
    return out


def test_waitall_waitany_testall_mix_the_four_request_kinds():
    res = PORT.run_threads(2, _mixed, pool_bytes=8 << 20, timeout=60,
                           device="cpu")
    for rank, out in enumerate(res):
        peer = 1 - rank
        assert out == [([float(peer)] * 64, [3.0] * 8,
                        [10.0 + peer] * 32, [2.0] * 16, 128, 128)] * 3


def test_a_persistent_request_not_started_says_so():
    def case(env):
        msgs = []
        for r in (env.comm.recv_init(0, bytearray(8), tag=5),
                  env.comm.allreduce_init(torch.ones(4))):
            for poll in (lambda: r.done, r.test, r.wait,
                         lambda: env.comm.waitall([r])):
                with pytest.raises(RuntimeError) as e:
                    poll()
                msgs.append(str(e.value))
        return msgs

    assert _on_rank0(1, case) == ["persistent request not started"] * 4 \
        + ["persistent collective not started"] * 4


# --------------------------------------------------------------------------
# the primitive
# --------------------------------------------------------------------------

class _Recorder:
    enabled = True

    def __init__(self):
        self.waits = []

    def add_waits(self, span, yields, ticks):
        self.waits.append((span, yields, ticks))


def test_spin_tries_first_counts_its_yields_and_records_them_however_it_ends():
    tr = _Recorder()
    assert wait.spin(lambda: True, 0.0, lambda: "never", tr, 3) == 0
    left = iter([False, False, True])
    assert wait.spin(lambda: next(left), None, lambda: "never", tr, 4) == 2
    calls = []

    def slow_third() -> bool:          # the third try outlasts the timeout
        calls.append(1)
        if len(calls) == 3:
            time.sleep(0.6)
        return False

    with pytest.raises(TimeoutError, match="^stuck$"):
        wait.spin(slow_third, 0.5, lambda: "stuck", tr, 5)
    with pytest.raises(KeyError):
        wait.spin(lambda: {}[0], 1.0, lambda: "never", tr, 6)
    wait.spin(lambda: True, 1.0, lambda: "never", tr, -1)   # no span
    assert tr.waits == [(3, 0, 1), (4, 2, 3), (5, 2, 3), (6, 0, 1)]


def test_one_request_base_and_one_bakery():
    """The four request kinds share ``Waitable``; the pt2pt and
    collective requests inherit its ``wait``; ``_req_done`` reads the
    base's state and nothing else; the arena locks with ``BakeryLock``."""
    for cls in (Request, CollRequest, PersistentRequest,
                PersistentCollRequest):
        assert issubclass(cls, wait.Waitable)
    assert "wait" not in vars(Request) and "wait" not in vars(CollRequest)
    src = ast.parse((CORE / "progress.py").read_text())
    fn = next(nd for nd in ast.walk(src) if isinstance(nd, ast.FunctionDef)
              and nd.name == "_req_done")
    assert not any(isinstance(nd, ast.Name) and nd.id == "getattr"
                   for nd in ast.walk(fn))
    assert not hasattr(Arena, "_lock") and not hasattr(Arena, "_unlock")
    assert "_SPIN_SLEEP" not in (CORE / "sync.py").read_text()


def test_the_arena_lock_is_the_references_bakery():
    """A reference rank holding its arena's lock keeps a port rank's
    arena out, and the port's ticket lands in the reference's word."""
    name = f"wl{os.getpid()}{uuid.uuid4().hex[:8]}"
    ref_pool = RefShm(1 << 20, name=name, create=True)
    port_pool = SharedMemoryPool(0, name=name, create=False, device="cpu")
    try:
        ref = RefArena(ref_pool, 0, initialize=True)
        port = Arena(port_pool, 1, initialize=False)
        ref._lock()
        with pytest.raises(TimeoutError, match="bakery: ticket stuck"):
            port._bakery.acquire(timeout=T)
        ref._unlock()
        port._bakery.acquire(timeout=T)
        assert ref.view.nt_load_u64(REF_BAKERY_NUMBER + 8) > 0
        port._bakery.release()
        assert ref.view.nt_load_u64(REF_BAKERY_NUMBER + 8) == 0
        h = port.create("o", 100)
        assert ref.open("o").offset == h.offset
    finally:
        port_pool.close()
        ref_pool.close()
        ref_pool.unlink()


# --------------------------------------------------------------------------
# nothing else in core/ sleeps
# --------------------------------------------------------------------------

def _sleep_sites(path: Path) -> list:
    """(file, enclosing function) of every ``time.sleep``/``sleep`` call."""
    out = []

    def walk(node, fn):
        for ch in ast.iter_child_nodes(node):
            inner = ch.name if isinstance(
                ch, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            if isinstance(ch, ast.Call):
                f = ch.func
                if (isinstance(f, ast.Attribute) and f.attr == "sleep") \
                        or (isinstance(f, ast.Name) and f.id == "sleep"):
                    out.append((path.name, fn))
            walk(ch, inner)

    walk(ast.parse(path.read_text()), None)
    return out


def test_only_the_spin_the_open_poll_and_the_retract_fence_sleep():
    sites = sorted(s for p in sorted(CORE.glob("*.py"))
                   for s in _sleep_sites(p))
    assert sites == [("pt2pt.py", "_mb_retract"), ("pt2pt.py", "_open_poll"),
                     ("wait.py", "spin")]


def test_the_linter_holds_the_spin_to_a_bare_yield():
    from repro_torch.analysis import lint_protocol as lint
    src = ("import time\n"
           "def spin(ready):\n"
           "    while not ready():\n"
           "        time.sleep(0)\n"
           "        time.sleep(0.001)\n")
    assert [(f.rule, f.line) for f in
            lint.lint_sources({"x/wait.py": src})] == [("LP003", 5)]
    assert lint.lint_paths([str(CORE)]) == []
