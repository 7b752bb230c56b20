"""The port's tracer spans (``repro_torch.core.trace``): every message's
spans carry one id on both ranks on the eager, staged and posted paths,
with their parents, and the send, the wake-up and the delivery tile the
message's life; a collective call's spans carry one id on its members,
and the time before the last member enters is the others' wait; spans
are exported on the epoch clock; an off tracer records nothing; the
storage counts what it drops; LP005 holds the span and sync-timing
sites to the guard; the serve path's spans nest. On the CPU, ranks as
``run_threads`` threads, each with its own tracer."""
import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import lint_protocol as lint  # noqa: E402
from repro_torch.core import run_threads  # noqa: E402
from repro_torch.core.trace import (NULL_TRACER, SP_COPY,  # noqa: E402
                                    SPAN_FIELDS, Tracer, as_tracer)

F = {k: i for i, k in enumerate(SPAN_FIELDS)}
EAGER, CELL = 4096, 4096
SIZES = {"eager": 512, "staged": 3 * CELL, "posted": 3 * CELL}


def _rows(tr: Tracer) -> list[tuple]:
    """The tracer's spans with their times back on the monotonic clock
    (the ranks are threads of one process: one clock, two anchors)."""
    off = tr.epoch_offset_ns
    return [r[:1] + (r[1] - off, r[2] - off if r[2] else 0) + r[3:]
            for r in tr.span_rows()]


def _exchange(env, path: str, n: int = 3):
    c, peer = env.comm, 1 - env.rank
    size = SIZES[path]
    c.tracer.start()
    for i in range(n):
        x = torch.full((size,), i + 1, dtype=torch.uint8)
        if path == "posted":
            # the receive is posted (a pool-resident destination in the
            # matchbox) before the sender looks for it
            pb = c.alloc_buffer(size)
            if env.rank == 1:
                req = c.irecv_into(0, pb, tag=7)
            c.barrier()
            if env.rank == 0:
                c.send(1, x, tag=7)
            else:
                req.wait()
                assert bytes(pb.read()) == bytes(x.numpy())
            c.barrier()
            pb.free()
            continue
        got = torch.empty_like(x)
        if env.rank == 0:
            c.send(peer, x, tag=7)
            c.recv_into(peer, got, tag=8)
        else:
            c.recv_into(peer, got, tag=7)
            c.send(peer, got, tag=8)
        assert torch.equal(got, x)
    c.barrier()
    # a staged sender sees its acks while it progresses
    c.progress()
    c.tracer.stop()
    return _rows(c.tracer), c.posted_sends


@pytest.mark.parametrize("path", ["eager", "staged", "posted"])
def test_each_message_has_one_id_parents_and_a_tiled_life(path):
    out = run_threads(2, lambda env: _exchange(env, path), pool_bytes=16 << 20,
                      cell_size=CELL, eager_threshold=EAGER,
                      comm_kw={"matchbox_slots": 4}, timeout=120,
                      device="cpu")
    rows = {r: out[r][0] for r in (0, 1)}
    if path == "posted":
        assert out[0][1] == 3
    msgs = {}
    for r in (0, 1):
        for i, row in enumerate(rows[r]):
            name = row[F["name"]]
            if name in ("pt2pt.send", "pt2pt.recv"):
                key = (row[F["comm"]], row[F["src"]], row[F["dst"]],
                       row[F["seq"]])
                assert name not in msgs.setdefault(key, {}), key
                msgs[key][name] = (r, i)
    directions = [(0, 1)] + ([] if path == "posted" else [(1, 0)])
    want = {("world", s, d, q) for s, d in directions for q in range(3)}
    assert set(msgs) == want
    for key, got in msgs.items():
        assert set(got) == {"pt2pt.send", "pt2pt.recv"}
        sr, si = got["pt2pt.send"]
        rr, ri = got["pt2pt.recv"]
        assert (sr, rr) == (key[1], key[2])
        send, recv = rows[sr][si], rows[rr][ri]
        assert send[F["path"]] == path and send[F["bytes"]] == SIZES[path]
        assert recv[F["bytes"]] == SIZES[path]
        kids = {}
        for row in rows[rr]:
            if row[F["parent"]] == ri:
                kids[row[F["name"]]] = row
        wait, deliver = kids["pt2pt.wait"], kids["pt2pt.deliver"]
        for k in (wait, deliver):
            assert k[F["seq"]] == key[3] and k[F["src"]] == key[1]
        # send, wake-up and delivery tile the life, to the nanosecond
        wake = deliver[F["start_ns"]] - send[F["end_ns"]]
        life = deliver[F["end_ns"]] - send[F["start_ns"]]
        assert wake >= 0
        assert (send[F["end_ns"]] - send[F["start_ns"]]) + wake \
            + (deliver[F["end_ns"]] - deliver[F["start_ns"]]) == life
        assert wait[F["end_ns"]] == deliver[F["start_ns"]]
        assert recv[F["end_ns"]] == deliver[F["end_ns"]]
        assert recv[F["start_ns"]] <= wait[F["start_ns"]]
        assert recv[F["ticks"]] >= 1 and send[F["ticks"]] >= 1
        dk = [row for row in rows[rr]
              if row[F["parent"]] == rows[rr].index(deliver)]
        sk = [row for row in rows[sr] if row[F["parent"]] == si]
        if path == "staged":
            # the receiver's ack store, the sender's stager and its sight
            # of the ack, each carrying the message's id
            assert [row[F["name"]] for row in dk] == ["pt2pt.ack"]
            names = sorted(row[F["name"]] for row in sk)
            assert names == ["arena.create", "arena.destroy",
                             "pt2pt.ack_seen"]
            for row in dk + sk:
                assert row[F["seq"]] == key[3]
            seen = next(row for row in sk
                        if row[F["name"]] == "pt2pt.ack_seen")
            assert seen[F["start_ns"]] >= dk[0][F["start_ns"]]
        else:
            assert not dk and not sk


def test_peer_wait_is_the_time_before_the_last_member_enters():
    # rank 3 enters 50 ms after the other three are inside the call
    # (each rank's second span: the barrier's, then the allreduce's);
    # the ranks are threads, so rank 3 can watch their tracers
    tracers = {}

    def prog(env):
        c = env.comm
        tracers[env.rank] = c.tracer
        c.tracer.start()
        c.barrier()
        if env.rank == 3:
            while any(tracers[r].span_counters()["spans_kept"] < 2
                      for r in range(3)):
                time.sleep(0.0005)
            time.sleep(0.05)
        c.allreduce(torch.ones(64))
        c.tracer.stop()
        return [r for r in _rows(c.tracer) if r[F["name"]] ==
                "coll.allreduce"]

    out = run_threads(4, prog, pool_bytes=16 << 20, cell_size=CELL,
                      timeout=120, device="cpu")
    calls = [rows[0] for rows in out]
    assert all(len(rows) == 1 for rows in out)
    # the barrier was call 0 on "world", the allreduce call 1
    assert {(r[F["comm"]], r[F["seq"]]) for r in calls} == {("world", 1)}
    assert all(r[F["bytes"]] == 256 for r in calls)
    last = max(r[F["start_ns"]] for r in calls)
    wait = [min(last, r[F["end_ns"]]) - r[F["start_ns"]] for r in calls]
    assert min(wait[:3]) >= 45e6
    assert wait[3] == 0


def test_sub_communicators_record_on_the_world_tracer():
    """``start`` on the world's tracer reaches its ``split`` children;
    a non-blocking call's span ends when ``wait`` returns its result;
    its messages are its children."""
    def prog(env):
        c = env.comm
        sub = c.split(env.rank % 2)
        assert sub.tracer is c.tracer
        c.tracer.start()
        req = sub.iallreduce(torch.ones(8))
        time.sleep(0.01)
        req.wait()
        t_back = time.monotonic_ns()
        c.tracer.stop()
        return _rows(c.tracer), t_back

    out = run_threads(4, prog, pool_bytes=16 << 20, cell_size=CELL,
                      timeout=120, device="cpu")
    names = set()
    for rows, t_back in out:
        (i, call), = [(i, r) for i, r in enumerate(rows)
                      if r[F["name"]] == "coll.iallreduce"]
        assert call[F["comm"]] != "world" and call[F["seq"]] == 0
        names.add(call[F["comm"]])
        assert call[F["end_ns"]] - call[F["start_ns"]] >= 10e6
        assert call[F["end_ns"]] <= t_back
        kids = [r for r in rows if r[F["parent"]] == i]
        assert {r[F["name"]] for r in kids} == {"pt2pt.send", "pt2pt.recv"}
        assert all(r[F["comm"]] == call[F["comm"]] for r in kids)
    assert len(names) == 2


def test_a_span_is_exported_on_the_epoch_clock():
    tr = Tracer(enabled=False)
    tr.start()
    a = time.time_ns()
    time.sleep(0.002)
    i = tr.open_span(SP_COPY, nbytes=8)
    time.sleep(0.002)
    tr.close_span(i)
    time.sleep(0.002)
    b = time.time_ns()
    (row,) = tr.span_rows()
    assert row[0] == "pool.copy" and row[F["bytes"]] == 8
    assert a < row[F["start_ns"]] < row[F["end_ns"]] < b
    assert row[F["end_ns"]] - row[F["start_ns"]] >= 2e6


def test_storage_grows_and_counts_what_it_drops():
    tr = Tracer(capacity=4, span_capacity=40000)
    tr.start()
    for _ in range(40000):
        tr.close_span(tr.open_span(SP_COPY))
    assert tr.span_counters()["spans_kept"] == 40000
    assert tr.spans_dropped == 0
    assert tr.open_span(SP_COPY) == -1
    assert tr.span_counters()["spans_dropped"] == 1
    tr.start(capacity=64)                      # a new window: empty again
    assert tr.capacity == 64 and tr.span_rows() == []
    assert tr.spans_dropped == 0


class _Counting(Tracer):
    """A tracer that counts every call of its recording methods."""

    CALLS = ("emit", "open_span", "open_child", "close_span", "push_span",
             "pop_span", "leave_span", "mark", "add_waits", "end_send",
             "dequeued", "recv_done", "staged", "ack_seen", "synced",
             "send_seq", "call_seq")

    def __init__(self):
        super().__init__(capacity=16, enabled=False)
        self.calls = 0
        for name in self.CALLS:
            fn = getattr(self, name)

            def counted(*a, _fn=fn, **k):
                self.calls += 1
                return _fn(*a, **k)
            setattr(self, name, counted)


def test_an_off_tracer_records_nothing():
    rec = _Counting()

    def prog(env):
        c = env.comm
        assert c.tracer is rec and env.arena.view.tracer is rec
        peer = 1 - env.rank
        for n in (64, 3 * CELL):
            x = torch.ones(n, dtype=torch.uint8)
            if env.rank == 0:
                c.waitall([c.isend(peer, x, tag=1)])
                c.recv_into(peer, torch.empty_like(x), tag=2)
            else:
                c.recv_into(peer, torch.empty_like(x), tag=1)
                c.send(peer, x, tag=2)
        c.allreduce(torch.ones(1024))
        c.iallreduce(torch.ones(8)).wait()
        c.alltoall([torch.ones(4), torch.ones(4)])
        c.barrier()
        return True

    assert all(run_threads(2, prog, pool_bytes=16 << 20, cell_size=CELL,
                           comm_kw={"trace": rec}, timeout=120,
                           device="cpu"))
    assert rec.calls == 0
    assert rec.span_rows() == [] and rec.recorded == 0
    assert as_tracer(None, 0).enabled is False and not NULL_TRACER.enabled


SPAN_SRC = ("def f(self, n):\n"
            "    tr = self.tracer\n"
            "    sp = tr.open_span(1, tr.cur)\n"
            "    if tr.enabled:\n"
            "        tr.close_span(sp)\n"
            "        tr.mark(2, {'n': n})\n"
            "    tr.synced(sp, 0)\n"
            "    tr.emit(1, 0, 0, 0)\n")


@pytest.mark.parametrize("fname", ["comm.py", "coherence.py", "pool.py",
                                   "pt2pt.py", "progress.py", "rma.py",
                                   "wait.py"])
def test_lp005_holds_span_and_sync_sites_to_the_guard(fname):
    found = [(f.rule, f.line) for f in
             lint.lint_sources({f"x/{fname}": SPAN_SRC})]
    spans = [("LP005", 3), ("LP005", 6), ("LP005", 7)]
    want = {"comm.py": spans, "coherence.py": spans, "pool.py": spans,
            "wait.py": spans, "pt2pt.py": spans + [("LP005", 8)],
            "progress.py": spans + [("LP005", 8)], "rma.py": []}[fname]
    assert found == want


def test_serve_path_spans_nest_under_the_step():
    """``moe_apply_ep``'s three phases are spans of the mesh's tracer,
    the combine's sum over ``model`` a collective under the last."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import DistContext
    from repro_torch.models import blocks as B
    from repro_torch.core.trace import SP_DECODE

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              compute_dtype="float32")
    params = B.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))

    def prog(env):
        dist = DistContext(env.comm, (2, 2), ("data", "model"))
        tr = dist.tracer
        assert tr is env.comm.tracer
        tr.start()
        sp = tr.push_span(SP_DECODE)
        B.moe_apply_ep(params, cfg, x, dist)
        tr.pop_span(sp)
        tr.stop()
        return _rows(tr)

    for rows in run_threads(4, prog, pool_bytes=32 << 20, cell_size=CELL,
                            timeout=120, device="cpu"):
        names = [r[F["name"]] for r in rows]
        top = names.index("serve.decode")
        phases = [i for i, r in enumerate(rows) if r[F["parent"]] == top]
        assert [names[i] for i in phases] == [
            "moe.dispatch", "moe.experts", "moe.combine"]
        call = names.index("coll.allreduce")
        assert rows[call][F["parent"]] == phases[2]
        assert rows[call][F["comm"]] != "world"
