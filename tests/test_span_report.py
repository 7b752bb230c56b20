"""What the program's own spans read in a benchmark run
(``tools/program_spans.py``): each reading's arithmetic on reports made
by hand; and, in a process of its own (the benchmark refuses to run
beside JAX), traced CPU runs of the benchmark's tiny ping-pong, stream
and decode that read what each cell has to read with nothing dropped,
and an untraced run whose reports hold no program spans."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ROOT / "tools"
sys.path.insert(0, str(TOOLS))

import program_spans as S  # noqa: E402

SEED = 2 ** 31 + 91
MESSAGE_READINGS = ("hop_send_us", "hop_wake_us", "hop_recv_us",
                    "sync_us_per_msg")


def row(name, t0, t1, parent=-1, comm="world", src=-1, dst=-1, seq=-1,
        nbytes=0, path=""):
    return (name, t0, t1, parent, comm, src, dst, seq, nbytes, 0, 0, path)


def rank(rows, t0_ns=0, seconds=1.0, **kw):
    return dict(program_spans=rows, t0_ns=t0_ns, seconds=seconds,
                program_counters={"sync_ns": 0}, **kw)


def message(src, dst, seq, t, send, wake, recv):
    """A message's rows on its two ranks: sent at ``t`` for ``send`` ns,
    dequeued ``wake`` ns after the commit, delivered in ``recv`` ns."""
    a, b = t, t + send
    c, d = b + wake, b + wake + recv
    out = [row("pt2pt.send", a, b, src=src, dst=dst, seq=seq)]
    into = [row("pt2pt.recv", a, d, src=src, dst=dst, seq=seq),
            row("pt2pt.wait", a, c, 0, src=src, dst=dst, seq=seq),
            row("pt2pt.deliver", c, d, 0, src=src, dst=dst, seq=seq)]
    return out, into


def test_hop_readings_join_both_directions_by_id():
    r0, r1 = [], []
    # (send, wake, recv) in us for three pings and two pongs
    for seq, (s, w, v) in enumerate([(100, 50, 300), (200, 60, 310),
                                     (300, 70, 320)]):
        out, into = message(0, 1, seq, 10_000 * seq + 1000, s * 1000,
                            w * 1000, v * 1000)
        r0 += out
        base = len(r1)
        r1 += [x if x[0] == "pt2pt.recv" else x[:3] + (base,) + x[4:]
               for x in into]
    for seq, (s, w, v) in enumerate([(400, 80, 330), (500, 90, 340)]):
        out, into = message(1, 0, seq, 10_000 * seq + 5000, s * 1000,
                            w * 1000, v * 1000)
        r1 += out
        r0 += into
    run = {"reports": [rank(r0, messages_received=2),
                       rank(r1, messages_received=3)]}
    run["reports"][0]["program_counters"]["sync_ns"] = 600_000
    run["reports"][1]["program_counters"]["sync_ns"] = 400_000
    assert S.hop_send_us(run) == pytest.approx(300.0)
    assert S.hop_wake_us(run) == pytest.approx(70.0)
    assert S.hop_recv_us(run) == pytest.approx(320.0)
    # 1 ms of syncs over 5 messages received
    assert S.sync_us_per_msg(run) == pytest.approx(200.0)


def test_a_message_sent_outside_the_window_is_left_out():
    out, into = message(0, 1, 0, 2_000_000_000, 1000, 1000, 1000)
    run = {"reports": [rank(out), rank(into)]}
    assert S.hop_send_us(run) is None


def test_copy_share_of_staged_messages():
    # message 0: life 0..1000 us; copies on the sender 100..200 and on
    # the receiver 500..650 (the receiver's, under its deliver span)
    send = row("pt2pt.send", 0, 300_000, src=0, dst=1, seq=0, path="staged")
    r0 = [send, row("pool.copy", 100_000, 200_000, 0),
          row("pool.sync", 150_000, 200_000, 1),
          row("pt2pt.ack_seen", 1_000_000, 1_000_000, 0, src=0, dst=1,
              seq=0)]
    r1 = [row("pt2pt.recv", 0, 700_000, src=0, dst=1, seq=0),
          row("pt2pt.deliver", 400_000, 700_000, 0, src=0, dst=1, seq=0),
          row("pool.copy", 500_000, 650_000, 1),
          # another message's copy is not this one's
          row("pool.copy", 300_000, 350_000, -1)]
    run = {"reports": [rank(r0), rank(r1)]}
    assert S.rndv_copy_share(run) == pytest.approx(25.0)


def test_peer_wait_share_by_call_id():
    # call 0 of comm "m": entries at 0, 10 and 40 us, all end at 50 us:
    # waits 40 + 30 + 0 over spans 50 + 40 + 10; call 0 of "d": no wait
    ranks = [[row("coll.allreduce", 0, 50_000, comm="m", seq=0),
              row("coll.allgather", 60_000, 70_000, comm="d", seq=0)],
             [row("coll.allreduce", 10_000, 50_000, comm="m", seq=0),
              row("coll.allgather", 60_000, 70_000, comm="d", seq=0)],
             [row("coll.allreduce", 40_000, 50_000, comm="m", seq=0)]]
    run = {"reports": [rank(r) for r in ranks]}
    assert S.coll_peer_wait_share(run) == pytest.approx(100.0 * 70 / 120)


@pytest.mark.parametrize("name", sorted(S.READINGS))
def test_readings_are_silent_without_the_program_spans(name):
    run = {"reports": [{"t0_ns": 0, "seconds": 1.0, "messages_received": 1}]}
    assert S.READINGS[name](run) is None


def test_sync_per_message_is_silent_where_no_message_is_counted():
    # a serving cell's reports count tokens, not messages
    run = {"reports": [rank([]), rank([])]}
    assert S.sync_us_per_msg(run) is None


def test_innermost_segments():
    rows = [row("a", 0, 100), row("b", 10, 50, 0), row("c", 20, 30, 1),
            row("d", 40, 120), row("e", 60, 70, 3), row("i", 80, 80)]
    assert S.innermost(rows) == [
        ("a", 0, 10), ("b", 10, 20), ("c", 20, 30), ("b", 30, 40),
        ("d", 40, 60), ("e", 60, 70), ("d", 70, 120)]


RUNS = """
import json, sys
from pathlib import Path
sys.path[:0] = [{tools!r}]
import span_report
from cmpibench.tests.cpu_cells import make_root
root = make_root(Path({tmp!r}))
out = {{c: span_report.report(c, {seed}, 1.0, root, "cpu")
        for c in ("osu.tiny-pingpong", "osu.tiny-stream",
                  "granite.tiny-decode")}}
_, run = span_report.recorded_run("osu.tiny-pingpong", {seed}, 1.0, False,
                                  root, "cpu")
out["untraced"] = [sorted(r) for r in run["reports"]]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cpu_runs(tmp_path_factory):
    code = RUNS.format(tools=str(TOOLS), seed=SEED,
                       tmp=str(tmp_path_factory.mktemp("spans")))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,names", [
    ("osu.tiny-pingpong", MESSAGE_READINGS),
    ("osu.tiny-stream", MESSAGE_READINGS + ("rndv_copy_share",)),
    ("granite.tiny-decode", ("coll_peer_wait_share",))])
def test_traced_cpu_runs_read_the_program_spans(cpu_runs, cell, names):
    got = cpu_runs[cell]
    assert got["correct"]
    for name in names:
        assert isinstance(got["readings"][name], float), name
    for c in got["counters"]:
        assert c["spans_dropped"] == 0 and c["spans_kept"] > 0
    # the program's spans label the idle gaps (no card here: none) and
    # tile rank 0's window with names of the program
    assert any(k.startswith(("pt2pt.", "pool.", "progress.", "coll."))
               for k in got["host_time_rank0"])


def test_an_untraced_run_records_no_program_spans(cpu_runs):
    for keys in cpu_runs["untraced"]:
        assert "program_spans" not in keys
        assert "program_counters" not in keys
