"""The trace CLI (``python -m repro_torch.trace``) against the JAX
package's ``repro.trace``: on the per-rank dumps of a 2-rank traced
exchange over the port's ``run_threads``, both CLIs write the same
merged Chrome trace and print the same summary, and a missing dump
exits 1 in both."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import trace as ref_trace  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.core import run_threads  # noqa: E402
from repro_torch.core.trace import SPAN_TID_BASE  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")


def _exchange(tmp_path):
    def prog(env):
        c = env.comm
        peer = 1 - env.rank
        x = torch.arange(4096, dtype=torch.int32).to(torch.uint8)
        got = torch.empty_like(x)
        if env.rank == 0:
            c.send(peer, x, tag=1)
            c.recv_into(peer, got, tag=2)
        else:
            c.recv_into(peer, got, tag=1)
            c.send(peer, got, tag=2)
        c.allreduce(torch.ones(256))
        c.barrier()
        return c.trace_dump(tmp_path / f"rank{env.rank}.json")

    return [str(p) for p in run_threads(
        2, prog, pool_bytes=16 << 20, comm_kw={"trace": True},
        timeout=120, device="cpu")]


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    return _exchange(tmp_path_factory.mktemp("torch_trace"))


def test_merge_equals_the_reference(dumps, tmp_path, capsys):
    """Every event the reference renders, rendered alike: the port's
    merge less its span lanes is the reference's, byte for byte."""
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    assert trace.main(["merge", *dumps, "-o", str(ours)]) == 0
    assert ref_trace.main(["merge", *dumps, "-o", str(theirs)]) == 0
    evs = json.loads(ours.read_text())["traceEvents"]
    rest = [e for e in evs if e["tid"] < SPAN_TID_BASE]
    assert len(rest) < len(evs)                  # the span lanes are there
    assert json.dumps({"traceEvents": rest, "displayTimeUnit": "ms"}) \
        + "\n" == theirs.read_text()
    assert {e["pid"] for e in evs if e["ph"] != "M"} == {0, 1}
    out = capsys.readouterr().out
    assert "merged 2 rank dump(s)" in out


def test_merge_renders_the_span_lanes(dumps, tmp_path):
    """Each rank's spans are slices in lanes of their own, named, every
    lane's slices nested, on the epoch clock of the dump."""
    out = tmp_path / "ours.json"
    assert trace.main(["merge", *dumps, "-o", str(out)]) == 0
    evs = [e for e in json.loads(out.read_text())["traceEvents"]
           if e["tid"] >= SPAN_TID_BASE]
    for pid in (0, 1):
        mine = [e for e in evs if e["pid"] == pid]
        lanes = {e["tid"] for e in mine if e["ph"] == "M"}
        assert lanes and {e["tid"] for e in mine} == lanes
        names = {e["name"] for e in mine if e["ph"] == "X"}
        assert {"pt2pt.send", "pt2pt.recv", "pt2pt.wait", "pt2pt.deliver",
                "coll.allreduce", "coll.barrier"} <= names
        for tid in lanes:
            stack = []
            for e in sorted((e for e in mine if e["tid"] == tid
                             and e["ph"] == "X"),
                            key=lambda e: (e["ts"], -e["dur"])):
                # microseconds on the epoch clock carry ~0.25 us in a
                # double: nested within that
                while stack and stack[-1] <= e["ts"] + 0.5:
                    stack.pop()
                assert not stack or e["ts"] + e["dur"] <= stack[-1] + 0.5
                stack.append(e["ts"] + e["dur"])
    dump = json.loads(Path(dumps[0]).read_text())
    lo = min(s[1] for s in dump["spans"]) / 1000.0
    hi = max(s[2] for s in dump["spans"]) / 1000.0
    xs = [e for e in evs if e["pid"] == 0 and e["ph"] == "X"]
    assert lo == min(e["ts"] for e in xs)
    assert max(e["ts"] + e["dur"] for e in xs) == pytest.approx(hi)
    assert abs(lo * 1000 - time.time_ns()) < 600e9      # epoch, not uptime


@pytest.mark.parametrize("top", [3, 10])
def test_summarize_equals_the_reference(dumps, capsys, top):
    assert trace.main(["summarize", *dumps, "--top", str(top)]) == 0
    ours = capsys.readouterr().out
    assert ref_trace.main(["summarize", *dumps, "--top", str(top)]) == 0
    assert ours == capsys.readouterr().out
    assert "engine.tick" in ours


def test_missing_dump_exits_1_as_the_reference(tmp_path, capsys):
    nope = str(tmp_path / "nope.json")
    assert trace.main(["merge", nope]) == 1
    err = capsys.readouterr().err
    assert ref_trace.main(["merge", nope]) == 1
    assert err == capsys.readouterr().err
    assert "missing dump" in err


def test_module_entry_point(dumps, tmp_path):
    """``python -m repro_torch.trace`` in a process of its own."""
    out = tmp_path / "timeline.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.trace", "merge", *dumps,
         "-o", str(out)], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert json.loads(out.read_text())["traceEvents"]
