"""The trace CLI (``python -m repro_torch.trace``) against the JAX
package's ``repro.trace``: on the per-rank dumps of a 2-rank traced
exchange over the port's ``run_threads``, both CLIs write the same
merged Chrome trace and print the same summary, and a missing dump
exits 1 in both."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import trace as ref_trace  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.core import run_threads  # noqa: E402

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
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    assert trace.main(["merge", *dumps, "-o", str(ours)]) == 0
    assert ref_trace.main(["merge", *dumps, "-o", str(theirs)]) == 0
    assert ours.read_text() == theirs.read_text()
    evs = json.loads(ours.read_text())["traceEvents"]
    assert {e["pid"] for e in evs if e["ph"] != "M"} == {0, 1}
    out = capsys.readouterr().out
    assert "merged 2 rank dump(s)" in out


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
