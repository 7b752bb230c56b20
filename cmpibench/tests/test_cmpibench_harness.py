"""The harness finds every cell's configuration, mix and metrics by name,
BENCHMARK.json keeps to its contract's shape, and a configuration, a mix
and a metric can be added as new files and entries alone."""
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from cmpibench import harness
from cmpibench.tests.tiny_cells import make_root

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_resolves_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    system, loop = c["conf"]["system"], c["traffic"]["loop"]
    assert (ROOT / "cmpibench" / "systems" / system / f"{loop}.py").exists()
    for trace in (False, True):
        ms = harness.cell_metrics(BENCH, cell, trace)
        assert ms
        for m in ms:
            assert (ROOT / "cmpibench" / "metrics"
                    / f"{m['name']}.py").exists()
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in harness.cell_metrics(BENCH, cell, True):
        assert m["moves"] in e2e


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {"serve step", "collectives and progress", "pt2pt",
              "pool plane", "kernels", "device"}        # PERF.md section 3
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["layer"] in layers
    assert len(json.dumps(BENCH)) < 64 * 1024


def _hashes(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


DRIVE = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from cmpibench.harness import run_cell
if __name__ == "__main__":
    out = run_cell(sys.argv[3], 5, 1.0, bool(int(sys.argv[4])),
                   device="cpu")
    out.pop("_detail")
    print(json.dumps(out))
"""


def drive(root: Path, cell: str, trace: int) -> dict:
    script = root / "drive.py"
    script.write_text(DRIVE)
    p = subprocess.run([sys.executable, str(script), str(root),
                        str(ROOT / "src"), cell, str(trace)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_configuration_a_mix_and_a_metric_added_as_files(tmp_path):
    """A configuration, a mix of a new kind (its rank program a new module
    of the system's package) and a metric, as new files and entries."""
    root = make_root(tmp_path / "repo")
    before = _hashes(root / "cmpibench")
    b = root / "cmpibench"
    conf = json.loads((b / "configs" / "osu-tiny.json").read_text())
    conf["comm"]["cell_size"] = 8192
    (b / "configs" / "osu-extra.json").write_text(json.dumps(conf))
    mix = json.loads((b / "traffic" / "tiny-pingpong.json").read_text())
    mix["sizes"] = [8, 8192, 16384]
    mix["loop"] = "extra_loop"
    (b / "traffic" / "extra-mix.json").write_text(json.dumps(mix))
    (b / "systems" / "osu" / "extra_loop.py").write_text(
        "from cmpibench.systems.osu import check\n"
        "from cmpibench.systems.osu.pingpong import rank_main as pingpong\n"
        "__all__ = ['rank_main', 'check']\n\n\n"
        "def rank_main(env, spec):\n"
        "    rep = pingpong(env, spec)\n"
        "    rep['extra_loop'] = rep['round_trips'] * 2\n"
        "    return rep\n")
    (b / "metrics" / "round_trips.extra.py").write_text(
        "def read(run):\n"
        "    return float(run['reports'][0]['extra_loop'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "osu-extra", "source": "test",
                             "file": "cmpibench/configs/osu-extra.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "extra.cell", "config": "osu-extra",
                               "traffic": "extra-mix", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "latency_p50_us":
            m["workloads"].append("extra.cell")
    bench["per_layer"].append({
        "name": "round_trips.extra", "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "pt2pt",
        "moves": "latency_p50_us", "workloads": ["extra.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _hashes(b)
    assert {k: after[k] for k in before} == before   # nothing edited
    out = drive(root, "extra.cell", 0)
    assert out["correct"] and "latency_p50_us" in out["metrics"]
    assert "setup_s" in out["metrics"]
    out = drive(root, "extra.cell", 1)
    assert out["correct"]
    assert out["metrics"]["round_trips.extra"]["value"] > 0
    assert list(out)[-1] == "checks"


def test_no_card_no_result():
    p = subprocess.run([sys.executable, str(ROOT / "cmpibench" / "run.py"),
                        "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert p.returncode != 0 and not p.stdout.strip()
    assert "CUDA device" in p.stderr
