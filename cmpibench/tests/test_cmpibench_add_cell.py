"""A cell is added with new files and entries alone: every real cell has a
tiny form and every tiny form a real cell; a second hybrid system, its
configuration, a cell and the cell's tiny forms go in beside the
benchmark without a byte of a file that is there changing, and the tiny
cell runs correct on the CPU; a real cell with no tiny form is left out
of the tiny checkout and named, not raised on."""
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cmpibench.tests import tiny_cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
REAL = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 91


def _copy(dst: Path) -> Path:
    """The benchmark's folder and BENCHMARK.json under ``dst``."""
    shutil.copytree(ROOT / "cmpibench", dst / "cmpibench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def _hashes(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))


@pytest.mark.parametrize("cell", REAL)
def test_every_real_cell_has_a_tiny_form(cell):
    tiny = [f for f in tiny_cells.forms("cells").values() if f["real"] == cell]
    assert tiny, f"{cell} has no tiny cell"
    for form in tiny:
        conf = tiny_cells.forms("configs")[form["config"]]
        mix = tiny_cells.forms("traffic")[form["traffic"]]
        assert (ROOT / "cmpibench" / "configs"
                / f"{conf['from']}.json").exists()
        assert (ROOT / "cmpibench" / "traffic"
                / f"{mix['from']}.json").exists()


def test_every_tiny_form_names_a_real_cell():
    assert {f["real"] for f in tiny_cells.forms("cells").values()} \
        <= set(REAL)


ADD = """
import json, sys, warnings
from pathlib import Path
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from cmpibench.harness import run_cell
from cmpibench.tests.tiny_cells import make_root
if __name__ == "__main__":
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no cell is left out
        root = make_root(Path(sys.argv[3]))
    tiny = json.loads((root / "BENCHMARK.json").read_text())
    outs = [run_cell(sys.argv[4], int(sys.argv[5]), 1.0, trace,
                     device="cpu", root=root) for trace in (False, True)]
    for o in outs:
        o.pop("_detail")
    print(json.dumps({"bench": tiny, "runs": outs}))
"""


def test_a_hybrid_system_and_its_cell_added_as_files(tmp_path):
    """A second hybrid system (a package re-exporting ``hybrid_serve``'s
    model under a new name, with a counter of its own, and a ``serve``
    loop re-exporting its ``rank_main``), its configuration, a cell
    entered in two metrics' lists, a metric that reads the system's
    counters, and the cell's tiny forms: new files and entries only."""
    copy = _copy(tmp_path / "repo")
    b = copy / "cmpibench"
    before = _hashes(b)
    conf = json.loads((b / "configs" / "jamba2-mini-ep2.json").read_text())
    conf["system"] = "hybrid_twin"
    _write(b / "configs" / "jamba-twin.json", conf)
    _write(b / "systems" / "hybrid_twin" / "__init__.py",
           "from cmpibench.systems import hybrid_serve\n"
           "from cmpibench.systems.hybrid_serve import (  # noqa: F401\n"
           "    SPANS, check, model_config, program_params)\n"
           "COUNTERS = (*hybrid_serve.COUNTERS, 'twin.counter')\n")
    _write(b / "metrics" / "twin_counters.prefill.py",
           "def read(run):\n"
           "    got = run['reports'][0].get('program_counters') or {}\n"
           "    return float(len(got)) if 'twin.counter' in got else None\n")
    _write(b / "systems" / "hybrid_twin" / "serve.py",
           "from cmpibench.systems.hybrid_serve.serve import rank_main\n"
           "from cmpibench.systems.hybrid_twin import check\n"
           "__all__ = ['rank_main', 'check']\n")
    tiny_conf = tiny_cells.forms("configs")["jamba-tiny-f32"]
    _write(b / "tests" / "tiny" / "configs" / "twin-tiny-f32.json",
           dict(tiny_conf, **{"from": "jamba-twin"}))
    _write(b / "tests" / "tiny" / "cells" / "twin.tiny-prefill.json",
           {"real": "twin.prefill-8k", "config": "twin-tiny-f32",
            "traffic": "tiny-prefill-8k"})
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "jamba-twin", "source": "test",
                             "file": "cmpibench/configs/jamba-twin.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "twin.prefill-8k",
                               "config": "jamba-twin",
                               "traffic": "prefill-8k", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("tokens_per_s", "mamba_share.prefill"):
            m["workloads"].append("twin.prefill-8k")
    bench["per_layer"].append({
        "name": "twin_counters.prefill", "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "serve step",
        "moves": "tokens_per_s", "workloads": ["twin.prefill-8k"]})
    _write(copy / "BENCHMARK.json", bench)
    after = _hashes(b)
    assert {k: after[k] for k in before} == before   # nothing edited

    script = tmp_path / "add.py"
    script.write_text(ADD)
    p = subprocess.run([sys.executable, str(script), str(copy),
                        str(ROOT / "src"), str(tmp_path / "tiny"),
                        "twin.tiny-prefill", str(SEED)],
                       capture_output=True, text=True, timeout=110)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    lists = {m["name"]: m.get("workloads")
             for m in got["bench"]["end_to_end"] + got["bench"]["per_layer"]}
    assert "twin.tiny-prefill" in lists["tokens_per_s"]
    untraced, traced = got["runs"]
    for out in got["runs"]:
        assert out["correct"], out["checks"]
        assert out["attempted"] > 0 and out["failed"] == 0
    assert {"tokens_per_s", "setup_s"} <= set(untraced["metrics"])
    # the twin's spans and counters reached its traced window
    assert 0 < traced["metrics"]["mamba_share.prefill"]["value"] <= 100
    assert traced["metrics"]["twin_counters.prefill"]["value"] == 3


def test_a_cell_with_no_tiny_form_is_left_out_and_named(tmp_path,
                                                         monkeypatch):
    want = json.loads((tiny_cells.make_root(tmp_path / "now")
                       / "BENCHMARK.json").read_text())
    copy = _copy(tmp_path / "repo")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "new.cell",
                               "config": "jamba2-mini-ep2",
                               "traffic": "prefill-8k", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("tokens_per_s", "mamba_share.prefill"):
            m["workloads"].append("new.cell")
    _write(copy / "BENCHMARK.json", bench)
    monkeypatch.setattr(tiny_cells, "BENCH", copy / "cmpibench")
    assert tiny_cells.left_out(bench) == ["new.cell"]
    with pytest.warns(UserWarning, match="new.cell"):
        root = tiny_cells.make_root(tmp_path / "tiny")
    # the tiny checkout is the one of the cells that have a form
    assert json.loads((root / "BENCHMARK.json").read_text()) == want
