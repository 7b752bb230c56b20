"""A copy of the benchmark with every cell small enough for the CPU: the
same code, tiny configurations and mixes beside the real ones, and a
BENCHMARK.json whose cells are the tiny ones and whose metrics are the
real ones.

Each tiny form is a data file under ``tiny/``, found by name:

- ``configs/<tiny>.json``: ``{"from": <real configuration's file stem>,
  "over": {...}, "comm": {...}}``, the real file with ``over`` and its
  ``comm`` updated;
- ``traffic/<tiny>.json``: ``{"from": <real mix>, "over": {...}}``;
- ``cells/<tiny cell>.json``: ``{"real", "config", "traffic"}``, a tiny
  cell that reports as the real cell ``real`` (one real cell may have
  several).

A new cell's tiny form is new files alone. A real cell with no tiny cell
is left out of the tiny BENCHMARK.json (``left_out`` names it).

The tiny models compute in float32 (their control TF32): at a vocabulary
of 96 their bfloat16 readings lie too close to a float8 control's for any
limit. So the tiny mixes hold the f32 program to the reference at tight
limits, which the control and the planted faults must fail. The tiny
Jamba keeps one whole period of 8 layers, at widths of a few dozen, 2 of
4 routed experts held over 2 model ranks."""
from __future__ import annotations

import json
import shutil
import warnings
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORMS = Path(__file__).resolve().parent / "tiny"


def forms(kind: str) -> dict:
    """Every tiny form of one kind (``configs``, ``traffic``, ``cells``),
    by file stem."""
    return {p.stem: json.loads(p.read_text())
            for p in sorted((FORMS / kind).glob("*.json"))}


def left_out(bench: dict) -> list[str]:
    """The cells of ``bench`` that have no tiny cell."""
    have = {f["real"] for f in forms("cells").values()}
    return [w["name"] for w in bench["workloads"] if w["name"] not in have]


def make_root(tmp: Path) -> Path:
    """``tmp`` laid out as a checkout: the benchmark's folder, the tiny
    configurations and mixes beside its own, and a BENCHMARK.json whose
    cells are the tiny ones with the real metrics, in the real cells'
    order. A real cell with no tiny cell is left out, with a warning
    that names it."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "cmpibench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    missing = left_out(bench)
    if missing:
        warnings.warn(f"no tiny form under {FORMS}: left out {missing}")
    # real cell -> its tiny cells, each (name, form)
    tiny = {w["name"]: [] for w in bench["workloads"]}
    for name, form in forms("cells").items():
        if form["real"] in tiny:
            tiny[form["real"]].append((name, form))
    cells = [(w, name, form) for w in bench["workloads"]
             for name, form in tiny[w["name"]]]
    confs = list(dict.fromkeys(form["config"] for _, _, form in cells))
    mixes = {form["traffic"] for _, _, form in cells}

    b = root / "cmpibench"
    conf_forms, mix_forms = forms("configs"), forms("traffic")
    for name in confs:
        form = conf_forms[name]
        c = json.loads((b / "configs" / f"{form['from']}.json").read_text())
        c.update(form["over"])
        c["comm"].update(form["comm"])
        (b / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name in mixes:
        form = mix_forms[name]
        t = json.loads((b / "traffic" / f"{form['from']}.json").read_text())
        t.update(form["over"])
        (b / "traffic" / f"{name}.json").write_text(json.dumps(t))

    bench["configs"] = [
        {"name": n, "source": "test", "reduced": [], "why": "test",
         "file": f"cmpibench/configs/{n}.json"} for n in confs]
    bench["workloads"] = [
        dict(w, name=name, config=form["config"], traffic=form["traffic"])
        for w, name, form in cells]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [name for w in m["workloads"]
                              for name, _ in tiny[w]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
