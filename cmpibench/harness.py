"""One run of one cell: ``BENCHMARK.json`` names the cell's configuration
(``configs/<name>.json``, whose ``"system"`` names a package under
``systems/``), its traffic mix (``traffic/<name>.json``, whose ``"loop"``
names the rank program, ``systems/<system>/<loop>.py``) and the metrics
it reports, each read by ``metrics/<name>.py``. Adding a configuration,
a mix, a kind of mix or a metric is adding files and entries.

A run: build the program's kernels, start the cell's ranks on the card,
warm up, measure for ``--seconds``, check what the timed path produced,
and print one JSON line. With ``--trace 0`` it reports the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics.
"""
from __future__ import annotations

import argparse
import bisect
import importlib
import importlib.util
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

from cmpibench import yardstick
from cmpibench.launcher import forbidden_modules, run_ranks

ROOT = Path(__file__).resolve().parents[1]
RUN_LIMIT_S = 240.0             # a run's ranks beyond their window


class CellError(Exception):
    """The run cannot be made as asked."""


def load_cell(root: Path, workload: str) -> dict:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no cell {workload!r} in BENCHMARK.json; cells: "
                        f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    conf = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "cmpibench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return {"bench": bench, "cell": cell, "conf": conf, "traffic": traffic}


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics the cell reports in this kind of run: the end-to-end
    metrics that name it (or name no cells); with ``trace`` the per-layer
    metrics that name it, or that name no cells and move an end-to-end
    metric it reports."""
    def names(m):
        return m.get("workloads")
    e2e = [m for m in bench["end_to_end"]
           if names(m) is None or cell in names(m)]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in names(m) if names(m) is not None
                else m["moves"] in mine)]


def read_metric(root: Path, name: str, run: dict):
    path = root / "cmpibench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "cmpibench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


# --------------------------------------------------------------------------
# the device trace of a traced run, merged over the ranks
# --------------------------------------------------------------------------

def merge_trace(reports: list[dict], seconds: float) -> dict:
    """Every rank's card operations on one clock (epoch nanoseconds), in
    rank 0's window. Raises where a rank's operations fall outside the
    span its profiler ran: its clock does not agree with the others'."""
    lo = reports[0]["t0_ns"]
    hi = lo + int(seconds * 1e9)
    for r in reports:
        a, b = r["trace_window_ns"]
        ev = r["device_events"]
        if ev and (min(e[1] for e in ev) < a - 10 ** 7
                   or max(e[2] for e in ev) > b + 10 ** 7):
            raise CellError(f"rank {r.get('rank')}: device events outside "
                            f"its profiler's span; the clocks disagree")
    allev = [e for r in reports for e in r["device_events"]]
    busy = yardstick.covered(yardstick.clip(
        [(s, e) for _, s, e in allev], lo, hi)) / 1e9
    by_name: dict = defaultdict(float)
    for n, s, e in allev:
        by_name[n] += (min(e, hi) - max(s, lo)) / 1e9 if e > lo and s < hi \
            else 0.0
    gaps = yardstick.gaps([(s, e) for _, s, e in allev], lo, hi)
    spans = sorted(reports[0].get("spans", []), key=lambda x: x[1])
    starts = [s[1] for s in spans]
    idle: dict = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "host:other"
        for k in range(i, max(i - 64, -1), -1):   # the innermost span
            if spans[k][2] >= mid:
                label = "host:" + spans[k][0]
                break
        idle[label] += (b - a) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": seconds,
            "events": allev, "lo": lo, "hi": hi,
            "breakdown": {
                "device_ops": [[n[:200], v] for n, v in top if v > 0],
                "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                    key=lambda kv: -kv[1])[:10]}}


# --------------------------------------------------------------------------
# a run
# --------------------------------------------------------------------------

def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: Path = ROOT, fault=None,
             control: bool = False, config_over: dict | None = None,
             traffic_over: dict | None = None,
             t_start: float | None = None) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``fault`` plants a fault in the rank programs and ``control`` reads
    the check's control in the program's place; ``config_over`` and
    ``traffic_over`` change keys of the configuration and the mix (all
    four for ``control.py`` and the tests)."""
    t_start = time.monotonic() if t_start is None else t_start
    c = load_cell(root, workload)
    conf, traffic = c["conf"], c["traffic"]
    conf.update(config_over or {})
    traffic.update(traffic_over or {})
    system = importlib.import_module(
        f"cmpibench.systems.{conf['system']}.{traffic['loop']}")
    comm = dict(conf["comm"])
    pool_bytes = comm.pop("pool_bytes")
    spec = {"config": conf, "traffic": traffic, "seed": int(seed),
            "seconds": float(seconds), "trace": bool(trace),
            "fault": fault}
    if device == "cuda":
        from repro_torch.kernels.build import build
        build()                               # once, before the ranks
    reports = run_ranks(conf["ranks"], f"{system.__name__}:rank_main", spec,
                        pool_bytes=pool_bytes, comm_kw=comm, device=device,
                        timeout=seconds + RUN_LIMIT_S)
    bad_mods = sorted({m for r in reports for m in r["forbidden_modules"]})
    setup_s = min(r["t0"] for r in reports) - t_start
    # the ranks have ended: their peaks are read, their memory is free
    checked = system.check(spec, reports, device, control=control)
    numbers = checked["numbers"]
    correct = all(n["value"] <= n["limit"] for n in numbers.values())
    run = {"cell": c["cell"], "config": conf, "traffic": traffic,
           "seed": seed, "seconds": float(seconds), "reports": reports,
           "setup_s": setup_s}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": _device_name(device), "count": 1,
           "memory_peak_bytes": sum(r["peak_bytes"] for r in reports)}
    out = {"correct": correct, "attempted": checked["attempted"],
           "failed": checked["failed"]}
    if trace:
        run["trace"] = merge_trace(reports, seconds)
        dev.update(busy_s=run["trace"]["busy_s"],
                   window_s=run["trace"]["window_s"])
    metrics = {}
    for m in cell_metrics(c["bench"], workload, trace):
        v = read_metric(root, m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out.update(metrics=metrics, device=dev)
    if trace:
        out["breakdown"] = run["trace"]["breakdown"]
    bad_mods = sorted(set(bad_mods) | set(forbidden_modules()))
    if bad_mods:
        raise CellError(f"modules of JAX or the JAX package were loaded: "
                        f"{bad_mods}")
    out["checks"] = numbers
    out["_detail"] = checked.get("detail")
    return out


def _device_name(device: str) -> str:
    if device != "cuda":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(0)


def _env() -> None:
    """Caches at fixed places inside the checkout, few host threads."""
    cache = ROOT / "build" / "cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="cmpibench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv) -> int:
    t_start = time.monotonic()
    a = parse(argv)
    _env()
    import torch
    cells = load_cell(ROOT, a.workload)
    need = cells["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"cmpibench: the cell needs {need} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                   t_start=t_start)
    detail = out.pop("_detail")
    if detail:
        print("cmpibench: check readings " + json.dumps(detail),
              file=sys.stderr)
    for name, n in out["checks"].items():
        print(f"cmpibench: check {name} = {n['value']!r} (limit "
              f"{n['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
