"""Traced runs of benchmark cells, read through the program's own spans
(recorded as ``program_spans.recording`` sets out): what the cell's
per-layer metrics cannot hold.

    python3 tools/span_report.py --cells osu2.pingpong-small \\
        --seeds 2200000301 --seconds 30 --out build/spans.json

For each run: the result line's metrics and idle-gap labels, and the
cell's end-to-end metrics read on the traced run; the spans' readings
(``program_spans.READINGS``); the split of the
message hop (the sender's ``pt2pt.send``, the receiver's wake-up, its
``pt2pt.deliver``) at p50 and p99, the message life against the half
round trip, and a ping-pong's round trip in parts; the share of the
card's idle time in gaps labelled by a program span; how each rank's
``cellcopy`` kernels lie against its ``pool.copy`` spans; each rank's
counters; the host time under each span (rank 0, the innermost span at
each instant).
``--cpu`` runs the benchmark's tiny CPU cells (``cmpibench/tests``).
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import program_spans as S  # noqa: E402  (beside this file)

BENCH_LABELS = ("send", "recv_into", "isend+waitall", "recv_ack", "waitall",
                "decode_step", "prefill")


def _pct(xs, q):
    from cmpibench import yardstick
    return yardstick.percentile(xs, q) if xs else None


def hop(run) -> dict:
    """The hop's parts (us) by message, p50 and p99, and the life."""
    parts = defaultdict(list)
    if not S.traced(run):
        return {}
    for v in S.messages(run).values():
        if "deliver" not in v:
            continue
        s, d = v["send"], v["deliver"]
        parts["send"].append((s[S.T1] - s[S.T0]) / 1e3)
        parts["wake"].append((d[S.T0] - s[S.T1]) / 1e3)
        parts["recv"].append((d[S.T1] - d[S.T0]) / 1e3)
        parts["life"].append((d[S.T1] - s[S.T0]) / 1e3)
    out = {k: {"p50": _pct(v, 50), "p99": _pct(v, 99), "n": len(v)}
           for k, v in parts.items()}
    lat = run["reports"][0].get("latency_s")
    if lat:
        out["half_round_trip"] = {"p50": _pct(lat, 50) * 1e6,
                                  "p99": _pct(lat, 99) * 1e6}
    return out


def round_trip(run) -> dict | None:
    """Rank 0's round trips of a ping-pong split (us, medians): its
    ``send`` call up to the ping's ``isend``, the ping's life, rank 1's
    turnaround from the ping's completion to the pong's ``isend``, the
    pong's life, and rank 0's return from the pong's completion."""
    r0 = run["reports"][0]
    if "program_spans" not in r0 or not r0.get("latency_s"):
        return None
    msgs = S.messages(run)
    calls = sorted((a, b) for n, a, b in r0["spans"] if n == "send")
    ends = sorted(b for n, a, b in r0["spans"] if n == "recv_into")
    parts = defaultdict(list)
    for seq, (a, _) in enumerate(calls):
        ping = msgs.get(("world", 0, 1, seq))
        pong = msgs.get(("world", 1, 0, seq))
        if not (ping and pong and "deliver" in ping and "deliver" in pong):
            continue
        i = bisect.bisect_left(ends, pong["deliver"][S.T1])
        if i == len(ends):
            continue
        parts["call_to_isend"].append(ping["send"][S.T0] - a)
        parts["ping_life"].append(ping["deliver"][S.T1] - ping["send"][S.T0])
        parts["turnaround"].append(pong["send"][S.T0]
                                   - ping["deliver"][S.T1])
        parts["pong_life"].append(pong["deliver"][S.T1] - pong["send"][S.T0])
        parts["return"].append(ends[i] - pong["deliver"][S.T1])
    return {k: _pct(v, 50) / 1e3 for k, v in parts.items() if v}


def clock_check(run) -> list:
    """Per rank: the share of its cellcopy kernels that start inside one
    of its pool.copy spans; for those that start outside every one, the
    signed distance (us) to the nearest span (negative: before one's
    start, positive: after one's end), quantiles and the first few by
    third of the window; and the shift that put the rank's spans on the
    window's reading of the epoch clock. Clocks that agree leave none
    outside."""
    out = []
    for r in run["reports"]:
        iv = sorted((x[1], x[2]) for x in r.get("program_spans", [])
                    if x[0] == "pool.copy" and x[2])
        starts = [a for a, _ in iv]
        kernels = [e[1] for e in r.get("device_events", [])
                   if "cellcopy" in e[0]]
        outside, thirds = [], [[], [], []]
        for t in kernels if iv else []:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and iv[i][1] >= t:
                continue
            before = (t - iv[i + 1][0]) if i + 1 < len(iv) else None
            after = (t - iv[i][1]) if i >= 0 else None
            d = min((x for x in (before, after) if x is not None),
                    key=abs) / 1e3
            outside.append(d)
            j = 3 * (t - r["t0_ns"]) // max(1, int(r["seconds"] * 1e9))
            thirds[min(2, max(0, j))].append(round(d, 1))
        n = len(kernels)
        out.append({
            "kernels": n, "inside_share": 100.0 * (n - len(outside)) / n
            if n and iv else None,
            "outside": {q: _pct(outside, q) for q in (1, 50, 99)},
            "outside_by_third": [x[:8] for x in thirds],
            "shift_us": r.get("program_clock_shift_ns", 0) / 1e3})
    return out


def labels(run) -> dict:
    """Idle seconds by label as the harness gives them, and the share
    under a program span."""
    gaps = run["trace"]["breakdown"]["idle_gaps"]
    idle = sum(v for _, v in gaps)
    bench = sum(v for k, v in gaps
                if k == "host:other" or k[5:] in BENCH_LABELS
                or k.startswith("host:collective:"))
    return {"idle_gaps": gaps, "program_share":
            100.0 * (idle - bench) / idle if idle else None}


def host_time(run, rank: int = 0) -> dict:
    """Seconds of rank ``rank``'s window under each innermost span."""
    r = run["reports"][rank]
    lo, hi = r["t0_ns"], r["t0_ns"] + int(r["seconds"] * 1e9)
    ev = []
    for name, a, b in r.get("spans", []):
        if b > a:
            ev += [(a, 1, name), (b, 0, name)]
    ev.sort()
    stack: list = []
    out: dict = defaultdict(float)
    last = lo
    for t, kind, name in ev:
        t = min(max(t, lo), hi)
        out[stack[-1] if stack else "(none)"] += (t - last) / 1e9
        last = t
        if kind:
            stack.append(name)
        elif name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()
    out[stack[-1] if stack else "(none)"] += (hi - last) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:25])


def recorded_run(cell: str, seed: int, seconds: float, trace: bool,
                 root: Path, device: str) -> tuple[dict, dict]:
    """One run of ``cell`` with the program's spans recorded where it is
    traced: the result line's object and the run the metrics read."""
    from cmpibench import harness
    seen = {}
    read = harness.read_metric

    def keep(root_, name, run):
        seen["run"] = run
        return read(root_, name, run)

    harness.read_metric = keep
    try:
        with S.recording():
            out = harness.run_cell(cell, seed, seconds, trace,
                                   device=device, root=root)
    finally:
        harness.read_metric = read
    return out, seen["run"]


def report(cell: str, seed: int, seconds: float, root: Path,
           device: str) -> dict:
    from cmpibench import harness
    out, run = recorded_run(cell, seed, seconds, True, root, device)
    out.pop("_detail", None)
    # the cell's end-to-end metrics, read on the traced run
    e2e = {m["name"]: harness.read_metric(root, m["name"], run)
           for m in harness.cell_metrics(harness.load_cell(root, cell)
                                         ["bench"], cell, False)}
    return {"cell": cell, "seed": seed, "correct": out["correct"],
            "e2e_traced": e2e,
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "readings": {k: f(run) for k, f in S.READINGS.items()},
            "device": out["device"], "hop": hop(run),
            "labels": labels(run), "round_trip": round_trip(run),
            "clock": clock_check(run),
            "counters": [{**(r.get("span_counters") or {}),
                          **(r.get("program_counters") or {})}
                         for r in run["reports"]],
            "host_time_rank0": host_time(run)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools/span_report.py")
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--seeds", nargs="+", type=int, default=[2200000301])
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", type=Path)
    a = p.parse_args(argv)
    root, device = ROOT, "cuda"
    if a.cpu:
        from cmpibench.tests.tiny_cells import make_root
        root, device = make_root(Path(tempfile.mkdtemp())), "cpu"
    else:
        from repro_torch.kernels.build import build
        build()
    outs = []
    for cell in a.cells:
        for seed in a.seeds:
            outs.append(report(cell, seed, a.seconds, root, device))
            print(json.dumps(outs[-1]), flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(outs, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
