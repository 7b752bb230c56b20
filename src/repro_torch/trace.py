"""``python -m repro_torch.trace`` — stitch and summarize flight-recorder
dumps (the JAX package's ``repro.trace``, over the port's
``core.trace``).

Each rank of a traced run writes its own dump via
``comm.trace_dump(path)`` (or ``Tracer.dump``). This CLI turns those
per-rank files into something a human can read:

    python -m repro_torch.trace merge rank0.json rank1.json -o timeline.json
    python -m repro_torch.trace summarize rank0.json rank1.json --top 15

``merge`` emits Chrome trace-event JSON — open it in Perfetto
(https://ui.perfetto.dev) or chrome://tracing: one process lane per
rank, engine ticks and schedule executions as duration slices (one
sub-lane per schedule node, so chunked collectives render per-chunk),
pt2pt/matchbox instants, RMA epochs as nested slices, and then the
rank's spans (messages, copies, syncs, collective calls, serve steps)
as slices in lanes of their own, on the epoch clock of the card's
profiler traces. ``summarize`` prints a text top-N event table +
latency-histogram percentiles.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.core.trace import load_dump, merge_dumps, summarize_dumps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.trace",
        description="merge/summarize per-rank flight-recorder dumps")
    sub = p.add_subparsers(dest="cmd", required=True)
    pm = sub.add_parser("merge", help="stitch per-rank dumps into one "
                                      "Perfetto-loadable Chrome trace")
    pm.add_argument("files", nargs="+", type=Path)
    pm.add_argument("-o", "--out", type=Path,
                    default=Path("timeline.json"))
    ps = sub.add_parser("summarize", help="text top-N event summary")
    ps.add_argument("files", nargs="+", type=Path)
    ps.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)

    dumps = []
    for f in args.files:
        if not f.exists():
            print(f"missing dump: {f}", file=sys.stderr)
            return 1
        dumps.append(load_dump(f))
    if args.cmd == "merge":
        trace = merge_dumps(dumps)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(trace) + "\n")
        print(f"merged {len(dumps)} rank dump(s), "
              f"{len(trace['traceEvents'])} trace events -> {args.out}")
    else:
        print(summarize_dumps(dumps, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
