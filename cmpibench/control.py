"""The readings the limits of ``correct`` are set from: the program's, and
its control's, on several seeds of one cell, each run as the benchmark
runs it (a short window at the cell's own load, the check after it).

    python3 cmpibench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--fault alter] [--set key=json ...] \\
        [--mix key=json ...] [--out <file.json>]

For a served model the control is the plain reference put in the
program's place, in the precision below the configuration's (float8 for
bfloat16, TF32 for float32); for a message cell, whose configuration states no
precision, it is a planted fault that breaks the delivery it guarantees
(``--fault alter``: one bit of some messages flipped as they are sent).
The control takes the program's place in the check, so each run
reports ``correct`` as the control would; the command exits with 1 where
any seed's control comes out correct. Each row also carries the
program's own readings (``detail``, unprefixed). The benchmark's own runs
never run it.
"""
import argparse
import json
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT / "src"), str(_ROOT)]


def main(argv) -> int:
    from cmpibench.harness import _env, run_cell
    p = argparse.ArgumentParser(prog="cmpibench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=JSON",
                   help="change a key of the configuration, for a look "
                        "at the program in another precision")
    p.add_argument("--mix", nargs="*", default=[], metavar="KEY=JSON",
                   help="change a key of the traffic mix, for a look")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    _env()
    rows = []
    for seed in a.seeds:
        over, mix = ({k: json.loads(v) for k, v in
                      (kv.split("=", 1) for kv in pairs)}
                     for pairs in (a.set, a.mix))
        out = run_cell(a.workload, seed, a.seconds, False, fault=a.fault,
                       control=a.fault is None, config_over=over,
                       traffic_over=mix)
        row = {"seed": seed, "correct": out["correct"],
               "checks": out["checks"], "detail": out["_detail"],
               "metrics": out["metrics"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(rows, indent=1))
    passed = [r["seed"] for r in rows if r["correct"]]
    if passed:
        print(f"control.py: the control came out correct on seeds "
              f"{passed}", file=sys.stderr)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
