"""Serving figures of several checkouts of this repository on one card,
in the order given, each in a process of its own that imports that
checkout's ``src/repro_torch`` (and builds its kernels there).

Give a parent and a change in alternating order (parent, change,
change, parent) so that a drift of the card or the host shows as a
difference between the two runs of one tree:

    git archive HEAD | tar -x -C build/parent
    python3 tools/serve_pairs.py --trees build/parent . . build/parent \\
        --arch granite-moe-1b-a400m llama3-8b --out build/pairs.json

Per tree and model, at the published config with ``chip_smoke.CUTS``'
cut where it has one (jamba-1.5-large-398b: 8 layers, 4 experts, bf16
parameters; the smoke's phase 4 serves the same cut), from seed-0
weights in bf16: ``serve_batch`` at batch 4, a 128-token prompt and 32
generated tokens (one warm-up, then ``--reps`` runs: decode tokens/s
and the teacher-forced prefill's seconds), and ``lm.prefill`` at 4 x 128
and 1 x 4096 (one warm-up each, then ``--reps`` timed runs, synced).
Prints one JSON line per tree and writes them all to ``--out``. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SERVE = {"batch": 4, "prompt_len": 128, "gen": 32}
PREFILLS = {"4x128": (4, 128), "1x4096": (1, 4096)}


def child(tree: str, archs: list[str], reps: int) -> dict:
    """The figures of one checkout (run in a process of its own)."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm
    if not torch.cuda.is_available():
        raise SystemExit("serve_pairs: no CUDA card")
    build.load()
    out: dict = {"tree": tree, "package": str(Path(
        sys.modules["repro_torch"].__file__).parent)}
    # this checkout's cuts, applied to the measured tree's configs
    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import model_config
    for arch in archs:
        cfg, _ = model_config(arch)
        params = lm.init(cfg, 0, device="cuda")
        res: dict = {"decode_tok_per_s": [], "serve_prefill_s": []}
        for i in range(reps + 1):
            r = serve_batch(cfg, params=params, seed=0, quiet=True,
                            device="cuda", **SERVE)
            if i:
                res["decode_tok_per_s"].append(r["decode_tok_per_s"])
                res["serve_prefill_s"].append(r["prefill_s"])
        for name, (b, s) in PREFILLS.items():
            toks = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab_size, size=(b, s), dtype=np.int32)).cuda()
            times = []
            for i in range(reps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    lm.prefill(params, cfg, {"tokens": toks})
                torch.cuda.synchronize()
                if i:
                    times.append(time.perf_counter() - t0)
            res[f"prefill_{name}_s"] = times
        out[arch] = res
        del params
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--arch", nargs="+",
                    default=["granite-moe-1b-a400m", "llama3-8b"])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.trees[0], args.arch, args.reps)),
              flush=True)
        return
    runs = []
    for tree in args.trees:
        p = subprocess.run(
            [sys.executable, __file__, "--child", "--trees", tree,
             "--reps", str(args.reps), "--arch", *args.arch],
            capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            sys.stderr.write(p.stderr)
            raise SystemExit(f"serve_pairs: {tree} exited {p.returncode}")
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main()
