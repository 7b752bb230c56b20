"""A copy of the benchmark with cells small enough for the CPU: the same
code, tiny configurations and mixes, for the tests of this folder. The
tiny model computes in float32 (its control TF32): at a vocabulary of 96
its bfloat16 readings lie too close to its float8 control's for any
limit, and their readings differ from the full size's. So the tiny
prefill mix holds the f32 program to its cell's number at a tighter
limit, and adds ``rows_off`` and ``token_gap`` as the decode mix has
them, which the planted faults must fail."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

TINY_GRANITE = {
    "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "intermediate_size": 16,
    "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 96,
    "attention_multiplier": 8 ** -0.5,
}
TINY_OSU = {"pool_bytes": 32 << 20}
TRAFFIC = {
    "tiny-pingpong": {"sizes": [8, 64, 4096, 16384], "per_block": 3,
                      "payload_bytes": 1 << 16, "log_bytes": 1 << 22},
    "tiny-stream": {"sizes": [20000, 65536], "per_block": 4,
                    "window": 4, "payload_bytes": 1 << 18,
                    "log_bytes": 1 << 22, "keep_share": 0.5},
    "tiny-decode": {"rows": 4, "prompt_len": 8, "gen": 5,
                    "check_requests": 2, "row_tol": 1e-4},
    "tiny-prefill": {"rows": 2, "prompt_len": 16, "gen": 0,
                     "check_requests": 3, "row_tol": 1e-4,
                     "limits": {"logit_l2_median": 1e-4, "token_gap": 0.07,
                                "rows_off": 0.25}},
}
BASE = {"tiny-pingpong": "pingpong-small", "tiny-stream": "stream-large",
        "tiny-decode": "decode-chat", "tiny-prefill": "prefill-long"}
CELLS = {"osu.tiny-pingpong": ("osu-tiny", "tiny-pingpong"),
         "osu.tiny-stream": ("osu-tiny", "tiny-stream"),
         "granite.tiny-decode": ("granite-tiny-f32", "tiny-decode"),
         "granite.tiny-prefill": ("granite-tiny-f32", "tiny-prefill")}


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """``tmp`` laid out as a checkout: the benchmark's folder, the tiny
    configurations and mixes beside its own, and a BENCHMARK.json whose
    cells are the tiny ones with the real metrics."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "cmpibench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    cfg = root / "cmpibench" / "configs"
    osu = json.loads((cfg / "cmpi-osu-2rank.json").read_text())
    osu["comm"].update(TINY_OSU)
    (cfg / "osu-tiny.json").write_text(json.dumps(osu))
    gr = json.loads((cfg / "granite-moe-1b-a400m-ep4.json").read_text())
    gr.update(TINY_GRANITE, compute_dtype="float32",
              kv_cache_dtype="float32")
    gr["comm"].update(TINY_OSU)
    (cfg / "granite-tiny-f32.json").write_text(json.dumps(gr))
    tr = root / "cmpibench" / "traffic"
    for name, over in TRAFFIC.items():
        t = json.loads((tr / f"{BASE[name]}.json").read_text())
        t.update(over)
        if limits and "limits" in t:
            t["limits"] = limits
        (tr / f"{name}.json").write_text(json.dumps(t))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    real = {w["name"]: w for w in bench["workloads"]}
    bench["configs"] = [
        {"name": "osu-tiny", "source": "test", "reduced": [], "why": "test",
         "file": "cmpibench/configs/osu-tiny.json"},
        {"name": "granite-tiny-f32", "source": "test", "reduced": [],
         "why": "test", "file": "cmpibench/configs/granite-tiny-f32.json"}]
    rename = dict(zip(["osu2.pingpong-small", "osu2.stream-large",
                       "granite-ep4-f32.decode-chat",
                       "granite-ep4.prefill-long"],
                      ["osu.tiny-pingpong", "osu.tiny-stream",
                       "granite.tiny-decode", "granite.tiny-prefill"]))
    bench["workloads"] = [dict(real[old], name=new, config=CELLS[new][0],
                               traffic=CELLS[new][1])
                          for old, new in rename.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def failing_rank(env, spec):
    """A rank program whose rank 1 raises while rank 0 waits on it."""
    import time
    if env.rank == 1:
        raise ValueError("planted failure")
    time.sleep(120)
    return {}


def hanging_rank(env, spec):
    import time
    time.sleep(120)
    return {}
