"""A copy of the benchmark with every cell small enough for the CPU: the
tiny configurations and mixes of ``cpu_cells`` and those of the cells
added after it (the hybrid Jamba model, prefill-only and with decode
steps; the one-sided loop), with a BENCHMARK.json whose cells are the
tiny ones and whose metrics are the real ones.

The tiny Jamba computes in float32 (its control TF32), as the tiny
granite does: one whole period of 8 layers at widths of a few dozen, 2
of 4 routed experts held over 2 model ranks. Its mixes hold the f32
program to the reference at a tight limit, which the control and the
planted faults must fail."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from cmpibench.tests import cpu_cells

BENCH = cpu_cells.BENCH

TINY_JAMBA = {
    "hidden_size": 32, "num_hidden_layers": 8, "num_attention_heads": 4,
    "num_key_value_heads": 2, "intermediate_size": 16, "num_experts": 2,
    "router_experts": 4, "num_experts_per_tok": 2, "vocab_size": 96,
    "mamba_d_state": 4, "mamba_dt_rank": 4, "compute_dtype": "float32",
    "kv_cache_dtype": "float32", "torch_dtype": "float32",
}
JAMBA_LIMITS = {"logit_l2_median": 1e-4, "logit_l2": 1e-3, "token_gap": 1e-3}
TRAFFIC = {
    **cpu_cells.TRAFFIC,
    "tiny-rma": {"sizes": [8, 64, 4096, 16384], "per_block": 3,
                 "payload_bytes": 1 << 16, "log_bytes": 1 << 22},
    "tiny-prefill-8k": {"prompt_len": 16, "check_requests": 2,
                        "limits": JAMBA_LIMITS},
    "tiny-hybrid-decode": {"prompt_len": 12, "gen": 4, "check_requests": 2,
                           "limits": JAMBA_LIMITS},
}
BASE = {**cpu_cells.BASE, "tiny-rma": "rma-small",
        "tiny-prefill-8k": "prefill-8k", "tiny-hybrid-decode": "prefill-8k"}
# real cell -> (tiny cell, tiny configuration, tiny mix)
CELLS = {
    "osu2.pingpong-small": ("osu.tiny-pingpong", "osu-tiny",
                            "tiny-pingpong"),
    "osu2.stream-large": ("osu.tiny-stream", "osu-tiny", "tiny-stream"),
    "granite-ep4-f32.decode-chat": ("granite.tiny-decode",
                                    "granite-tiny-f32", "tiny-decode"),
    "granite-ep4.prefill-long": ("granite.tiny-prefill", "granite-tiny-f32",
                                 "tiny-prefill"),
    "jamba2-ep2.prefill-8k": ("jamba.tiny-prefill", "jamba-tiny-f32",
                              "tiny-prefill-8k"),
    "osu2.rma-small": ("osu.tiny-rma", "osu-tiny", "tiny-rma"),
}
# tiny cells of no real cell of their own, reporting as the one named
EXTRA = {"jamba.tiny-decode": ("jamba2-ep2.prefill-8k", "jamba-tiny-f32",
                               "tiny-hybrid-decode")}


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """``tmp`` laid out as a checkout: the benchmark's folder, the tiny
    configurations and mixes beside its own, and a BENCHMARK.json whose
    cells are the tiny ones with the real metrics. ``limits`` replaces
    the limits of the granite mixes, as ``cpu_cells.make_root``'s."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "cmpibench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    cfg = root / "cmpibench" / "configs"
    osu = json.loads((cfg / "cmpi-osu-2rank.json").read_text())
    osu["comm"].update(cpu_cells.TINY_OSU)
    (cfg / "osu-tiny.json").write_text(json.dumps(osu))
    gr = json.loads((cfg / "granite-moe-1b-a400m-ep4.json").read_text())
    gr.update(cpu_cells.TINY_GRANITE, compute_dtype="float32",
              kv_cache_dtype="float32")
    gr["comm"].update(cpu_cells.TINY_OSU)
    (cfg / "granite-tiny-f32.json").write_text(json.dumps(gr))
    jb = json.loads((cfg / "jamba2-mini-ep2.json").read_text())
    jb.update(TINY_JAMBA)
    jb["comm"].update(cpu_cells.TINY_OSU)
    (cfg / "jamba-tiny-f32.json").write_text(json.dumps(jb))
    tr = root / "cmpibench" / "traffic"
    for name, over in TRAFFIC.items():
        t = json.loads((tr / f"{BASE[name]}.json").read_text())
        t.update(over)
        if limits and name in cpu_cells.TRAFFIC and "limits" in t:
            t["limits"] = limits
        (tr / f"{name}.json").write_text(json.dumps(t))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    real = {w["name"]: w for w in bench["workloads"]}
    bench["configs"] = [
        {"name": n, "source": "test", "reduced": [], "why": "test",
         "file": f"cmpibench/configs/{n}.json"}
        for n in ("osu-tiny", "granite-tiny-f32", "jamba-tiny-f32")]
    tiny = [(real[old], *CELLS[old]) for old in real]
    tiny += [(real[src], name, conf, mix)
             for name, (src, conf, mix) in EXTRA.items()]
    bench["workloads"] = [dict(w, name=name, config=conf, traffic=mix)
                          for w, name, conf, mix in tiny]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELLS[w][0] for w in m["workloads"]] + [
                name for name, (src, _, _) in EXTRA.items()
                if src in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
