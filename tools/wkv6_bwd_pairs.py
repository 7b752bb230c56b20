"""``wkv6_bwd`` of two sources of ``csrc/wkv6.cu`` on one card, in turns.

Builds the given older source alone into ``build/wkv6_pairs/`` (nvcc,
``sm_90a``) beside the checkout's own library (``kernels.build``), and
runs both at rwkv6-3b's training launch (``chip_smoke.WKV6_LAUNCH``: B 1,
H 40, S 4096, n 64, bf16 r, k, v in the model's BSHN layout) on the same
inputs. Both keep the C interface ``wkv6_bwd`` / ``wkv6_bwd_plan``; the
older library's workspace bytes are read from its own plan (``--old-plan``
ints, the last two holding the bytes) and the checkout's from
``ops.bwd_launch_plan``. Per turn, in the order old, new, new, old: the
device ms per call from CUDA events (``--reps`` calls after two warm
ones). Then, per library: ms per call by kernel (``torch.profiler``),
the workspace bytes, each gradient's error against ``wkv6_bwd_ref``
(as a share of ``chip_smoke.GRAD_TOL`` x its max |g|) and against the
other library's. Prints one JSON line, with the card's name and power
limit, and writes it to ``--out``. Needs a CUDA card:

    git show HEAD~1:src/repro_torch/csrc/wkv6.cu > build/wkv6_old.cu
    python3 tools/wkv6_bwd_pairs.py --old build/wkv6_old.cu \\
        --out build/wkv6_bwd_pairs.json
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def build_old(src: Path) -> ctypes.CDLL:
    """The older source alone as a shared library, its two functions
    typed as ``kernels.build`` types them."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR.parent / "wkv6_pairs"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libwkv6_old.so"
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                           "-o", str(lib), str(src)], capture_output=True,
                          text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{done.stdout}"
                         f"{done.stderr}")
    cdll = ctypes.CDLL(str(lib))
    vp, i = ctypes.c_void_p, ctypes.c_int
    cdll.wkv6_bwd.argtypes = [vp] * 12 + [i] * 5 + [ctypes.c_longlong] * 3 \
        + [vp]
    cdll.wkv6_bwd.restype = i
    cdll.wkv6_bwd_plan.argtypes = [i] * 5 + [ctypes.POINTER(i)]
    cdll.wkv6_bwd_plan.restype = i
    return cdll


def runner(lib, ws_bytes: int, args):
    """A call of ``lib.wkv6_bwd`` on the BSHN inputs ``args`` = (r, k, v,
    w, u, do), into outputs and a workspace allocated once."""
    import torch
    r, k, v, w, u, do = args
    outs = [torch.empty_like(r) for _ in range(3)] + [
        torch.empty_like(w), torch.empty_like(u)]
    ws = torch.empty(ws_bytes // 4, dtype=torch.float32, device="cuda")
    b, s, h, n = r.shape
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*args, *outs, ws)]

    def call():
        rc = lib.wkv6_bwd(*ptrs, 1, b, h, s, n, r.stride(0), r.stride(2),
                          r.stride(1), ctypes.c_void_p(
                              torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"wkv6_bwd: CUDA error {rc}")
        return outs
    call.workspace = ws          # held as long as the call is
    return call


def device_ms(call, reps: int) -> float:
    import torch
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        call()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="the older wkv6.cu")
    ap.add_argument("--old-plan", type=int, default=10,
                    help="ints the older wkv6_bwd_plan writes")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.kernels.rwkv6 import ref
    if not torch.cuda.is_available():
        raise SystemExit("wkv6_bwd_pairs: no CUDA card")
    t0 = time.perf_counter()
    libs = {"old": build_old(a.old), "new": build.load()}
    b, h, s, n = cs.WKV6_LAUNCH
    g = torch.Generator(device="cuda").manual_seed(15)
    bhsn = cs._wkv6_inputs(b, h, s, n, "bfloat16", g)
    do_bhsn = cs._randn((b, h, s, n), g)
    args = tuple(t.transpose(1, 2).contiguous() for t in bhsn[:4]) + (
        bhsn[4], do_bhsn.transpose(1, 2).contiguous())
    plan = (ctypes.c_int * a.old_plan)()
    if libs["old"].wkv6_bwd_plan(1, b, h, s, n, plan):
        raise SystemExit("wkv6_bwd_pairs: the older plan failed")
    ws = {"old": plan[a.old_plan - 2] | plan[a.old_plan - 1] << 31,
          "new": ops.bwd_launch_plan(b, h, s, n, torch.bfloat16)[
              "workspace_bytes"]}
    calls = {k: runner(lib, ws[k], args) for k, lib in libs.items()}
    turns = [(k, device_ms(calls[k], a.reps))
             for k in ("old", "new", "new", "old")]
    want = ref.wkv6_bwd_ref(*bhsn, do_bhsn)
    names = ("dr", "dk", "dv", "dw", "du")
    got = {}
    res = {"shape": f"B={b} H={h} S={s} n={n} bf16 r,k,v bshn",
           "turns_ms": turns, "by_library": {}}
    for k, call in calls.items():
        outs = [x.clone() for x in call()]
        torch.cuda.synchronize()
        got[k] = [x.transpose(1, 2) if x.dim() == 4 else x for x in outs]
        shares = {nm: cs._grad_share(x, y, cs.GRAD_TOL["bfloat16"])
                  for nm, x, y in zip(names, got[k], want)}
        split = cs.kernel_split_ms(call)
        if split is None:
            raise SystemExit("wkv6_bwd_pairs: the trace lost events")
        res["by_library"][k] = {
            "ms": [t for kk, t in turns if kk == k],
            "kernel_ms": split, "kernel_share": {
                kk: v / sum(split.values()) for kk, v in split.items()},
            "workspace_bytes": ws[k], "share_of_grad_tol": shares}
    res["new_vs_old_max_abs"] = {
        nm: float((x.float() - y.float()).abs().max())
        for nm, x, y in zip(names, got["new"], got["old"])}
    res["speedup_old_over_new"] = sum(
        t for k, t in turns if k == "old") / sum(
        t for k, t in turns if k == "new")
    res["card"] = cs.nvidia_smi()
    res["seconds"] = time.perf_counter() - t0
    line = json.dumps(res)
    print(line)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
