"""Multi-pod dry run on the meta device: count every (arch x shape x mesh)
cell's step with meta inputs (no allocation, no card), and record its
argument bytes, its counted FLOPs, bytes and collective traffic, and its
roofline (the JAX package's ``repro.launch.dryrun``).

The JAX package lowers and compiles each cell over 512 forced host
devices and walks the HLO (``lower_cell``). The port has no compiler to
ask: ``count_cell``, ``lower_cell``'s counterpart, builds
``train/steps.py``'s step on ``launch/specs.py``'s meta inputs and runs
it once under ``analysis.hlo.count``. Under a mesh the step runs as rank
0 of a ``DistContext`` over a recording stand-in communicator, whose
collectives return meta tensors of the result's shape and record (kind,
bytes, group size); one rank's program is counted, as the reference
counts one device's module.

What the port runs per device differs from the reference's SPMD module:
dense leaves stay whole on every rank (``distributed/sharding.py``),
experts are blocked under ``moe_shard="ep_a2a"``, and the batch is split
over the dp axes. So on the production meshes a dense layer's FLOPs per
device are the reference's times the ``model`` axis, and a rank's
argument bytes may exceed the card's 80 GB: the record says so
(``memory.exceeds_device``), and hides nothing. Temp bytes are not known
on the meta device and are not recorded. There is no ``unroll``: the
port has no scan to unroll. There is no ``--save-hlo``: nothing is
lowered, so there is no HLO to save.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --variant ga1 \\
      --grad-accum 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis import hlo as H
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import DistContext
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import MESHES, make_production_mesh
from repro_torch.models import lm
from repro_torch.train import steps as ST

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
DEVICE_BYTES = 80e9          # one H100's memory


class RecordingComm:
    """A stand-in communicator of ``size`` ranks over the mesh axes
    ``group``. Its collective, ``allreduce`` (the one ``DistContext`` and
    ``train/steps.py`` call), returns a meta tensor of the result's shape
    and records itself with the active count."""

    def __init__(self, size: int, group: str):
        self.size, self.rank, self.group = size, 0, group

    def allreduce(self, x, op=None):
        H.record_collective("all-reduce", _nbytes(x), self.size, self.group)
        return torch.empty_like(x)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def recording_dist(mesh) -> DistContext:
    """Rank 0 of ``mesh`` (a ``launch.mesh.Placement``) as a
    ``DistContext`` whose communicators are ``RecordingComm``s: one per
    axis, and one over the dp axes together."""
    d = DistContext.__new__(DistContext)
    d.shape = dict(mesh.shape)
    d.comm = RecordingComm(math.prod(d.shape.values()), "+".join(d.shape))
    d.batch_shardable = True
    d.coords = {a: 0 for a in d.shape}
    d.comms = {a: RecordingComm(n, a) for a, n in d.shape.items()}
    d.dp_comm = (RecordingComm(d.dp_size, "+".join(d.dp)) if d.dp
                 else None)
    return d


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in lm.tree_leaves(tree))


def _local_rows(shape, dist) -> int:
    """The rows of the global batch a rank computes on."""
    d = ST.make_dist(None, shape, dist)
    return shape.global_batch // (d.dp_size if d is not None
                                  and d.bspec is not None else 1)


def count_cell(cfg, shape, mesh, *, grad_accum=None):
    """Count one call of the cell's step on meta inputs: returns
    (``hlo.ModuleStats``, meta). ``mesh`` is a ``Placement`` or None (one
    card, no collectives). ``meta`` holds the step's name, its
    microbatches (train) and the rank's argument bytes by part."""
    dist = None if mesh is None else recording_dist(mesh)
    params = SP.param_specs(cfg)
    rows = _local_rows(shape, dist)
    batch = SP.batch_specs(cfg, shape)
    mem = {"batch": _tree_bytes(batch) * rows // shape.global_batch}
    if shape.kind == "train":
        ts = ST.make_train_step(cfg, shape, dist, grad_accum=grad_accum)
        opt_state = SP.opt_state_specs(cfg)
        mem.update(params=_tree_bytes(params),
                   opt_state=_tree_bytes(opt_state))
        stats = H.count(ts.fn, params, opt_state, batch)
        return stats, {"step": "train_step", "grad_accum": ts.grad_accum,
                       "arg_bytes": mem}
    if (dist is not None and cfg.moe_shard == "ep_a2a"
            and dist.model_size > 1):
        params = shd.shard_experts(params, cfg, dist)
    mem["params"] = _tree_bytes(params)
    if shape.kind == "prefill":
        ss = ST.make_serve_prefill(cfg, shape, dist)
        stats = H.count(ss.fn, params, batch)
        return stats, {"step": "serve_prefill", "arg_bytes": mem}
    ss = ST.make_serve_decode(cfg, shape, dist)
    state = lm.decode_state_specs(cfg, rows, shape.seq_len)
    pos = SP.decode_specs(cfg, shape)[1]
    mem["decode_state"] = _tree_bytes(state)
    stats = H.count(ss.fn, params, state, batch, pos)
    return stats, {"step": "serve_decode", "arg_bytes": mem}


def run_cell(arch: str, shape_name: str, mesh_key: str, *,
             variant: str = "baseline", grad_accum=None, overrides=None,
             preset: str = "baseline") -> dict:
    cfg = get_config(arch)
    if preset == "optimized":
        from repro_torch.configs import optimized
        cfg = optimized(cfg)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    minfo = MESHES[mesh_key]
    chips = minfo["chips"]

    ok, why = shape_applicable(cfg, shape)
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": minfo["tag"],
        "chips": chips, "variant": variant,
    }
    if not ok:
        rec["status"] = "skip"
        rec["why"] = why
        return rec

    mesh = make_production_mesh(multi_pod=minfo["multi_pod"])
    t0 = time.perf_counter()
    st, meta = count_cell(cfg, shape, mesh, grad_accum=grad_accum)
    rec["count_s"] = round(time.perf_counter() - t0, 2)
    mem = meta.pop("arg_bytes")
    rec.update(meta)
    arg = sum(mem.values())
    rec["memory"] = {
        "argument_size_in_bytes": arg, "by_part": mem,
        "exceeds_device": arg > DEVICE_BYTES,
        "temp_size_in_bytes": None,
        "note": "a rank's arguments under the port's placement (dense "
                "leaves whole on every rank, experts blocked under "
                "ep_a2a, the batch split over dp); temp bytes are not "
                "known on the meta device"}
    rec["collectives"] = {
        "counts": st.coll_counts,
        "wire_bytes": st.wire_bytes,
        "wire_by_group": st.wire_by_group,
        "top_ops": st.top_ops,
        "total_wire_bytes_per_device": st.total_wire_bytes,
    }
    rec["kernels"] = st.kernels
    rec["top_bytes_ops"] = st.top_bytes_ops
    roof = H.Roofline(
        flops_per_device=st.flops,
        bytes_per_device=st.bytes_,
        wire_bytes_per_device=st.total_wire_bytes,
        model_flops_per_device=H.model_flops(cfg, shape, chips),
    )
    rec["roofline"] = roof.as_dict()
    rec["status"] = "ok"
    return rec


def cell_path(variant: str, mesh_tag: str, arch: str, shape: str) -> Path:
    return ART / variant / mesh_tag / f"{arch}__{shape}.json"


def _parse_overrides(items) -> dict:
    overrides = {}
    for kv in items:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "true"):
            v = True
        if v in ("False", "false"):
            v = False
        overrides[k] = v
    return overrides


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--preset", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--override", nargs="*", default=[],
                    help="cfg overrides key=value (e.g. remat=none)")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.override)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    total = ok = skip = fail = 0
    for mesh_key in meshes:
        for arch in args.arch:
            for shape in args.shape:
                total += 1
                out = cell_path(args.variant, MESHES[mesh_key]["tag"], arch,
                                shape)
                if args.skip_existing and out.exists():
                    prev = json.loads(out.read_text())
                    if prev.get("status") in ("ok", "skip"):
                        print(f"[cached] {mesh_key:6s} {arch:24s} {shape}")
                        ok += prev["status"] == "ok"
                        skip += prev["status"] == "skip"
                        continue
                t0 = time.perf_counter()
                try:
                    rec = run_cell(arch, shape, mesh_key,
                                   variant=args.variant,
                                   grad_accum=args.grad_accum,
                                   overrides=overrides or None,
                                   preset=args.preset)
                except Exception as e:  # a failing cell is a bug — record it
                    rec = {"arch": arch, "shape": shape,
                           "mesh": MESHES[mesh_key]["tag"],
                           "variant": args.variant, "status": "fail",
                           "error": repr(e),
                           "traceback": traceback.format_exc()[-4000:]}
                out.parent.mkdir(parents=True, exist_ok=True)
                out.write_text(json.dumps(rec, indent=1))
                dt = time.perf_counter() - t0
                if rec["status"] == "ok":
                    ok += 1
                    r = rec["roofline"]
                    mem = rec["memory"]["argument_size_in_bytes"]
                    print(f"[ok {dt:6.1f}s] {mesh_key:6s} {arch:24s} "
                          f"{shape:12s} args/dev={mem / 2**30:7.2f}GiB "
                          f"c={r['compute_s']:.2e}s m={r['memory_s']:.2e}s "
                          f"coll={r['collective_s']:.2e}s "
                          f"dom={r['bottleneck']:10s} "
                          f"frac={r['roofline_fraction']:.3f}", flush=True)
                elif rec["status"] == "skip":
                    skip += 1
                    print(f"[skip] {mesh_key:6s} {arch:24s} {shape:12s} "
                          f"{rec['why']}", flush=True)
                else:
                    fail += 1
                    print(f"[FAIL {dt:6.1f}s] {mesh_key:6s} {arch:24s} "
                          f"{shape:12s} {rec['error'][:200]}", flush=True)
    print(f"\ndryrun: {ok} ok, {skip} skip, {fail} fail / {total} cells")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
