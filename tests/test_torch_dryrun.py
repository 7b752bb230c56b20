"""The port's dry run (``launch/mesh.py``, ``launch/specs.py``,
``launch/dryrun.py``) against the JAX package's, and the kernels' meta
route.

* ``MESHES`` and the mesh shapes equal the reference's.
* ``specs`` gives meta tensors equal, leaf for leaf in shape and dtype,
  to the reference's ``ShapeDtypeStruct``s for all ten archs x the four
  ``SHAPES`` (params, optimizer state, batch with frames, ctx and
  labels, decode state and positions).
* ``count_cell`` of smollm-135m cut to 2 layers (``remat="none"``) on one
  device against the reference's ``analyze_module`` of the same cell,
  lowered and compiled in ONE module-scoped subprocess (the reference's
  mesh needs its own device count; this process keeps the real
  single-device view):

  - train 4 x 128: within 1 %. The attention terms differ and nearly
    cancel: the reference differentiates its oracle over the full S x S
    (12 B H S^2 Dh a layer: 4 forward, 8 backward), the port charges
    the kernel's causal triangle (4 B H Dh S(S+1)/2) and counts the
    torch-op backward of ``kernels/flash_attention/bwd.py``, which
    recomputes Q K^T and runs four more products over the whole S x S
    (10 B H S^2 Dh, one block of query rows, as S <= 1024). Everything
    else is equal, so the difference is exactly those terms.
  - prefill 4 x 128: the reference's oracle computes 4 B H S^2 Dh a
    layer, the kernel the causal triangle: the port is 1.9 % below, and
    adding that one term back gives the reference's count exactly. At
    prefill 4 x 32 (the triangle's share four times smaller) the raw
    counts are within 1 %.
  - decode at batch 4 over a 128-token cache: held term by term, each
    term named: the q/k/v/o projections and the FFN, the LM head, the
    attention over the cache (scores and the weighted sum), and the
    cache update, a one-hot product under ``kv_update="onehot"`` that is
    elementwise in both packages and so counts no dot FLOPs.

* ``count_cell`` on a (2, 2, 2) placement for a reduced granite-moe
  (the counterpart of ``tests/test_distributed.py::
  test_small_mesh_dryrun_lowers``) is "ok", with wire bytes on ``pod``
  and ``data``; ``run_cell`` records skips with ``shape_applicable``'s
  reason.
"""
import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import specs as ref_SP  # noqa: E402
from repro_torch.analysis import hlo as H  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh, specs as SP  # noqa: E402
from repro_torch.models import lm  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
CELL = dict(n_layers=2, remat="none")       # dryrun's --override
CELLS = {"train": ("train_4k", 4, 128), "prefill": ("prefill_32k", 4, 128),
         "prefill_short": ("prefill_32k", 4, 32),
         "decode": ("decode_32k", 4, 128)}
REL = 0.01

REFERENCE = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from repro.analysis import hlo as H
    from repro.configs import get_config, SHAPES
    from repro.launch import mesh as M, specs as SP
    from repro.train import steps as ST

    cells = json.loads(sys.argv[1])
    cfg = dataclasses.replace(get_config("smollm-135m"),
                              **json.loads(sys.argv[2]))
    vocab = cfg.padded_vocab
    mesh = M.make_test_mesh((1, 1), ("data", "model"))

    def term(ins, comp):
        ops = [H._shape_dims(comp.symbols.get(o, ""))
               for o in ins.operands]
        if vocab in H._shape_dims(ins.shape):
            return "head"
        if any(len(d) == 4 for d in ops):
            return "attention over the cache"
        return "projections and FFN"

    def by_term(text):
        out = {}
        real = H._split_computations
        for name in ("head", "attention over the cache",
                     "projections and FFN"):
            def only(t, name=name):
                comps = real(t)
                for c in comps.values():
                    for ins in c.instrs:
                        if ins.op == "dot" and term(ins, c) != name:
                            ins.op = "dot-elsewhere"
                return comps
            H._split_computations = only
            try:
                out[name] = H.analyze_module(text).flops
            finally:
                H._split_computations = real
        return out

    out = {"meshes": {
        "multi": dict(M.make_production_mesh(multi_pod=True).shape),
        "single": dict(M.make_production_mesh().shape),
        "test": dict(M.make_test_mesh((2, 2, 2),
                                      ("pod", "data", "model")).shape)}}
    for key, (base, b, s) in cells.items():
        shape = dataclasses.replace(SHAPES[base], seq_len=s,
                                    global_batch=b)
        if shape.kind == "train":
            st = ST.make_train_step(cfg, shape, mesh, grad_accum=1)
            args = (SP.param_specs(cfg), SP.opt_state_specs(cfg),
                    SP.batch_specs(cfg, shape))
        elif shape.kind == "prefill":
            st = ST.make_serve_prefill(cfg, shape, mesh)
            args = (SP.param_specs(cfg), SP.batch_specs(cfg, shape))
        else:
            st = ST.make_serve_decode(cfg, shape, mesh)
            state, pos = SP.decode_specs(cfg, shape)
            args = (SP.param_specs(cfg), state, SP.batch_specs(cfg, shape),
                    pos)
        text = jax.jit(st.fn, in_shardings=st.in_shardings,
                       out_shardings=st.out_shardings).lower(
            *args).compile().as_text()
        ms = H.analyze_module(text)
        out[key] = {"flops": ms.flops, "bytes": ms.bytes_,
                    "terms": by_term(text) if key == "decode" else None}
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    r = subprocess.run(
        [sys.executable, "-c", REFERENCE, json.dumps(CELLS),
         json.dumps(CELL)], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
             "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _cfg():
    return dataclasses.replace(get_config("smollm-135m"), **CELL)


def _shape(key):
    base, b, s = CELLS[key]
    return dataclasses.replace(SHAPES[base], seq_len=s, global_batch=b)


def _port(key):
    return D.count_cell(_cfg(), _shape(key), None,
                        grad_accum=1 if key == "train" else None)


def _attention(b, s, c, factor):
    """``factor`` B H S^2 Dh over the cell's layers."""
    return factor * b * c.n_heads * s * s * c.d_head * c.n_layers


# --------------------------------------------------------------------------
# mesh and specs
# --------------------------------------------------------------------------

def test_meshes_equal_the_reference(reference):
    assert mesh.MESHES == ref_mesh.MESHES
    assert mesh.make_production_mesh(multi_pod=True).shape == \
        reference["meshes"]["multi"]
    assert mesh.make_production_mesh().shape == reference["meshes"]["single"]
    m = mesh.make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    assert m.shape == reference["meshes"]["test"] and m.size == 8
    assert shd.dp_axes(m) == ("pod", "data")


def _ref_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _port_leaves(tree) -> dict:
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in zip(shd.leaf_paths(tree), lm.tree_leaves(tree))
            if t.device.type == "meta"}


@pytest.mark.parametrize("arch", list(REF_ARCHS))
def test_specs_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert _port_leaves(SP.param_specs(cfg)) == \
        _ref_leaves(ref_SP.param_specs(rcfg))
    assert _port_leaves(SP.opt_state_specs(cfg)) == \
        _ref_leaves(ref_SP.opt_state_specs(rcfg))
    for name in SHAPES:
        got = SP.batch_specs(cfg, SHAPES[name])
        want = ref_SP.batch_specs(rcfg, REF_SHAPES[name])
        assert _port_leaves(got) == _ref_leaves(want)
        assert all(t.is_meta for t in got.values())
        assert ("frames" in got) == (cfg.frontend == "frames")
        assert ("labels" in got) == (SHAPES[name].kind == "train")
        state, pos = SP.decode_specs(cfg, SHAPES[name])
        rstate, rpos = ref_SP.decode_specs(rcfg, REF_SHAPES[name])
        assert _port_leaves(state) == _ref_leaves(rstate)
        assert _port_leaves({"pos": pos}) == _ref_leaves({"pos": rpos})


# --------------------------------------------------------------------------
# count_cell against the reference's HLO walk
# --------------------------------------------------------------------------

def test_train_cell_within_1pct_of_the_reference(reference):
    c = _cfg()
    st, meta = _port("train")
    want = reference["train"]["flops"]
    assert meta == {"step": "train_step", "grad_accum": 1,
                    "arg_bytes": meta["arg_bytes"]}
    assert abs(st.flops - want) / want < REL
    # the attention terms: the reference's 12 B H S^2 Dh a layer against
    # the kernel's triangle and the torch-op backward's 10 B H S^2 Dh
    b, s = 4, 128
    ref_attn = _attention(b, s, c, 12)
    port_attn = (st.kernels["flash_attention"]["flops"]
                 + _attention(b, s, c, 10))
    assert st.kernels["flash_attention"] == {
        "launches": c.n_layers, "flops": fops.work(
            b, c.n_heads, c.n_kv_heads, s, c.d_head, "float32")[0]
        * c.n_layers, "bytes": st.kernels["flash_attention"]["bytes"]}
    assert st.flops - port_attn == want - ref_attn


def test_prefill_cell_differs_by_the_causal_triangle_alone(reference):
    c = _cfg()
    st, _ = _port("prefill")
    want = reference["prefill"]["flops"]
    b, s = 4, 128
    oracle = _attention(b, s, c, 4)
    triangle = st.kernels["flash_attention"]["flops"]
    assert triangle == 4 * b * c.n_heads * c.d_head * s * (s + 1) // 2 \
        * c.n_layers
    assert st.flops - triangle + oracle == want
    assert 0.015 < (want - st.flops) / want < 0.02


def test_short_prefill_cell_within_1pct_of_the_reference(reference):
    st, _ = _port("prefill_short")
    want = reference["prefill_short"]["flops"]
    assert abs(st.flops - want) / want < REL


def test_decode_cell_term_by_term(reference):
    c = _cfg()
    st, _ = _port("decode")
    vocab = c.padded_vocab
    terms = {"head": 0.0, "attention over the cache": 0.0,
             "projections and FFN": 0.0}
    for key, f in st.dot_flops.items():
        if key.startswith("bmm"):
            terms["attention over the cache"] += f
        elif f"{vocab})" in key or f"{vocab}," in key:
            terms["head"] += f
        else:
            terms["projections and FFN"] += f
    assert terms == reference["decode"]["terms"]
    b, cache = 4, 128
    assert terms["attention over the cache"] == 2 * (
        2 * b * c.n_heads * cache * c.d_head) * c.n_layers
    assert terms["head"] == 2 * b * c.d_model * vocab
    # the cache update is a one-hot product, elementwise in both: no
    # dot FLOPs, so the named terms make up both totals
    assert sum(terms.values()) == st.flops == reference["decode"]["flops"]
    assert st.kernels == {}


# --------------------------------------------------------------------------
# mesh cells, records and the CLI
# --------------------------------------------------------------------------

def _small_moe():
    return dataclasses.replace(
        get_config("granite-moe-1b-a400m").reduced(), d_model=64,
        n_heads=2, n_kv_heads=1, d_head=32, moe_shard="ep_a2a")


@pytest.mark.parametrize("base", ["train_4k", "prefill_32k", "decode_32k"])
def test_small_mesh_cells_count(base):
    cfg = _small_moe()
    m = mesh.make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    shape = dataclasses.replace(SHAPES[base], seq_len=64, global_batch=8)
    st, meta = D.count_cell(cfg, shape, m)
    assert st.flops > 0 and st.bytes_ > 0

    def wire(axis):                  # over a group that spans ``axis``
        return sum(v for g, v in st.wire_by_group.items()
                   if axis in g.split("+"))
    # the experts' partial outputs are summed over model in every step
    assert wire("model") > 0
    if base == "train_4k":
        # the gradients are averaged over the dp ranks: pod and data
        assert wire("pod") > 0 and wire("data") > 0
        assert st.wire_by_group["pod+data"] == st.wire_bytes[
            "all-reduce"] - st.wire_by_group["model"]
        assert st.kernels["flash_attention"]["launches"] == cfg.n_layers
    # a rank's rows of the batch: 8 over pod 2 x data 2
    assert meta["arg_bytes"]["batch"] * 4 == sum(
        t.numel() * t.element_size()
        for t in SP.batch_specs(cfg, shape).values())


def test_small_mesh_run_cell_record(monkeypatch):
    monkeypatch.setattr(D, "make_production_mesh",
                        lambda multi_pod: mesh.make_test_mesh(
                            (2, 2, 2), ("pod", "data", "model")))
    monkeypatch.setattr(D, "get_config", lambda arch: _small_moe())
    monkeypatch.setitem(D.SHAPES, "tiny", dataclasses.replace(
        SHAPES["train_4k"], seq_len=64, global_batch=8))
    rec = D.run_cell("granite-moe-1b-a400m", "tiny", "multi")
    assert rec["status"] == "ok" and rec["step"] == "train_step"
    assert rec["collectives"]["total_wire_bytes_per_device"] > 0
    assert rec["memory"]["temp_size_in_bytes"] is None
    assert rec["memory"]["exceeds_device"] is False
    r = rec["roofline"]
    assert r["compute_s"] == rec["roofline"]["flops_per_device"] / \
        H.PEAK_FLOPS
    json.dumps(rec)


def test_run_cell_skip_carries_the_reason():
    rec = D.run_cell("llama3-8b", "long_500k", "single")
    assert rec["status"] == "skip"
    assert rec["why"] == "SKIP(full-attention): 500k decode needs " \
        "sub-quadratic mixing"


def test_cli_writes_the_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(D, "ART", tmp_path)
    D.main(["--arch", "llama3-8b", "--shape", "long_500k", "--mesh",
            "single"])
    out = capsys.readouterr().out
    assert "0 ok, 1 skip, 0 fail / 1 cells" in out
    rec = json.loads(D.cell_path("baseline", "pod16x16", "llama3-8b",
                                 "long_500k").read_text())
    assert rec["status"] == "skip"
    assert D.ART == tmp_path and D.cell_path(
        "v", "m", "a", "s").parent.parent.parent == tmp_path


def test_artifacts_are_ignored():
    assert Path(D.__file__).resolve().parents[3] / "artifacts" / \
        "dryrun_torch" == Path(SRC).parent / "artifacts" / "dryrun_torch"
    ignore = (Path(SRC).parent / ".gitignore").read_text().splitlines()
    assert "artifacts/*" in ignore


def test_count_cell_allocates_nothing():
    st, meta = D.count_cell(_cfg(), _shape("prefill"), None)
    assert meta["arg_bytes"]["params"] == sum(
        t.numel() * t.element_size()
        for t in lm.tree_leaves(SP.param_specs(_cfg())))
    assert all(t.is_meta for t in lm.tree_leaves(SP.param_specs(_cfg())))
