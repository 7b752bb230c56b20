"""The port's distribution layer (``repro_torch.distributed``) against the
JAX package's, on the same numpy inputs.

Every JAX mesh reference (the int8 ``make_cmpi_train_step`` on a
(2, 2, 2) mesh, the vocab-parallel functions and their ``jax.grad`` on
data 2 x model 2, ``psum_int8`` over two pods) runs in ONE module-scoped
subprocess with 8 forced host devices, as ``tests/test_distributed.py``
runs its mesh tests; this process keeps the real single-device view. The
port's ranks run as ``run_threads`` threads, or as ``run_processes``
processes for the train step, on the CPU."""
import dataclasses
import functools
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as ref_core  # noqa: E402
from repro.configs import SHAPES, get_config, optimized  # noqa: E402
from repro.distributed import compression as ref_C  # noqa: E402
from repro.distributed import host_coord as ref_hc  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.train import data as ref_D  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch import core as port_core  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.distributed import compression as C  # noqa: E402
from repro_torch.distributed import host_coord as hc  # noqa: E402
from repro_torch.distributed.context import DistContext  # noqa: E402
from repro_torch.distributed.schedules import (  # noqa: E402
    make_cmpi_train_step, sync_grads)
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
POOL = 16 << 20
# the train step of tests/test_distributed.py, smollm-135m reduced at 8
# sequences of 32 tokens, in f32 compute: in its bf16 the two frameworks
# round at other places, and their gradients part by ~1e-2 of a leaf's
# largest |g| (so do one process's and four ranks' in the port alone),
# far above the bound that shows the sync right
STEP_SHAPE = dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                 global_batch=8)
STEP_CFG = dict(compute_dtype="float32")
LOSS_RTOL = 1e-5
# the vocab-parallel case of tests/test_distributed.py
VP = dict(vocab_parallel=True, vocab_size=64, vocab_pad_multiple=4,
          compute_dtype="float32")
VP_B, VP_S = 4, 8
# the psum_int8 scale fault: what each of two pods holds
POD_INPUTS = ([1.0, 0.5, 0.25, 0.0], [0.01, 0.005, 0.0025, 0.0])

_MESH_PROG = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config, SHAPES
from repro.distributed.compression import psum_int8
from repro.distributed.context import DistContext
from repro.distributed.schedules import make_cmpi_train_step, sync_grads
from repro.launch.mesh import make_test_mesh
from repro.models import lm
from repro.train import optimizer as opt, data as D

out = {}
# 1. the int8 cMPI step on the (pod, data, model) = (2, 2, 2) mesh
cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                          compute_dtype="float32")
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=8)
mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
out["mesh_devices"] = np.array([d.id for d in mesh.devices.flat])
params = lm.init(cfg, jax.random.key(0))
ostate = opt.init(opt.for_model(cfg), params)
batch = {k: jnp.asarray(v) for k, v in
         D.SyntheticLM(D.for_model(cfg, shape)).batch(0).items()}
fn, in_sh, out_sh = make_cmpi_train_step(cfg, shape, mesh,
                                         compression="int8")
p2, _, m = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
    params, ostate, batch)
for i, leaf in enumerate(jax.tree.leaves(p2)):
    out[f"int8_param_{i}"] = np.asarray(leaf)
out["int8_loss"] = np.asarray(m["loss"])


# the same step's synced, dp-averaged gradients, and one quantum of each
# data block of every leaf: the pods' largest int8 scale of the block
# (the one psum_int8 applies), over the dp size
def synced_int8(p, b):
    _, g = jax.value_and_grad(lambda q: lm.loss_fn(q, cfg, b),
                              has_aux=True)(p)

    def quantum(x):
        xf = x.astype(jnp.float32).reshape(-1)
        xf = jnp.concatenate([xf, jnp.zeros((-xf.size) % 2, jnp.float32)])
        shard = jax.lax.psum_scatter(xf.reshape(2, -1), "data",
                                     scatter_dimension=0, tiled=False)
        s = jax.lax.pmax(jnp.max(jnp.abs(shard)) / 127.0, "pod")
        return jax.lax.all_gather(s, "data") / 4

    synced = sync_grads(g, data_axis="data", pod_axis="pod",
                        compression="int8")
    return jax.tree.map(lambda x: x / 4, synced), jax.tree.map(quantum, g)


bsp = {k: P(("pod", "data"), None) for k in batch}
grads, quanta = jax.jit(jax.shard_map(
    synced_int8, mesh=mesh, in_specs=(P(), bsp), out_specs=P(),
    check_vma=False))(params, batch)
for i, (g, q) in enumerate(zip(jax.tree.leaves(grads),
                               jax.tree.leaves(quanta))):
    out[f"int8_grad_{i}"], out[f"int8_quantum_{i}"] = (np.asarray(g),
                                                       np.asarray(q))

# 2. the vocab-parallel functions on data 2 x model 2, and their grads
VP = dict(vocab_parallel=True, vocab_size=64, vocab_pad_multiple=4,
          compute_dtype="float32")
vcfg = dataclasses.replace(get_config("smollm-135m").reduced(), **VP)
dist = DistContext(make_test_mesh((2, 2), ("data", "model")))
inp = dict(np.load(sys.argv[2]))
table, x = jnp.asarray(inp["table"]), jnp.asarray(inp["x"])
toks = jnp.asarray(inp["toks"])
out["vp_embed"] = np.asarray(jax.jit(
    lambda t, tk: dist.vp_embed(t, tk, vcfg))(table, toks))
out["vp_ce"] = np.asarray(jax.jit(
    lambda t, xx, tk: dist.vp_cross_entropy(t, xx, tk, vcfg))(table, x, toks))
out["vp_token"] = np.asarray(jax.jit(
    lambda t, xx: dist.vp_greedy_token(t, xx, vcfg))(table, x[:, 0]))
out["vp_embed_dtable"] = np.asarray(jax.jit(jax.grad(
    lambda t: (dist.vp_embed(t, toks, vcfg) * inp["cot_e"]).sum()))(table))
dt, dx = jax.jit(jax.grad(lambda t, xx: (dist.vp_cross_entropy(
    t, xx, toks, vcfg) * inp["cot_ce"]).sum(), argnums=(0, 1)))(table, x)
out["vp_ce_dtable"], out["vp_ce_dx"] = np.asarray(dt), np.asarray(dx)

# 3. psum_int8 over two pods
pods = make_test_mesh((2,), ("pod",))
got = jax.shard_map(lambda a: psum_int8(a[0], "pod")[None], mesh=pods,
                    in_specs=P("pod"), out_specs=P("pod"))(
    jnp.asarray(inp["pod_inputs"]))
out["psum_int8"] = np.asarray(got)

# 4. shard_leaf: each device's block of a NamedSharding, by device id
import json
from jax.sharding import NamedSharding
for mshape, axes in (((2, 2), ("data", "model")),
                     ((2, 2, 2), ("pod", "data", "model"))):
    m = make_test_mesh(mshape, axes)
    for i, spec in enumerate(SHARD_SPECS[len(mshape)]):
        arr = jax.device_put(jnp.asarray(inp["leaf"]),
                             NamedSharding(m, P(*spec)))
        for sh in arr.addressable_shards:
            out[f"leaf_{len(mshape)}_{i}_{sh.device.id}"] = np.asarray(sh.data)

# 5. moe_apply_ep on data 2 x model 2 (dist above), y, aux and jax.grad
from repro.models import blocks as B
ecfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                           compute_dtype="float32")
ep_p = {k: jnp.asarray(inp["ep_" + k]) for k in EP_KEYS}
for cf in EP_CAPACITY:
    c = dataclasses.replace(ecfg, moe=dataclasses.replace(ecfg.moe,
                                                          capacity_factor=cf))
    for tag in ("prefill", "decode"):
        w = jnp.asarray(inp[f"ep_w_{tag}"])

        def f(p, x):
            y, aux = B.moe_apply_ep(p, c, x, dist)
            return (y * w).sum() + 3 * aux, (y, aux)

        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(ep_p,
                                              jnp.asarray(inp[f"ep_x_{tag}"]))
        key = f"ep_{cf}_{tag}"
        out[key + "_y"], out[key + "_aux"] = np.asarray(y), np.asarray(aux)
        out[key + "_gx"] = np.asarray(gx)
        for k in EP_KEYS:
            out[key + "_g_" + k] = np.asarray(gp[k])

# 6. the serve steps on data 2 x model 2: granite-moe reduced under the
# JAX package's serving flags (optimized), f32, prefill then decode
from repro.configs import InputShape, optimized
from repro.train import steps as ST
scfg = dataclasses.replace(
    optimized(get_config("granite-moe-1b-a400m").reduced()), **SERVE_CFG)
mesh = make_test_mesh((2, 2), ("data", "model"))
sp = lm.init(scfg, jax.random.key(SERVE_SEED))
toks = jnp.asarray(inp["serve_toks"])
pre = ST.make_serve_prefill(scfg, InputShape("p", "prefill", *SERVE_PREFILL),
                            mesh)
out["serve_logits"] = np.asarray(jax.jit(
    pre.fn, in_shardings=pre.in_shardings,
    out_shardings=pre.out_shardings)(sp, {"tokens": toks}))
dec = ST.make_serve_decode(scfg, InputShape("d", "decode", *SERVE_DECODE),
                           mesh)
step = jax.jit(dec.fn, in_shardings=dec.in_shardings,
               out_shardings=dec.out_shardings)
state = lm.decode_state_init(scfg, SERVE_DECODE[1], SERVE_DECODE[0])
tok, pos = toks[:, :1], jnp.zeros((SERVE_DECODE[1],), jnp.int32)
for i in range(SERVE_STEPS):
    got, state = step(sp, state, {"tokens": tok}, pos)
    out[f"serve_token_{i}"] = np.asarray(got)
    tok, pos = got[:, None], pos + 1
tr = ST.make_train_step(scfg, InputShape("t", "train", *SERVE_PREFILL), mesh)
out["serve_specs"] = np.array(json.dumps([
    [list(x) if isinstance(x, tuple) else x for x in s.spec]
    for ss in (pre, dec, tr) for s in jax.tree.leaves(
        (ss.in_shardings, ss.out_shardings))]))

# 7. make_train_step on data 2 x model 2: granite-moe reduced in f32,
# ep_a2a, the vocab split, capacity factor 8; the gradient of its loss
# (jax.grad under the step's own dist and shardings), then the step
tcfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                           compute_dtype="float32")
tparams = lm.init(tcfg, jax.random.key(DIST_STEP_SEED))
tshape = dataclasses.replace(SHAPES["train_4k"], seq_len=DIST_STEP[0],
                             global_batch=DIST_STEP[1])
tbatch = {k: jnp.asarray(v) for k, v in
          D.SyntheticLM(D.for_model(tcfg, tshape)).batch(0).items()}
tcfg = dataclasses.replace(tcfg, moe_shard="ep_a2a", vocab_parallel=True,
                           moe=dataclasses.replace(tcfg.moe,
                                                   capacity_factor=8.0))
tr = ST.make_train_step(tcfg, tshape, mesh)
tdist = ST.make_dist(tcfg, tshape, mesh)
tg = jax.jit(jax.grad(lambda p, b: lm.loss_fn(p, tcfg, b, dist=tdist)[0]),
             in_shardings=tr.in_shardings[::2])(tparams, tbatch)
tp2, _, tm = jax.jit(tr.fn, in_shardings=tr.in_shardings,
                     out_shardings=tr.out_shardings)(
    tparams, opt.init(opt.for_model(tcfg), tparams), tbatch)
for i, (g, p2) in enumerate(zip(jax.tree.leaves(tg), jax.tree.leaves(tp2))):
    out[f"dist_grad_{i}"], out[f"dist_param_{i}"] = (np.asarray(g),
                                                     np.asarray(p2))
out["dist_loss"], out["dist_aux"] = (np.asarray(tm["loss"]),
                                     np.asarray(tm["aux"]))
out["dist_ga"] = np.asarray(tr.grad_accum)
np.savez(sys.argv[1], **out)
"""


# shard_leaf against NamedSharding: a split dim, a dim over two axes in
# both orders, a replicated dim, on the (2, 2) and (2, 2, 2) meshes
SHARD_SPECS = {2: [("data", None), (("model", "data"), None),
                   (None, "model"), (None, None), ("model", ("data",))],
               3: [(("pod", "data"), "model"), (("model", "pod"), None),
                   (None, ("data", "model", "pod"))]}
# moe_apply_ep on data 2 x model 2: granite-moe reduced (4 experts,
# top 2), f32, 4 rows of 16 tokens (prefill: one group of 32 a dp rank)
# and 4 rows of one (decode), the router biased to experts 0 and 2 (each
# model rank's first) so that their queues overflow at the published
# capacity factor and the slot clobber shows; at 8.0 nothing drops.
EP_KEYS = ("router", "w_gate", "w_up", "w_down")
EP_CAPACITY = (1.25, 8.0)
EP_B, EP_S = 4, 16
# y and each gradient leaf within EP_TOL x its largest |value| (f32 sums
# over the slots and over model in other orders); aux within EP_TOL
EP_TOL = 1e-5
# the serve steps: granite-moe reduced, optimized's serving flags, f32
# (a float32 KV cache: kv_update="dus" takes no other under f32), the
# vocab split over model; prefill (seq, batch) and decode (cache, batch)
SERVE_CFG = dict(compute_dtype="float32", kv_cache_dtype="float32",
                 vocab_parallel=True)
SERVE_SEED = 2
SERVE_PREFILL = (8, 4)
SERVE_DECODE = (16, 4)
SERVE_STEPS = 3
SERVE_TOL = 1e-4              # logits, absolute
# make_train_step under a dist: (seq, global batch) and the weights' seed
DIST_STEP = (16, 4)
DIST_STEP_SEED = 4


def _prelude() -> str:
    """The constants the mesh program shares with this module."""
    names = ("SHARD_SPECS", "EP_KEYS", "EP_CAPACITY", "SERVE_CFG",
             "SERVE_SEED", "SERVE_PREFILL", "SERVE_DECODE", "SERVE_STEPS",
             "DIST_STEP", "DIST_STEP_SEED")
    return "".join(f"{n} = {globals()[n]!r}\n" for n in names)


def _ep_inputs():
    """moe_apply_ep's inputs (numpy, seeded): the expert params, x and
    the cotangent w of a prefill and a decode shape."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    rng = np.random.default_rng(11)
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    out = {"ep_router": 0.3 * rng.standard_normal((D, E), np.float32),
           "ep_w_gate": rng.standard_normal((E, D, Fd), np.float32)
           / np.sqrt(D),
           "ep_w_up": rng.standard_normal((E, D, Fd), np.float32)
           / np.sqrt(D),
           "ep_w_down": rng.standard_normal((E, Fd, D), np.float32)
           / np.sqrt(Fd)}
    out["ep_router"][0] = [1.0, 0.0, 1.0, 0.0]
    for tag, s in (("prefill", EP_S), ("decode", 1)):
        x = rng.standard_normal((EP_B, s, D), np.float32)
        x[..., 0] = 2.0
        out[f"ep_x_{tag}"] = x
        out[f"ep_w_{tag}"] = rng.standard_normal((EP_B, s, D), np.float32)
    return out


def _vp_inputs():
    """The vocab-parallel case's inputs (numpy, seeded) and their
    cotangents."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), **VP)
    rng = np.random.default_rng(3)
    V, D = cfg.padded_vocab, cfg.d_model
    return {"table": rng.standard_normal((V, D), dtype=np.float32),
            "x": rng.standard_normal((VP_B, VP_S, D), dtype=np.float32),
            "toks": rng.integers(0, cfg.vocab_size, (VP_B, VP_S),
                                 dtype=np.int32),
            "cot_e": rng.standard_normal((VP_B, VP_S, D), dtype=np.float32),
            "cot_ce": rng.standard_normal((VP_B, VP_S), dtype=np.float32),
            "pod_inputs": np.array(POD_INPUTS, np.float32),
            "leaf": np.arange(8 * 16 * 8, dtype=np.float32).reshape(
                8, 16, 8),
            "serve_toks": rng.integers(0, 128, SERVE_PREFILL[::-1],
                                       dtype=np.int32),
            **_ep_inputs()}


@pytest.fixture(scope="module", autouse=True)
def _mesh_run(tmp_path_factory):
    """Start the subprocess of every JAX mesh reference with the module's
    first test, so that it runs beside the port's ranks."""
    d = tmp_path_factory.mktemp("mesh")
    np.savez(d / "inputs.npz", **_vp_inputs())
    proc = subprocess.Popen(
        [sys.executable, "-c", _prelude() + _MESH_PROG, str(d / "out.npz"),
         str(d / "inputs.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
             "HOME": str(d), "JAX_PLATFORMS": "cpu"})
    try:
        yield d, proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def mesh_ref(_mesh_run):
    """Every JAX mesh reference of this file, from that subprocess."""
    d, proc = _mesh_run
    _, err = proc.communicate(timeout=540)
    assert proc.returncode == 0, f"stderr:\n{err[-3000:]}"
    return dict(np.load(d / "out.npz"))


# ---------------------------------------------------------------------------
# host_coord: the same rank program under both packages' run_threads
# ---------------------------------------------------------------------------

def _coord_prog(env, mod):
    c, r = env.comm, env.rank
    metrics = {"loss": 1.5 * (r + 1), "tokens": 10.0 * r, "step": r}
    manifest = {"step": 40 + r, "leaves": [f"leaf_{i}" for i in range(r + 2)],
                "rank": r} if r == 1 else None
    return (mod.allreduce_metrics(c, metrics),
            mod.allreduce_metrics(c, metrics, op=np.maximum),
            mod.bcast_manifest(c, manifest, root=1),
            mod.sync_epoch(c, 7 + r, root=c.size - 1),
            mod.agree_max_step(c, [12, 40, 3, 40][r]))


@pytest.mark.parametrize("n", [3, 4])
def test_host_coord_matches_reference(n):
    want = ref_core.run_threads(n, functools.partial(_coord_prog, mod=ref_hc))
    got = port_core.run_threads(n, functools.partial(_coord_prog, mod=hc),
                                device="cpu")
    assert got == want
    assert got[0][0] == {"loss": 1.5 * n * (n + 1) / 2,
                         "tokens": 10.0 * n * (n - 1) / 2,
                         "step": n * (n - 1) / 2}
    assert got[0][3] == 7 + n - 1 and got[0][4] == 40


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_int8_encode_decode_and_error_feedback_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 128)).astype(np.float32)
    q, s = C.int8_encode(torch.from_numpy(x))
    jq, js = ref_C.int8_encode(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(C.int8_decode(q, s).numpy(),
                               np.asarray(ref_C.int8_decode(jq, js)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(C.quantize_error(torch.from_numpy(x)).numpy(),
                               np.asarray(ref_C.quantize_error(
                                   jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    # four rounds of error feedback, as tests/test_distributed.py runs them
    totals = []
    for mod, arr, zeros in ((C, torch.from_numpy(x), torch.zeros_like),
                            (ref_C, jnp.asarray(x), jnp.zeros_like)):
        resid = mod.ErrorFeedback.init({"g": arr})
        total = zeros(arr)
        for _ in range(4):
            comp, new_r = mod.ErrorFeedback.apply({"g": arr}, resid)
            dec = mod.int8_decode(*mod.int8_encode(comp["g"]))
            resid = new_r({"g": dec})
            total = total + dec
        totals.append(np.asarray(total))
    np.testing.assert_allclose(totals[0], totals[1], rtol=1e-6, atol=1e-6)
    assert float(np.abs(totals[0] / 4 - x).max()) < float(s.max())


# ---------------------------------------------------------------------------
# the cMPI train step: 4 processes (pod 2 x data 2) against the JAX step
# ---------------------------------------------------------------------------

def _ref_setup():
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              **STEP_CFG)
    params = ref_lm.init(cfg, jax.random.key(0))
    batch = ref_D.SyntheticLM(ref_D.for_model(cfg, STEP_SHAPE)).batch(0)
    return cfg, params, batch


def _step_prog(env, tree, batch):
    """One step with each compression from the same params, in its three
    parts; rank 0 also returns its synced, dp-averaged gradients and its
    params after the step, every rank a digest of both."""
    cfg = dataclasses.replace(port_config("smollm-135m").reduced(),
                              **STEP_CFG)
    dist = DistContext(env.comm, (2, 2), ("pod", "data"))
    out = {"coords": dist.coords, "dp_index": dist.dp_index}
    for comp in ("none", "int8"):
        params = lm.params_from_numpy(cfg, tree, device="cpu")
        state = opt.init(opt.for_model(cfg), params)
        step = make_cmpi_train_step(cfg, STEP_SHAPE, dist, compression=comp)
        grads, metrics = step.grads(params, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
        grads = step.sync(grads)
        m = step.update(params, state, grads, metrics)
        leaves = [p.detach().numpy() for p in lm.tree_leaves(params)]
        synced = [g.numpy() for g in lm.tree_leaves(grads)]
        out[comp] = {"loss": float(m["loss"]),
                     "digest": hashlib.sha256(b"".join(
                         a.tobytes() for a in leaves + synced)).hexdigest(),
                     "params": leaves if env.rank == 0 else None,
                     "grads": synced if env.rank == 0 else None}
    return out


@pytest.fixture(scope="module")
def port_steps():
    cfg, params, batch = _ref_setup()
    tree = jax.tree.map(np.asarray, params)
    return port_core.run_processes(
        4, functools.partial(_step_prog, tree=tree, batch=batch),
        pool_bytes=POOL, cell_size=4096, device="cpu", timeout=240)


def _update_of(cfg, tree, grads) -> list:
    """The port's optimizer step from ``tree`` with ``grads``: the params
    a step that applies exactly these gradients ends with."""
    params = lm.params_from_numpy(cfg, tree, device="cpu")
    oc = opt.for_model(cfg)
    state = opt.init(oc, params)
    opt.apply_updates(oc, params, lm.tree_unflatten(params, [
        torch.from_numpy(g) for g in grads]), state)
    return [p.detach().numpy() for p in lm.tree_leaves(params)]


def test_cmpi_train_step_matches_single_device_step(port_steps):
    """compression="none": every leaf's synced, dp-averaged gradient on 4
    ranks (the batch split over pod x data) within 1e-4 x that leaf's
    largest |g| of ``jax.value_and_grad`` over the whole batch; the
    params after the step are the optimizer's step with exactly those
    gradients, and within 1e-4 of the JAX package's single-device step
    (tests/test_distributed.py's bound, which the first AdamW step, of
    at most the warmup's learning rate, meets by itself); every rank
    holds the same gradients and params; the loss is the mean."""
    cfg, params, batch = _ref_setup()
    oc = ref_opt.for_model(cfg)

    def ref_loss(p):
        return ref_lm.loss_fn(p, cfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    (loss, _), g = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(
        params)
    want, _, _ = jax.jit(functools.partial(ref_opt.apply_updates, oc))(
        params, g, ref_opt.init(oc, params))
    assert [r["coords"] for r in port_steps] == [
        {"pod": p, "data": d} for p in range(2) for d in range(2)]
    assert [r["dp_index"] for r in port_steps] == [0, 1, 2, 3]
    assert len({r["none"]["digest"] for r in port_steps}) == 1
    got = port_steps[0]["none"]
    for a, b in zip(got["grads"], jax.tree.leaves(g)):
        b = np.asarray(b)
        assert float(np.abs(a - b).max()) <= 1e-4 * float(np.abs(b).max())
    tree = jax.tree.map(np.asarray, params)
    for a, b in zip(got["params"], _update_of(
            dataclasses.replace(port_config("smollm-135m").reduced(),
                                **STEP_CFG), tree, got["grads"])):
        np.testing.assert_array_equal(a, b)
    diff = max(float(np.abs(a - np.asarray(b)).max())
               for a, b in zip(got["params"], jax.tree.leaves(want)))
    assert diff < 1e-4
    np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)


def _psum_int8_prog(env):
    x = torch.tensor(POD_INPUTS[env.rank])
    return C.psum_int8(x, env.comm).numpy()


def test_psum_int8_scale_fault_pinned(mesh_ref):
    """Each pod quantizes with its own scale; the int32 sum is rescaled by
    the largest: pod 1's 0.01 becomes 127 quanta of pod 0's scale, and
    the sum of 1.0 and 0.01 comes out 2.0. Both packages give it
    (``ROADMAP.md`` Queue 3)."""
    got = port_core.run_threads(2, _psum_int8_prog, pool_bytes=POOL,
                                device="cpu")
    want = mesh_ref["psum_int8"]
    true_sum = np.sum(POD_INPUTS, axis=0)
    for rank_out, jax_out in zip(got, want):
        np.testing.assert_allclose(rank_out, jax_out, rtol=1e-6)
        np.testing.assert_allclose(rank_out, [2.0, 1.0, 0.50393701, 0.0],
                                   rtol=1e-6)
    assert abs(got[0][0] - true_sum[0]) > 0.9         # 2.0 against 1.01


def test_cmpi_train_step_int8_matches_jax_mesh_step(port_steps, mesh_ref):
    """compression="int8": every leaf's synced, dp-averaged gradient
    within one quantum of the JAX package's on its (2, 2, 2) mesh, whose
    devices lie in rank order (a quantum: the pods' largest int8 scale
    of the data block, over the dp size; a sync that left out a rank,
    the / dp or the block order would be off by many); the params after
    the step are the optimizer's step with exactly those gradients, and
    within 5e-3 of the JAX step's (tests/test_distributed.py's bound)."""
    np.testing.assert_array_equal(mesh_ref["mesh_devices"], np.arange(8))
    assert len({r["int8"]["digest"] for r in port_steps}) == 1
    got = port_steps[0]["int8"]
    for i, a in enumerate(got["grads"]):
        want, quantum = mesh_ref[f"int8_grad_{i}"], mesh_ref[
            f"int8_quantum_{i}"]
        err = np.abs(a - want).reshape(-1)
        err = np.concatenate([err, np.zeros(err.size % 2)]).reshape(2, -1)
        assert (err.max(axis=1) <= quantum).all(), (i, err.max(), quantum)
    cfg, params, _ = _ref_setup()
    tree = jax.tree.map(np.asarray, params)
    for a, b in zip(got["params"], _update_of(
            dataclasses.replace(port_config("smollm-135m").reduced(),
                                **STEP_CFG), tree, got["grads"])):
        np.testing.assert_array_equal(a, b)
    diff = max(float(np.abs(a - mesh_ref[f"int8_param_{i}"]).max())
               for i, a in enumerate(got["params"]))
    assert diff < 5e-3
    np.testing.assert_allclose(got["loss"], float(mesh_ref["int8_loss"]),
                               rtol=LOSS_RTOL)


def _sync_prog(env):
    dist = DistContext(env.comm, (2, 2), ("pod", "data"))
    g = torch.Generator().manual_seed(env.rank)
    grads = {"a": torch.randn(7, 5, generator=g),
             "b": (torch.randn(3, generator=g).bfloat16(),)}
    out = sync_grads(grads, dist.comms["data"], dist.comms["pod"])
    return out["a"].numpy(), out["b"][0].dtype, out["b"][0].numpy()


def test_sync_grads_sums_every_leaf_over_pod_and_data():
    """Every rank ends with the sum of the four ranks' leaves (odd sizes
    padded to the data size), in f32 whatever the leaf's type."""
    res = port_core.run_threads(4, _sync_prog, pool_bytes=POOL, device="cpu")
    want_a = want_b = 0
    for r in range(4):
        g = torch.Generator().manual_seed(r)
        want_a = want_a + torch.randn(7, 5, generator=g)
        want_b = want_b + torch.randn(3, generator=g).bfloat16().float()
    for a, dt, b in res:
        assert dt == torch.float32
        np.testing.assert_allclose(a, want_a.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(b, want_b.numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# vocab-parallel functions on data 2 x model 2
# ---------------------------------------------------------------------------

def _vp_prog(env, inp):
    cfg = dataclasses.replace(port_config("smollm-135m").reduced(), **VP)
    dist = DistContext(env.comm, (2, 2), ("data", "model"))
    rows = slice(dist.dp_index * VP_B // 2, (dist.dp_index + 1) * VP_B // 2)
    table = torch.from_numpy(inp["table"]).requires_grad_(True)
    x = torch.from_numpy(inp["x"][rows]).requires_grad_(True)
    toks = torch.from_numpy(inp["toks"][rows])
    emb = dist.vp_embed(table, toks, cfg)
    (emb * torch.from_numpy(inp["cot_e"][rows])).sum().backward()
    d_embed = table.grad.clone()
    table.grad = None
    ce = dist.vp_cross_entropy(table, x, toks, cfg)
    (ce * torch.from_numpy(inp["cot_ce"][rows])).sum().backward()
    tok = dist.vp_greedy_token(table.detach(), x.detach()[:, 0], cfg)
    return {"rows": rows, "model": dist.axis_index("model"),
            "embed": emb.detach().numpy(), "ce": ce.detach().numpy(),
            "token": tok.numpy(), "d_embed": d_embed.numpy(),
            "d_table": table.grad.numpy(), "dx": x.grad.numpy()}


def test_vocab_parallel_matches_jax(mesh_ref):
    """vp_embed, vp_cross_entropy and vp_greedy_token on data 2 x model 2
    against the JAX package's shard_maps on the same mesh: values within
    1e-5, 1e-4 and 0 mismatches (tests/test_distributed.py's bounds), and
    the gradients jax.grad gives through them (within 1e-5 relative and
    absolute: f32 sums over the vocab in other orders): each rank's table
    gradient lies in its own vocab slice and sums over the data ranks to
    the JAX one; each rank's dx (summed over model inside the backward)
    is JAX's for its rows."""
    inp = _vp_inputs()
    res = port_core.run_threads(4, functools.partial(_vp_prog, inp=inp),
                                pool_bytes=POOL, device="cpu")
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), **VP)
    shard = cfg.padded_vocab // 2
    d_embed = np.zeros_like(inp["table"])
    d_table = np.zeros_like(inp["table"])
    for r in res:
        rows = r["rows"]
        assert float(np.abs(r["embed"] - mesh_ref["vp_embed"][rows]).max()) \
            < 1e-5
        assert float(np.abs(r["ce"] - mesh_ref["vp_ce"][rows]).max()) < 1e-4
        assert int((r["token"] != mesh_ref["vp_token"][rows]).sum()) == 0
        np.testing.assert_allclose(r["dx"], mesh_ref["vp_ce_dx"][rows],
                                   rtol=1e-5, atol=1e-5)
        lo, hi = r["model"] * shard, (r["model"] + 1) * shard
        for got in (r["d_embed"], r["d_table"]):
            assert not got[:lo].any() and not got[hi:].any()
        d_embed += r["d_embed"]
        d_table += r["d_table"]
    np.testing.assert_allclose(d_embed, mesh_ref["vp_embed_dtable"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_table, mesh_ref["vp_ce_dtable"],
                               rtol=1e-5, atol=1e-5)


def _lm_vp_prog(env, tree):
    """loss_fn and decode_step of a vocab-parallel model with and without
    the dist, on the rank's rows."""
    cfg = dataclasses.replace(port_config("smollm-135m").reduced(), **VP,
                              decode_return="token")
    dist = DistContext(env.comm, (2, 2), ("data", "model"))
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 6),
                                         dtype=np.int64))
    batch = dist.shard_batch({"tokens": toks, "labels": toks.roll(-1, 1)})
    out = {}
    for name, d in (("vp", dist), ("dense", None)):
        params = lm.params_from_numpy(cfg, tree, device="cpu")
        for p in lm.tree_leaves(params):
            p.requires_grad_(True)
        total, _ = lm.loss_fn(params, cfg, batch, dist=d)
        total.backward()
        out[name] = {"loss": float(total.detach()),
                     "embed": params["embed"].grad.numpy(),
                     "grads": [p.grad.numpy() for p in lm.tree_leaves(
                         {k: v for k, v in params.items() if k != "embed"})]}
        with torch.no_grad():
            state = lm.decode_state_init(cfg, 2, 4, device="cpu")
            tok, _ = lm.decode_step(params, cfg, state,
                                    {"tokens": batch["tokens"][:, :1]},
                                    torch.zeros(2, dtype=torch.int32),
                                    dist=d)
        out[name]["token"] = tok.numpy()
    out["model"] = dist.axis_index("model")
    return out


def test_lm_hooks_take_the_vocab_parallel_path():
    """lm.loss_fn and decode_step under a vocab-parallel DistContext: the
    loss of the rank's rows and every gradient outside the embedding are
    the dense ones (the embedding's, summed over model, too); with
    decode_return="token" the step returns the dense logits' argmax."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), **VP)
    tree = jax.tree.map(np.asarray, ref_lm.init(cfg, jax.random.key(1)))
    res = port_core.run_threads(4, functools.partial(_lm_vp_prog,
                                                     tree=tree),
                                pool_bytes=POOL, device="cpu")
    for r in res:
        vp, dense = r["vp"], r["dense"]
        assert abs(vp["loss"] - dense["loss"]) < 1e-5
        assert vp["token"].dtype == np.int32
        np.testing.assert_array_equal(vp["token"], np.argmax(
            dense["token"], axis=-1))
        for a, b in zip(vp["grads"], dense["grads"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    # the embedding (the tied head too): each rank's vocab slice
    for data in (0, 1):
        pair = res[2 * data:2 * data + 2]
        np.testing.assert_allclose(sum(r["vp"]["embed"] for r in pair),
                                   pair[0]["dense"]["embed"], rtol=1e-4,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# shard_leaf against the JAX package's NamedSharding
# ---------------------------------------------------------------------------

def _leaf_prog(env, leaf, shape, axes):
    dist = DistContext(env.comm, shape, axes)
    return [dist.shard_leaf(torch.from_numpy(leaf), spec).numpy()
            for spec in SHARD_SPECS[len(shape)]]


@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))])
def test_shard_leaf_matches_named_sharding(shape, axes, mesh_ref):
    """Rank r's block of an (8, 16, 8) leaf under each spec of
    ``SHARD_SPECS`` (a split dim, a dim over two or three axes in the
    listed order, a replicated dim) is device r's addressable shard of
    ``jax.device_put(x, NamedSharding(make_test_mesh(...), spec))``,
    exactly."""
    leaf = _vp_inputs()["leaf"]
    res = port_core.run_threads(
        int(np.prod(shape)),
        functools.partial(_leaf_prog, leaf=leaf, shape=shape, axes=axes),
        pool_bytes=POOL, device="cpu")
    for rank, blocks in enumerate(res):
        for i, got in enumerate(blocks):
            np.testing.assert_array_equal(
                got, mesh_ref[f"leaf_{len(shape)}_{i}_{rank}"])


# ---------------------------------------------------------------------------
# moe_apply_ep on data 2 x model 2 against the JAX package's shard_map
# ---------------------------------------------------------------------------

def _ep_cfg(cf: float):
    cfg = dataclasses.replace(port_config("granite-moe-1b-a400m").reduced(),
                              compute_dtype="float32", moe_shard="ep_a2a")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _clobbered(cfg, x, router, dist) -> int:
    """How many kept (token, k) entries of this rank lose their slot to
    a later entry's sentinel: the queues replayed in numpy from the
    router's choices."""
    from repro_torch.models import blocks as B
    d = x.shape[-1]
    _, _, top_e, _, _ = B._route(x.reshape(1, -1, d), router, cfg)
    top_e = top_e.reshape(-1).numpy()
    E, T = cfg.moe.n_experts, top_e.size // cfg.moe.top_k
    e_loc = E // dist.model_size
    lo = dist.axis_index("model") * e_loc
    C = B.moe_capacity(cfg, T)
    count, owner, kept = np.zeros(E, int), {}, []
    for i, e in enumerate(top_e):
        pos, count[e] = count[e], count[e] + 1
        keep = pos < C and lo <= e < lo + e_loc
        slot = ((e - lo) * C + pos) if keep else C - 1
        owner[slot] = i
        if keep:
            kept.append((i, slot))
    return sum(owner[slot] != i for i, slot in kept)


def _ep_prog(env, inp):
    """moe_apply_ep on the rank's rows with whole expert leaves, and the
    gradients of sum(y * w) + 3 aux / dp (the JAX package's jax.grad
    takes the mean of the data shards' aux gradients); at 1.25 also with
    the rank's expert blocks alone (``shard_experts``' form)."""
    from repro_torch.distributed.sharding import P
    from repro_torch.models import blocks as B
    dist = DistContext(env.comm, (2, 2), ("data", "model"))
    rows = slice(dist.dp_index * EP_B // 2, (dist.dp_index + 1) * EP_B // 2)
    out = {"rows": rows, "model": dist.axis_index("model")}
    for cf in EP_CAPACITY:
        cfg = _ep_cfg(cf)
        for tag in ("prefill", "decode"):
            for form in ("whole", "block") if cf == 1.25 else ("whole",):
                p = {k: torch.from_numpy(inp["ep_" + k]) for k in EP_KEYS}
                if form == "block":
                    p = {k: v if k == "router" else dist.shard_leaf(
                        v, P("model")) for k, v in p.items()}
                p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
                x = torch.from_numpy(inp[f"ep_x_{tag}"][rows]).requires_grad_(
                    True)
                y, aux = B.moe_apply_ep(p, cfg, x, dist)
                w = torch.from_numpy(inp[f"ep_w_{tag}"][rows])
                ((y * w).sum() + 3 * aux / dist.dp_size).backward()
                out[(cf, tag, form)] = {
                    "y": y.detach().numpy(), "aux": float(aux.detach()),
                    "gx": x.grad.numpy(),
                    "g": {k: v.grad.numpy() for k, v in p.items()}}
            out[(cf, tag, "clobbered")] = _clobbered(
                cfg, torch.from_numpy(inp[f"ep_x_{tag}"][rows]),
                torch.from_numpy(inp["ep_router"]), dist)
    return out


@pytest.fixture(scope="module")
def port_ep():
    return port_core.run_threads(4, functools.partial(
        _ep_prog, inp=_vp_inputs()), pool_bytes=POOL, device="cpu")


def _within(got, want, tol=EP_TOL) -> None:
    want = np.asarray(want)
    assert float(np.abs(got - want).max()) <= tol * max(
        float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("tag", ["prefill", "decode"])
@pytest.mark.parametrize("cf", EP_CAPACITY)
def test_moe_apply_ep_matches_jax_shard_map(cf, tag, port_ep, mesh_ref):
    """moe_apply_ep on data 2 x model 2 against the JAX package's
    shard_map on make_test_mesh((2, 2)): each rank's y (its rows, both
    model ranks alike) and the gradients of sum(y * w) + 3 aux: x's (the
    rank's rows, summed over model inside), the router's (summed over
    the data ranks) and each expert leaf's (the rank's block, summed
    over all four), each within EP_TOL x its largest |value|. At the
    published capacity factor the slot clobber happens on every rank
    (prefill) and is reproduced; at 8.0 nothing drops."""
    key = f"ep_{cf}_{tag}"
    sums = {k: 0 for k in EP_KEYS}
    for r in port_ep:
        got = r[(cf, tag, "whole")]
        _within(got["y"], mesh_ref[key + "_y"][r["rows"]])
        _within(got["gx"], mesh_ref[key + "_gx"][r["rows"]])
        for k in EP_KEYS:
            if k != "router" or r["model"] == 0:
                sums[k] = sums[k] + got["g"][k]
    for k in EP_KEYS:
        _within(sums[k], mesh_ref[key + "_g_" + k])
    clobbered = [r[(cf, tag, "clobbered")] for r in port_ep]
    if cf == 8.0:
        assert clobbered == [0] * 4
    elif tag == "prefill":
        assert min(clobbered) > 0, clobbered


def test_moe_apply_ep_aux_is_data_shard_0s(port_ep, mesh_ref):
    """moe_apply_ep returns each rank's own rows' aux loss, alike over
    ``model``: on data shard 0's ranks it is the value the JAX package's
    moe_apply_ep returns on every shard (``out_specs=P()`` without a
    check), on data shard 1's another. Its gradient is the mean of the
    shards' (the test above), and make_train_step reports shard 0's aux
    as the JAX package's step does
    (``test_train_step_under_a_dist_matches_one_process``)."""
    for cf in EP_CAPACITY:
        want = float(mesh_ref[f"ep_{cf}_prefill_aux"])
        by_data = {}
        for r in port_ep:
            by_data.setdefault(r["rows"].start, set()).add(
                r[(cf, "prefill", "whole")]["aux"])
        assert all(len(v) == 1 for v in by_data.values())   # over model
        (aux0,), (aux1,) = by_data[0].copy(), by_data[EP_B // 2].copy()
        assert abs(aux0 - want) <= EP_TOL * want
        assert abs(aux1 - want) > 1e-3


def test_moe_apply_ep_takes_expert_blocks(port_ep):
    """Given the rank's expert blocks alone (E_loc, ...), moe_apply_ep
    computes the same y, aux and x and router gradients as from the whole
    leaves, and the blocks' gradients are the whole leaves' gradients in
    the rank's slice (zeros elsewhere)."""
    for r in port_ep:
        for tag in ("prefill", "decode"):
            whole, block = (r[(1.25, tag, f)] for f in ("whole", "block"))
            np.testing.assert_array_equal(block["y"], whole["y"])
            assert block["aux"] == whole["aux"]
            np.testing.assert_array_equal(block["gx"], whole["gx"])
            np.testing.assert_array_equal(block["g"]["router"],
                                          whole["g"]["router"])
            m = r["model"]
            for k in EP_KEYS[1:]:
                g = whole["g"][k]
                np.testing.assert_array_equal(block["g"][k],
                                              g[2 * m:2 * m + 2])
                assert not np.delete(g, [2 * m, 2 * m + 1], axis=0).any()


# ---------------------------------------------------------------------------
# the serve steps on data 2 x model 2 against the JAX package's mesh steps
# ---------------------------------------------------------------------------

def _serve_cfg():
    from repro_torch.configs import optimized
    return dataclasses.replace(optimized(
        port_config("granite-moe-1b-a400m").reduced()), **SERVE_CFG)


def _serve_prog(env, tree, toks):
    """make_serve_prefill, then SERVE_STEPS greedy make_serve_decode
    steps fed their own tokens, on the rank's rows, with the rank's
    expert blocks (``shard_experts``)."""
    from repro_torch.configs import InputShape
    from repro_torch.distributed.sharding import shard_experts, spec_leaves
    from repro_torch.train import steps as ST
    cfg = _serve_cfg()
    dist = DistContext(env.comm, (2, 2), ("data", "model"))
    params = shard_experts(lm.params_from_numpy(cfg, tree, device="cpu"),
                           cfg, dist)
    pre = ST.make_serve_prefill(cfg, InputShape("p", "prefill",
                                                *SERVE_PREFILL), dist)
    dec = ST.make_serve_decode(cfg, InputShape("d", "decode", *SERVE_DECODE),
                               dist)
    tr = ST.make_train_step(cfg, InputShape("t", "train", *SERVE_PREFILL),
                            dist)
    toks = torch.from_numpy(toks)
    out = {"rows": slice(dist.dp_index * 2, dist.dp_index * 2 + 2),
           "logits": pre.fn(params, {"tokens": toks}).numpy(), "tokens": [],
           "experts": tuple(params["blocks"][0]["ffn"]["w_gate"].shape),
           "specs": [[list(x) if isinstance(x, tuple) else x for x in s]
                     for ss in (pre, dec, tr) for s in spec_leaves(
                         (ss.in_shardings, ss.out_shardings))]}
    state = lm.decode_state_init(cfg, SERVE_DECODE[1] // 2, SERVE_DECODE[0],
                                 device="cpu")
    tok, pos = toks[:, :1], torch.zeros(SERVE_DECODE[1], dtype=torch.int32)
    for _ in range(SERVE_STEPS):
        local, state = dec.fn(params, state, {"tokens": tok}, pos)
        out["tokens"].append(local.numpy())
        # every rank feeds back the global batch's tokens
        tok = dist.comms["data"].allgather(local)[:, None]
        pos = pos + 1
    return out


def test_serve_steps_match_jax_mesh_steps(mesh_ref):
    """make_serve_prefill and make_serve_decode on data 2 x model 2
    (granite-moe reduced under optimized's serving flags: ep_a2a,
    greedy tokens from the split vocab, flashdecode, dus; f32) against
    the JAX package's steps jitted on make_test_mesh((2, 2)) from the
    same weights: each rank's prefill logits (its rows) within
    SERVE_TOL, its greedy tokens exactly, both model ranks of a row
    alike; each rank holds its block of the experts; the sharding trees
    of these steps and of make_train_step are the JAX package's, leaf
    for leaf."""
    import json
    cfg = dataclasses.replace(optimized(
        get_config("granite-moe-1b-a400m").reduced()), **SERVE_CFG)
    tree = jax.tree.map(np.asarray, ref_lm.init(cfg, jax.random.key(
        SERVE_SEED)))
    toks = _vp_inputs()["serve_toks"]
    res = port_core.run_threads(4, functools.partial(
        _serve_prog, tree=tree, toks=toks), pool_bytes=POOL, device="cpu")
    specs = json.loads(str(mesh_ref["serve_specs"]))
    for r in res:
        rows = r["rows"]
        assert float(np.abs(r["logits"] - mesh_ref["serve_logits"][
            rows]).max()) <= SERVE_TOL
        for i, got in enumerate(r["tokens"]):
            np.testing.assert_array_equal(got,
                                          mesh_ref[f"serve_token_{i}"][rows])
        assert r["experts"][1] == cfg.moe.n_experts // 2
        assert r["specs"] == specs
    for a, b in (res[0], res[1]), (res[2], res[3]):
        np.testing.assert_array_equal(a["logits"], b["logits"])


# ---------------------------------------------------------------------------
# make_train_step under a dist: data 2 x model 2, ep_a2a, vocab-parallel
# ---------------------------------------------------------------------------

# granite-moe reduced in f32, 4 sequences of 16 tokens, the experts
# split over model and the vocab too, at capacity factor 8 (no token
# drops, so the dense dispatch of one process, which groups by row, is
# the same function); every leaf's synced gradient within STEP_GRAD_TOL
# x its largest |g| of the JAX package's, and of one process's; the
# params after the step within STEP_UPDATE_TOL x the leaf's largest
# update of the JAX package's step (tests/test_torch_train.py's bound
# for a step's params)
STEP_GRAD_TOL = 1e-4
STEP_UPDATE_TOL = 1e-2
DIST_STEP_SHAPE = dataclasses.replace(SHAPES["train_4k"],
                                      seq_len=DIST_STEP[0],
                                      global_batch=DIST_STEP[1])


def _dist_step_cfg():
    return dataclasses.replace(_ep_cfg(8.0), vocab_parallel=True)


def _dist_step_prog(env, tree, batch):
    from repro_torch.train import steps as ST
    cfg = _dist_step_cfg()
    dist = DistContext(env.comm, (2, 2), ("data", "model"))
    params = lm.params_from_numpy(cfg, tree, device="cpu")
    step = ST.make_train_step(cfg, DIST_STEP_SHAPE, dist)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, metrics = step.grads(params, batch)
    state = opt.init(opt.for_model(cfg), params)
    _, _, m = step.fn(params, state, batch)
    return {"grads": [g.numpy() for g in lm.tree_leaves(grads)],
            "loss": float(metrics["loss"]), "aux": float(metrics["aux"]),
            "step_loss": float(m["loss"]),
            "params": [p.detach().numpy() for p in lm.tree_leaves(params)],
            "ga": step.grad_accum}


def test_train_step_under_a_dist_matches_one_process(mesh_ref):
    """make_train_step on data 2 x model 2 (each data rank its 2 rows,
    the experts and the vocab split over model) against the JAX
    package's make_train_step jitted on make_test_mesh((2, 2)) from the
    same weights and batch: after the sums over model and the mean over
    data, every rank's gradients are equal and each leaf is within
    STEP_GRAD_TOL x its largest |g| of jax.grad of the reference's loss
    under its own dist (the mean of the data shards' aux gradients), and
    of one process's step over the same 4 rows in 2 microbatches of the
    data ranks' rows; the params after the step are the optimizer's step
    with exactly those gradients, alike on every rank, and within
    STEP_UPDATE_TOL x each leaf's largest update of the reference's
    step. The reported loss and aux are the reference's step's (rtol
    LOSS_RTOL) on every rank: its aux is data shard 0's
    (``test_moe_apply_ep_aux_is_data_shard_0s``), so one process's,
    the mean of the two shards' aux, differs; the loss less its aux
    term is one process's."""
    from repro_torch.train import steps as ST
    cfg = _dist_step_cfg()
    jcfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                               compute_dtype="float32")
    tree = jax.tree.map(np.asarray, ref_lm.init(jcfg, jax.random.key(
        DIST_STEP_SEED)))
    batch = ref_D.SyntheticLM(ref_D.for_model(jcfg, DIST_STEP_SHAPE)).batch(0)
    res = port_core.run_threads(4, functools.partial(
        _dist_step_prog, tree=tree, batch=batch), pool_bytes=POOL,
        device="cpu")
    one = ST.make_train_step(cfg, DIST_STEP_SHAPE, None, grad_accum=2)
    want, wm = one.grads(lm.params_from_numpy(cfg, tree, device="cpu"),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    assert [r["ga"] for r in res] == [int(mesh_ref["dist_ga"])] * 4 == [1] * 4
    stepped = _update_of(cfg, tree, res[0]["grads"])
    p0 = jax.tree.leaves(tree)
    for r in res:
        for i, (a, b) in enumerate(zip(r["grads"], lm.tree_leaves(want))):
            _within(a, mesh_ref[f"dist_grad_{i}"], STEP_GRAD_TOL)
            _within(a, b.numpy(), STEP_GRAD_TOL)
        for i, (a, b) in enumerate(zip(r["params"], stepped)):
            np.testing.assert_array_equal(a, b)
            ref = mesh_ref[f"dist_param_{i}"]
            assert float(np.abs(a - ref).max()) <= STEP_UPDATE_TOL * float(
                np.abs(ref - p0[i]).max())
        assert r["step_loss"] == r["loss"]
        np.testing.assert_allclose(r["loss"], float(mesh_ref["dist_loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["aux"], float(mesh_ref["dist_aux"]),
                                   rtol=LOSS_RTOL)
        coef = lm.AUX_WEIGHT
        np.testing.assert_allclose(
            r["loss"] - coef * r["aux"],
            float(wm["loss"]) - coef * float(wm["aux"]), rtol=LOSS_RTOL)
    assert abs(float(wm["aux"]) - res[0]["aux"]) > 1e-3
