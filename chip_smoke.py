#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on error:

1. build   nvcc builds the kernel library from ``src/repro_torch/csrc``
           (one nvcc per source, all started together); prints each
           kernel's registers and spills (from ptxas), each flash
           kernel's threads, tiles and shared memory (the library's
           ``flash_attention_plan``, whose numbers the launch takes,
           held to ``ops.launch_plan``) and,
           where ``cuobjdump`` exists, the HGMMA (wgmma) instructions of
           every flash instance, bf16 and f32, failing if one has
           none; ``cellcopy``'s cluster size per shape and its
           shared memory (failing unless ``ops.smem_bytes`` states it);
           ``wkv6``'s CTAs and dynamic shared memory per instance, and
           the registers and spills of each ``wkv6_bwd`` kernel
           instance (local, carry, chunk, du) with its shared memory,
           cluster size, CTAs an SM (the runtime's occupancy) and warps
           a scheduler, and the workspace.
2. kernel  each kernel against its plain PyTorch version on the card:
           ``cellcopy`` bit-exact on the copied bytes and the per-cell
           sums (the cell shapes of ``tests/test_kernels.py``,
           ``copy_message`` at 8 MiB with 16 KiB and 64 KiB cells,
           byte-range copies at odd lengths, at the edges of a CTA's
           slice and of a cell, and offsets = 1, 3, 8 (mod 16) between
           device memory and the pinned, mapped pool, in 16 KiB and
           64 KiB cells, each launch as ``ops.launch_plan`` gives it; one
           corrupted cell that ``verify`` must catch); ``flash_attention``
           on the cases of ``tests/test_kernels.py``, at the model
           path's shapes and at both kernels' edges (D = 32, 64 and
           128, ragged S, S = 1, GQA groups 1 to 8, causal or not), f32
           within 1e-5 and bf16 within 3e-2 (absolute plus relative, as
           ``assert_allclose``), in both layouts, each launch and each
           CTA's (batch, head, query block, K/V tiles) as
           ``ops.launch_plan`` gives them, the errors printed per dtype;
           bf16 also within a relative L2 error of ``FLASH_L2`` (scaled
           to the output's own size, which at S = 4096 is about that
           3e-2); ``wkv6``
           likewise, within rel < 1e-4, at the edges of its 32-token
           chunks too, each launch as ``ops.launch_plan`` gives it;
           ``wkv6_bwd`` (``WKV6_BWD_CASES``: f32 and bf16, small shapes,
           chunk edges, S = 1, w near 1 and near 0, and rwkv6-3b's
           launch (1, 40, 4096, 64)) in both
           layouts against ``wkv6_bwd_ref``, and the ``WKV6`` Function's
           gradients in the model's layout against autograd through
           ``wkv6_ref``, each gradient within ``GRAD_TOL`` x its max |g|
           (1e-4 f32, 2e-2 bf16; the share used is printed), each
           launch as ``ops.bwd_launch_plan`` gives it.
3. main    ``run_processes(2, ..., pool_bytes=512 MiB, cell_size=16 KiB,
           device="cuda")``: CUDA tensors of 8 B to 8 MiB cross the pool
           on the eager, staged and posted paths in both directions and
           are checked byte for byte; copied bytes per 1 MiB message are
           held to ``artifacts/bench/budget_copies.json``; an 8 MiB
           float32 ``allreduce`` equals the sum computed on the card; a
           persistent ``allreduce_init`` hits a pre-posted entry on every
           rendezvous send; every rank launched the kernel.
3b. window ``run_processes(2, window_path, ...)``, same pool and cells:
           ``win_allocate`` of 8 MiB + 64 B a rank; at every size of
           ``SIZES`` an ``rput`` + ``flush`` of a seeded CUDA tensor into
           the peer, read there through ``local_view`` byte for byte, an
           ``rget`` back into a CUDA tensor byte for byte, the
           ``rma_put``/``rma_get`` deltas equal to the payload bytes
           exactly, and a ``put_notify`` -> ``wait_notify`` ping-pong; a
           1 MiB ``put_notify`` whose receiver copies 0 bytes; 8
           ``raccumulate``s of a 1 MiB float32 tensor from both ranks
           equal to the sum computed on the card; the window
           ``allgather`` and ``bcast`` of 1 MiB a rank; ``rput``/``rget``
           against a ``PoolBuffer`` attached to a ``win_create_dynamic``
           window; a ``lock_all``/``flush``/``unlock_all`` epoch; both
           ranks launched the kernel.
3c. serve  ``run_processes(4, serve_path, ...)``, same pool and cells: the
           serving tier at the JAX package's full cut
           (``benchmarks/serve_qps.py``): router + 3 workers, 2000
           sessions at 1500/s, ``verify_every=29``, 128 slots of 4096 B
           pages a worker, seed 0; every session done, no bad checksum or
           failed page verify, the raccumulated token total equal to the
           DONE frames', the copy accounting of
           ``serve_qps.check_copy_accounting`` exact, every worker
           launched the kernel.
4. model   one model at a time, freed before the next: llama3-8b,
           rwkv6-3b, granite-moe-1b-a400m (MoE, 32 experts top-8) and
           musicgen-large (frames frontend) at full width and depth;
           llama-3.2-vision-90b (cross-attention over 1024 context
           tokens) cut to one pattern group of 5 layers, and
           jamba-1.5-large-398b (Mamba + MoE top-2) cut to one pattern
           group of 8 layers and 4 experts with bf16 parameters (``CUTS``;
           each model's output lists its cuts as ``reduced``). Random
           weights from seed 0 (f32 unless cut), bf16 compute:
           ``serve_batch`` (batch 4, 128-token prompts, 32 new tokens;
           no kernel launch), ``lm.prefill`` on the same prompts and on
           one 4096-token prompt (musicgen on their embedding rows as
           frames, vision with a seeded context), each prefill launching
           ``flash_attention`` once per self-attention layer and
           ``wkv6`` once per rwkv6 layer; one decode step's wall and
           device time (``torch.profiler``); then, in f32 compute with
           TF32 off, prefill (timed, twice) and its last-position logits
           against the teacher-forced decode's (which runs no kernel)
           within 1e-3 * max|logit| (MoE at capacity factor 8, so that
           neither grouping drops a token; vision with each
           cross-attention layer's decode cache filled with the
           context's K and V); peak card memory under 80 GB.
5. train   training on the card (``TRAIN``, ``RESTART``): (a) dq, dk
           and dv of ``flash_attention`` (the autograd Function: kernel
           forward, torch-op backward) against autograd through
           ``attention_ref`` at smollm-135m's and granite-moe's heads
           and training batch, S = 128 and 4096, bf16 and f32, within
           ``GRAD_TOL`` x max|g|; (b) smollm-135m, and rwkv6-3b cut to 2
           layers, at full width in f32: ``loss_fn`` and every leaf's
           gradient on the card against the CPU route, every layer's
           wq, wk and wv (wr, wk, wv and u) gradient non-zero, one
           kernel launch of each kind per layer; (c) ``run_training``
           of smollm-135m (8 x 4096), granite-moe-1b-a400m (3 x 4096)
           and rwkv6-3b (1 x 4096, all 32 layers), 6 steps each: finite
           losses, step 0 near ln(vocab), one flash launch per
           self-attention layer and one ``wkv6`` forward and one
           ``wkv6_bwd`` per rwkv6 layer and step, peak under 80 GB,
           tokens/s, a step split
           into batch generation, forward + backward and optimizer
           (``launch/train.py``'s ``grad_step`` and ``update_step``), and
           the card's busy share from ``torch.profiler`` (device time
           over the same step's wall time, at most 1); (d) under
           ``torch.use_deterministic_algorithms(True)``, a run
           interrupted by ``FailureInjector`` and resumed from a
           ``CheckpointManager`` bitwise equal to an uninterrupted one
           (smollm-135m; granite-moe and rwkv6-3b cut to 2 layers), and
           the resumed
           params + AdamW state through ``ArenaCheckpoint`` into a
           mapped ``SharedMemoryPool`` and back, bitwise, one
           ``cellcopy`` launch a leaf each way.
6. cmpi    ``run_processes(4, cmpi_path, ...)``, same pool and cells:
           data-parallel training over the port's ``Comm`` (pod 2 x
           data 2, ``distributed.make_cmpi_train_step``), CUDA gradients
           crossing the pool through ``cellcopy``: (a) smollm-135m in f32
           at 2 x 256 a rank, ``compression="none"``: every rank's
           params after one step equal, and within 1e-4 of rank 0's
           single-card step over the whole batch; (b) ``"int8"``: rank
           0's synced gradients equal to the parent's emulation of the
           JAX package's ``psum_int8`` sync from every rank's local
           gradients, within one quantum, and the params' distance from
           (a) printed; (c) ``vp_embed``, ``vp_cross_entropy`` and
           ``vp_greedy_token`` on data 2 x model 2 against the dense
           computation (1e-5, 1e-4, 0 mismatches) and the cross-entropy's
           gradients (1e-5 relative); (d) smollm-135m in bf16 at 4096
           tokens, one sequence a rank, 3 timed steps: tokens/s, the
           split (batch generation, forward + backward, ``sync_grads``,
           optimizer), pool bytes a rank copies per part, launches per
           rank and step (``cellcopy`` > 0 on every rank), peak per
           process.
7. steps   the step functions of ``train/steps.py``: (a) on this card,
           ``make_train_step`` of smollm-135m at its published config:
           f32 at 4 x 256, ga 4 against ga 1 (loss rel 1e-5, each leaf's
           gradient within 1e-4 x max|g|, params within 1e-4); bf16 at
           8 x 4096 with ``pick_grad_accum``'s 4 microbatches (one
           flash launch a layer and microbatch, peak beside phase 5's at
           ga 1, tokens/s); one step of train_4k's 256 x 4096 (ga 128),
           peak under 80 GB; (b) ``run_processes(4, ep_path, ...)``, same
           pool and cells, data 2 x model 2: granite-moe-1b-a400m under
           ``configs.optimized`` (``moe_shard="ep_a2a"``, greedy tokens
           from the split vocab), each rank its block of the experts
           (``shard_experts``): f32 at capacity factor 8 against one
           process's dense dispatch on the rank's row (1e-3 x
           max|logit|), then ``make_serve_prefill`` of 2 x 4096 and 8
           ``make_serve_decode`` steps in bf16, the model ranks of a row
           bitwise alike, one flash launch a layer and a ``cellcopy`` or
           more a MoE layer and step on every rank; prefill s, decode
           tokens/s, pool bytes, peak; (c) ``make_train_step`` under the
           same mesh, granite-moe cut to 2 layers in f32: every synced
           leaf within 1e-4 x max|g| of one process's step, one flash
           launch a layer and a ``cellcopy`` or more on every rank. The
           counts go to 0 just before (b)'s timed prefill and (c)'s step
           and are read just after, each path on its own.
8. counts  the host tools against the card: (a) the dry run's roofline
           (``launch/dryrun.count_cell`` on the meta device) of three
           steps phases 4 and 7 (a) time: smollm-135m's
           ``make_train_step`` at 8 x 4096, ga 4; llama3-8b's prefill of
           1 x 4096 and its decode step at batch 4. Each ran once more,
           untimed, under ``analysis.hlo.count`` in its phase: FLOPs and
           bytes agree within rel 1e-6 of the meta count, the charged
           launches equal the launch counts; prints the three roofline
           terms (H100 constants), the measured step time and the
           measured share of the roofline. (b) ``perfmodel``'s
           ``protocol_time`` of each path's 1 MiB one-way counters on
           the paper's CXL box beside the card's time (printed in phase
           3; gates nothing). (c) phase 3's one-way run once more at
           1 MiB a path, 2 ranks under ``trace=True``: each rank's dump
           merged by ``python -m repro_torch.trace`` into a timeline with
           two process lanes with events on each, and its summary. (d)
           ``compile_schedule(verify=True)`` for every schedule phases 3
           and 6 compiled, and ``lint_protocol`` over
           ``repro_torch/core``: no finding.
9. examples every script of ``examples_torch/`` through its ``main`` on
           the card (``examples_phase``), at the JAX package's examples'
           defaults, but ``quickstart --steps 100`` (not 300) and
           ``serve_decode --ranks 3 --sessions 24`` beside the default
           ``serve_batch`` run (``EXAMPLES``): ``scaling_study`` (host
           only), ``comm_v2_tour`` and ``rma_tour`` (4 processes),
           ``cmpi_pingpong`` (2 processes, 8 B to 64 KiB, 100 iterations,
           and the TCP baseline on the same CUDA buffers), ``serve_decode``
           and ``quickstart``. Every rank of the ping-pong, the tours and
           the serving tier's workers launched ``cellcopy`` (its router
           none), quickstart ``flash_attention``; the examples' own checks
           hold (hierarchical == ring, persistent slots stable, 0 bytes
           copied by each notified-put consumer, the allgather exact, the
           restart resumed at the trained step), every ping-pong message
           byte-exact, ``flash_attention`` at quickstart's shape (heads
           of 8, padded to the D = 32 instance) within phase 2's
           tolerances of its plain version, the tour's ring allreduce copying
           ``tour_ring_bytes`` on the rendezvous paths over its ranks; one
           line of times an example.
10. report the ``kernels`` JSON line (times at the main paths' shapes,
           ``cellcopy``'s beside ``Tensor.copy_`` (one at the serving
           tier's 4096 B page), its launches per path, ``flash_attention``
           at every shape phases 4 and 5 launch it at, beside SDPA,
           with its launches per model and training run, ``wkv6``'s in
           cycles per token, ``wkv6_bwd``'s at rwkv6-3b's training launch
           beside its bound and the plain backward, with its workspace
           and each kernel's share (traced in phase 2), and the
           f32 flash kernel at the parity prefill's shapes and at the
           long prompt, beside its FMA and split-TF32 bounds),
           one-way latency and bandwidth per path and size, one-sided
           latency and bandwidth per size, the serving tier's QPS and
           latency, the serving numbers per model, the ``training``,
           ``cmpi_training`` and ``examples`` lines, and the card's name
           and power limit.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
BUDGET = ROOT / "artifacts" / "bench" / "budget_copies.json"

MiB = 1 << 20
CELL = 16384
POOL_BYTES = 512 * MiB
SIZES = (8, 512, 4096, 64 * 1024, MiB, 8 * MiB)
PATHS = ("eager", "staged", "posted")
HOST_SIZES = (8, 4096, 64 * 1024)
BUDGET_KEYS = {"eager": "pt2pt_eager@1MiB",
               "staged": "pt2pt_rndv_staged@1MiB",
               "posted": "pt2pt_rndv_posted@1MiB"}
ALLREDUCE_BYTES = 8 * MiB
PERSIST_BYTES, PERSIST_ROUNDS = MiB, 10
# the window phase: an 8 MiB segment (the largest size) and 64 B more
WIN_BYTES = 8 * MiB + 64
RACC_ROUNDS = 8
SOLO_ACC_ROUNDS = 2
# the serving tier at benchmarks/serve_qps.py's full cut (FULL, and the
# ServeConfig run_bench builds from it)
SERVE_RANKS = 4
SERVE_TIER = {"sessions": 2000, "rate": 1500.0, "verify_every": 29,
              "slots_per_worker": 128, "page_bytes": 4096,
              "deadline_s": 600.0, "seed": 0}

# the peak rates of one H100 SXM (HBM3, the PCIe 5.0 x16 host link, the
# per-dtype tensor-core and FMA peaks) are repro_torch.analysis.hlo's,
# and the kernels' work formulas their ops modules' (``work``)

# phase 8 (a): the steps whose dry-run counts meet the card's, and the
# largest relative difference allowed between the two counts
ROOFLINE = {"arch": "llama3-8b", "decode_batch": 4}
COUNT_RTOL = 1e-6
# phase 8 (b): the counters of a one-way run that protocol_time reads
PROTO_KEYS = ("written_bytes", "read_bytes", "flush_lines", "fences",
              "nt_ops", "uncached_ops")
TRACE_DIR = ROOT / "artifacts" / "trace_smoke"

# the model path: published configs, serve_batch's shape, one long prompt
MODELS = ("llama3-8b", "rwkv6-3b", "granite-moe-1b-a400m", "musicgen-large",
          "llama-3.2-vision-90b", "jamba-1.5-large-398b")
# phase 4's cuts of a published config, each listed in the model's
# output as ``reduced``: (overrides, why)
CUTS = {
    "llama-3.2-vision-90b": (
        {"n_layers": 5},
        "depth 100 -> one pattern group (5 layers: 4 self-attention + 1 "
        "cross-attention); the 88 B parameters do not fit one card"),
    "jamba-1.5-large-398b": (
        {"n_layers": 8, "n_experts": 4, "param_dtype": "bfloat16"},
        "depth 72 -> one pattern group (8 layers: 7 mamba + 1 attention); "
        "experts 16 -> 4 (top-2 kept, so tokens are still dropped); "
        "parameters in bf16; one layer's 16 experts alone are 9.7 B "
        "parameters"),
}
CTX_SEED = 7                     # the cross-attention context's seed
SERVE = {"batch": 4, "prompt_len": 128, "gen": 32}
LONG_PROMPT = 4096
# prefill (kernel) against teacher-forced decode (no kernel) in f32: the
# two sum in other orders through 32 layers of random weights
LOGIT_TOL = 1e-3

# phase 5, training: published configs at train_4k's seq_len 4096, the
# global batch (256) cut to what one H100 holds (granite-moe at 4 ran
# out of the 80 GB: 21 GB of f32 params, grads and AdamW state, ~14 GB
# of activations a sequence; rwkv6-3b's 3.07 B params take 49 GB of f32
# params, grads and AdamW state, and its depth stays whole: 13.8 GB at 2
# layers and 17.6 GB at 4 give ~72 GB at 32); STEPS steps each
TRAIN = {"smollm-135m": 8, "granite-moe-1b-a400m": 3, "rwkv6-3b": 1}
TRAIN_STEPS = 6
# (H, KV, D) of each trained model's self-attention layers
TRAIN_HEADS = {(9, 3, 64): "smollm-135m", (16, 8, 64): "granite-moe-1b-a400m"}
# (a) dq, dk, dv of the flash Function (kernel forward, torch-op
# backward) against autograd through attention_ref on the card: max
# |got - want| <= tol x max |want| of each gradient. bf16: both sides
# round q, k, v, o and the gradients to bf16 (8 bits), at other places
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (b) smollm-135m in f32 compute, card (kernel forward, torch-op
# backward) against the CPU (plain versions): loss relative, and each
# leaf's gradient within tol x that leaf's max |g|
MODEL_GRAD = {"batch": 2, "seq_len": 256, "loss_rtol": 1e-4,
              "grad_tol": 1e-3}
# the configs of (b) and their cuts: rwkv6-3b at full width, 2 layers
MODEL_GRAD_CUTS = {"smollm-135m": {}, "rwkv6-3b": {"n_layers": 2}}
# (d) restart: steps uninterrupted, then a failure at step FAIL_AT and a
# resume from the checkpoint written at CKPT_EVERY; smollm-135m and
# granite-moe cut to 2 layers (the MoE scatter), short sequences
RESTART = {"steps": 4, "fail_at": 3, "ckpt_every": 3, "seq_len": 256,
           "global_batch": 2}
# phase 6, cMPI data-parallel training: 4 ranks (pod 2 x data 2) on the
# one card, one process each, through the port's Comm over the mapped
# pool (POOL_BYTES: a blocking collective hands at most Comm.lease_cap,
# an eighth of a rank's share of the pool, 16 MiB, to one schedule, so
# that a rank leases ~60 MiB of the pool at most).
# (a)/(b) smollm-135m in f32 compute, 2 x 256 a rank, (a) holding every
# leaf's synced gradient to rank 0's single-card one within tol_grad x
# that leaf's largest |g|; (c) the
# vocab-parallel functions on data 2 x model 2 at tests/test_distributed
# .py's sizes; (d) smollm-135m in bf16 at 4096 tokens, one sequence a rank
CMPI = {"ranks": 4, "mesh": (2, 2), "axes": ("pod", "data"),
        "arch": "smollm-135m", "f32_seq": 256, "f32_rows": 2,
        "seq": LONG_PROMPT, "rows": 1, "steps": 3, "tol_none": 1e-4,
        "tol_grad": 1e-4,
        "vp": {"mesh": (2, 2), "axes": ("data", "model"), "batch": 4,
               "seq": 8, "vocab_size": 64, "vocab_pad_multiple": 4,
               "tol_embed": 1e-5, "tol_ce": 1e-4, "tol_grad": 1e-5}}
RESTART_CUTS = {"smollm-135m": {},
                "granite-moe-1b-a400m": {"n_layers": 2},
                "rwkv6-3b": {"n_layers": 2}}
# phase 7, the step functions of train/steps.py. (a) gradient
# accumulation, smollm-135m at its published config: f32 parity at
# 4 x 256 (ga 4 against ga 1; loss rel, each leaf's gradient within
# grad_tol x its max|g|, the params after the step within params_tol),
# bf16 at 8 x 4096 (ga = pick_grad_accum = 4; 1 warm + mem_steps timed
# steps) and one step of train_4k's whole 256 x 4096 (ga 128)
STEPS_GA = {"arch": "smollm-135m", "parity_rows": 4, "parity_seq": 256,
            "parity_ga": 4, "loss_rtol": 1e-5, "grad_tol": 1e-4,
            "params_tol": 1e-4, "mem_rows": 8, "mem_steps": 2}
# (b) expert-parallel serving of granite-moe-1b-a400m under the JAX
# package's serving flags (configs.optimized), 4 processes (data 2 x
# model 2) over the pool: prefill of `rows` x `prompt` global (one row a
# dp rank), then `decode` greedy steps; the ranks of a dp row bitwise
# alike; at capacity factor check_cf (a check-only cut: no token drops,
# so the dense dispatch groups alike) each rank's f32 last-position
# logits within logit_tol x max|logit| of one process's lm.prefill
# through the dense moe_apply on its row. (c) make_train_step under the
# same mesh: granite-moe cut to 2 layers, f32, 2 x 256 a dp rank, at
# check_cf; every synced leaf within grad_tol x max|g| of one process's
# step over the global batch in 2 microbatches (the dp ranks' rows: the
# mean of the shards' aux gradients)
EP = {"arch": "granite-moe-1b-a400m", "ranks": 4, "mesh": (2, 2),
      "axes": ("data", "model"), "rows": 2, "prompt": LONG_PROMPT,
      "decode": 8, "logit_tol": 1e-3, "check_cf": 8.0,
      "train_layers": 2, "train_rows": 2, "train_seq": 256,
      "grad_tol": 1e-4}
# phase 9, the examples (examples_torch/), each through its main on the
# card at the JAX package's examples' defaults, with two cuts: quickstart
# trains 100 steps (the default is 300), and serve_decode runs the
# distributed tier with 3 ranks and 24 sessions beside its serve_batch
# run. The full-width runs of the same entry points are phases 3c to 7.
EXAMPLES = {"quickstart": ["--steps", "100"],
            "serve_ranks": ["--ranks", "3", "--sessions", "24"]}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*a) -> None:
    print(*a, flush=True)


def iters_for(size: int) -> int:
    return 20 if size <= 64 * 1024 else 10 if size <= MiB else 3


def _payload(size: int, seed: int, device):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (size,), dtype=torch.uint8,
                         device=device, generator=g)


# ---------------------------------------------------------------------------
# phase 3: the rank program (module level: run_processes spawns)
# ---------------------------------------------------------------------------

def _one_way(env, path: str, size: int, sender: int, iters: int,
             seed: int, host: bool = False) -> dict:
    """``iters`` messages of ``size`` bytes from ``sender`` to its peer on
    ``path``, paced by a zero-byte credit from the receiver as
    ``benchmarks/fig5_8_osu.run_protocols`` paces them (the receive is
    posted before the credit, so the posted path always finds its
    entry). ``host``: the payload is host bytes, as a CPU caller's is.
    Returns this rank's counters and checks the bytes."""
    import torch

    from repro_torch.kernels.cellcopy import ops
    c, peer = env.comm, 1 - env.rank
    src = _payload(size, seed, c.device)
    if host:
        src = src.cpu().numpy().tobytes()
    pbuf = reg = None
    if env.rank != sender:
        if host:
            dst = bytearray(size)
        elif path == "posted":
            pbuf = c.alloc_buffer(size)
            dst = pbuf
        else:
            target = dst = torch.zeros(size, dtype=torch.uint8,
                                       device=c.device)
            if path == "registered":
                # posted into the registration's pool shadow, drained
                # into the CUDA tensor on completion
                reg = dst = c.register(target)
    st = env.arena.view.stats
    c.barrier()
    s0 = st.snapshot()
    k0 = (c.eager_sends, c.rndv_sends, c.posted_sends, ops.LAUNCHES)
    t0 = time.perf_counter()
    for _ in range(iters):
        if env.rank == sender:
            c.recv(peer, tag=2)                       # credit
            c.send(peer, src, tag=1)
        else:
            req = c.irecv_into(peer, dst, tag=1)
            c.send(peer, b"", tag=2)
            req.wait(timeout=120)
    dt = time.perf_counter() - t0
    delta = st.delta(s0)
    k1 = (c.eager_sends, c.rndv_sends, c.posted_sends, ops.LAUNCHES)
    out = {"s": dt / iters, "copied": delta["copied_bytes"],
           "path_bytes": delta["path_copied_bytes"],
           "proto": {k: delta[k] for k in PROTO_KEYS},
           "eager": k1[0] - k0[0], "rndv": k1[1] - k0[1],
           "posted": k1[2] - k0[2], "launches": k1[3] - k0[3]}
    if env.rank != sender:
        got = (pbuf.tensor() if pbuf is not None
               else dst if host else target)
        out["bytes_ok"] = (bytes(got) == src if host
                           else bool(torch.equal(got, src)))
    c.barrier()
    if pbuf is not None:
        pbuf.free()
    if reg is not None:
        reg.free()
    return out


def main_path(env) -> dict:
    import torch

    from repro_torch.kernels.cellcopy import ops
    ops.LAUNCHES = 0
    c, rank = env.comm, env.rank
    default_threshold = c.eager_threshold
    res: dict = {"rank": rank, "device": str(c.device), "p2p": {}}
    for path in PATHS:
        # force the path as fig5_8_osu.run_protocols does: every payload
        # eager, or every non-empty payload rendezvous; the receive kind
        # (CUDA tensor or pool-resident buffer) picks staged or posted
        c.eager_threshold = 1 << 40 if path == "eager" else 0
        for size in SIZES:
            fwd = _one_way(env, path, size, 0, iters_for(size), size)
            back = _one_way(env, path, size, 1, 1, size + 1)
            res["p2p"][f"{path}:{size}"] = {"fwd": fwd, "back": back}
    # the other CUDA payload sites: a posted receive into a registered
    # CUDA tensor, and a self-send (cloned on the card)
    c.eager_threshold = 0
    res["p2p"]["registered"] = {
        "fwd": _one_way(env, "registered", MiB, 0, 3, 7),
        "back": _one_way(env, "registered", MiB, 1, 1, 8)}
    mine = _payload(4096, 9 + rank, c.device)
    c.send(rank, mine, tag=5)
    echo, _ = c.recv(rank, tag=5)
    res["self_send_ok"] = bool(echo.device == mine.device
                               and torch.equal(echo, mine))
    # the same eager stream with host payloads: the protocol's own cost,
    # beside which the CUDA payloads above show what the device adds
    c.eager_threshold = 1 << 40
    for size in HOST_SIZES:
        fwd = _one_way(env, "eager", size, 0, iters_for(size), size, True)
        res["p2p"][f"eager-host:{size}"] = {"fwd": fwd}
    c.eager_threshold = default_threshold
    # allreduce of an 8 MiB float32 CUDA tensor against the sum on the card
    n = ALLREDUCE_BYTES // 4
    xs = [torch.randn(n, device=c.device, generator=torch.Generator(
        device=c.device).manual_seed(1000 + r)) for r in range(2)]
    want = xs[0] + xs[1]
    st = env.arena.view.stats
    s0 = st.snapshot()
    got = c.allreduce(xs[rank].clone())
    res["allreduce_ok"] = bool(got.device == want.device
                               and torch.equal(got, want))
    # a 2-rank sum above the eager threshold: the direct sum, whose read
    # of the peer's operand is counted on the ``coll_direct`` path
    res["allreduce_direct_bytes"] = st.delta(s0)["path_copied_bytes"].get(
        "coll_direct", 0)
    # persistent allreduce: every rendezvous send hits a pre-posted entry
    x = torch.zeros(PERSIST_BYTES // 8, dtype=torch.float64,
                    device=c.device)
    req = c.allreduce_init(x, algo="rd")
    h0, r0 = c.posted_sends, c.rndv_sends
    ok = True
    for i in range(PERSIST_ROUNDS):
        x.fill_(float(i + rank + 1))
        out = req.start().wait()
        ok = ok and bool(torch.all(out == 2 * i + 3))
    req.free()
    res["persistent"] = {"ok": ok, "hits": c.posted_sends - h0,
                         "rndv": c.rndv_sends - r0,
                         "misses": env.arena.view.stats.mb_capacity_misses}
    res["launches"] = ops.LAUNCHES
    res["schedules"] = compiled_schedules()
    return res


def compiled_schedules() -> list:
    """Every schedule this process's communicators compiled, as
    ``(size, kind, nbytes, itemsize, root, group, chunk_bytes)``: phase 8
    (d) verifies each."""
    import gc
    import warnings

    from repro_torch.core.pt2pt import Communicator
    with warnings.catch_warnings():     # isinstance on deprecated objects
        warnings.simplefilter("ignore")
        comms = [o for o in gc.get_objects() if isinstance(o, Communicator)]
    return sorted({(o.size, *k) for o in comms for k in o._sched_cache},
                  key=repr)


def trace_path(env) -> dict:
    """Phase 8 (c)'s rank program: phase 3's one-way run once more at
    1 MiB a path under ``trace=True``; each rank writes its
    flight-recorder dump."""
    c = env.comm
    ok = True
    for path in PATHS:
        c.eager_threshold = 1 << 40 if path == "eager" else 0
        out = _one_way(env, path, MiB, 0, 1, MiB + 2)
        ok = ok and out.get("bytes_ok", True)
    dump = c.trace_dump(TRACE_DIR / f"rank{env.rank}.json")
    return {"rank": env.rank, "dump": str(dump), "bytes_ok": ok}


# ---------------------------------------------------------------------------
# phases 3b and 3c: one-sided windows and the serving tier (module level:
# run_processes spawns)
# ---------------------------------------------------------------------------

def _notify_pingpong(win, rank: int, src, iters: int) -> float:
    """Seconds one way of a ``put_notify`` answered by ``wait_notify``:
    rank 0 notifies rank 1, which notifies back, ``iters`` times."""
    t0 = time.perf_counter()
    for _ in range(iters):
        if rank == 0:
            win.put_notify(1, 0, src)
            win.wait_notify(1, timeout=60.0)
        else:
            win.wait_notify(0, timeout=60.0)
            win.put_notify(0, 0, src)
    return (time.perf_counter() - t0) / iters / 2


def _rma_paths(delta: dict) -> dict:
    """The one-sided buckets of a stats delta (the first chunked
    transfer also agrees its chunk size across ranks over the wire)."""
    return {k: v for k, v in delta["path_copied_bytes"].items()
            if k.startswith("rma_")}


def window_path(env) -> dict:
    """The one-sided path with CUDA tensors: returns this rank's checks,
    times and kernel launches."""
    import numpy as np
    import torch

    from repro_torch.kernels.cellcopy import ops
    ops.LAUNCHES = 0
    c, rank, peer = env.comm, env.rank, 1 - env.rank
    st = env.arena.view.stats
    dev = c.device
    win = c.win_allocate("smoke:win", WIN_BYTES)
    res: dict = {"rank": rank, "sizes": {}}
    for size in SIZES:
        iters = iters_for(size)
        src = _payload(size, 7000 + 2 * size + rank, dev)
        want = _payload(size, 7000 + 2 * size + peer, dev)
        win.fence()
        s0 = st.snapshot()
        t0 = time.perf_counter()
        for _ in range(iters):
            win.rput(peer, 0, src)
            win.flush(peer)
        t_put = (time.perf_counter() - t0) / iters
        d_put = _rma_paths(st.delta(s0))
        win.fence()
        view_ok = bool(torch.equal(win.local_view(0, size), want))
        dst = torch.zeros(size, dtype=torch.uint8, device=dev)
        s0 = st.snapshot()
        t0 = time.perf_counter()
        for _ in range(iters):
            win.rget(peer, 0, dst).wait()
        t_get = (time.perf_counter() - t0) / iters
        d_get = _rma_paths(st.delta(s0))
        get_ok = bool(torch.equal(dst, src))
        win.fence()
        res["sizes"][size] = {
            "view_ok": view_ok, "get_ok": get_ok,
            "put_paths": d_put, "get_paths": d_get,
            "want_put": {"rma_put": iters * size},
            "want_get": {"rma_get": iters * size},
            "rput_flush_s": t_put, "rget_s": t_get,
            "notify_one_way_s": _notify_pingpong(win, rank, src, iters)}
        win.fence()
    # a 1 MiB notified put, consumed in place: the receiver copies nothing
    note = _payload(MiB, 8001, dev)
    win.fence()
    if rank == 0:
        win.put_notify(1, 64, note)
    else:
        c0 = st.copied_bytes
        win.wait_notify(0, timeout=60.0)
        res["notify"] = {
            "ok": bool(torch.equal(win.local_view(64, MiB), note)),
            "receiver_copied": st.copied_bytes - c0}
    win.fence()
    # raccumulate: 1 MiB of float32 from both ranks into rank 0, integer
    # valued so that any order of the adds gives the exact sum
    n = MiB // 4
    xs = [torch.randint(-1000, 1000, (n,), generator=torch.Generator(
        device=dev).manual_seed(9000 + r), device=dev).float()
        for r in range(2)]
    if rank == 0:
        win.put_array(0, 0, torch.zeros(n, device=dev))
    win.fence()
    for _ in range(RACC_ROUNDS):
        win.raccumulate(0, 0, xs[rank]).wait()
    win.fence()
    got = win.get_array(0, 0, (n,), torch.float32)
    want = RACC_ROUNDS * (xs[0] + xs[1])            # the sum on the card
    res["raccumulate_ok"] = bool(got.device == want.device
                                 and torch.equal(got, want))
    win.fence()
    # a window built without a communicator: its blocking accumulate of
    # a CUDA operand reads and writes the segment through cellcopy, one
    # launch each way, with no host copy in between
    from repro_torch.core import Window
    solo = Window(env.arena, f"smoke:solo{rank}", 1, 0, MiB, create=True)
    solo.put_from(0, 0, torch.zeros(n, device=dev))
    l0 = ops.LAUNCHES
    for _ in range(SOLO_ACC_ROUNDS):
        solo.accumulate(0, 0, xs[rank])
    launched = ops.LAUNCHES - l0
    got = torch.empty(n, device=dev)
    solo.get_into(0, 0, got)
    res["solo_accumulate"] = {
        "ok": bool(torch.equal(got, SOLO_ACC_ROUNDS * xs[rank])),
        "launches": launched, "want_launches": 2 * SOLO_ACC_ROUNDS}
    solo.free()
    # window collectives, 1 MiB a rank
    shards = [_payload(MiB, 9100 + r, dev) for r in range(2)]
    gathered = win.allgather(shards[rank])
    res["allgather_ok"] = bool(gathered.device == shards[0].device
                               and torch.equal(gathered, torch.cat(shards)))
    arr = shards[0].clone() if rank == 0 else torch.zeros(
        MiB, dtype=torch.uint8, device=dev)
    win.bcast(arr, root=0)
    res["bcast_ok"] = bool(torch.equal(arr, shards[0]))
    win.fence()
    # a passive-target epoch: lock_all, chunked rput, flush, unlock_all
    epoch = _payload(MiB, 9200 + rank, dev)
    win.lock_all()
    req = win.rput(peer, 0, epoch, chunk_bytes=64 * 1024)
    win.flush(peer)
    win.unlock_all()
    win.fence()
    res["lock_all_ok"] = bool(req.done and torch.equal(
        win.local_view(0, MiB), _payload(MiB, 9200 + peer, dev)))
    win.free()
    # a dynamic window: a PoolBuffer attached, rput and rget against it
    dyn = c.win_create_dynamic("smoke:dyn")
    buf = c.alloc_buffer(MiB)
    addr = dyn.attach(buf)
    addrs = c.allgather(np.asarray([addr], np.int64))
    page = _payload(MiB, 9300 + rank, dev)
    dyn.rput(peer, int(addrs[peer]), page).wait()
    c.barrier()
    back = torch.zeros(MiB, dtype=torch.uint8, device=dev)
    dyn.rget(peer, int(addrs[peer]), back).wait()
    res["dynamic_ok"] = bool(
        torch.equal(buf.tensor(), _payload(MiB, 9300 + peer, dev))
        and torch.equal(back, page))
    c.barrier()
    dyn.detach(addr)
    buf.free()
    dyn.free()
    res["launches"] = ops.LAUNCHES
    return res


def serve_path(env) -> dict:
    """One rank of the serving tier at the full cut: its report, its
    seconds and its kernel launches."""
    from repro_torch.kernels.cellcopy import ops
    from repro_torch.serve import ServeConfig, serve_rank
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    report = serve_rank(env, ServeConfig(**SERVE_TIER))
    report["seconds"] = time.perf_counter() - t0
    report["launches"] = ops.LAUNCHES
    return report


def check_window(ranks: list[dict], window_s: float) -> tuple:
    """Hold the window phase's reports to its limits; returns (launches
    per rank, one-sided latency table)."""
    launches = [r["launches"] for r in ranks]
    say(f"[window] 2 ranks: {window_s:.1f} s, cellcopy launches per rank "
        f"{launches}")
    if min(launches) <= 0:
        fail(f"a rank never launched the kernel in the window phase: "
             f"{launches}")
    lat: dict = {}
    for size in SIZES:
        for r in ranks:
            x = r["sizes"][size]
            if not (x["view_ok"] and x["get_ok"]):
                fail(f"window {size} B, rank {r['rank']}: bytes differ "
                     f"(local_view {x['view_ok']}, rget {x['get_ok']})")
            if x["put_paths"] != x["want_put"] \
                    or x["get_paths"] != x["want_get"]:
                fail(f"window {size} B, rank {r['rank']}: path bytes "
                     f"{x['put_paths']} / {x['get_paths']}, want "
                     f"{x['want_put']} / {x['want_get']}")
        x = ranks[0]["sizes"][size]
        lat[size] = {k[:-2] + "_us": x[k] * 1e6 for k in (
            "rput_flush_s", "rget_s", "notify_one_way_s")}
        lat[size]["rput_MBps"] = size / x["rput_flush_s"] / 1e6
        lat[size]["rget_MBps"] = size / x["rget_s"] / 1e6
    say(f"[window] all {len(SIZES)} sizes byte-exact through local_view "
        f"and rget; rma_put and rma_get deltas equal the payload bytes")
    note = ranks[1]["notify"]
    if not note["ok"] or note["receiver_copied"] != 0:
        fail(f"put_notify of 1 MiB: {note}")
    say("[window] put_notify 1 MiB consumed in place, receiver copied 0 B")
    for key, what in (("raccumulate_ok", f"{RACC_ROUNDS} raccumulates of "
                       f"1 MiB float32 from both ranks equal the sum on the "
                       f"card"),
                      ("allgather_ok", "window allgather of 1 MiB a rank"),
                      ("bcast_ok", "window bcast of 1 MiB"),
                      ("lock_all_ok", "lock_all / flush / unlock_all"),
                      ("dynamic_ok", "rput / rget on an attached "
                       "PoolBuffer")):
        if not all(r[key] for r in ranks):
            fail(f"window phase: {what}: failed")
        say(f"[window] {what}: ok")
    for r in ranks:
        acc = r["solo_accumulate"]
        if not acc["ok"] or acc["launches"] != acc["want_launches"]:
            fail(f"window phase, rank {r['rank']}: accumulate of a CUDA "
                 f"operand on a window without a communicator: {acc}")
    say(f"[window] {SOLO_ACC_ROUNDS} accumulates of a CUDA operand on a "
        f"window without a communicator: exact, "
        f"{ranks[0]['solo_accumulate']['launches']} cellcopy launches")
    return launches, lat


def check_copy_accounting(reports: list[dict]) -> list[str]:
    """The serving tier's zero-receiver-drain contract, exact to the byte
    (as ``benchmarks/serve_qps.check_copy_accounting`` states it): the
    router, a pure control rank, counts nothing under ``rma_put``,
    ``rma_get``, ``rndv_staged`` or ``rndv_posted``; every worker's
    ``rma_put`` is its page fills plus 8 B per ``raccumulate``, its
    ``rma_get`` its page drains plus 8 B per ``raccumulate``, and it
    stages nothing."""
    problems = []
    rd = reports[0]["stats_delta"]["path_copied_bytes"]
    for path in ("rma_put", "rma_get", "rndv_staged", "rndv_posted"):
        if rd.get(path, 0):
            problems.append(f"router counted {rd[path]} B under {path}")
    for w in reports[1:]:
        d = w["stats_delta"]["path_copied_bytes"]
        racc = 8 * w["racc_calls"]
        for path, want in (("rma_put", w["rput_bytes"] + racc),
                           ("rma_get", w["rget_bytes"] + racc)):
            if d.get(path, 0) != want:
                problems.append(f"worker {w['rank']}: {path} "
                                f"{d.get(path, 0)} B != {want} B")
        for path in ("rndv_staged", "rndv_posted"):
            if d.get(path, 0):
                problems.append(f"worker {w['rank']}: {d[path]} B under "
                                f"{path}")
    return problems


def check_serve(reports: list[dict], serve_s: float) -> tuple:
    """Hold the serving tier's reports to its limits; returns (launches
    per rank, the ``serve_tier`` figures)."""
    router, workers = reports[0], reports[1:]
    launches = [r["launches"] for r in reports]
    say(f"[serve] {SERVE_RANKS} ranks: {serve_s:.1f} s, cellcopy launches "
        f"per rank {launches}")
    if launches[0]:
        fail("the router (a control rank) launched the kernel")
    if min(launches[1:]) <= 0:
        fail(f"a worker never launched the kernel: {launches}")
    problems = check_copy_accounting(reports)
    if router["sessions"] != SERVE_TIER["sessions"]:
        problems.append(f"{router['sessions']} of {SERVE_TIER['sessions']}"
                        f" sessions done")
    if router["bad_checksums"]:
        problems.append(f"{router['bad_checksums']} bad checksums")
    bad = sum(w["verify_failures"] for w in workers)
    if bad:
        problems.append(f"{bad} page verify failures")
    if router["stats_tokens"] != router["tokens"]:
        problems.append(f"raccumulated tokens {router['stats_tokens']} != "
                        f"{router['tokens']}")
    if problems:
        fail("serving tier: " + "; ".join(problems))
    say(f"[serve] {router['sessions']} sessions done, 0 bad checksums, 0 "
        f"verify failures, stats_tokens == tokens == {router['tokens']}, "
        f"copy accounting exact on every worker")
    fig = {k: router[k] for k in ("sessions", "tokens", "qps", "p50_us",
                                  "p99_us", "mean_us")}
    fig.update({
        "rput_bytes": sum(w["rput_bytes"] for w in workers),
        "rget_bytes": sum(w["rget_bytes"] for w in workers),
        "local_fills": sum(w["local_fills"] for w in workers),
        "racc_calls": sum(w["racc_calls"] for w in workers),
        "seconds": max(r["seconds"] for r in reports),
        "phase_s": serve_s, "launches": launches})
    return launches, fig


# ---------------------------------------------------------------------------
# phase 2 and the timings: the kernel against its plain version
# ---------------------------------------------------------------------------

class Check:
    """Bit-exact comparisons of kernel and plain outputs."""

    def __init__(self):
        self.cases = 0
        self.mismatches = 0
        self.max_abs_err = 0

    def same(self, what: str, got, want) -> None:
        import torch
        self.cases += 1
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        err = int(diff.max()) if diff.numel() else 0
        self.max_abs_err = max(self.max_abs_err, err)
        if err or got.shape != want.shape:
            self.mismatches += 1
            fail(f"kernel and plain version differ: {what} "
                 f"(max abs err {err})")


def _u32(t):
    import torch
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _plan_check(n: int, cell: int) -> None:
    """The launch the library makes (``cellcopy_plan``) is the one
    ``ops.launch_plan`` gives, which the CPU tests hold to the bytes."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.cellcopy import ops
    out = (ctypes.c_longlong * 4)()
    rc = build.load().cellcopy_plan(n, cell, out)
    plan = ops.launch_plan(n, cell)
    want = [plan["grid"], plan["cluster"], plan["threads"],
            plan["smem_bytes"]]
    if rc or list(out) != want:
        fail(f"cellcopy launch of {n} B in {cell} B cells: library "
             f"{list(out)} (rc {rc}), launch_plan {want}")


def _byte_ranges(pool, check: Check, big, cell: int, lengths) -> None:
    """Copies of ``lengths`` bytes at source and destination offsets 0,
    1, 3 and 8 (mod 16): device to device, device to the mapped pool and
    back, bytes and per-cell sums bit-exact."""
    import torch

    from repro_torch.kernels.cellcopy import ops, ref
    dev = big.device
    for n in lengths:
        _plan_check(n, cell)
        n_cells = -(-n // cell)
        for so in (0, 1, 3, 8):
            src = big[so:so + n]
            want_sums = _u32(ref.cell_sums_ref(src, cell, n_cells))
            for do in (0, 1, 3, 8):
                what = f"{n}@{so}->{do}/{cell}"
                plain = torch.zeros(n + 32, dtype=torch.uint8, device=dev)
                ref.copy_bytes_ref(plain[do:do + n], src, cell)
                dst = torch.zeros(n + 32, dtype=torch.uint8, device=dev)
                s = ops.copy_into(dst[do:do + n], src, cell)
                check.same(f"d2d {what}", dst, plain)
                check.same(f"d2d sums {what}", _u32(s), want_sums)
                off = 4096 + do
                sums = torch.empty(n_cells, dtype=torch.uint32, device=dev)
                ops.copy_bytes(pool.device_ptr(off, n), src.data_ptr(), n,
                               cell, sums)
                torch.cuda.synchronize()
                check.same(f"d2pool {what}", pool.device_view(off, n), src)
                check.same(f"d2pool sums {what}", _u32(sums), want_sums)
                back = torch.zeros(n + 32, dtype=torch.uint8, device=dev)
                ops.copy_bytes(back.data_ptr() + so, pool.device_ptr(off, n),
                               n, cell, sums)
                torch.cuda.synchronize()
                check.same(f"pool2d {what}", back[so:so + n], src)
                check.same(f"pool2d sums {what}", _u32(sums), want_sums)


def kernel_phase(pool, check: Check) -> None:
    import torch

    from repro_torch.kernels.cellcopy import ops, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for cells, words, block in [(8, 128, 2), (16, 256, 4), (32, 512, 8),
                                (4, 1024, 4)]:
        src = torch.randint(-2**31, 2**31 - 1, (cells, words),
                            dtype=torch.int32, device=dev, generator=g)
        d, s = ops.cellcopy(src, block_cells=block)
        rd, rs = ref.cellcopy_ref(src)
        check.same(f"cellcopy {cells}x{words} dst", d, rd)
        check.same(f"cellcopy {cells}x{words} sums", _u32(s), _u32(rs))
        if not ops.verify(d, s):
            fail("verify rejected a clean copy")
    for n in (123_457, 8 * MiB):
        msg = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                            generator=g)
        for cb in (16384, 65536):
            o, s = ops.copy_message(msg, cell_bytes=cb, block_cells=2)
            rcb, rcells = ops._cell_layout(n, cb, 2)
            check.same(f"copy_message {n}/{cb} bytes", o, msg)
            check.same(f"copy_message {n}/{cb} sums", _u32(s),
                       _u32(ref.cell_sums_ref(msg, rcb, rcells)))
    # byte ranges, any alignment: device -> pool -> device; lengths at
    # the edges of a CTA's slice (4 KiB), of a cell, and one cell plus
    # one slice; then 64 KiB cells (8 CTAs of 8 KiB a cell)
    big = torch.randint(0, 256, (MiB + 64,), dtype=torch.uint8, device=dev,
                        generator=g)
    _byte_ranges(pool, check, big, CELL, (
        1, 3, 15, 16, 17, 255, 4095, 4096, 4097, 16368, 16383, 16384,
        16385, CELL + 4096, CELL + 4097, 100_003, MiB + 5))
    _byte_ranges(pool, check, big, 4 * CELL, (
        8191, 8193, 4 * CELL - 1, 4 * CELL + 1, 4 * CELL + 8192,
        3 * 4 * CELL + 5))
    src = torch.randint(0, 100, (8, 128), dtype=torch.int32, device=dev,
                        generator=g)
    d, s = ops.cellcopy(src, block_cells=2)
    d[3, 5] += 1
    if ops.verify(d, s):
        fail("verify missed a corrupted cell")
    torch.cuda.synchronize()


def _time_ms(fn, reps: int = 50, warm: int = 5,
             spin: bool = True) -> tuple[float, float]:
    """(device ms, issued ms) per call of ``fn``, from CUDA events.

    issued: calls issued back to back from Python, as the data plane
    issues them; a call shorter than its host-side launch path measures
    that path. device: the same calls queued behind a spin kernel long
    enough to hold all of them, so the card runs them back to back and
    the events see the card's time alone. ``spin=False`` for a call that
    issues more launches than the launch queue holds (a Python loop over
    tokens): the card cannot run ahead of its host there, and device ms
    is the issued ms."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    issued = e0.elapsed_time(e1) / reps
    if not spin:
        return issued, issued
    # calibrate the spin, then make it outlast three times the issue
    # time; a time counts only if the spin outlasted the enqueue, and a
    # host that stalls past it (a busy shared host) is given a spin
    # twice as long, up to 24 times the issue time
    e0.record()
    torch.cuda._sleep(1_000_000)
    e1.record()
    torch.cuda.synchronize()
    ms_per_mcycle = max(e0.elapsed_time(e1), 1e-3)
    for margin in (3, 6, 12, 24):
        cycles = int((margin * reps * issued / ms_per_mcycle + 1) * 1e6)
        torch.cuda._sleep(cycles)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        e1.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueue_ms <= cycles / 1e6 * ms_per_mcycle:
            return e0.elapsed_time(e1) / reps, issued
        say(f"[time] the spin ran out before the launches were queued "
            f"({enqueue_ms:.3f} ms): again with a spin of "
            f"{2 * margin} x the issue time")
    fail(f"timing: the spin ran out before the launches were queued "
         f"({enqueue_ms:.3f} ms, spin {24 * reps * issued:.3f} ms)")


def timings(pool) -> list[dict]:
    """Kernel, plain version and ``Tensor.copy_`` at the main path's
    shapes: a 1 MiB rendezvous payload into the pool (staged and posted
    sends) and out of it (staged drain), one eager cell payload
    (16368 B at cell offset + 8, the first chunk after the 16 B message
    header) and 1 MiB device to device."""
    import torch
    dev = torch.device("cuda")
    src = torch.randint(0, 256, (MiB,), dtype=torch.uint8, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    d2d = torch.empty(MiB, dtype=torch.uint8, device=dev)
    shapes = [
        ("device->pool", MiB, pool.device_view(0, MiB), src, MiB, MiB),
        ("pool->device", MiB, d2d, pool.device_view(0, MiB), MiB, MiB),
        ("device->pool eager cell", CELL - 16,
         pool.device_view(2 * MiB + 24, CELL - 16), src[:CELL - 16],
         CELL - 16, CELL - 16),
        ("device->device", MiB, d2d, src, 0, 2 * MiB),
    ]
    return [_copy_row(*shape) for shape in shapes]


def page_timing(pool) -> dict:
    """Kernel, plain version and ``Tensor.copy_`` at the serving tier's
    page: 4096 B from device memory into the pool (a local page fill or
    one ``rput`` of a page)."""
    import torch
    dev = torch.device("cuda")
    page = torch.randint(0, 256, (4096,), dtype=torch.uint8, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    return _copy_row("device->pool serve page", 4096,
                     pool.device_view(4 * MiB, 4096), page, 4096, 4096)


def _copy_row(name, n, dst, s, pcie_bytes, hbm_bytes) -> dict:
    import torch

    from repro_torch.analysis.hlo import HBM_BW, LINK_BW
    from repro_torch.kernels.cellcopy import ops, ref
    n_cells = -(-n // CELL)
    sums = torch.empty(n_cells, dtype=torch.uint32, device=dst.device)
    kern, kern_issued = _time_ms(lambda: ops.copy_bytes(
        dst.data_ptr(), s.data_ptr(), n, CELL, sums))
    plain, plain_issued = _time_ms(
        lambda: ref.copy_bytes_ref(dst, s, CELL))
    lib, lib_issued = _time_ms(lambda: dst.copy_(s))
    # each input read once, each output written once: the payload,
    # plus 4 B of sum per cell into device memory
    hbm = hbm_bytes + 4 * n_cells
    bound = max(pcie_bytes / LINK_BW, hbm / HBM_BW) * 1e3
    plan = ops.launch_plan(n, CELL, dst.data_ptr() % 16,
                           s.data_ptr() % 16)
    return {"shape": name, "bytes": n, "ms": kern,
            "plain_ms": plain, "library_ms": lib,
            "vs_copy_": kern / lib, "bound_ms": bound,
            "bound_link": "pcie" if pcie_bytes else "hbm",
            "GBps": n / kern / 1e6, "CTAs": plan["grid"],
            "cluster": plan["cluster"], "issued_ms": kern_issued,
            "plain_issued_ms": plain_issued,
            "library_issued_ms": lib_issued}


# ---------------------------------------------------------------------------
# phase 2, model kernels: flash_attention and wkv6 against their plain
# versions; and their timings at the model path's shapes
# ---------------------------------------------------------------------------

class FloatCheck:
    """Comparisons of kernel and plain outputs within a tolerance."""

    def __init__(self, name: str):
        self.name = name
        self.cases = 0
        self.mismatches = 0
        self.max_abs_err = 0.0
        self.max_rel_err = 0.0
        self.max_l2_err = 0.0
        self.max_l2_case = ""
        # per kind of case (the flash dtypes): cases, max abs err, max
        # rel err (max|got - want| / max|want|) and the largest share of
        # the allclose bound an element used (|got - want| / (tol + tol
        # |want|), at most 1 on a pass)
        self.by_kind: dict = {}

    def close(self, what: str, got, want, tol: float,
              l2: float | None = None, kind: str | None = None) -> None:
        """|got - want| <= tol + tol * |want| everywhere (assert_allclose)
        and, with ``l2``, ||got - want||_2 / ||want||_2 <= l2."""
        self.cases += 1
        if got.shape != want.shape:
            self.mismatches += 1
            fail(f"{self.name}: {what}: shape {tuple(got.shape)}, "
                 f"plain version {tuple(want.shape)}")
        g, w = got.float(), want.float()
        err = float((g - w).abs().max())
        allclose = bool(((g - w).abs() <= tol + tol * w.abs()).all())
        rel2 = float((g - w).norm() / w.norm().clamp_min(1e-30))
        self.max_abs_err = max(self.max_abs_err, err)
        if kind is not None:
            k = self.by_kind.setdefault(kind, {
                "cases": 0, "max_abs_err": 0.0, "max_rel_err": 0.0,
                "bound_use": 0.0, "worst_case": ""})
            k["cases"] += 1
            k["max_abs_err"] = max(k["max_abs_err"], err)
            k["max_rel_err"] = max(k["max_rel_err"], err / max(
                float(w.abs().max()), 1e-30))
            use = float(((g - w).abs() / (tol + tol * w.abs())).max())
            if use >= k["bound_use"]:
                k["bound_use"], k["worst_case"] = use, what
        if l2 is not None and rel2 >= self.max_l2_err:
            self.max_l2_err, self.max_l2_case = rel2, what
        if not allclose or (l2 is not None and rel2 > l2):
            self.mismatches += 1
            fail(f"{self.name} and its plain version differ: {what} "
                 f"(max abs err {err:.3g}, tol {tol}: "
                 f"{'within' if allclose else 'over'}; relative L2 err "
                 f"{rel2:.3g}, bound {l2})")

    def rel(self, what: str, got, want, bound: float) -> None:
        """max|got - want| / max|want| < bound (tests/test_kernels.py)."""
        self.cases += 1
        err = float((got.float() - want.float()).abs().max())
        rel = err / (float(want.float().abs().max()) + 1e-9)
        self.max_abs_err = max(self.max_abs_err, err)
        self.max_rel_err = max(self.max_rel_err, rel)
        if got.shape != want.shape or not rel < bound:
            self.mismatches += 1
            fail(f"{self.name} and its plain version differ: {what} "
                 f"(rel err {rel:.3g}, bound {bound})")


# (b, h, kv, s, d, causal, dtype): tests/test_kernels.py's sweep, ragged
# lengths, the model path's shapes (serve prompts; one long prompt), and
# the kernels' edges: D = 32 and 64, S not a multiple of the bf16
# kernel's 128-row tiles nor of the f32 kernel's 64-row blocks and
# 32-key stages, S = 1, GQA groups 1 to 8, causal and not
FLASH_CASES = [
    (2, 4, 4, 256, 64, True, "float32"),
    (1, 8, 2, 256, 128, True, "bfloat16"),
    (2, 4, 1, 128, 64, False, "float32"),
    (1, 2, 2, 512, 32, True, "float32"),
    (1, 4, 2, 100, 64, True, "float32"),
    (2, 2, 1, 77, 32, False, "bfloat16"),
    (4, 32, 8, 128, 128, True, "bfloat16"),
    (4, 32, 8, 128, 128, True, "float32"),
    (1, 32, 8, 4096, 128, True, "bfloat16"),
    (1, 32, 8, 4096, 128, True, "float32"),
    (2, 8, 8, 384, 64, True, "bfloat16"),
    (1, 16, 2, 200, 128, True, "bfloat16"),
    (2, 8, 1, 256, 128, False, "bfloat16"),
    (1, 4, 4, 200, 32, True, "bfloat16"),
    (1, 4, 1, 333, 64, False, "bfloat16"),
    (1, 16, 2, 200, 128, True, "float32"),
    (2, 8, 2, 1, 128, True, "float32"),
    (2, 8, 1, 256, 128, False, "float32"),
    (1, 4, 4, 77, 32, False, "float32"),
    (1, 4, 1, 333, 64, True, "float32")]
# (H, KV, D) of the self-attention layers phase 4 prefills, and its models
FLASH_HEADS = {(32, 8, 128): ["llama3-8b"],
               (16, 8, 64): ["granite-moe-1b-a400m"],
               (32, 32, 64): ["musicgen-large"],
               (64, 8, 128): ["llama-3.2-vision-90b", "jamba-1.5-large-398b"]}
# ((H, KV, D), B, S, dtype) timed in the report: every launch shape of
# phase 4 (4x128 and 1x4096 in bf16, the f32 parity prefill at 4x128),
# and llama3-8b's f32 at the long prompt beside its bounds
FLASH_TIMED = [(hd, b, s, dt) for hd in FLASH_HEADS
               for b, s, dt in ((4, SERVE["prompt_len"], "bfloat16"),
                                (1, LONG_PROMPT, "bfloat16"),
                                (4, SERVE["prompt_len"], "float32"))]
FLASH_TIMED.insert(3, ((32, 8, 128), 1, LONG_PROMPT, "float32"))
# phase 5's launch shapes: each trained model's batch at S = 4096, bf16
TRAIN_TIMED = [(hd, TRAIN[arch], LONG_PROMPT, "bfloat16")
               for hd, arch in TRAIN_HEADS.items()]
FLASH_TIMED += TRAIN_TIMED
# every launch shape of phase 4 with its plain version, on top of the
# edges above
FLASH_CASES += [case for case in ((b, hd[0], hd[1], s, hd[2], True, dt)
                                  for hd, b, s, dt in FLASH_TIMED)
                if case not in FLASH_CASES]
# bf16 outputs: bound on ||got - want||_2 / ||want||_2, scaled to the
# output where 3e-2 is not: at S = 4096 an output is ~0.02, and a 2 %
# error in every row (a softmax scale off by 2 %) stays inside 3e-2.
# Both versions round p to bf16 (8 significant bits), but at different
# points: the kernel each tile's exp against its running max, the plain
# version the normalised softmax. That alone parts them by ~3e-3 of the
# output's norm; the bound is 2^-7, one bf16 ulp at the bottom of a
# binade.
FLASH_L2 = 2.0 ** -7
# (b, h, s, n, dtype of r, k, v): the sweep and the path's shapes, and
# the kernel's chunk edges (32 tokens): S = 1, one chunk plus one token,
# a ragged last chunk at the long prompt and at B = 4; each case runs in
# both layouts (BHSN and BSHN)
WKV6_CASES = [
    (2, 2, 64, 16, "float32"), (1, 4, 128, 32, "float32"),
    (2, 1, 96, 64, "float32"), (1, 1, 32, 8, "float32"),
    (4, 40, 128, 64, "bfloat16"), (4, 40, 128, 64, "float32"),
    (1, 40, 4096, 64, "bfloat16"), (2, 4, 1, 64, "bfloat16"),
    (1, 40, 33, 64, "float32"), (1, 40, 4095, 64, "bfloat16"),
    (4, 8, 77, 64, "bfloat16")]
# the wkv6 backward (``wkv6_bwd``, the WKV6 Function's): (b, h, s, n,
# dtype of r, k, v[, decay]): small shapes, the chunk edges (S = 33, 40,
# 77, 100), S = 1, w = 1 - 1e-3 over 32 chunks (long memory: the carry
# over chunks dominates) and w ~ 0.01 (a chunk's decay product underflows
# to 0), and rwkv6-3b's launch shape at train_4k's seq_len; each case in
# both layouts against ``wkv6_bwd_ref``, and the Function's gradients in
# the model's layout against autograd through ``wkv6_ref``, each
# gradient within GRAD_TOL x its max |g|
WKV6_LAUNCH = (1, 40, LONG_PROMPT, 64)
WKV6_BWD_CASES = [
    (2, 2, 64, 16, "float32"), (1, 4, 100, 32, "float32"),
    (2, 3, 40, 16, "bfloat16"), (1, 1, 33, 8, "float32"),
    (2, 4, 77, 64, "bfloat16"), (2, 4, 1, 64, "bfloat16"),
    (1, 40, 33, 64, "float32"), (1, 8, 1024, 64, "float32", "near_one"),
    (1, 8, 1024, 64, "bfloat16", "near_one"),
    (2, 4, 77, 64, "bfloat16", "near_zero"),
    (1, 2, 33, 32, "float32", "near_zero"), (*WKV6_LAUNCH, "float32"),
    (*WKV6_LAUNCH, "bfloat16")]


def _randn(shape, g, dtype="float32"):
    import torch
    return torch.randn(shape, device="cuda", generator=g).to(
        getattr(torch, dtype))


def _flash_inputs(b, h, kv, s, d, dtype, g):
    return (_randn((b, h, s, d), g, dtype), _randn((b, kv, s, d), g, dtype),
            _randn((b, kv, s, d), g, dtype))


def _wkv6_inputs(b, h, s, n, dtype, g, decay=None):
    """r, k, v, w, u of a case; w = exp(-exp(x)) (the model's spread),
    or with ``decay`` "near_one" 1 - 1e-3, "near_zero" in [0.005, 0.02)."""
    import torch
    r, k, v = (_randn((b, h, s, n), g, dtype) for _ in range(3))
    w = torch.exp(-torch.exp(_randn((b, h, s, n), g) * 0.5 - 2.0))
    if decay == "near_one":
        w = torch.full_like(w, 1 - 1e-3)
    elif decay == "near_zero":
        w = 0.005 + 0.015 * torch.rand(w.shape, device="cuda", generator=g)
    return r, k, v, w, _randn((h, n), g) * 0.5


def _wkv6_plan(b, h, s, n, dtype) -> dict:
    """The launch the library makes for the case, checked against
    ``ops.launch_plan`` (whose schedule the CPU tests emulate)."""
    import ctypes

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6 import ops
    out = (ctypes.c_int * 8)()
    dt = getattr(torch, dtype)
    rc = build.load().wkv6_plan(ops.DTYPES[dt], b, h, n, out)
    plan = ops.launch_plan(b, h, s, n, dt)
    want = [*plan["grid"], plan["threads"], plan["smem_bytes"],
            plan["chunk"], plan["cols"], plan["row_groups"]]
    if rc or list(out) != want:
        fail(f"wkv6 launch of {(b, h, s, n, dtype)}: library {list(out)} "
             f"(rc {rc}), launch_plan {want}")
    return plan


def _wkv6_bwd_plan(b, h, s, n, dtype) -> dict:
    """The launches the library's ``wkv6_bwd`` makes for the case
    (``wkv6_bwd_plan``), checked against ``ops.bwd_launch_plan``, whose
    workspace the wrapper allocates."""
    import ctypes

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6 import ops
    out = (ctypes.c_int * 12)()
    dt = getattr(torch, dtype)
    rc = build.load().wkv6_bwd_plan(ops.DTYPES[dt], b, h, s, n, out)
    plan = ops.bwd_launch_plan(b, h, s, n, dt)
    ws = plan["workspace_bytes"]
    want = [*plan["grid"], plan["cluster"], plan["threads"],
            plan["smem_bytes"], plan["local_smem_bytes"],
            plan["carry_grid"][0], plan["carry_threads"],
            plan["du_grid"][0], ws & 0x7FFFFFFF, ws >> 31]
    if rc or list(out) != want:
        fail(f"wkv6_bwd launch of {(b, h, s, n, dtype)}: library "
             f"{list(out)} (rc {rc}), bwd_launch_plan {want}")
    return plan


def _flash_plan(b, h, kv, s, d, causal, dtype) -> dict:
    """The launch the library makes for the case (``flash_attention_plan``,
    whose numbers the launch itself takes) and each CTA's work as the
    kernels compute it (``flash_attention_order``), checked against
    ``ops.launch_plan`` (whose tiles and order the CPU tests use)."""
    import ctypes

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    lib = build.load()
    out = (ctypes.c_int * 8)()
    dt = getattr(torch, dtype)
    rc = lib.flash_attention_plan(ops.DTYPES[dt], b, h, s, d, out)
    plan = ops.launch_plan(b, h, kv, s, d, dt, causal)
    want = [plan["grid"], plan["threads"], plan["smem_bytes"],
            plan["block_q"], plan["block_k"], plan["stages"],
            plan["warpgroups"]["load"], plan["warpgroups"]["math"]]
    what = f"flash_attention launch of {(b, h, kv, s, d, causal, dtype)}"
    if rc or list(out) != want:
        fail(f"{what}: library {list(out)} (rc {rc}), launch_plan {want}")
    work = (ctypes.c_int * (4 * plan["grid"]))()
    rc = lib.flash_attention_order(ops.DTYPES[dt], b, h, s, d, int(causal),
                                   work)
    got = [tuple(work[4 * i:4 * i + 4]) for i in range(plan["grid"])]
    want = [(bi, hi, qi, plan["kv_tiles"][qi])
            for bi, hi, qi in plan["order"]]
    if rc or got != want:
        first = [(i, x, y) for i, (x, y) in enumerate(zip(got, want))
                 if x != y][:1]
        fail(f"{what}: (CTA, library's work, launch_plan's) {first} "
             f"(rc {rc})")
    return plan


def model_kernel_phase(fcheck: FloatCheck, wcheck: FloatCheck) -> None:
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rwkv6 import ops as wk
    from repro_torch.kernels.rwkv6 import ref as wk_ref
    g = torch.Generator(device="cuda").manual_seed(11)
    for b, h, kv, s, d, causal, dt in FLASH_CASES:
        _flash_plan(b, h, kv, s, d, causal, dt)
        q, k, v = _flash_inputs(b, h, kv, s, d, dt, g)
        tol, l2 = (3e-2, FLASH_L2) if dt == "bfloat16" else (1e-5, None)
        want = fa_ref.attention_ref(q, k, v, causal=causal)
        what = f"({b},{h},{kv},{s},{d}) causal={causal} {dt}"
        fcheck.close(what, fa.flash_attention(q, k, v, causal=causal),
                     want, tol, l2, kind=dt)
        got = fa.flash_attention_bshd(
            *(t.transpose(1, 2).contiguous() for t in (q, k, v)),
            causal=causal)
        fcheck.close(what + " bshd", got.transpose(1, 2), want, tol, l2,
                     kind=dt)
        del q, k, v, want, got
    for b, h, s, n, dt in WKV6_CASES:
        _wkv6_plan(b, h, s, n, dt)
        args = _wkv6_inputs(b, h, s, n, dt, g)
        want = wk_ref.wkv6_ref(*args)
        what = f"({b},{h},{s},{n}) {dt}"
        wcheck.rel(what, wk.wkv6(*args), want, 1e-4)
        got = wk.wkv6_bshn(*(t.transpose(1, 2).contiguous()
                             for t in args[:4]), args[4])
        wcheck.rel(what + " bshn", got.transpose(1, 2), want, 1e-4)
    torch.cuda.synchronize()


def wkv6_bwd_phase() -> dict:
    """Phase 2, the wkv6 backward: for each of ``WKV6_BWD_CASES`` the
    library's launch (``wkv6_bwd_plan``) held to ``ops.bwd_launch_plan``;
    ``wkv6_bwd`` in both layouts against ``wkv6_bwd_ref`` on the same
    inputs, each gradient in its input's dtype; the ``WKV6`` Function in
    the model's BSHN layout (kernel forward, ``wkv6_bwd`` backward)
    against autograd through ``wkv6_ref``. Every gradient within
    ``GRAD_TOL`` x its max |g|; returns the share of that bound each
    comparison used."""
    import torch

    from repro_torch.kernels.rwkv6 import ops as wk
    from repro_torch.kernels.rwkv6 import ref as wk_ref
    g = torch.Generator(device="cuda").manual_seed(14)
    names = ("dr", "dk", "dv", "dw", "du")
    cases = []
    for b, h, s, n, dt, *decay in WKV6_BWD_CASES:
        _wkv6_bwd_plan(b, h, s, n, dt)
        args = _wkv6_inputs(b, h, s, n, dt, g, *decay)
        do = _randn((b, h, s, n), g)
        want = wk_ref.wkv6_bwd_ref(*args, do)
        before = wk.BWD_LAUNCHES
        got = {"bhsn": wk._launch_bwd(*args, do, heads=1)}
        t = wk._launch_bwd(*(a.transpose(1, 2).contiguous()
                             for a in args[:4]), args[4],
                           do.transpose(1, 2).contiguous(), heads=2)
        got["bshn"] = (*(a.transpose(1, 2) for a in t[:4]), t[4])
        leaves = [a.clone().requires_grad_(True) for a in args]
        out = wk.wkv6_bshn(*(a.transpose(1, 2) for a in leaves[:4]),
                           leaves[4])
        if type(out.grad_fn).__name__ != "WKV6Backward":
            fail(f"wkv6_bwd ({b},{h},{s},{n}) {dt}: the card route did "
                 "not go through the WKV6 Function")
        out.backward(do.transpose(1, 2))
        fn = [a.grad for a in leaves]
        for a in leaves:
            a.grad = None
        wk_ref.wkv6_ref(*leaves).backward(do)
        # (at S = 1 the output does not depend on w: autograd leaves it
        # without a gradient, which is 0)
        auto = [torch.zeros_like(a) if a.grad is None else a.grad
                for a in leaves]
        if wk.BWD_LAUNCHES != before + 3:
            fail(f"wkv6_bwd ({b},{h},{s},{n}) {dt}: "
                 f"{wk.BWD_LAUNCHES - before} backward launches, want 3")
        what = " ".join([f"B={b} H={h} S={s} n={n}", *decay, dt])
        shares, err = {}, 0.0
        for kind, gs, ws in (("kernel_bhsn", got["bhsn"], want),
                             ("kernel_bshn", got["bshn"], want),
                             ("function", fn, auto)):
            for name, a, w, x in zip(names, gs, ws, args):
                if a.dtype != x.dtype or a.shape != x.shape:
                    fail(f"wkv6_bwd {what} {kind}: {name} "
                         f"{a.dtype} {tuple(a.shape)}, input {x.dtype} "
                         f"{tuple(x.shape)}")
                shares[f"{kind}.{name}"] = _grad_share(a, w, GRAD_TOL[dt])
                err = max(err, float((a.float() - w.float()).abs().max()))
        worst = max(shares, key=shares.get)
        if not shares[worst] <= 1:
            fail(f"wkv6_bwd {what}: {worst} used {shares[worst]:.3g} of "
                 f"{GRAD_TOL[dt]} x max|g| ({shares})")
        cases.append({"case": what, "tol": GRAD_TOL[dt],
                      "max_share_of_tol": shares[worst], "worst": worst,
                      "max_abs_err": err})
        del args, do, want, got, t, leaves, out, fn, auto
    torch.cuda.empty_cache()
    return {"cases": cases, "max_abs_err": max(c["max_abs_err"]
                                               for c in cases),
            "max_share_of_tol": {
                dt: max(c["max_share_of_tol"] for c in cases
                        if c["case"].endswith(dt)) for dt in GRAD_TOL}}


def model_kernel_timings() -> tuple[list[dict], list[dict]]:
    """Kernel, plain version and library call at the model path's shapes
    (bf16, as the served models call them; f32 at the parity prefill's
    shape and at the long prompt, bound by three TF32 products per flop,
    the kernel's method, with the FMA pipes' bound beside it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.analysis.hlo import bound_ms
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rwkv6 import ops as wk
    from repro_torch.kernels.rwkv6 import ref as wk_ref
    g = torch.Generator(device="cuda").manual_seed(12)
    flash = []
    for heads, b, s, dt in FLASH_TIMED:
        shape = (b, *heads[:2], s, heads[2])
        plan = _flash_plan(*shape, True, dt)
        q, k, v = _flash_inputs(*shape, dt, g)
        reps = 20 if s <= 1024 else 5
        kern, kern_issued = _time_ms(
            lambda: fa.flash_attention(q, k, v, causal=True), reps, 2)
        plain, _ = _time_ms(lambda: fa_ref.attention_ref(q, k, v), reps, 2)
        lib, _ = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps, 2)
        flops, nbytes = fa.work(*shape, dt)
        if dt == "float32":
            # the kernel's own bound: three TF32 tensor-core products per
            # flop; the FMA pipes' bound beside it
            bound, by = bound_ms(3 * flops, nbytes, "tf32")
            fma = dict(zip(("fma_bound_ms", "fma_bound_by"),
                           bound_ms(flops, nbytes, dt)))
        else:
            (bound, by), fma = bound_ms(flops, nbytes, dt), {}
        kind = "bf16" if dt == "bfloat16" else "f32"
        h, kv, d = heads
        train = (heads, b, s, dt) in TRAIN_TIMED
        flash.append({
            "shape": f"B={b} H={h} KV={kv} S={s} D={d} {kind} causal",
            "models": ([f"{TRAIN_HEADS[heads]} (train)"] if train
                       else FLASH_HEADS[heads]),
            "ms": kern, "issued_ms": kern_issued, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bound, "bound_by": by, **fma,
            "TFLOPs": flops / kern / 1e9, "CTAs": plan["grid"]})
        del q, k, v
    wkv = []
    clock_hz = sm_clock_max_hz()
    for b, s in ((4, SERVE["prompt_len"]), (1, LONG_PROMPT)):
        shape = (b, 40, s, 64)
        args = _wkv6_inputs(*shape, "bfloat16", g)
        kern, kern_issued = _time_ms(lambda: wk.wkv6(*args), 10, 2)
        plain, _ = _time_ms(lambda: wk_ref.wkv6_ref(*args), 2, 1,
                            spin=False)
        flops, nbytes = wk.work(*shape, "bfloat16")
        bound, by = bound_ms(flops, nbytes, "float32")
        plan = _wkv6_plan(*shape, "bfloat16")
        gx, gy, gz = plan["grid"]
        wkv.append({"shape": f"B={b} H=40 S={s} n=64 bf16 r,k,v",
                    "ms": kern, "issued_ms": kern_issued,
                    "plain_ms": plain, "library_ms": None,
                    "bound_ms": bound, "bound_by": by,
                    "CTAs": gx * gy * gz,
                    "threads_per_CTA": plan["threads"],
                    "smem_bytes": plan["smem_bytes"],
                    "cycles_per_token_at_max_clock":
                        kern * 1e-3 * clock_hz / s})
    return flash, wkv


def kernel_split_ms(fn, reps: int = 5) -> dict | None:
    """Device ms per call of ``fn`` by kernel name (``torch.profiler``'s
    ``key_averages`` over ``reps`` calls after one warm call), or None
    where the trace holds some kernel fewer or more than ``reps`` times
    (a trace that lost events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def name(key: str) -> str:       # the kernel's name, no arguments
        return re.sub(r"^void |\(anonymous namespace\)::", "",
                      key).split("(")[0][:60]
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels or any(e.count != reps for e in kernels):
        return None
    return {name(e.key): e.self_device_time_total / 1e3 / reps
            for e in kernels}


def _wkv6_bwd_launch_args() -> tuple:
    """r, k, v, w (bf16 r, k, v in the model's BSHN layout), u and do at
    rwkv6-3b's training launch (``WKV6_LAUNCH``)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(15)
    b, h, s, n = WKV6_LAUNCH
    args = _wkv6_inputs(b, h, s, n, "bfloat16", g)
    return (*(a.transpose(1, 2).contiguous() for a in args[:4]), args[4],
            _randn((b, s, h, n), g))


def wkv6_bwd_split() -> dict | None:
    """Each ``wkv6_bwd`` kernel's device ms at ``WKV6_LAUNCH``
    (``kernel_split_ms``). Taken in phase 2, before the run's other
    traces: taken in the report, after them, the trace held some of
    these kernels' launches and not others (two runs on the H100)."""
    from repro_torch.kernels.rwkv6 import ops as wk
    args = _wkv6_bwd_launch_args()
    return kernel_split_ms(lambda: wk._launch_bwd(*args, heads=2))


def wkv6_bwd_timing(split: dict | None) -> dict:
    """``wkv6_bwd`` at rwkv6-3b's training launch (``WKV6_LAUNCH``, bf16
    r, k, v in the model's BSHN layout) beside its bound and the plain
    backward's time (``wkv6_bwd_ref``, a Python loop over tokens: timed
    without the spin, once); its workspace, and each kernel's share of
    its device time (``split``, from ``wkv6_bwd_split``)."""
    from repro_torch.analysis.hlo import bound_ms
    from repro_torch.kernels.rwkv6 import ops as wk
    from repro_torch.kernels.rwkv6 import ref as wk_ref
    b, h, s, n = WKV6_LAUNCH
    r, k, v, w, u, do = _wkv6_bwd_launch_args()
    kern, issued = _time_ms(
        lambda: wk._launch_bwd(r, k, v, w, u, do, heads=2), 10, 2)
    plain, _ = _time_ms(lambda: wk_ref.wkv6_bwd_ref(
        *(a.transpose(1, 2) for a in (r, k, v, w)), u, do.transpose(1, 2)),
        1, 0, spin=False)
    flops, nbytes = wk.bwd_work(b, h, s, n, "bfloat16")
    bound, by = bound_ms(flops, nbytes, "float32")
    plan = _wkv6_bwd_plan(b, h, s, n, "bfloat16")
    gx, gy, gz = plan["grid"]
    return {"shape": f"B={b} H={h} S={s} n={n} bf16 r,k,v bshn",
            "ms": kern, "issued_ms": issued, "plain_ms": plain,
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "CTAs": gx * gy * gz, "cluster": plan["cluster"],
            "threads_per_CTA": plan["threads"],
            "smem_bytes": plan["smem_bytes"],
            "workspace_bytes": plan["workspace_bytes"],
            "kernel_ms": split or "not measured: the trace lost events",
            "kernel_share": split and {
                k_: v_ / sum(split.values()) for k_, v_ in split.items()},
            "cycles_per_token_at_max_clock":
                kern * 1e-3 * sm_clock_max_hz() / s}


# the selective scan (``kernels/selective_scan``): (b, S, d_in, N, whether
# a state is given): one token, a tile's edge and ragged tiles, d_in not a
# multiple of a CTA's channels, every state size the kernel instantiates,
# and a Jamba2-Mini layer's prefill (``SCAN_TIMED``) filling its state;
# y and the last state each within SCAN_TOL of the plain version's
# largest |value| (the two differ in the order of rounding and in exp2
# for exp)
SCAN_TIMED = (1, 8192, 8192, 16)
SCAN_CASES = [(1, 1, 64, 16, False), (2, 63, 100, 16, True),
              (2, 64, 100, 16, False), (2, 300, 100, 16, True),
              (1, 300, 72, 4, True), (1, 130, 200, 4, False),
              (*SCAN_TIMED, True)]
SCAN_TOL = 1e-5
SFU_EXP_PER_CLOCK_SM = 16        # Hopper: MUFU.EX2 a clock an SM


def _scan_inputs(b, s, d_in, n, g, with_h=False):
    """u, dt, B, C, A (and h where asked) in the model's regime: dt a
    softplus near its bias's 0.01, A = -(1..n) times e^(0.1 x), f32."""
    import torch
    import torch.nn.functional as F
    u = _randn((b, s, d_in), g)
    dt = F.softplus(_randn((b, s, d_in), g) * 0.5 - 4.6)
    B, C = _randn((b, s, n), g), _randn((b, s, n), g)
    A = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda").repeat(
        d_in, 1) * torch.exp(_randn((d_in, n), g) * 0.1)
    return u, dt, B, C, A, _randn((b, d_in, n), g) if with_h else None


def scan_kernel_phase(check: FloatCheck) -> None:
    """Every ``SCAN_CASES`` case: the kernel's y and last state against
    the plain version's on the card, one launch a call, and the launch
    the library plans held to ``ops.launch_plan``."""
    import ctypes

    import torch

    from repro_torch.kernels.build import load
    from repro_torch.kernels.selective_scan import ops as ss
    g = torch.Generator(device="cuda").manual_seed(13)
    out = (ctypes.c_int * 6)()
    for b, s, d_in, n, with_h in SCAN_CASES:
        plan = ss.launch_plan(b, d_in, n)
        if load().selective_scan_plan(b, d_in, n, out):
            fail(f"selective_scan_plan failed at {(b, d_in, n)}")
        got_plan = {"grid": (out[0], out[1]), "threads": out[2],
                    "smem_bytes": out[3], "tile": out[4],
                    "channels": out[5]}
        if got_plan != plan:
            fail(f"selective_scan: the library plans {got_plan}, "
                 f"ops.launch_plan {plan}")
        args = _scan_inputs(b, s, d_in, n, g, with_h)
        want_y, want_h = ss.selective_scan_ref(*args)
        before = ss.LAUNCHES
        got_y, got_h = ss.selective_scan(*args)
        torch.cuda.synchronize()
        if ss.LAUNCHES != before + 1:
            fail(f"selective_scan: {ss.LAUNCHES - before} launches a call")
        what = f"({b},{s},{d_in},{n}) h={'given' if with_h else 'zeros'}"
        check.rel(what + " y", got_y, want_y, SCAN_TOL)
        check.rel(what + " last state", got_h, want_h, SCAN_TOL)
        del args, want_y, want_h, got_y, got_h


def scan_timing() -> dict:
    """The kernel at ``SCAN_TIMED`` beside its bound (the larger of its
    bytes at HBM's rate and its exponentials on the card's SFUs at its
    highest clock) and the plain version (some 45 launches a 64-token
    chunk, more than the launch queue holds: timed without the spin)."""
    import torch

    from repro_torch.analysis.hlo import bound_ms
    from repro_torch.kernels.selective_scan import ops as ss
    b, s, d_in, n = SCAN_TIMED
    g = torch.Generator(device="cuda").manual_seed(14)
    args = _scan_inputs(b, s, d_in, n, g)
    kern, issued = _time_ms(lambda: ss.selective_scan(*args), 20, 3)
    plain, _ = _time_ms(lambda: ss.selective_scan_ref(*args), 2, 1,
                        spin=False)
    flops, nbytes = ss.work(b, s, d_in, n)
    mem_ms, mem_by = bound_ms(flops, nbytes, "float32")
    clock_hz = sm_clock_max_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_ms = b * s * d_in * n / (SFU_EXP_PER_CLOCK_SM * sms * clock_hz) \
        * 1e3
    bound, by = max((mem_ms, mem_by), (sfu_ms, "exponentials (SFU)"))
    plan = ss.launch_plan(b, d_in, n)
    return {"shape": f"B={b} S={s} d_in={d_in} N={n} f32",
            "ms": kern, "issued_ms": issued, "plain_ms": plain,
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "bytes_bound_ms": mem_ms, "sfu_bound_ms": sfu_ms,
            "GBps": nbytes / kern / 1e6,
            "CTAs": plan["grid"][0] * plan["grid"][1],
            "threads_per_CTA": plan["threads"],
            "smem_bytes": plan["smem_bytes"],
            "cycles_per_token_at_max_clock":
                kern * 1e-3 * clock_hz / s}


# ---------------------------------------------------------------------------
# phase 4: the model path
# ---------------------------------------------------------------------------

def _sync_s(t0: float) -> float:
    import torch
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _decode_profile(params, cfg, step_batch, b: int, steps: int = 3) -> dict:
    """One decode step's wall time (unprofiled, synchronised), and its
    device time from ``torch.profiler`` (the kernels' own durations):
    their ratio is the card's busy share during decode. ``step_batch(i)``
    is the batch of step i."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    state = lm.decode_state_init(cfg, b, steps + 1, device="cuda")

    def run():
        for i in range(steps):
            lm.decode_step(params, cfg, state, step_batch(i),
                           torch.full((b,), i, dtype=torch.int32,
                                      device="cuda"))
        torch.cuda.synchronize()

    run()                                          # warm
    t0 = time.perf_counter()
    run()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device = sum(e.self_device_time_total for e in kernels) / 1e6 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    return {"step_ms": wall * 1e3, "device_ms": device * 1e3,
            "busy_share": device / wall,
            "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                               / steps for e in top}}


def model_config(arch: str):
    """``arch``'s published config with phase 4's cuts (``CUTS``);
    returns (config, the cuts as text or None)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    over, why = CUTS.get(arch, ({}, None))
    over = dict(over)
    if "n_experts" in over:
        over["moe"] = dataclasses.replace(cfg.moe,
                                          n_experts=over.pop("n_experts"))
    return dataclasses.replace(cfg, **over), why


def prefill_launches(cfg) -> dict:
    """Kernel launches one prefill makes: ``flash_attention`` once per
    self-attention layer (a cross-attention layer given its context runs
    plain torch ops), ``wkv6`` once per rwkv6 layer, ``selective_scan``
    once per Mamba layer."""
    def layers(mixer):
        return sum(b.mixer == mixer for b in cfg.pattern) * cfg.n_groups
    return {"flash_attention": layers("attn"), "wkv6": layers("rwkv6"),
            "selective_scan": layers("mamba")}


def model_batch(params, cfg, toks, ctx=None) -> dict:
    """What the model is fed for prompt tokens ``toks`` (B, S): a frames
    model the embedding rows of the tokens in the compute dtype (as
    ``serve_batch`` feeds it), any other the tokens; and ``ctx`` for a
    cross-attention model."""
    import torch
    if cfg.frontend == "frames":
        batch = {"frames": params["embed"][toks.long()].to(
            getattr(torch, cfg.compute_dtype))}
    else:
        batch = {"tokens": toks}
    if ctx is not None:
        batch["ctx"] = ctx
    return batch


def fill_cross_cache(params, cfg, state, ctx) -> None:
    """Fill each cross-attention layer's decode cache with ``ctx @ wk``
    and ``ctx @ wv`` as (B, KV, Nctx, Dh), so that decode attends over
    the context the prefill was given. No entry point of the port (or of
    the JAX package) fills it: this is the smoke's, for the parity
    check."""
    import torch
    cdt = getattr(torch, cfg.compute_dtype)
    b, n, _ = ctx.shape
    for p, blk in enumerate(cfg.pattern):
        if blk.mixer != "cross_attn":
            continue
        mixer = params["blocks"][p]["mixer"]
        for name, w in (("k", "wk"), ("v", "wv")):
            t = ctx.to(cdt)[None] @ mixer[w].to(cdt)[:, None]  # (G,B,N,E)
            state[p]["kv"][name].copy_(t.reshape(
                cfg.n_groups, b, n, cfg.n_kv_heads, cfg.d_head
            ).transpose(2, 3))


def count_on_card(fn, *args) -> dict:
    """One untimed call of ``fn(*args)`` under ``analysis.hlo.count`` on
    the card: its FLOPs, bytes and charged kernels, and the kernels
    launched meanwhile."""
    import torch

    from repro_torch.analysis import hlo
    from repro_torch.kernels.cellcopy import ops as cc
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv6 import ops as wk

    def launches():
        return {"flash_attention": fa.LAUNCHES, "wkv6": wk.LAUNCHES,
                "wkv6_bwd": wk.BWD_LAUNCHES, "cellcopy": cc.LAUNCHES}
    before = launches()
    st = hlo.count(fn, *args)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in launches().items()
                if v - before[k]}
    return {"flops": st.flops, "bytes": st.bytes_,
            "kernels": {k: v["launches"] for k, v in st.kernels.items()},
            "launched": launched}


def roofline_shape(kind: str):
    """Phase 8 (a)'s shape of llama3-8b's ``kind`` step: the prefill of
    one ``LONG_PROMPT``-token row, or a decode step at batch 4 over the
    cache ``_decode_profile`` times (steps + 1 = 4 positions)."""
    import dataclasses

    from repro_torch.configs import SHAPES
    if kind == "prefill":
        return dataclasses.replace(SHAPES["prefill_32k"], seq_len=LONG_PROMPT,
                                   global_batch=1)
    return dataclasses.replace(SHAPES["decode_32k"], seq_len=4,
                               global_batch=ROOFLINE["decode_batch"])


def count_serve_steps(params, cfg, long_prompt, prompts) -> dict:
    """Phase 8 (a) on the card: ``make_serve_prefill``'s step of the long
    prompt and ``make_serve_decode``'s step at batch 4, once each under
    the counter."""
    import torch

    from repro_torch.models import lm
    from repro_torch.train import steps as ST
    pre = ST.make_serve_prefill(cfg, roofline_shape("prefill"), None)
    out = {"prefill": count_on_card(pre.fn, params,
                                    {"tokens": long_prompt})}
    shape = roofline_shape("decode")
    b = shape.global_batch
    state = lm.decode_state_init(cfg, b, shape.seq_len, device="cuda")
    dec = ST.make_serve_decode(cfg, shape, None)
    out["decode"] = count_on_card(
        dec.fn, params, state, {"tokens": prompts[:b, :1].contiguous()},
        torch.zeros((b,), dtype=torch.int32, device="cuda"))
    del state
    return out


def model_phase(arch: str) -> dict:
    """Serve and prefill ``arch`` at full width (and full depth unless
    ``CUTS`` cuts it); returns what the run measured and how often each
    kernel launched."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.cellcopy import ops as cc
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv6 import ops as wk
    from repro_torch.kernels.selective_scan import ops as ss
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm
    kernels = {"flash_attention": fa, "wkv6": wk, "selective_scan": ss}
    cfg, reduced = model_config(arch)
    per_prefill = prefill_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(cfg, 0, device="cuda")
    init_s = _sync_s(t0)
    param_gb = sum(t.numel() * t.element_size()
                   for t in lm.tree_leaves(params)) / 1e9
    res: dict = {"arch": arch, "reduced": reduced, "init_s": init_s,
                 "param_GB": param_gb,
                 "launches_per_prefill": per_prefill}

    # the main path: counts to 0 just before, read just after
    cc.LAUNCHES = fa.LAUNCHES = wk.LAUNCHES = ss.LAUNCHES = 0
    served = serve_batch(cfg, params=params, seed=0, quiet=True,
                         device="cuda", **SERVE)
    if served["tokens"].shape != (SERVE["batch"], SERVE["gen"]) or not (
            (served["tokens"] >= 0) & (served["tokens"] < cfg.vocab_size)
    ).all():
        fail(f"{arch}: serve_batch gave bad tokens {served['tokens']}")
    res["serve"] = {k: served[k] for k in
                    ("decode_tok_per_s", "prefill_s", "decode_s")}
    res["serve"]["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
    if fa.LAUNCHES or wk.LAUNCHES or ss.LAUNCHES:
        fail(f"{arch}: serve_batch's teacher-forced prefill launched a "
             "prefill kernel")
    rng = np.random.default_rng(0)          # serve_batch's prompts
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(SERVE["batch"], SERVE["prompt_len"]),
        dtype=np.int32)).cuda()
    long_prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(1, LONG_PROMPT), dtype=np.int32)).cuda()
    ctx = long_ctx = None
    if cfg.n_ctx_tokens:
        g = torch.Generator(device="cuda").manual_seed(CTX_SEED)
        ctx, long_ctx = (torch.randn((b, cfg.n_ctx_tokens, cfg.d_model),
                                     generator=g, device="cuda")
                         for b in (SERVE["batch"], 1))

    def prefill(c, batch, what):
        before = {k: m.LAUNCHES for k, m in kernels.items()}
        t0 = time.perf_counter()
        logits = lm.prefill(params, c, batch)
        secs = _sync_s(t0)
        n = {k: m.LAUNCHES - before[k] for k, m in kernels.items()}
        if n != per_prefill:
            fail(f"{arch} {what}: kernel launches {n}, want one per "
                 f"self-attention, rwkv6 or Mamba layer {per_prefill}")
        b = next(iter(batch.values())).shape[0]
        if logits.shape != (b, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            fail(f"{arch} {what}: logits {tuple(logits.shape)} not finite "
                 "or of the wrong shape")
        return logits, secs

    step = model_batch(params, cfg, prompts)
    res["decode_profile"] = _decode_profile(
        params, cfg, lambda i: {k: v[:, i:i + 1] for k, v in step.items()},
        SERVE["batch"])
    torch.cuda.reset_peak_memory_stats()
    short = model_batch(params, cfg, prompts, ctx)
    _, cold = prefill(cfg, short, "prefill 4x128")
    _, warm = prefill(cfg, short, "prefill 4x128")
    _, long_s = prefill(cfg, model_batch(params, cfg, long_prompt, long_ctx),
                        f"prefill 1x{LONG_PROMPT}")
    res["prefill"] = {"4x128_s": warm, "4x128_first_s": cold,
                      f"1x{LONG_PROMPT}_s": long_s,
                      "peak_GB": torch.cuda.max_memory_allocated() / 1e9}
    del short

    # f32 compute, TF32 off: prefill (kernel) against teacher-forced
    # decode (no kernel) at the last prompt position; MoE at ample
    # capacity (the prefill's groups and decode's drop different tokens
    # by design), cross-attention over the prefill's context in the
    # decode cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    if cfg.moe is not None:
        c32 = dataclasses.replace(c32, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    full = model_batch(params, c32, prompts, ctx)
    _, f32_first = prefill(c32, full, "f32 prefill")
    par, f32_warm = prefill(c32, full, "f32 prefill")
    state = lm.decode_state_init(c32, SERVE["batch"], SERVE["prompt_len"],
                                 device="cuda")
    if ctx is not None:
        fill_cross_cache(params, c32, state, ctx)
    for i in range(SERVE["prompt_len"]):
        seq, state = lm.decode_step(
            params, c32, state,
            {k: v[:, i:i + 1] for k, v in full.items() if k != "ctx"},
            torch.full((SERVE["batch"],), i, dtype=torch.int32,
                       device="cuda"))
    diff = float((par - seq).abs().max())
    scale = float(seq.abs().max())
    res["f32_prefill_vs_decode"] = {"max_abs_diff": diff,
                                    "max_abs_logit": scale,
                                    "ratio": diff / scale,
                                    "tol": LOGIT_TOL,
                                    "prefill_4x128_s": f32_warm,
                                    "prefill_4x128_first_s": f32_first,
                                    "peak_GB": torch.cuda.
                                    max_memory_allocated() / 1e9}
    if not diff <= LOGIT_TOL * scale:
        fail(f"{arch}: f32 prefill and teacher-forced decode differ by "
             f"{diff:.3g} (max |logit| {scale:.3g})")
    res["launches"] = {"cellcopy": cc.LAUNCHES,
                       **{k: m.LAUNCHES for k, m in kernels.items()}}
    want = {k: 5 * n for k, n in per_prefill.items()}
    if {k: m.LAUNCHES for k, m in kernels.items()} != want or cc.LAUNCHES:
        fail(f"{arch}: launches on the model path {res['launches']}, "
             f"want {want} and no cellcopy")
    peak = max(res[k]["peak_GB"] for k in
               ("serve", "prefill", "f32_prefill_vs_decode"))
    if not peak < 80:
        fail(f"{arch}: peak card memory {peak:.1f} GB, over 80 GB")
    if arch == ROOFLINE["arch"]:
        # phase 8 (a): the long prefill and a decode step once more,
        # untimed, under the dry run's counter
        res["counted"] = count_serve_steps(params, cfg, long_prompt,
                                           prompts)
    del params, state, full, ctx, long_ctx
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------

def _grad_share(got, want, tol: float) -> float:
    """max |got - want| / (tol x max |want|): at most 1 on a pass."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max()) / (tol * max(float(w.abs().max()),
                                                   1e-30))


def train_grad_phase() -> dict:
    """(a) dq, dk, dv of ``flash_attention`` (the autograd Function: the
    kernel forward, launched once, and the torch-op backward) against
    autograd through ``attention_ref`` on the same inputs on the card, at
    each trained model's heads and batch, S = 128 and 4096, bf16 and
    f32, causal; and the backward's own time (``bwd.attention_bwd``)."""
    import torch

    from repro_torch.kernels.flash_attention import bwd
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    g = torch.Generator(device="cuda").manual_seed(13)
    cases = []
    for (h, kv, d), arch in TRAIN_HEADS.items():
        b = TRAIN[arch]
        for s in (128, LONG_PROMPT):
            for dt in ("bfloat16", "float32"):
                what = f"B={b} H={h} KV={kv} S={s} D={d} {dt}"
                q, k, v = (t.requires_grad_(True)
                           for t in _flash_inputs(b, h, kv, s, d, dt, g))
                do = _randn((b, h, s, d), g, dt)
                before = fa.LAUNCHES
                out = fa.flash_attention(q, k, v, causal=True)
                if fa.LAUNCHES != before + 1 or type(
                        out.grad_fn).__name__ != "FlashAttentionBackward":
                    fail(f"train (a) {what}: the card route did not go "
                         "through the Function's one launch")
                out.backward(do)
                got = [t.grad for t in (q, k, v)]
                for t in (q, k, v):
                    t.grad = None
                fa_ref.attention_ref(q, k, v, causal=True).backward(do)
                shares = {n: _grad_share(a, t.grad, GRAD_TOL[dt])
                          for n, a, t in zip(("dq", "dk", "dv"), got,
                                             (q, k, v))}
                if not max(shares.values()) <= 1:
                    fail(f"train (a) {what}: gradients differ from "
                         f"autograd through attention_ref: {shares} of "
                         f"{GRAD_TOL[dt]} x max|g|")
                case = {"case": what, "tol": GRAD_TOL[dt],
                        "share_of_tol": shares}
                if s == LONG_PROMPT and dt == "bfloat16":
                    o = out.detach()
                    case["torch_op_bwd_ms"], _ = _time_ms(
                        lambda: bwd.attention_bwd(q, k, v, o, do), 3, 1,
                        spin=False)
                cases.append(case)
                del q, k, v, do, out, got
    torch.cuda.empty_cache()
    return {"cases": cases, "max_share_of_tol": {
        dt: max(max(c["share_of_tol"].values()) for c in cases
                if c["case"].endswith(dt)) for dt in GRAD_TOL}}


def train_model_grad_phase(arch: str) -> dict:
    """(b) ``arch`` at full width in f32 compute (its ``MODEL_GRAD_CUTS``
    depth): ``loss_fn`` and every leaf's gradient on the card (kernel
    forwards; the flash kernel's torch-op backward and ``wkv6_bwd``; TF32
    off) against the port's CPU route (plain versions) from the same
    weights and batch; one kernel launch of each kind per layer; every
    layer's mixer projections (wq, wk, wv or wr, wk, wv, and rwkv6's u)
    get a non-zero gradient on the card."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv6 import ops as wk
    from repro_torch.models import lm
    from repro_torch.train import data as D
    torch.backends.cuda.matmul.allow_tf32 = False
    cut = MODEL_GRAD_CUTS[arch]
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32",
                              **cut)
    batch = D.SyntheticLM(D.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=MODEL_GRAD["seq_len"],
        global_batch=MODEL_GRAD["batch"])).batch(0)
    card = lm.init(cfg, 0, device="cuda")
    cpu = lm._tree_map(lambda t: t.cpu(), card)
    want = prefill_launches(cfg)
    want = {"flash_attention": want["flash_attention"],
            "wkv6": want["wkv6"], "wkv6_bwd": want["wkv6"]}
    res = {"arch": arch, "cut": cut or None}
    for name, params in (("card", card), ("cpu", cpu)):
        dev = next(lm.tree_leaves(params)).device
        for t in lm.tree_leaves(params):
            t.requires_grad_(True)
        before = (fa.LAUNCHES, wk.LAUNCHES, wk.BWD_LAUNCHES)
        t0 = time.perf_counter()
        total, m = lm.loss_fn(params, cfg, {
            k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        total.backward()
        if name == "card":
            res["card_fwd_bwd_s"] = _sync_s(t0)
            got = dict(zip(want, (a - b for a, b in zip(
                (fa.LAUNCHES, wk.LAUNCHES, wk.BWD_LAUNCHES), before))))
            if got != want:
                fail(f"train (b) {arch}: launches {got}, want {want}")
            res["launches"] = got
        else:
            res["cpu_fwd_bwd_s"] = time.perf_counter() - t0
        res[f"{name}_loss"] = m["loss"].item()
    mixer = card["blocks"][0]["mixer"]
    names = ("wq", "wk", "wv") if "wq" in mixer else ("wr", "wk", "wv", "u")
    for w in names:
        g = mixer[w].grad
        zero = [i for i in range(cfg.n_groups) if not bool(g[i].any())]
        if zero:
            fail(f"train (b) {arch}: {w}.grad is zero in layers {zero}")
    loss_rel = abs(res["card_loss"] - res["cpu_loss"]) / abs(res["cpu_loss"])
    share = 0.0
    for a, b in zip(lm.tree_leaves(card), lm.tree_leaves(cpu)):
        share = max(share, _grad_share(a.grad.cpu(), b.grad,
                                       MODEL_GRAD["grad_tol"]))
    res.update({"loss_rel_diff": loss_rel, "grad_max_share_of_tol": share,
                **MODEL_GRAD, f"every_layer_{'_'.join(names)}_grad_nonzero":
                    True})
    if not (loss_rel <= MODEL_GRAD["loss_rtol"] and share <= 1):
        fail(f"train (b) {arch}: card against CPU: loss rel diff "
             f"{loss_rel:.3g} (tol {MODEL_GRAD['loss_rtol']}), gradient "
             f"{share:.3g} of {MODEL_GRAD['grad_tol']} x max|g|")
    del card, cpu
    torch.cuda.empty_cache()
    return res


def train_run(arch: str) -> dict:
    """(c) ``run_training`` of ``arch``'s published config at train_4k's
    seq_len and ``TRAIN[arch]`` sequences a step, ``TRAIN_STEPS`` steps
    (counts to 0 just before, read just after); then one more step timed
    in parts (batch generation on the host, forward + backward, the
    optimizer) and one under ``torch.profiler``, whose device time over
    its own wall time is the card's busy share."""
    import dataclasses

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.cellcopy import ops as cc
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv6 import ops as wk
    from repro_torch.launch import train as T
    from repro_torch.train import data as D
    from repro_torch.train import optimizer as opt
    cfg = get_config(arch)
    b = TRAIN[arch]
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=b)
    per_step = prefill_launches(cfg)
    want = {"flash_attention": per_step["flash_attention"] * TRAIN_STEPS,
            "wkv6": per_step["wkv6"] * TRAIN_STEPS,
            "wkv6_bwd": per_step["wkv6"] * TRAIN_STEPS, "cellcopy": 0}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cc.LAUNCHES = fa.LAUNCHES = wk.LAUNCHES = wk.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    out = T.run_training(cfg, shape, TRAIN_STEPS, quiet=True,
                         device="cuda")
    run_s = _sync_s(t0)
    launches = {"flash_attention": fa.LAUNCHES, "wkv6": wk.LAUNCHES,
                "wkv6_bwd": wk.BWD_LAUNCHES, "cellcopy": cc.LAUNCHES}
    hist = out["history"]
    uniform = float(np.log(cfg.vocab_size))
    res = {"arch": arch, "reduced": (
        f"global batch 256 -> {b} (one card); {TRAIN_STEPS} steps"),
        "seq_len": shape.seq_len, "global_batch": b, "history": hist,
        "ln_vocab": uniform, "run_s": run_s,
        "tokens_per_s": out["tokens_per_s"], "launches": launches,
        "launches_per_step": {k: v // TRAIN_STEPS
                              for k, v in launches.items()},
        "peak_GB": torch.cuda.max_memory_allocated() / 1e9}
    if len(hist) != TRAIN_STEPS or not all(map(np.isfinite, hist)):
        fail(f"train (c) {arch}: losses {hist}")
    if not abs(hist[0] - uniform) < 1.0:
        fail(f"train (c) {arch}: step 0's loss {hist[0]:.3f}, not near "
             f"ln(vocab) = {uniform:.3f}")
    if launches != want:
        fail(f"train (c) {arch}: launches {launches}, want {want} (one "
             f"flash launch per self-attention layer and one wkv6 "
             f"forward and backward per rwkv6 layer, x {TRAIN_STEPS} "
             "steps)")

    params, state = out["params"], out["opt_state"]
    oc = opt.for_model(cfg)
    ds = D.SyntheticLM(D.for_model(cfg, shape, 0))

    def step(i: int) -> dict:
        """``run_training``'s step (``grad_step``, ``update_step``) with a
        sync after each part; the seconds of each part."""
        t = {"t0": time.perf_counter()}
        host = ds.batch(i)
        t["gen"] = time.perf_counter()
        batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
        torch.cuda.synchronize()
        t["h2d"] = time.perf_counter()
        grads, _ = T.grad_step(params, cfg, batch)
        torch.cuda.synchronize()
        t["fwd_bwd"] = time.perf_counter()
        T.update_step(params, oc, state, grads)
        torch.cuda.synchronize()
        t["opt"] = time.perf_counter()
        keys = list(t)
        return {f"{k}_s": t[k] - t[p] for p, k in zip(keys, keys[1:])}

    split = step(TRAIN_STEPS)
    wall = sum(split.values())
    # the busy share: device time and wall time of the same (profiled)
    # step; the profiler's host overhead only lengthens the wall
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = step(TRAIN_STEPS + 1)
    traced_wall = sum(traced.values())
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    res.update({
        "step_split_s": split, "step_s": wall,
        "steady_tokens_per_s": b * shape.seq_len / wall,
        "traced_step_split_s": traced, "traced_step_s": traced_wall,
        "device_s": device_s, "busy_share": device_s / traced_wall,
        "busy_share_without_batch_gen":
            device_s / (traced_wall - traced["gen_s"]),
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                           for e in top},
        "peak_GB": torch.cuda.max_memory_allocated() / 1e9})
    if not 0 < res["busy_share_without_batch_gen"] <= 1:
        fail(f"train (c) {arch}: {device_s:.4f} s of device time in a "
             f"step of {traced_wall:.4f} s, "
             f"{traced_wall - traced['gen_s']:.4f} s without batch "
             "generation")
    if not res["peak_GB"] < 80:
        fail(f"train (c) {arch}: peak card memory {res['peak_GB']:.1f} GB")
    del out, params, state
    torch.cuda.empty_cache()
    return res


def train_restart_phase() -> dict:
    """(d) under ``torch.use_deterministic_algorithms(True)``: for each
    config of ``RESTART_CUTS``, ``run_training`` uninterrupted, then with
    a ``FailureInjector`` firing at step ``fail_at`` and a resume from a
    ``CheckpointManager`` in a temporary directory: params and optimizer
    state bitwise equal. Then the resumed smollm-135m params + state
    through ``ArenaCheckpoint`` into a ``SharedMemoryPool`` mapped into
    the card and back into fresh tensors: bitwise equal, each leaf in
    and out by one ``cellcopy`` launch (counts to 0 just before, read
    just after)."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import Arena, SharedMemoryPool
    from repro_torch.kernels.cellcopy import ops as cc
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    from repro_torch.train.checkpoint import ArenaCheckpoint
    from repro_torch.train.fault import FailureInjector, InjectedFailure
    shape = dataclasses.replace(SHAPES["train_4k"],
                                seq_len=RESTART["seq_len"],
                                global_batch=RESTART["global_batch"])
    n = RESTART["steps"]
    kw = dict(quiet=True, device="cuda")
    res: dict = {**RESTART, "deterministic": True}
    torch.use_deterministic_algorithms(True)
    try:
        for arch, cut in RESTART_CUTS.items():
            cfg = dataclasses.replace(get_config(arch), **cut)
            ref = T.run_training(cfg, shape, n, **kw)
            with tempfile.TemporaryDirectory() as d:
                ck = dict(ckpt_dir=d, ckpt_every=RESTART["ckpt_every"])
                try:
                    T.run_training(cfg, shape, n, injector=FailureInjector(
                        fail_at_step=RESTART["fail_at"]), **ck, **kw)
                    fail(f"train (d) {arch}: the injected failure never "
                         "fired")
                except InjectedFailure:
                    pass
                t0 = time.perf_counter()
                out = T.run_training(cfg, shape, n, **ck, **kw)
                resume_s = _sync_s(t0)
            if out["history"] != ref["history"][RESTART["fail_at"]:]:
                fail(f"train (d) {arch}: resumed losses {out['history']}, "
                     f"uninterrupted {ref['history']}")
            tree, want = ((out["params"], out["opt_state"]),
                          (ref["params"], ref["opt_state"]))
            diff = [i for i, (a, b) in enumerate(zip(
                lm.tree_leaves(tree), lm.tree_leaves(want)))
                if not torch.equal(a, b)]
            if diff:
                fail(f"train (d) {arch}: restart not bitwise: leaves {diff}")
            res[arch] = {"cut": cut or None, "history": ref["history"],
                         "resume_s": resume_s, "bitwise": True}
            if arch == "smollm-135m":
                arena_tree = tree
        tree = arena_tree
        leaves = list(lm.tree_leaves(tree))
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        pool = SharedMemoryPool(nbytes + len(leaves) * 64 + 64 * MiB,
                                device="cuda")
        try:
            ck = ArenaCheckpoint(Arena(pool, 0, initialize=True), "train")
            like = lm._tree_map(torch.empty_like, tree)
            cc.LAUNCHES = 0
            t0 = time.perf_counter()
            ck.save(n, tree)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            step, got = ck.restore(like)
            restore_s = _sync_s(t0)
            launches = cc.LAUNCHES
        finally:
            pool.close()
            pool.unlink()
        if step != n or any(not torch.equal(a, b) for a, b in zip(
                lm.tree_leaves(got), leaves)):
            fail("train (d): ArenaCheckpoint round trip not bitwise")
        if launches != 2 * len(leaves):
            fail(f"train (d): {launches} cellcopy launches for "
                 f"{len(leaves)} leaves in and out")
        res["arena"] = {"leaves": len(leaves), "GB": nbytes / 1e9,
                        "save_s": save_s, "restore_s": restore_s,
                        "save_GB_per_s": nbytes / save_s / 1e9,
                        "restore_GB_per_s": nbytes / restore_s / 1e9,
                        "cellcopy_launches": launches, "bitwise": True}
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    return res


def train_phase() -> dict:
    """Phase 5: (a) the attention gradient, (b) full-width models'
    gradients, card against CPU, (c) training at full width, (d) the
    restart and the arena checkpoint."""
    res = {}
    t0 = time.perf_counter()
    res["grad"] = train_grad_phase()
    say(f"[train] grad: {json.dumps(res['grad'])} "
        f"({time.perf_counter() - t0:.1f} s)")
    res["model_grad"] = {}
    for arch in MODEL_GRAD_CUTS:
        t0 = time.perf_counter()
        res["model_grad"][arch] = train_model_grad_phase(arch)
        say(f"[train] model_grad: {json.dumps(res['model_grad'][arch])} "
            f"({time.perf_counter() - t0:.1f} s)")
    for arch in TRAIN:
        t0 = time.perf_counter()
        res[arch] = train_run(arch)
        say(f"[train] {json.dumps(res[arch])} "
            f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    res["restart"] = train_restart_phase()
    say(f"[train] restart: {json.dumps(res['restart'])} "
        f"({time.perf_counter() - t0:.1f} s)")
    return res


# ---------------------------------------------------------------------------
# phase 6: cMPI data-parallel training (module level: run_processes spawns)
# ---------------------------------------------------------------------------

def _cmpi_counts() -> dict:
    from repro_torch.kernels.cellcopy import ops as cc
    from repro_torch.kernels.flash_attention import ops as fa
    return {"cellcopy": cc.LAUNCHES, "flash_attention": fa.LAUNCHES}


def _zero_cmpi_counts() -> None:
    from repro_torch.kernels.cellcopy import ops as cc
    from repro_torch.kernels.flash_attention import ops as fa
    cc.LAUNCHES = fa.LAUNCHES = 0


def _cmpi_vp(env) -> dict:
    """(c) vp_embed, vp_cross_entropy and vp_greedy_token on data 2 x
    model 2 against the dense computation on the rank's rows; and the
    gradients of the cross-entropy (dx, summed over model, and the
    table's slice) against dense autograd."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.context import DistContext
    vp = CMPI["vp"]
    cfg = dataclasses.replace(
        get_config(CMPI["arch"]).reduced(), vocab_parallel=True,
        vocab_size=vp["vocab_size"],
        vocab_pad_multiple=vp["vocab_pad_multiple"], compute_dtype="float32")
    dist = DistContext(env.comm, vp["mesh"], vp["axes"])
    g = torch.Generator().manual_seed(3)
    V, D, b, s = cfg.padded_vocab, cfg.d_model, vp["batch"], vp["seq"]
    table = torch.randn(V, D, generator=g).cuda()
    x = torch.randn(b, s, D, generator=g).cuda()
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g).cuda()
    local = dist.shard_batch({"x": x, "toks": toks})
    x, toks = local["x"], local["toks"]
    logits = (x @ table.T)[..., :cfg.vocab_size]
    dense_ce = torch.logsumexp(logits, -1) - torch.take_along_dim(
        logits, toks[..., None], -1)[..., 0]
    out = {"e_embed": float((dist.vp_embed(table, toks, cfg)
                             - table[toks]).abs().max()),
           "e_ce": float((dist.vp_cross_entropy(table, x, toks, cfg)
                          - dense_ce).abs().max()),
           "argmax_mismatches": int((dist.vp_greedy_token(
               table, x[:, 0], cfg) != logits[:, 0].argmax(-1)).sum())}
    grads = []
    for fn in (lambda t, xx: dist.vp_cross_entropy(t, xx, toks, cfg),
               lambda t, xx: torch.logsumexp((xx @ t.T)[
                   ..., :cfg.vocab_size], -1) - torch.take_along_dim(
                   (xx @ t.T), toks[..., None], -1)[..., 0]):
        t, xx = table.clone().requires_grad_(True), \
            x.clone().requires_grad_(True)
        fn(t, xx).sum().backward()
        grads.append((t.grad, xx.grad))
    shard = V // dist.model_size
    lo = dist.axis_index("model") * shard
    (vt, vx), (dt, dx) = grads
    out["e_grad_x"] = float((vx - dx).abs().max() / dx.abs().max())
    out["e_grad_table_slice"] = float(
        (vt[lo:lo + shard] - dt[lo:lo + shard]).abs().max()
        / dt.abs().max())
    out["table_grad_outside_slice"] = bool(
        vt[:lo].any() or vt[lo + shard:].any())
    return out


def cmpi_path(env) -> dict:
    """Phase 6's rank program (4 ranks, pod 2 x data 2): (a) one cMPI
    step of smollm-135m in f32 (``compression="none"``), with rank 0's
    single-card step over the whole batch beside it: its gradients
    against the synced ones, its params against the step's; (b) the same step
    under ``"int8"``, every rank's local gradients and rank 0's synced
    ones returned for the parent's emulation of the JAX package's
    ``psum_int8``; (c) the vocab-parallel functions; (d) smollm-135m in
    bf16 at 4096 tokens a rank, ``CMPI["steps"]`` steps timed in parts,
    the pool bytes the rank copies and its kernel launches, the counts
    set to 0 just before those steps and read just after them."""
    import dataclasses
    import hashlib

    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.context import DistContext
    from repro_torch.distributed.schedules import make_cmpi_train_step
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    from repro_torch.train import data as D
    from repro_torch.train import optimizer as opt
    torch.backends.cuda.matmul.allow_tf32 = False
    stats = env.arena.view.stats
    rep = {"rank": env.rank, "device": str(env.comm.device)}
    t_all = time.perf_counter()
    dist = DistContext(env.comm, CMPI["mesh"], CMPI["axes"])
    rep["coords"], rep["dp_index"] = dist.coords, dist.dp_index

    # (a) and (b): f32 compute, the same params, one step each way
    cfg = dataclasses.replace(get_config(CMPI["arch"]),
                              compute_dtype="float32")
    n = dist.dp_size
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=CMPI["f32_seq"],
                                global_batch=CMPI["f32_rows"] * n)
    batch = {k: torch.from_numpy(v).cuda() for k, v in D.SyntheticLM(
        D.for_model(cfg, shape, 0)).batch(0).items()}
    oc = opt.for_model(cfg)
    after, synced_none = {}, None
    for comp in ("none", "int8"):
        params = lm.init(cfg, 0, device="cuda")
        state = opt.init(oc, params)
        step = make_cmpi_train_step(cfg, shape, dist, oc=oc,
                                    compression=comp)
        grads, metrics = step.grads(params, batch)
        if comp == "int8":
            rep["local_grads"] = [g.cpu().numpy()
                                  for g in lm.tree_leaves(grads)]
        synced = step.sync(grads)
        if comp == "int8" and env.rank == 0:
            rep["int8_synced"] = [g.cpu().numpy()
                                  for g in lm.tree_leaves(synced)]
        if comp == "none":
            synced_none = list(lm.tree_leaves(synced))
        m = step.update(params, state, synced, metrics)
        rep[f"{comp}_loss"] = float(m["loss"])
        after[comp] = [p.detach() for p in lm.tree_leaves(params)]
        del params, state, grads, synced
    rep["digest"] = hashlib.sha256(b"".join(
        p.cpu().numpy().tobytes()
        for p in after["none"] + synced_none)).hexdigest()
    rep["int8_vs_none_max_abs"] = max(float((a - b).abs().max()) for a, b
                                      in zip(after["int8"], after["none"]))
    if env.rank == 0:
        params = lm.init(cfg, 0, device="cuda")
        state = opt.init(oc, params)
        for p in lm.tree_leaves(params):
            p.requires_grad_(True)
        grads, sm = T.grad_step(params, cfg, batch)
        # every leaf: the largest |synced - single-card| over tol_grad x
        # the leaf's largest single-card |g|
        rep["none_grad_share"] = max(
            float((a - b).abs().max() / (CMPI["tol_grad"] * b.abs().max()))
            for a, b in zip(synced_none, lm.tree_leaves(grads)))
        T.update_step(params, oc, state, grads)
        rep["single_loss"] = sm["loss"].item()
        rep["none_vs_single_max_abs"] = max(
            float((a - b.detach()).abs().max()) for a, b in
            zip(after["none"], lm.tree_leaves(params)))
        del params, state, grads
    del after, synced_none
    env.comm.barrier()

    # (c) the vocab-parallel functions on data 2 x model 2
    rep["vp"] = _cmpi_vp(env)
    torch.cuda.empty_cache()

    # (d) bf16 compute at 4096 tokens a rank
    cfg = get_config(CMPI["arch"])
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=CMPI["seq"],
                                global_batch=CMPI["rows"] * n)
    ds = D.SyntheticLM(D.for_model(cfg, shape, 0))
    oc = opt.for_model(cfg)
    params = lm.init(cfg, 0, device="cuda")
    state = opt.init(oc, params)
    step = make_cmpi_train_step(cfg, shape, dist, oc=oc)
    torch.cuda.reset_peak_memory_stats()
    splits, losses = [], []
    _zero_cmpi_counts()
    for i in range(CMPI["steps"] + 1):            # step 0 warms up
        t = {"t0": time.perf_counter()}
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in ds.batch(i).items()}
        torch.cuda.synchronize()
        t["gen"] = time.perf_counter()
        c0, b0 = _cmpi_counts(), stats.copied_bytes
        grads, metrics = step.grads(params, batch)
        torch.cuda.synchronize()
        t["fwd_bwd"] = time.perf_counter()
        b1 = stats.copied_bytes
        grads = step.sync(grads)
        torch.cuda.synchronize()
        t["sync_grads"] = time.perf_counter()
        b2 = stats.copied_bytes
        m = step.update(params, state, grads, metrics)
        torch.cuda.synchronize()
        t["opt"] = time.perf_counter()
        c1, b3 = _cmpi_counts(), stats.copied_bytes
        keys = list(t)
        split = {f"{k}_s": t[k] - t[p] for p, k in zip(keys, keys[1:])}
        split.update(pool_bytes_fwd_bwd=b1 - b0, pool_bytes_sync=b2 - b1,
                     pool_bytes_opt=b3 - b2,
                     launches={k: c1[k] - c0[k] for k in c1})
        splits.append(split)
        losses.append(float(m["loss"]))
    rep["d"] = {"losses": losses, "steps": splits[1:],
                "peak_GB": torch.cuda.max_memory_allocated() / 1e9}
    rep["launches"] = _cmpi_counts()
    rep["attn_layers"] = prefill_launches(cfg)["flash_attention"]
    rep["seconds"] = time.perf_counter() - t_all
    rep["schedules"] = compiled_schedules()
    return rep


def emulate_psum_int8_sync(local: list, n_pod: int, n_data: int) -> tuple:
    """The JAX package's ``sync_grads`` with ``psum_int8`` in one
    process, from every rank's local gradient leaves (rank r = pod
    r // n_data, data r % n_data): per leaf, block d of the f32 padded
    flat gradient summed over a pod's data ranks, each pod's shard
    int8-encoded with its own scale, the int32 sum of the pods' q
    rescaled by their largest scale, the blocks concatenated and divided
    by the dp size. Returns (leaves, per leaf the largest scale, one
    quantum of the result)."""
    import torch

    from repro_torch.distributed import compression as C
    out, quanta = [], []
    for i in range(len(local[0])):
        g = [torch.from_numpy(rk[i]).cuda().float().reshape(-1)
             for rk in local]
        pad = (-g[0].numel()) % n_data
        blocks = [torch.cat([x, x.new_zeros(pad)]).reshape(n_data, -1)
                  for x in g]
        res, smaxes = [], []
        for d in range(n_data):
            q, s = zip(*(C.int8_encode(sum(
                blocks[p * n_data + e][d] for e in range(n_data)))
                for p in range(n_pod)))
            smax = torch.stack(s).amax(0)
            res.append(sum(x.to(torch.int32) for x in q).float() * smax)
            smaxes.append(float(smax.max()))
        full = torch.cat(res)[:g[0].numel()].reshape(local[0][i].shape)
        out.append((full / (n_pod * n_data)).cpu().numpy())
        quanta.append(max(smaxes) / (n_pod * n_data))
    return out, quanta


def check_cmpi(ranks: list[dict], cmpi_s: float) -> dict:
    """Hold phase 6's reports to its gates; returns its summary."""
    import numpy as np
    launches = [r["launches"] for r in ranks]
    say(f"[cmpi] {len(ranks)} ranks on {ranks[0]['device']}: "
        f"{cmpi_s:.1f} s, launches per rank {launches}")
    if min(x["cellcopy"] for x in launches) <= 0:
        fail(f"cmpi: a rank never launched cellcopy: {launches}")
    if [r["dp_index"] for r in ranks] != list(range(len(ranks))):
        fail(f"cmpi: dp order {[r['coords'] for r in ranks]}")
    r0 = ranks[0]
    # (a)
    if len({r["digest"] for r in ranks}) != 1:
        fail("cmpi (a): the ranks' params differ after the step")
    if not r0["none_grad_share"] <= 1:
        fail(f"cmpi (a): synced gradients {r0['none_grad_share']:.3g} x "
             f"{CMPI['tol_grad']} x max|g| from the single-card ones")
    if not r0["none_vs_single_max_abs"] <= CMPI["tol_none"]:
        fail(f"cmpi (a): params {r0['none_vs_single_max_abs']:.3g} from "
             f"the single-card step (bound {CMPI['tol_none']})")
    # (b)
    n_pod, n_data = CMPI["mesh"]
    want, quanta = emulate_psum_int8_sync(
        [r["local_grads"] for r in ranks], n_pod, n_data)
    diffs = [float(np.abs(a - b).max()) for a, b in
             zip(r0["int8_synced"], want)]
    over = [(i, d, q) for i, (d, q) in enumerate(zip(diffs, quanta))
            if d > q]
    mism = sum(int((a != b).sum()) for a, b in zip(r0["int8_synced"],
                                                    want))
    if over:
        fail(f"cmpi (b): int8 sync against the emulated psum_int8: "
             f"(leaf, max abs diff, one quantum) {over[:3]}")
    # (c)
    vp = {k: max(r["vp"][k] for r in ranks) for k in ranks[0]["vp"]}
    v = CMPI["vp"]
    if not (vp["e_embed"] < v["tol_embed"] and vp["e_ce"] < v["tol_ce"]
            and vp["argmax_mismatches"] == 0
            and vp["e_grad_x"] < v["tol_grad"]
            and vp["e_grad_table_slice"] < v["tol_grad"]
            and not vp["table_grad_outside_slice"]):
        fail(f"cmpi (c): vocab-parallel against dense: {vp}")
    # (d)
    steps = [s for r in ranks for s in r["d"]["steps"]]
    n_tok = CMPI["seq"] * CMPI["rows"] * len(ranks)
    # a step ends when its slowest rank does
    step_s = [max(sum(r["d"]["steps"][i][f"{k}_s"]
                      for k in ("fwd_bwd", "sync_grads", "opt"))
                  for r in ranks) for i in range(CMPI["steps"])]
    if not all(np.isfinite(r["d"]["losses"]).all() for r in ranks):
        fail(f"cmpi (d): losses {[r['d']['losses'] for r in ranks]}")
    mean = {k: float(np.mean([s[k] for s in steps])) for k in (
        "gen_s", "fwd_bwd_s", "sync_grads_s", "opt_s", "pool_bytes_sync",
        "pool_bytes_fwd_bwd", "pool_bytes_opt")}
    out = {
        "a": {"grad_share_of_bound": r0["none_grad_share"],
              "grad_bound": f"{CMPI['tol_grad']} x max|g| a leaf",
              "none_vs_single_max_abs": r0["none_vs_single_max_abs"],
              "bound": CMPI["tol_none"], "loss": r0["none_loss"],
              "single_card_loss": r0["single_loss"],
              "ranks_bitwise_equal": True},
        "b": {"int8_vs_emulation_max_abs": max(diffs),
              "elements_differing": mism,
              "largest_quantum": max(quanta),
              "int8_vs_none_params_max_abs": r0["int8_vs_none_max_abs"],
              "loss": r0["int8_loss"]},
        "c": vp,
        "d": {"tokens_per_step": n_tok, "step_s": step_s,
              "tokens_per_s": n_tok / float(np.median(step_s)),
              "tokens_per_s_with_batch_gen": n_tok / float(np.median(
                  [s + mean["gen_s"] for s in step_s])),
              "mean_split": mean,
              "sync_share": mean["sync_grads_s"] / (
                  mean["fwd_bwd_s"] + mean["sync_grads_s"] + mean["opt_s"]),
              "cellcopy_launches_per_rank_step": [
                  r["d"]["steps"][-1]["launches"]["cellcopy"]
                  for r in ranks],
              "flash_launches_per_rank_step": [
                  r["d"]["steps"][-1]["launches"]["flash_attention"]
                  for r in ranks],
              "peak_GB_per_process": [r["d"]["peak_GB"] for r in ranks],
              "losses": [r["d"]["losses"] for r in ranks]},
        "launches": {k: sum(x[k] for x in launches)
                     for k in launches[0]},
        "launches_per_rank": launches, "phase_s": cmpi_s}
    if min(out["d"]["cellcopy_launches_per_rank_step"]) <= 0:
        fail("cmpi (d): a rank's step launched no cellcopy")
    per_step = {(r["rank"], s["launches"]["flash_attention"])
                for r in ranks for s in r["d"]["steps"]}
    if {f for _, f in per_step} != {r0["attn_layers"]}:
        fail(f"cmpi (d): flash launches per rank step {sorted(per_step)}, "
             f"want one per attention layer ({r0['attn_layers']})")
    if any(x["flash_attention"] != r0["attn_layers"] * (CMPI["steps"] + 1)
           for x in launches):
        fail(f"cmpi (d): flash launches {launches} over "
             f"{CMPI['steps'] + 1} steps of {r0['attn_layers']} layers")
    return out


# ---------------------------------------------------------------------------
# phase 7: the step functions (train/steps.py)
# ---------------------------------------------------------------------------

def _leaf_shares(got, want, tol: float) -> float:
    """The largest ``_grad_share`` over two trees' leaves."""
    from repro_torch.models import lm
    return max(_grad_share(a, b, tol) for a, b in zip(
        lm.tree_leaves(got), lm.tree_leaves(want)))


def steps_ga_phase() -> dict:
    """(a) ``make_train_step`` on one card (``dist=None``), smollm-135m at
    its published config: f32 parity of ga 4 against ga 1 at 4 x 256;
    bf16 at 8 x 4096 with ``pick_grad_accum``'s 4 microbatches (peak,
    tokens/s, flash launches a step); one step of train_4k's 256 x 4096
    (ga 128). The counts go to 0 just before the bf16 steps and are read
    just after the full step."""
    import dataclasses

    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.cellcopy import ops as cc
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import lm
    from repro_torch.train import data as D
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as ST
    g = STEPS_GA
    res: dict = {}

    def batch_of(cfg, shape, i=0):
        return {k: torch.from_numpy(v).cuda() for k, v in D.SyntheticLM(
            D.for_model(cfg, shape, 0)).batch(i).items()}

    # parity in f32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(g["arch"]), compute_dtype="float32")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=g["parity_seq"],
                                global_batch=g["parity_rows"])
    batch = batch_of(cfg, shape)
    out, after = {}, {}
    for ga in (g["parity_ga"], 1):
        step = ST.make_train_step(cfg, shape, None, grad_accum=ga)
        params = lm.init(cfg, 0, device="cuda")
        out[ga] = step.grads(params, batch)
        state = opt.init(opt.for_model(cfg), params)
        step.fn(params, state, batch)
        after[ga] = params
    (g_ga, m_ga), (g_1, m_1) = out[g["parity_ga"]], out[1]
    loss_rel = abs(float(m_ga["loss"]) - float(m_1["loss"])) / abs(
        float(m_1["loss"]))
    share = _leaf_shares(g_ga, g_1, g["grad_tol"])
    p_diff = max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(
        lm.tree_leaves(after[g["parity_ga"]]), lm.tree_leaves(after[1])))
    res["parity"] = {"rows": g["parity_rows"], "seq": g["parity_seq"],
                     "ga": g["parity_ga"], "loss_rel": loss_rel,
                     "loss_rtol": g["loss_rtol"], "grad_share": share,
                     "grad_bound": f"{g['grad_tol']} x max|g| a leaf",
                     "params_max_abs": p_diff,
                     "params_tol": g["params_tol"]}
    if not (loss_rel <= g["loss_rtol"] and share <= 1
            and p_diff <= g["params_tol"]):
        fail(f"steps (a): ga {g['parity_ga']} against ga 1: "
             f"{res['parity']}")
    del out, after, g_ga, g_1, params, state
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.cuda.empty_cache()

    # bf16 at 8 x 4096, then train_4k's whole batch
    cfg = get_config(g["arch"])
    params = lm.init(cfg, 0, device="cuda")
    state = opt.init(opt.for_model(cfg), params)
    layers = prefill_launches(cfg)["flash_attention"]
    shape = dataclasses.replace(SHAPES["train_4k"],
                                global_batch=g["mem_rows"])
    step = ST.make_train_step(cfg, shape, None)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = cc.LAUNCHES = 0
    times, losses = [], []
    for i in range(g["mem_steps"] + 1):           # step 0 warms up
        batch = batch_of(cfg, shape, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step.fn(params, state, batch)
        times.append(_sync_s(t0))
        losses.append(float(m["loss"]))
    mem_launches = fa.LAUNCHES
    res["mem"] = {"rows": g["mem_rows"], "seq": shape.seq_len,
                  "ga": step.grad_accum, "step_s": times[1:],
                  "tokens_per_s": g["mem_rows"] * shape.seq_len
                  / min(times[1:]), "losses": losses,
                  "flash_launches_per_step": mem_launches
                  // (g["mem_steps"] + 1),
                  "peak_GB": torch.cuda.max_memory_allocated() / 1e9}
    want = layers * step.grad_accum
    if step.grad_accum != 4 or mem_launches != want * (g["mem_steps"] + 1):
        fail(f"steps (a): ga {step.grad_accum}, flash launches "
             f"{mem_launches}, want {want} a step (one a layer and "
             "microbatch)")
    if not all(map(math.isfinite, losses)) or not res["mem"]["peak_GB"] < 80:
        fail(f"steps (a): 8 x 4096: {res['mem']}")
    # phase 8 (a): one more 8 x 4096 step, untimed, under the dry run's
    # counter (its launches are not the path's)
    res["counted"] = count_on_card(step.fn, params, state, batch_of(
        cfg, shape, g["mem_steps"] + 1))

    shape = SHAPES["train_4k"]
    step = ST.make_train_step(cfg, shape, None)
    t0 = time.perf_counter()
    batch = batch_of(cfg, shape, g["mem_steps"] + 1)
    gen_s = _sync_s(t0)
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    _, _, m = step.fn(params, state, batch)
    full_s = _sync_s(t0)
    res["full"] = {"rows": shape.global_batch, "seq": shape.seq_len,
                   "ga": step.grad_accum, "batch_gen_s": gen_s,
                   "step_s": full_s,
                   "tokens_per_s": shape.global_batch * shape.seq_len
                   / full_s, "loss": float(m["loss"]),
                   "flash_launches": fa.LAUNCHES,
                   "peak_GB": torch.cuda.max_memory_allocated() / 1e9}
    res["launches"] = {"flash_attention": mem_launches + fa.LAUNCHES,
                       "cellcopy": cc.LAUNCHES}
    if step.grad_accum != 128 or fa.LAUNCHES != layers * 128:
        fail(f"steps (a): train_4k: ga {step.grad_accum}, flash launches "
             f"{fa.LAUNCHES}")
    if not math.isfinite(res["full"]["loss"]) or \
            not res["full"]["peak_GB"] < 80:
        fail(f"steps (a): train_4k: {res['full']}")
    del params, state, batch
    torch.cuda.empty_cache()
    return res


def _ep_counts(zero: bool = False) -> dict:
    """This process's launch counts of the two kernels phase 7 (b) and
    (c) run; with ``zero``, set them to 0 (just before a main path)."""
    from repro_torch.kernels.cellcopy import ops as cc
    from repro_torch.kernels.flash_attention import ops as fa
    if zero:
        cc.LAUNCHES = fa.LAUNCHES = 0
    return {"cellcopy": cc.LAUNCHES, "flash_attention": fa.LAUNCHES}


def _ep_train(env, dist) -> dict:
    """(c) ``make_train_step`` under ``dist``: granite-moe cut to 2 layers,
    f32 (TF32 off), at ``check_cf``; the synced gradients, and on rank 0
    their shares of the bound against one process's step over the global
    batch in dp x ga microbatches (the blocks of rows the ranks took)."""
    import dataclasses
    import hashlib

    import torch

    from repro_torch.configs import SHAPES, get_config, optimized
    from repro_torch.models import lm
    from repro_torch.train import data as D
    from repro_torch.train import steps as ST
    cfg = optimized(get_config(EP["arch"]))
    cfg = dataclasses.replace(
        cfg, n_layers=EP["train_layers"], compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=EP["check_cf"]))
    shape = dataclasses.replace(
        SHAPES["train_4k"], seq_len=EP["train_seq"],
        global_batch=EP["train_rows"] * dist.dp_size)
    batch = {k: torch.from_numpy(v).cuda() for k, v in D.SyntheticLM(
        D.for_model(cfg, shape, 0)).batch(0).items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    params = lm.init(cfg, 0, device="cuda")
    step = ST.make_train_step(cfg, shape, dist)
    _ep_counts(zero=True)
    grads, metrics = step.grads(params, batch)
    rep = {"ga": step.grad_accum, "loss": float(metrics["loss"]),
           "aux": float(metrics["aux"]), "launches": _ep_counts(),
           "attn_layers": prefill_launches(cfg)["flash_attention"],
           "digest": hashlib.sha256(b"".join(
               g.cpu().numpy().tobytes()
               for g in lm.tree_leaves(grads))).hexdigest()}
    if env.rank == 0:
        # each of its microbatches one (dp rank, microbatch) block
        one = ST.make_train_step(cfg, shape, None, grad_accum=dist.dp_size
                                 * step.grad_accum)
        want, wm = one.grads(lm.init(cfg, 0, device="cuda"), batch)
        rep["grad_share"] = _leaf_shares(grads, want, EP["grad_tol"])
        rep["single_loss"] = float(wm["loss"])
        del want
    del params, grads
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.cuda.empty_cache()
    return rep


def ep_path(env) -> dict:
    """Phase 7's rank program (4 ranks, data 2 x model 2): (c) the train
    step under the dist; then (b) expert-parallel serving of granite-moe
    at full width: each rank's f32 check against the dense dispatch at
    ``check_cf``, then ``make_serve_prefill`` of ``rows`` x ``prompt`` and
    ``decode`` steps of ``make_serve_decode`` (bf16, the published
    capacity factor), each timed, with the pool bytes the rank copies
    and its launches (counts to 0 just before the timed prefill, read
    after it and after the decode steps; the f32 check, the warm-up and
    (c) are outside that window, and (c) counts its own step alike)."""
    import dataclasses

    import torch

    from repro_torch.configs import InputShape, get_config, optimized
    from repro_torch.distributed.context import DistContext
    from repro_torch.distributed.sharding import shard_experts
    from repro_torch.models import lm
    from repro_torch.train import steps as ST
    stats = env.arena.view.stats
    t_all = time.perf_counter()
    dist = DistContext(env.comm, EP["mesh"], EP["axes"])
    rep = {"rank": env.rank, "coords": dist.coords,
           "dp_index": dist.dp_index, "train": _ep_train(env, dist)}
    env.comm.barrier()

    cfg = optimized(get_config(EP["arch"]))
    b, s = EP["rows"], EP["prompt"]
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g).cuda()
    params = lm.init(cfg, 0, device="cuda")
    # the f32 check at check_cf: one process's dense dispatch on the
    # rank's row against the ep prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dataclasses.replace(cfg, compute_dtype="float32", moe=dataclasses
                              .replace(cfg.moe, capacity_factor=EP[
                                  "check_cf"]))
    row = dist.shard_batch({"tokens": toks})
    with torch.no_grad():
        dense = lm.prefill(params, f32, row)
    params = shard_experts(params, cfg, dist)
    torch.cuda.empty_cache()
    rep["param_GB"] = sum(t.numel() * t.element_size()
                          for t in lm.tree_leaves(params)) / 1e9
    pre = ST.make_serve_prefill(f32, InputShape("p", "prefill", s, b), dist)
    ep32 = pre.fn(params, {"tokens": toks})
    rep["f32_share"] = float((ep32 - dense).abs().max()) / (
        EP["logit_tol"] * float(dense.abs().max()))
    torch.backends.cuda.matmul.allow_tf32 = True
    del dense, ep32

    # the main path: bf16, the published capacity factor
    pre = ST.make_serve_prefill(cfg, InputShape("p", "prefill", s, b), dist)
    dec = ST.make_serve_decode(cfg, InputShape("d", "decode",
                                               s + EP["decode"], b), dist)
    state = lm.decode_state_init(cfg, b // dist.dp_size, s + EP["decode"],
                                 device="cuda")
    pre.fn(params, {"tokens": toks})                       # warm
    torch.cuda.reset_peak_memory_stats()
    b0, c0 = stats.copied_bytes, _ep_counts(zero=True)
    t0 = time.perf_counter()
    logits = pre.fn(params, {"tokens": toks})
    rep["prefill_s"] = _sync_s(t0)
    b1, c1 = stats.copied_bytes, _ep_counts()
    tok = logits.argmax(-1).int()
    tok = dist.comms["data"].allgather(tok)
    tokens = []
    t0 = time.perf_counter()
    for i in range(EP["decode"]):
        pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
        local, state = dec.fn(params, state, {"tokens": tok[:, None]}, pos)
        tokens.append(local.cpu())
        tok = dist.comms["data"].allgather(local)
    rep["decode_s"] = _sync_s(t0)
    b2, c2 = stats.copied_bytes, _ep_counts()
    rep.update({
        "logits": logits.float().cpu().numpy(),
        "tokens": torch.stack(tokens).numpy(),
        "token_mode": local.dtype == torch.int32,
        "pool_bytes_prefill": b1 - b0, "pool_bytes_decode": b2 - b1,
        "launches_prefill": {k: c1[k] - c0[k] for k in c1},
        "launches_decode": {k: c2[k] - c1[k] for k in c1},
        "launches": c2,
        "moe_layers": cfg.n_layers,
        "attn_layers": prefill_launches(cfg)["flash_attention"],
        "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
        "seconds": time.perf_counter() - t_all})
    return rep


def check_ep(ranks: list[dict], ep_s: float) -> dict:
    """Hold phase 7 (b) and (c)'s reports to their gates; returns their
    summary."""
    import numpy as np
    say(f"[ep] {len(ranks)} ranks: {ep_s:.1f} s, launches per rank "
        f"{[r['launches'] for r in ranks]}")
    if [r["dp_index"] for r in ranks] != [0, 0, 1, 1]:
        fail(f"ep: mesh order {[r['coords'] for r in ranks]}")
    # (c)
    tr = [r["train"] for r in ranks]
    if len({t["digest"] for t in tr}) != 1:
        fail("ep (c): the ranks' synced gradients differ")
    if not tr[0]["grad_share"] <= 1:
        fail(f"ep (c): synced gradients {tr[0]['grad_share']:.3g} x "
             f"{EP['grad_tol']} x max|g| from one process's")
    for t in tr:
        lc = t["launches"]
        if lc["cellcopy"] <= 0 or \
                lc["flash_attention"] != t["attn_layers"] * t["ga"]:
            fail(f"ep (c): a rank's step launched {lc}; want a cellcopy "
                 f"or more and one flash a layer ({t['attn_layers']}) "
                 f"and microbatch ({t['ga']})")
    # (b)
    for a, b in (ranks[0], ranks[1]), (ranks[2], ranks[3]):
        if not (np.array_equal(a["logits"], b["logits"])
                and np.array_equal(a["tokens"], b["tokens"])):
            fail("ep (b): the model ranks of a dp row differ")
    share = max(r["f32_share"] for r in ranks)
    if not share <= 1:
        fail(f"ep (b): f32 ep prefill {share:.3g} x {EP['logit_tol']} x "
             "max|logit| from the dense dispatch")
    for r in ranks:
        lp, ld = r["launches_prefill"], r["launches_decode"]
        if lp["flash_attention"] != r["attn_layers"] \
                or lp["cellcopy"] < r["moe_layers"] \
                or ld["cellcopy"] < r["moe_layers"] * EP["decode"]:
            fail(f"ep (b): rank {r['rank']} launched {lp} in the prefill "
                 f"and {ld} in {EP['decode']} decode steps; want one "
                 f"flash a layer ({r['attn_layers']}) and a cellcopy or "
                 f"more a MoE layer ({r['moe_layers']}) and step")
        if not r["token_mode"]:
            fail("ep (b): decode returned logits, not greedy tokens")
    n_tok = EP["rows"] * EP["decode"]
    return {
        "b": {"arch": EP["arch"], "flags": "configs.optimized",
              "mesh": dict(zip(EP["axes"], EP["mesh"])),
              "prefill": f"{EP['rows']} x {EP['prompt']}",
              "prefill_s": max(r["prefill_s"] for r in ranks),
              "decode_steps": EP["decode"],
              "decode_tokens_per_s": n_tok / max(r["decode_s"]
                                                 for r in ranks),
              "f32_share_of_bound": share,
              "f32_bound": f"{EP['logit_tol']} x max|logit| at capacity "
                           f"factor {EP['check_cf']}",
              "pool_bytes_prefill_per_rank": [r["pool_bytes_prefill"]
                                              for r in ranks],
              "pool_bytes_decode_per_rank": [r["pool_bytes_decode"]
                                             for r in ranks],
              "launches_prefill_per_rank": [r["launches_prefill"]
                                            for r in ranks],
              "launches_decode_per_rank": [r["launches_decode"]
                                           for r in ranks],
              "param_GB_per_rank": [r["param_GB"] for r in ranks],
              "peak_GB_per_process": [r["peak_GB"] for r in ranks],
              "ranks_of_a_row_bitwise_equal": True},
        "c": {"layers": EP["train_layers"],
              "batch": f"{EP['train_rows']} x {EP['train_seq']} a dp rank",
              "grad_share_of_bound": tr[0]["grad_share"],
              "grad_bound": f"{EP['grad_tol']} x max|g| a leaf",
              "loss": tr[0]["loss"], "single_loss": tr[0]["single_loss"],
              "launches_per_rank": [t["launches"] for t in tr],
              "ranks_bitwise_equal": True},
        # each from its own window: (b)'s timed prefill and decode, (c)'s
        # step; the f32 check and the references are outside both
        "launches_serve": {k: sum(r["launches"][k] for r in ranks)
                           for k in ranks[0]["launches"]},
        "launches_train": {k: sum(t["launches"][k] for t in tr)
                           for k in tr[0]["launches"]},
        "phase_s": ep_s,
        "reduced": [f"(b) capacity factor {EP['check_cf']} for the f32 "
                    "check only", f"(c) depth 24 -> "
                    f"{EP['train_layers']} layers, capacity factor "
                    f"{EP['check_cf']}"]}


def _ptxas_kernels(log: str) -> dict:
    """{mangled name: {"registers", "spill_stores", "spill_loads"}} of
    every entry function in nvcc's ``-Xptxas -v`` output."""
    out: dict = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


def _hgmma_counts(lib) -> dict | None:
    """{mangled name: HGMMA instructions} of each kernel in the library's
    SASS, or None where the toolkit has no ``cuobjdump``."""
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass failed: {sass.stderr.strip()}")
    counts: dict = {}
    name = None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


def flash_build_report(build) -> dict:
    """Registers, spills, threads and dynamic shared memory of each flash
    kernel instance (the library's plan, held to ``ops.launch_plan``), and
    its HGMMA (wgmma) instructions; fails if an instance has none."""
    build.load()
    ptxas = _ptxas_kernels(build.BUILD_LOG.get("log", ""))
    hgmma = _hgmma_counts(build.lib_path())
    report = {}
    for kind, dt in (("bf16", "bfloat16"), ("f32", "float32")):
        for d in (32, 64, 128):
            key = f"flash_fwd_{kind}<{d}>"
            mangled = f"flash_fwd_{kind}ILi{d}E"
            plan = _flash_plan(1, 32, 8, LONG_PROMPT, d, True, dt)
            info = {"threads": plan["threads"],
                    "smem_bytes": plan["smem_bytes"],
                    "block_q": plan["block_q"], "block_k": plan["block_k"]}
            for name, props in ptxas.items():
                if mangled in name:
                    info.update(props)
            if hgmma is not None:
                info["hgmma"] = sum(n for name, n in hgmma.items()
                                    if mangled in name)
                if not info["hgmma"]:
                    fail(f"{key}: no HGMMA instruction in its SASS")
            report[key] = info
            say(f"[build] {key}: {json.dumps(info)}")
    if hgmma is None:
        say("[build] cuobjdump not found: HGMMA count not taken")
    if not ptxas:
        say("[build] cached build: no ptxas report")
    return report


def sm_clock_max_hz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), to
    turn a time into cycles; the clock under load may be lower."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def kernel_build_report(build) -> dict:
    """Registers and spills (ptxas) of the ``cellcopy`` kernel and of
    each ``wkv6`` and ``selective_scan`` instance, the CTA's shared
    memory, and the cluster size at the data plane's shapes; fails if the
    static shared memory of a ``cellcopy`` CTA is not what
    ``ops.smem_bytes`` states."""
    import ctypes

    import torch

    from repro_torch.kernels.cellcopy import ops as cc
    from repro_torch.kernels.rwkv6 import ops as wk
    from repro_torch.kernels.selective_scan import ops as ss
    lib = build.load()
    ptxas = _ptxas_kernels(build.BUILD_LOG.get("log", ""))

    def props(mangled: str) -> dict:
        return next((p for name, p in ptxas.items() if mangled in name), {})

    out = (ctypes.c_longlong * 4)()
    clusters = {}
    for what, n in (("eager cell", CELL - 16), ("1 MiB", MiB),
                    ("8 B", 8)):
        if lib.cellcopy_plan(n, CELL, out):
            fail("cellcopy_plan failed")
        clusters[what] = {"CTAs": out[0], "cluster": out[1]}
    info = {**props("cellcopy_kernel"), "threads": out[2],
            "static_smem_bytes": out[3],
            "ops.smem_bytes": cc.smem_bytes(8, 4096),
            "cluster_by_shape": clusters}
    if out[3] != cc.smem_bytes(8, 4096):
        fail(f"cellcopy: a CTA claims {out[3]} B of shared memory, "
             f"ops.smem_bytes says {cc.smem_bytes(8, 4096)}")
    report = {"cellcopy_kernel": info}
    say(f"[build] cellcopy_kernel: {json.dumps(info)}")
    for dt, mangled in ((torch.bfloat16, "13__nv_bfloat16"),
                        (torch.float32, "f")):
        for n in wk.HEAD_SIZES:
            key = f"wkv6_fwd<{str(dt)[6:]},{n}>"
            plan = wk.launch_plan(1, 40, LONG_PROMPT, n, dt)
            info = {**props(f"wkv6_fwdI{mangled}Li{n}E"),
                    "threads": plan["threads"],
                    "dynamic_smem_bytes": plan["smem_bytes"],
                    "CTAs_at_B1_H40": plan["grid"][0] * plan["grid"][1]}
            report[key] = info
            say(f"[build] {key}: {json.dumps(info)}")
            report.update(_wkv6_bwd_build(lib, props, dt, mangled, n))
    for n in ss.STATE_SIZES:
        key = f"selective_scan_kernel<{n}>"
        plan = ss.launch_plan(SCAN_TIMED[0], SCAN_TIMED[2], n)
        info = {**props(f"selective_scan_kernelILi{n}E"),
                "threads": plan["threads"],
                "dynamic_smem_bytes": plan["smem_bytes"],
                "channels_per_CTA": plan["channels"],
                "CTAs_at_d_in_8192": plan["grid"][0]}
        report[key] = info
        say(f"[build] {key}: {json.dumps(info)}")
    return report


def _wkv6_bwd_build(lib, props, dt, mangled: str, n: int) -> dict:
    """Registers and spills of ``wkv6_bwd``'s four kernels for (dt, n),
    with each one's threads, dynamic shared memory, cluster size and, at
    rwkv6-3b's launch (``WKV6_LAUNCH``), CTAs and warps a scheduler
    (``wkv6_bwd_occupancy``: the runtime's count from registers, shared
    memory and threads); fails if a kernel fits no CTA on an SM."""
    import ctypes

    from repro_torch.kernels.rwkv6 import ops as wk
    plan = wk.bwd_launch_plan(1, 40, WKV6_LAUNCH[2], n, dt)
    occ = (ctypes.c_int * 3)()
    if lib.wkv6_bwd_occupancy(wk.DTYPES[dt], n, occ):
        fail(f"wkv6_bwd_occupancy {dt} n={n} failed")
    if not all(occ):
        fail(f"wkv6_bwd {dt} n={n}: a kernel fits no CTA on an SM "
             f"({list(occ)})")
    tname = str(dt)[6:]
    kernels = {
        "wkv6_bwd_local": (f"I{mangled}Li{n}E", plan["threads"],
                           plan["local_smem_bytes"], 1, occ[0]),
        "wkv6_bwd_carry": (f"ILi{n}E", plan["carry_threads"], 0, 1, occ[1]),
        "wkv6_bwd_chunk": (f"I{mangled}Li{n}E", plan["threads"],
                           plan["smem_bytes"], plan["cluster"], occ[2]),
        "wkv6_bwd_du": (f"ILi{n}E", n, 0, 1, None)}
    report = {}
    for kern, (suffix, threads, smem, cluster, ctas) in kernels.items():
        key = f"{kern}<{tname},{n}>"
        info = {**props(f"{kern}{suffix}"), "threads": threads,
                "dynamic_smem_bytes": smem, "cluster": cluster}
        if ctas is not None:
            info.update(CTAs_per_SM=ctas,
                        warps_per_scheduler=ctas * -(-threads // 32) / 4)
        if kern == "wkv6_bwd_chunk":
            info.update(CTAs_at_B1_H40_S4096=plan["grid"][0] * 40,
                        CTAs_per_SM_by_smem=plan["ctas_per_sm_by_smem"],
                        workspace_bytes_at_B1_H40_S4096=plan[
                            "workspace_bytes"])
        report[key] = info
        say(f"[build] {key}: {json.dumps(info)}")
    return report


# ---------------------------------------------------------------------------
# phase 8: the host tools against the card
# ---------------------------------------------------------------------------

def roofline_phase(models: dict, steps_ga: dict, card: str) -> dict:
    """(a) Each step's dry-run count on the meta device (``count_cell``,
    one card, no mesh) against its count on the card (``counted``, taken
    in phases 4 and 7 (a)): FLOPs and bytes within ``COUNT_RTOL``, the
    charged launches equal to the launches on the card and to the
    phase's own count a step. Returns each step's counts, roofline terms
    and measured share of the roofline."""
    import dataclasses

    from repro_torch.analysis import hlo
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    llama = models[ROOFLINE["arch"]]
    train_shape = dataclasses.replace(SHAPES["train_4k"],
                                      global_batch=STEPS_GA["mem_rows"])
    cells = {
        f"{STEPS_GA['arch']} train_step {STEPS_GA['mem_rows']}x4096 ga 4": (
            get_config(STEPS_GA["arch"]), train_shape, 4,
            steps_ga["counted"], min(steps_ga["mem"]["step_s"]),
            {"flash_attention": steps_ga["mem"]["flash_launches_per_step"]}),
        f"{ROOFLINE['arch']} prefill 1x{LONG_PROMPT}": (
            get_config(ROOFLINE["arch"]), roofline_shape("prefill"), None,
            llama["counted"]["prefill"], llama["prefill"][
                f"1x{LONG_PROMPT}_s"], llama["launches_per_prefill"]),
        f"{ROOFLINE['arch']} decode step batch "
        f"{ROOFLINE['decode_batch']}": (
            get_config(ROOFLINE["arch"]), roofline_shape("decode"), None,
            llama["counted"]["decode"],
            llama["decode_profile"]["step_ms"] / 1e3, {})}
    out = {}
    for name, (cfg, shape, ga, on_card, measured_s, per_step) in \
            cells.items():
        t0 = time.perf_counter()
        st, _ = dryrun.count_cell(cfg, shape, None, grad_accum=ga)
        meta_s = time.perf_counter() - t0
        rel = {k: abs(on_card[k] - m) / m for k, m in
               (("flops", st.flops), ("bytes", st.bytes_))}
        charged = {k: v["launches"] for k, v in st.kernels.items()}
        want = {k: n for k, n in per_step.items() if n}
        if max(rel.values()) > COUNT_RTOL:
            fail(f"counts (a) {name}: meta and card differ by {rel}")
        if not (charged == on_card["kernels"] == on_card["launched"]
                == want):
            fail(f"counts (a) {name}: charged launches {charged} on meta, "
                 f"{on_card['kernels']} on the card, launched "
                 f"{on_card['launched']}, the phase's count a step {want}")
        roof = hlo.Roofline(st.flops, st.bytes_, st.total_wire_bytes,
                            hlo.model_flops(cfg, shape, 1))
        share = roof.model_flops_per_device / hlo.PEAK_FLOPS / measured_s
        out[name] = {"flops": st.flops, "bytes": st.bytes_,
                     "rel_diff_card": rel, "charged_launches": charged,
                     "roofline": roof.as_dict(), "measured_s": measured_s,
                     "measured_share": share, "meta_count_s": meta_s,
                     "card": card}
        say(f"[counts] {name}: {st.flops:.6g} FLOPs, {st.bytes_:.6g} B "
            f"(card within {max(rel.values()):.2g}); compute "
            f"{roof.compute_s * 1e3:.4g} ms, memory "
            f"{roof.memory_s * 1e3:.4g} ms, collective "
            f"{roof.collective_s * 1e3:.4g} ms (H100: {hlo.PEAK_FLOPS:.4g} "
            f"FLOP/s, {hlo.HBM_BW:.4g} B/s, {hlo.LINK_BW:.4g} B/s); "
            f"measured {measured_s * 1e3:.4g} ms, share of the roofline "
            f"{share:.4g} ({card}); charged launches {charged}")
    return out


def trace_phase() -> dict:
    """(c) Phase 3's one-way run once more at 1 MiB a path, 2 ranks under
    ``trace=True``; ``python -m repro_torch.trace merge`` of their dumps
    in a subprocess must give two process lanes with events on each."""
    from repro_torch.core import run_processes
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ranks = run_processes(2, trace_path, pool_bytes=POOL_BYTES,
                          cell_size=CELL, device="cuda",
                          comm_kw={"matchbox_slots": 8, "trace": True},
                          timeout=300)
    if not all(r["bytes_ok"] for r in ranks):
        fail("counts (c): a traced 1 MiB message arrived different")
    dumps = [r["dump"] for r in sorted(ranks, key=lambda r: r["rank"])]
    timeline = TRACE_DIR / "timeline.json"
    env = dict(os.environ, PYTHONPATH=str(SRC))

    def cli(*args) -> str:
        r = subprocess.run([sys.executable, "-m", "repro_torch.trace",
                            *args], capture_output=True, text=True,
                           timeout=300, env=env)
        if r.returncode != 0:
            fail(f"counts (c): python -m repro_torch.trace {args[0]} "
                 f"exited {r.returncode}: {r.stderr[-2000:]}")
        return r.stdout
    say(f"[counts] {cli('merge', *dumps, '-o', str(timeline)).strip()}")
    evs = json.loads(timeline.read_text())["traceEvents"]
    lanes = {pid: sum(1 for e in evs if e["pid"] == pid and e["ph"] != "M")
             for pid in {e["pid"] for e in evs}}
    if sorted(lanes) != [0, 1] or not all(lanes.values()):
        fail(f"counts (c): the timeline's process lanes and events {lanes}")
    summary = cli("summarize", *dumps, "--top", "10")
    say("[counts] trace summary, top 10:\n" + summary.rstrip())
    return {"lanes": lanes, "events": len(evs),
            "seconds": time.perf_counter() - t0}


def static_phase(schedules: set) -> dict:
    """(d) ``compile_schedule(verify=True)`` for every schedule phases 3
    and 6 compiled, and the protocol linter over ``repro_torch/core``."""
    from repro_torch.analysis import lint_protocol, verify
    from repro_torch.core.sched import compile_schedule
    t0 = time.perf_counter()
    for size, kind, nbytes, itemsize, root, group, chunk in sorted(
            schedules, key=repr):
        try:
            compile_schedule(verify._CompileView(size, 0), kind, nbytes,
                             itemsize, root, group=group, chunk_bytes=chunk,
                             verify=True)
        except Exception as e:      # a finding, or a compiler that fails
            fail(f"counts (d): {kind} at {size} ranks, {nbytes} B: {e}")
    findings = lint_protocol.lint_paths([lint_protocol._default_target()])
    if findings:
        fail("counts (d): lint_protocol: " + "; ".join(map(str, findings)))
    out = {"schedules_verified": len(schedules),
           "kinds": sorted({s[1] for s in schedules}),
           "lint_findings": 0, "seconds": time.perf_counter() - t0}
    say(f"[counts] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 9: the examples
# ---------------------------------------------------------------------------

def _launch_counts(zero: bool = False) -> dict:
    """This process's launch counts of the port's kernels; with
    ``zero``, set them to 0 (just before a main path)."""
    from repro_torch.kernels.cellcopy import ops
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv6 import ops as wk
    if zero:
        ops.LAUNCHES = fa.LAUNCHES = wk.LAUNCHES = wk.BWD_LAUNCHES = 0
    return {"cellcopy": ops.LAUNCHES, "flash_attention": fa.LAUNCHES,
            "wkv6": wk.LAUNCHES, "wkv6_bwd": wk.BWD_LAUNCHES}


def run_example(name: str, argv: list) -> tuple:
    """``examples_torch/<name>.py``'s ``main(argv)`` on the card, its
    launch counts in this process set to 0 just before and read just
    after: returns (what it returned, the counts, seconds). An example
    that raises fails the run."""
    import importlib
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    mod = importlib.import_module(f"examples_torch.{name}")
    _launch_counts(zero=True)
    t0 = time.perf_counter()
    try:
        out = mod.main(argv)
    except Exception:  # noqa: BLE001 — reported as the run's failure
        import traceback
        fail(f"example {name} {' '.join(argv)}:\n{traceback.format_exc()}")
    return out, _launch_counts(), time.perf_counter() - t0


def _rank_launches(name: str, launches: list, control: tuple = ()) -> None:
    """Every rank but the ``control`` ones launched ``cellcopy``; those
    launched none."""
    if any(launches[r] for r in control) or min(
            n for r, n in enumerate(launches) if r not in control) <= 0:
        fail(f"example {name}: cellcopy launches per rank {launches} (a "
             f"data rank launched none, or a control rank {control} some)")


def tour_ring_bytes(tour) -> int:
    """The bytes ``comm_v2_tour``'s ring allreduce copies on the
    rendezvous paths, summed over its ranks: each of its ``N`` ranks
    sends 2 (N - 1) chunks of ``VEC / N`` float64, each counted once, on
    whichever side copied it (the sender into the receiver's posted
    buffer, or into a staging object). One rank's share varies from run
    to run; the sum does not, and is the JAX package's
    (``tests/test_torch_examples.py``)."""
    return 2 * (tour.N - 1) * tour.VEC * 8


def examples_phase() -> dict:
    """Phase 9: every script of ``examples_torch/`` through its
    ``main([...])`` on the card, at the JAX package's examples'
    defaults but for ``EXAMPLES``' cuts. Each multi-process example's
    ranks report their own ``cellcopy`` launches (every rank > 0; the
    serving tier's router, a control rank, 0), and the parent launches
    nothing meanwhile; each example's own checks hold (it raises
    otherwise), and so do these: the ping-pong's messages byte-exact in
    all four columns, the tour's ring allreduce copying
    ``tour_ring_bytes`` over its ranks (the copy count of CUDA payloads
    per path), the notified-put consumers copying 0 bytes, the serving
    tier finishing its sessions with exact checksums, the served tokens
    in the vocabulary, and quickstart launching ``flash_attention`` and
    resuming at its trained step. Before quickstart, the flash kernel at
    its attention shape (heads of 8, run padded on the D = 32 instance)
    against the plain version, bf16 and f32, within phase 2's
    tolerances. Returns each example's figures and counts."""
    import numpy as np

    from repro_torch.configs import get_config
    res: dict = {}

    out, counts, secs = run_example("scaling_study", [])
    if sum(counts.values()) or sorted(out) != ["CG", "miniAMR"]:
        fail(f"example scaling_study: {sorted(out)}, launches {counts}")
    res["scaling_study"] = {"s": secs, "launches": counts}

    ranks = {}
    for name in ("comm_v2_tour", "rma_tour", "cmpi_pingpong"):
        out, counts, secs = run_example(name, [])
        if sum(counts.values()):
            fail(f"the parent launched kernels during example {name}: "
                 f"{counts}")
        ranks[name] = out["ranks"]
        launches = [r["launches"] for r in out["ranks"]]
        _rank_launches(name, launches)
        res[name] = {"s": secs, "launches_per_rank": launches}
        if name == "cmpi_pingpong":
            if not all(out["exact"].values()):
                fail(f"example cmpi_pingpong: {out['exact']}")
            res[name]["us"] = out["us"]

    copied = sum(v for r in ranks["comm_v2_tour"] for k, v in
                 r["allreduce_paths"].items() if k.startswith("rndv_"))
    want = tour_ring_bytes(sys.modules["examples_torch.comm_v2_tour"])
    if copied != want:
        fail(f"example comm_v2_tour: the ring allreduce's rendezvous "
             f"chunks copied {copied} B over the ranks, not {want}")
    res["comm_v2_tour"].update(
        allreduce_rndv_copied=copied,
        allreduce_copied=[r["allreduce_copied"]
                          for r in ranks["comm_v2_tour"]],
        thresholds=[r["threshold"] for r in ranks["comm_v2_tour"]])
    consumers = [r["recv_copies"] for r in ranks["rma_tour"]
                 if "recv_copies" in r]
    if len(consumers) != 2 or any(consumers):
        fail(f"example rma_tour: consumers copied {consumers} B")
    res["rma_tour"]["paths"] = [r["paths"] for r in ranks["rma_tour"]]

    out, counts, secs = run_example("serve_decode", [])
    toks = np.asarray(out["tokens"])
    vocab = get_config("smollm-135m").reduced().vocab_size
    if toks.shape != (4, 24) or toks.min() < 0 or toks.max() >= vocab:
        fail(f"example serve_decode: tokens {toks.shape} "
             f"[{toks.min()}, {toks.max()}]")
    res["serve_decode"] = {"s": secs, "launches": counts,
                           "decode_tok_per_s": out["decode_tok_per_s"]}

    out, counts, secs = run_example("serve_decode", EXAMPLES["serve_ranks"])
    _rank_launches("serve_decode --ranks 3", out["launches_by_rank"],
                   control=(0,))
    if out["sessions"] != 24 or out["bad_checksums"] \
            or out["stats_tokens"] != out["tokens"]:
        fail(f"example serve_decode --ranks 3: {out['sessions']} sessions, "
             f"{out['bad_checksums']} bad checksums, stats_tokens "
             f"{out['stats_tokens']} of {out['tokens']}")
    res["serve_decode_ranks"] = {
        "s": secs, "launches_per_rank": out["launches_by_rank"],
        **{k: out[k] for k in ("sessions", "tokens", "qps", "p50_us",
                               "p99_us")}}

    # quickstart's attention shape (the reduced config's heads of 8, on
    # the kernel's D = 32 instance, padded) against the plain version
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    cfg = get_config("smollm-135m").reduced()
    shape = (8, cfg.n_heads, cfg.n_kv_heads, 64, cfg.d_head)
    fcheck = FloatCheck("flash_attention")
    g = torch.Generator(device="cuda").manual_seed(23)
    tf32 = torch.backends.cuda.matmul.allow_tf32     # phase 7 sets it
    torch.backends.cuda.matmul.allow_tf32 = False    # an f32 plain version
    try:
        for dt, tol, l2 in (("bfloat16", 3e-2, FLASH_L2),
                            ("float32", 1e-5, None)):
            q, k, v = _flash_inputs(*shape, dt, g)
            fcheck.close(f"quickstart {shape} {dt}",
                         fa.flash_attention(q, k, v),
                         fa_ref.attention_ref(q, k, v), tol, l2=l2, kind=dt)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out, counts, secs = run_example("quickstart", EXAMPLES["quickstart"])
    if counts["flash_attention"] <= 0:
        fail(f"example quickstart launched no flash_attention: {counts}")
    hist = np.asarray(out["history"])
    if len(hist) != 100 or not np.isfinite(hist).all() \
            or hist[-10:].mean() >= hist[:10].mean():
        fail(f"example quickstart: losses {hist[:3]} ... {hist[-3:]}")
    res["quickstart"] = {
        "s": secs, "launches": counts, "tokens_per_s": out["tokens_per_s"],
        "flash_check": {"shape": shape, **fcheck.by_kind},
        "first_loss": float(hist[0]), "final_loss": out["final_loss"],
        "restart": out["restart"]}
    return res


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def modeled_cxl_us(fwd: list[dict], iters: int) -> float:
    """``perfmodel.protocol_time`` on the paper's CXL box of both ranks'
    protocol counters of a one-way run, per message, in us."""
    from types import SimpleNamespace

    from repro_torch.perfmodel.interconnects import CXL_SHM, protocol_time
    stats = SimpleNamespace(**{k: sum(f["proto"][k] for f in fwd) / iters
                               for k in PROTO_KEYS})
    return protocol_time(stats, CXL_SHM) * 1e6


def check_main(ranks: list[dict], main_s: float) -> tuple:
    """Hold the ranks' reports of the main path to the run's limits;
    returns (launches per rank, latency table, launches per 1 MiB
    message by path)."""
    launches = [r["launches"] for r in ranks]
    say(f"[main] 2 ranks on {ranks[0]['device']}: {main_s:.1f} s, "
        f"cellcopy launches per rank {launches}")
    if min(launches) <= 0:
        fail(f"a rank never launched the kernel: {launches}")
    budget = json.loads(BUDGET.read_text())
    tol = budget["tolerance"]
    lat: dict = {}
    per_msg_launches: dict = {}
    for path in PATHS:
        for size in SIZES:
            key = f"{path}:{size}"
            fwd = [r["p2p"][key]["fwd"] for r in ranks]
            back = [r["p2p"][key]["back"] for r in ranks]
            if not (fwd[1]["bytes_ok"] and back[0]["bytes_ok"]):
                fail(f"{key}: bytes differ after the round trip")
            snd = fwd[0]
            iters = iters_for(size)
            want = {"eager": (iters, 0, 0), "staged": (0, iters, 0),
                    "posted": (0, iters, iters)}[path]
            if (snd["eager"], snd["rndv"], snd["posted"]) != want:
                fail(f"{key}: took the wrong path {snd}")
            lat.setdefault(path, {})[size] = {
                "us": snd["s"] * 1e6, "MBps": size / snd["s"] / 1e6}
            if size == MiB:
                copied = (fwd[0]["copied"] + fwd[1]["copied"]) / iters
                ref_b = budget["copied_bytes_per_message"][
                    BUDGET_KEYS[path]]
                say(f"[main] {path} @1MiB: {copied:.1f} copied B/msg "
                    f"(budget {ref_b}, tolerance {tol})")
                if abs(copied - ref_b) > tol * ref_b:
                    fail(f"{path}: copied bytes {copied} outside "
                         f"{tol} of {ref_b}")
                per_msg_launches[path] = (
                    fwd[0]["launches"] + fwd[1]["launches"]) / iters
                lat[path][size]["modeled_cxl_us"] = modeled_cxl_us(
                    fwd, iters)
                say(f"[perfmodel] {path} @1MiB: protocol_time on the "
                    f"paper's CXL box (CXL_SHM, clflushopt, modeled) "
                    f"{lat[path][size]['modeled_cxl_us']:.1f} us/msg, "
                    f"measured on the card's mapped pool "
                    f"{snd['s'] * 1e6:.1f} us/msg")
    say(f"[main] all {len(PATHS) * len(SIZES)} path x size cases "
        f"byte-exact both ways")
    reg = [r["p2p"]["registered"] for r in ranks]
    if not (reg[1]["fwd"]["bytes_ok"] and reg[0]["back"]["bytes_ok"]):
        fail("registered CUDA receive: bytes differ")
    if reg[0]["fwd"]["posted"] != 3:
        fail(f"registered CUDA receive missed its posting {reg[0]}")
    if not all(r["self_send_ok"] for r in ranks):
        fail("self-send of a CUDA tensor came back different")
    say("[main] registered CUDA receives posted 3/3 and byte-exact; "
        "CUDA self-send stays on the card")
    for size in HOST_SIZES:
        fwd = [r["p2p"][f"eager-host:{size}"]["fwd"] for r in ranks]
        if not fwd[1]["bytes_ok"]:
            fail(f"eager host payload of {size} B: bytes differ")
        if fwd[0]["launches"] or fwd[1]["launches"]:
            fail("a host payload went through the kernel")
        lat.setdefault("eager-host", {})[size] = {
            "us": fwd[0]["s"] * 1e6,
            "MBps": size / fwd[0]["s"] / 1e6}
    if not all(r["allreduce_ok"] for r in ranks):
        fail("8 MiB allreduce differs from the sum on the card")
    direct = [r["allreduce_direct_bytes"] for r in ranks]
    if direct != [ALLREDUCE_BYTES] * len(ranks):
        fail(f"8 MiB allreduce: {direct} B read by the direct sum")
    say("[main] allreduce of 8 MiB float32 equals the sum on the card "
        "(the direct sum on every rank)")
    hits = sum(r["persistent"]["hits"] for r in ranks)
    rndv = sum(r["persistent"]["rndv"] for r in ranks)
    rate = hits / max(rndv, 1)
    if not all(r["persistent"]["ok"] for r in ranks) or rndv == 0 \
            or rate != 1.0:
        fail(f"persistent allreduce: {hits}/{rndv} posted hits")
    say(f"[main] persistent allreduce: {hits}/{rndv} rendezvous sends "
        f"hit a pre-posted entry (rate {rate:.2f})")
    say(f"[main] cellcopy launches per 1 MiB message (both ranks): "
        f"{json.dumps(per_msg_launches)}")
    return launches, lat, per_msg_launches


def _children() -> list[int]:
    """This process's children, read from /proc."""
    me, kids = str(os.getpid()), []
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            stat = Path(f"/proc/{d}/stat").read_text()
        except OSError:                  # exited meanwhile
            continue
        if stat[stat.rfind(")") + 2:].split()[1] == me:
            kids.append(int(d))
    return kids


def stop_children() -> None:
    """Leave no process running: end the ranks ``run_processes`` may have
    left, then the multiprocessing resource tracker that its shared
    memory started (EOF on its pipe ends it; it ignores SIGTERM), and
    wait for each, so that none outlives the script."""
    import multiprocessing as mp
    from multiprocessing import resource_tracker
    for p in mp.active_children():
        p.kill()
        p.join(10)
    tracker = resource_tracker._resource_tracker
    if tracker._fd is not None:
        os.close(tracker._fd)
        tracker._fd = tracker._pid = None
    deadline = time.monotonic() + 10
    while (kids := _children()) and time.monotonic() < deadline:
        for pid in kids:
            _reap(pid, os.WNOHANG)
        time.sleep(0.05)
    for pid in _children():
        print(f"chip_smoke: killing leftover process {pid}",
              file=sys.stderr, flush=True)
        os.kill(pid, signal.SIGKILL)
        _reap(pid, 0)


def _reap(pid: int, flags: int) -> int:
    """waitpid that treats a child already reaped as gone."""
    try:
        return os.waitpid(pid, flags)[0]
    except ChildProcessError:
        return pid


def main() -> None:
    # phase 5's restart runs under torch.use_deterministic_algorithms,
    # whose cuBLAS needs this set before the first CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (SRC / "repro_torch" / "csrc" / "cellcopy.cu").is_file() \
            or not BUDGET.is_file():
        fail(f"not a checkout of the repository: {SRC} has no port")
    sys.path.insert(0, str(SRC))
    from repro_torch.core import SharedMemoryPool, run_processes
    from repro_torch.kernels import build
    from repro_torch.kernels.cellcopy import ops
    t_start = time.perf_counter()
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    build.load()
    say(f"[build] {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.BUILD_LOG.get('seconds', 0.0):.2f} s)")
    say(build.BUILD_LOG.get("log", ""))
    flash_build = flash_build_report(build)
    kernel_build = kernel_build_report(build)

    # 2. kernels against their plain versions
    check = Check()
    fcheck, wcheck = FloatCheck("flash_attention"), FloatCheck("wkv6")
    pool = SharedMemoryPool(64 * MiB, device="cuda")
    try:
        t0 = time.perf_counter()
        kernel_phase(pool, check)
        say(f"[kernel] cellcopy: {check.cases} comparisons bit-exact, "
            f"{check.mismatches} mismatches, corrupted cell caught "
            f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        model_kernel_phase(fcheck, wcheck)
        for c in (fcheck, wcheck):
            say(f"[kernel] {c.name}: {c.cases} comparisons within "
                f"tolerance, {c.mismatches} mismatches, max abs err "
                f"{c.max_abs_err:.3g}, max rel err {c.max_rel_err:.3g}"
                + (f", max relative L2 err {c.max_l2_err:.3g} at "
                   f"{c.max_l2_case} (bf16, bound {FLASH_L2:.3g})"
                   if c is fcheck else ""))
        for kind, k in fcheck.by_kind.items():
            say(f"[kernel] flash_attention {kind}: {k['cases']} "
                f"comparisons, max abs err {k['max_abs_err']:.3g}, max rel "
                f"err {k['max_rel_err']:.3g}, largest share of the allclose "
                f"bound {k['bound_use']:.3g} at {k['worst_case']}")
        scheck = FloatCheck("selective_scan")
        scan_kernel_phase(scheck)
        say(f"[kernel] selective_scan: {scheck.cases} comparisons within "
            f"{SCAN_TOL} of the largest value, max abs err "
            f"{scheck.max_abs_err:.3g}, max rel err "
            f"{scheck.max_rel_err:.3g}")
        say(f"[kernel] model kernels {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        wkv6_bwd = wkv6_bwd_phase()
        bwd_split = wkv6_bwd_split()
        say(f"[kernel] wkv6_bwd: {json.dumps(wkv6_bwd)} "
            f"({time.perf_counter() - t0:.1f} s)")

        # 3. the message plane: counts to 0 just before, read just after
        ops.LAUNCHES = 0
        t0 = time.perf_counter()
        ranks = run_processes(2, main_path, pool_bytes=POOL_BYTES,
                              cell_size=CELL, device="cuda",
                              comm_kw={"matchbox_slots": 8}, timeout=900)
        main_s = time.perf_counter() - t0
        if ops.LAUNCHES:
            fail("the parent launched kernels during the main path")
        launches, lat, per_msg_launches = check_main(ranks, main_s)
        schedules = {tuple(s) for r in ranks for s in r["schedules"]}
        rows = timings(pool)
        rows.append(page_timing(pool))

        # 3b. one-sided windows: counts to 0 just before, read just after
        ops.LAUNCHES = 0
        t0 = time.perf_counter()
        wranks = run_processes(2, window_path, pool_bytes=POOL_BYTES,
                               cell_size=CELL, device="cuda", timeout=300)
        window_s = time.perf_counter() - t0
        if ops.LAUNCHES:
            fail("the parent launched kernels during the window phase")
        win_launches, one_sided = check_window(wranks, window_s)

        # 3c. the serving tier: counts to 0 just before, read just after
        ops.LAUNCHES = 0
        t0 = time.perf_counter()
        sranks = run_processes(SERVE_RANKS, serve_path,
                               pool_bytes=POOL_BYTES, cell_size=CELL,
                               device="cuda", timeout=300)
        serve_s = time.perf_counter() - t0
        if ops.LAUNCHES:
            fail("the parent launched kernels during the serve phase")
        serve_launches, serve_tier = check_serve(sranks, serve_s)
    finally:
        pool.close()
        pool.unlink()

    # 4. the model path, one model at a time
    models = {}
    for arch in MODELS:
        t0 = time.perf_counter()
        models[arch] = model_phase(arch)
        say(f"[model] {json.dumps(models[arch])} "
            f"({time.perf_counter() - t0:.1f} s)")

    # 5. training, each path's counts to 0 just before and read just
    # after it (in train_run and train_restart_phase)
    t0 = time.perf_counter()
    training = train_phase()
    say(f"[train] phase {time.perf_counter() - t0:.1f} s")

    # 6. cMPI data-parallel training: each rank's counts start at 0 in its
    # own process and are read at its end; the parent launches nothing
    torch.cuda.empty_cache()
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    cranks = run_processes(CMPI["ranks"], cmpi_path, pool_bytes=POOL_BYTES,
                           cell_size=CELL, device="cuda", timeout=900)
    cmpi_s = time.perf_counter() - t0
    if ops.LAUNCHES:
        fail("the parent launched kernels during the cmpi phase")
    cmpi = check_cmpi(cranks, cmpi_s)
    schedules |= {tuple(s) for r in cranks for s in r["schedules"]}
    del cranks
    say(f"[cmpi] {json.dumps(cmpi)}")

    # 7. the step functions: (a) on this card, its counts to 0 just
    # before its main path and read just after (in steps_ga_phase); (b)
    # and (c) in 4 processes, each rank's counts from 0 in its own
    # process; the parent launches nothing meanwhile
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    steps_ga = steps_ga_phase()
    steps_ga["mem"]["peak_GB_ga1_phase5"] = training[
        STEPS_GA["arch"]]["peak_GB"]
    say(f"[steps] {json.dumps(steps_ga)} ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    eranks = run_processes(EP["ranks"], ep_path, pool_bytes=POOL_BYTES,
                           cell_size=CELL, device="cuda", timeout=900)
    ep_s = time.perf_counter() - t0
    if ops.LAUNCHES:
        fail("the parent launched kernels during the ep phase")
    ep = check_ep(eranks, ep_s)
    del eranks
    say(f"[ep] {json.dumps(ep)}")

    # 8. the host tools against the card: (a) the dry run's counts, (c)
    # the trace CLI, (d) the verifier and the linter ((b) printed in 3)
    t0 = time.perf_counter()
    card = nvidia_smi()
    roofline = roofline_phase(models, steps_ga, card)
    traced = trace_phase()
    static = static_phase(schedules)
    say(f"[counts] phase {time.perf_counter() - t0:.1f} s")
    dry_launches: dict = {}
    for cell, r in roofline.items():
        for k, n in r["charged_launches"].items():
            dry_launches.setdefault(k, {})[cell] = n

    # 9. the examples, each path's counts to 0 just before and read just
    # after it (in run_example; the ranks' in their own processes)
    t0 = time.perf_counter()
    examples = examples_phase()
    say(f"[examples] phase {time.perf_counter() - t0:.1f} s")
    for name, ex in examples.items():
        say(f"[examples] {name}: {json.dumps(ex)}")
    pp = examples["cmpi_pingpong"]["us"]
    say("[examples] cmpi_pingpong us (two-sided, persistent, one-sided, "
        "TCP) by size: " + "; ".join(
            f"{s}: " + ", ".join(f"{pp[c][s]:.1f}" for c in (
                "two", "pers", "one", "tcp")) for s in pp["two"]))

    # 10. report
    for r in rows:
        say(f"[time] {json.dumps(r)}")
    flash_rows, wkv_rows = model_kernel_timings()
    bwd_row = wkv6_bwd_timing(bwd_split)
    scan_row = scan_timing()
    for r in flash_rows + wkv_rows + [bwd_row, scan_row]:
        say(f"[time] {json.dumps(r)}")
    head = rows[0]
    by_path = {"message_plane": sum(launches),
               "window": sum(win_launches), "serve": sum(serve_launches),
               "train_arena_checkpoint":
                   training["restart"]["arena"]["cellcopy_launches"],
               "cmpi_train": cmpi["launches"]["cellcopy"],
               "ep_serve": ep["launches_serve"]["cellcopy"],
               "dist_train_step": ep["launches_train"]["cellcopy"],
               **{f"example {k}": sum(examples[k]["launches_per_rank"])
                  for k in ("cmpi_pingpong", "comm_v2_tour", "rma_tour",
                            "serve_decode_ranks")}}
    entries = [{
        "name": "cellcopy", "route": "cuda",
        "source": "src/repro_torch/csrc/cellcopy.cu",
        "replaces": "src/repro/kernels/cellcopy/kernel.py:40",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "mismatches": check.mismatches,
        "max_abs_err": check.max_abs_err,
        "shape": head["shape"] + " 1 MiB, 16 KiB cells",
        "ms": head["ms"], "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": "bytes", "library_ms": head["library_ms"],
        "launches_per_1MiB_message": per_msg_launches,
        "dryrun_charged_launches": dry_launches.get("cellcopy", {}),
        "build": kernel_build["cellcopy_kernel"], "shapes": rows}]
    for name, src, replaces, c, rows_ in (
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:75", fcheck,
             flash_rows),
            ("wkv6", "wkv6.cu", "src/repro/kernels/rwkv6/kernel.py:78",
             wcheck, wkv_rows)):
        head = next(r for r in rows_    # bf16, long prompt, first model
                    if f" S={LONG_PROMPT} " in r["shape"]
                    and " bf16 " in r["shape"])
        by_model = {a: m["launches"][name] for a, m in models.items()
                    if m["launches"][name]}
        by_model.update({f"{a} (train)": training[a]["launches"][name]
                         for a in TRAIN if training[a]["launches"][name]})
        if name == "flash_attention":
            by_model[f"{CMPI['arch']} (cmpi, {CMPI['ranks']} ranks)"] = \
                cmpi["launches"][name]
            by_model[f"{STEPS_GA['arch']} (make_train_step, ga)"] = \
                steps_ga["launches"][name]
            by_model[f"{EP['arch']} (ep serve, {EP['ranks']} ranks)"] = \
                ep["launches_serve"][name]
            by_model[f"{EP['arch']} (dist train step, {EP['ranks']} "
                     "ranks)"] = ep["launches_train"][name]
            by_model["smollm-135m reduced (example quickstart)"] = \
                examples["quickstart"]["launches"][name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "launches": sum(by_model.values()),
            "launches_by_model": by_model,
            "mismatches": c.mismatches, "max_abs_err": c.max_abs_err,
            "max_rel_err": c.max_rel_err,
            **({"max_l2_err": c.max_l2_err, "by_dtype": c.by_kind}
               if c is fcheck else {}),
            "shape": head["shape"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shapes": rows_,
            "dryrun_charged_launches": dry_launches.get(name, {}),
            "build": flash_build if name == "flash_attention" else {
                k: v for k, v in kernel_build.items() if "wkv6_fwd" in k}})
    entries.append({
        "name": "wkv6_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:78",
        "launches": training["rwkv6-3b"]["launches"]["wkv6_bwd"],
        "launches_by_model": {"rwkv6-3b (train)": training[
            "rwkv6-3b"]["launches"]["wkv6_bwd"]},
        "mismatches": 0, "max_abs_err": wkv6_bwd["max_abs_err"],
        "max_share_of_tol": wkv6_bwd["max_share_of_tol"],
        "shape": bwd_row["shape"], "ms": bwd_row["ms"],
        "plain_ms": bwd_row["plain_ms"], "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"], "library_ms": None,
        "shapes": [bwd_row],
        "dryrun_charged_launches": dry_launches.get("wkv6_bwd", {}),
        "build": {k: v for k, v in kernel_build.items() if "bwd" in k}})
    entries.append({
        "name": "selective_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/selective_scan.cu",
        "replaces": "none: the JAX package's scan is jnp "
                    "(src/repro/models/blocks.py:555)",
        "launches": sum(m["launches"]["selective_scan"]
                        for m in models.values()),
        "launches_by_model": {a: m["launches"]["selective_scan"]
                              for a, m in models.items()
                              if m["launches"]["selective_scan"]},
        "mismatches": scheck.mismatches, "max_abs_err": scheck.max_abs_err,
        "max_rel_err": scheck.max_rel_err, "shape": scan_row["shape"],
        "ms": scan_row["ms"], "plain_ms": scan_row["plain_ms"],
        "bound_ms": scan_row["bound_ms"], "bound_by": scan_row["bound_by"],
        "library_ms": None, "shapes": [scan_row],
        "dryrun_charged_launches": dry_launches.get("selective_scan", {}),
        "build": {k: v for k, v in kernel_build.items()
                  if "selective_scan" in k}})
    say(json.dumps({"one_way_latency_bandwidth": lat}))
    say(json.dumps({"one_sided_latency_bandwidth": one_sided}))
    say(json.dumps({"serve_tier": serve_tier}))
    say(json.dumps({"serving": {a: {k: m[k] for k in (
        "reduced", "serve", "decode_profile", "prefill",
        "f32_prefill_vs_decode", "init_s", "param_GB")}
        for a, m in models.items()}}))
    say(json.dumps({"training": {k: training[k] for k in (
        "grad", "model_grad", *TRAIN, "restart")}}))
    say(json.dumps({"cmpi_training": cmpi}))
    say(json.dumps({"steps": {"grad_accum": steps_ga, "ep": ep}}))
    say(json.dumps({"counts": {"roofline": roofline, "trace": traced,
                               "static": static}}))
    say(json.dumps({"examples": examples}))
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": entries}))
    say(nvidia_smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_children()
