"""Training driver (the JAX package's ``launch/train.py``).

The ``cpu-smoke`` preset trains a REDUCED config (real training,
synthetic Markov data, checkpoint/restart, straggler monitor) and
``full`` the published one; both run on the card unless the caller of
``run_training`` passes ``device="cpu"``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 60 --preset cpu-smoke
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --steps 30 --preset cpu-smoke

The parser is the JAX package's. As there, ``--preset full`` trains the
``train_4k`` shape as it is (256 x 4096 tokens in one step, which no
single card holds), ``grad_accum`` and ``n_shards`` are accepted and
``grad_accum`` is not used, and the JAX package's docstring names a
``--cmpi-sync`` flag its parser does not have (``ROADMAP.md`` Queue 3).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.models import lm
from repro_torch.train import data as D
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import FailureInjector, HeartbeatBoard


def grad_step(params, cfg, batch) -> tuple:
    """``loss_fn`` -> ``backward`` on ``params`` (whose leaves require
    grad): returns the gradient tree and the loss metrics (tensors). A
    leaf the loss does not reach (a frames model's embedding under an
    untied head) has a zero gradient, as ``jax.value_and_grad`` gives
    it."""
    loss, metrics = lm.loss_fn(params, cfg, batch)
    loss.backward()
    grads = lm.tree_unflatten(params, [
        torch.zeros_like(p) if p.grad is None else p.grad
        for p in lm.tree_leaves(params)])
    return grads, metrics


def update_step(params, oc: opt.OptConfig, opt_state, grads) -> dict:
    """``apply_updates`` in place on ``params`` and ``opt_state``, then
    the grads are cleared. Returns the optimizer's metrics (tensors)."""
    _, _, om = opt.apply_updates(oc, params, grads, opt_state)
    for p in lm.tree_leaves(params):
        p.grad = None
    return om


def train_step(params, cfg, oc: opt.OptConfig, opt_state, batch) -> dict:
    """One step: ``grad_step`` then ``update_step``. Returns the metrics
    (detached tensors)."""
    grads, metrics = grad_step(params, cfg, batch)
    om = update_step(params, oc, opt_state, grads)
    return {k: v.detach() for k, v in dict(metrics, **om).items()}


def run_training(cfg, shape: InputShape, steps: int, *,
                 ckpt_dir: str | Path | None = None,
                 ckpt_every: int = 20,
                 seed: int = 0,
                 injector: FailureInjector | None = None,
                 log_every: int = 10,
                 grad_accum: int = 1,
                 n_shards: int = 1,
                 quiet: bool = False,
                 device="cuda") -> dict:
    """Single-process training loop. Returns final metrics + loss
    history. Restartable via ckpt_dir. ``grad_accum`` is accepted and not
    used, as in the JAX package. An async checkpoint still being written
    when a step raises is finished before the error leaves."""
    device = lm.require_device(device)
    oc = opt.for_model(cfg)
    params = lm.init(cfg, seed, device=device)
    opt_state = opt.init(oc, params)
    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr is not None:
        got = mgr.restore((params, opt_state))
        if got[0] is not None:
            start_step, (params, opt_state) = got
            if not quiet:
                print(f"[train] resumed from step {start_step}")
    for p in lm.tree_leaves(params):
        p.requires_grad_(True)

    ds = D.SyntheticLM(D.for_model(cfg, shape, seed))
    board = HeartbeatBoard(n_shards)

    history = []
    t0 = time.perf_counter()
    try:
        for step in range(start_step, steps):
            if injector is not None:
                injector.check(step)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in ds.batch(step).items()}
            metrics = train_step(params, cfg, oc, opt_state, batch)
            loss = float(metrics["loss"])
            history.append(loss)
            board.beat(0, step)
            if mgr is not None and (step + 1) % ckpt_every == 0:
                mgr.save_async(step + 1, (params, opt_state))
            if not quiet and (step % log_every == 0 or step == steps - 1):
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"lr {float(metrics['lr']):.2e}")
        if mgr is not None:
            mgr.save(steps, (params, opt_state))
    finally:
        if mgr is not None:
            mgr.wait()
    dt = time.perf_counter() - t0
    tokens = (steps - start_step) * shape.global_batch * shape.seq_len
    return {
        "history": history,
        "final_loss": history[-1] if history else float("nan"),
        "tokens_per_s": tokens / max(dt, 1e-9),
        "params": params,
        "opt_state": opt_state,
        "health": board.health(),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--preset", default="cpu-smoke",
                    choices=["cpu-smoke", "full"])
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.preset == "cpu-smoke":
        cfg = cfg.reduced()
        shape = dataclasses.replace(shape, seq_len=args.seq_len,
                                    global_batch=args.global_batch)
    out = run_training(cfg, shape, args.steps, ckpt_dir=args.ckpt_dir,
                       seed=args.seed)
    uniform = float(np.log(cfg.vocab_size))
    print(f"[train] done: final loss {out['final_loss']:.4f} "
          f"(uniform {uniform:.2f}) | {out['tokens_per_s']:.0f} tok/s")


if __name__ == "__main__":
    main()
