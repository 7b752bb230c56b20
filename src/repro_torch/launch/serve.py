"""Serving driver: batched prefill + decode with a KV/state cache.

The ``cpu-smoke`` preset serves a REDUCED config and ``full`` the
published one; both run on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --preset full --batch 4 --prompt-len 128 --gen 32

``--ranks N`` (N > 1) runs the distributed serve tier instead: one
router and N - 1 workers over one communicator on the card
(``repro_torch.serve``), ``--sessions`` open-loop Poisson arrivals at
``--rate`` per second; ``--arch`` is then not needed:

  PYTHONPATH=src python -m repro_torch.launch.serve --ranks 4 \\
      --sessions 2000 --rate 1500
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg, *, batch: int, prompt_len: int, gen: int,
                seed: int = 0, greedy: bool = True, quiet: bool = False,
                params=None, device="cuda") -> dict:
    """Prefill a batch of prompts, then decode ``gen`` tokens each.

    The prompts are the JAX package's (numpy ``default_rng(seed)``), and
    the prefill teacher-forces them through decode steps as it does. A
    cross-attention model attends over its context cache as
    ``decode_state_init`` leaves it (zeros), as the JAX package's does.
    ``params``: weights to serve (on ``device``); by default
    ``lm.init(cfg, seed)``. ``greedy=False`` samples from the softmax
    with a ``torch.Generator`` seeded with ``seed``, which gives other
    numbers than JAX's sampler."""
    device = lm.require_device(device)
    if params is None:
        params = lm.init(cfg, seed, device=device)
    rng = np.random.default_rng(seed)
    # every position below is < cache_len: decode_step does not read a
    # CUDA pos back to check it
    cache_len = prompt_len + gen
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch, prompt_len), dtype=np.int32)
    ).to(device)
    sampler = torch.Generator(device=device).manual_seed(seed)
    state = lm.decode_state_init(cfg, batch, cache_len, device=device)

    def step_batch(tok):
        """A frames model is fed each token's embedding row, cast to the
        compute dtype, as its frame (the JAX package's serve step)."""
        if cfg.frontend == "frames":
            rows = params["embed"][tok[:, 0].long()]
            return {"frames": rows.to(getattr(torch, cfg.compute_dtype))
                    [:, None, :]}
        return {"tokens": tok}

    t0 = time.perf_counter()
    logits = None
    for i in range(prompt_len):
        pos = torch.full((batch,), i, dtype=torch.int32, device=device)
        logits, state = lm.decode_step(params, cfg, state,
                                       step_batch(prompts[:, i:i + 1]), pos)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out_tokens = np.zeros((batch, gen), np.int32)
    t0 = time.perf_counter()
    for j in range(gen):
        if greedy:
            nxt = logits.argmax(dim=-1)
        else:
            nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                    generator=sampler)[:, 0]
        nxt = nxt.to(torch.int32)
        out_tokens[:, j] = nxt.cpu().numpy()
        pos = torch.full((batch,), prompt_len + j, dtype=torch.int32,
                         device=device)
        logits, state = lm.decode_step(params, cfg, state,
                                       step_batch(nxt[:, None]), pos)
    _sync(device)
    t_decode = time.perf_counter() - t0

    tput = batch * gen / max(t_decode, 1e-9)
    if not quiet:
        print(f"[serve] batch={batch} prefill {prompt_len} tok in "
              f"{t_prefill:.2f}s | decode {gen} tok in {t_decode:.2f}s "
              f"({tput:.1f} tok/s)")
    return {"tokens": out_tokens, "decode_tok_per_s": tput,
            "prefill_s": t_prefill, "decode_s": t_decode}


def serve_distributed(*, ranks: int = 3, sessions: int = 32,
                      rate: float = 400.0, seed: int = 0,
                      quiet: bool = False, device="cuda") -> dict:
    """Run the multi-rank serve tier (router + workers over one Comm,
    on the card unless ``device="cpu"``) and return the router's
    report, with every rank's ``cellcopy`` launches over its serve run
    (``launches_by_rank``, the router's first). Thin wrapper over
    ``repro_torch.serve.run_serve``."""
    from repro_torch.serve import ServeConfig, run_serve
    cfg = ServeConfig(sessions=sessions, rate=rate, seed=seed)
    reports = run_serve(cfg, ranks=ranks, device=device)
    router = dict(reports[0],
                  launches_by_rank=[r["launches"] for r in reports])
    if not quiet:
        print(f"[serve] {router['sessions']} sessions on {ranks} ranks "
              f"({ranks - 1} workers): qps {router['qps']:.1f}, "
              f"p50 {router['p50_us']:.0f} us, "
              f"p99 {router['p99_us']:.0f} us")
    return router


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--preset", default="cpu-smoke",
                    choices=["cpu-smoke", "full"])
    ap.add_argument("--ranks", type=int, default=0,
                    help="> 1: run the distributed serve tier instead "
                         "of the single-process driver")
    ap.add_argument("--sessions", type=int, default=32)
    ap.add_argument("--rate", type=float, default=400.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.ranks > 1:
        serve_distributed(ranks=args.ranks, sessions=args.sessions,
                          rate=args.rate, seed=args.seed)
        return
    if args.arch is None:
        ap.error("--arch is required for the single-process driver")
    cfg = get_config(args.arch)
    if args.preset == "cpu-smoke":
        cfg = cfg.reduced()
    serve_batch(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, seed=args.seed)


if __name__ == "__main__":
    main()
