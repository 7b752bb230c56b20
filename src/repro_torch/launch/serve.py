"""Serving driver: batched prefill + decode with a KV/state cache.

The ``cpu-smoke`` preset serves a REDUCED config and ``full`` the
published one; both run on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --preset full --batch 4 --prompt-len 128 --gen 32

The distributed serve tier (``--ranks``) needs the port of ``serve/``
and is not ported yet (``ROADMAP.md`` Queue 1).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.blocks import unported


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg, *, batch: int, prompt_len: int, gen: int,
                seed: int = 0, greedy: bool = True, quiet: bool = False,
                params=None, device="cuda") -> dict:
    """Prefill a batch of prompts, then decode ``gen`` tokens each.

    The prompts are the JAX package's (numpy ``default_rng(seed)``), and
    the prefill teacher-forces them through decode steps as it does.
    ``params``: weights to serve (on ``device``); by default
    ``lm.init(cfg, seed)``. ``greedy=False`` samples from the softmax
    with a ``torch.Generator`` seeded with ``seed``, which gives other
    numbers than JAX's sampler."""
    device = lm.require_device(device)
    if params is None:
        params = lm.init(cfg, seed, device=device)
    rng = np.random.default_rng(seed)
    cache_len = prompt_len + gen
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch, prompt_len), dtype=np.int32)
    ).to(device)
    sampler = torch.Generator(device=device).manual_seed(seed)
    state = lm.decode_state_init(cfg, batch, cache_len, device=device)

    t0 = time.perf_counter()
    logits = None
    for i in range(prompt_len):
        pos = torch.full((batch,), i, dtype=torch.int32, device=device)
        logits, state = lm.decode_step(params, cfg, state,
                                       {"tokens": prompts[:, i:i + 1]}, pos)
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
                                       {"tokens": nxt[:, None]}, pos)
    _sync(device)
    t_decode = time.perf_counter() - t0

    tput = batch * gen / max(t_decode, 1e-9)
    if not quiet:
        print(f"[serve] batch={batch} prefill {prompt_len} tok in "
              f"{t_prefill:.2f}s | decode {gen} tok in {t_decode:.2f}s "
              f"({tput:.1f} tok/s)")
    return {"tokens": out_tokens, "decode_tok_per_s": tput,
            "prefill_s": t_prefill, "decode_s": t_decode}


def serve_distributed(**kw) -> dict:
    raise unported("the distributed serve tier (serve_distributed, "
                   "--ranks)", "Queue 1, serve/")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--preset", default="cpu-smoke",
                    choices=["cpu-smoke", "full"])
    ap.add_argument("--ranks", type=int, default=0,
                    help="> 1: the distributed serve tier (not ported)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.ranks > 1:
        serve_distributed(ranks=args.ranks, seed=args.seed)
    cfg = get_config(args.arch)
    if args.preset == "cpu-smoke":
        cfg = cfg.reduced()
    serve_batch(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, seed=args.seed)


if __name__ == "__main__":
    main()
