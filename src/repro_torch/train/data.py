"""Deterministic synthetic LM data pipeline (numpy only: the JAX
package's ``train/data.py`` as it is, so that ``SyntheticLM.batch`` gives
the same bytes in both packages; the per-token ``rng.choice`` loop of
``_gen_tokens`` defines the stream and stays).

Documents are generated from a seeded order-2 Markov chain over the vocab
(so there IS learnable structure — the integration test asserts loss drops
well below uniform entropy), tokenized into fixed-length sequences with
next-token labels. Batches are addressed by (step, shard) so any rank can
materialize exactly its shard without coordination — the data-parallel
contract a real cluster loader needs (and what makes elastic restarts
reproducible: the schedule is a pure function of the step).

A background prefetch thread keeps ``depth`` batches ready.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64          # markov states (<= vocab)
    frontend: str = "tokens"    # tokens | frames
    d_model: int = 0            # for frames
    n_ctx_tokens: int = 0       # cross-attn context stub


class SyntheticLM:
    """Markov-chain token stream; batch(step, shard, n_shards) is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        s = min(cfg.n_states, cfg.vocab_size)
        # sparse-ish row-stochastic transition matrix with strong modes
        logits = rng.normal(size=(s, s)) * 2.0
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        self.trans = p / p.sum(axis=1, keepdims=True)
        self.s = s

    def _gen_tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n, np.int64)
        x = int(rng.integers(self.s))
        for i in range(n):
            x = int(rng.choice(self.s, p=self.trans[x]))
            out[i] = x
        return out % self.cfg.vocab_size

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0
        b = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            (cfg.seed, step, shard, n_shards))
        toks = np.stack([self._gen_tokens(rng, cfg.seq_len + 1)
                         for _ in range(b)])
        batch = {"labels": toks[:, 1:].astype(np.int32)}
        if cfg.frontend == "frames":
            emb_rng = np.random.default_rng((cfg.seed, 7))
            table = emb_rng.normal(size=(cfg.vocab_size, cfg.d_model)) \
                .astype(np.float32) * 0.1
            batch["frames"] = table[toks[:, :-1]]
        else:
            batch["tokens"] = toks[:, :-1].astype(np.int32)
        if cfg.n_ctx_tokens:
            batch["ctx"] = rng.normal(
                size=(b, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)
        return batch


class Prefetcher:
    """Background thread keeping `depth` batches ready."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0, *,
                 shard: int = 0, n_shards: int = 1, depth: int = 2):
        self.ds = ds
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._shard = shard
        self._n_shards = n_shards
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            b = self.ds.batch(step, self._shard, self._n_shards)
            while not self._stop.is_set():
                try:
                    self.q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self.q.get(timeout=30)

    def stop(self):
        self._stop.set()


def for_model(model_cfg, shape, seed: int = 0) -> DataConfig:
    return DataConfig(
        vocab_size=model_cfg.vocab_size,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        seed=seed,
        frontend=model_cfg.frontend,
        d_model=model_cfg.d_model,
        n_ctx_tokens=model_cfg.n_ctx_tokens,
    )
