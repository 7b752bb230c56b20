"""Serve-tier wiring: one router rank + N-1 workers over one Comm.

``serve_rank(env, cfg)`` is the per-rank program for the thread or
process runtimes: it builds the shared dynamic KV window, attaches this
rank's page shard, allgathers the page directory, broadcasts the
router's shared stats word, then runs the rank's role to completion.
``run_serve(cfg, ranks=...)`` wraps it in ``run_threads`` and returns
the per-rank reports (router report at index 0).

Zero-copy bookkeeping: every rank snapshots its ``ProtocolStats``
around the serve phase and attaches the delta to its report
(``stats_delta``), so callers can assert the data plane's contract —
page bytes appear ONLY under the origin-side ``rma_put``/``rma_get``
(and 8-byte ``raccumulate`` stats words in both), never under
``rndv_staged``, and a passive page home drains nothing. The report's
``launches`` are the rank's ``cellcopy`` launches over the same span
(its own thread's: the thread runtime's ranks share one process).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.runtime import run_threads
from repro_torch.kernels.cellcopy import ops
from repro_torch.serve import wire
from repro_torch.serve.pages import PageDirectory, PageStore
from repro_torch.serve.router import Router
from repro_torch.serve.worker import Worker


@dataclasses.dataclass
class ServeConfig:
    """Knobs for one serve run. Defaults are smoke-sized: a few dozen
    sessions, small pages, everything verified."""
    sessions: int = 32            # total Poisson arrivals (open loop)
    rate: float = 400.0           # arrivals per second
    seed: int = 0
    prompt_min: int = 8
    prompt_max: int = 24
    gen_min: int = 8
    gen_max: int = 24
    page_tokens: int = 16         # KV positions per page
    page_bytes: int = 4096
    slots_per_worker: int = 64
    max_batch: int = 8            # continuous-batching width per worker
    admit_depth: int = 4          # persistent request ring depth
    stats_interval: int = 8       # steps between raccumulate + BEAT
    decode_us: float = 0.0        # synthetic per-step compute
    verify_every: int = 1         # router recomputes 1-in-k checksums
    worker_timeout: float = 0.0   # >0: fail-stop heartbeat window (s)
    deadline_s: float = 60.0      # hard abort for CI hangs
    fail_rank: int = -1           # fault injection: this worker...
    fail_after_steps: int = -1    # ...aborts after this many steps

    @property
    def max_pages(self) -> int:
        return wire.pages_for(self.prompt_max, self.gen_max,
                              self.page_tokens)

    def pool_bytes_needed(self, ranks: int) -> int:
        """Pages + round buffers + queue matrix headroom per run."""
        pages = ranks * self.slots_per_worker * (self.page_bytes + 4096)
        return pages + (8 << 20)


def serve_rank(env, cfg: ServeConfig) -> dict:
    """The per-rank serve program (router on rank 0)."""
    comm = env.comm
    if comm.size < 2:
        raise ValueError("serving needs at least 2 ranks "
                         "(1 router + 1 worker)")
    win = comm.win_create_dynamic(
        "kv", attach_slots=cfg.slots_per_worker + 2)
    store = PageStore(comm, win, cfg.slots_per_worker, cfg.page_bytes)
    directory = PageDirectory(comm, store)
    # the router's shared stats word: workers raccumulate token deltas
    if comm.rank == 0:
        stats_buf = comm.alloc_buffer(8)
        stats_buf.write(b"\x00" * 8)
        stats_addr = win.attach(stats_buf)
        comm.bcast(np.asarray([stats_addr], dtype=np.int64))
    else:
        stats_buf = None
        stats_addr = int(comm.bcast(None)[0])
    before = comm.arena.view.stats.snapshot()
    launched = ops.thread_launches()
    if comm.rank == 0:
        report = Router(comm, cfg, directory, win).run()
    else:
        report = Worker(comm, cfg, store, directory, win,
                        stats_addr=stats_addr).run()
    comm.barrier()                # all traffic quiesced before teardown
    report["stats_delta"] = comm.arena.view.stats.delta(before)
    report["launches"] = ops.thread_launches() - launched
    if comm.rank == 0:
        report["stats_tokens"] = int(np.frombuffer(
            stats_buf.read(), dtype=np.int64)[0])
        win.detach(stats_addr)
        stats_buf.free()
    comm.barrier()                # no rget may race the detach below
    store.free()
    win.free()
    return report


def run_serve(cfg: ServeConfig, ranks: int = 3, *,
              timeout: float | None = None,
              device: str = "cuda") -> list[dict]:
    """Drive a full serve run under the thread runtime; returns the
    per-rank reports (router first). Runs on the card (every rank's
    comm on one GPU, the pool pinned and mapped into it) unless
    ``device="cpu"``; without a GPU that default raises."""
    return run_threads(
        ranks, lambda env: serve_rank(env, cfg),
        pool_bytes=cfg.pool_bytes_needed(ranks),
        timeout=timeout if timeout is not None else cfg.deadline_s + 30.0,
        device=device)
