"""Fault tolerance for the training loop (the JAX package's
``train/fault.py`` as it is: it imports no framework).

Designed for thousands of nodes, exercised on CPU by simulation:

* step fencing       — checkpoints publish atomically (checkpoint.py);
                       restart resumes from LATEST and replays the data
                       schedule (a pure function of step), so an
                       interrupted run is BITWISE identical to an
                       uninterrupted one (tested).
* heartbeats         — every rank appends (step, wall_time) to a heartbeat
                       board; the monitor flags ranks whose last beat is
                       older than `deadline` (dead) or whose step lags the
                       median by > `lag_steps` (STRAGGLER).
* straggler policy   — 'warn' (log), 'skip' (continue without the
                       straggler's contribution — valid for DP replicas
                       when grads are averaged over contributing shards),
                       or 'restart' (fence + reload at last checkpoint).
* elastic re-mesh    — restore is layout-agnostic (full arrays per leaf),
                       so resuming on a different data-parallel width only
                       changes the batch sharding; tested by training on
                       n_shards=4, resuming on 2.
* failure injection  — FailureInjector raises at a chosen step to drive
                       the restart path in tests.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    fail_at_step: int | None = None
    fail_rank: int = 0
    fired: bool = False

    def check(self, step: int, rank: int = 0) -> None:
        if (not self.fired and self.fail_at_step is not None
                and step == self.fail_at_step and rank == self.fail_rank):
            self.fired = True
            raise InjectedFailure(f"injected failure at step {step}")


@dataclass
class Heartbeat:
    step: int
    t: float


@dataclass
class HeartbeatBoard:
    """In-memory stand-in for the heartbeat KV store (on a real cluster
    this is the coordination service; over cMPI it is an arena object that
    every rank writes at its own slot — single-writer, no atomics)."""
    n_ranks: int
    beats: dict[int, Heartbeat] = field(default_factory=dict)

    def beat(self, rank: int, step: int, t: float | None = None) -> None:
        self.beats[rank] = Heartbeat(step, time.monotonic() if t is None
                                     else t)

    def health(self, *, now: float | None = None, deadline: float = 10.0,
               lag_steps: int = 3) -> dict:
        now = time.monotonic() if now is None else now
        dead, stragglers = [], []
        steps = sorted(hb.step for hb in self.beats.values())
        median = steps[len(steps) // 2] if steps else 0
        for r in range(self.n_ranks):
            hb = self.beats.get(r)
            if hb is None or now - hb.t > deadline:
                dead.append(r)
            elif median - hb.step > lag_steps:
                stragglers.append(r)
        return {"dead": dead, "stragglers": stragglers, "median": median}


@dataclass
class ElasticPlan:
    """Decides the next world configuration after failures."""
    n_shards: int

    def after_failures(self, dead: list[int]) -> "ElasticPlan":
        healthy = self.n_shards - len(set(d % self.n_shards for d in dead))
        # keep a divisor-friendly width (batch divisibility)
        width = max(1, healthy)
        while self.n_shards % width:
            width -= 1
        return ElasticPlan(width)
