"""Event-driven MPI simulator (the paper's SimGrid role, §4.4).

Rank programs are generator coroutines yielding actions; the engine
advances virtual time:

    yield ("compute", seconds)
    yield ("send", dst, nbytes, tag)      # non-blocking injection
    yield ("recv", src, nbytes, tag)      # blocks until matching arrival
    yield ("sendrecv", peer, nbytes, tag) # symmetric exchange
    yield ("allreduce", nbytes)           # collective (ring model)
    yield ("barrier",)

Network model — the paper's SimGrid configuration: links carry the RAW
fabric alpha-beta from Table 1 (16 us Ethernet vs 18 us CX-6 TCP is exactly
why Ethernet wins miniAMR at <=8 nodes), plus a fabric-independent
per-message MPI software cost. Inter-node messages share the node's single
port (NIC / CXL link) with the other ranks on the node: effective bytes =
size * sharers, sharers ~= ppn * (1 - 1/nodes) — this is what makes the
117.8 MB/s Ethernet NIC the limiting factor at scale while latency rules
small scales (paper §4.4's stated mechanism). Intra-node messages ride main
memory. Collectives use the ring decomposition:
  allreduce(n ranks, s bytes) = 2(n-1) steps of (t_sw + alpha + shard/bw).

This is deliberately a THIN simulator — enough to reproduce the paper's
Fig 10 strong-scaling study (CG, miniAMR) with configured lat/bw, not a
general platform simulator.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

from repro_torch.perfmodel.interconnects import Interconnect, MAIN_MEMORY


@dataclass
class Proc:
    rank: int
    gen: Iterator
    time: float = 0.0
    blocked: Any = None          # ("recv", src, nbytes, tag) | barrier token


class Engine:
    def __init__(self, n_ranks: int, fabric: Interconnect,
                 procs_per_node: int = 8,
                 intra: Interconnect = MAIN_MEMORY, *,
                 onesided: bool = False):
        self.n = n_ranks
        self.fabric = fabric
        self.intra = intra
        self.ppn = procs_per_node
        self.onesided = onesided
        # (src, dst, tag) -> list of arrival times
        self.mailbox: dict[tuple[int, int, int], list[float]] = {}
        self.comm_time = [0.0] * n_ranks
        self.compute_time = [0.0] * n_ranks

    T_SW = 1.5e-6        # fabric-independent per-message MPI software cost

    def _node(self, r: int) -> int:
        return r // self.ppn

    @property
    def nodes(self) -> int:
        return max(1, self.n // self.ppn)

    def _sharers(self) -> float:
        """Ranks contending for the node's single inter-node port."""
        return max(1.0, self.ppn * (1.0 - 1.0 / self.nodes))

    def _msg_time(self, a: int, b: int, nbytes: int) -> float:
        if self._node(a) == self._node(b):
            return self.T_SW + self.intra.raw_latency(nbytes)
        ic = self.fabric
        return self.T_SW + ic.alpha + nbytes * self._sharers() / ic.bandwidth

    def _allreduce_time(self, nbytes: int) -> float:
        """Small payloads: recursive doubling (log2 n rounds, full size).
        Large payloads: ring reduce-scatter + all-gather (2(n-1) rounds of
        1/n size). The inter-node hop paces every round once the job spans
        nodes — MPICH's size-switched algorithm choice."""
        if self.n == 1:
            return 0.0
        import math as _m

        def hop(size: int) -> float:
            if self.nodes <= 1:
                return self.T_SW + self.intra.raw_latency(size)
            return (self.T_SW + self.fabric.alpha
                    + size * self._sharers() / self.fabric.bandwidth)

        rd = _m.ceil(_m.log2(self.n)) * hop(nbytes)
        ring = 2 * (self.n - 1) * hop(max(nbytes // self.n, 1))
        return min(rd, ring)

    # ------------------------------------------------------------------
    def run(self, make_prog: Callable[[int], Iterator]) -> dict:
        procs = [Proc(r, make_prog(r)) for r in range(self.n)]
        barrier_wait: list[Proc] = []
        # receivers blocked on a (src, dst, tag) with no message yet;
        # woken by the matching send (no polling)
        waiting: dict[tuple[int, int, int], Proc] = {}

        ready = [(0.0, r) for r in range(self.n)]
        heapq.heapify(ready)
        done = 0
        guard = 0
        while done < self.n:
            guard += 1
            if guard > 50_000_000:
                raise RuntimeError("simulator livelock")
            if not ready:
                raise RuntimeError("simulator deadlock: no runnable rank")
            t, r = heapq.heappop(ready)
            p = procs[r]
            p.time = max(p.time, t)
            try:
                action = next(p.gen)
            except StopIteration:
                done += 1
                continue
            kind = action[0]
            if kind == "compute":
                self.compute_time[r] += action[1]
                p.time += action[1]
                heapq.heappush(ready, (p.time, r))
            elif kind == "send":
                _, dst, nbytes, tag = action
                arrive = p.time + self._msg_time(r, dst, nbytes)
                key = (r, dst, tag)
                blocked = waiting.pop(key, None)
                if blocked is not None:
                    wait = max(arrive - blocked.time, 0.0)
                    self.comm_time[blocked.rank] += wait
                    blocked.time = max(blocked.time, arrive)
                    heapq.heappush(ready, (blocked.time, blocked.rank))
                else:
                    self.mailbox.setdefault(key, []).append(arrive)
                # eager injection: sender proceeds immediately
                heapq.heappush(ready, (p.time, r))
            elif kind == "recv":
                _, src, nbytes, tag = action
                box = self.mailbox.get((src, r, tag))
                if box:
                    arrive = box.pop(0)
                    wait = max(arrive - p.time, 0.0)
                    self.comm_time[r] += wait
                    p.time = max(p.time, arrive)
                    heapq.heappush(ready, (p.time, r))
                else:
                    waiting[(src, r, tag)] = p   # sleep until the send
            elif kind == "sendrecv":
                _, peer, nbytes, tag = action
                tmsg = self._msg_time(r, peer, nbytes)
                self.comm_time[r] += tmsg
                p.time += tmsg
                heapq.heappush(ready, (p.time, r))
            elif kind == "allreduce":
                tar = self._allreduce_time(action[1])
                self.comm_time[r] += tar
                p.time += tar
                barrier_wait.append(p)
                if len(barrier_wait) == self.n:
                    tmax = max(q.time for q in barrier_wait)
                    for q in barrier_wait:
                        self.comm_time[q.rank] += tmax - q.time
                        q.time = tmax
                        heapq.heappush(ready, (q.time, q.rank))
                    barrier_wait = []
            elif kind == "barrier":
                barrier_wait.append(p)
                if len(barrier_wait) == self.n:
                    tmax = max(q.time for q in barrier_wait)
                    for q in barrier_wait:
                        self.comm_time[q.rank] += tmax - q.time
                        q.time = tmax
                        heapq.heappush(ready, (q.time, q.rank))
                    barrier_wait = []
            else:
                raise ValueError(kind)
        if waiting:
            raise RuntimeError(
                f"simulator deadlock: receivers never matched: "
                f"{list(waiting)[:4]}")
        total = max(p.time for p in procs)
        return {
            "total_s": total,
            "comm_s": max(self.comm_time),
            "compute_s": max(self.compute_time),
            "comm_fraction": max(self.comm_time) / total if total else 0.0,
        }
