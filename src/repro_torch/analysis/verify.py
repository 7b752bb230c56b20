"""Cross-rank static verification of compiled collective schedules (the
JAX package's ``repro.analysis.verify``, over the port's schedule IR).

``repro_torch.core.sched`` compiles each collective into a per-rank DAG of
Send/Recv/Reduce/Copy nodes, and the protocol's correctness rests on
invariants that span RANKS: every send must meet exactly one matching
receive, the union of all ranks' dependency edges plus the wire edges
must stay acyclic, no two unordered node executions may touch the same
bytes with a write, and no execution may demand more matchbox depth or
tag space than the runtime provisions. The runtime fuzz suite exercises
those properties at runtime; this module PROVES them per config by
compiling the schedule for all ranks and model-checking the result —
cheap enough to sweep the whole compiler matrix in CI.

The checks (one ``Finding.code`` per failure class):

``invariant``
    a rank's schedule fails ``Schedule.validate()`` (forward/self dep,
    round outside span) — the per-rank structural floor, reused from
    ``core.sched.ScheduleInvariantError``.
``rounds-mismatch``
    ranks disagree on the tag span or chunk size. Wire tags are
    ``tag_base + round``; a span disagreement silently cross-matches
    adjacent collectives.
``tag-window``
    the (sub-)round count exceeds ``MAX_ROUNDS`` — the per-launch tag
    window — so two in-flight launches could collide.
``orphan-send`` / ``orphan-recv`` / ``duplicate-match`` / ``size-mismatch``
    send/recv matching is not a size-preserving bijection on
    ``(src, dst, round)`` keys.
``deadlock``
    the global happens-before graph has a cycle. Every node is split
    into an issue and a completion event: deps order ``complete(dep) ->
    issue(node)``; a matched pair adds ``issue(send) -> complete(recv)``
    (data cannot land before the sender starts) and ``issue(recv) ->
    complete(send)`` (rendezvous: a pool-resident send drains only once
    the receive is posted — the synchronous-mode conservative model).
    Dependency-free receives therefore pre-post correctly: their issue
    event has no prerequisites, which is exactly how the progress
    engine primes the matchbox.
``buffer-hazard``
    two accesses on one rank overlap in a slot, at least one writes,
    and neither is an ancestor of the other — an unordered WAR/WAW/RAW
    pair the engine could execute in either order.
``unchained-send``
    two payload-carrying sends source the same slot without a
    dependency path between them. A ``PoolBuffer`` has ONE drain-ack
    word, so at most one send per underlying buffer may be in flight;
    zero-byte sends (the dissemination barrier) are exempt — they never
    take the pool path.
``depth-overflow``
    a peer needs more concurrent receive postings than the declared
    matchbox demand (``Schedule.required_matchbox_depth`` is the single
    source of truth; ``comm.py`` derives persistent demand from it).

One-sided schedules (``rput``/``rget``/``raccumulate``/
``allgather_get``/``bcast_put``) verify under the SAME checks: their Put/Get nodes are engine-local
(the shared-memory store IS the transfer, so they never enter the
send/recv bijection), while all cross-rank ordering they need rides on
zero-byte Send/Recv token pairs — which the matching, deadlock and
depth checks see as ordinary wire traffic. Put reads its staging
region, Get writes it, so the hazard check orders one-sided data
movement exactly like Reduce/Copy.

What this does NOT prove: value correctness (reduce order, padding),
liveness of the runtime engine, or races in the matchbox claim
protocol itself — those stay with the runtime fuzz suite and the
``lint_protocol`` discipline linter. For one-sided schedules it also
does not model WINDOW-segment overlap across collectives (epoch
discipline — fence/PSCW/lock — owns that, as in MPI).

Entry points: ``verify_config`` for one config, ``sweep`` /
``iter_matrix`` for the full compiler matrix, ``compile_group`` +
``verify_schedules`` when the schedules are built by hand (mutation
tests). CLI: ``python -m repro_torch.analysis.verify [--max-n N]``.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass, field

from repro_torch.core.sched import (MAX_ROUNDS, GetOp, PutOp, RecvOp, Schedule,
                              ScheduleInvariantError, SendOp,
                              compile_schedule)

__all__ = ["Finding", "VerificationReport", "compile_group",
           "verify_schedules", "verify_config", "iter_matrix", "sweep"]


# --------------------------------------------------------------------------
# findings
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Finding:
    """One verification failure. ``code`` is the machine-checkable
    failure class (see module docstring); ``rank``/``node`` locate the
    offending node when the failure is attributable to one."""
    code: str
    message: str
    rank: int | None = None
    node: int | None = None

    def __str__(self) -> str:
        where = ""
        if self.rank is not None:
            where += f" rank={self.rank}"
        if self.node is not None:
            where += f" node={self.node}"
        return f"[{self.code}]{where}: {self.message}"


@dataclass
class VerificationReport:
    """All findings for one verified config."""
    config: str
    findings: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def codes(self) -> set:
        return {f.code for f in self.findings}

    def raise_if_failed(self) -> None:
        if self.findings:
            lines = "\n  ".join(str(f) for f in self.findings)
            raise ScheduleInvariantError(
                f"schedule verification failed for {self.config}:"
                f"\n  {lines}")

    def __str__(self) -> str:
        if self.ok:
            return f"{self.config}: OK"
        lines = "\n  ".join(str(f) for f in self.findings)
        return f"{self.config}: {len(self.findings)} finding(s)\n  {lines}"


# --------------------------------------------------------------------------
# compiling every rank of a config
# --------------------------------------------------------------------------

class _CompileView:
    """Minimal communicator stand-in: ``compile_schedule`` reads only
    ``size``, ``rank`` and the ``_sched_cache`` dict, so verifying rank
    r never needs a live runtime — chunk widening included, because it
    is a pure function of the (rank-uniform) sub-round count."""

    def __init__(self, n: int, rank: int):
        self.size = n
        self.rank = rank
        self._sched_cache: dict = {}


def compile_group(kind: str, n: int, *, nbytes: int = 0,
                  itemsize: int = 1, root: int = 0, group: int = 0,
                  chunk_bytes: int | None = None) -> list[Schedule]:
    """Compile ``kind`` for ALL ranks of an n-rank communicator."""
    return [compile_schedule(_CompileView(n, r), kind, nbytes, itemsize,
                             root, group=group, chunk_bytes=chunk_bytes)
            for r in range(n)]


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------

def _check_structure(scheds, out) -> None:
    for sched in scheds:
        try:
            sched.validate()
        except ScheduleInvariantError as e:
            out.append(Finding("invariant", str(e), rank=sched.rank,
                               node=e.node))


def _check_uniformity(scheds, out) -> None:
    rounds = {s.rounds for s in scheds}
    if len(rounds) > 1:
        out.append(Finding("rounds-mismatch",
                           f"ranks disagree on tag span: {sorted(rounds)}"))
    cbs = {s.chunk_bytes for s in scheds}
    if len(cbs) > 1:
        out.append(Finding("rounds-mismatch",
                           f"ranks disagree on chunk size: {sorted(map(str, cbs))}"))
    for s in scheds:
        if s.rounds > MAX_ROUNDS:
            out.append(Finding(
                "tag-window",
                f"{s.rounds} sub-rounds exceed the per-launch tag "
                f"window MAX_ROUNDS={MAX_ROUNDS}", rank=s.rank))


def _check_matching(scheds, out):
    """Send/recv matching must be a size-preserving bijection on
    ``(src, dst, round)`` — the wire key after the executor adds the
    per-launch tag base. Returns the matched pairs for the deadlock
    check: list of ``(src_rank, send_idx, dst_rank, recv_idx)``."""
    sends: dict = {}
    recvs: dict = {}
    for sched in scheds:
        for nd in sched.nodes:
            if isinstance(nd, SendOp):
                key = (sched.rank, nd.peer, nd.round)
                if key in sends:
                    out.append(Finding(
                        "duplicate-match",
                        f"two sends {sends[key].idx} and {nd.idx} from "
                        f"rank {sched.rank} to rank {nd.peer} share "
                        f"round {nd.round}", rank=sched.rank,
                        node=nd.idx))
                sends[key] = nd
            elif isinstance(nd, RecvOp):
                key = (nd.peer, sched.rank, nd.round)
                if key in recvs:
                    out.append(Finding(
                        "duplicate-match",
                        f"two receives {recvs[key].idx} and {nd.idx} on "
                        f"rank {sched.rank} from rank {nd.peer} share "
                        f"round {nd.round}", rank=sched.rank,
                        node=nd.idx))
                recvs[key] = nd
    pairs = []
    for key, snd in sends.items():
        src, dst, rnd = key
        rcv = recvs.get(key)
        if rcv is None:
            out.append(Finding(
                "orphan-send",
                f"send to rank {dst} at round {rnd} has no matching "
                f"receive on the peer", rank=src, node=snd.idx))
            continue
        if rcv.buf.nbytes != snd.buf.nbytes:
            out.append(Finding(
                "size-mismatch",
                f"send of {snd.buf.nbytes} B to rank {dst} at round "
                f"{rnd} meets a receive of {rcv.buf.nbytes} B",
                rank=src, node=snd.idx))
        pairs.append((src, snd.idx, dst, rcv.idx))
    for key, rcv in recvs.items():
        src, dst, rnd = key
        if key not in sends:
            out.append(Finding(
                "orphan-recv",
                f"receive from rank {src} at round {rnd} has no "
                f"matching send on the peer", rank=dst, node=rcv.idx))
    return pairs


def _check_deadlock(scheds, pairs, out) -> None:
    """Kahn's algorithm over the global happens-before event graph;
    any cycle is a deadlock the engine cannot make progress through.
    Events: node X -> issue(X)=2*gid(X), complete(X)=2*gid(X)+1."""
    offset = []
    total = 0
    for sched in scheds:
        offset.append(total)
        total += len(sched.nodes)
    n_ev = 2 * total
    succ: list[list[int]] = [[] for _ in range(n_ev)]
    indeg = [0] * n_ev

    def add(a: int, b: int) -> None:
        succ[a].append(b)
        indeg[b] += 1

    for sched in scheds:
        off = offset[sched.rank]
        for nd in sched.nodes:
            gid = off + nd.idx
            add(2 * gid, 2 * gid + 1)            # issue -> complete
            for d in nd.deps:
                add(2 * (off + d) + 1, 2 * gid)  # complete(dep) -> issue
    for src, sidx, dst, ridx in pairs:
        sg, rg = offset[src] + sidx, offset[dst] + ridx
        add(2 * sg, 2 * rg + 1)   # issue(send) -> complete(recv)
        add(2 * rg, 2 * sg + 1)   # issue(recv) -> complete(send)

    stack = [e for e in range(n_ev) if indeg[e] == 0]
    done = 0
    while stack:
        e = stack.pop()
        done += 1
        for t in succ[e]:
            indeg[t] -= 1
            if indeg[t] == 0:
                stack.append(t)
    if done == n_ev:
        return

    # extract one concrete cycle from the residual graph for the report
    def name(ev: int) -> str:
        gid, phase = divmod(ev, 2)
        for sched in scheds:
            if gid - offset[sched.rank] < len(sched.nodes) \
                    and gid >= offset[sched.rank]:
                nd = sched.nodes[gid - offset[sched.rank]]
                kind = type(nd).__name__
                tag = "issue" if phase == 0 else "complete"
                return f"rank{sched.rank}.{kind}[{nd.idx}].{tag}"
        return f"event{ev}"

    # walk BACKWARD through unprocessed predecessors: indeg[e] > 0
    # means some predecessor never completed Kahn's, so the walk stays
    # inside the residual set and must revisit a node — the cycle
    pred: list[list[int]] = [[] for _ in range(n_ev)]
    residual = {e for e in range(n_ev) if indeg[e] > 0}
    for e in residual:
        for t in succ[e]:
            if t in residual:
                pred[t].append(e)
    cur = next(iter(residual))
    path: list[int] = []
    seen: dict[int, int] = {}
    while cur not in seen:
        seen[cur] = len(path)
        path.append(cur)
        cur = pred[cur][0]
    cycle = [cur] + list(reversed(path[seen[cur]:]))
    out.append(Finding(
        "deadlock",
        "happens-before cycle: " + " -> ".join(name(e) for e in cycle)))


def _accesses(nd):
    """Yield ``(buf, is_write)`` for every LOCAL region a node touches.
    Put reads its staging region (window store), Get writes it (window
    load) — the window segment itself is cross-collective state that
    epoch discipline orders, not the schedule DAG."""
    if isinstance(nd, (SendOp, PutOp)):
        yield nd.buf, False
    elif isinstance(nd, (RecvOp, GetOp)):
        yield nd.buf, True
    else:                                   # ReduceOp / CopyOp
        yield nd.src, False
        yield nd.dst, True


def _ancestors(sched) -> list[int]:
    """Per-node ancestor sets as bitmasks. Construction order is a
    topological order (validate() enforces strictly-backward deps), so
    one forward pass computes the transitive closure."""
    anc = [0] * len(sched.nodes)
    for nd in sched.nodes:
        a = 0
        for d in nd.deps:
            a |= anc[d] | (1 << d)
        anc[nd.idx] = a
    return anc


def _check_hazards(scheds, out) -> None:
    """Unordered overlapping accesses with a write (WAR/WAW/RAW), and
    the same-slot send chain (one drain-ack word per PoolBuffer)."""
    for sched in scheds:
        anc = _ancestors(sched)
        by_slot: dict[int, list] = {}
        sends_in_slot: dict[int, list] = {}
        for nd in sched.nodes:
            for buf, wr in _accesses(nd):
                if buf.nbytes:
                    by_slot.setdefault(buf.slot, []).append(
                        (nd.idx, wr, buf.off, buf.off + buf.nbytes))
            if isinstance(nd, SendOp) and nd.buf.nbytes:
                sends_in_slot.setdefault(nd.buf.slot, []).append(nd.idx)

        for slot, accs in by_slot.items():
            for i in range(len(accs)):
                ai, awr, alo, ahi = accs[i]
                for j in range(i + 1, len(accs)):
                    bi, bwr, blo, bhi = accs[j]
                    if ai == bi or not (awr or bwr):
                        continue
                    if ahi <= blo or bhi <= alo:
                        continue
                    lo, hi = (ai, bi) if ai < bi else (bi, ai)
                    if not (anc[hi] >> lo) & 1:
                        out.append(Finding(
                            "buffer-hazard",
                            f"nodes {lo} and {hi} touch slot {slot} "
                            f"bytes [{max(alo, blo)}, {min(ahi, bhi)}) "
                            f"with a write but no dependency path "
                            f"orders them", rank=sched.rank, node=hi))

        for slot, idxs in sends_in_slot.items():
            for prev, cur in zip(idxs, idxs[1:]):
                if not (anc[cur] >> prev) & 1:
                    out.append(Finding(
                        "unchained-send",
                        f"sends {prev} and {cur} both source slot "
                        f"{slot} but are not ordered — a PoolBuffer "
                        f"has one drain-ack word, so same-slot sends "
                        f"must chain", rank=sched.rank, node=cur))


def _check_depth(scheds, matchbox_capacity, out) -> None:
    """``Schedule.required_matchbox_depth`` must equal the recount from
    the nodes (it is the declared bound ``comm.py`` provisions from),
    and — when a capacity is declared — no peer may need more."""
    for sched in scheds:
        per: dict[int, int] = {}
        for nd in sched.nodes:
            if isinstance(nd, RecvOp):
                per[nd.peer] = per.get(nd.peer, 0) + 1
        worst = max(per.values(), default=0)
        declared = sched.required_matchbox_depth()
        if worst != declared:
            out.append(Finding(
                "depth-overflow",
                f"declared matchbox depth {declared} != recounted "
                f"per-peer maximum {worst}", rank=sched.rank))
        for peer, depth in per.items():
            if sched.required_matchbox_depth(peer) != depth:
                out.append(Finding(
                    "depth-overflow",
                    f"declared depth toward peer {peer} is "
                    f"{sched.required_matchbox_depth(peer)}, schedule "
                    f"posts {depth}", rank=sched.rank))
            if matchbox_capacity is not None \
                    and depth > matchbox_capacity:
                out.append(Finding(
                    "depth-overflow",
                    f"peer {peer} needs {depth} concurrent postings "
                    f"but declared matchbox capacity is "
                    f"{matchbox_capacity}", rank=sched.rank))


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def verify_schedules(scheds: list[Schedule], *, config: str = "?",
                     matchbox_capacity: int | None = None
                     ) -> VerificationReport:
    """Run every check over one per-rank schedule list (``scheds[r]``
    is rank r's schedule). ``matchbox_capacity``, when given, is the
    provisioned per-peer posting depth to check ``depth-overflow``
    against (callers normally pass the persistent declaration
    ``2 * required_matchbox_depth()``)."""
    out: list[Finding] = []
    rep = VerificationReport(config, out)
    _check_structure(scheds, out)
    _check_uniformity(scheds, out)
    if any(f.code == "invariant" for f in out):
        return rep        # deps may be unusable; later checks assume not
    pairs = _check_matching(scheds, out)
    _check_deadlock(scheds, pairs, out)
    _check_hazards(scheds, out)
    _check_depth(scheds, matchbox_capacity, out)
    return rep


def verify_config(kind: str, n: int, *, nbytes: int = 0,
                  itemsize: int = 1, root: int = 0, group: int = 0,
                  chunk_bytes: int | None = None) -> VerificationReport:
    """Compile ``kind`` for all ``n`` ranks and verify the group. The
    matchbox capacity checked is the persistent-mode declaration
    (twice the schedule's own depth — two iterations coexist)."""
    config = (f"{kind}(n={n}, nbytes={nbytes}, itemsize={itemsize}, "
              f"root={root}, group={group}, chunk_bytes={chunk_bytes})")
    try:
        scheds = compile_group(kind, n, nbytes=nbytes, itemsize=itemsize,
                               root=root, group=group,
                               chunk_bytes=chunk_bytes)
    except ValueError as e:
        # ScheduleInvariantError and compiler preconditions (e.g. rd on
        # a non-pow2 size) both mean "this config cannot compile" — a
        # report the caller can inspect, not a crash.
        return VerificationReport(config, [Finding("invariant", str(e))])
    cap = max(2 * s.required_matchbox_depth() for s in scheds)
    return verify_schedules(scheds, config=config,
                            matchbox_capacity=max(cap, 1))


def iter_matrix(max_n: int = 16):
    """Yield every config the compilers currently support: all algos x
    rank counts 2..max_n x {unchunked, chunked, finely-chunked} x all
    valid hier group sizes, plus a chunk-widening boundary case. Pure
    and deterministic — the CI sweep and the pytest sweep share it."""
    nbytes, itemsize, per_b = 4096, 8, 1024
    for n in range(2, max_n + 1):
        pow2 = (n & (n - 1)) == 0
        for chunk in (None, 512, 128):
            cfgs = [dict(kind="allreduce_ring", n=n, nbytes=nbytes,
                         itemsize=itemsize),
                    dict(kind="reduce_scatter_ring", n=n, nbytes=nbytes,
                         itemsize=itemsize),
                    dict(kind="allgather_ring", n=n, nbytes=per_b),
                    dict(kind="allgather_bruck", n=n, nbytes=per_b),
                    # one-sided: Put/Get nodes + zero-byte token pairs
                    dict(kind="allgather_get", n=n, nbytes=per_b),
                    dict(kind="rput", n=n, nbytes=nbytes, root=n - 1),
                    dict(kind="rget", n=n, nbytes=nbytes, root=n - 1),
                    # read-modify-write chain: Get -> Reduce -> Put
                    dict(kind="raccumulate", n=n, nbytes=nbytes,
                         itemsize=itemsize, root=n - 1)]
            if pow2:
                cfgs.append(dict(kind="allreduce_rd", n=n, nbytes=nbytes,
                                 itemsize=itemsize))
            for root in (0, n - 1):
                cfgs.append(dict(kind="bcast", n=n, nbytes=nbytes,
                                 root=root))
                cfgs.append(dict(kind="bcast_put", n=n, nbytes=nbytes,
                                 root=root))
                cfgs.append(dict(kind="reduce", n=n, nbytes=nbytes,
                                 itemsize=itemsize, root=root))
            for g in range(1, n + 1):
                if n % g == 0 and ((n // g) & (n // g - 1)) == 0:
                    cfgs.append(dict(kind="allreduce_hier", n=n,
                                     nbytes=nbytes, itemsize=itemsize,
                                     group=g))
            for cfg in cfgs:
                cfg["chunk_bytes"] = chunk
                yield cfg
        yield dict(kind="barrier", n=n)
    # widening boundary: sub-rounds would blow past MAX_ROUNDS, so the
    # compiler must widen the chunk until the tag window fits — and the
    # widened schedule must still verify on every rank
    yield dict(kind="allreduce_rd", n=min(16, 1 << (max_n.bit_length() - 1)),
               nbytes=65536, itemsize=8, chunk_bytes=64)


def sweep(max_n: int = 16, *, fail_fast: bool = False):
    """Verify the full matrix; returns ``(n_configs, bad_reports)``."""
    count = 0
    bad = []
    for cfg in iter_matrix(max_n):
        kind = cfg.pop("kind")
        n = cfg.pop("n")
        rep = verify_config(kind, n, **cfg)
        count += 1
        if not rep.ok:
            bad.append(rep)
            if fail_fast:
                break
    return count, bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="cross-rank static verification of every compiled "
                    "collective schedule shape")
    p.add_argument("--max-n", type=int, default=16,
                   help="largest communicator size to sweep (default 16)")
    p.add_argument("--fail-fast", action="store_true",
                   help="stop at the first failing config")
    args = p.parse_args(argv)
    count, bad = sweep(args.max_n, fail_fast=args.fail_fast)
    for rep in bad:
        print(rep)
    print(f"verified {count} configs across sizes 2..{args.max_n}: "
          f"{len(bad)} failing")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
