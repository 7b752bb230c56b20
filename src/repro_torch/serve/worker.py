"""Worker ranks: continuous-batching decode over the sharded page cache.

A worker runs one loop: drain admissions from its persistent receive
ring, let waiting sessions JOIN the decode batch (up to ``max_batch``),
advance every batched session by one synthetic token, and let finished
sessions LEAVE — continuous batching, requests join and leave between
steps, the batch never drains to restart.

KV pages are produced as decode crosses page boundaries.  A page homed
on this rank is a plain local pool write; a page homed elsewhere moves
by ``win.rput`` against the PASSIVE home (zero receiver-side drain —
one chunk per engine tick, overlapping the next decode steps; the
request is only awaited at session completion).  At completion the
worker drains every REMOTE page back with ``win.rget`` and verifies it
against the regenerable expected bytes, folds the session checksum,
and reports DONE through its persistent send ring.

Every ``stats_interval`` steps the worker ``raccumulate``s its decoded
token delta into the router's shared stats word (satellite 1's
request-based accumulate: exclusive window lock held only across the
engine-pumped get->reduce->put chain) and heartbeats the router so
fail-stop detection has a signal even mid-long-session.

``abort()`` is the fault hook: cancel the posted admission receives
(matchbox retracted), stop serving.  The pages this rank HOMES stay
attached and readable — pool memory outlives the rank, so surviving
sessions keep rget-ing their pages from the dead shard.

Pages live on the worker's device (the comm's): each page's bytes come
from ``wire.page_fill`` and are held as a uint8 tensor there; local
fills are ``PoolBuffer.write`` of it, remote fills ``win.rput``; drains
land in a scratch tensor on the device, are compared with the expected
page there, and their checksum is taken there. The stats word is
``raccumulate``d as an int64 tensor on the device. On the card every
page byte crosses the pool through the ``cellcopy`` kernel.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.serve import wire


class _ActiveSession:
    __slots__ = ("sid", "epoch", "prompt", "gen", "pages", "tokens",
                 "next_page", "checksum", "page_reqs", "t_join")

    def __init__(self, msg: dict, now: float):
        self.sid = msg["sid"]
        self.epoch = msg["epoch"]
        self.prompt = msg["prompt"]
        self.gen = msg["gen"]
        self.pages = msg["pages"]
        self.tokens = 0
        self.next_page = 0
        self.checksum = 0
        self.page_reqs = []       # (req, src) — src pinned till wait()
        self.t_join = now


class Worker:
    def __init__(self, comm, cfg, store, directory, win, router: int = 0,
                 stats_addr: int = -1):
        self.comm = comm
        self.cfg = cfg
        self.store = store
        self.dir = directory
        self.win = win
        self.router = router
        self.stats_addr = stats_addr
        self.rank = comm.rank
        # persistent pools: admissions in, DONE/BEAT frames out
        words = wire.admit_words(cfg.max_pages)
        self._rx_bufs = [np.zeros(words, dtype=np.int64)
                         for _ in range(cfg.admit_depth)]
        self._rx = [comm.recv_init(router, b) for b in self._rx_bufs]
        for r in self._rx:
            r.start()
        self._rx_head = 0
        self._tx_bufs = [np.zeros(wire.DONE_WORDS, dtype=np.int64)
                         for _ in range(cfg.admit_depth)]
        self._tx = [comm.send_init(router, b) for b in self._tx_bufs]
        self._tx_head = 0
        self.pending: list[_ActiveSession] = []
        self.batch: list[_ActiveSession] = []
        self.stopping = False
        self.aborted = False
        # report counters
        self.steps = 0
        self.busy_steps = 0       # steps that advanced a live batch
        self.served = 0
        self.tokens_out = 0
        self.rput_bytes = 0
        self.rget_bytes = 0
        self.local_fills = 0
        self.racc_calls = 0
        self.verify_failures = 0
        self._tokens_unreported = 0
        self.device = comm.device
        self._scratch = torch.empty(cfg.page_bytes, dtype=torch.uint8,
                                    device=self.device)

    # -- control-plane frames -------------------------------------------

    def _drain_admits(self, now: float) -> None:
        while not self.stopping:
            req = self._rx[self._rx_head]
            if not req.test():
                return
            buf = self._rx_bufs[self._rx_head]
            kind = int(buf[0])
            if kind == wire.MSG_STOP:
                self.stopping = True
                req.start()          # keep the ring armed for teardown
            else:
                self.pending.append(_ActiveSession(
                    wire.decode_admit(buf), now))
                req.start()
            self._rx_head = (self._rx_head + 1) % len(self._rx)

    def _send_status(self, fill) -> None:
        req = self._tx[self._tx_head]
        if req.started and req.active:
            req.wait()
        fill(self._tx_bufs[self._tx_head])
        req.start()
        self._tx_head = (self._tx_head + 1) % len(self._tx)

    # -- data plane ------------------------------------------------------

    def _page(self, sid: int, p: int) -> torch.Tensor:
        """Page ``p`` of session ``sid`` as a uint8 tensor on the
        worker's device."""
        return torch.from_numpy(wire.page_fill(
            sid, p, self.cfg.seed, self.cfg.page_bytes)).to(self.device)

    def _fill_page(self, sess: _ActiveSession, p: int) -> None:
        content = self._page(sess.sid, p)
        home, slot = sess.pages[p]
        if home == self.rank:
            self.store.write_local(slot, content)
            self.local_fills += 1
        else:
            addr = self.dir.addr(home, slot)
            req = self.win.rput(home, addr, content)
            sess.page_reqs.append((req, content))
            self.rput_bytes += content.numel()

    def _advance(self, sess: _ActiveSession) -> bool:
        """One decode step; True when the session just finished."""
        pos = sess.prompt + sess.tokens
        sess.tokens += 1
        sess.checksum = wire.fold(
            sess.checksum, wire.token(sess.sid, pos, self.cfg.seed))
        kv = sess.prompt + sess.tokens
        while (sess.next_page + 1) * self.cfg.page_tokens <= kv:
            self._fill_page(sess, sess.next_page)
            sess.next_page += 1
        if sess.tokens < sess.gen:
            return False
        while sess.next_page < len(sess.pages):   # final partial page
            self._fill_page(sess, sess.next_page)
            sess.next_page += 1
        return True

    def _complete(self, sess: _ActiveSession) -> None:
        """Flush outstanding fills, drain every page back (a remote one
        by rget), verify it against the expected page on the device,
        fold the drained page's checksum, report DONE. (The JAX package
        folds the expected page's checksum; the two agree whenever
        verification passes, and here a corrupted drain also fails the
        router's check.)"""
        for req, _src in sess.page_reqs:
            req.wait()
        sess.page_reqs = []
        data = self._scratch
        for p, (home, slot) in enumerate(sess.pages):
            if home == self.rank:
                self.store.read_local_into(slot, data)
            else:
                addr = self.dir.addr(home, slot)
                self.win.rget(home, addr, data).wait()
                self.rget_bytes += data.numel()
            if not torch.equal(data, self._page(sess.sid, p)):
                self.verify_failures += 1
            sess.checksum = wire.fold(sess.checksum,
                                      wire.page_checksum(data))
        self.served += 1
        self.tokens_out += sess.tokens
        self._tokens_unreported += sess.tokens
        self._send_status(lambda b, s=sess: wire.encode_done(
            b, self.rank, s.sid, s.epoch, s.tokens, s.checksum,
            self.steps))

    def _accumulate_stats(self) -> None:
        delta = self._tokens_unreported
        if delta == 0 or self.stats_addr < 0:
            return
        self._tokens_unreported = 0
        self.win.raccumulate(self.router, self.stats_addr,
                             torch.tensor([delta], dtype=torch.int64,
                                          device=self.device)).wait()
        self.racc_calls += 1

    # -- the loop --------------------------------------------------------

    def step(self) -> None:
        now = time.monotonic()
        self._drain_admits(now)
        while self.pending and len(self.batch) < self.cfg.max_batch:
            self.batch.append(self.pending.pop(0))    # JOIN
        if self.batch:
            self.busy_steps += 1
        finished = []
        for sess in self.batch:
            if self._advance(sess):
                finished.append(sess)
        for sess in finished:
            self.batch.remove(sess)                   # LEAVE
            self._complete(sess)
        self.steps += 1
        if self.cfg.decode_us > 0:
            time.sleep(self.cfg.decode_us * 1e-6)     # synthetic compute
        if self.steps % self.cfg.stats_interval == 0:
            self._accumulate_stats()
            self._send_status(lambda b: wire.encode_beat(
                b, self.rank, self.tokens_out, self.steps))
        self.comm.progress()

    def run(self) -> dict:
        fail_at = (self.cfg.fail_after_steps
                   if self.rank == self.cfg.fail_rank else -1)
        while not (self.stopping and not self.batch and not self.pending):
            self.step()
            if fail_at >= 0 and self.steps >= fail_at:
                self.abort()
                break
            time.sleep(0)
        if not self.aborted:
            self._accumulate_stats()
            self._teardown()
        # sends nothing more: the router may stop reading (a fail-stopped
        # rank of this simulation says so too, in case it was not retired)
        self.win.notify(self.router)
        return self.report()

    def abort(self) -> None:
        """Fail-stop: retract posted admission receives, stop serving.
        Homed pages stay attached — the shared pool outlives the rank,
        peers keep reading them."""
        self.aborted = True
        for r in self._rx:
            r.cancel()
            r.free()
        self._rx = []

    def _teardown(self) -> None:
        for r in self._rx:
            r.cancel()
            r.free()
        self._rx = []
        for r in self._tx:
            if r.started and r.active:
                r.wait()
            r.free()
        self._tx = []

    def report(self) -> dict:
        return dict(role="worker", rank=self.rank, steps=self.steps,
                    busy_steps=self.busy_steps,
                    served=self.served, tokens=self.tokens_out,
                    rput_bytes=self.rput_bytes,
                    rget_bytes=self.rget_bytes,
                    local_fills=self.local_fills,
                    racc_calls=self.racc_calls,
                    verify_failures=self.verify_failures,
                    aborted=self.aborted)
