"""The front-end router rank: admission, placement, completion, faults.

The router (rank 0) owns THE allocator for every worker's page slots
and admits an open-loop Poisson population of synthetic sessions.  All
control traffic runs over pre-planned persistent requests:

  * one ``send_init`` ring per worker for ADMIT/STOP frames — the hot
    admission loop mutates a pinned buffer and ``start()``s, it never
    allocates;
  * one ``recv_init`` ring per worker for DONE/BEAT frames, tested
    head-only so frame order is preserved (the pt2pt FIFO matches
    posted receives in order).

Placement is rank-sharded round-robin: a session's pages are dealt
across every alive worker's shard, so most page fills and the final
page drain cross ranks one-sidedly (that traffic is the point of the
bench).  Admission is open loop — the arrival schedule is drawn once
from a seeded exponential stream and never reacts to completions, so
measured latency includes real queueing delay.

Fault handling is fail-stop: a worker that misses its heartbeat window
while holding sessions is retired — the router CANCELS its posted
DONE/BEAT receives (retracting the matchbox postings so the slots are
reusable), drops the dead shard from the allocator, and re-admits the
worker's sessions elsewhere under a bumped epoch.  Stale completions
from the old placement can never double-count: DONE carries (sid,
epoch) and the router only accepts the live pair.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.serve import wire


class _SendRing:
    """Depth-d ring of persistent ADMIT-frame sends to one worker."""

    def __init__(self, comm, worker: int, words: int, depth: int):
        self.bufs = [np.zeros(words, dtype=np.int64) for _ in range(depth)]
        self.reqs = [comm.send_init(worker, b) for b in self.bufs]
        self.head = 0

    def claim(self) -> np.ndarray:
        """The next frame buffer, recycled once its last send lands."""
        req = self.reqs[self.head]
        if req.started and req.active:
            req.wait()
        return self.bufs[self.head]

    def send(self) -> None:
        self.reqs[self.head].start()
        self.head = (self.head + 1) % len(self.reqs)

    def free(self) -> None:
        for r in self.reqs:
            if r.started and r.active:
                r.wait()
            r.free()


class _RecvRing:
    """Depth-d ring of persistent DONE/BEAT receives from one worker,
    tested head-only (frames complete in post order)."""

    def __init__(self, comm, worker: int, depth: int):
        self.bufs = [np.zeros(wire.DONE_WORDS, dtype=np.int64)
                     for _ in range(depth)]
        self.reqs = [comm.recv_init(worker, b) for b in self.bufs]
        for r in self.reqs:
            r.start()
        self.head = 0

    def poll(self):
        """One completed frame (decoded dict) or None; re-arms the slot."""
        req = self.reqs[self.head]
        if not req.test():
            return None
        msg = wire.decode_status(self.bufs[self.head])
        req.start()
        self.head = (self.head + 1) % len(self.reqs)
        return msg

    def cancel(self) -> None:
        """Retract every posted receive (worker retired): the matchbox
        entries are withdrawn and the requests freed."""
        for r in self.reqs:
            r.cancel()
            r.free()
        self.reqs = []


class _Session:
    __slots__ = ("sid", "prompt", "gen", "arrival", "epoch", "worker",
                 "pages", "t_admit", "t_done", "n_pages")

    def __init__(self, sid, prompt, gen, arrival):
        self.sid = sid
        self.prompt = prompt
        self.gen = gen
        self.arrival = arrival
        self.epoch = 0
        self.worker = -1
        self.pages = []           # [(home, slot), ...]
        self.t_admit = None
        self.t_done = None


class Router:
    def __init__(self, comm, cfg, directory, win):
        self.comm = comm
        self.cfg = cfg
        self.dir = directory
        self.win = win            # the page window: workers' last notify
        self.workers = list(range(1, comm.size))
        self.alive = set(self.workers)
        self.free_slots = {w: list(range(cfg.slots_per_worker))
                           for w in self.workers}
        self.load = {w: 0 for w in self.workers}
        words = wire.admit_words(cfg.max_pages)
        self.tx = {w: _SendRing(comm, w, words, cfg.admit_depth)
                   for w in self.workers}
        self.rx = {w: _RecvRing(comm, w, cfg.admit_depth)
                   for w in self.workers}
        self.sessions: dict[int, _Session] = {}
        self.backlog: list[_Session] = []
        self.done: list[_Session] = []
        self.retired: list[int] = []
        self.reroutes = 0
        self.bad_checksums = 0
        self._place_cursor = 0

        rng = np.random.default_rng(cfg.seed)
        gaps = rng.exponential(1.0 / cfg.rate, size=cfg.sessions)
        self._arrivals = np.cumsum(gaps)
        self._prompts = rng.integers(cfg.prompt_min, cfg.prompt_max + 1,
                                     size=cfg.sessions)
        self._gens = rng.integers(cfg.gen_min, cfg.gen_max + 1,
                                  size=cfg.sessions)
        self._next_sid = 0
        self.t0 = None

    # -- placement ------------------------------------------------------

    def _place(self, n_pages: int):
        """Deal n_pages slots round-robin across alive shards; None when
        the cache cannot hold the session right now (stays in backlog)."""
        pool = [w for w in self.workers
                if w in self.alive and self.free_slots[w]]
        if not pool or sum(len(self.free_slots[w]) for w in pool) < n_pages:
            return None
        placement = []
        while len(placement) < n_pages:
            w = pool[self._place_cursor % len(pool)]
            self._place_cursor += 1
            if self.free_slots[w]:
                placement.append((w, self.free_slots[w].pop()))
        return placement

    def _reclaim(self, sess: _Session) -> None:
        for home, slot in sess.pages:
            if home in self.alive:
                self.free_slots[home].append(slot)
        sess.pages = []

    def _admit(self, sess: _Session, now: float) -> bool:
        placement = self._place(sess.n_pages)
        if placement is None:
            return False
        serving = min((w for w in self.alive), key=lambda w: self.load[w],
                      default=None)
        if serving is None:
            return False
        sess.pages = placement
        sess.worker = serving
        self.load[serving] += 1
        if sess.t_admit is None:
            sess.t_admit = now
        buf = self.tx[serving].claim()
        wire.encode_admit(buf, sess.sid, sess.epoch, sess.prompt, sess.gen,
                          [wire.pack_page(h, s) for h, s in placement])
        self.tx[serving].send()
        return True

    def _admit_backlog(self) -> None:
        """Admit backlogged sessions in order, as trying each in turn
        would: a session fits iff the alive shards' free slots cover its
        pages, so a running count of free slots decides, and the scan
        stops when none are left. (A deep backlog is rescanned on every
        loop; scanning all of it would starve the ranks that share this
        interpreter.)"""
        free = sum(len(self.free_slots[w]) for w in self.alive)
        still = []
        for i, sess in enumerate(self.backlog):
            if not free:
                still += self.backlog[i:]
                break
            if sess.n_pages > free \
                    or not self._admit(sess, time.monotonic()):
                still.append(sess)
            else:
                free -= sess.n_pages
        self.backlog = still

    # -- completion / fault handling ------------------------------------

    def _on_done(self, msg: dict, now: float) -> None:
        sess = self.sessions.get(msg["sid"])
        if sess is None or sess.t_done is not None \
                or msg["epoch"] != sess.epoch:
            return                      # stale epoch: retired placement
        sess.t_done = now
        self.load[sess.worker] -= 1
        every = max(1, self.cfg.verify_every)
        if sess.sid % every == 0:
            want = wire.session_checksum(
                sess.sid, sess.prompt, sess.gen, self.cfg.page_tokens,
                self.cfg.page_bytes, self.cfg.seed)
            if msg["checksum"] != want:
                self.bad_checksums += 1
        self._reclaim(sess)
        self.done.append(sess)

    def retire_worker(self, w: int) -> None:
        """Fail-stop retirement: retract the dead worker's postings,
        drop its shard, re-route its sessions under a new epoch."""
        if w not in self.alive:
            return
        self.alive.discard(w)
        self.retired.append(w)
        self.rx[w].cancel()
        self.free_slots[w] = []
        for sess in self.sessions.values():
            if sess.worker == w and sess.t_done is None:
                self._reclaim(sess)
                sess.epoch += 1
                sess.worker = -1
                self.reroutes += 1
                self.backlog.append(sess)

    # -- main loop ------------------------------------------------------

    def run(self) -> dict:
        cfg = self.cfg
        self.t0 = t0 = time.monotonic()
        last_seen = {w: t0 for w in self.workers}
        deadline = t0 + cfg.deadline_s
        while len(self.done) < cfg.sessions:
            now = time.monotonic()
            if now > deadline:
                raise RuntimeError(
                    f"serve deadline exceeded: {len(self.done)}/"
                    f"{cfg.sessions} sessions done, alive={self.alive}")
            for w in self.workers:
                if w not in self.alive:
                    continue
                while True:
                    msg = self.rx[w].poll()
                    if msg is None:
                        break
                    last_seen[w] = now
                    if msg["kind"] == wire.MSG_DONE:
                        self._on_done(msg, now)
            if cfg.worker_timeout > 0:
                for w in list(self.alive):
                    if now - last_seen[w] > cfg.worker_timeout \
                            and self.load[w] > 0:
                        self.retire_worker(w)
            while self._next_sid < cfg.sessions \
                    and now - t0 >= self._arrivals[self._next_sid]:
                i = self._next_sid
                self._next_sid += 1
                sess = _Session(i, int(self._prompts[i]),
                                int(self._gens[i]),
                                t0 + float(self._arrivals[i]))
                sess.n_pages = wire.pages_for(sess.prompt, sess.gen,
                                              cfg.page_tokens)
                self.sessions[i] = sess
                self.backlog.append(sess)
            self._admit_backlog()
            self.comm.progress()
            time.sleep(0)            # fair scheduling vs worker threads
        for w in self.alive:
            buf = self.tx[w].claim()
            wire.encode_stop(buf)
            self.tx[w].send()
        self._drain_until_quiet()
        for w in self.workers:
            self.tx[w].free()
            if w in self.alive:
                self.rx[w].cancel()
        return self.report()

    def _drain_until_quiet(self) -> None:
        """Keep reading the alive workers' frames until each has notified
        on the page window that it sends nothing more. A BEAT a worker
        started before it saw STOP can sit in a full queue, and the
        worker's teardown waits for it to land: a router that stopped
        reading here left that worker waiting out its send timeout."""
        left = set(self.alive)
        deadline = time.monotonic() + 30.0
        while left:
            for w in list(left):
                if self.win.test_notify(w):
                    self.win.wait_notify(w)
                    left.discard(w)
            for w in self.alive:
                while self.rx[w].poll() is not None:
                    pass
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"workers {sorted(left)} never finished sending "
                    f"after STOP")
            self.comm.progress()
            time.sleep(0)

    # -- results --------------------------------------------------------

    def report(self) -> dict:
        lats = sorted((s.t_done - s.arrival) * 1e6 for s in self.done)

        def pct(q):
            if not lats:
                return 0.0
            return lats[min(len(lats) - 1, int(q * (len(lats) - 1) + 0.5))]

        span = max(1e-9, (max(s.t_done for s in self.done) - self.t0)
                   if self.done else 0.0)
        return dict(
            role="router",
            sessions=len(self.done),
            qps=len(self.done) / span,
            p50_us=pct(0.50),
            p99_us=pct(0.99),
            mean_us=(sum(lats) / len(lats)) if lats else 0.0,
            tokens=sum(s.gen for s in self.done),
            retired=list(self.retired),
            reroutes=self.reroutes,
            bad_checksums=self.bad_checksums,
        )
