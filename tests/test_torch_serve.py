"""The port's serving tier (``repro_torch.serve``) against the JAX package's
(``repro.serve``): every case of ``tests/test_serve.py``, run under both
packages' thread runtimes (the port with ``device="cpu"``) on the same
``ServeConfig`` and seed. Besides each reference test's own checks:

- the wire content (``page_fill``, ``token``, ``session_checksum``) and
  the frame encoders agree bit for bit; the port's ``page_checksum`` of a
  tensor equals numpy's;
- one seed gives the same ``sessions``, ``tokens`` and ``stats_tokens``
  in both packages, with no bad checksum and no failed page verify;
- on every worker ``rma_put == rput_bytes + 8 x racc_calls`` and
  ``rma_get == rget_bytes + 8 x racc_calls`` exactly, nothing lands under
  ``rndv_staged``/``rndv_posted``, and the router has no ``rma_*`` bytes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as REF  # noqa: E402
import repro.serve as REF_SERVE  # noqa: E402
import repro_torch.core as PORT  # noqa: E402
import repro_torch.serve as PORT_SERVE  # noqa: E402
from repro.serve import wire as ref_wire  # noqa: E402
from repro.serve.pages import PageDirectory as RefDirectory  # noqa: E402
from repro.serve.pages import PageStore as RefStore  # noqa: E402
from repro_torch.serve import wire  # noqa: E402
from repro_torch.serve.pages import PageDirectory, PageStore  # noqa: E402

PKGS = {"ref": (REF, REF_SERVE, RefStore, RefDirectory),
        "port": (PORT, PORT_SERVE, PageStore, PageDirectory)}


def _cfg(pkg, **over):
    base = dict(sessions=16, rate=400.0, seed=11, slots_per_worker=32,
                deadline_s=45.0)
    base.update(over)
    return PKGS[pkg][1].ServeConfig(**base)


def _serve(pkg, ranks, **over):
    kw = {"device": "cpu"} if pkg == "port" else {}
    return PKGS[pkg][1].run_serve(_cfg(pkg, **over), ranks=ranks, **kw)


def _threads(pkg, n, prog, **kw):
    if pkg == "port":
        kw["device"] = "cpu"
    return PKGS[pkg][0].run_threads(n, prog, **kw)


def _check_accounting(reports):
    """The zero-receiver-drain contract, exact to the byte
    (``benchmarks/serve_qps.check_copy_accounting``)."""
    router, workers = reports[0], reports[1:]
    rd = router["stats_delta"]["path_copied_bytes"]
    for path in ("rma_put", "rma_get", "rma_notify", "rma_coll",
                 "rndv_staged", "rndv_posted"):
        assert rd.get(path, 0) == 0, (path, rd)
    for w in workers:
        d = w["stats_delta"]["path_copied_bytes"]
        racc = 8 * w["racc_calls"]
        assert d.get("rma_put", 0) == w["rput_bytes"] + racc
        assert d.get("rma_get", 0) == w["rget_bytes"] + racc
        assert d.get("rndv_staged", 0) == d.get("rndv_posted", 0) == 0
        assert w["verify_failures"] == 0
    assert router["bad_checksums"] == 0


def _serve_both(ranks, **over):
    """Both packages on one config: the same sessions, tokens and
    raccumulated token total, and the copy contract in each."""
    ref, port = _serve("ref", ranks, **over), _serve("port", ranks, **over)
    for reports in (ref, port):
        _check_accounting(reports)
    for key in ("sessions", "tokens", "stats_tokens"):
        assert port[0][key] == ref[0][key], key
    return ref, port


class TestServeSmoke:
    def test_all_sessions_complete_and_verify(self):
        ref, port = _serve_both(3)
        for reports in (ref, port):
            router, workers = reports[0], reports[1:]
            assert router["sessions"] == 16
            assert sum(w["served"] for w in workers) == 16
            assert router["p99_us"] >= router["p50_us"] > 0

    def test_raccumulated_token_total_matches_done_frames(self):
        ref, port = _serve_both(3, sessions=20, stats_interval=2)
        assert port[0]["stats_tokens"] == port[0]["tokens"] > 0

    def test_deterministic_session_content(self):
        a = _serve("port", 3)[0]
        b = _serve("port", 3)[0]
        assert (a["tokens"], a["sessions"]) == (b["tokens"], b["sessions"])

    def test_continuous_batching_overlaps_sessions(self):
        over = dict(sessions=8, rate=10_000.0, max_batch=4, prompt_min=16,
                    prompt_max=16, gen_min=16, gen_max=16)
        for reports in _serve_both(2, **over):
            w = reports[1]
            assert w["served"] == 8
            # 8 x 16 decode steps serially = 128; width-4 batching needs
            # ~2 waves of 16 plus slack
            assert w["busy_steps"] < 100


class TestZeroReceiverDrain:
    def test_page_moves_land_only_in_rma_buckets(self):
        _serve_both(3, sessions=12)

    @pytest.mark.parametrize("pkg", ["ref", "port"])
    def test_passive_page_home_copies_nothing(self, pkg):
        """A rank that merely HOMES pages while a peer fills and drains
        them executes no counted copy (uint8 tensors on the port)."""
        store_cls, dir_cls = PKGS[pkg][2:]

        def prog(env):
            comm = env.comm
            win = comm.win_create_dynamic("pp", attach_slots=8)
            store = store_cls(comm, win, 4, 4096)
            directory = dir_cls(comm, store)
            out = None
            if env.rank == 2:
                before = comm.arena.view.stats.snapshot()
                win.wait_notify(1, timeout=30.0)    # peer's traffic done
                d = comm.arena.view.stats.delta(before)
                out = (d["copies"], d["copied_bytes"])
            elif env.rank == 1:
                src = np.arange(4096, dtype=np.uint8)
                dst = np.zeros(4096, np.uint8)
                if pkg == "port":
                    src, dst = torch.from_numpy(src), torch.from_numpy(dst)
                for slot in range(4):
                    addr = directory.addr(2, slot)
                    win.rput(2, addr, src).wait()
                    win.rget(2, addr, dst).wait()
                    assert bytes(np.asarray(dst)) == bytes(np.asarray(src))
                win.notify(2)
            comm.barrier()
            store.free()
            win.free()
            return out

        assert _threads(pkg, 3, prog, pool_bytes=16 << 20,
                        timeout=60)[2] == (0, 0)


class TestWorkerDeath:
    @pytest.mark.parametrize("pkg", ["ref", "port"])
    def test_worker_dies_mid_decode_sessions_reroute(self, pkg):
        """One worker fail-stops mid-decode; the router retires it,
        re-routes its sessions under a bumped epoch and finishes the
        population with correct checksums; the comm survives for every
        rank. ``stats_tokens`` depends on when the worker died, so only
        its bound is asserted, in each package.

        Arrivals come at 50/s (``tests/test_serve.py``: 400/s), so that
        they outlast the doomed worker's 25 steps on a loaded host: at
        400/s all 16 sessions could be served before its 25th step, and
        it then died idle and was never retired."""
        cfg = _cfg(pkg, sessions=16, rate=50.0, worker_timeout=0.8,
                   fail_rank=1, fail_after_steps=25, decode_us=300.0)
        serve_rank = PKGS[pkg][1].serve_rank

        def prog(env):
            report = serve_rank(env, cfg)
            assert not env.comm._mb_records
            assert not any(env.comm._mb_overflow.values())
            out = env.comm.allreduce(np.full(8, float(env.rank + 1)))
            assert np.allclose(np.asarray(out), 1.0 + 2.0 + 3.0 + 4.0)
            return report

        reports = _threads(pkg, 4, prog,
                           pool_bytes=cfg.pool_bytes_needed(4), timeout=90)
        router, workers = reports[0], reports[1:]
        assert router["retired"] == [1]
        assert router["reroutes"] > 0
        assert reports[1]["aborted"]
        assert router["sessions"] == cfg.sessions
        assert router["bad_checksums"] == 0
        assert all(w["verify_failures"] == 0 for w in workers)
        assert sum(w["served"] for w in workers[1:]) > 0
        assert router["stats_tokens"] <= router["tokens"]

    @pytest.mark.parametrize("pkg", ["ref", "port"])
    def test_pages_homed_on_dead_rank_stay_readable(self, pkg):
        store_cls, dir_cls = PKGS[pkg][2:]

        def prog(env):
            comm = env.comm
            win = comm.win_create_dynamic("dd", attach_slots=4)
            store = store_cls(comm, win, 2, 1024)
            directory = dir_cls(comm, store)
            ok = True
            if env.rank == 1:
                store.write_local(0, np.full(1024, 7, np.uint8))
                win.notify(2)          # "filled" — then fail-stop
            if env.rank == 2:
                win.wait_notify(1, timeout=30.0)
                dst = np.zeros(1024, np.uint8)
                win.rget(1, directory.addr(1, 0), dst).wait()
                ok = bool((dst == 7).all())
            comm.barrier()
            store.free()
            win.free()
            return ok

        assert all(_threads(pkg, 3, prog, pool_bytes=16 << 20, timeout=60))


SAMPLES = [(0, 0), (3, 5), (17, 11), (1999, 0), (123456, 2 ** 40)]


class TestWire:
    def test_admit_roundtrip(self):
        pages = [wire.pack_page(2, 7), wire.pack_page(1, 31)]
        bufs = {}
        for mod in (ref_wire, wire):
            buf = np.zeros(mod.admit_words(4), np.int64)
            mod.encode_admit(buf, sid=9, epoch=2, prompt=16, gen=24,
                             pages=pages)
            assert wire.decode_admit(buf) == dict(
                sid=9, epoch=2, prompt=16, gen=24, pages=[(2, 7), (1, 31)])
            done = np.zeros(mod.DONE_WORDS, np.int64)
            mod.encode_done(done, 2, 9, 1, 30, 12345, 77)
            beat = np.zeros(mod.DONE_WORDS, np.int64)
            mod.encode_beat(beat, 3, 400, 81)
            stop = np.full(mod.admit_words(4), 5, np.int64)
            mod.encode_stop(stop)
            bufs[mod] = [b.tobytes() for b in (buf, done, beat, stop)]
        assert bufs[wire] == bufs[ref_wire]
        assert wire.decode_status(np.frombuffer(bufs[wire][1], np.int64)) \
            == ref_wire.decode_status(np.frombuffer(bufs[ref_wire][1],
                                                    np.int64))

    def test_session_checksum_matches_worker_fold(self):
        sid, prompt, gen, pt, pb, seed = 3, 10, 14, 16, 256, 5
        acc = 0
        for t in range(gen):
            acc = wire.fold(acc, wire.token(sid, prompt + t, seed))
        for p in range(wire.pages_for(prompt, gen, pt)):
            page = torch.from_numpy(wire.page_fill(sid, p, seed, pb))
            acc = wire.fold(acc, wire.page_checksum(page))
        assert acc == wire.session_checksum(sid, prompt, gen, pt, pb, seed)
        assert acc == ref_wire.session_checksum(sid, prompt, gen, pt, pb,
                                                seed)

    @pytest.mark.parametrize("sid,seed", SAMPLES)
    def test_content_matches_the_reference(self, sid, seed):
        for pos in (0, 1, 63, 4097):
            assert wire.token(sid, pos, seed) == ref_wire.token(sid, pos,
                                                                seed)
        for page, nbytes in ((0, 4096), (2, 512), (7, 1)):
            a = wire.page_fill(sid, page, seed, nbytes)
            assert a.tobytes() == ref_wire.page_fill(sid, page, seed,
                                                     nbytes).tobytes()
            want = ref_wire.page_checksum(a)
            assert wire.page_checksum(a) == want
            assert wire.page_checksum(torch.from_numpy(a)) == want
        assert wire.page_checksum(torch.full((4096,), 255,
                                             dtype=torch.uint8)) == \
            ref_wire.page_checksum(np.full(4096, 255, np.uint8))
        assert wire.session_checksum(sid, 10, 14, 16, 256, seed) == \
            ref_wire.session_checksum(sid, 10, 14, 16, 256, seed)

    def test_content_is_deterministic(self):
        assert wire.token(1, 2, 3) == wire.token(1, 2, 3)
        a = wire.page_fill(4, 5, 6, 512)
        b = wire.page_fill(4, 5, 6, 512)
        assert np.array_equal(a, b)
        assert not np.array_equal(a, wire.page_fill(4, 6, 6, 512))
