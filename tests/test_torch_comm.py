"""The same rank programs under both packages' ``run_threads``: pt2pt on
every path, the collectives and a persistent allreduce give exactly the
reference's results (every reduce is the same elementwise IEEE add in
the same schedule order), and ``ProtocolStats`` agree wherever the
reference treats them as deterministic — the 1 MiB copy budgets among
them. One test runs the port's ``run_processes`` (``spawn``)."""
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402

MiB = 1 << 20
POOL = 8 << 20
BUDGET = json.loads((Path(__file__).resolve().parents[1] / "artifacts"
                     / "bench" / "budget_copies.json").read_text())


class Ref:
    core = ref_core
    kw: dict = {}

    @staticmethod
    def arr(x: np.ndarray):
        return x.copy()

    @staticmethod
    def np(y) -> np.ndarray:
        return np.frombuffer(y, np.uint8) if isinstance(y, bytes) \
            else np.asarray(y)


class Port:
    core = port_core
    kw = {"device": "cpu"}

    @staticmethod
    def arr(x: np.ndarray):
        return torch.from_numpy(x.copy())

    @staticmethod
    def np(y) -> np.ndarray:
        assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
        return y.numpy()


def run(pkg, n, prog, pool_bytes=POOL, **kw):
    return pkg.core.run_threads(n, functools.partial(prog, pkg=pkg),
                                pool_bytes=pool_bytes, timeout=120,
                                **pkg.kw, **kw)


def both(n, prog, **kw):
    return run(Ref, n, prog, **kw), run(Port, n, prog, **kw)


def _data(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8)


# ---------------------------------------------------------------------------
# pt2pt: the three paths, forced as benchmarks/fig5_8_osu.run_protocols
# forces them, with each rank's ProtocolStats delta over the stream
# ---------------------------------------------------------------------------

def _stream(env, pkg, *, path, size, iters=3):
    c = env.comm
    c.eager_threshold = 1 << 40 if path == "eager" else 0
    src = pkg.arr(_data(size, 7))
    if path == "posted" and env.rank == 1:
        dst = c.alloc_buffer(size)
    else:
        dst = pkg.arr(np.zeros(size, np.uint8))
    c.barrier()
    st = env.arena.view.stats
    s0, hits0 = st.snapshot(), c.posted_sends
    for _ in range(iters):
        if env.rank == 0:
            c.recv(1, tag=2)                 # the receiver's credit
            c.send(1, src, tag=1)
        else:
            req = c.irecv_into(0, dst, tag=1)
            c.send(0, b"", tag=2)
            req.wait()
    delta = st.delta(s0)
    got = (bytes(dst.read()) if path == "posted" and env.rank == 1
           else pkg.np(dst).tobytes())
    c.barrier()
    return delta, c.posted_sends - hits0, got


@pytest.mark.parametrize("path,budget", [
    ("eager", "pt2pt_eager@1MiB"),
    ("rndv_staged", "pt2pt_rndv_staged@1MiB"),
    ("rndv_posted", "pt2pt_rndv_posted@1MiB")])
def test_pt2pt_paths_match_reference_and_budget(path, budget):
    iters = 3
    prog = functools.partial(_stream, path=path.replace("rndv_", ""),
                             size=MiB, iters=iters)
    ref, port = both(2, prog, cell_size=16384)
    assert port[1][2] == ref[1][2] == _data(MiB, 7).tobytes()
    for r in (0, 1):
        assert port[r][0]["path_copied_bytes"] == \
            ref[r][0]["path_copied_bytes"]
        assert port[r][1] == ref[r][1]       # posted hits
    copied = sum(port[r][0]["copied_bytes"] for r in (0, 1)) / iters
    want = BUDGET["copied_bytes_per_message"][budget]
    assert abs(copied - want) <= BUDGET["tolerance"] * want
    if path != "rndv_staged":                # staged churns the arena
        assert [p[0]["copied_bytes"] for p in port] == \
            [p[0]["copied_bytes"] for p in ref]
    if path == "rndv_posted":
        assert port[0][1] == iters


def _ring(env, pkg):
    """Each rank sends to its right neighbour on every path; recv()
    results, recv_into of tensors/arrays, tag reordering, self-send."""
    c, n, r = env.comm, env.size, env.rank
    out = []
    for size in (0, 5, 16384, 70_000):
        req = c.isend((r + 1) % n, pkg.arr(_data(size, r)), tag=3)
        got, tag = c.recv((r - 1) % n, tag=3)
        req.wait()
        out.append((pkg.np(got).tobytes(), tag))
    c.send((r + 1) % n, pkg.arr(_data(10, 1)), tag=8)
    c.send((r + 1) % n, pkg.arr(_data(10, 2)), tag=9)
    buf = pkg.arr(np.zeros(10, np.uint8))
    out.append(c.recv_into((r - 1) % n, buf, tag=9))
    out.append(pkg.np(buf).tobytes())
    out.append(pkg.np(c.recv((r - 1) % n, tag=8)[0]).tobytes())
    c.send(r, pkg.arr(_data(33, 3)), tag=4)
    out.append(pkg.np(c.recv(r, tag=4)[0]).tobytes())
    return out


@pytest.mark.parametrize("n,threshold", [(3, None), (4, 0), (2, 1 << 40)])
def test_pt2pt_ring_matches_reference(n, threshold):
    ref, port = both(n, _ring, eager_threshold=threshold)
    assert port == ref


def _registered(env, pkg, *, rounds=3):
    """Posted rendezvous into a registered user buffer (shadow drain on
    completion) and into a numpy array; the receiver posts first."""
    c, peer = env.comm, 1 - env.rank
    c.eager_threshold = 0
    n = 50_000
    dst = pkg.arr(np.zeros(n, np.uint8))
    reg = c.register(dst)
    arr = np.zeros(n, np.uint8)
    st = env.arena.view.stats
    s0, h0 = st.snapshot(), c.posted_sends
    got = []
    for i in range(rounds):
        if env.rank == 0:
            c.recv(1, tag=2)
            c.send(1, pkg.arr(_data(n, i)), tag=1)
            c.send(1, pkg.arr(_data(n, 10 + i)), tag=3)
        else:
            req = c.irecv_into(0, reg, tag=1)
            c.send(0, b"", tag=2)
            req.wait()
            c.recv_into(0, arr, tag=3)
            got.append((pkg.np(dst).tobytes(), arr.tobytes()))
    reg.free()
    delta = st.delta(s0)
    return got, c.posted_sends - h0, delta["path_copied_bytes"]


def test_registration_and_numpy_destinations_match_reference():
    ref, port = both(2, _registered)
    assert port == ref
    got, _, _ = port[1]
    assert got == [(_data(50_000, i).tobytes(),
                    _data(50_000, 10 + i).tobytes()) for i in range(3)]
    assert port[0][1] == 3                   # every registered receive hit


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _x(rank: int, count: int = 3000, dtype=np.float64) -> np.ndarray:
    return np.random.default_rng(100 + rank).standard_normal(count) \
        .astype(dtype)


def _allreduce(env, pkg, *, algo, dtype):
    out = env.comm.allreduce(pkg.arr(_x(env.rank, dtype=dtype)), algo=algo)
    return pkg.np(out).tobytes()


@pytest.mark.parametrize("n,algo,dtype", [
    (2, "rd", np.float64), (4, "rd", np.float32), (3, "ring", np.float64),
    (4, "ring", np.float32), (4, "hier", np.float64),
    (2, "auto", np.float64)])
def test_allreduce_matches_reference(n, algo, dtype):
    prog = functools.partial(_allreduce, algo=algo, dtype=dtype)
    ref, port = both(n, prog)
    assert port == ref
    assert len(set(port)) == 1               # every rank holds the result


# the direct two-rank sum (``collectives.allreduce_pair``): its cases
# run the port on a 2 MiB pool, whose lease cap (128 KiB) cuts the
# largest payload into 4 pieces, and the reference on a pool that takes
# every payload whole
SMALL_POOL = 2 << 20
EAGER = 4096                                 # run_threads' cell size


def _operand(rank: int, dtype: str, count: int, pkg):
    """A rank's operand: f64 or f32 normals, or f32 normals rounded to
    bf16 (the reference adds their f32 values)."""
    x = _x(rank, count, np.float64 if dtype == "f64" else np.float32)
    if dtype != "bf16":
        return pkg.arr(x)
    b = torch.from_numpy(x).to(torch.bfloat16)
    return b if pkg is Port else b.float().numpy()


def _direct_prog(env, pkg, *, dtype, count):
    c = env.comm
    x = _operand(env.rank, dtype, count, pkg)
    if pkg is Ref:
        return np.asarray(c.allreduce(x)).tobytes()
    st = env.arena.view.stats
    c.tracer.start()
    s0 = st.snapshot()
    auto = c.allreduce(x)
    moved = st.delta(s0)["path_copied_bytes"].get("coll_direct", 0)
    pieces = c.tracer.allreduce_direct
    ring = c.allreduce(x, algo="ring")
    return (auto.view(torch.uint8).numpy().tobytes(),
            ring.view(torch.uint8).numpy().tobytes(), pieces, moved)


@pytest.mark.parametrize("size", ["at_threshold", "above_threshold",
                                  "pieces"])
@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_two_rank_sum_is_the_rings_and_the_references(dtype, size):
    """A 2-rank ``auto`` allreduce is bitwise the reference's and the
    port's ``algo="ring"``: at the eager threshold (the ring's eager
    path), one element above it (the direct sum, whole) and above the
    lease cap (the direct sum in pieces, the last one ragged). Where the
    direct sum runs, ``allreduce_direct`` counts its pieces and the
    ``coll_direct`` path its bytes, once each."""
    item = 8 if dtype == "f64" else 4 if dtype == "f32" else 2
    cap = SMALL_POOL // 16
    count = {"at_threshold": EAGER // item,
             "above_threshold": EAGER // item + 1,
             "pieces": (3 * cap + 1000) // item + 7}[size]
    prog = functools.partial(_direct_prog, dtype=dtype, count=count)
    ref = run(Ref, 2, prog, pool_bytes=32 << 20)
    port = run(Port, 2, prog, pool_bytes=SMALL_POOL)
    want = ref[0]
    if dtype == "bf16":                  # the f32 sum, rounded to bf16
        want = torch.from_numpy(np.frombuffer(want, np.float32).copy()) \
            .to(torch.bfloat16).view(torch.uint8).numpy().tobytes()
    nbytes = count * item
    direct = nbytes > EAGER
    for auto, ring, pieces, moved in port:
        assert auto == ring == want
        assert pieces == (-(-nbytes // cap) if direct else 0)
        assert moved == (nbytes if direct else 0)
    assert ref[0] == ref[1]


def _back_to_back(env, pkg, *, rounds=50):
    """Allreduces of two sizes in turn, one above the lease cap; each
    round's sum is exact (integers), so a slot refilled while the peer
    still read it would show."""
    c, out = env.comm, []
    c.tracer.start()
    for i in range(rounds):
        m = 70_001 if i % 2 else 5_000
        x = torch.arange(m, dtype=torch.float32) % 251 + env.rank + i
        got = c.allreduce(x)
        out.append(torch.equal(
            got, 2 * (torch.arange(m, dtype=torch.float32) % 251) + 2 * i + 1))
    return out, c.tracer.allreduce_direct


def test_two_rank_sums_back_to_back_stay_exact():
    res = run(Port, 2, _back_to_back, pool_bytes=SMALL_POOL)
    for ok, pieces in res:
        assert all(ok)
        assert pieces == 25 * 1 + 25 * 3     # 70,001 f32: 3 pieces of 128 KiB


OPS = {"np.add": (np.add, np.add), "torch.add": (np.add, torch.add),
       "maximum": (np.maximum, torch.maximum)}   # (reference's, port's)


def _engaged(env, pkg, *, op, algo, count):
    c, x = env.comm, _x(env.rank, count)
    if pkg is Ref:
        return np.asarray(c.allreduce(x, op=OPS[op][0], algo=algo)).tobytes()
    c.tracer.start()
    st = env.arena.view.stats
    s0 = st.snapshot()
    got = c.allreduce(torch.from_numpy(x), op=OPS[op][1], algo=algo)
    return (got.numpy().tobytes(), c.tracer.allreduce_direct,
            st.delta(s0)["path_copied_bytes"].get("coll_direct", 0))


@pytest.mark.parametrize("n,op,algo,count,engaged", [
    (2, "np.add", "auto", 3000, True),
    (2, "torch.add", "auto", 3000, True),
    (3, "torch.add", "auto", 3000, False),
    (2, "maximum", "auto", 3000, False),
    (2, "torch.add", "auto", EAGER // 8, False),
    (2, "torch.add", "ring", 3000, False),
    (2, "torch.add", "rd", 3000, False)],
    ids=["np.add", "torch.add", "3_ranks", "maximum", "eager", "ring", "rd"])
def test_two_rank_sum_engages_only_for_pool_resident_sums(n, op, algo, count,
                                                           engaged):
    """The direct sum takes 2-rank sums above the eager threshold under
    ``auto`` alone: 3 ranks, a max, an eager payload and an explicit
    schedule run as before; every result is the reference's."""
    ref, port = both(n, functools.partial(_engaged, op=op, algo=algo,
                                          count=count))
    for want, (got, pieces, moved) in zip(ref, port):
        assert got == want
        assert (pieces, moved) == ((1, 8 * count) if engaged else (0, 0))


def _uneven_thresholds(env, pkg, *, first):
    """Each rank's own eager threshold set at run time, one above and
    one below the payload, before or after a first sum: the ranks still
    choose alike, since the direct sum reads the agreed threshold."""
    c, x = env.comm, _x(env.rank)
    if pkg is Port:
        x = torch.from_numpy(x)
        c.tracer.start()
    out = [c.allreduce(x)] if first else []
    c.eager_threshold = 1 << 40 if env.rank == 0 else 0
    out += [c.allreduce(x), c.allreduce(x)]
    sums = b"".join(np.asarray(o).tobytes() for o in out)
    return sums if pkg is Ref else (sums, c.tracer.allreduce_direct)


@pytest.mark.parametrize("first", [True, False],
                         ids=["after_a_sum", "before_any_sum"])
def test_two_rank_sum_choice_ignores_per_rank_thresholds(first):
    ref, port = both(2, functools.partial(_uneven_thresholds, first=first))
    pieces = {p for _, p in port}
    assert all(got == want for (got, _), want in zip(port, ref))
    # the agreed threshold is the ranks' largest at the first sum
    assert pieces == ({3} if first else {0})


def _collectives(env, pkg):
    c, r = env.comm, env.rank
    out = {}
    b = c.bcast(pkg.arr(_x(9).reshape(30, 100)) if r == 1 else None,
                root=1)
    out["bcast"] = (tuple(b.shape), pkg.np(b).tobytes())
    shard = pkg.arr(np.arange(5, dtype=np.int64) + 10 * r)
    out["ag_ring"] = pkg.np(c.allgather(shard, algo="ring")).tobytes()
    out["ag_bruck"] = pkg.np(c.allgather(shard, algo="bruck")).tobytes()
    out["rs"] = pkg.np(c.reduce_scatter(pkg.arr(_x(r, 1001)))).tobytes()
    red = c.reduce(pkg.arr(_x(r, 50)), root=0)
    out["reduce"] = None if red is None else pkg.np(red).tobytes()
    ib = pkg.arr(_x(5, 64) if r == 0 else np.zeros(64))
    c.ibcast(ib, root=0).wait()
    out["ibcast"] = pkg.np(ib).tobytes()
    return out


@pytest.mark.parametrize("n", [3, 4])
def test_collectives_match_reference(n):
    ref, port = both(n, _collectives)
    assert port == ref


def _bytes(pkg, y) -> bytes:
    return pkg.np(y).tobytes()


def _split_dup(env, pkg):
    c, r = env.comm, env.rank
    sub = c.split(r % 2, key=-r)             # reversed order in each half
    none = c.split(None if r == 0 else 1)
    d = c.dup()
    return (sub.size, sub.rank,
            _bytes(pkg, sub.allreduce(pkg.arr(_x(r, 700)))),
            none is None,
            _bytes(pkg, d.allreduce(pkg.arr(_x(r, 300)), algo="ring")),
            _bytes(pkg, c.allreduce(pkg.arr(_x(r, 300)), algo="ring")))


def _alltoall(env, pkg):
    c, r, n = env.comm, env.rank, env.size
    blocks = [pkg.arr(np.arange(9, dtype=np.int32) * 100 + 10 * r + j)
              for j in range(n)]
    return [_bytes(pkg, b) for b in c.alltoall(blocks)]


def _chunked(env, pkg):
    c, r = env.comm, env.rank
    return (_bytes(pkg, c.iallreduce(pkg.arr(_x(r)), chunk_bytes=4096)
                   .wait()),
            _bytes(pkg, c.iallreduce(pkg.arr(_x(r)), algo="ring",
                                     chunk_bytes="auto").wait()),
            _bytes(pkg, c.reduce_scatter(pkg.arr(_x(r, 1001)),
                                         chunk_bytes=2048)),
            _bytes(pkg, c.allgather(pkg.arr(_x(r, 1000)),
                                    chunk_bytes=1024)))


def _hier(env, pkg):
    return _bytes(pkg, env.comm.ihier_allreduce(
        pkg.arr(_x(env.rank, 2000)), group_size=2).wait())


def _persistent_bcast_allgather(env, pkg, *, rounds=3):
    c, r = env.comm, env.rank
    x = pkg.arr(np.zeros(500))
    breq = c.bcast_init(x, root=1)
    shard = pkg.arr(np.zeros(40, np.int64))
    greq = c.allgather_init(shard, algo="ring")
    outs = []
    for i in range(rounds):
        if r == 1:
            x[:] = pkg.arr(_x(i, 500))
        outs.append(_bytes(pkg, breq.start().wait()))
        shard[:] = pkg.arr(np.arange(40, dtype=np.int64) + 1000 * i + r)
        outs.append(_bytes(pkg, greq.start().wait()))
    breq.free()
    greq.free()
    return outs


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("prog", [_split_dup, _alltoall, _chunked, _hier,
                                  _persistent_bcast_allgather],
                         ids=lambda f: f.__name__.strip("_"))
def test_more_collectives_match_reference(prog, n):
    """Results only: which rank of a sub-communicator takes a
    rendezvous copy depends on timing, in both packages, so the
    per-rank ProtocolStats splits are not compared here."""
    ref, port = both(n, prog)
    assert port == ref


def _cancel(env, pkg):
    """A posted persistent receive cancelled and freed, then a plain
    exchange on the same pair still matches in order."""
    c, r = env.comm, env.rank
    out = []
    if r == 1:
        req = c.recv_init(0, pkg.arr(np.zeros(64, np.uint8)), tag=3)
        req.start()
        req.cancel()
        req.free()
        out.append(len(c._mb_records))
    c.barrier()
    if r == 0:
        c.send(1, pkg.arr(_data(64, 5)), tag=3)
    else:
        got = pkg.arr(np.zeros(64, np.uint8))
        c.recv_into(0, got, tag=3)
        out.append(_bytes(pkg, got))
    c.barrier()
    return out


def test_persistent_cancel_matches_reference():
    ref, port = both(2, _cancel)
    assert port == ref
    assert port[1] == [0, _data(64, 5).tobytes()]


def _retune(env, pkg, *, path):
    """``tuning="auto"`` without a profile, then ``retune`` on every rank
    once one exists: the status and the agreed constants."""
    c = env.comm
    before = dict(c.tuning_status)
    after = c.retune(path)
    out = _bytes(pkg, c.allreduce(pkg.arr(_x(env.rank, 40_000)),
                                  chunk_bytes="auto"))
    return before, after, c.eager_threshold, c._chunk_base, out


def test_retune_and_tuning_status_match_reference(tmp_path):
    from repro.core import profile as ref_prof
    path = ref_prof.write_profile(
        {"eager_crossover_bytes": 4096, "copy_knee_bytes": 256 * 1024,
         "best_chunk_bytes": 1 << 20, "cache_gbps": 80.0,
         "dram_gbps": 20.0, "strip_scan_us_per_slot": 2.5,
         "spill_promote_us": 20.0, "yield_cost_us": 0.5},
        tmp_path / "profile.json")
    kw = {"tuning": "auto", "profile_path": str(tmp_path / "missing.json")}
    prog = functools.partial(_retune, path=str(path))
    ref, port = both(3, prog, comm_kw=kw)
    assert port == ref
    before, after = port[0][:2]
    assert before["mode"] == "heuristic" and after["mode"] == "profile"


def _persistent(env, pkg, *, rounds=4):
    c = env.comm
    x = pkg.arr(np.zeros(MiB // 8))
    req = c.allreduce_init(x, algo="rd")
    st = env.arena.view.stats
    h0, r0, s0 = c.posted_sends, c.rndv_sends, st.snapshot()
    outs = []
    for i in range(rounds):
        x[:] = float(i + env.rank + 1)
        outs.append(float(req.start().wait()[0]))
    delta = st.delta(s0)
    req.free()
    return (outs, c.posted_sends - h0, c.rndv_sends - r0,
            delta["copied_bytes"] / rounds, delta["path_copied_bytes"],
            st.mb_capacity_misses)


def test_persistent_allreduce_matches_reference():
    # two iterations' 1 MiB slot sets per rank outgrow the 8 MiB pool
    ref, port = both(2, _persistent, comm_kw={"matchbox_slots": 8},
                     pool_bytes=32 << 20)
    assert port == ref
    outs, hits, rndv, copied, _, misses = port[0]
    assert outs == [2.0 * i + 3 for i in range(4)]
    assert hits == rndv > 0 and misses == 0     # 100% posted hits
    want = BUDGET["copied_bytes_per_message"][
        "collective_allreduce_persistent@1MiB_2p"]
    assert abs(copied - want) <= BUDGET["tolerance"] * want


# ---------------------------------------------------------------------------
# run_processes: real processes started with spawn
# ---------------------------------------------------------------------------

def _spawn_prog(env):
    c, peer = env.comm, 1 - env.rank
    x = torch.full((4096,), float(env.rank + 1))
    total = c.allreduce(x)
    c.send(peer, torch.arange(100_000, dtype=torch.int32), tag=1)
    got = torch.empty(100_000, dtype=torch.int32)
    c.recv_into(peer, got, tag=1)
    return (float(total[0]), bool(torch.equal(got, torch.arange(
        100_000, dtype=torch.int32))), str(c.device))


def test_run_processes_spawn_cpu():
    res = port_core.run_processes(2, _spawn_prog, pool_bytes=POOL,
                                  device="cpu", timeout=120)
    assert res == [(3.0, True, "cpu")] * 2


def _pieces_prog(env, sizes):
    """allreduce, reduce_scatter and allgather of integer-valued f32
    payloads (exact sums in any order) of ``sizes`` elements; the
    largest round buffer the comm leased, and its lease cap."""
    c, r = env.comm, env.rank
    a, rs, ag = (torch.arange(m, dtype=torch.float32) % 251 + r
                 for m in sizes)
    out = (c.allreduce(a).numpy(), c.reduce_scatter(rs).numpy(),
           c.allgather(ag).numpy())
    leased = max(pb.nbytes for bufs in c._rounds._free_sets
                 for pb in bufs.values())
    return out, leased, c.lease_cap, c._use_resident(4 * sizes[0])


def test_collectives_above_the_lease_cap_run_in_pieces():
    """A payload larger than ``lease_cap`` (an eighth of a rank's share
    of the pool: 64 KiB here) runs in pieces: the results equal those of
    a pool that takes each payload whole, and no round buffer the comm
    leases exceeds twice the cap."""
    n, sizes = 4, (70_001, 4 * 30_001 + 3, 30_001)
    small, whole = (port_core.run_threads(
        n, functools.partial(_pieces_prog, sizes=sizes), pool_bytes=pool,
        device="cpu", timeout=120) for pool in (2 * MiB, 64 * MiB))
    cap = small[0][2]
    assert cap == 64 << 10 and small[0][3]
    assert all(4 * m > cap for m in sizes[:2]) and 4 * n * sizes[2] > cap
    assert all(s[1] <= 2 * cap for s in small)
    assert all(w[1] > 2 * cap for w in whole)      # the whole payloads
    rows = -(-sizes[1] // n)
    padded = np.zeros(n * rows, np.float32)
    for rank, (got, want) in enumerate(zip(small, whole)):
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g, w)
        base = np.arange(max(sizes), dtype=np.float32) % 251
        np.testing.assert_array_equal(got[0][0], n * base[:sizes[0]]
                                      + sum(range(n)))
        padded[:sizes[1]] = n * base[:sizes[1]] + sum(range(n))
        chunk = (rank + 1) % n
        np.testing.assert_array_equal(
            got[0][1], padded[chunk * rows:(chunk + 1) * rows])
        np.testing.assert_array_equal(got[0][2], np.concatenate(
            [base[:sizes[2]] + k for k in range(n)]))


# the reference at the same input: 4 threads on a 2 MiB pool, an f32
# allreduce of 70,001 elements. It runs in a subprocess, whose exit ends
# the ranks that still spin when run_threads gives up on them.
_REF_ABOVE_CAP = """
import numpy as np
import repro.core as rc

def prog(env):
    x = np.arange(70_001, dtype=np.float32) % 251 + env.rank
    return env.comm.allreduce(x)

try:
    rc.run_threads(4, prog, pool_bytes=2 << 20, timeout=5)
    print("RAN")
except TimeoutError as e:
    print("TIMEOUT", e)
"""


def test_reference_fails_above_the_lease_cap():
    """Where the port runs in pieces (the test above), the reference's
    allreduce leases the whole payload: one rank raises ``ArenaFullError``
    ("heap exhausted") and the others never finish, so ``run_threads``
    times out. The port departs from it on purpose (``ROADMAP.md``
    Queue 3)."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", _REF_ABOVE_CAP],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("TIMEOUT"), out.stdout[-2000:]
    assert "ArenaFullError" in out.stdout
    assert "heap exhausted" in out.stdout
