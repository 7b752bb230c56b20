"""Pools and the coherence protocol, port against the JAX package: the
same sequence of ``write_release`` / ``read_acquire(_into)`` / ``nt_*``
operations, drawn from a numpy seed, on both packages' views over a
coherent and an incoherent pool gives identical pool bytes, identical
reads and identical ``ProtocolStats`` snapshots."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import coherence as ref_coh  # noqa: E402
from repro.core import pool as ref_pool  # noqa: E402
from repro_torch.core import coherence as port_coh  # noqa: E402
from repro_torch.core import pool as port_pool  # noqa: E402

POOL = 4096


def _views(pkg_pool, pkg_coh, incoherent: bool, n_ranks: int = 2):
    backing = pkg_pool.LocalPool(POOL)
    if not incoherent:
        return backing, [pkg_coh.CoherentView(backing, "coherent")
                         for _ in range(n_ranks)], []
    caches = [pkg_pool.RankCache(backing) for _ in range(n_ranks)]
    views = [pkg_coh.CoherentView(pkg_pool.IncoherentPool(backing, c),
                                  "incoherent") for c in caches]
    return backing, views, caches


def _script(seed: int, steps: int = 300):
    """A deterministic op sequence: (rank, op, off, arg)."""
    r = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        rank = int(r.integers(0, 2))
        kind = ["w", "wg", "r", "ri", "s64", "l64", "s8", "l8", "s32",
                "l32"][int(r.integers(0, 10))]
        n = int(r.integers(1, 200))
        off = int(r.integers(0, POOL - 256))
        if kind in ("w", "wg"):
            data = r.integers(0, 256, size=n, dtype=np.uint8)
            ops.append((rank, kind, off, data))
        elif kind in ("r", "ri"):
            ops.append((rank, kind, off, n))
        else:
            ops.append((rank, kind, off - off % 8,
                        int(r.integers(0, 2**32))))
    return ops


def _run(views, ops, as_host):
    out = []
    for rank, kind, off, arg in ops:
        v = views[rank]
        if kind == "w":
            v.write_release(off, as_host(arg))
        elif kind == "wg":
            h = len(arg) // 3
            out.append(v.write_release_gather(
                off, (as_host(arg[:h]), bytes(arg[h:2 * h]),
                      as_host(arg[2 * h:]))))
        elif kind == "r":
            out.append(bytes(v.read_acquire(off, arg)))
        elif kind == "ri":
            dst = bytearray(arg)
            out.append((v.read_acquire_into(off, dst), bytes(dst)))
        elif kind == "s64":
            v.nt_store_u64(off, arg)
        elif kind == "l64":
            out.append(v.nt_load_u64(off))
        elif kind == "s8":
            v.nt_store_u8(off, arg)
        elif kind == "l8":
            out.append(v.nt_load_u8(off))
        elif kind == "s32":
            v.nt_store_u32(off, arg)
        else:
            out.append(v.nt_load_u32(off))
    return out


def _bytes(pool) -> bytes:
    return pool.read(0, pool.size)


@pytest.mark.parametrize("incoherent", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_ops_same_pool_and_stats(incoherent, seed):
    ops = _script(seed)
    rb, rv, rc = _views(ref_pool, ref_coh, incoherent)
    pb, pv, pc = _views(port_pool, port_coh, incoherent)
    ref_out = _run(rv, ops, lambda a: a)
    # the port takes the same payloads as CPU tensors
    port_out = _run(pv, ops, lambda a: torch.from_numpy(a.copy()))
    assert port_out == ref_out
    if incoherent:
        for v in rv + pv:                 # write back every dirty line
            v.pool.flush(0, POOL)
    assert _bytes(pb) == _bytes(rb)
    for a, b in zip(rv, pv):
        assert b.stats.snapshot() == a.stats.snapshot()
    for a, b in zip(rc, pc):
        assert vars(b.stats) == vars(a.stats)


@pytest.mark.parametrize("make_dst", [
    lambda n: bytearray(n),
    lambda n: np.zeros(n, np.uint8),
    lambda n: torch.zeros(n, dtype=torch.uint8),
    lambda n: torch.zeros(n // 4, dtype=torch.int32),
])
def test_read_acquire_into_host_destinations(make_dst):
    """CPU tensors, numpy arrays and writable buffers take the host path
    and are counted exactly as the reference counts a bytearray."""
    n = 64
    data = np.arange(n, dtype=np.uint8)
    rv = ref_coh.CoherentView(ref_pool.LocalPool(256))
    pv = port_coh.CoherentView(port_pool.LocalPool(256))
    rv.write_release(8, data)
    pv.write_release(8, torch.from_numpy(data))
    want = bytearray(n)
    rv.read_acquire_into(8, want)
    dst = make_dst(n)
    assert pv.read_acquire_into(8, dst) == n
    got = bytes(dst) if not isinstance(dst, torch.Tensor) \
        else bytes(dst.view(torch.uint8).numpy())
    assert got == bytes(want)
    assert pv.stats.snapshot() == rv.stats.snapshot()


def test_pool_from_numpy_adopts_image():
    rp = ref_pool.LocalPool(1024)
    rp.write(100, bytes(range(200)))
    img = np.frombuffer(rp.buf, dtype=np.uint8)
    pp = port_pool.pool_from_numpy(img)
    assert isinstance(pp, port_pool.LocalPool)
    assert pp.size == rp.size and _bytes(pp) == _bytes(rp)
    pp.write(0, b"x")                    # a copy, not an alias
    assert rp.read(0, 1) == b"\0"


def test_memview_and_readinto_match_reference():
    rp, pp = ref_pool.LocalPool(512), port_pool.LocalPool(512)
    for p in (rp, pp):
        p.memview(10, 5)[:] = b"hello"
        p.write(40, np.arange(16, dtype=np.uint8))
    assert _bytes(pp) == _bytes(rp)
    a, b = bytearray(30), torch.zeros(30, dtype=torch.uint8)
    rp.readinto(10, a)
    pp.readinto(10, b)
    assert bytes(b.numpy()) == bytes(a)


def test_cpu_pool_has_no_device_view():
    with pytest.raises(TypeError):
        port_pool.LocalPool(64).device_view(0, 8)
    backing = port_pool.LocalPool(64)
    inc = port_pool.IncoherentPool(backing, port_pool.RankCache(backing))
    with pytest.raises(TypeError):
        inc.device_view(0, 8)
    with pytest.raises(TypeError):
        inc.memview(0, 8)
