"""The performance model (``repro_torch.perfmodel``) against the JAX
package's ``repro.perfmodel``: every fabric model, the coherence-mode
latencies, ``protocol_time`` over ``ProtocolStats`` that the same
operations produce in both packages, and the simulator's makespans of
the Fig-10 skeletons. The arithmetic is the same, so every float is
held with ``==``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import coherence as ref_coh  # noqa: E402
from repro.core import pool as ref_pool  # noqa: E402
from repro.perfmodel import apps as ref_apps  # noqa: E402
from repro.perfmodel import interconnects as ref_ic  # noqa: E402
from repro.perfmodel import simulator as ref_sim  # noqa: E402
from repro_torch import perfmodel  # noqa: E402
from repro_torch.core import coherence as port_coh  # noqa: E402
from repro_torch.core import pool as port_pool  # noqa: E402
from repro_torch.perfmodel import apps, interconnects as ic  # noqa: E402
from repro_torch.perfmodel import simulator as sim  # noqa: E402

# 1 B to 64 MiB: every power of two, and a ragged size between each
SIZES = sorted({1 << k for k in range(27)}
               | {(1 << k) + 3 * k + 1 for k in range(1, 26)})
PROCS = (1, 2, 8, 16, 32)
MODES = ("clflush", "clflushopt", "uncacheable", "cached")
RANKS = (2, 4, 8, 16, 64)


def test_public_names_match_the_reference():
    import repro.perfmodel as ref
    assert set(n for n in dir(ref) if not n.startswith("_")) <= set(
        dir(perfmodel))
    assert list(ic.INTERCONNECTS) == list(ref_ic.INTERCONNECTS)


@pytest.mark.parametrize("name", list(ref_ic.INTERCONNECTS))
def test_interconnect_models_equal(name):
    want, got = ref_ic.INTERCONNECTS[name], ic.INTERCONNECTS[name]
    assert vars(got) == vars(want)
    for size in SIZES:
        assert got.raw_latency(size) == want.raw_latency(size)
        for onesided in (True, False):
            for p in PROCS:
                assert got.mpi_latency(size, onesided=onesided, procs=p) \
                    == want.mpi_latency(size, onesided=onesided, procs=p)
                assert got.mpi_bandwidth(size, p, onesided=onesided) \
                    == want.mpi_bandwidth(size, p, onesided=onesided)


@pytest.mark.parametrize("mode", MODES)
def test_coherence_latency_equal(mode):
    for size in SIZES:
        assert ic.coherence_latency(size, mode) \
            == ref_ic.coherence_latency(size, mode)


def test_coherence_latency_unknown_mode_raises_as_the_reference():
    with pytest.raises(ValueError):
        ref_ic.coherence_latency(8, "wc")
    with pytest.raises(ValueError):
        ic.coherence_latency(8, "wc")


def _ops(seed: int, steps: int = 200):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        kind = ["w", "r", "s64", "l64"][int(r.integers(0, 4))]
        off = int(r.integers(0, 3000)) // 8 * 8
        if kind == "w":
            out.append((kind, off, r.integers(0, 256, size=int(
                r.integers(1, 300)), dtype=np.uint8)))
        elif kind == "r":
            out.append((kind, off, int(r.integers(1, 300))))
        else:
            out.append((kind, off, int(r.integers(0, 2**32))))
    return out


def _stats(pool_mod, coh_mod, incoherent: bool, ops, as_host):
    backing = pool_mod.LocalPool(4096)
    if incoherent:
        v = coh_mod.CoherentView(pool_mod.IncoherentPool(
            backing, pool_mod.RankCache(backing)), "incoherent")
    else:
        v = coh_mod.CoherentView(backing, "coherent")
    for kind, off, arg in ops:
        if kind == "w":
            v.write_release(off, as_host(arg))
        elif kind == "r":
            v.read_acquire(off, arg)
        elif kind == "s64":
            v.nt_store_u64(off, arg)
        else:
            v.nt_load_u64(off)
    return v.stats


@pytest.mark.parametrize("incoherent", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_protocol_time_equal_on_the_same_operations(incoherent, seed):
    ops = _ops(seed)
    want = _stats(ref_pool, ref_coh, incoherent, ops, lambda a: a)
    got = _stats(port_pool, port_coh, incoherent, ops,
                 lambda a: torch.from_numpy(a.copy()))
    assert isinstance(got, port_coh.ProtocolStats)
    assert got.snapshot() == want.snapshot()
    assert got.flush_lines or not incoherent
    for name in ref_ic.INTERCONNECTS:
        for mode in ("clflushopt", "clflush"):
            assert ic.protocol_time(got, ic.INTERCONNECTS[name], mode) \
                == ref_ic.protocol_time(want, ref_ic.INTERCONNECTS[name],
                                        mode)
    assert ic.protocol_time(got) == ref_ic.protocol_time(want)


@pytest.mark.parametrize("program", ["cg", "miniamr"])
@pytest.mark.parametrize("fabric", ["tcp_ethernet", "cxl_shm"])
def test_engine_makespans_equal(program, fabric):
    port_prog = {"cg": apps.cg_program,
                 "miniamr": apps.miniamr_program}[program]
    ref_prog = {"cg": ref_apps.cg_program,
                "miniamr": ref_apps.miniamr_program}[program]
    kw = {"iters": 10} if program == "cg" else {"steps": 12}
    for p in RANKS:
        got = sim.Engine(p, ic.INTERCONNECTS[fabric]).run(
            lambda r: port_prog(r, p, **kw))
        want = ref_sim.Engine(p, ref_ic.INTERCONNECTS[fabric]).run(
            lambda r: ref_prog(r, p, **kw))
        assert got == want
        assert got["total_s"] > 0


def test_engine_deadlock_raises_as_the_reference():
    def prog(r):
        yield ("recv", 1 - r, 8, 0)

    for mod, fab in ((sim, ic.CXL_SHM), (ref_sim, ref_ic.CXL_SHM)):
        with pytest.raises(RuntimeError, match="deadlock"):
            mod.Engine(2, fab).run(prog)
