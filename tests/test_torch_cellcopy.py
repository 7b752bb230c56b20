"""The port's cellcopy wrappers (plain PyTorch versions on the CPU) against
the JAX package's Pallas kernel in interpret mode: the same numpy inputs
through both, compared exactly (integers end to end)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.cellcopy.kernel import cellcopy as jax_cellcopy  # noqa: E402
from repro.kernels.cellcopy.ops import copy_message as jax_copy_message  # noqa: E402
from repro.kernels.cellcopy.ops import verify as jax_verify  # noqa: E402
from repro_torch.kernels.cellcopy import ops, ref  # noqa: E402

# the shapes of tests/test_kernels.py::TestCellcopy::test_sweep
SWEEP = [(8, 128, 2), (16, 256, 4), (32, 512, 8), (4, 1024, 4)]


def _u32(t) -> np.ndarray:
    return np.asarray(t).view(np.uint32) if isinstance(t, np.ndarray) \
        else t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("cells,words,block", SWEEP)
def test_cellcopy_matches_jax(cells, words, block, rng):
    src = rng.integers(-2**31, 2**31 - 1, size=(cells, words),
                       dtype=np.int32)
    jd, js = jax_cellcopy(jnp.asarray(src), block_cells=block)
    td, ts = ops.cellcopy(torch.from_numpy(src.copy()), block_cells=block)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(_u32(ts), np.asarray(js))
    assert ops.verify(td, ts)
    assert bool(jax_verify(jd, js))


@pytest.mark.parametrize("n,cell_bytes,block", [
    (123_457, 16384, 2), (123_457, 65536, 2), (1, 16384, 1),
    (4097, 4096, 1), (65536, 16384, 8)])
def test_copy_message_matches_jax(n, cell_bytes, block, rng):
    msg = rng.integers(0, 256, size=n, dtype=np.uint8)
    jo, js = jax_copy_message(msg, cell_bytes=cell_bytes,
                              block_cells=block)
    to, ts = ops.copy_message(torch.from_numpy(msg.copy()),
                              cell_bytes=cell_bytes, block_cells=block)
    np.testing.assert_array_equal(to.numpy(), msg)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(_u32(ts), np.asarray(js))


@pytest.mark.parametrize("n", [1, 15, 17, 16383, 16385, 100_003])
@pytest.mark.parametrize("src_off,dst_off", [(0, 0), (1, 3), (3, 8),
                                             (8, 1)])
def test_copy_bytes_ref_sums_match_jax(n, src_off, dst_off, rng):
    """Byte-range copies at odd lengths and offsets: the bytes land, and
    the sums (relative to the message start, ragged tail zero-padded)
    are the ones the JAX package's copy_message gives."""
    cb = 16384
    big = torch.from_numpy(rng.integers(0, 256, size=n + 16,
                                        dtype=np.uint8))
    src = big[src_off:src_off + n]
    buf = torch.zeros(n + 16, dtype=torch.uint8)
    dst = buf[dst_off:dst_off + n]
    sums = ref.copy_bytes_ref(dst, src, cb)
    assert torch.equal(dst, src)
    assert int(buf[:dst_off].sum()) == 0 and int(buf[dst_off + n:].sum()) == 0
    _, js = jax_copy_message(src.numpy(), cell_bytes=cb, block_cells=1)
    np.testing.assert_array_equal(_u32(sums), np.asarray(js))
    got = ops.copy_into(torch.zeros(n, dtype=torch.uint8), src, cb)
    np.testing.assert_array_equal(_u32(got), np.asarray(js))


def test_corrupted_cell_is_caught(rng):
    src = torch.from_numpy(rng.integers(0, 100, size=(8, 128),
                                        dtype=np.int32))
    dst, sums = ops.cellcopy(src, block_cells=2)
    assert ops.verify(dst, sums)
    dst[3, 5] += 1
    assert not ops.verify(dst, sums)


def test_cellcopy_rejects_what_the_tpu_kernel_rejects():
    with pytest.raises(ValueError):
        ops.cellcopy(torch.zeros((8, 100), dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.cellcopy(torch.zeros((6, 128), dtype=torch.int32), block_cells=4)
    assert ops.smem_bytes(8, 4096) == ops.smem_bytes(1, 128) > 0


# --- the kernel's launch plan: cells split across a thread-block cluster

# the byte-range sweep above, plus lengths at a slice's edges (4 KiB), a
# cell's (16 KiB) and one cell plus one slice
PLAN_LENGTHS = [1, 15, 17, 4095, 4096, 4097, 8191, 8193, 16368, 16383,
                16384, 16385, 16384 + 4096, 16384 + 4097, 100_003]
PLAN_OFFSETS = [(0, 0), (1, 3), (3, 8), (8, 1), (0, 8)]


def _rotl(words: np.ndarray, phase: int) -> np.ndarray:
    s = np.uint64(8 * phase)
    w = words.astype(np.uint64)
    return ((w << s) | (w >> (np.uint64(32) - s))) & np.uint64(0xFFFFFFFF)


def _partial(msg: np.ndarray, cta: dict) -> int:
    """One CTA's phase-weighted sum: a head or tail byte at message offset
    j adds byte << 8 (j % 4); a 16 B vector at offset o (o % 4 = the
    phase) adds each of its little-endian words rotated left by 8 (o % 4),
    as the kernel adds them."""
    acc = 0
    for part in ("head", "tail"):
        if cta[part]:
            lo, hi = cta[part]
            j = np.arange(lo, hi, dtype=np.uint64)
            acc += int((msg[lo:hi].astype(np.uint64)
                        << (np.uint64(8) * (j % np.uint64(4)))).sum())
    if cta["body"]:
        lo, hi = cta["body"]
        words = np.frombuffer(msg[lo:hi].tobytes(), dtype="<u4")
        acc += int(_rotl(words, lo % 4).sum())
    return acc & 0xFFFFFFFF


def _check_plan(plan: dict, n: int, cb: int, dst_off: int) -> None:
    """Every byte copied once; each CTA's bytes inside its own cell; a
    cell's CTAs one cluster; vectors on 16 B destination boundaries;
    the head only on rank 0, the tail only on the last rank."""
    k = plan["cluster"]
    assert plan["grid"] == len(plan["ctas"]) == k * -(-n // cb)
    assert 1 <= k <= ops.MAX_CLUSTER and plan["threads"] == ops.THREADS
    seen = np.zeros(n, dtype=np.int64)
    for idx, cta in enumerate(plan["ctas"]):
        c = cta["cell"]
        assert idx // k == c and idx % k == cta["rank"]
        for part in ("head", "body", "tail"):
            if cta[part]:
                lo, hi = cta[part]
                assert c * cb <= lo < hi <= min((c + 1) * cb, n)
                seen[lo:hi] += 1
        if cta["body"]:
            lo, hi = cta["body"]
            assert (dst_off + lo) % 16 == 0 and (hi - lo) % 16 == 0
        assert cta["head"] is None or cta["rank"] == 0
        assert cta["tail"] is None or cta["rank"] == k - 1
        if cta["head"]:
            assert cta["head"][1] - cta["head"][0] < 16
        if cta["tail"]:
            assert cta["tail"][1] - cta["tail"][0] < 16
    np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("n", PLAN_LENGTHS)
@pytest.mark.parametrize("src_off,dst_off", PLAN_OFFSETS)
def test_launch_plan_partials_add_up_to_jax_sums(n, src_off, dst_off, rng):
    """The kernel's split of a message over clusters, at any length and
    alignment: each byte once, each cell in one cluster, and the CTAs'
    phase-weighted partial sums add up, per cell, to the sums of the JAX
    package's copy_message (Pallas kernel in interpret mode)."""
    cb = 16384
    msg = rng.integers(0, 256, size=n, dtype=np.uint8)
    plan = ops.launch_plan(n, cb, dst_off, src_off)
    _check_plan(plan, n, cb, dst_off)
    sums = np.zeros(-(-n // cb), dtype=np.uint64)
    for cta in plan["ctas"]:
        sums[cta["cell"]] += _partial(msg, cta)
        if cta["body"]:                  # the source's offset in a vector
            assert cta["shift"] == (src_off + cta["body"][0]) % 16
    _, js = jax_copy_message(msg, cell_bytes=cb, block_cells=1)
    np.testing.assert_array_equal(sums & 0xFFFFFFFF, np.asarray(js))


@pytest.mark.parametrize("n,cb", [(65535, 65536), (65537, 65536),
                                  (65536 + 8193, 65536), (8191, 65536),
                                  (123_457, 65536), (4097, 4096),
                                  (1300, 512)])
def test_launch_plan_other_cell_sizes(n, cb, rng):
    """64 KiB cells (8 CTAs of 8 KiB, two vectors a thread), 4 KiB cells
    and the 512-byte cells of the JAX API's shapes: the same covering and
    sums."""
    msg = rng.integers(0, 256, size=n, dtype=np.uint8)
    for src_off, dst_off in ((0, 0), (3, 8)):
        plan = ops.launch_plan(n, cb, dst_off, src_off)
        _check_plan(plan, n, cb, dst_off)
        sums = np.zeros(-(-n // cb), dtype=np.uint64)
        for cta in plan["ctas"]:
            sums[cta["cell"]] += _partial(msg, cta)
        _, js = jax_copy_message(msg, cell_bytes=cb, block_cells=1)
        np.testing.assert_array_equal(sums & 0xFFFFFFFF, np.asarray(js))


@pytest.mark.parametrize("n,cb,cluster,grid", [
    (16368, 16384, 4, 4),              # an eager cell: 4 SMs
    (1 << 20, 16384, 4, 256),          # 1 MiB: 256 CTAs on 132 SMs
    (8 << 20, 65536, 8, 1024),         # 64 KiB cells: clusters of 8
    (8, 16384, 1, 1),                  # a small message: one CTA
    (4097, 16384, 2, 2),
    (8 * 128 * 4, 512, 1, 8)])         # cellcopy's 8 x 128-word cells
def test_grid_follows_the_bytes(n, cb, cluster, grid):
    assert ops.cluster_size(n, cb) == cluster
    plan = ops.launch_plan(n, cb)
    assert (plan["cluster"], plan["grid"]) == (cluster, grid)
    assert plan["smem_bytes"] == ops.smem_bytes(8, 128) == 4 * (8 + 8)


class _FakeLibrary:
    """Stands in for the CUDA library: records what the wrapper would
    hand the kernel and launches nothing."""

    def __init__(self):
        self.calls = []

    def cellcopy_bytes(self, *args):
        self.calls.append([a.value if hasattr(a, "value") else a
                           for a in args])
        return 0


@pytest.mark.parametrize("n,cb,src_off,dst_off", [
    (16368, 16384, 0, 8), (1 << 20, 16384, 0, 0), (100_003, 65536, 3, 1),
    (8, 16384, 1, 3)])
def test_launch_arguments(n, cb, src_off, dst_off, monkeypatch):
    """What copy_bytes (the data plane's call) passes the kernel library
    on the card route: the two addresses as given, the byte count, the
    cell size, the sums scratch, PyTorch's current stream, one launch per
    call; and the launch the kernel makes of it: grid, cluster and shared
    memory (static only, no dynamic shared memory; a byte range has no
    strides)."""
    import types

    from repro_torch.kernels import build
    lib = _FakeLibrary()
    stream = 0x5EED0
    scratch = torch.zeros(2048, dtype=torch.uint32)
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(ops, "_LIB", None)
    monkeypatch.setattr(ops, "_scratch_sums", lambda n_cells: scratch)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=stream))
    dst, src = 0x7000_0000 + dst_off, 0x9000_0000 + src_off
    launches = ops.LAUNCHES
    ops.copy_bytes(dst, src, n, cb, None)
    assert ops.LAUNCHES == launches + 1
    assert lib.calls == [[dst, src, n, cb, 1, scratch.data_ptr(), stream]]
    plan = ops.launch_plan(n, cb, dst % 16, src % 16)
    k = ops.cluster_size(n, cb)
    assert plan["grid"] == k * -(-n // cb) and plan["cluster"] == k
    assert plan["grid"] % plan["cluster"] == 0
    assert plan["threads"] == 256 and plan["smem_bytes"] == 64
    ops.copy_bytes(dst, src, 0, cb, None)            # nothing to copy
    assert ops.LAUNCHES == launches + 1 and len(lib.calls) == 1
