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
