"""Guards of the port: it imports neither JAX nor the JAX package, its
entry points run on the card unless told otherwise, and a tensor that is
not in host memory never takes a host path."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (Comm, LocalPool, run_processes,  # noqa: E402
                              run_threads)
from repro_torch.core.arena import Arena  # noqa: E402
from repro_torch.core.coherence import CoherentView  # noqa: E402
from repro_torch.core.pool import IncoherentPool, RankCache  # noqa: E402
from repro_torch.kernels.cellcopy import ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")


def test_comm_defaults_to_the_card():
    _no_card()
    arena = Arena(LocalPool(4 << 20), 0, initialize=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Comm(arena, 0, 1)


def test_runtimes_default_to_the_card():
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_threads(2, lambda env: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_processes(2, print)


def _device_bytes(n: int) -> torch.Tensor:
    # a tensor that is not in host memory; with no card here the meta
    # device stands in for a CUDA tensor on the paths that must refuse it
    return torch.zeros(n, dtype=torch.uint8, device="meta")


def test_device_payload_on_incoherent_pool_raises():
    backing = LocalPool(4096)
    view = CoherentView(IncoherentPool(backing, RankCache(backing)),
                        "incoherent")
    with pytest.raises(TypeError):
        view.write_release(0, _device_bytes(64))
    with pytest.raises(TypeError):
        view.read_acquire_into(0, _device_bytes(64))
    with pytest.raises(TypeError):       # an unmapped pool refuses too
        CoherentView(LocalPool(4096)).write_release(0, _device_bytes(64))
    assert backing.read(0, 64) == bytes(64)


def test_kernel_wrappers_never_fall_back():
    """A tensor off the CPU goes to the kernel or raises: here, where
    there is no card, it raises."""
    d = _device_bytes(4096)
    with pytest.raises((ValueError, RuntimeError)):
        ops.copy_into(d, d)
    with pytest.raises((ValueError, RuntimeError)):
        ops.cellcopy(torch.zeros((8, 128), dtype=torch.int32,
                                 device="meta"))
    with pytest.raises(ValueError):     # mixed devices are refused
        ops.copy_into(torch.zeros(16, dtype=torch.uint8),
                      _device_bytes(16))
    launches = ops.LAUNCHES
    ops.copy_into(torch.zeros(16, dtype=torch.uint8),
                  torch.from_numpy(np.arange(16, dtype=np.uint8)))
    assert ops.LAUNCHES == launches      # the plain version is no launch
