"""Guards of the port: it imports neither JAX nor the JAX package, its
entry points run on the card unless told otherwise, and a tensor that is
not in host memory never takes a host path."""
import ast
import json
import subprocess
import sys
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
EXAMPLE_FILES = sorted((ROOT / "examples_torch").glob("*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + EXAMPLE_FILES


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
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")]
    assert not bad, f"{path.name} imports {bad}"


def test_import_check_covers_the_examples():
    """The six examples are among the files the import check reads,
    which also refuses ``benchmarks`` (the port keeps its own TCP
    ping-pong)."""
    assert [p.name for p in EXAMPLE_FILES] == sorted(
        p.name for p in (ROOT / "examples").glob("*.py"))
    assert len(EXAMPLE_FILES) == 6


@pytest.mark.parametrize("name", ["cmpi_pingpong", "comm_v2_tour",
                                  "rma_tour", "serve_decode", "quickstart"])
def test_examples_default_to_the_card(name, monkeypatch):
    """Each example but the host-only scaling study runs on the card
    unless ``--device cpu`` is given: here, with no card, it raises
    before it starts a process or trains a step."""
    _no_card()
    import importlib
    mod = importlib.import_module(f"examples_torch.{name}")
    argv = {"serve_decode": [], "quickstart": ["--steps", "1"]}.get(name, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    if name == "serve_decode":
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(["--ranks", "2", "--sessions", "2"])


def test_import_check_covers_windows_and_serving():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert "src/repro_torch/core/rma.py" in names
    assert {f"src/repro_torch/serve/{m}.py" for m in (
        "__init__", "wire", "pages", "router", "worker", "service")} <= names


def test_import_check_covers_the_distribution_layer():
    """The expert-parallel MoE, the sharding specs and the step functions
    are among the files the import check reads, and build no tensor on
    a device of their own: the specs live on the ``meta`` device."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/distributed/sharding.py",
            "src/repro_torch/distributed/context.py",
            "src/repro_torch/models/blocks.py",
            "src/repro_torch/train/steps.py"} <= names
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("granite-moe-1b-a400m")
    assert {t.device.type for t in lm.tree_leaves(lm.param_specs(cfg))} \
        == {t.device.type for t in lm.tree_leaves(
            lm.decode_state_specs(cfg, 2, 8))} == {"meta"}


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")


def test_import_check_covers_the_host_tools():
    """The perf model, the analysis passes, the dry run and the trace
    CLI are among the files the import check reads."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"src/repro_torch/perfmodel/{m}.py" for m in (
        "__init__", "interconnects", "simulator", "apps")} <= names
    assert {f"src/repro_torch/analysis/{m}.py" for m in (
        "__init__", "hlo", "verify", "lint_protocol")} <= names
    assert {f"src/repro_torch/launch/{m}.py" for m in (
        "dryrun", "mesh", "specs")} <= names
    assert "src/repro_torch/trace.py" in names


def test_meta_route_only_inside_the_counter():
    """Meta tensors reach a kernel's wrapper only inside
    ``analysis.hlo.count``, where the wrapper launches nothing; outside
    it they raise as before, and a CPU/meta mix raises inside it too."""
    from repro_torch import kernels
    from repro_torch.analysis import hlo
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv6 import ops as wk

    def meta(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    qkv = [meta(1, 2, 8, 32) for _ in range(3)]
    with pytest.raises(ValueError, match="meta"):
        fa.flash_attention(*qkv)
    before = (fa.LAUNCHES, wk.LAUNCHES, wk.BWD_LAUNCHES, ops.LAUNCHES)

    def calls():
        out = fa.flash_attention(*qkv)
        assert out.is_meta and out.shape == qkv[0].shape
        o = wk.wkv6(*(meta(1, 2, 4, 8) for _ in range(4)), meta(2, 8))
        assert o.is_meta and o.dtype == torch.float32
        dst, sums = ops.cellcopy(meta(8, 128, dtype=torch.int32))
        assert dst.is_meta and sums.shape == (8,)
        with pytest.raises(ValueError, match="meta"):
            fa.flash_attention(torch.zeros(1, 2, 8, 32), *qkv[1:])

    st = hlo.count(calls)
    assert (fa.LAUNCHES, wk.LAUNCHES, wk.BWD_LAUNCHES, ops.LAUNCHES) \
        == before
    assert {k: v["launches"] for k, v in st.kernels.items()} == {
        "flash_attention": 1, "wkv6": 1, "cellcopy": 1}
    assert kernels.COUNTERS == []
    with pytest.raises(ValueError, match="meta"):
        kernels.route("x", qkv[0])


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


def test_serving_tier_defaults_to_the_card():
    _no_card()
    from repro_torch.launch.serve import serve_distributed
    from repro_torch.serve import ServeConfig, run_serve
    with pytest.raises(RuntimeError, match="CUDA"):
        run_serve(ServeConfig(sessions=2), ranks=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_distributed(ranks=2, sessions=2, quiet=True)
    router = serve_distributed(ranks=2, sessions=2, rate=1000.0,
                               quiet=True, device="cpu")
    assert router["sessions"] == 2 and router["bad_checksums"] == 0


def test_serve_cli_takes_ranks_without_arch():
    """``--ranks`` runs the tier (on the card, so it raises here) and
    needs no ``--arch``; the single-process driver does."""
    _no_card()
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--ranks", "2", "--sessions", "2", "--rate", "100"])
    with pytest.raises(SystemExit):
        main([])


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


def test_model_kernels_refuse_a_device_tensor():
    """flash_attention, wkv6 and lm.prefill on a tensor off the CPU (meta
    stands in for the card here) raise instead of computing."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv6 import ops as wk
    from repro_torch.models import lm

    def meta(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="meta"):
        fa.flash_attention(meta(1, 2, 8, 32), meta(1, 2, 8, 32),
                           meta(1, 2, 8, 32))
    with pytest.raises(ValueError, match="meta"):
        fa.flash_attention_bshd(meta(1, 8, 2, 32), meta(1, 8, 2, 32),
                                meta(1, 8, 2, 32))
    with pytest.raises(ValueError, match="meta"):
        wk.wkv6(*(meta(1, 2, 4, 8) for _ in range(4)), meta(2, 8))
    for arch in ("llama3-8b", "rwkv6-3b"):
        cfg = get_config(arch).reduced()
        params = lm.init(cfg, device="meta")
        with pytest.raises(ValueError, match="meta"):
            lm.prefill(params, cfg, {"tokens": torch.zeros(
                (1, 8), dtype=torch.int32, device="meta")})


def test_model_entry_points_default_to_the_card():
    _no_card()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.decode_state_init(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_batch(cfg, batch=1, prompt_len=2, gen=1, quiet=True)


@pytest.mark.parametrize("kernel", ["flash_attention", "wkv6"])
def test_card_route_never_reaches_the_plain_version(kernel, monkeypatch):
    """With the route forced to the card, the wrapper goes to the kernel
    library (stubbed to raise, so nothing is built or launched) and never
    to ``ref``."""
    import importlib

    from repro_torch.kernels import build

    def no_library():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(build, "load", no_library)
    ops_ = importlib.import_module(
        f"repro_torch.kernels.{'rwkv6' if kernel == 'wkv6' else kernel}.ops")
    monkeypatch.setattr(ops_, "route", lambda name, *ts: "cuda")

    def plain(*a, **k):
        raise AssertionError("a card tensor reached the plain version")

    for name in dir(ops_.ref):
        if name.endswith("_ref"):
            monkeypatch.setattr(ops_.ref, name, plain)
    if kernel == "wkv6":
        calls = [lambda: ops_.wkv6(*(torch.zeros(1, 2, 4, 8)
                                     for _ in range(4)), torch.zeros(2, 8)),
                 lambda: ops_.wkv6_bshn(*(torch.zeros(1, 4, 2, 8)
                                          for _ in range(4)),
                                        torch.zeros(2, 8))]
    else:
        x = torch.zeros(1, 2, 8, 32)
        calls = [lambda: ops_.flash_attention(x, x, x),
                 lambda: ops_.flash_attention_bshd(x, x, x)]
    for call in calls:
        with pytest.raises(RuntimeError, match="kernel library requested"):
            call()


_LEFTOVERS = """
import json, multiprocessing as mp, os, sys, time
from multiprocessing import resource_tracker, shared_memory
sys.path.insert(0, sys.argv[1])
import chip_smoke
shm = shared_memory.SharedMemory(create=True, size=4096)  # starts the tracker
shm.close()
shm.unlink()
tracker = resource_tracker._resource_tracker._pid
rank = mp.get_context("fork").Process(target=time.sleep, args=(60,),
                                      daemon=True)
rank.start()
chip_smoke.stop_children()
try:
    os.kill(tracker, 0)
    tracker_gone = False
except ProcessLookupError:
    tracker_gone = True
print(json.dumps({"children": chip_smoke._children(),
                  "tracker_gone": tracker_gone,
                  "rank_exitcode": rank.exitcode}))
"""


def test_smoke_leaves_no_process_running():
    """chip_smoke.stop_children, which runs as the script exits, ends a
    rank left alive and the multiprocessing resource tracker and reaps
    both, so no process outlives the script."""
    out = subprocess.run([sys.executable, "-c", _LEFTOVERS, str(ROOT)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["children"] == [] and got["tracker_gone"], got
    assert got["rank_exitcode"] is not None, got
    assert "killing leftover" not in out.stderr, out.stderr
