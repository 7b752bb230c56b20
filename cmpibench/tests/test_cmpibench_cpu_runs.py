"""Whole runs of the benchmark on the CPU at tiny sizes (the harness's
look for a chip skipped): every kind of cell comes out correct; the
program in f32 agrees with the plain reference; the control and every
planted fault a cell can have come out not correct; the launcher leaves
no rank process and no pool segment behind."""
import multiprocessing as mp
import os
import time

import pytest

from cmpibench import harness, launcher
from cmpibench.tests.tiny_cells import make_root

SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, **kw):
    kw.setdefault("trace", False)
    return harness.run_cell(cell, SEED, 1.0, kw.pop("trace"), device="cpu",
                            root=root, **kw)


@pytest.mark.parametrize("cell,trace", [
    ("osu.tiny-pingpong", False), ("osu.tiny-pingpong", True),
    ("osu.tiny-stream", False), ("osu.tiny-stream", True),
    ("granite.tiny-decode", False), ("granite.tiny-prefill", True)])
def test_tiny_cells_are_correct(root, cell, trace):
    out = run(root, cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]
    assert list(out)[-2:] == ["checks", "_detail"]


@pytest.mark.parametrize("cell", ["granite.tiny-decode",
                                  "granite.tiny-prefill"])
def test_program_in_f32_agrees_with_the_reference(root, cell):
    out = run(root, cell, config_over={"compute_dtype": "float32",
                                       "kv_cache_dtype": "float32"})
    d = out["_detail"]
    assert d["logit_err"] < 1e-5 and d["token_gap"] < 1e-5


@pytest.mark.parametrize("cell", ["granite.tiny-decode",
                                  "granite.tiny-prefill"])
def test_the_control_fails_a_number(root, cell):
    out = run(root, cell, control=True)
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0
    d, checks = out["_detail"], out["checks"]
    # the numbers compared are the control's, in the program's place
    assert all(checks[k]["value"] == d["control_" + k] for k in checks)
    assert any(checks[k]["value"] > checks[k]["limit"] for k in checks)


@pytest.mark.parametrize("cell,fault", [
    ("osu.tiny-pingpong", "alter"), ("osu.tiny-pingpong", "drop_half"),
    ("osu.tiny-stream", "alter"), ("osu.tiny-stream", "drop_half"),
    ("granite.tiny-decode", "alter"), ("granite.tiny-decode", "stale_state"),
    ("granite.tiny-decode", "no_exchange"),
    ("granite.tiny-decode", "half_batch"),
    ("granite.tiny-prefill", "alter"), ("granite.tiny-prefill", "no_exchange"),
    ("granite.tiny-prefill", "half_batch")])
def test_planted_faults_come_out_not_correct(root, cell, fault):
    out = run(root, cell, fault=fault)
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0


@pytest.mark.parametrize("target,err", [
    ("cmpibench.tests.cpu_cells:failing_rank", RuntimeError),
    ("cmpibench.tests.cpu_cells:hanging_rank", TimeoutError)])
def test_launcher_leaves_nothing_behind(target, err, monkeypatch):
    import repro_torch.core as core
    made = []

    class Recorded(core.SharedMemoryPool):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self.name)

    monkeypatch.setattr(core, "SharedMemoryPool", Recorded)
    t0 = time.monotonic()
    with pytest.raises(err):
        launcher.run_ranks(2, target, {}, pool_bytes=4 << 20,
                           comm_kw={"cell_size": 4096}, device="cpu",
                           timeout=20)
    assert time.monotonic() - t0 < 60
    assert not mp.active_children()
    assert made and not any(os.path.exists(f"/dev/shm/{n.lstrip('/')}")
                            for n in made)


@pytest.mark.parametrize("precision", ["fp8", "tf32"])
def test_the_controls_round_below_the_reference(precision):
    import torch

    from cmpibench.reference.granite import ROUND
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    err = ((ROUND[precision](x) - x).abs() / x.abs()).max()
    assert {"fp8": 2 ** -4, "tf32": 2 ** -11}[precision] * 0.5 < err \
        <= {"fp8": 2 ** -4, "tf32": 2 ** -11}[precision] * 1.01
