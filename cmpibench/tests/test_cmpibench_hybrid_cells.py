"""Whole runs of the cells added with the hybrid model, on the CPU at
tiny sizes (``tiny_cells``): the Jamba prefill cell and a decode mix of
the same system, and the one-sided loop, come out correct traced and
untraced; the control and every planted fault come out not correct."""
import pytest

from cmpibench import harness
from cmpibench.tests.tiny_cells import make_root

SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, trace=False, **kw):
    return harness.run_cell(cell, SEED, 1.0, trace, device="cpu",
                            root=root, **kw)


@pytest.mark.parametrize("cell,trace", [
    ("jamba.tiny-prefill", False), ("jamba.tiny-prefill", True),
    ("jamba.tiny-decode", False), ("osu.tiny-rma", False),
    ("osu.tiny-rma", True)])
def test_tiny_cells_are_correct(root, cell, trace):
    out = run(root, cell, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = ({"mamba_share.prefill", "mfu.jamba-prefill", "step_ms.prefill",
             "collective_share.prefill", "pool_bytes_per_token.prefill"}
            if cell.startswith("jamba") else {"tail_p99_us.latency"}) \
        if trace else ({"tokens_per_s", "setup_s"} if cell.startswith(
            "jamba") else {"latency_p50_us", "setup_s"})
    assert want <= set(out["metrics"])


def test_a_traced_run_carries_the_program_spans(root):
    out = run(root, "jamba.tiny-prefill", True)
    share = out["metrics"]["mamba_share.prefill"]["value"]
    assert 0 < share <= 100


@pytest.mark.parametrize("cell", ["jamba.tiny-prefill",
                                  "jamba.tiny-decode"])
def test_the_control_fails_a_number(root, cell):
    out = run(root, cell, control=True)
    assert not out["correct"], out["checks"]
    d, checks = out["_detail"], out["checks"]
    assert all(checks[k]["value"] == d["control_" + k] for k in checks)


@pytest.mark.parametrize("cell,fault", [
    ("jamba.tiny-prefill", "alter"), ("jamba.tiny-prefill", "no_exchange"),
    ("jamba.tiny-decode", "alter"), ("jamba.tiny-decode", "stale_state"),
    ("osu.tiny-rma", "alter"), ("osu.tiny-rma", "drop_half")])
def test_planted_faults_come_out_not_correct(root, cell, fault):
    out = run(root, cell, fault=fault)
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0
