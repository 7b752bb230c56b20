"""The metric arithmetic on inputs worked by hand."""
import importlib.util
from pathlib import Path

import pytest

from cmpibench import readings, yardstick

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_percentiles_over_every_sample():
    xs = list(range(1, 101))               # 1 .. 100
    assert yardstick.percentile(xs, 50) == pytest.approx(50.5)
    assert yardstick.percentile(xs, 99) == pytest.approx(99.01)
    assert yardstick.percentile([3.0], 99) == 3.0
    run = {"reports": [{"latency_s": [i * 1e-6 for i in xs]}]}
    assert reader("latency_p50_us")(run) == pytest.approx(50.5)
    assert reader("tail_p99_us.latency")(run) == pytest.approx(99.01)


def test_spread_is_the_quartiles_over_the_median():
    assert yardstick.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3)


def test_bandwidth_counts_windows_done_within_the_window():
    run = {"reports": [{}, {"t0": 100.0, "seconds": 10.0, "windows": [
        (101.0, 4_000_000), (109.9, 6_000_000), (110.0, 1_000_000),
        (110.5, 9_000_000)]}]}
    assert reader("bandwidth_MBps")(run) == pytest.approx(1.1)


def test_tokens_per_s_counts_prompt_tokens_at_their_prefill():
    ev = [("prefill", 1.0, 4, 512, 0.3), ("decode", 2.0, 4, 512, 0.2),
          ("decode", 12.0, 4, 513, 0.2)]
    run = {"seconds": 10.0, "reports": [
        {"leader": True, "t0": 0.5, "seconds": 10.0, "events": ev},
        {"leader": False, "t0": 0.5, "seconds": 10.0, "events": ev}]}
    # 4 x (512 + 1) at the prefill, 4 at the first decode step; the
    # second step ends after the window, the non-leader's not counted
    assert reader("tokens_per_s")(run) == pytest.approx(
        (4 * 513 + 4) / 10.0)
    # generated tokens alone: the prefill's first token and the step's
    assert reader("gen_tokens_per_s")(run) == pytest.approx((4 + 4) / 10.0)


def test_flash_work_and_roofline_by_hand():
    flops, nbytes = yardstick.flash_work(1, 16, 8, 4096, 64, 2)
    assert flops == 4 * 16 * 64 * 4096 * 4097 // 2
    assert nbytes == 2 * 64 * 4096 * (2 * 16 + 2 * 8)
    assert yardstick.flash_least_s(1, 16, 8, 4096, 64, 2) == \
        pytest.approx(flops / 989e12)


def test_cellcopy_least_time_is_the_bytes_over_pcie():
    assert yardstick.PCIE_BW == pytest.approx(63.015e9, rel=1e-4)
    assert yardstick.cellcopy_least_s(63_015_384_615) == \
        pytest.approx(1.0, rel=1e-6)


def test_model_flops_by_hand():
    m = {"hidden_size": 8, "num_attention_heads": 2,
         "num_key_value_heads": 1, "num_local_experts": 4,
         "num_experts_per_tok": 2, "intermediate_size": 3,
         "num_hidden_layers": 2, "vocab_size": 10}
    # per token and layer: qkv 2*8*(8+2*4)=256, o 2*8*8=128, router
    # 2*8*4=64, experts 2*2*3*8*3=288 -> 736
    per_tok = 736
    attn = 4 * 4 * 2 * 1 * 3 * 4 // 2            # 4 dh h rows s(s+1)/2
    assert yardstick.prefill_flops(m, 1, 3) == \
        2 * (3 * per_tok + attn) + 2 * 1 * 8 * 10
    attn_d = 4 * 4 * 2 * 2 * 6                   # rows 2, pos 5: 6 keys
    assert yardstick.decode_flops(m, 2, 5) == \
        2 * (2 * per_tok + attn_d) + 2 * 2 * 8 * 10


def test_mfu_is_window_flops_over_peak():
    m = {"hidden_size": 8, "num_attention_heads": 2,
         "num_key_value_heads": 1, "num_local_experts": 4,
         "num_experts_per_tok": 2, "intermediate_size": 3,
         "num_hidden_layers": 2, "vocab_size": 10}
    ev = [("prefill", 1.0, 1, 3, 0.1)]
    run = {"config": m, "seconds": 2.0, "reports": [
        {"leader": True, "t0": 0.0, "seconds": 2.0, "events": ev}]}
    want = 100 * yardstick.prefill_flops(m, 1, 3) / (2.0 * 989e12)
    assert reader("mfu.prefill")(run) == pytest.approx(want)
    assert reader("mfu.decode")(run) == pytest.approx(want)


def test_idle_share_merges_the_ranks_intervals():
    iv = [(0, 10), (5, 20), (30, 40), (35, 36), (90, 120)]
    assert yardstick.merge_intervals(iv) == [(0, 20), (30, 40), (90, 120)]
    assert yardstick.covered(yardstick.clip(iv, 0, 100)) == 40
    assert yardstick.gaps(iv, 0, 100) == [(20, 30), (40, 90)]
    from cmpibench.harness import merge_trace
    r0 = {"t0_ns": 0, "trace_window_ns": (0, 10 ** 9), "spans": [],
          "device_events": [("k", 0, 2 * 10 ** 8), ("c", 10 ** 8,
                                                     3 * 10 ** 8)]}
    r1 = {"t0_ns": 0, "trace_window_ns": (0, 10 ** 9), "spans": [],
          "device_events": [("k", 5 * 10 ** 8, 6 * 10 ** 8)]}
    t = merge_trace([r0, r1], 1.0)
    assert t["busy_s"] == pytest.approx(0.4)
    assert readings.idle_share({"trace": t}) == pytest.approx(60.0)
    assert t["breakdown"]["device_ops"][0] == ["k", pytest.approx(0.3)]


def test_clocks_that_disagree_are_refused():
    from cmpibench.harness import CellError, merge_trace
    r0 = {"t0_ns": 0, "trace_window_ns": (0, 10 ** 9), "spans": [],
          "device_events": [("k", 0, 10 ** 8)]}
    r1 = {"rank": 1, "t0_ns": 0, "trace_window_ns": (0, 10 ** 9),
          "spans": [], "device_events": [("k", 2 * 10 ** 9, 3 * 10 ** 9)]}
    with pytest.raises(CellError, match="rank 1"):
        merge_trace([r0, r1], 1.0)


def test_collective_share_clips_spans_to_the_window():
    r = {"t0_ns": 0, "seconds": 1.0, "spans": [
        ("collective:allreduce", 0, 2 * 10 ** 8),
        ("collective:allgather", 9 * 10 ** 8, 2 * 10 ** 9),
        ("decode_step", 0, 10 ** 9)]}
    assert readings.collective_share({"reports": [r, r]}) == \
        pytest.approx(30.0)
