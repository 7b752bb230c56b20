"""flash_attention's share of its roofline, in per cent: the least time
of each traced call (the larger of its FLOPs over the bf16 peak and its
q, k, v and o bytes over HBM's rate, from the prefill's shape) over the
kernel's device time in the profiler's trace."""
from cmpibench import readings, yardstick


def read(run):
    t, n = readings.device_time(run, lambda name: "flash_fwd" in name)
    if not n:
        return None
    m, tr = run["config"], run["traffic"]
    rows = tr["rows"] // run["config"]["mesh"]["data"]
    h = m["num_attention_heads"]
    least = yardstick.flash_least_s(
        rows, h, m["num_key_value_heads"], tr["prompt_len"],
        m["hidden_size"] // h, 2 if m["compute_dtype"] == "bfloat16" else 4)
    return 100.0 * n * least / t
