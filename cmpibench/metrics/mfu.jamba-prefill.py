"""The whole prefill's share of the card's peak for a Jamba-style hybrid:
the model FLOPs of the window's prefills (``hybrid_flops``, each data
row counted once) over the window's length times one H100's dense bf16
peak, in per cent."""
from cmpibench import hybrid_flops, readings, yardstick


def read(run):
    ev = [e for e in readings.row_events(run) if e[0] == "prefill"]
    if not ev or "router_experts" not in run["config"]:
        return None
    flops = sum(hybrid_flops.prefill_flops(run["config"], rows, pos)
                for _, _, rows, pos, _ in ev)
    return 100.0 * flops / (run["seconds"] * yardstick.PEAK_BF16_FLOPS)
