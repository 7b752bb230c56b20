"""cellcopy's share of its roofline, in per cent: the least time of every
launch of the traced span (its bytes across PCIe once, at the link's
rate) over the kernel's device time in the profiler's trace."""
from cmpibench import readings, yardstick


def read(run):
    t, n = readings.device_time(run, lambda name: "cellcopy" in name)
    if not n:
        return None
    least = sum(yardstick.cellcopy_least_s(r.get("copy_bytes", 0))
                for r in run["reports"])
    return 100.0 * least / t
