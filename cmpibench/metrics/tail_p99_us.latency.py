"""99th percentile of the half round trips of every round trip of the
traced run's window (rank 0's host clock), in microseconds. It is read
with the profiler on, so it lies above an untraced run's tail; the
untraced tail spreads too widely from run to run to hold a bound
(PERF.md section 2)."""
from cmpibench import yardstick


def read(run):
    lat = run["reports"][0].get("latency_s")
    return yardstick.percentile(lat, 99) * 1e6 if lat else None
