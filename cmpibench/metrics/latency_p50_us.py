"""Median half round trip over every round trip of the window (rank 0's
host clock), in microseconds."""
from cmpibench import yardstick


def read(run):
    lat = run["reports"][0].get("latency_s")
    return yardstick.percentile(lat, 50) * 1e6 if lat else None
