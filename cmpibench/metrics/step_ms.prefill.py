"""Median wall time of rank 0's prefills within the window, in ms."""
from cmpibench import yardstick


def read(run):
    r = run["reports"][0]
    end = r["t0"] + r["seconds"]
    walls = [e[4] for e in r["events"]
             if e[0] == "prefill" and r["t0"] <= e[1] <= end]
    return yardstick.percentile(walls, 50) * 1e3 if walls else None
