"""Per cent of the traced window in which no rank's operation ran on the
card, every rank's profiler intervals merged on one clock."""
from cmpibench import readings


def read(run):
    return readings.idle_share(run)
