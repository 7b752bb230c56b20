"""Per cent of each rank's window spent inside the collective calls its
serve steps make on the DistContext's sub-communicators, averaged over
the ranks (spans of the benchmark's own wrappers)."""
from cmpibench import readings


def read(run):
    return readings.collective_share(run)
