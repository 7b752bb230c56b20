"""The whole serve step's share of the card's peak: model FLOPs of the
window's prefills and decode steps over the window's length times one
H100's dense bf16 peak, in per cent (``readings.mfu``)."""
from cmpibench import readings


def read(run):
    return readings.mfu(run)
