"""cellcopy launches (ops.LAUNCHES), both ranks, over the messages they
received in the same span."""
from cmpibench import readings


def read(run):
    n = readings.messages(run)
    return readings.counter(run, "launches") / n if n else None
