"""Bytes both ranks copied through the pool (ProtocolStats.copied_bytes)
over the messages they received in the same span."""
from cmpibench import readings


def read(run):
    n = readings.messages(run)
    return readings.counter(run, "copied") / n if n else None
