"""Bytes every rank copied through the pool (ProtocolStats.copied_bytes)
over the tokens served in the same span, as ``tokens_per_s`` counts
them: prompt tokens too."""
from cmpibench import readings


def read(run):
    n = readings.tokens(readings.row_events(run, in_window=False),
                        prompt=True)
    return readings.counter(run, "copied") / n if n else None
