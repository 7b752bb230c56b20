"""Bytes every rank copied through the pool (ProtocolStats.copied_bytes)
over the tokens emitted in the same span, as ``gen_tokens_per_s`` counts
them."""
from cmpibench import readings


def read(run):
    n = readings.tokens(readings.row_events(run, in_window=False),
                        prompt=False)
    return readings.counter(run, "copied") / n if n else None
