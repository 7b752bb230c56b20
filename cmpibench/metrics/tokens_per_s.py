"""Tokens the served model took in or emitted within the window, over
its length: a prefill's prompt tokens and first token when it completes,
a decode step's tokens when it does; each data row counted once."""
from cmpibench import readings


def read(run):
    ev = readings.row_events(run)
    return readings.tokens(ev, prompt=True) / run["seconds"] if ev else None
