"""Tokens the served model emitted within the window, over its length: a
prefill's first token when it completes, a decode step's tokens when it
does; each data row counted once. Prompt tokens are not counted: they
arrive a whole batch at a time, once in many seconds, and would make the
rate jump with the number of batches that begin in the window."""
from cmpibench import readings


def read(run):
    ev = readings.row_events(run)
    return readings.tokens(ev, prompt=False) / run["seconds"] if ev else None
