"""What the CPU tests share besides the tiny checkout
(``tiny_cells.make_root``): the tiny granite's sizes, read from its tiny
form, and rank programs that fail or hang for the launcher's tests."""
from __future__ import annotations

from cmpibench.tests import tiny_cells

TINY_GRANITE = tiny_cells.forms("configs")["granite-tiny-f32"]["over"]


def failing_rank(env, spec):
    """A rank program whose rank 1 raises while rank 0 waits on it."""
    import time
    if env.rank == 1:
        raise ValueError("planted failure")
    time.sleep(120)
    return {}


def hanging_rank(env, spec):
    import time
    time.sleep(120)
    return {}
