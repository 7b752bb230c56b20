"""How a rank waits on the pool. Every blocking wait of ``core/`` is a
``spin`` over a readiness test, and every request is a ``Waitable``: the
wait policy (test, then the deadline, then ``time.sleep(0)``) and the
yields a traced wait counts on its span live here alone."""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.core.trace import NULL_TRACER

DEFAULT_TIMEOUT = object()      # sentinel: the request's own default


def spin(ready, timeout: float | None, what, tr=NULL_TRACER,
         span: int = -1) -> int:
    """Call ``ready()`` until it is true, yielding the CPU between
    tries; returns the yields. A failed try ``timeout`` seconds after
    entry (None: never) raises ``TimeoutError(what())``. While ``tr``
    records, the yields and tries are counted on ``span`` however the
    wait ends."""
    t0 = time.monotonic()
    n = 0
    try:
        while not ready():
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(what())
            time.sleep(0)
            n += 1
        return n
    finally:
        if tr.enabled and span >= 0:
            tr.add_waits(span, n, n + 1)


class Waitable:
    """A request. ``test()`` turns progress once and says whether it
    completed; ``done`` and ``error`` read its state without turning
    anything; ``wait()`` spins on ``test()`` and returns ``_outcome()``,
    or raises ``TimeoutError(_stuck())``."""

    default_timeout: float | None = 30.0
    _comm = None
    _span = -1        # the span a wait counts its yields on

    @property
    def done(self) -> bool:
        raise NotImplementedError

    @property
    def error(self) -> Optional[BaseException]:
        raise NotImplementedError

    def wait(self, timeout=DEFAULT_TIMEOUT):
        """Block until the request completes; returns its outcome.
        ``timeout`` in seconds (None: forever) defaults to
        ``default_timeout``."""
        if timeout is DEFAULT_TIMEOUT:
            timeout = self.default_timeout
        tr = NULL_TRACER if self._comm is None else self._comm.tracer
        spin(self.test, timeout, self._stuck, tr, self._span)
        return self._outcome()
