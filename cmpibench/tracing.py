"""What a traced run (``--trace 1``) records inside a rank, from the
benchmark's own files: host spans around the calls into the program, the
bytes each ``cellcopy`` launch moves, and the card's kernels from
``torch.profiler``. Nothing here is installed in an untraced run.

Times are epoch nanoseconds (``time.time_ns``), the clock the profiler's
kineto events carry, so the ranks' kernels and spans lie on one clock.
"""
from __future__ import annotations

import time

COLLECTIVES = ("allreduce", "iallreduce", "allgather", "iallgather",
               "bcast", "ibcast", "reduce", "reduce_scatter",
               "ireduce_scatter", "alltoall", "barrier", "ibarrier")


class Spans:
    """Host spans ``(name, start_ns, end_ns)`` kept in memory."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    def add(self, name: str, t0: int, t1: int) -> None:
        self.items.append((name, t0, t1))


def wrap_collectives(comms, spans: Spans) -> None:
    """Time every collective call made on ``comms`` (instance attributes
    over the methods), outermost calls only: a collective that calls
    another on the same process is one span."""
    depth = [0]

    def wrap(name, fn):
        def timed(*a, **k):
            depth[0] += 1
            t0 = time.time_ns()
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    spans.add("collective:" + name, t0, time.time_ns())
        return timed

    for c in comms:
        for name in COLLECTIVES:
            if hasattr(c, name):
                setattr(c, name, wrap(name, getattr(c, name)))


class CopyBytes:
    """Counts the bytes of every ``cellcopy`` launch while installed over
    the kernel wrapper's ``copy_bytes`` (every caller looks it up on the
    module)."""

    def __init__(self):
        self.nbytes = 0
        self.launches = 0
        self._orig = None

    def install(self) -> None:
        from repro_torch.kernels.cellcopy import ops
        self._orig = orig = ops.copy_bytes

        def counted(dst_ptr, src_ptr, nbytes, *a, **k):
            self.nbytes += int(nbytes) if nbytes > 0 else 0
            self.launches += 1 if nbytes > 0 else 0
            return orig(dst_ptr, src_ptr, nbytes, *a, **k)

        ops.copy_bytes = counted

    def remove(self) -> None:
        from repro_torch.kernels.cellcopy import ops
        if self._orig is not None:
            ops.copy_bytes = self._orig
            self._orig = None


class DeviceTrace:
    """The card's operations (kernels, copies, fills) between ``start``
    and ``stop``, from ``torch.profiler``'s CUDA activity alone: the
    host's operators are not recorded, so the host pays little for it."""

    def __init__(self, device):
        self.on = getattr(device, "type", str(device)) == "cuda"
        self.prof = None
        self.events: list[tuple[str, int, int]] = []
        self.window: tuple[int, int] = (0, 0)

    def start(self) -> None:
        self.window = (time.time_ns(), 0)
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self) -> None:
        if self.prof is not None:
            import torch
            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.events = device_events(self.prof)
            self.prof = None
        self.window = (self.window[0], time.time_ns())


def device_events(prof) -> list[tuple[str, int, int]]:
    """``(name, start_ns, end_ns)`` of every operation the profiler saw on
    the card, on the epoch clock."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        s = int(e.start_ns())
        out.append((e.name(), s, s + int(e.duration_ns())))
    return out
