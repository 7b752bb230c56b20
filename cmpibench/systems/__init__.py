"""Rank programs: one package per kind of system a configuration names
(``"system"`` in its file; ``osu`` moves messages, ``ep_serve`` serves a
model expert-parallel), and in it one module per kind of mix (the mix's
``"loop"``). Each such module has ``rank_main(env, spec) -> dict`` (the
rank's report) and ``check(spec, reports, device) -> dict`` (the numbers
compared, after the ranks have ended). ``Window`` is what every rank
program does around its measured window."""
from __future__ import annotations

import time

from cmpibench.tracing import CopyBytes, DeviceTrace, Spans


class Window:
    """The measured window of one rank: opened after the warm-up by a
    barrier, ``seconds`` long on the rank's monotonic clock. In a traced
    run it also records host spans, the bytes ``cellcopy`` moves and the
    card's operations, from just before the barrier to ``close``."""

    def __init__(self, env, spec: dict):
        self.env = env
        self.seconds = float(spec["seconds"])
        self.cuda = env.comm.device.type == "cuda"
        self.trace = bool(spec["trace"])
        self.spans = Spans() if self.trace else None
        self.copy = CopyBytes() if self.trace and self.cuda else None
        self.dtrace = DeviceTrace(env.comm.device) if self.trace else None
        self.rep: dict = {"rank": env.rank}

    def open(self) -> None:
        from repro_torch.kernels.cellcopy import ops
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        if self.trace:
            if self.copy is not None:
                self.copy.install()
            self.dtrace.start()
        self.env.comm.barrier()
        self.t0 = time.monotonic()
        self.t0_ns = time.time_ns()
        self.t_end = self.t0 + self.seconds
        self._s0 = self.env.arena.view.stats.snapshot()
        self._l0 = ops.LAUNCHES

    def to_ns(self, t_mono: float) -> int:
        """A monotonic time of this rank on the epoch clock."""
        return self.t0_ns + int((t_mono - self.t0) * 1e9)

    def close(self) -> None:
        """End of the rank's work: counters read, trace stopped, the
        card's peak read before any check allocates."""
        from repro_torch.kernels.cellcopy import ops
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        t_close = time.monotonic()
        d = self.env.arena.view.stats.delta(self._s0)
        self.rep.update(
            t0=self.t0, t0_ns=self.t0_ns, seconds=self.seconds,
            t_close=t_close, copied=d["copied_bytes"],
            path_bytes=dict(d["path_copied_bytes"]),
            launches=ops.LAUNCHES - self._l0)
        if self.trace:
            self.dtrace.stop()
            if self.copy is not None:
                self.copy.remove()
                self.rep["copy_bytes"] = self.copy.nbytes
                self.rep["copy_launches"] = self.copy.launches
            self.rep["device_events"] = self.dtrace.events
            self.rep["trace_window_ns"] = self.dtrace.window
            self.rep["spans"] = self.spans.items
        if self.cuda:
            import torch
            self.rep["peak_bytes"] = torch.cuda.max_memory_allocated()
        else:
            self.rep["peak_bytes"] = 0
