"""One-sided latency over a shared window, as MPI one-sided programs use
it (a halo exchange by ``MPI_Put``, a PGAS runtime): rank 0 puts a
message of the plan's size from a CUDA tensor into rank 1's segment of
the window (``rput``, completed by ``flush``) and gets the same bytes
back into its log (``rget``, completed by the request's wait); a sample
is half of the put and the get. Rank 1 is the passive target: it takes
no part until rank 0 stops it."""
from __future__ import annotations

import time

from cmpibench import generate
from cmpibench.systems import Window
from cmpibench.systems.osu import (STOP, Log, check, check_log, payload_on,
                                   send_src)

__all__ = ["rank_main", "check"]


def rank_main(env, spec: dict) -> dict:
    import torch
    t, c, rank = spec["traffic"], env.comm, env.rank
    src = payload_on(env, spec)
    fault = spec.get("fault")
    plan = generate.MessagePlan(t, spec["seed"])
    big = max(t["sizes"])
    win = c.win_allocate("osu:rma", big)
    log = Log(t, c.device, scratch_bytes=big) if rank == 0 else None
    stop = torch.zeros(1, dtype=torch.uint8)
    if rank == 0:                             # warm every size, both ways
        for s in t["sizes"]:
            win.rput(1, 0, src[:s])
            win.flush(1)
            win.rget(1, 0, log.scratch[:s]).wait()
    win.fence()
    w = Window(env, spec)
    spans = w.spans
    lat: list[float] = []
    i = 0
    w.open()
    if rank == 0:
        while time.monotonic() < w.t_end:
            size, _, _, kept = plan(i)
            x = send_src(src, plan, i, 0, fault)
            dst = log.place(i, size, kept,
                            divert=fault == "drop_half" and i % 2 == 1)
            a = time.monotonic()
            win.rput(1, 0, x)
            win.flush(1)
            b = time.monotonic()
            win.rget(1, 0, dst).wait()
            e = time.monotonic()
            lat.append((e - a) / 2)
            if spans is not None:
                spans.add("rput+flush", w.to_ns(a), w.to_ns(b))
                spans.add("rget", w.to_ns(b), w.to_ns(e))
            i += 1
        c.send(1, b"", tag=STOP)
    else:
        c.recv_into(0, stop, tag=STOP, timeout=w.seconds + 120)
    w.close()
    win.free()
    w.rep.update(loop="rma", messages_received=i, round_trips=i,
                 sizes_bad=0)
    if rank == 0:
        w.rep["latency_s"] = lat
        w.rep["check"] = check_log(spec, log, direction=0)
    return w.rep
