"""osu_latency: rank 0 sends a message of the plan's size and waits for
the same size back (blocking ``send`` and ``recv_into``); a sample is the
half round trip."""
from __future__ import annotations

import time

from cmpibench import generate
from cmpibench.systems import Window
from cmpibench.systems.osu import (DATA, STOP, Log, check, check_log,
                                   payload_on, send_src)

__all__ = ["rank_main", "check"]


def rank_main(env, spec: dict) -> dict:
    t, c, rank = spec["traffic"], env.comm, env.rank
    src = payload_on(env, spec)
    peer, fault = 1 - rank, spec.get("fault")
    plan = generate.MessagePlan(t, spec["seed"])
    log = Log(t, c.device, scratch_bytes=max(t["sizes"]))
    for s in t["sizes"]:                  # warm every size, both ways
        if rank == 0:
            c.send(peer, src[:s], tag=DATA)
            c.recv_into(peer, log.scratch[:s], tag=DATA)
        else:
            c.recv_into(peer, log.scratch[:s], tag=DATA)
            c.send(peer, src[:s], tag=DATA)
    w = Window(env, spec)
    spans = w.spans
    lat: list[float] = []
    sizes_bad = 0
    w.open()
    i = 0
    while True:
        size, _, _, kept = plan(i)
        drop = fault == "drop_half" and i % 2 == 1
        if rank == 0:
            if time.monotonic() >= w.t_end:
                c.send(peer, b"", tag=STOP)
                break
            x = send_src(src, plan, i, 0, fault)
            dst = log.place(i, size, kept, divert=drop)
            a = time.monotonic()
            c.send(peer, x, tag=DATA)
            b = time.monotonic()
            n, _ = c.recv_into(peer, dst, tag=DATA)
            e = time.monotonic()
            lat.append((e - a) / 2)
            if spans is not None:
                spans.add("send", w.to_ns(a), w.to_ns(b))
                spans.add("recv_into", w.to_ns(b), w.to_ns(e))
        else:
            dst = log.place(i, size, kept, divert=drop)
            a = time.monotonic()
            n, tag = c.recv_into(peer, dst, tag=-1)
            if tag == STOP:
                log.retract(i)
                break
            b = time.monotonic()
            c.send(peer, send_src(src, plan, i, 1, fault), tag=DATA)
            if spans is not None:
                e = time.monotonic()
                spans.add("recv_into", w.to_ns(a), w.to_ns(b))
                spans.add("send", w.to_ns(b), w.to_ns(e))
        sizes_bad += n != size
        i += 1
    w.close()
    # rank 1 received the pings (direction 0), rank 0 the pongs
    w.rep.update(loop="pingpong", messages_received=i, round_trips=i,
                 sizes_bad=sizes_bad,
                 check=check_log(spec, log, direction=1 - rank))
    if rank == 0:
        w.rep["latency_s"] = lat
    return w.rep
