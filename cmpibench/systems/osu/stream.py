"""osu_bw: rank 1 posts ``irecv_into`` a window of messages at a time,
rank 0 streams them (``isend``, ``waitall``) and then waits for rank 1's
zero-byte acknowledgement, which also says when the window has ended."""
from __future__ import annotations

import time

from cmpibench import generate
from cmpibench.systems import Window
from cmpibench.systems.osu import (ACK, DATA, STOP, Log, check, check_log,
                                   payload_on, send_src)

__all__ = ["rank_main", "check"]


def rank_main(env, spec: dict) -> dict:
    import torch
    t, c, rank = spec["traffic"], env.comm, env.rank
    src = payload_on(env, spec)
    fault = spec.get("fault")
    plan = generate.MessagePlan(t, spec["seed"])
    win, big = t["window"], max(t["sizes"])
    log = Log(t, c.device, scratch_bytes=win * big) if rank == 1 else None
    ack = torch.zeros(1, dtype=torch.uint8)

    def post(i0: int) -> list:
        reqs = []
        for j in range(win):
            size, _, _, kept = plan(i0 + j)
            drop = fault == "drop_half" and (i0 + j) % 2 == 1
            dst = log.place(i0 + j, size, kept, j * big, divert=drop)
            reqs.append((size, c.irecv_into(0, dst, tag=DATA)))
        return reqs

    # warm every size once, in one window of the stream's own shape
    sizes = list(t["sizes"]) * -(-win // len(t["sizes"]))
    if rank == 0:
        c.waitall([c.isend(1, src[:s], tag=DATA) for s in sizes[:win]],
                  timeout=120)
        c.recv_into(1, ack, tag=ACK)
    else:
        reqs = [c.irecv_into(0, log.scratch[j * big:j * big + s], tag=DATA)
                for j, s in enumerate(sizes[:win])]
        c.waitall([r for r in reqs], timeout=120)
        c.send(0, b"", tag=ACK)
    w = Window(env, spec)
    spans = w.spans
    done: list[tuple[float, int]] = []      # (receiver's time, bytes)
    sizes_bad = 0
    i = 0
    w.open()
    if rank == 0:
        while True:
            a = time.monotonic()
            reqs = [c.isend(1, send_src(src, plan, i + j, 0, fault),
                            tag=DATA) for j in range(win)]
            c.waitall(reqs, timeout=120)
            b = time.monotonic()
            _, tag = c.recv_into(1, ack, tag=-1)
            if spans is not None:
                e = time.monotonic()
                spans.add("isend+waitall", w.to_ns(a), w.to_ns(b))
                spans.add("recv_ack", w.to_ns(b), w.to_ns(e))
            i += win
            if tag == STOP:
                break
    else:
        reqs = post(0)
        while True:
            a = time.monotonic()
            for size, r in reqs:
                r.wait(timeout=120)
                sizes_bad += r.nbytes != size
            now = time.monotonic()
            done.append((now, sum(size for size, _ in reqs)))
            if spans is not None:
                spans.add("waitall", w.to_ns(a), w.to_ns(time.monotonic()))
            i += win
            if now >= w.t_end:
                c.send(0, b"", tag=STOP)
                break
            reqs = post(i)
            c.send(0, b"", tag=ACK)
    w.close()
    w.rep.update(loop="stream", messages_received=i if rank == 1 else 0,
                 messages_sent=i if rank == 0 else 0, sizes_bad=sizes_bad)
    if rank == 1:
        w.rep["windows"] = done
        w.rep["check"] = check_log(spec, log, direction=0)
    return w.rep
