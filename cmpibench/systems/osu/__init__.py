"""Two ranks moving CUDA tensors over the program's message plane, as the
OSU micro-benchmarks do. Each kind of mix (its ``"loop"``) is a module of
this package: ``pingpong`` (osu_latency), ``stream`` (osu_bw); a new kind
is a new module. In every one, each message lands in a CUDA tensor on the
receiving rank; those the check keeps land in a log of their own, which
the check compares, after the window, byte for byte with the seeded
payload (``generate``). What the loops share is here.
"""
from __future__ import annotations

import numpy as np

from cmpibench import generate

DATA, ACK, STOP = 1, 2, 9


def payload_on(env, spec: dict):
    """The run's seeded payload, on the rank's device."""
    import torch
    return torch.from_numpy(generate.payload(spec["traffic"],
                                             spec["seed"])).to(env.comm.device)


class Log:
    """Where each received message lands: the next aligned place of the
    log while it has room (the check reads those), else scratch."""

    def __init__(self, t: dict, device, *, scratch_bytes: int):
        import torch
        self.buf = torch.zeros(t["log_bytes"], dtype=torch.uint8,
                               device=device)
        self.scratch = torch.empty(scratch_bytes, dtype=torch.uint8,
                                   device=device)
        self.align = t["align"]
        self.pos = 0
        self.landed: list[tuple[int, int, int]] = []   # (index, pos, size)

    def place(self, i: int, size: int, keep: bool, slot: int = 0,
              divert: bool = False):
        """``divert``: a planted fault, the message lands in scratch
        though its place in the log is checked."""
        if keep and self.pos + size <= self.buf.numel():
            self.landed.append((i, self.pos, size))
            dst = self.buf[self.pos:self.pos + size]
            self.pos += -(-size // self.align) * self.align
            if not divert:
                return dst
        return self.scratch[slot:slot + size]

    def retract(self, i: int) -> None:
        """Message ``i`` never came (the stop came in its place)."""
        if self.landed and self.landed[-1][0] == i:
            self.pos = self.landed.pop()[1]


def send_src(src, plan, i: int, direction: int, fault):
    size, o0, o1, kept = plan(i)
    o = o0 if direction == 0 else o1
    x = src[o:o + size]
    if fault == "alter" and kept and i % 7 == 3:
        x = x.clone()
        x[size // 2] ^= 1                 # one bit of one byte, as sent
    return x


def check_log(spec: dict, log: Log, direction: int) -> dict:
    """Every logged message against the seeded payload, byte for byte."""
    if log is None:
        return {}
    t = spec["traffic"]
    if not log.landed:
        return {"checked": 0, "bad_messages": 0, "bad_bytes": 0}
    got = log.buf[:log.pos].cpu().numpy()
    src = generate.payload(t, spec["seed"])
    plan = generate.MessagePlan(t, spec["seed"])
    bad_msgs = bad_bytes = 0
    for i, pos, size in log.landed:
        _, o0, o1, _ = plan(i)
        o = o0 if direction == 0 else o1
        n = int(np.count_nonzero(got[pos:pos + size] != src[o:o + size]))
        bad_bytes += n
        bad_msgs += n > 0
    return {"checked": len(log.landed), "bad_messages": bad_msgs,
            "bad_bytes": bad_bytes}


def check(spec: dict, reports: list[dict], device, *,
          control: bool = False) -> dict:
    """The numbers compared: bytes that differ from the payload, messages
    that came with another size, and whether anything was checked. The
    configuration states no precision, so its control is a planted
    fault (``fault="alter"``), and ``control`` adds nothing here."""
    checked = sum(r.get("check", {}).get("checked", 0) for r in reports)
    bad = sum(r.get("check", {}).get("bad_bytes", 0) for r in reports)
    bad_msgs = sum(r.get("check", {}).get("bad_messages", 0)
                   for r in reports)
    sizes_bad = sum(r["sizes_bad"] for r in reports)
    received = sum(r["messages_received"] for r in reports)
    return {"numbers": {
                "bad_bytes": {"value": bad, "limit": 0},
                "bad_sizes": {"value": sizes_bad, "limit": 0},
                "unchecked": {"value": 0 if checked else 1, "limit": 0}},
            "attempted": received,
            "failed": bad_msgs + sizes_bad}
