"""Requests in a closed loop, one in flight: the program's
``make_serve_prefill`` over a data rank's seeded prompts, filling a
fresh decode state as a prefill server does before it hands a request
to decode, and the greedy first token; where the mix has ``gen`` > 0,
that many greedy steps of ``make_serve_decode`` through that state, the
tokens allgathered over ``data`` between steps. After each request the
ranks agree whether the window has ended.

The model comes from the configuration's system package
(``systems/<system>/__init__.py``): its ``model_config``,
``program_params``, ``SPANS`` and ``COUNTERS``. Another hybrid system is
its own package and a ``serve.py`` that re-exports ``rank_main`` beside
its own ``check``.

In a traced run the program's tracer records for the window, and its
spans that the system names in ``SPANS`` join the window's spans on the
epoch clock, with its counters of ``COUNTERS`` in the report."""
from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from cmpibench import generate
from cmpibench.systems import Window
from cmpibench.systems.ep_serve import digest
from cmpibench.systems.hybrid_serve import check
from cmpibench.tracing import wrap_collectives

__all__ = ["rank_main", "check"]


def rank_main(env, spec: dict) -> dict:
    from repro_torch.configs import InputShape
    from repro_torch.distributed.context import DistContext
    from repro_torch.models import lm
    from repro_torch.train import steps as ST

    conf, t, seed = spec["config"], spec["traffic"], spec["seed"]
    fault = spec.get("fault")
    system = importlib.import_module(f"cmpibench.systems.{conf['system']}")
    cfg = system.model_config(conf)
    dev = env.comm.device
    mesh = conf["mesh"]
    dist = DistContext(env.comm, tuple(mesh.values()), tuple(mesh))
    params = system.program_params(conf, seed, dev,
                                   dist.axis_index("model"), dist.model_size)
    P, G, R = t["prompt_len"], t["gen"], t["rows"]
    b_loc = R // dist.dp_size
    pre = ST.make_serve_prefill(cfg, InputShape("p", "prefill", P, R), dist)
    dec = (ST.make_serve_decode(cfg, InputShape("d", "decode", P + G, R),
                                dist) if G else None)
    data = dist.comms["data"]
    if fault == "no_exchange":                # the MoE and vocab sums
        dist.comms["model"].allreduce = lambda x, *a, **k: x

    def serve(j: int, w, gen: int) -> dict:
        """Request ``j`` with ``gen`` decode steps; ``w`` the window
        (None: the warm-up)."""
        ids = generate.prompts(t, seed, j, cfg.vocab_size)
        toks = torch.from_numpy(ids).to(dev)
        a = time.monotonic()
        state = lm.decode_state_init(cfg, b_loc, P + G, device=dev)
        logits, state = pre.fn(params, {"tokens": toks}, state)
        tok = logits.argmax(-1).int()
        if fault == "alter" and not G:
            logits = logits.roll(1, -1)
            tok = (tok + 1) % cfg.vocab_size
        served, lg = [tok.cpu().numpy()], [logits.float().cpu().numpy()]
        b = time.monotonic()
        if w is not None:
            events.append(("prefill", b, b_loc, P, b - a))
            _span(w, "prefill", a, b)
        tok = data.allgather(tok)
        for i in range(gen):
            a = time.monotonic()
            pos = torch.full((R,), P + i, dtype=torch.int32, device=dev)
            if fault == "stale_state" and i == 0:
                state = lm.decode_state_init(cfg, b_loc, P + G, device=dev)
            logits, _ = dec.fn(params, state, {"tokens": tok[:, None]}, pos)
            if fault == "alter" and i == 1:
                logits = logits.roll(1, -1)
            local = logits.argmax(-1).int()
            served.append(local.cpu().numpy())
            lg.append(logits.float().cpu().numpy())
            b = time.monotonic()
            if w is not None:
                events.append(("decode", b, b_loc, P + i, b - a))
                _span(w, "decode_step", a, b)
            tok = data.allgather(local)
        lg = np.stack(lg, 1)                            # (b_loc, 1 + G, V)
        out = np.stack(served, 1).astype(np.int64)      # (b_loc, 1 + G)
        return {"batch": j, "digest": digest(lg, out), "logits": lg,
                "tokens": out}

    events: list = []
    serve(-1, None, min(G, 2))                # warm the cell's shapes
    w = Window(env, spec)
    tr = env.comm.tracer
    if w.trace:
        wrap_collectives([*dist.comms.values(), dist.dp_comm], w.spans)
        tr.start()
        c0 = dict(tr.metrics.counters)
    w.open()
    outputs = []
    j = 0
    while True:
        outputs.append(serve(j, w, G))
        j += 1
        flag = torch.tensor([int(time.monotonic() >= w.t_end)],
                            dtype=torch.int32, device=dev)
        if int(env.comm.allreduce(flag).item()):
            break
    w.close()
    if w.trace:
        tr.stop()
        _program_spans(w, tr, c0, system.SPANS, system.COUNTERS)
    leader = dist.axis_index("model") == 0
    if not leader:                            # its row's leader sends them
        for o in outputs:
            o.pop("logits")
            o.pop("tokens")
    w.rep.update(leader=leader, dp_index=dist.dp_index, rows=b_loc,
                 events=events, outputs=outputs, requests=j)
    return w.rep


def _program_spans(w, tr, c0: dict, spans, counters) -> None:
    """The program's spans named in ``spans`` into the window's, on the
    epoch clock, and the window's counts of ``counters``."""
    for row in tr.span_rows():
        name, t0, t1 = row[0], row[1], row[2]
        if name in spans and t1:
            w.spans.add(name, t0, t1)
    got = tr.metrics.counters
    w.rep["program_counters"] = {k: got.get(k, 0) - c0.get(k, 0)
                                 for k in counters}


def _span(w, name: str, a: float, b: float) -> None:
    if w.spans is not None:
        w.spans.add(name, w.to_ns(a), w.to_ns(b))
