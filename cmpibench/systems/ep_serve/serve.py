"""Request batches in a closed loop, one in flight: the program's
``make_serve_prefill`` over a batch of seeded prompts, its greedy first
token, and, where the mix has ``gen`` > 0, that many greedy steps of
``make_serve_decode``, the tokens allgathered over ``data`` between
steps. After each batch the ranks agree whether the window has ended."""
from __future__ import annotations

import time

import numpy as np

from cmpibench import generate, weights
from cmpibench.systems import Window
from cmpibench.systems.ep_serve import check, digest, model_config
from cmpibench.tracing import wrap_collectives

__all__ = ["rank_main", "check"]


def rank_main(env, spec: dict) -> dict:
    import torch

    from repro_torch.configs import InputShape
    from repro_torch.distributed.context import DistContext
    from repro_torch.models import lm
    from repro_torch.train import steps as ST

    conf, t, seed = spec["config"], spec["traffic"], spec["seed"]
    fault = spec.get("fault")
    cfg = model_config(conf)
    dev = env.comm.device
    mesh = conf["mesh"]
    dist = DistContext(env.comm, tuple(mesh.values()), tuple(mesh))
    params = weights.program_params(conf, seed, dev,
                                    dist.axis_index("model"),
                                    dist.model_size)
    P, G, R = t["prompt_len"], t["gen"], t["rows"]
    b_loc = R // dist.dp_size
    pre = ST.make_serve_prefill(cfg, InputShape("p", "prefill", P, R), dist)
    dec = (ST.make_serve_decode(cfg, InputShape("d", "decode", P + G, R),
                                dist) if G else None)
    data = dist.comms["data"]
    if fault == "no_exchange":                # MoE and vocab sums skipped
        dist.comms["model"].allreduce = lambda x, *a, **k: x

    def serve(j: int, w, gen: int) -> dict:
        """Request batch ``j`` with ``gen`` decode steps; ``w`` the window
        (None: the warm-up)."""
        ids = generate.prompts(t, seed, j, cfg.vocab_size)
        if fault == "half_batch":             # second half = first half
            ids[R // 2:] = ids[:R // 2]
        toks = torch.from_numpy(ids).to(dev)
        a = time.monotonic()
        logits = pre.fn(params, {"tokens": toks})
        tok = logits.argmax(-1).int()
        if fault == "alter" and not G:
            tok = (tok + 1) % cfg.vocab_size
        served = [tok.cpu().numpy()]
        b = time.monotonic()
        if w is not None:
            events.append(("prefill", b, b_loc, P, b - a))
            _span(w, "prefill", a, b)
        if gen:
            state = lm.decode_state_init(cfg, b_loc, P + G, device=dev)
            tok = data.allgather(tok)
            for i in range(gen):
                a = time.monotonic()
                pos = torch.full((R,), P + i, dtype=torch.int32, device=dev)
                st = state if fault != "stale_state" else \
                    [{k: {n: x.clone() for n, x in v.items()}
                      if isinstance(v, dict) else v.clone()
                      for k, v in s.items()} for s in state]
                local, _ = dec.fn(params, st, {"tokens": tok[:, None]}, pos)
                if fault == "alter" and i == 3:
                    local = (local + 1) % cfg.vocab_size
                served.append(local.cpu().numpy())
                b = time.monotonic()
                if w is not None:
                    events.append(("decode", b, b_loc, P + i, b - a))
                    _span(w, "decode_step", a, b)
                tok = data.allgather(local)
        lg = logits.float().cpu().numpy()
        out = np.stack(served, 1).astype(np.int64)       # (b_loc, 1 + G)
        return {"batch": j, "digest": digest(lg, out),
                "logits": lg, "tokens": out}

    events: list = []
    serve(-1, None, min(G, 2))                # warm the cell's shapes
    w = Window(env, spec)
    if w.trace:
        wrap_collectives([*dist.comms.values(), dist.dp_comm], w.spans)
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
    leader = dist.axis_index("model") == 0
    if not leader:                            # its row's leader sends them
        for o in outputs:
            o.pop("logits")
            o.pop("tokens")
    w.rep.update(leader=leader, dp_index=dist.dp_index, rows=b_loc,
                 events=events, outputs=outputs, requests=j)
    return w.rep


def _span(w, name: str, a: float, b: float) -> None:
    if w.spans is not None:
        w.spans.add(name, w.to_ns(a), w.to_ns(b))
