"""A hybrid Mamba-attention MoE model (Jamba) served expert-parallel over
the program's message plane: the port's ``DistContext`` over the ranks
(data x model), the chip's block of the experts split over the model
ranks, and the serve steps of ``repro_torch.train.steps``.

A request: a data rank's rows of seeded prompt ids, ``make_serve_prefill``
with a decode state to fill (every attention layer's KV cache and every
Mamba layer's conv and h, as a prefill server hands a request to
decode), and the greedy first token; for a decode mix, ``gen`` greedy
steps of ``make_serve_decode`` through that state. Requests follow one
another in a closed loop; after each, the ranks agree whether the
window has ended. The rank program is ``serve`` (the mixes' ``"loop"``).
``serve`` takes the model from this package: ``model_config``,
``program_params``, and the program's spans and counters that a traced
window copies (``SPANS``, ``COUNTERS``).

The check runs the plain reference (``cmpibench.reference.jamba``) in
this process once the ranks have ended, on a sample of the requests
drawn from the seed: the logits of the prefill and of each decode step
against the reference's full forward over the prompt and the served
tokens.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from cmpibench import generate
from cmpibench.reference.jamba import layer_kinds
from cmpibench.systems.ep_serve import CONTROL

# the program's spans and counters a traced window copies: a Mamba layer
# and its scan, each write of the decode state in a prefill
SPANS = ("mamba.mixer", "mamba.scan", "serve.state_fill")
COUNTERS = ("mamba_scan_chunks", "state_fill_bytes")

# what the program computes of the published configuration
FIXED = {"hidden_act": "silu", "tie_word_embeddings": False,
         "mamba_conv_bias": True, "mamba_proj_bias": False,
         "sliding_window": None, "model_type": "jamba"}


def dims(m: dict) -> dict:
    d, h = m["hidden_size"], m["num_attention_heads"]
    pad = m["vocab_pad_multiple"]
    d_in = m["mamba_expand"] * d
    return {"L": m["num_hidden_layers"], "D": d, "H": h,
            "KV": m["num_key_value_heads"], "Dh": d // h,
            "F": m["intermediate_size"], "E": m["router_experts"],
            "held": m["num_experts"], "d_in": d_in,
            "N": m["mamba_d_state"], "R": m["mamba_dt_rank"],
            "C": m["mamba_d_conv"], "V": m["vocab_size"],
            "Vp": -(-m["vocab_size"] // pad) * pad}


def model_config(conf: dict):
    """The program's config of the configuration file. Raises where the
    file states what the program does not compute."""
    from repro_torch.configs import (MambaConfig, MoEConfig, get_config,
                                     optimized)
    for k, want in FIXED.items():
        if conf[k] != want:
            raise ValueError(f"{k}={conf[k]!r}: the program computes "
                             f"{want!r}")
    d = dims(conf)
    base = get_config(conf["arch"])
    kinds = [(b.mixer, b.ffn) for b in base.pattern]
    if layer_kinds(conf)[:len(kinds)] != kinds or d["L"] % len(kinds):
        raise ValueError("the configuration's layer pattern is not the "
                         f"program's {kinds}")
    cfg = dataclasses.replace(
        base, n_layers=d["L"], d_model=d["D"], n_heads=d["H"],
        n_kv_heads=d["KV"], d_head=d["Dh"], d_ff=d["F"], vocab_size=d["V"],
        vocab_pad_multiple=conf["vocab_pad_multiple"],
        norm_eps=conf["rms_norm_eps"], tie_embeddings=False,
        compute_dtype=conf["compute_dtype"],
        kv_cache_dtype=conf["kv_cache_dtype"], param_dtype="float32",
        moe=MoEConfig(n_experts=d["E"], top_k=conf["num_experts_per_tok"],
                      capacity_factor=conf["capacity_factor"]),
        mamba=MambaConfig(d_state=d["N"], d_conv=d["C"],
                          expand=conf["mamba_expand"], dt_rank=d["R"]),
        moe_held=d["held"], moe_held_offset=conf["held_expert_offset"])
    if conf["flags"] == "configs.optimized":
        cfg = optimized(cfg)
    # the check reads the logits of every decode step, not its token alone
    return dataclasses.replace(cfg, decode_return="logits")


# --------------------------------------------------------------------------
# seeded weights, made on the device: every leaf a generator stream of its
# own, and each expert's three matrices theirs, so a rank makes its own
# block of the experts alone and the reference the chip's, with the same
# numbers; f32, the type the program holds its parameters in
# --------------------------------------------------------------------------

def _randn(seed: int, name: str, shape, scale: float, device, shift=0.0):
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(generate.stream_seed(seed, "weights", name))
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return w.mul_(scale).add_(shift)


def _dt_bias(seed: int, name: str, n: int, device):
    """softplus^-1 of dt drawn log-uniform in [1e-3, 1e-1] (Mamba's
    initialisation)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(generate.stream_seed(seed, "weights", name))
    u = torch.rand(n, generator=g, device=device, dtype=torch.float32)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return dt + torch.log(-torch.expm1(-dt))


def _layer(m: dict, seed: int, i: int, device) -> dict:
    """Layer ``i``'s leaves but the experts: ``norm1``, ``norm2``, and
    ``mixer`` and ``ffn`` dicts."""
    import torch
    d = dims(m)
    D, d_in = d["D"], d["d_in"]
    r = lambda n, s, sc, sh=0.0: _randn(seed, f"{i}.{n}", s, sc,  # noqa
                                        device, sh)
    mixer, ffn = layer_kinds(m)[i]
    if mixer == "attn":
        H, KV, Dh = d["H"], d["KV"], d["Dh"]
        mix = dict(wq=r("wq", (D, H * Dh), D ** -0.5),
                   wk=r("wk", (D, KV * Dh), D ** -0.5),
                   wv=r("wv", (D, KV * Dh), D ** -0.5),
                   wo=r("wo", (H * Dh, D), (H * Dh) ** -0.5))
    else:
        N, R = d["N"], d["R"]
        mix = dict(
            in_proj=r("in_proj", (D, 2 * d_in), D ** -0.5),
            conv_w=r("conv_w", (d["C"], d_in), d["C"] ** -0.5),
            conv_b=r("conv_b", (d_in,), 0.1),
            x_proj=r("x_proj", (d_in, R + 2 * N), d_in ** -0.5),
            dt_norm=r("dt_norm", (R,), 0.1, 1.0),
            b_norm=r("b_norm", (N,), 0.1, 1.0),
            c_norm=r("c_norm", (N,), 0.1, 1.0),
            dt_proj=r("dt_proj", (R, d_in), R ** -0.5),
            dt_bias=_dt_bias(seed, f"{i}.dt_bias", d_in, device),
            A_log=torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                         device=device)).repeat(d_in, 1),
            D=torch.ones(d_in, device=device),
            out_proj=r("out_proj", (d_in, D), d_in ** -0.5))
    if ffn == "moe":
        f = {"router": r("router", (D, d["E"]), 0.02)}
    else:
        F = d["F"]
        f = dict(w_gate=r("w_gate", (D, F), D ** -0.5),
                 w_up=r("w_up", (D, F), D ** -0.5),
                 w_down=r("w_down", (F, D), F ** -0.5))
    return {"norm1": r("norm1", (D,), 0.1, 1.0),
            "norm2": r("norm2", (D,), 0.1, 1.0), "mixer": mix, "ffn": f}


def _experts(m: dict, seed: int, i: int, device, lo: int, n: int) -> dict:
    """Layer ``i``'s experts ``lo .. lo + n - 1`` (global ids), stacked."""
    import torch
    d = dims(m)
    D, F = d["D"], d["F"]
    out = {}
    for leaf, shape, scale in (("w_gate", (D, F), D ** -0.5),
                               ("w_up", (D, F), D ** -0.5),
                               ("w_down", (F, D), F ** -0.5)):
        t = torch.empty((n, *shape), dtype=torch.float32, device=device)
        for e in range(n):
            t[e] = _randn(seed, f"{i}.{leaf}.{lo + e}", shape, scale, device)
        out[leaf] = t
    return out


def _shared(m: dict, seed: int, device) -> dict:
    d = dims(m)
    return {"embed": _randn(seed, "embed", (d["Vp"], d["D"]), 0.02, device),
            "head": _randn(seed, "head", (d["Vp"], d["D"]), 0.02, device),
            "final_norm": _randn(seed, "final_norm", (d["D"],), 0.1, device,
                                 1.0)}


def program_params(m: dict, seed: int, device, model_index: int,
                   model_size: int) -> dict:
    """The program's parameter tree (``repro_torch.models.lm``'s: one
    dict a pattern position, each leaf with its group axis), the held
    experts cut to the block of model rank ``model_index`` of
    ``model_size``."""
    d = dims(m)
    e_loc = d["held"] // model_size
    lo = m["held_expert_offset"] + model_index * e_loc
    blocks = []
    for i, (_, ffn) in enumerate(layer_kinds(m)):
        blk = _layer(m, seed, i, device)
        if ffn == "moe":
            blk["ffn"].update(_experts(m, seed, i, device, lo, e_loc))
        blocks.append(_stack(blk))
    return {**_shared(m, seed, device), "blocks": tuple(blocks)}


def _stack(v):
    """The group axis (one group: the configuration is one period)."""
    if isinstance(v, dict):
        return {k: _stack(x) for k, x in v.items()}
    return v[None]


def reference_params(m: dict, seed: int, device) -> dict:
    """Every leaf and the chip's experts, flat (``"<layer>.<leaf>"``)."""
    w = _shared(m, seed, device)
    for i, (_, ffn) in enumerate(layer_kinds(m)):
        blk = _layer(m, seed, i, device)
        if ffn == "moe":
            blk["ffn"].update(_experts(m, seed, i, device,
                                       m["held_expert_offset"],
                                       m["num_experts"]))
        leaves = {"norm1": blk["norm1"], "norm2": blk["norm2"],
                  **blk["mixer"], **blk["ffn"]}
        w.update({f"{i}.{k}": v for k, v in leaves.items()})
    return w


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------

def readings(spec: dict, reports: list[dict], device, *,
             control: bool = False) -> dict:
    """The reference's readings on the sampled requests, for the program
    and, with ``control``, for the reference in the precision ``CONTROL``
    names put in the program's place (``control_*``). Every logit of a
    row is the prefill's or a decode step's, against the reference's full
    forward over the prompt and the served tokens: ``logit_l2`` the
    widest relative L2 error of one, ``logit_l2_median`` their median,
    ``logit_err`` the widest gap over the reference's largest logit;
    ``token_gap``, the widest gap by which a served token's reference
    logit lies below the reference's best at its position, and
    ``token_off`` the share of served tokens that are not its best.
    ``ref_margin_median``: the median gap between the reference's best
    logit and its second (how near the ties are)."""
    import torch

    from cmpibench.reference.jamba import Jamba
    conf, t, seed = spec["config"], spec["traffic"], spec["seed"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    leaders = {r["dp_index"]: r for r in reports if r["leader"]}
    n_req = min(len(r["outputs"]) for r in reports)
    chosen = generate.sample(seed, "check", n_req, t["check_requests"])
    w = reference_params(conf, seed, device)
    kw = dict(model_size=conf["mesh"]["model"],
              capacity_factor=conf["capacity_factor"])
    sides = {"": Jamba(conf, w, **kw)}
    if control:
        sides["control_"] = Jamba(conf, w, precision=CONTROL[
            conf["compute_dtype"]], **kw)
    ref = sides[""]
    P, G, R = t["prompt_len"], t["gen"], t["rows"]
    b_loc = R // len(leaders)
    acc = {k: {"abs": [], "l2": [], "gaps": []} for k in sides}
    margins: list = []
    for j in chosen:
        ids = generate.prompts(t, seed, j, conf["vocab_size"])
        for dpi, rep in sorted(leaders.items()):
            o = rep["outputs"][j]
            rows = torch.from_numpy(ids[dpi * b_loc:(dpi + 1) * b_loc])
            served = torch.from_numpy(o["tokens"])            # (b, 1 + G)
            seq = torch.cat([rows, served[:, :G]], 1).to(device)
            want = ref.logits(seq, P)                         # (b, 1+G, V)
            best = want.max(-1).values
            top2 = want.topk(2, -1).values
            margins.append((top2[..., 0] - top2[..., 1]).flatten().cpu())
            for k, side in sides.items():
                if k:
                    got = side.logits(seq, P)
                    pick = got.argmax(-1, keepdim=True)
                else:
                    got = torch.from_numpy(o["logits"]).to(device)
                    pick = served.to(device)[..., None]
                a = acc[k]
                err = (got - want).abs().amax(-1) / want.abs().amax(-1)
                a["abs"].append(float(err.max()))
                a["l2"] += ((got - want).norm(dim=-1)
                            / want.norm(dim=-1)).flatten().tolist()
                a["gaps"].append((best - want.gather(-1, pick)[..., 0])
                                 .flatten().cpu())
    out = {"requests": len(chosen),
           "served_tokens": int(sum(g.numel() for g in acc[""]["gaps"]))}
    if margins:
        out["ref_margin_median"] = float(torch.cat(margins).median())
    for k, a in acc.items():
        gaps = torch.cat(a["gaps"]) if a["gaps"] else torch.zeros(1)
        out.update({k + "logit_err": max(a["abs"], default=0.0),
                    k + "logit_l2": max(a["l2"], default=0.0),
                    k + "logit_l2_median": float(np.median(a["l2"]))
                    if a["l2"] else 0.0,
                    k + "token_gap": float(gaps.max()),
                    k + "token_off": float((gaps > 0).float().mean())})
    return out


def check(spec: dict, reports: list[dict], device, *,
          control: bool = False) -> dict:
    """The numbers compared, each beside its limit: the program's, or,
    with ``control``, the control's in the program's place."""
    got = readings(spec, reports, device, control=control)
    if str(device).startswith("cuda"):
        # the reference's ~31 GB go back to the card, for a next run
        # from this process (``control.py``'s seeds)
        import torch
        torch.cuda.empty_cache()
    side = "control_" if control else ""
    numbers = {}
    if not control:
        # the model ranks of a row serve the same thing, bit for bit
        by_row: dict = {}
        for r in reports:
            for o in r["outputs"]:
                by_row.setdefault((r["dp_index"], o["batch"]), set()).add(
                    o["digest"])
        differ = sum(len(s) > 1 for s in by_row.values())
        numbers["ranks_of_a_row_differ"] = {"value": differ, "limit": 0}
    numbers.update({k: {"value": got[side + k], "limit": v}
                    for k, v in spec["traffic"]["limits"].items()})
    leaders = [r for r in reports if r["leader"]]
    bad = 0 if all(n["value"] <= n["limit"] for n in numbers.values()) \
        else got["requests"] * sum(r["rows"] for r in leaders)
    return {"numbers": numbers,
            "attempted": sum(r["requests"] * r["rows"] for r in leaders),
            "failed": bad, "detail": got}
