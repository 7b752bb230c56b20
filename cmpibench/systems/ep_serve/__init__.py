"""A MoE model served expert-parallel over the program's message plane:
the port's ``DistContext`` over the ranks (data x model), each model rank
holding its block of the experts, and the serve steps of
``repro_torch.train.steps`` as the program's expert-parallel serving
runs them.

A request batch: the global prompt ids of the batch (drawn from the
seed), ``make_serve_prefill`` (every layer's attention through
``flash_attention``, the MoE's partial outputs summed over ``model``),
the greedy first token of each row, and, for a decode mix, ``gen``
greedy steps of ``make_serve_decode`` (the tokens allgathered over
``data`` between steps). Batches follow one another in a closed loop;
after each, the ranks agree whether the window has ended.

The rank program is ``serve`` (the mixes' ``"loop"``). The check, here,
runs the plain reference (``cmpibench.reference.granite``) in this
process once the ranks have ended, on a sample of the requests drawn
from the seed: the prefill's logits, and every served token's logit
against the reference's best at its position.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from cmpibench import generate, weights


def model_config(conf: dict):
    """The program's ``ModelConfig`` of the configuration file. Raises
    where the file states what the program does not compute."""
    from repro_torch.configs import MoEConfig, get_config, optimized
    d = weights.dims(conf)
    fixed = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
             "logits_scaling": 1.0, "attention_multiplier": d["Dh"] ** -0.5,
             "hidden_act": "silu", "tie_word_embeddings": False}
    for k, want in fixed.items():
        if conf[k] != want:
            raise ValueError(f"{k}={conf[k]!r}: the program computes "
                             f"{want!r}")
    cfg = dataclasses.replace(
        get_config(conf["arch"]), n_layers=d["L"], d_model=d["D"],
        n_heads=d["H"], n_kv_heads=d["KV"], d_head=d["Dh"], d_ff=d["F"],
        vocab_size=d["V"], vocab_pad_multiple=conf["vocab_pad_multiple"],
        rope_theta=conf["rope_theta"], norm_eps=conf["rms_norm_eps"],
        tie_embeddings=False, compute_dtype=conf["compute_dtype"],
        kv_cache_dtype=conf["kv_cache_dtype"],
        param_dtype="float32",
        moe=MoEConfig(n_experts=d["E"], top_k=conf["num_experts_per_tok"],
                      capacity_factor=conf["capacity_factor"]))
    return optimized(cfg) if conf["flags"] == "configs.optimized" else cfg


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------

# the nearest precision below the one the configuration states
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def readings(spec: dict, reports: list[dict], device, *,
             control: bool = False) -> dict:
    """The reference's readings on the sampled requests, for the program
    and, with ``control``, for the reference put in the program's place
    in the precision ``CONTROL`` names (``control_*``): ``logit_err``,
    the widest gap between the prefill's logits and the reference's over
    the largest reference logit; ``logit_l2`` the widest relative L2
    error of a row's, ``logit_l2_median`` its median over the rows;
    ``token_gap``, the widest gap by which a served token's
    reference logit lies below the reference's best at its position,
    ``token_gap_mean`` its mean and ``token_off`` the share of served
    tokens that are not the reference's best; where the mix gives a
    ``row_tol``, ``rows_off``, the share of rows whose prefill logits lie
    further than that from the reference's (relative to its largest).
    The control's token is the one it puts first at each position of the
    same prompts and served tokens. ``ref_margin_*_median``: the median
    gap between the reference's best logit and its second, at the first
    token and at the decode steps (how near the ties are)."""
    import torch

    from cmpibench.reference.granite import Granite
    conf, t, seed = spec["config"], spec["traffic"], spec["seed"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    leaders = {r["dp_index"]: r for r in reports if r["leader"]}
    n_req = min(len(r["outputs"]) for r in reports)
    chosen = generate.sample(seed, "check", n_req, t["check_requests"])
    w = weights.reference_params(conf, seed, device)
    kw = dict(model_size=conf["mesh"]["model"],
              capacity_factor=conf["capacity_factor"])
    ref = Granite(conf, w, **kw)
    sides = {"": None}
    if control:
        sides["control_"] = Granite(conf, w, precision=CONTROL[
            conf["compute_dtype"]], **kw)
    P, G, R = t["prompt_len"], t["gen"], t["rows"]
    b_loc = R // len(leaders)
    acc = {k: {"abs": [], "l2": [], "gaps": [], "rows": []} for k in sides}
    margins: list = []          # the reference's best less its second
    for j in chosen:
        ids = generate.prompts(t, seed, j, conf["vocab_size"])
        for d, rep in sorted(leaders.items()):
            o = rep["outputs"][j]
            rows = torch.from_numpy(ids[d * b_loc:(d + 1) * b_loc]).to(device)
            served = torch.from_numpy(o["tokens"]).to(device)  # (b, 1 + G)
            want = ref.prefill(rows)
            ref_all = torch.stack([want] + (list(ref.decode(
                P, served[:, :G]).unbind(1)) if G else []), 1)
            best = ref_all.max(-1).values                   # (b, 1 + G)
            top2 = ref_all.topk(2, -1).values
            margins.append((top2[..., 0] - top2[..., 1]).cpu())
            for k, low in sides.items():
                if low is None:
                    got = torch.from_numpy(o["logits"]).to(device)
                    pick = served[..., None]
                else:
                    got = low.prefill(rows)
                    pick = torch.stack([got] + (list(low.decode(
                        P, served[:, :G]).unbind(1)) if G else []),
                        1).argmax(-1, keepdim=True)
                a = acc[k]
                err = (got - want).abs().max(-1).values
                a["rows"] += (err / want.abs().max(-1).values).tolist()
                a["abs"].append(float(err.max() / want.abs().max()))
                l2 = (got - want).norm(dim=-1) / want.norm(dim=-1)
                a["l2"] += l2.tolist()
                a["gaps"].append((best - ref_all.gather(-1, pick)[..., 0])
                                 .flatten().cpu())
    out = {"served_tokens": int(sum(g.numel() for g in acc[""]["gaps"])),
           "requests": len(chosen)}
    if margins:
        mg = torch.cat(margins)
        out["ref_margin_first_median"] = float(mg[:, 0].median())
        if G:
            out["ref_margin_decode_median"] = float(mg[:, 1:].median())
    tol = t.get("row_tol")
    for k, a in acc.items():
        if tol is not None:
            out[k + "rows_off"] = sum(e > tol for e in a["rows"]) / max(
                len(a["rows"]), 1)
        gaps = torch.cat(a["gaps"]) if a["gaps"] else torch.zeros(1)
        out.update({k + "logit_err": max(a["abs"], default=0.0),
                    k + "logit_l2": max(a["l2"], default=0.0),
                    k + "logit_l2_median": float(np.median(a["l2"]))
                    if a["l2"] else 0.0,
                    k + "token_gap": float(gaps.max()),
                    k + "token_gap_mean": float(gaps.mean()),
                    k + "token_off": float((gaps > 0).float().mean())})
    return out


def check(spec: dict, reports: list[dict], device, *,
          control: bool = False) -> dict:
    """The numbers compared, each beside its limit: the program's, or,
    with ``control``, the control's in the program's place (its own
    logits and the tokens it puts first), so that the run reports what
    the control would."""
    t = spec["traffic"]
    got = readings(spec, reports, device, control=control)
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
                    for k, v in t["limits"].items()})
    leaders = [r for r in reports if r["leader"]]
    rows = sum(r["requests"] * r["rows"] for r in leaders)
    bad = 0 if all(n["value"] <= n["limit"] for n in numbers.values()) \
        else got["requests"] * sum(r["rows"] for r in leaders)
    return {"numbers": numbers, "attempted": rows, "failed": bad,
            "detail": got}
