"""Seeded weights of a granite-style MoE model, made on the device.

Every leaf has a generator stream of its own (``generate.stream_seed``),
and each expert's three matrices theirs, so a rank of the program makes
its own block of the experts alone and the reference all of them, with
the same numbers. The program takes them in its own layout
(``program_params``: ``repro_torch.models.lm``'s tree, the expert leaves
cut to the rank's block, as ``distributed.sharding.shard_experts`` would
cut them); the reference takes ``reference_params``. f32, the type the
program holds its parameters in (it casts them to bf16 as it computes).
"""
from __future__ import annotations

from cmpibench.generate import stream_seed


def dims(m: dict) -> dict:
    h = m["num_attention_heads"]
    v = m["vocab_size"]
    pad = m.get("vocab_pad_multiple", 16)
    return {"L": m["num_hidden_layers"], "D": m["hidden_size"], "H": h,
            "KV": m["num_key_value_heads"], "Dh": m["hidden_size"] // h,
            "F": m["intermediate_size"], "E": m["num_local_experts"],
            "V": v, "Vp": -(-v // pad) * pad}


def _randn(seed: int, name: str, shape, scale: float, device, shift=0.0):
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, "weights", name))
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    w.mul_(scale)
    if shift:
        w.add_(shift)
    return w


def _shared(m: dict, seed: int, device) -> dict:
    d = dims(m)
    L, D, H, KV, Dh, E = d["L"], d["D"], d["H"], d["KV"], d["Dh"], d["E"]
    r = lambda n, s, sc, sh=0.0: _randn(seed, n, s, sc, device, sh)  # noqa
    return {
        "embed": r("embed", (d["Vp"], D), 0.02),
        "head": r("head", (d["Vp"], D), 0.02),
        "final_norm": r("final_norm", (D,), 0.1, 1.0),
        "norm1": r("norm1", (L, D), 0.1, 1.0),
        "norm2": r("norm2", (L, D), 0.1, 1.0),
        "wq": r("wq", (L, D, H * Dh), D ** -0.5),
        "wk": r("wk", (L, D, KV * Dh), D ** -0.5),
        "wv": r("wv", (L, D, KV * Dh), D ** -0.5),
        "wo": r("wo", (L, H * Dh, D), (H * Dh) ** -0.5),
        "router": r("router", (L, D, E), 0.02),
    }


def _experts(m: dict, seed: int, device, lo: int, n: int) -> dict:
    """Experts ``lo .. lo + n - 1``, stacked (L, n, ...)."""
    import torch
    d = dims(m)
    L, D, F = d["L"], d["D"], d["F"]
    out = {}
    for leaf, shape, scale in (("w_gate", (L, D, F), D ** -0.5),
                               ("w_up", (L, D, F), D ** -0.5),
                               ("w_down", (L, F, D), F ** -0.5)):
        t = torch.empty((L, n, *shape[1:]), dtype=torch.float32,
                        device=device)
        for i in range(n):
            t[:, i] = _randn(seed, f"{leaf}.{lo + i}", shape, scale, device)
        out[leaf] = t
    return out


def program_params(m: dict, seed: int, device, model_index: int,
                   model_size: int) -> dict:
    """The program's parameter tree on ``device``, the experts cut to the
    block of model rank ``model_index`` of ``model_size``."""
    s = _shared(m, seed, device)
    e_loc = dims(m)["E"] // model_size
    ex = _experts(m, seed, device, model_index * e_loc, e_loc)
    block = {"norm1": s["norm1"], "norm2": s["norm2"],
             "mixer": {k: s[k] for k in ("wq", "wk", "wv", "wo")},
             "ffn": {"router": s["router"], **ex}}
    return {"embed": s["embed"], "head": s["head"],
            "final_norm": s["final_norm"], "blocks": (block,)}


def reference_params(m: dict, seed: int, device) -> dict:
    """Every leaf, every expert: a flat dict for the reference."""
    s = _shared(m, seed, device)
    s.update(_experts(m, seed, device, 0, dims(m)["E"]))
    return s
