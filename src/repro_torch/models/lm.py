"""The LM in PyTorch: embedding -> pattern-stacked backbone -> (tied)
head, with prefill and decode entry points.

Parameters keep the JAX package's tree: ``params["blocks"]`` is a tuple
with one dict per pattern position, each leaf with a leading
``n_groups`` axis, so ``params_from_numpy`` carries a JAX tree across as
it is. The JAX package's ``lax.scan`` over groups is a Python loop here.

Entry points run on the card unless the caller passes ``device="cpu"``.
Left out of this slice (``ROADMAP.md`` Queue 1): mamba and MoE blocks,
cross attention and the frames frontend, the int8 KV cache, ``dist``,
``loss_fn`` and training.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.blocks import unported

Params = dict[str, Any]


def require_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names the card and
    there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the model runs on the card by default; pass "
            "device='cpu' to run it on the CPU")
    return device


def _check_supported(cfg: ModelConfig) -> None:
    for blk in cfg.pattern:
        if blk.mixer == "mamba":
            raise unported("the mamba mixer", "Queue 1, mamba")
        if blk.mixer == "cross_attn":
            raise unported("cross-attention (cross_attn)",
                           "Queue 1, cross-attention/VLM")
        if blk.ffn == "moe":
            raise unported("the MoE FFN", "Queue 1, moe")
        if blk.mixer not in ("attn", "rwkv6"):
            raise ValueError(blk.mixer)
        if blk.ffn not in ("dense", "cmix", "none"):
            raise ValueError(blk.ffn)
    if cfg.frontend == "frames":
        raise unported('frontend="frames"', "Queue 1, frames frontend")
    if cfg.kv_cache_dtype == "int8":
        raise unported("the int8 KV cache", "Queue 1, int8 KV cache")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """The tensors of a parameter or state tree, dict keys in sorted
    order (the order of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _block_init(gen, cfg: ModelConfig, blk: BlockSpec, device) -> Params:
    dt = getattr(torch, cfg.param_dtype)
    lead = (cfg.n_groups,)
    kw = dict(device=device, lead=lead)
    p: Params = {"norm1": torch.ones((*lead, cfg.d_model), dtype=dt,
                                     device=device)}
    if blk.mixer == "attn":
        p["mixer"] = B.attn_init(gen, cfg, **kw)
    else:
        p["mixer"] = B.rwkv6_init(gen, cfg, **kw)
    if blk.ffn != "none":
        p["norm2"] = torch.ones((*lead, cfg.d_model), dtype=dt,
                                device=device)
        if blk.ffn == "dense":
            p["ffn"] = B.ffn_init(gen, cfg, **kw)
        else:
            p["ffn"] = B.cmix_init(gen, cfg, **kw)
    return p


def init(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, in
    ``cfg.param_dtype``, made on ``device``. The numbers differ from
    the JAX package's ``lm.init``; tests carry those across with
    ``params_from_numpy``."""
    _check_supported(cfg)
    device = require_device(device)
    # a meta device (shapes only, as params_from_numpy uses) draws nothing
    gen = torch.Generator(device="cuda" if device.type == "cuda" else "cpu")
    gen.manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    Vp = cfg.padded_vocab
    params: Params = {
        "embed": B.dense_init(gen, (Vp, cfg.d_model), scale=0.02, dtype=dt,
                              device=device),
        "blocks": tuple(_block_init(gen, cfg, blk, device)
                        for blk in cfg.pattern),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = B.dense_init(gen, (Vp, cfg.d_model), scale=0.02,
                                      dtype=dt, device=device)
    return params


def params_from_numpy(cfg: ModelConfig, tree, device="cuda") -> Params:
    """The port's parameters from the JAX package's tree of numpy arrays
    (``jax.tree.map(np.asarray, repro.models.lm.init(cfg, key))``). Every
    leaf must have the shape and type ``init`` gives."""
    device = require_device(device)
    want = init(cfg, device="meta")
    got = _tree_map(lambda a: torch.from_numpy(np.array(a)),
                    tree)
    if _tree_map(lambda t: None, got) != _tree_map(lambda t: None, want):
        raise ValueError("params_from_numpy: the tree's structure differs "
                         f"from {cfg.arch_id}'s parameters")
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise ValueError(f"params_from_numpy: leaf {tuple(g.shape)} "
                             f"{g.dtype}, want {tuple(w.shape)} {w.dtype}")
    return _tree_map(lambda t: t.to(device), got)


# --------------------------------------------------------------------------
# decode-state init
# --------------------------------------------------------------------------

def decode_state_init(cfg: ModelConfig, batch: int, cache_len: int, *,
                      device="cuda"):
    """Stacked-over-groups decode state, one entry per pattern position.
    The KV cache is held in the type its update promotes to (bf16 under
    bf16 compute, f32 under f32 compute), the type the JAX package's
    cache takes after its first decode step, so it can be updated in
    place."""
    _check_supported(cfg)
    device = require_device(device)
    cdt = B._dtype(cfg)
    kv_dt = torch.promote_types(getattr(torch, cfg.kv_cache_dtype), cdt)
    lead = (cfg.n_groups,)
    state = []
    for blk in cfg.pattern:
        st: Params = {}
        if blk.mixer == "attn":
            shape = (*lead, batch, cfg.n_kv_heads, cache_len, cfg.d_head)
            st["kv"] = {"k": torch.zeros(shape, dtype=kv_dt, device=device),
                        "v": torch.zeros(shape, dtype=kv_dt, device=device)}
        else:
            st["ssm"] = B.rwkv6_state_init(cfg, batch, device=device,
                                           lead=lead)
        if blk.ffn == "cmix":
            st["cm_x_prev"] = torch.zeros((*lead, batch, cfg.d_model),
                                          dtype=cdt, device=device)
        state.append(st)
    return tuple(state)


# --------------------------------------------------------------------------
# block application
# --------------------------------------------------------------------------

def _apply_block(bp: Params, cfg: ModelConfig, blk: BlockSpec, x, positions,
                 *, state=None, pos=None, dist=None):
    """Returns x after the block. With ``state`` (decode) the block's
    state is updated in place."""
    h = B.rmsnorm(x, bp["norm1"], cfg.norm_eps)
    if blk.mixer == "attn":
        mix, _ = B.attn_apply(bp["mixer"], cfg, h, positions,
                              cache=None if state is None else state["kv"],
                              cache_len=pos, dist=dist)
    else:
        B._no_dist(dist)
        mix, _ = B.rwkv6_apply(bp["mixer"], cfg, h,
                               state=None if state is None else state["ssm"])

    if blk.parallel and blk.ffn != "none":
        # Cohere-style: attn and ffn both read the same normed input
        return x + mix + _apply_ffn(bp, cfg, blk, h, state)
    x = x + mix
    if blk.ffn != "none":
        h2 = B.rmsnorm(x, bp["norm2"], cfg.norm_eps)
        x = x + _apply_ffn(bp, cfg, blk, h2, state)
    return x


def _apply_ffn(bp, cfg, blk, h, state):
    if blk.ffn == "dense":
        return B.ffn_apply(bp["ffn"], cfg, h)
    xp = None if state is None else state["cm_x_prev"]
    f, last = B.cmix_apply(bp["ffn"], cfg, h, x_prev=xp)
    if state is not None:
        xp.copy_(last)
    return f


def _group(tree, g: int):
    """The parameters (or state) of group ``g``: views into the stack."""
    return _tree_map(lambda t: t[g], tree)


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------

def _embed_tokens(params, cfg: ModelConfig, batch, dist=None):
    """Gather the rows, then cast them: the same values as casting the
    whole table first, as the JAX package writes it, without a pass over
    the table on every step."""
    B._no_dist(dist)
    if cfg.frontend == "frames":
        raise unported('frontend="frames"', "Queue 1, frames frontend")
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    return params["embed"][tokens.long()].to(B._dtype(cfg))


def forward(params: Params, cfg: ModelConfig, batch, *, dist=None):
    """Causal full-sequence forward. batch: {"tokens": (B, S)}. Returns
    x_final (B, S, D); the JAX package also returns the MoE auxiliary
    loss, which no block of this slice produces."""
    _check_supported(cfg)
    if batch.get("ctx") is not None:
        raise unported("cross-attention context (ctx)",
                       "Queue 1, cross-attention/VLM")
    x = _embed_tokens(params, cfg, batch, dist)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for g in range(cfg.n_groups):
        gp = _group(params["blocks"], g)
        for p, blk in enumerate(cfg.pattern):
            x = _apply_block(gp[p], cfg, blk, x, positions, dist=dist)
    return B.rmsnorm(x, params["final_norm"], cfg.norm_eps)


def lm_head(params: Params, cfg: ModelConfig):
    return params.get("head", params["embed"])


def _logits(params, cfg: ModelConfig, x_last):
    head = lm_head(params, cfg)
    logits = (x_last @ head.to(x_last.dtype).T).float()
    return logits[..., :cfg.vocab_size]


def loss_fn(*args, **kw):
    raise unported("loss_fn and training", "Queue 1, loss_fn and training")


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def decode_step(params: Params, cfg: ModelConfig, state, batch, pos, *,
                dist=None):
    """One decode step. batch: {"tokens": (B, 1)}; state: from
    decode_state_init; pos: (B,) write/attend position.

    The KV caches and recurrent states in ``state`` are updated in place
    to save memory (the JAX package returns new ones); the same ``state``
    is returned. Returns (logits (B, vocab) f32, state).

    A CPU ``pos`` at or past the KV cache's length raises ``ValueError``
    (``blocks.check_kv_room``), where the JAX package silently drops or
    clamps the cache update. A CUDA ``pos`` is not read on the host,
    which would cost a sync per step: its caller keeps it in range."""
    _check_supported(cfg)
    kv = next((st["kv"]["k"] for st in state if "kv" in st), None)
    if kv is not None:
        B.check_kv_room(pos, kv.shape[-2])
    x = _embed_tokens(params, cfg, batch, dist)
    positions = pos[:, None]
    for g in range(cfg.n_groups):
        gp = _group(params["blocks"], g)
        gs = _group(state, g)
        for p, blk in enumerate(cfg.pattern):
            x = _apply_block(gp[p], cfg, blk, x, positions, state=gs[p],
                             pos=pos, dist=dist)
    x = B.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x[:, 0]), state


def prefill(params: Params, cfg: ModelConfig, batch, *, dist=None):
    """Full-sequence prefill returning last-position logits (B, vocab)
    f32. On the card every attention layer runs the flash attention
    kernel and every rwkv6 layer the WKV6 kernel, once each."""
    x = forward(params, cfg, batch, dist=dist)
    return _logits(params, cfg, x[:, -1])
