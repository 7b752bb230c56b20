"""The LM in PyTorch: embedding -> pattern-stacked backbone -> (tied)
head, with prefill and decode entry points.

Parameters keep the JAX package's tree: ``params["blocks"]`` is a tuple
with one dict per pattern position, each leaf with a leading
``n_groups`` axis, so ``params_from_numpy`` carries a JAX tree across as
it is. The JAX package's ``lax.scan`` over groups is a Python loop here.

Entry points run on the card unless the caller passes ``device="cpu"``.
Every config of ``configs.ARCHS`` initialises, runs ``forward``,
``prefill`` and ``decode_step`` and serves. ``loss_fn`` is the training
entry point (``launch/train.py``'s step differentiates it with
``backward``): on the CPU autograd runs through the plain versions, as
the JAX package differentiates its oracles; on the card the attention
gradient is the flash kernel's torch-op backward
(``kernels/flash_attention/bwd.py``) and the rwkv6 recurrence's the
``wkv6_bwd`` kernel.

``dist`` is a ``repro_torch.distributed.DistContext``, a rank's view of
the mesh: where ``dist.vocab_parallel(cfg)``, the embedding lookup, the
cross-entropy of ``loss_fn`` and the greedy token of ``decode_step``
(``decode_return="token"``) run on the rank's vocab slice and reduce
over its ``model`` communicator, as the JAX package's ``shard_map``s do;
under ``moe_shard="ep_a2a"`` a MoE block runs the rank's experts alone
(``blocks.moe_apply_ep``) and sums the partial outputs over ``model``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import blocks as B

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


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` whose leaves are ``leaves``, taken in
    ``tree_leaves`` order (``jax.tree``'s unflatten)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _block_init(gen, cfg: ModelConfig, blk: BlockSpec, device) -> Params:
    dt = getattr(torch, cfg.param_dtype)
    lead = (cfg.n_groups,)
    kw = dict(device=device, lead=lead)
    p: Params = {"norm1": torch.ones((*lead, cfg.d_model), dtype=dt,
                                     device=device)}
    mixers = {"attn": B.attn_init, "cross_attn": B.attn_init,
              "mamba": B.mamba_init, "rwkv6": B.rwkv6_init}
    ffns = {"dense": B.ffn_init, "moe": B.moe_init, "cmix": B.cmix_init}
    if blk.mixer not in mixers:
        raise ValueError(blk.mixer)
    p["mixer"] = mixers[blk.mixer](gen, cfg, **kw)
    if blk.ffn != "none":
        if blk.ffn not in ffns:
            raise ValueError(blk.ffn)
        p["norm2"] = torch.ones((*lead, cfg.d_model), dtype=dt,
                                device=device)
        p["ffn"] = ffns[blk.ffn](gen, cfg, **kw)
    return p


def init(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, in
    ``cfg.param_dtype``, made on ``device``. The numbers differ from
    the JAX package's ``lm.init``; tests carry those across with
    ``params_from_numpy``."""
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


def param_specs(cfg: ModelConfig) -> Params:
    """The parameters' shapes and dtypes without memory: ``init`` on the
    ``meta`` device (the JAX package's ``jax.eval_shape`` of its init)."""
    return init(cfg, device="meta")


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

    A float KV cache is held in the type its update promotes to (bf16
    under bf16 compute, f32 under f32 compute), the type the JAX
    package's cache takes after its first decode step, so it can be
    updated in place. ``kv_cache_dtype="int8"`` gives the JAX package's
    tree as it is: int8 ``k``/``v`` and f32 ``k_scale``/``v_scale``,
    which ``decode_step`` treats as the JAX package does (see there).
    A cross-attention block holds its context's K/V (compute dtype,
    ``n_ctx_tokens`` long), zeros until the caller fills them: no entry
    point of either package fills them."""
    device = require_device(device)
    cdt = B._dtype(cfg)
    int8 = cfg.kv_cache_dtype == "int8"
    kv_dt = torch.int8 if int8 else torch.promote_types(
        getattr(torch, cfg.kv_cache_dtype), cdt)
    lead = (cfg.n_groups,)
    KV, Dh = cfg.n_kv_heads, cfg.d_head
    state = []
    for blk in cfg.pattern:
        st: Params = {}
        if blk.mixer == "attn":
            shape = (*lead, batch, KV, cache_len, Dh)
            st["kv"] = {"k": torch.zeros(shape, dtype=kv_dt, device=device),
                        "v": torch.zeros(shape, dtype=kv_dt, device=device)}
            if int8:
                for name in ("k_scale", "v_scale"):
                    st["kv"][name] = torch.zeros(
                        shape[:-1], dtype=torch.float32, device=device)
        elif blk.mixer == "cross_attn":
            shape = (*lead, batch, KV, cfg.n_ctx_tokens, Dh)
            st["kv"] = {"k": torch.zeros(shape, dtype=cdt, device=device),
                        "v": torch.zeros(shape, dtype=cdt, device=device)}
        elif blk.mixer == "mamba":
            st["ssm"] = B.mamba_state_init(cfg, batch, device=device,
                                           lead=lead)
        elif blk.mixer == "rwkv6":
            st["ssm"] = B.rwkv6_state_init(cfg, batch, device=device,
                                           lead=lead)
        if blk.ffn == "cmix":
            st["cm_x_prev"] = torch.zeros((*lead, batch, cfg.d_model),
                                          dtype=cdt, device=device)
        state.append(st)
    return tuple(state)


def decode_state_specs(cfg: ModelConfig, batch: int, cache_len: int):
    """``decode_state_init``'s tree on the ``meta`` device: shapes and
    dtypes without memory."""
    return decode_state_init(cfg, batch, cache_len, device="meta")


def _kv_cache_as_the_reference(cfg: ModelConfig, state) -> None:
    """The JAX package's decode step over its KV cache's type, in place.

    Under ``kv_update="dus"`` its scatter refuses an update whose type
    differs from the cache's ``kv_cache_dtype`` with a ``TypeError``: an
    int8 cache, or a float one of another type than the compute dtype
    (a bfloat16 cache under f32 compute). The port holds a float cache in
    the promoted type and could run, but raises the same error.

    An int8 cache quantizes nothing: under ``"onehot"`` the JAX package
    adds compute-dtype values to it, which promotes the cache to the
    compute dtype, and the state it returns holds ``k`` and ``v`` only
    (the scales are gone). This mirrors that behaviour (``ROADMAP.md``
    Queue 3); it is not a design of an int8 cache.

    A float cache of a wider type than the compute dtype (f32 under bf16)
    under ``"onehot"`` promotes the JAX package's attention output (its
    einsum of bf16 probabilities by f32 values is f32) and with it the
    residual stream, so its ``lax.scan`` over the groups refuses its
    carry: "carry input and carry output must have equal types", a
    ``TypeError`` before anything runs. The port raises the same error
    before it updates anything, so no port path multiplies tensors of
    two float types there."""
    cdt = B._dtype(cfg)
    kv_dt = getattr(torch, cfg.kv_cache_dtype)
    attn = any(blk.mixer == "attn" for blk in cfg.pattern)
    if cfg.kv_update == "dus" and kv_dt != cdt and attn:
        raise TypeError(
            f"decode_step: a {kv_dt} KV cache takes no {cdt} update under "
            f"kv_update='dus' (the JAX package's lax.scatter requires "
            f"arguments to have the same dtypes)")
    if (attn and kv_dt.is_floating_point
            and torch.promote_types(kv_dt, cdt) != cdt):
        raise TypeError(
            f"decode_step: a {kv_dt} KV cache promotes the {cdt} residual "
            f"stream to {torch.promote_types(kv_dt, cdt)} (the JAX "
            f"package's lax.scan over the groups: carry input and carry "
            f"output must have equal types)")
    for blk, st in zip(cfg.pattern, state):
        if blk.mixer == "attn" and not st["kv"]["k"].dtype.is_floating_point:
            kv = st["kv"]
            st["kv"] = {"k": kv["k"].to(cdt), "v": kv["v"].to(cdt)}


# --------------------------------------------------------------------------
# block application
# --------------------------------------------------------------------------

def _apply_block(bp: Params, cfg: ModelConfig, blk: BlockSpec, x, positions,
                 *, ctx=None, state=None, pos=None, dist=None):
    """Returns (x after the block, its MoE auxiliary loss: an f32
    scalar, or None for a block without MoE, whose loss is 0). With
    ``state`` (decode) the block's state is updated in place; a
    cross-attention block then reads its context cache and leaves it as
    it is. Without ``ctx`` a cross-attention block attends over ``x``,
    causally and with rope, as the JAX package's does."""
    h = B.rmsnorm(x, bp["norm1"], cfg.norm_eps)
    if blk.mixer in ("attn", "cross_attn"):
        is_cross = blk.mixer == "cross_attn"
        if state is not None and is_cross:
            mix = B.attn_decode_readonly(bp["mixer"], cfg, h, state["kv"])
        else:
            mix, _ = B.attn_apply(
                bp["mixer"], cfg, h, positions,
                ctx=ctx if is_cross else None,
                cache=None if state is None else state["kv"],
                cache_len=pos, dist=dist)
    elif blk.mixer == "mamba":
        mix, _ = B.mamba_apply(bp["mixer"], cfg, h,
                               state=None if state is None else state["ssm"],
                               dist=dist)
    elif blk.mixer == "rwkv6":
        mix, _ = B.rwkv6_apply(bp["mixer"], cfg, h,
                               state=None if state is None else state["ssm"])
    else:
        raise ValueError(blk.mixer)

    if blk.ffn == "none":
        return x + mix, None
    if blk.parallel:
        # Cohere-style: attn and ffn both read the same normed input
        f, aux = _apply_ffn(bp, cfg, blk, h, state, dist)
        return x + mix + f, aux
    x = x + mix
    h2 = B.rmsnorm(x, bp["norm2"], cfg.norm_eps)
    f, aux = _apply_ffn(bp, cfg, blk, h2, state, dist)
    return x + f, aux


def _apply_ffn(bp, cfg, blk, h, state, dist):
    """Returns (y, MoE auxiliary loss, or None for the other FFNs)."""
    if blk.ffn == "dense":
        return B.ffn_apply(bp["ffn"], cfg, h), None
    if blk.ffn == "moe":
        if cfg.moe_shard == "ep_a2a" and dist is not None:
            return B.moe_apply_ep(bp["ffn"], cfg, h, dist)
        return B.moe_apply(bp["ffn"], cfg, h)
    if blk.ffn != "cmix":
        raise ValueError(blk.ffn)
    xp = None if state is None else state["cm_x_prev"]
    f, last = B.cmix_apply(bp["ffn"], cfg, h, x_prev=xp)
    if state is not None:
        xp.copy_(last)
    return f, None


def _group(tree, g: int):
    """The parameters (or state) of group ``g``: views into the stack."""
    return _tree_map(lambda t: t[g], tree)


def _groups(tree, n: int) -> list:
    """Every group's parameters, views into the stack from one
    ``unbind`` a leaf: its backward stacks the groups' gradients once,
    where indexing each group would add a stack-sized gradient per
    group."""
    leaves = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [t[g] for t in leaves]) for g in range(n)]


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------

def _embed_tokens(params, cfg: ModelConfig, batch, dist=None):
    """``batch["frames"]`` cast to the compute dtype where the frontend
    is ``"frames"`` and the batch holds them; else the embedding rows of
    ``batch["tokens"]`` (a frames model given tokens looks them up too, as
    the JAX package's does). The rows are gathered, then cast: the same
    values as casting the whole table first, as the JAX package writes
    it, without a pass over the table on every step. Where
    ``dist.vocab_parallel(cfg)``, ``dist.vp_embed`` looks the tokens up
    in the rank's vocab slice of the (replicated) table and sums the rows
    over ``model``."""
    dev = params["embed"].device
    if cfg.frontend == "frames" and "frames" in batch:
        return torch.as_tensor(batch["frames"], device=dev).to(B._dtype(cfg))
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    if dist is not None and dist.vocab_parallel(cfg):
        return dist.vp_embed(params["embed"], tokens, cfg)
    return params["embed"][tokens.long()].to(B._dtype(cfg))


def _check_fillable(cfg: ModelConfig, state) -> None:
    """A prefill writes the decode state of attention and Mamba layers
    (``blocks.attn_apply``, ``blocks.mamba_apply``); no other mixer's
    yet."""
    for blk in cfg.pattern:
        if blk.mixer not in ("attn", "mamba"):
            raise NotImplementedError(
                f"{cfg.arch_id}: a prefill does not fill the decode state "
                f"of a {blk.mixer} layer")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("a prefill does not fill an int8 KV cache")
    if len(state) != len(cfg.pattern):
        raise ValueError("state: one entry per pattern position "
                         "(decode_state_init)")


def forward(params: Params, cfg: ModelConfig, batch, *, dist=None,
            state=None):
    """Causal full-sequence forward. batch: {"tokens": (B, S)} or
    {"frames": (B, S, D)}, and {"ctx": (B, Nctx, D)} for the
    cross-attention blocks. Returns (x_final (B, S, D), aux), aux the
    sum of the MoE blocks' auxiliary losses (f32 scalar, 0 without
    MoE). ``state``: a decode state of ``decode_state_init`` (zeros) to
    fill in place as the sequence runs, from position 0: each attention
    layer's KV cache at positions ``0 .. S-1``, each Mamba layer's conv
    and h, so that ``decode_step`` goes on from position S. Other mixers
    raise ``NotImplementedError``."""
    if state is not None:
        _check_fillable(cfg, state)
    x = _embed_tokens(params, cfg, batch, dist)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    ctx = batch.get("ctx")
    if ctx is not None:
        ctx = torch.as_tensor(ctx, device=x.device).to(x.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g, gp in enumerate(_groups(params["blocks"], cfg.n_groups)):
        gs = None if state is None else _group(state, g)
        for p, blk in enumerate(cfg.pattern):
            x, a = _apply_block(gp[p], cfg, blk, x, positions, ctx=ctx,
                                state=None if gs is None else gs[p],
                                dist=dist)
            if a is not None:
                aux = aux + a
    return B.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def lm_head(params: Params, cfg: ModelConfig):
    return params.get("head", params["embed"])


def _logits(params, cfg: ModelConfig, x_last):
    head = lm_head(params, cfg)
    logits = (x_last @ head.to(x_last.dtype).T).float()
    return logits[..., :cfg.vocab_size]


AUX_WEIGHT = 0.01    # the MoE aux loss's weight in ``loss_fn``'s total


def loss_fn(params: Params, cfg: ModelConfig, batch, *, dist=None):
    """Cross-entropy LM loss over ``batch["labels"]`` (B, S), masked
    where a label is < 0. Returns (loss + AUX_WEIGHT * the MoE aux loss,
    {"loss", "aux", "tokens"}), f32 scalars. The logits are the compute
    dtype's product, in f32, sliced to ``vocab_size``; where
    ``dist.vocab_parallel(cfg)``, ``dist.vp_cross_entropy`` computes the
    per-token loss from the rank's slice of the head."""
    x, aux = forward(params, cfg, batch, dist=dist)
    labels = torch.as_tensor(batch["labels"], device=x.device).long()
    head = lm_head(params, cfg)
    if dist is not None and dist.vocab_parallel(cfg):
        ce = dist.vp_cross_entropy(head, x, labels, cfg)
    else:
        logits = (x @ head.to(x.dtype).T).float()[..., :cfg.vocab_size]
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, labels.clamp(min=0)[..., None],
                                  dim=-1)[..., 0]
        ce = lse - ll
    mask = (labels >= 0).float()
    loss = (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    total = loss + AUX_WEIGHT * aux
    return total, {"loss": loss, "aux": aux, "tokens": mask.sum()}


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def decode_step(params: Params, cfg: ModelConfig, state, batch, pos, *,
                dist=None):
    """One decode step. batch: {"tokens": (B, 1)} or {"frames": (B, 1,
    D)}; state: from decode_state_init; pos: (B,) write/attend position.
    A ``"ctx"`` in the batch is not read: cross-attention blocks read
    their context cache in ``state``, as the JAX package's do.

    The KV caches and recurrent states in ``state`` are updated in place
    to save memory (the JAX package returns new ones); the same ``state``
    is returned. Returns (logits (B, vocab) f32, state). An int8 KV
    cache behaves as the JAX package's (``_kv_cache_as_the_reference``):
    promoted to the compute dtype with its scales dropped under
    ``kv_update="onehot"``; under ``"dus"`` a cache whose
    ``kv_cache_dtype`` is not the compute dtype raises ``TypeError``.

    A CPU ``pos`` at or past the KV cache's length raises ``ValueError``
    (``blocks.check_kv_room``), where the JAX package silently drops or
    clamps the cache update. A CUDA ``pos`` is not read on the host,
    which would cost a sync per step: its caller keeps it in range.

    With ``cfg.decode_return == "token"`` and a vocab-parallel ``dist``
    it returns the greedy token ids (B,) int32 in place of the logits
    (``dist.vp_greedy_token``: the (B, V) logits never exist)."""
    _kv_cache_as_the_reference(cfg, state)
    kv = next((st["kv"]["k"] for blk, st in zip(cfg.pattern, state)
               if blk.mixer == "attn"), None)
    if kv is not None:
        B.check_kv_room(pos, kv.shape[-2])
    x = _embed_tokens(params, cfg, batch, dist)
    positions = pos[:, None]
    for g in range(cfg.n_groups):
        gp = _group(params["blocks"], g)
        gs = _group(state, g)
        for p, blk in enumerate(cfg.pattern):
            x, _ = _apply_block(gp[p], cfg, blk, x, positions, state=gs[p],
                                pos=pos, dist=dist)
    x = B.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if (cfg.decode_return == "token" and dist is not None
            and dist.vocab_parallel(cfg)):
        return dist.vp_greedy_token(lm_head(params, cfg), x[:, 0],
                                    cfg), state
    return _logits(params, cfg, x[:, 0]), state


def prefill(params: Params, cfg: ModelConfig, batch, *, dist=None,
            state=None):
    """Full-sequence prefill returning last-position logits (B, vocab)
    f32. On the card every self-attention layer runs the flash attention
    kernel and every rwkv6 layer the WKV6 kernel, once each; a
    cross-attention layer given ``batch["ctx"]`` runs plain torch ops.
    ``state`` (``decode_state_init``'s, at least S long) is filled in
    place for ``decode_step`` to go on from position S (``forward``)."""
    x, _ = forward(params, cfg, batch, dist=dist, state=state)
    return _logits(params, cfg, x[:, -1])
