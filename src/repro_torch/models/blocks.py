"""Model building blocks in PyTorch: norms, rotary embeddings, attention
(GQA, causal, chunked, decode with a cache), cross-attention, SwiGLU FFN,
capacity-based MoE, Mamba selective scan, RWKV6 (Finch) time and channel
mix.

All blocks are plain functions ``apply(params, x, ...) -> y`` over
parameter dicts laid out as the JAX package's trees. On a CUDA tensor the
full-sequence causal self-attention, the WKV6 prefill and the Mamba
prefill's scan run the port's hand-written kernels; on the CPU they keep
the JAX package's jnp structure (``_plain_attention`` /
``_chunked_attention``, ``_wkv6_scan``, the selective scan's plain
version), so the CPU tests compare like with like. Meta tensors under the
dry run's counter (``analysis.hlo.count``) take the kernels' route, which
launches nothing; any other device raises.
Cross-attention (queries and keys of different lengths) and the MoE
dispatch are plain torch ops on both devices, as the JAX package computes
them outside any Pallas kernel.

Training (``lm.loss_fn``, driven by ``launch/train.py``) differentiates
these functions with autograd. On the CPU the gradient runs through the
plain versions. On the card the self-attention gradient is the flash
kernel's torch-op backward (``kernels/flash_attention/bwd.py``: the
softmax recomputed a block of query rows at a time), and an rwkv6
layer's is the hand-written ``wkv6_bwd`` kernel (the ``WKV6`` autograd
Function of ``kernels/rwkv6/ops.py``), and a Mamba scan's is autograd's
through its plain version, run again on the saved inputs (the
``SelectiveScan`` Function of ``kernels/selective_scan/ops.py``); every
other block's gradient is autograd's through its torch ops.

The ``dist`` argument is the port's ``distributed.DistContext``: each
rank holds its local tensors, so the blocks' sharding constraints are
identities and attention, rwkv6 and Mamba need nothing of it but its
tracer (the spans of the Mamba mixer and of a prefill's state fill). The
expert-parallel MoE (``moe_apply_ep``) runs the rank's experts and sums
the partial outputs over ``dist``'s ``model`` ranks.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig, ModelConfig, RWKVConfig
from repro_torch.core.trace import (NULL_TRACER, SP_MAMBA_MIXER,
                                    SP_MAMBA_SCAN, SP_MOE_COMBINE,
                                    SP_MOE_DISPATCH, SP_MOE_EXPERTS,
                                    SP_STATE_FILL)
from repro_torch.kernels import route
from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
from repro_torch.kernels.rwkv6.ops import wkv6_bshn
from repro_torch.kernels.selective_scan.ops import CHUNK as SCAN_CHUNK
from repro_torch.kernels.selective_scan.ops import selective_scan

Params = dict[str, Any]

NEG_INF = -1e30


# --------------------------------------------------------------------------
# small helpers
# --------------------------------------------------------------------------

def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32, device="cpu", lead: tuple = ()):
    """Normal(0, 1/sqrt(fan_in)) weights from ``gen``; ``lead`` prepends
    stacking axes (the groups) that do not count in the fan-in."""
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn((*lead, *shape), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)


def fill_state(tr, dst, src) -> None:
    """``dst.copy_(src)``: a prefill writing the decode state, under the
    span ``serve.state_fill`` and counted in ``state_fill_bytes`` while
    the tracer ``tr`` records."""
    sp = tr.push_span(SP_STATE_FILL) if tr.enabled else -1
    dst.copy_(src)
    if tr.enabled:
        tr.pop_span(sp)
        tr.metrics.counter("state_fill_bytes",
                           dst.numel() * dst.element_size())


def rmsnorm(x, scale, eps: float):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device="cpu"):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, n_heads, d_head); positions: (..., S) int. The two
    halves of the head rotate as pairs (split halves, f32)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs             # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]                      # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, *, device="cpu", lead=()) -> Params:
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dt, device=device, lead=lead)
    return {
        "wq": dense_init(gen, (D, H * Dh), **kw),
        "wk": dense_init(gen, (D, KV * Dh), **kw),
        "wv": dense_init(gen, (D, KV * Dh), **kw),
        "wo": dense_init(gen, (H * Dh, D), scale=1.0 / math.sqrt(H * Dh),
                         **kw),
    }


def _repeat_kv(k, n_rep: int):
    """(B, S, KV, Dh) -> (B, S, KV*n_rep, Dh) by head repetition (GQA)."""
    if n_rep == 1:
        return k
    b, s, kv, dh = k.shape
    k = k[:, :, :, None, :].expand(b, s, kv, n_rep, dh)
    return k.reshape(b, s, kv * n_rep, dh)


def _plain_attention(q, k, v, causal: bool, q_offset=0,
                     kv_len: Optional[torch.Tensor] = None):
    """q: (B,Sq,H,Dh)  k,v: (B,Sk,H,Dh). f32 scores and softmax."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(~(kpos <= qpos)[None, None], NEG_INF)
    if kv_len is not None:
        valid = (torch.arange(sk, device=q.device)[None, None, None, :]
                 < kv_len[:, None, None, None])
        scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _chunked_attention(q, k, v, causal: bool, q_chunk: int, kv_chunk: int):
    """Memory-efficient (online-softmax) attention; never materializes SxS.
    The plain mirror of the flash attention kernel, block by block as the
    JAX package computes it: every kv block is visited, those above the
    diagonal fully masked (they change nothing)."""
    b, s, h, dh = q.shape
    sk = k.shape[1]
    if s % q_chunk or sk % kv_chunk:
        raise ValueError(f"chunked attention: {s}/{sk} not divisible by "
                         f"{q_chunk}/{kv_chunk}")
    nq, nk = s // q_chunk, sk // kv_chunk
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for qi in range(nq):
        qb = q[:, qi * q_chunk:(qi + 1) * q_chunk].float()
        acc = torch.zeros((b, h, q_chunk, dh), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32,
                        device=q.device)
        for ki in range(nk):
            kb = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vb = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            scores = torch.einsum("bqhd,bkhd->bhqk", qb, kb.float()) * scale
            if causal:
                qpos = qi * q_chunk + torch.arange(
                    q_chunk, device=q.device)[:, None]
                kpos = ki * kv_chunk + torch.arange(
                    kv_chunk, device=q.device)[None, :]
                scores = scores.masked_fill(~(kpos <= qpos)[None, None],
                                            NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(q.dtype).float(), vb.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2))                 # (B, qc, H, Dh)
    return torch.cat(outs, dim=1).to(q.dtype)


def check_kv_room(pos, cache_len: int) -> None:
    """Refuse a decode position at or past the end of the KV cache.

    The JAX package does not check: there a position past the cache
    silently drops the new token's K/V under ``kv_update="onehot"`` (the
    one-hot of an out-of-range class is all zeros) and, under ``"dus"``,
    clamps the update and overwrites the last slot. Either corrupts the
    cache, so the port raises ``ValueError`` instead.

    Only a ``pos`` on the CPU is checked: reading a CUDA ``pos`` would
    make the host wait for the card on every decode step. A caller that
    builds ``pos`` on the card bounds it on the host (``serve_batch``
    sizes its cache to ``prompt_len + gen``); a CUDA ``pos`` past the
    cache fails the indexed write with a device-side assert instead."""
    if pos.device.type != "cpu":     # the card, or the dry run's meta
        return
    if pos.numel() and int(pos.max()) >= cache_len:
        raise ValueError(
            f"decode position {int(pos.max())} is past the KV cache of "
            f"length {cache_len}: allocate a longer cache "
            f"(decode_state_init's cache_len)")


def attn_decode_readonly(params: Params, cfg: ModelConfig, x, kv_cache):
    """Cross-attention at decode time: q from x (B, 1, D), k/v from the
    static context cache (B, KV, Nctx, Dh). No cache update, no causal
    mask, no rope."""
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    b, s, _ = x.shape
    cdt = _dtype(cfg)
    q = (x @ params["wq"].to(cdt)).reshape(b, s, H, Dh)
    k = _repeat_kv(kv_cache["k"].transpose(1, 2), H // KV)
    v = _repeat_kv(kv_cache["v"].transpose(1, 2), H // KV)
    out = _plain_attention(q, k, v, causal=False)
    return out.reshape(b, s, H * Dh) @ params["wo"].to(cdt)


def attn_apply(params: Params, cfg: ModelConfig, x, positions, *,
               ctx=None, cache=None, cache_len=None, dist=None):
    """Self- or cross-attention.

    x: (B, S, D). ctx: (B, Nctx, D) for cross-attention: K and V come
    from ``ctx``, with no rope and no causal mask, through
    ``_plain_attention`` on both devices (the kernel takes equal query
    and key lengths only). cache: optional dict {k: (B, KV, Smax, Dh),
    v: ...} for self-attention decode; when given with S == 1,
    ``cache_len`` (B,) gives the valid prefix length, which must be <
    Smax: ``lm.decode_step`` checks that once per step for a CPU ``pos``
    (``check_kv_room``) and raises ``ValueError`` where the JAX package
    drops or clamps the update. The cache is updated in place (the JAX
    package returns a new one): the one-hot update keeps its add
    semantics, the ``dus`` update is an indexed write. Given with S > 1,
    a prefill from position 0, the attention is the full-sequence one
    and the cache's positions ``0 .. S-1`` take the sequence's K and V
    as decode would write them (after rope, where the config has it).
    Returns (out, cache). Without ``cfg.attn_rope`` self-attention has
    no positional encoding.

    ``dist`` is read for its tracer alone. Each rank holds the whole
    cache of its rows, so the JAX package's ``decode_attn="flashdecode"``
    (the cache sharded
    over ``model``, the softmax reduced across it) is the same function
    as the plain path computed here.
    """
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    b, s, _ = x.shape
    cdt = _dtype(cfg)
    is_cross = ctx is not None
    kv_src = ctx if is_cross else x
    q = (x @ params["wq"].to(cdt)).reshape(b, s, H, Dh)
    k = (kv_src @ params["wk"].to(cdt)).reshape(b, -1, KV, Dh)
    v = (kv_src @ params["wv"].to(cdt)).reshape(b, -1, KV, Dh)
    if not is_cross and cfg.attn_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and s > 1:
        if s > cache["k"].shape[2]:
            raise ValueError(f"a prefill of {s} tokens does not fit a KV "
                             f"cache of {cache['k'].shape[2]}")
        tr = dist.tracer if dist is not None else NULL_TRACER
        fill_state(tr, cache["k"][:, :, :s], k.transpose(1, 2))
        fill_state(tr, cache["v"][:, :, :s], v.transpose(1, 2))
    if cache is not None and s == 1:
        k_cache, v_cache = cache["k"], cache["v"]     # (B, KV, Smax, Dh)
        pos = cache_len                                # (B,) int
        kn, vn = k.transpose(1, 2), v.transpose(1, 2)  # (B, KV, 1, Dh)
        if cfg.kv_update == "dus":
            rows = torch.arange(b, device=x.device)
            k_cache[rows, :, pos] = kn[:, :, 0].to(k_cache.dtype)
            v_cache[rows, :, pos] = vn[:, :, 0].to(v_cache.dtype)
        else:
            oh = F.one_hot(pos.long(), k_cache.shape[2]).to(k.dtype)
            k_cache.add_(oh[:, None, :, None] * kn)
            v_cache.add_(oh[:, None, :, None] * vn)
        k_full = _repeat_kv(k_cache.transpose(1, 2), H // KV)
        v_full = _repeat_kv(v_cache.transpose(1, 2), H // KV)
        out = _plain_attention(q, k_full, v_full, causal=False,
                               kv_len=cache_len + 1)
    elif is_cross:
        out = _plain_attention(q, _repeat_kv(k, H // KV),
                               _repeat_kv(v, H // KV), causal=False)
    elif route("attention", q, k, v) != "cpu":
        # the card (or the dry run's meta route): the kernel maps query
        # head h to kv head h // (H // KV) itself
        out = flash_attention_bshd(q, k, v, causal=True)
    else:
        k = _repeat_kv(k, H // KV)
        v = _repeat_kv(v, H // KV)
        chunk = cfg.attn_chunk or (1024 if s > 8192 else 0)
        if chunk and s % chunk == 0:
            out = _chunked_attention(q, k, v, causal=True, q_chunk=chunk,
                                     kv_chunk=chunk)
        else:
            out = _plain_attention(q, k, v, causal=True)
    out = out.reshape(b, s, H * Dh)
    return out @ params["wo"].to(cdt), cache


# --------------------------------------------------------------------------
# FFNs
# --------------------------------------------------------------------------

def ffn_init(gen, cfg: ModelConfig, *, device="cpu", lead=()) -> Params:
    D, Fd = cfg.d_model, cfg.d_ff
    kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device,
              lead=lead)
    return {
        "w_gate": dense_init(gen, (D, Fd), **kw),
        "w_up": dense_init(gen, (D, Fd), **kw),
        "w_down": dense_init(gen, (Fd, D), scale=1.0 / math.sqrt(Fd), **kw),
    }


def ffn_apply(params: Params, cfg: ModelConfig, x):
    cdt = _dtype(cfg)
    g = x @ params["w_gate"].to(cdt)
    u = x @ params["w_up"].to(cdt)
    return (F.silu(g) * u) @ params["w_down"].to(cdt)


def cmix_init(gen, cfg: ModelConfig, *, device="cpu", lead=()) -> Params:
    """RWKV channel-mix: receptance-gated squared-relu FFN with token shift."""
    D, Fd = cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dt, device=device, lead=lead)
    return {
        "cm_r": dense_init(gen, (D, D), **kw),
        "cm_k": dense_init(gen, (D, Fd), **kw),
        "cm_v": dense_init(gen, (Fd, D), scale=1.0 / math.sqrt(Fd), **kw),
        "mix_k": torch.full((*lead, D), 0.5, dtype=dt, device=device),
        "mix_r": torch.full((*lead, D), 0.5, dtype=dt, device=device),
    }


def _shift(x, x_prev):
    """The previous token of each position: zero before the first, or
    ``x_prev`` (B, D) at decode (S == 1)."""
    if x_prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return x_prev[:, None, :]


def cmix_apply(params: Params, cfg: ModelConfig, x, x_prev=None):
    """x: (B,S,D). x_prev: (B,D) decode-state token shift; returns
    (y, last_x)."""
    cdt = _dtype(cfg)
    shifted = _shift(x, x_prev)
    mk, mr = params["mix_k"].to(cdt), params["mix_r"].to(cdt)
    xk = x * mk + shifted * (1 - mk)
    xr = x * mr + shifted * (1 - mr)
    r = torch.sigmoid(xr @ params["cm_r"].to(cdt))
    k = torch.square(torch.relu(xk @ params["cm_k"].to(cdt)))
    return r * (k @ params["cm_v"].to(cdt)), x[:, -1, :]


# --------------------------------------------------------------------------
# MoE (GShard-style capacity dispatch)
# --------------------------------------------------------------------------

def moe_init(gen, cfg: ModelConfig, *, device="cpu", lead=()) -> Params:
    """The router over all ``moe.n_experts``, the expert leaves of the
    ``cfg.n_held`` held here."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    held = cfg.n_held
    kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device,
              lead=lead)
    return {
        "router": dense_init(gen, (D, E), scale=0.02, **kw),
        "w_gate": dense_init(gen, (held, D, Fd), scale=1.0 / math.sqrt(D),
                             **kw),
        "w_up": dense_init(gen, (held, D, Fd), scale=1.0 / math.sqrt(D),
                           **kw),
        "w_down": dense_init(gen, (held, Fd, D), scale=1.0 / math.sqrt(Fd),
                             **kw),
    }


def moe_capacity(cfg: ModelConfig, group_tokens: int) -> int:
    moe = cfg.moe
    c = math.ceil(group_tokens * moe.top_k * moe.capacity_factor
                  / moe.n_experts)
    return max(c, 1)


def _top_k(probs, k: int):
    """``lax.top_k``'s order: largest first, the lower index first on
    ties (a stable descending sort; ``torch.topk`` leaves ties in no
    stated order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xg, router, cfg: ModelConfig):
    """The router over groups ``xg`` (G, T, D): (probs (G, T, E) f32,
    top-k weights (renormalised unless ``cfg.moe_renormalize`` is
    False) and experts (G, T, K), the one-hot
    assignment (G, T, K, E), each (token, k)'s place in its expert's
    queue (G, T, K) int64).

    The place is the JAX package's cumsum of the one-hot over the
    (token, k) axis, in int64 (the same counts; a float cumsum on the
    card has no deterministic implementation), as the last axis of a
    (G, E, T*K) copy: a scan along a middle axis runs one thread per
    (group, expert) down T*K rows on the card."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    groups, gtok, _ = xg.shape
    logits = (xg @ router.to(_dtype(cfg))).float()              # (G,T,E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, K)                              # (G,T,K)
    if cfg.moe_renormalize:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(top_e, E)                                 # (G,T,K,E)
    flat = onehot.reshape(groups, gtok * K, E)
    pos = flat.transpose(1, 2).contiguous().cumsum(-1).transpose(1, 2) \
        - flat
    pos = (pos * flat).sum(-1).reshape(groups, gtok, K)
    return probs, top_p, top_e, onehot, pos


def _dispatch(slot, vals, n_slots: int, empty: int):
    """The (G, n_slots) dispatch table: each slot takes the value of the
    last (token, k) in flat order that writes it (``slot``, ``vals``:
    (G, T*K)), ``empty`` where none does. That is the JAX package's
    scatter on XLA's CPU (the last write wins); a scatter with repeated
    indices has no stated order on the card, so the port takes an
    ``amax`` of the flat index per slot."""
    groups, n = slot.shape
    order = torch.arange(n, device=slot.device).expand(groups, n)
    last = torch.full((groups, n_slots), -1, dtype=torch.long,
                      device=slot.device)
    last.scatter_reduce_(1, slot, order, "amax")
    return torch.where(last >= 0, vals.gather(1, last.clamp_min(0)), empty)


def _experts(xg, dispatch, w_gate, w_up, w_down, cdt):
    """The SwiGLU experts over their slots: (G, E*C, D) outputs of the
    (E, D, F) / (E, F, D) weights for the tokens ``dispatch`` (G, E*C)
    names (the sentinel ``T`` reads a zero row)."""
    groups, gtok, d = xg.shape
    E = w_gate.shape[0]
    xpad = torch.cat([xg, xg.new_zeros(groups, 1, d)], dim=1)
    rows = torch.arange(groups, device=xg.device)[:, None]
    expert_in = xpad[rows, dispatch].reshape(groups, E, -1, d)
    h_g = torch.einsum("gecd,edf->gecf", expert_in, w_gate.to(cdt))
    h_u = torch.einsum("gecd,edf->gecf", expert_in, w_up.to(cdt))
    out = torch.einsum("gecf,efd->gecd", F.silu(h_g) * h_u, w_down.to(cdt))
    return out.reshape(groups, -1, d)


def _combine(expert_out, dispatch, slot, vals, keep, top_p):
    """Each kept (token, k)'s weighted expert output, gathered from its
    slot where the table still names that token, summed over k in f32:
    (G, T, D) f32, the JAX package's scatter-add over slots without
    atomics. The product is of the gathered outputs (upcast exactly) and
    their f32 weights; autograd keeps the gathered outputs in their own
    type."""
    groups, gtok, K = top_p.shape
    rows = torch.arange(groups, device=slot.device)[:, None]
    mine = keep.reshape(groups, -1) & (dispatch.gather(1, slot) == vals)
    w = torch.where(mine, top_p.reshape(groups, -1), 0.0)
    picked = expert_out[rows, slot]
    return (picked * w[..., None]).reshape(groups, gtok, K, -1).sum(2)


def _aux_loss(probs, onehot, cfg: ModelConfig):
    """Switch-style load balancing over every group and token."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = onehot.sum(dim=2).float().mean(dim=(0, 1))  # fraction routed
    return E * torch.sum(me * ce / K)


def moe_apply(params: Params, cfg: ModelConfig, x):
    """x: (B, S, D) -> (y, aux_loss), the JAX package's GShard dispatch.

    Groups are rows of the batch when S > 1, or groups of ``min(B, 16)``
    adjacent rows for decode shapes (S == 1). A (token, k)'s place in its
    expert's queue is the cumsum of the one-hot assignment; places at or
    past the capacity C are dropped. The (G, E, C) dispatch table holds
    token ids, ``gtok`` (a zero row of ``xpad``) where a slot is empty.

    The JAX package writes the table with one scatter in which a dropped
    (token, k) writes the sentinel into slot (expert 0, C - 1); where a
    kept token holds that slot, XLA's CPU scatter keeps the last write in
    flat (token, k) order, so a later dropped entry takes the slot and
    the kept token loses its expert-0 output (``ROADMAP.md`` Queue 3).
    The port reproduces that rule on both devices (``_dispatch``).

    Where the config holds ``cfg.n_held`` of the experts (a block from
    ``cfg.moe_held_offset``), the router still routes over all of them at
    their capacity, and an entry for an expert not held here is dropped
    as one over capacity is: this layer's share of the whole layer's
    output.
    """
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    held, lo = cfg.n_held, cfg.moe_held_offset
    if params["w_gate"].shape[0] != held:
        raise ValueError(f"moe_apply: expert leaves of "
                         f"{params['w_gate'].shape[0]} experts, the config "
                         f"holds {held} (a block runs only in moe_apply_ep)")
    b, s, d = x.shape
    if s > 1:
        groups, gtok = b, s
        xg = x
    else:
        gsz = min(b, 16)
        groups, gtok = b // gsz, gsz
        xg = x.reshape(groups, gtok, d)
    C = moe_capacity(cfg, gtok)
    probs, top_p, top_e, onehot, pos = _route(xg, params["router"], cfg)
    keep = (pos < C) & (top_e >= lo) & (top_e < lo + held)
    # the slot each (token, k) writes, flat over (held, C); dropped ones
    # all write the sentinel into (0, C - 1)
    slot = torch.where(keep, (top_e - lo) * C + pos, C - 1).reshape(
        groups, -1)
    tok_ids = torch.arange(gtok, device=x.device)[None, :, None].expand(
        groups, gtok, K)
    vals = torch.where(keep, tok_ids, gtok).reshape(groups, -1)
    dispatch = _dispatch(slot, vals, held * C, gtok)
    expert_out = _experts(xg, dispatch, params["w_gate"], params["w_up"],
                          params["w_down"], _dtype(cfg))
    y = _combine(expert_out, dispatch, slot, vals, keep, top_p).to(
        _dtype(cfg))
    if s == 1:
        y = y.reshape(b, s, d)
    return y, _aux_loss(probs, onehot, cfg)


def moe_apply_ep(params: Params, cfg: ModelConfig, x, dist):
    """Expert-parallel MoE over ``dist``'s ``model`` ranks, the JAX
    package's ``shard_map`` of ``cfg.moe_shard == "ep_a2a"``.

    Every model rank holds the same (B_loc, S, D) tokens (they are split
    over the dp axes only) and routes them as ONE group of B_loc * S, for
    prefill and decode alike, at ``moe_capacity(cfg, B_loc * S)``. Places
    are taken in the global expert queues; rank m keeps the entries of
    its experts ``[m * E_loc, (m + 1) * E_loc)`` within the capacity, and
    every other entry (dropped, or another rank's) writes the sentinel
    into (local expert 0, slot C - 1), the last write in flat order
    winning, as ``moe_apply``'s clobber (``_dispatch``): so the kept token
    in that slot loses its output whenever a later non-local entry
    follows it. Each rank runs its experts and combines in f32; the f32
    partial outputs are summed over ``model`` (one (B_loc, S, D)
    allreduce a layer), then cast to the compute dtype. Where TP <= 1 or
    E % TP it is ``moe_apply``.

    The expert leaves are the whole (E, D, F) / (E, F, D), from which the
    rank takes its block, or the block alone (E_loc, ...), as
    ``DistContext.shard_leaf`` cuts them by ``sharding.param_pspecs``.
    Where the config holds ``cfg.n_held`` of the E experts from
    ``cfg.moe_held_offset``, the model ranks split that block (E_loc =
    n_held / TP, the whole leaves hold n_held), every rank routes over
    all E at their capacity, and entries for experts not held on this
    chip are another rank's.

    Gradients are ``jax.grad``'s through the JAX package's ``shard_map``:
    the output's gradient reaches every rank as it is, and x's and the
    router's are summed over ``model`` (each rank used them for its own
    experts). Every model rank computes the same aux loss, so its
    gradient is divided by TP before that sum, to count once. A whole
    expert leaf gets the gradient of the rank's block only: the caller
    sums it over ``model`` (``train.steps``). The aux is the rank's own
    rows'; the JAX package returns data shard 0's on every shard, though
    its gradient is the shards' mean, and ``train.steps.make_train_step``
    reports shard 0's as it does.
    """
    K = cfg.moe.top_k
    held = cfg.n_held
    tp = dist.model_size
    if tp <= 1 or held % tp:
        return moe_apply(params, cfg, x)
    e_loc = held // tp
    first = dist.axis_index("model") * e_loc
    lo = cfg.moe_held_offset + first
    ws = [params[k] for k in ("w_gate", "w_up", "w_down")]
    if ws[0].shape[0] == held:
        ws = [w[first:first + e_loc] for w in ws]
    elif ws[0].shape[0] != e_loc:
        raise ValueError(f"moe_apply_ep: expert leaves of {ws[0].shape[0]} "
                         f"experts: {held} whole or {e_loc} a model rank")
    b, s, d = x.shape
    gtok = b * s
    # host spans of the three phases, on the mesh's tracer while it records
    tr = dist.tracer
    sp = -1
    if tr.enabled:
        sp = tr.push_span(SP_MOE_DISPATCH)
    xg = dist.replicated_over_model(x).reshape(1, gtok, d)
    probs, top_p, top_e, onehot, pos = _route(
        xg, dist.replicated_over_model(params["router"]), cfg)
    C = moe_capacity(cfg, gtok)
    keep = (pos < C) & (top_e >= lo) & (top_e < lo + e_loc)
    slot = torch.where(keep, (top_e - lo) * C + pos, C - 1).reshape(1, -1)
    tok_ids = torch.arange(gtok, device=x.device)[None, :, None].expand(
        1, gtok, K)
    vals = torch.where(keep, tok_ids, gtok).reshape(1, -1)
    dispatch = _dispatch(slot, vals, e_loc * C, gtok)
    if tr.enabled:
        tr.pop_span(sp)
        sp = tr.push_span(SP_MOE_EXPERTS)
    expert_out = _experts(xg, dispatch, *ws, _dtype(cfg))
    if tr.enabled:
        tr.pop_span(sp)
        sp = tr.push_span(SP_MOE_COMBINE)
    out = _combine(expert_out, dispatch, slot, vals, keep, top_p)
    y = dist.sum_over_model(out).reshape(b, s, d).to(_dtype(cfg))
    if tr.enabled:
        tr.pop_span(sp)
    return y, dist.once_over_model(_aux_loss(probs, onehot, cfg))


# --------------------------------------------------------------------------
# Mamba (selective state space)
# --------------------------------------------------------------------------

def mamba_init(gen, cfg: ModelConfig, *, device="cpu", lead=()) -> Params:
    mc = cfg.mamba or MambaConfig()
    D = cfg.d_model
    d_in = mc.expand * D
    dt_rank = mc.dt_rank or -(-D // 16)
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dt, device=device, lead=lead)
    a_log = torch.log(torch.arange(1, mc.d_state + 1, dtype=torch.float32,
                                   device=device))
    norms = {}
    if cfg.mamba_inner_norms:
        norms = {name: torch.ones((*lead, n), dtype=dt, device=device)
                 for name, n in (("dt_norm", dt_rank), ("b_norm", mc.d_state),
                                 ("c_norm", mc.d_state))}
    return {
        **norms,
        "in_proj": dense_init(gen, (D, 2 * d_in), **kw),
        "conv_w": dense_init(gen, (mc.d_conv, d_in), scale=0.5, **kw),
        "conv_b": torch.zeros((*lead, d_in), dtype=dt, device=device),
        "x_proj": dense_init(gen, (d_in, dt_rank + 2 * mc.d_state), **kw),
        "dt_proj": dense_init(gen, (dt_rank, d_in), **kw),
        "dt_bias": torch.full((*lead, d_in), -4.6, dtype=dt,
                              device=device),     # softplus^-1(0.01)
        "A_log": a_log.repeat(*lead, d_in, 1).to(dt),
        "D": torch.ones((*lead, d_in), dtype=dt, device=device),
        "out_proj": dense_init(gen, (d_in, D), **kw),
    }


def _selective_scan(u, dt, B, Cm, A, h=None, tr=NULL_TRACER):
    """u: (b, S, d_in); dt: (b, S, d_in); B, Cm: (b, S, N); A: (d_in, N).

    h_t = exp(A*dt_t) h_{t-1} + dt_t * B_t * u_t;  y_t = <Cm_t, h_t>.
    ``kernels/selective_scan``: the hand-written kernel on the card, the
    JAX package's chunked scan in torch ops on the CPU.

    ``h`` (b, d_in, N) f32: the state before the first token (zeros where
    None), overwritten with the state after the last (``fill_state``).
    ``tr``: a tracer that counts, while it records, the plain version's
    64-token chunks (``mamba_scan_chunks``) and the layers the kernel
    scanned (``mamba_scan_kernel``).
    """
    y, h_last = selective_scan(u, dt, B, Cm, A, h)
    if h is not None:
        fill_state(tr, h, h_last)
    if tr.enabled:
        tr.metrics.counter("mamba_scan_chunks", -(-u.shape[1] // SCAN_CHUNK))
        if u.is_cuda:
            tr.metrics.counter("mamba_scan_kernel")
    return y


def mamba_apply(params: Params, cfg: ModelConfig, x, *, state=None,
                dist=None):
    """x: (B, S, D). state: {conv: (B, d_conv-1, d_in), h: (B, d_in, N)},
    updated in place (the JAX package returns a new one) to the state
    after x: for decode (S == 1) as the JAX package steps it; for a
    prefill (S > 1) the state then holds the last d_conv - 1 pre-conv
    inputs and the scan's last h (a zero state gives the full-sequence
    path's numbers).
    Returns (y, state or None). With ``cfg.mamba_inner_norms`` x_proj's
    dt, B and C pass through RMSNorms (``dt_norm``, ``b_norm``,
    ``c_norm``) before dt_proj and the scan. ``dist``'s tracer, while it
    records, takes the spans ``mamba.mixer`` and ``mamba.scan``."""
    mc = cfg.mamba or MambaConfig()
    cdt = _dtype(cfg)
    b, s, _ = x.shape
    tr = dist.tracer if dist is not None else NULL_TRACER
    sp = -1
    if tr.enabled:
        sp = tr.push_span(SP_MAMBA_MIXER)
    xz = x @ params["in_proj"].to(cdt)
    xi, z = xz.chunk(2, dim=-1)                        # (B,S,d_in) each

    conv_w = params["conv_w"].to(cdt)                  # (d_conv, d_in)
    decode = state is not None and s == 1
    if decode:
        hist = torch.cat([state["conv"], xi], dim=1)   # (B, d_conv, d_in)
        conv = torch.einsum("bcd,cd->bd", hist, conv_w)[:, None]
        state["conv"].copy_(hist[:, 1:])
    else:
        xpad = F.pad(xi, (0, 0, mc.d_conv - 1, 0)) if state is None \
            else torch.cat([state["conv"], xi], dim=1)
        conv = sum(xpad[:, i:i + s] * conv_w[i] for i in range(mc.d_conv))
        if state is not None:
            fill_state(tr, state["conv"], xpad[:, s:])
    conv = F.silu(conv + params["conv_b"].to(cdt))

    proj = conv @ params["x_proj"].to(cdt)
    dt_rank = params["dt_proj"].shape[0]
    dt_x, Bm, Cm = proj.split([dt_rank, mc.d_state, mc.d_state], dim=-1)
    if cfg.mamba_inner_norms:
        dt_x = rmsnorm(dt_x, params["dt_norm"], cfg.norm_eps)
        Bm = rmsnorm(Bm, params["b_norm"], cfg.norm_eps)
        Cm = rmsnorm(Cm, params["c_norm"], cfg.norm_eps)
    dt = F.softplus((dt_x @ params["dt_proj"].to(cdt)).float()
                    + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())

    if not decode:
        ssp = tr.push_span(SP_MAMBA_SCAN) if tr.enabled else -1
        y = _selective_scan(conv.float(), dt, Bm.float(), Cm.float(), A,
                            h=None if state is None else state["h"], tr=tr)
        if tr.enabled:
            tr.pop_span(ssp)
    else:
        h = state["h"]                                 # (B, d_in, N) f32
        dA = torch.exp(dt[:, 0, :, None] * A[None])
        dBu = (dt[:, 0] * conv[:, 0].float())[..., None] \
            * Bm[:, 0, None, :].float()
        h.mul_(dA).add_(dBu)
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())[:, None]
    y = y + conv.float() * params["D"].float()
    y = y.to(cdt) * F.silu(z)
    out = y @ params["out_proj"].to(cdt)
    if tr.enabled:
        tr.pop_span(sp)
    return out, state


def mamba_state_init(cfg: ModelConfig, batch: int, *, device="cpu",
                     lead=()):
    mc = cfg.mamba or MambaConfig()
    d_in = mc.expand * cfg.d_model
    return {
        "conv": torch.zeros((*lead, batch, mc.d_conv - 1, d_in),
                            dtype=_dtype(cfg), device=device),
        "h": torch.zeros((*lead, batch, d_in, mc.d_state),
                         dtype=torch.float32, device=device),
    }


# --------------------------------------------------------------------------
# RWKV6 (Finch) time mix
# --------------------------------------------------------------------------

def rwkv6_init(gen, cfg: ModelConfig, *, device="cpu", lead=()) -> Params:
    rc = cfg.rwkv or RWKVConfig()
    D = cfg.d_model
    H = D // rc.head_size
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dt, device=device, lead=lead)
    return {
        "wr": dense_init(gen, (D, D), **kw),
        "wk": dense_init(gen, (D, D), **kw),
        "wv": dense_init(gen, (D, D), **kw),
        "wg": dense_init(gen, (D, D), **kw),
        "wo": dense_init(gen, (D, D), **kw),
        "w0": torch.full((*lead, D), -2.0, dtype=dt, device=device),
        "w_a": dense_init(gen, (D, rc.decay_lora), **kw),
        "w_b": dense_init(gen, (rc.decay_lora, D), scale=0.1, **kw),
        "u": dense_init(gen, (H, rc.head_size), scale=0.5, **kw),
        "mix_x": torch.full((*lead, D), 0.5, dtype=dt, device=device),
    }


def _wkv6_scan(r, k, v, w, u):
    """Linear recurrence with data-dependent per-channel decay (exact).

    r,k,v: (B,S,H,n); w: (B,S,H,n) decay in (0,1); u: (H,n) bonus.
        S_t = diag(w_t) S_{t-1} + k_t v_t^T
        o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
    Sequential over time, f32 -- the plain version the CPU runs.
    """
    b, S, h, n = r.shape
    r, k, v, w = (a.float() for a in (r, k, v, w))
    uu = u[None, :, :, None]
    state = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        kv = torch.einsum("bhn,bhm->bhnm", k[:, t], v[:, t])
        outs.append(torch.einsum("bhn,bhnm->bhm", r[:, t], state + uu * kv))
        state = state * w[:, t, ..., None] + kv
    return torch.stack(outs, dim=1)                 # (B, S, H, n)


def rwkv6_apply(params: Params, cfg: ModelConfig, x, *, state=None):
    """x: (B,S,D). state: {"S": (B,H,n,n), "x_prev": (B,D)} for decode,
    updated in place (the JAX package returns a new one). Returns
    (y, state or None)."""
    rc = cfg.rwkv or RWKVConfig()
    cdt = _dtype(cfg)
    b, s, D = x.shape
    n = rc.head_size
    H = D // n

    shifted = _shift(x, None if state is None else state["x_prev"])
    mix = params["mix_x"].to(cdt)
    xm = x * mix + shifted * (1 - mix)

    r = (xm @ params["wr"].to(cdt)).reshape(b, s, H, n)
    k = (xm @ params["wk"].to(cdt)).reshape(b, s, H, n)
    v = (xm @ params["wv"].to(cdt)).reshape(b, s, H, n)
    g = F.silu(xm @ params["wg"].to(cdt))
    w_log = params["w0"].float() + (
        torch.tanh(xm @ params["w_a"].to(cdt)) @ params["w_b"].to(cdt)
    ).float()
    w = torch.exp(-torch.exp(w_log)).reshape(b, s, H, n)   # decay in (0,1)
    u = params["u"].float()

    if state is None:
        if route("wkv6", r, k, v, w, u) != "cpu":   # card, or meta
            o = wkv6_bshn(r, k, v, w, u)
        else:
            o = _wkv6_scan(r, k, v, w, u)
    else:
        S0 = state["S"]                                # (B,H,n,n)
        rf, kf, vf, wf = (a[:, 0].float() for a in (r, k, v, w))
        kv = torch.einsum("bhn,bhm->bhnm", kf, vf)
        o = torch.einsum("bhn,bhnm->bhm", rf,
                         S0 + u[None, :, :, None] * kv)[:, None]
        S0.mul_(wf[..., None]).add_(kv)
        state["x_prev"].copy_(x[:, -1, :])
    o = o.reshape(b, s, D).to(cdt) * g
    return o @ params["wo"].to(cdt), state


def rwkv6_state_init(cfg: ModelConfig, batch: int, *, device="cpu",
                     lead=()):
    rc = cfg.rwkv or RWKVConfig()
    H = cfg.d_model // rc.head_size
    return {
        "S": torch.zeros((*lead, batch, H, rc.head_size, rc.head_size),
                         dtype=torch.float32, device=device),
        "x_prev": torch.zeros((*lead, batch, cfg.d_model),
                              dtype=_dtype(cfg), device=device),
    }
