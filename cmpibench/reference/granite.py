"""A plain reference of the served granite-moe model: torch operations in
float32 (TF32 off: the caller sets ``allow_tf32`` to False), no kernel,
no cache but its own, nothing of the program.

It computes what the program's serve steps are specified to compute, on
the weights the benchmark makes (``cmpibench.weights``):

* prefill: the causal forward of a data rank's rows and the last
  position's logits over the vocabulary;
* decode: one token a row at position ``p`` over a KV cache of the
  request's length that starts at zero, as the program's
  ``decode_state_init`` gives it: its prefill does not fill the cache,
  so the prompt's positions hold zero keys and values;
* the MoE layer as expert parallelism over ``model_size`` ranks runs it:
  one routing group of all the data rank's tokens of the step, top-k of
  the softmax renormalised, places in each expert's queue in (token, k)
  order, capacity ``ceil(tokens * k * capacity_factor / experts)``, and
  on each model rank the slot (its first expert, place capacity - 1)
  lost to a later entry that rank does not keep.

Departures from the published granite-3.0-1b-a400m (ibm-granite on
Hugging Face), all of them the program's, listed in the configuration's
``reduced`` and its ``departures``: no embedding, attention, residual or
logits multipliers (attention scaled by 1/sqrt(head size)), the head not
tied to the embedding, and tokens over capacity dropped.

The controls, each the nearest precision below the one a configuration
states: ``precision="fp8"`` (for bfloat16) rounds every product's
operands to float8 e4m3 with one scale a tensor, ``precision="tf32"``
(for float32 with TF32 off) rounds them to TF32's 10-bit mantissa; the
products are then taken in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale for the tensor."""
    s = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def q_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


ROUND = {"f32": None, "fp8": q8, "tf32": q_tf32}


class Granite:
    def __init__(self, m: dict, w: dict, *, model_size: int,
                 capacity_factor: float, precision: str = "f32"):
        self.q = ROUND[precision]
        self.L = m["num_hidden_layers"]
        self.D = m["hidden_size"]
        self.H = m["num_attention_heads"]
        self.KV = m["num_key_value_heads"]
        self.Dh = self.D // self.H
        self.E = m["num_local_experts"]
        self.K = m["num_experts_per_tok"]
        self.V = m["vocab_size"]
        self.eps = m["rms_norm_eps"]
        self.theta = m["rope_theta"]
        self.tp = model_size
        self.cf = capacity_factor
        self.w = {k: (self._q_weight(v) if self.q and k not in (
            "embed", "final_norm", "norm1", "norm2") else v)
            for k, v in w.items()}
        self.head = self.w["head"][:self.V]

    def _q_weight(self, t):
        """One scale a matrix: per layer, and per expert."""
        if t.dim() <= 2:
            return self.q(t)
        flat = t.reshape(-1, *t.shape[-2:])
        return torch.stack([self.q(x) for x in flat]).reshape(t.shape)

    def mm(self, a, b):
        return (self.q(a) if self.q else a) @ b

    def _rms(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * w

    def _rope(self, x, pos):
        """x (..., H, Dh) at positions ``pos`` broadcast over heads: the
        two halves of a head rotate as pairs."""
        half = self.Dh // 2
        freqs = 1.0 / self.theta ** (torch.arange(
            0, self.Dh, 2, dtype=torch.float32, device=x.device) / self.Dh)
        ang = pos.float()[..., None] * freqs
        cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _attend(self, q, k, v, mask):
        """q (R, Sq, H, Dh), k/v (R, Sk, KV, Dh); ``mask`` (Sq, Sk): the
        pairs allowed."""
        rep = self.H // self.KV
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if self.q:
            qt, kt, vt = self.q(qt), self.q(kt), self.q(vt)
        s = qt @ kt.transpose(-1, -2) / math.sqrt(self.Dh)
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        if self.q:
            p = self.q(p)
        return (p @ vt).transpose(1, 2)              # (R, Sq, H, Dh)

    def _moe(self, layer: int, x):
        """x (N, D), the routing group; returns (N, D)."""
        w = self.w
        n = x.shape[0]
        probs = torch.softmax(self.mm(x, w["router"][layer]), dim=-1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_p, top_e = top_p[:, :self.K], top_e[:, :self.K]
        top_p = top_p / top_p.sum(-1, keepdim=True)
        e = top_e.reshape(-1)                             # (N*K,) flat
        onehot = F.one_hot(e, self.E)
        place = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
        cap = max(1, math.ceil(n * self.K * self.cf / self.E))
        e_loc = self.E // self.tp
        rank = e // e_loc
        kept = place < cap
        idx = torch.arange(e.numel(), device=x.device)
        lost = torch.zeros_like(kept)
        for r in range(self.tp):
            # the last entry in flat order that rank r does not keep
            other = idx[~(kept & (rank == r))]
            last = int(other.max()) if other.numel() else -1
            lost |= ((rank == r) & (e % e_loc == 0) & (place == cap - 1)
                     & (idx < last))
        use = kept & ~lost
        tok = idx[use] // self.K
        ex = e[use]
        wt = top_p.reshape(-1)[use]
        y = torch.zeros_like(x)
        if use.sum() <= 64:
            xs = x[tok][:, None]
            h = F.silu(self.mm(xs, w["w_gate"][layer][ex])) \
                * self.mm(xs, w["w_up"][layer][ex])
            out = self.mm(h, w["w_down"][layer][ex])[:, 0]
            y.index_add_(0, tok, out * wt[:, None])
            return y
        for j in torch.unique(ex).tolist():
            sel = ex == j
            t = tok[sel]
            xs = x[t]
            h = F.silu(self.mm(xs, w["w_gate"][layer, j])) \
                * self.mm(xs, w["w_up"][layer, j])
            y.index_add_(0, t, self.mm(h, w["w_down"][layer, j])
                         * wt[sel][:, None])
        return y

    def _block(self, layer: int, x, pos, kv_write, mask):
        """x (R, S, D); ``kv_write(layer, k, v) -> (k_all, v_all)``."""
        w = self.w
        r, s, _ = x.shape
        h = self._rms(x, w["norm1"][layer])
        q = self.mm(h, w["wq"][layer]).reshape(r, s, self.H, self.Dh)
        k = self.mm(h, w["wk"][layer]).reshape(r, s, self.KV, self.Dh)
        v = self.mm(h, w["wv"][layer]).reshape(r, s, self.KV, self.Dh)
        q, k = self._rope(q, pos), self._rope(k, pos)
        k, v = kv_write(layer, k, v)
        a = self._attend(q, k, v, mask).reshape(r, s, self.H * self.Dh)
        x = x + self.mm(a, w["wo"][layer])
        h = self._rms(x, w["norm2"][layer])
        return x + self._moe(layer, h.reshape(r * s, -1)).reshape(r, s, -1)

    def logits(self, x_last):
        x = self._rms(x_last, self.w["final_norm"])
        return self.mm(x, self.head.T)

    @torch.no_grad()
    def prefill(self, tokens):
        """tokens (R, S): the last position's logits (R, V)."""
        r, s = tokens.shape
        x = self.w["embed"][tokens]
        pos = torch.arange(s, device=x.device)
        causal = torch.ones(s, s, dtype=torch.bool,
                            device=x.device).tril()
        for layer in range(self.L):
            x = self._block(layer, x, pos[None, :], lambda _, k, v: (k, v),
                            causal)
        return self.logits(x[:, -1])

    @torch.no_grad()
    def decode(self, prompt_len: int, tokens):
        """tokens (R, G): the token fed at each of G decode steps, from
        position ``prompt_len`` on, over a cache that starts at zero.
        Returns the logits of every step (R, G, V)."""
        r, g = tokens.shape
        dev = tokens.device
        n = prompt_len + g
        kc = torch.zeros(self.L, r, n, self.KV, self.Dh, device=dev)
        vc = torch.zeros_like(kc)
        out = []
        for i in range(g):
            p = prompt_len + i

            def write(layer, k, v, p=p):
                kc[layer, :, p] = k[:, 0]
                vc[layer, :, p] = v[:, 0]
                return kc[layer, :, :p + 1], vc[layer, :, :p + 1]

            x = self.w["embed"][tokens[:, i:i + 1]]
            mask = torch.ones(1, p + 1, dtype=torch.bool, device=dev)
            pos = torch.full((r, 1), p, device=dev)
            for layer in range(self.L):
                x = self._block(layer, x, pos, write, mask)
            out.append(self.logits(x[:, 0]))
        return torch.stack(out, 1)
