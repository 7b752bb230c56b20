"""A plain reference of the served Jamba model (AI21-Jamba2-Mini's layer
equations): torch operations in float32 (TF32 off: the caller sets
``allow_tf32`` to False), no kernel, no cache, no batching, nothing of
the program.

It follows the published equations (HF ``modeling_jamba``, as recalled,
not read):

* the layers: ``attn_layer_period``/``attn_layer_offset`` place the
  attention layers among Mamba-1 layers, ``expert_layer_period``/
  ``expert_layer_offset`` the MoE FFNs among dense SwiGLU ones; each
  layer is ``x + mixer(rmsnorm(x))`` then ``x + ffn(rmsnorm(x))``, with
  a final RMSNorm and an untied head;
* attention: GQA, causal, softmax in float32, scaled by 1/sqrt(head
  size), no positional encoding;
* Mamba-1: in_proj to (x, z), a causal depthwise conv of ``d_conv``
  taps with bias, SiLU, x_proj to (dt, B, C), RMSNorms on each of the
  three, dt_proj with bias and softplus, the selective scan
  h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t, y_t = <C_t, h_t> + D x_t,
  times SiLU(z), out_proj; the scan is taken token by token, in blocks
  of ``SCAN_BLOCK`` positions so that an 8192-token row fits;
* the router: a bias-free linear layer over all routed experts, softmax
  in float32, top-k, the weights NOT renormalised.

Departures, both of the deployment the configuration states, and
mirrored from the program's expert-parallel MoE as
``reference/granite.py`` mirrors it:

* the chip's share of the experts: the router routes over all
  ``router_experts``, but only the block of ``num_experts`` from
  ``held_expert_offset`` is computed; what the others would add is left
  out;
* the capacity rule with its clobber: each routing group's entries take
  places in their expert's queue in (token, k) order, capacity
  ``ceil(tokens * k * capacity_factor / router_experts)``; the held
  block is split over ``model_size`` ranks, and on each rank the slot
  (its first expert, place capacity - 1) is lost to a later entry that
  rank does not keep. The routing groups are the program's serve steps:
  a data rank's whole prompt (rows x prompt tokens) as one, then each
  decode position's rows as one.

The control, the nearest precision below bfloat16 (``precision="fp8"``,
``reference.granite.q8``): every product's operands rounded to float8
e4m3 with one scale a tensor (a weight matrix, one expert's matrix),
the products then taken in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .granite import ROUND

SCAN_BLOCK = 256        # positions of a block of the scan's terms
Q_BLOCK = 1024          # query rows attended at a time


def layer_kinds(m: dict) -> list[tuple[str, str]]:
    """(mixer, ffn) of each layer: ``"attn"``/``"mamba"``,
    ``"moe"``/``"dense"``."""
    return [("attn" if i % m["attn_layer_period"] == m["attn_layer_offset"]
             else "mamba",
             "moe" if i % m["expert_layer_period"]
             == m["expert_layer_offset"] else "dense")
            for i in range(m["num_hidden_layers"])]


class Jamba:
    def __init__(self, m: dict, w: dict, *, model_size: int,
                 capacity_factor: float, precision: str = "f32"):
        """``w``: flat float32 leaves named ``"<layer>.<leaf>"`` (matrices
        laid out ``x @ w``), the held experts stacked ``(num_experts,
        ...)``, and ``embed``, ``head``, ``final_norm``."""
        self.q = ROUND[precision]
        self.kinds = layer_kinds(m)
        self.D = m["hidden_size"]
        self.H = m["num_attention_heads"]
        self.KV = m["num_key_value_heads"]
        self.Dh = self.D // self.H
        self.E = m["router_experts"]
        self.held = m["num_experts"]
        self.lo = m["held_expert_offset"]
        self.K = m["num_experts_per_tok"]
        self.V = m["vocab_size"]
        self.N = m["mamba_d_state"]
        self.R = m["mamba_dt_rank"]
        self.eps = m["rms_norm_eps"]
        self.tp = model_size
        self.cf = capacity_factor
        self.w = w

    # ------------------------------------------------------------------
    # pieces

    def mm(self, a, b):
        if self.q is None:
            return a @ b
        return self.q(a) @ self.q(b)

    def _rms(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * w

    def _attention(self, i: int, h):
        """h (R, T, D): causal GQA attention without positions."""
        w = self.w
        r, t, _ = h.shape
        q = self.mm(h, w[f"{i}.wq"]).reshape(r, t, self.H, self.Dh)
        k = self.mm(h, w[f"{i}.wk"]).reshape(r, t, self.KV, self.Dh)
        v = self.mm(h, w[f"{i}.wv"]).reshape(r, t, self.KV, self.Dh)
        rep = self.H // self.KV
        qt, kt, vt = (x.transpose(1, 2) for x in (
            q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)))
        if self.q:
            qt, kt, vt = self.q(qt), self.q(kt), self.q(vt)
        out = torch.empty_like(qt)
        for a in range(0, t, Q_BLOCK):
            b = min(a + Q_BLOCK, t)
            s = qt[:, :, a:b] @ kt[:, :, :b].transpose(-1, -2) \
                / math.sqrt(self.Dh)
            allowed = (torch.arange(b, device=h.device)[None, :]
                       <= torch.arange(a, b, device=h.device)[:, None])
            p = torch.softmax(s.masked_fill(~allowed, float("-inf")), -1)
            if self.q:
                p = self.q(p)
            out[:, :, a:b] = p @ vt[:, :, :b]
        a = out.transpose(1, 2).reshape(r, t, self.H * self.Dh)
        return self.mm(a, w[f"{i}.wo"])

    def _scan(self, u, dt, B, C, A):
        """u, dt (R, T, d); B, C (R, T, N); A (d, N): y (R, T, d), token
        by token."""
        r, t, d = u.shape
        h = torch.zeros(r, d, self.N, device=u.device)
        y = torch.empty_like(u)
        for a in range(0, t, SCAN_BLOCK):
            b = min(a + SCAN_BLOCK, t)
            dA = torch.exp(dt[:, a:b, :, None] * A)
            dBu = (dt[:, a:b] * u[:, a:b])[..., None] * B[:, a:b, None, :]
            hs = torch.empty_like(dA)
            for j in range(b - a):
                h = torch.addcmul(dBu[:, j], dA[:, j], h)
                hs[:, j] = h
            y[:, a:b] = torch.einsum("rtdn,rtn->rtd", hs, C[:, a:b])
        return y

    def _mamba(self, i: int, h):
        w = self.w
        _, t, _ = h.shape
        xz = self.mm(h, w[f"{i}.in_proj"])
        x, z = xz.chunk(2, dim=-1)
        cw = w[f"{i}.conv_w"]                              # (d_conv, d)
        dc = cw.shape[0]
        xp = F.pad(x, (0, 0, dc - 1, 0))
        x = F.silu(sum(xp[:, j:j + t] * cw[j] for j in range(dc))
                   + w[f"{i}.conv_b"])
        dt, B, C = self.mm(x, w[f"{i}.x_proj"]).split(
            [self.R, self.N, self.N], dim=-1)
        dt = self._rms(dt, w[f"{i}.dt_norm"])
        B = self._rms(B, w[f"{i}.b_norm"])
        C = self._rms(C, w[f"{i}.c_norm"])
        dt = F.softplus(self.mm(dt, w[f"{i}.dt_proj"]) + w[f"{i}.dt_bias"])
        A = -torch.exp(w[f"{i}.A_log"])
        y = self._scan(x, dt, B, C, A) + x * w[f"{i}.D"]
        return self.mm(y * F.silu(z), w[f"{i}.out_proj"])

    def _dense(self, i: int, h):
        w = self.w
        g = F.silu(self.mm(h, w[f"{i}.w_gate"])) * self.mm(h, w[f"{i}.w_up"])
        return self.mm(g, w[f"{i}.w_down"])

    def _moe(self, i: int, x):
        """x (n, D), one routing group: this chip's share of the layer."""
        w = self.w
        n = x.shape[0]
        probs = torch.softmax(self.mm(x, w[f"{i}.router"]), dim=-1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_p, top_e = top_p[:, :self.K], top_e[:, :self.K]
        e = top_e.reshape(-1)                             # (n*K,) flat
        onehot = F.one_hot(e, self.E)
        place = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
        cap = max(1, math.ceil(n * self.K * self.cf / self.E))
        local = e - self.lo
        mine = (local >= 0) & (local < self.held)
        e_loc = self.held // self.tp
        rank = torch.where(mine, local // e_loc, -1)
        kept = mine & (place < cap)
        idx = torch.arange(e.numel(), device=x.device)
        lost = torch.zeros_like(kept)
        for r in range(self.tp):
            # the last entry in flat order that rank r does not keep
            other = idx[~(kept & (rank == r))]
            last = int(other.max()) if other.numel() else -1
            lost |= ((rank == r) & (local % e_loc == 0)
                     & (place == cap - 1) & (idx < last))
        use = kept & ~lost
        tok = idx[use] // self.K
        ex = local[use]
        wt = top_p.reshape(-1)[use]
        y = torch.zeros_like(x)
        for j in torch.unique(ex).tolist():
            sel = ex == j
            xs = x[tok[sel]]
            g = F.silu(self.mm(xs, w[f"{i}.w_gate"][j])) \
                * self.mm(xs, w[f"{i}.w_up"][j])
            y.index_add_(0, tok[sel],
                         self.mm(g, w[f"{i}.w_down"][j]) * wt[sel][:, None])
        return y

    def _moe_steps(self, i: int, h, prompt_len: int):
        """The MoE over the serve steps' routing groups: the rows' prompt
        tokens as one, then each later position's rows as one."""
        r, t, d = h.shape
        out = torch.empty_like(h)
        out[:, :prompt_len] = self._moe(
            i, h[:, :prompt_len].reshape(-1, d)).reshape(r, prompt_len, d)
        for p in range(prompt_len, t):
            out[:, p] = self._moe(i, h[:, p])
        return out

    # ------------------------------------------------------------------

    @torch.no_grad()
    def logits(self, tokens, prompt_len: int):
        """tokens (R, T), a data rank's rows: the prompt's ``prompt_len``
        tokens, then the tokens fed at each decode step. The full forward
        over all T positions at once; returns the logits (R, T - P + 1, V)
        of positions P - 1 .. T - 1: the prefill's and each decode
        step's."""
        w = self.w
        x = w["embed"][tokens]
        for i, (mixer, ffn) in enumerate(self.kinds):
            h = self._rms(x, w[f"{i}.norm1"])
            x = x + (self._attention(i, h) if mixer == "attn"
                     else self._mamba(i, h))
            h = self._rms(x, w[f"{i}.norm2"])
            x = x + (self._moe_steps(i, h, prompt_len) if ffn == "moe"
                     else self._dense(i, h))
        x = self._rms(x[:, prompt_len - 1:], w["final_norm"])
        return self.mm(x, w["head"][:self.V].T)

    def prefill(self, tokens):
        """tokens (R, S): the last position's logits (R, V)."""
        return self.logits(tokens, tokens.shape[1])[:, 0]
