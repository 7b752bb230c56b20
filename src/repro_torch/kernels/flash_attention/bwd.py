"""The gradient of flash attention on the card, in torch ops.

The JAX package has no backward for its Pallas kernel: its models call
the jnp oracle, and ``jax.value_and_grad`` differentiates that
(``src/repro/launch/train.py``). The port's forward on the card is the
kernel (``csrc/flash_attention.cu``), which writes only the output, so
this backward recomputes the softmax from Q and K, one block of query
rows at a time, with the standard formulas

    P  = softmax(scale Q K^T)        (causal mask; f32)
    dV = P^T dO        dP = dO V^T        D = rowsum(dO * O)
    dS = P * (dP - D)  dQ = scale dS K    dK = scale dS^T Q

in f32, summing dK and dV over the ``H / KV`` query heads that share a
kv head. A block of ``block_q`` rows holds (B, H, block_q, keys) f32
scores and two more of that size, never (B, H, S, S): at B = 8, H = 9,
S = 4096 one block of 1024 rows is 1.2 GB. Under a causal mask a block
reads only the keys up to its last row. ``ROADMAP.md`` Queue 2 holds the
kernel that would replace it (the forward writing its row log-sum-exp,
and a hand-written backward).
"""
from __future__ import annotations

import math

import torch

BLOCK_Q = 1024                   # query rows per block


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                  block_q: int = BLOCK_Q):
    """q, o, do: (B, H, S, D); k, v: (B, KV, S, D), in any strides; o is
    the forward's output and do its gradient. Returns (dq, dk, dv) in the
    dtypes of q, k and v."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    dq = torch.empty((b, h, s, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, kv, s, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, kv, s, d), dtype=torch.float32, device=dev)
    kf, vf = k.float(), v.float()

    def rows(t, i0, i1):         # (B, H, n, D) -> (B, KV, G, n, D) f32
        return t[:, :, i0:i1].float().reshape(b, kv, g, i1 - i0, d)

    for i0 in range(0, s, block_q):
        i1 = min(i0 + block_q, s)
        n = i1 if causal else s  # the keys this block's rows can see
        qb, ob, dob = rows(q, i0, i1), rows(o, i0, i1), rows(do, i0, i1)
        kb, vb = kf[:, :, :n], vf[:, :, :n]
        p = torch.einsum("bkgqd,bknd->bkgqn", qb, kb).mul_(scale)
        if causal:
            later = (torch.arange(n, device=dev)[None, :]
                     > torch.arange(i0, i1, device=dev)[:, None])
            p.masked_fill_(later, float("-inf"))
        p = torch.softmax(p, dim=-1)
        dv[:, :, :n] += torch.einsum("bkgqn,bkgqd->bknd", p, dob)
        ds = torch.einsum("bkgqd,bknd->bkgqn", dob, vb)
        ds.sub_((dob * ob).sum(dim=-1, keepdim=True)).mul_(p)
        del p
        dq[:, :, i0:i1] = torch.einsum(
            "bkgqn,bknd->bkgqd", ds, kb).mul_(scale).reshape(
                b, h, i1 - i0, d)
        dk[:, :, :n] += torch.einsum("bkgqn,bkgqd->bknd", ds,
                                     qb).mul_(scale)
        del ds
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
