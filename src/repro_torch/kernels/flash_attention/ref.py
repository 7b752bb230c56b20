"""Plain PyTorch version of the flash attention kernel (exact softmax
attention). The wrappers in ``ops`` use it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel against it on the card."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, KV, S, D). f32 scores and softmax, the
    probabilities rounded to v's dtype before the product with v (f32
    sums), out in q.dtype."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(d)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)
