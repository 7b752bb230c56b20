"""Plain PyTorch version of the WKV6 kernel: the exact sequential
recurrence, all in f32. The wrappers in ``ops`` use it for tensors on the
CPU, and ``chip_smoke.py`` holds the CUDA kernel against it on the
card."""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u):
    """r,k,v,w: (B, H, S, n); u: (H, n) -> (B, H, S, n) f32.

        S_t = diag(w_t) S_{t-1} + k_t v_t^T
        o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
    """
    b, h, s, n = r.shape
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()[None, :, :, None]
    state = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    out = torch.empty((b, h, s, n), dtype=torch.float32, device=r.device)
    for t in range(s):
        kv = torch.einsum("bhn,bhm->bhnm", k[:, :, t], v[:, :, t])
        out[:, :, t] = torch.einsum("bhn,bhnm->bhm", r[:, :, t],
                                    state + u * kv)
        state = state * w[:, :, t, :, None] + kv
    return out
