"""Plain PyTorch versions of the WKV6 kernels: the exact sequential
recurrence (``wkv6_ref``) and its gradient as the reverse recurrence
(``wkv6_bwd_ref``), all in f32. The wrappers in ``ops`` use the forward
for tensors on the CPU (autograd differentiates it there), and
``chip_smoke.py`` holds the CUDA kernels against both on the card."""
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


def wkv6_bwd_ref(r, k, v, w, u, do):
    """The gradients of ``wkv6_ref`` for an output gradient ``do``, as the
    explicit reverse recurrence (not through autograd); the plain version
    of the ``wkv6_bwd`` kernel. r,k,v,w,do: (B, H, S, n); u: (H, n).
    Returns (dr, dk, dv, dw, du), each in its input's dtype.

    With S_t the state after token t (S_{-1} = 0) and G_t = dL/dS_t
    (G_{S-1} = 0), going backwards over t, a_t = sum_m v_t[m] do_t[m]:

        dr_t[n] = sum_m (S_{t-1}[n,m] + u[n] k_t[n] v_t[m]) do_t[m]
        dk_t[n] = r_t[n] u[n] a_t + sum_m G_t[n,m] v_t[m]
        dv_t[m] = (sum_n r_t[n] u[n] k_t[n]) do_t[m] + sum_n k_t[n] G_t[n,m]
        dw_t[n] = sum_m G_t[n,m] S_{t-1}[n,m]
        du[n]  += sum_b r_t[n] k_t[n] a_t
        G_{t-1} = diag(w_t) G_t + r_t do_t^T

    All in f32."""
    b, h, s, n = r.shape
    rf, kf, vf, wf, dof = (a.float() for a in (r, k, v, w, do))
    uf = u.float()
    # the state before each token
    prev = []
    state = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    for t in range(s):
        prev.append(state)
        state = state * wf[:, :, t, :, None] + torch.einsum(
            "bhn,bhm->bhnm", kf[:, :, t], vf[:, :, t])
    dr, dk, dv, dw = (torch.empty((b, h, s, n), dtype=torch.float32,
                                  device=r.device) for _ in range(4))
    du = torch.zeros((h, n), dtype=torch.float32, device=r.device)
    g = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    for t in range(s - 1, -1, -1):
        rt, kt, vt, wt, dt = (a[:, :, t] for a in (rf, kf, vf, wf, dof))
        a_t = (vt * dt).sum(-1)                               # (b, h)
        dr[:, :, t] = torch.einsum("bhnm,bhm->bhn", prev[t], dt) \
            + uf * kt * a_t[..., None]
        dk[:, :, t] = rt * uf * a_t[..., None] \
            + torch.einsum("bhnm,bhm->bhn", g, vt)
        dv[:, :, t] = (rt * uf * kt).sum(-1)[..., None] * dt \
            + torch.einsum("bhn,bhnm->bhm", kt, g)
        dw[:, :, t] = (g * prev[t]).sum(-1)
        du += (rt * kt * a_t[..., None]).sum(0)
        g = g * wt[..., None] + torch.einsum("bhn,bhm->bhnm", rt, dt)
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype))
