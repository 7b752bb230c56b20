"""The Mamba selective scan: its kernel (``csrc/selective_scan.cu``)
and its plain version.

A tensor on the CPU goes to the plain version, ``selective_scan_ref``:
the torch ops of the JAX package's chunked scan, unchanged. A tensor on
the card launches the kernel, and anything else raises; there is no
fallback from one to the other. ``LAUNCHES`` counts kernel launches, so a
run can show that its path went through the kernel.

Autograd: on the CPU it runs through the plain version. On the card every
call goes through the ``SelectiveScan`` autograd Function: its forward is
the kernel; its backward runs the plain version once more on the saved
inputs, under grad, and backpropagates through it (no backward kernel).
Without grad the Function records no graph.

Every call charges ``work`` to an active counter (``kernels.charged``).
Under the dry run's counter, meta tensors take the ``"meta"`` route,
which launches nothing and returns empty outputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import charged, route

CHUNK = 64                       # the plain version's tokens a chunk
STATE_SIZES = (4, 16)            # template instances: the configs' d_state
THREADS = 128                    # threads a CTA
STATES_PER_THREAD = 4
TILE = 64                        # tokens staged in shared memory at a time
LAUNCHES = 0


def work(b: int, s: int, d_in: int, n: int) -> tuple[int, int]:
    """(flops, bytes) of one scan: per token and channel dt u once, and
    per state dt A, its exponential, (dt u) B, the update's multiply-add
    and the read-out's, 7n + 1; u and dt read and y written once (f32),
    B and C read once, A read and the last state written once."""
    return (b * s * d_in * (7 * n + 1),
            4 * (3 * b * s * d_in + 2 * b * s * n + d_in * n + b * d_in * n))


def launch_plan(b: int, d_in: int, n: int) -> dict:
    """The launch ``csrc/selective_scan.cu`` makes: ``grid`` (channel
    blocks, batch), ``threads``, ``channels`` a CTA (``n / 4`` lanes a
    channel, 4 states a lane), ``tile`` (tokens a stage) and
    ``smem_bytes`` (two stages of u and dt at the CTA's channels and B
    and C, f32)."""
    ch = THREADS // (n // STATES_PER_THREAD)
    return {"grid": (-(-d_in // ch), b), "threads": THREADS,
            "channels": ch, "tile": TILE,
            "smem_bytes": 2 * TILE * (2 * ch + 2 * n) * 4}


def _chunk_scan(a, b):
    """Inclusive scan over dim 1 of the pairs (a, b) under the combine
    (al * ar, bl * ar + br), the JAX package's associative scan, by
    log-step doubling (Hillis-Steele): 6 steps for a 64-token chunk."""
    n, step = a.shape[1], 1
    while step < n:
        b = torch.cat([b[:, :step], b[:, :-step] * a[:, step:]
                       + b[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1)
        step *= 2
    return a, b


def selective_scan_ref(u, dt, B, Cm, A, h=None):
    """The plain version: (y, the state after the last token).

    Chunked as the JAX package computes it: h carried from chunk to
    chunk, a parallel scan inside a chunk. One chunk's (b, chunk, d_in, N)
    terms are held at a time. The last chunk runs at its own length where
    the JAX package pads it with zero steps: a position's value in the
    doubling scan depends on the positions before it alone, so the outputs
    are the same, and the last state is that of position S - 1."""
    b, S, d_in = u.shape
    h_c = h if h is not None else torch.zeros(
        (b, d_in, A.shape[1]), dtype=torch.float32, device=u.device)
    ys = []
    for c0 in range(0, S, CHUNK):
        uc, dtc, Bc, Cc = (a[:, c0:c0 + CHUNK] for a in (u, dt, B, Cm))
        dA = torch.exp(dtc[..., None] * A.float())               # (b,c,d,N)
        dBu = (dtc * uc)[..., None] * Bc[..., None, :]           # (b,c,d,N)
        aa, bb = _chunk_scan(dA, dBu)
        h_seq = aa * h_c[:, None] + bb
        ys.append(torch.einsum("bcdn,bcn->bcd", h_seq, Cc.float()))
        h_c = h_seq[:, -1]
    return torch.cat(ys, dim=1), h_c


def _check(u, dt, B, Cm, A, h) -> None:
    """Shapes and types the scan takes."""
    b, s, d_in = u.shape
    n = A.shape[-1]
    want = {"dt": (b, s, d_in), "B": (b, s, n), "Cm": (b, s, n),
            "A": (d_in, n), "h": (b, d_in, n)}
    for name, t in (("dt", dt), ("B", B), ("Cm", Cm), ("A", A), ("h", h)):
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"selective_scan: {name} {tuple(t.shape)}, "
                             f"want {want[name]}")
    if any(t is not None and t.dtype != torch.float32
           for t in (u, dt, B, Cm, A, h)):
        raise ValueError("selective_scan: every input must be float32")


def _launch(u, dt, B, Cm, A, h):
    """Run the kernel: (y, the state after the last token), f32."""
    global LAUNCHES
    b, s, d_in = u.shape
    n = A.shape[1]
    y = torch.empty((b, s, d_in), dtype=torch.float32, device=u.device)
    h_last = torch.empty((b, d_in, n), dtype=torch.float32, device=u.device)
    if u.is_meta:                    # the dry run: nothing to launch
        return y, h_last
    if n not in STATE_SIZES:
        raise ValueError(f"selective_scan: d_state {n} not in "
                         f"{STATE_SIZES}")
    from repro_torch.kernels.build import load
    u, dt, B, Cm, A = (t.contiguous() for t in (u, dt, B, Cm, A))
    h = None if h is None else h.contiguous()
    rc = load().selective_scan_fwd(
        *(ctypes.c_void_p(t.data_ptr()) for t in (u, dt, B, Cm, A)),
        ctypes.c_void_p(None if h is None else h.data_ptr()),
        ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(h_last.data_ptr()),
        b, s, d_in, n,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"selective_scan launch failed: CUDA error {rc}")
    return y, h_last


class SelectiveScan(torch.autograd.Function):
    """The kernel with a gradient: forward ``_launch``; backward the plain
    version's autograd on the saved inputs."""

    @staticmethod
    def forward(ctx, u, dt, B, Cm, A, h):
        ctx.save_for_backward(u, dt, B, Cm, A, h)
        return _launch(u, dt, B, Cm, A, h)

    @staticmethod
    def backward(ctx, dy, dh):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(w)
                   for t, w in zip(ctx.saved_tensors, need)]
            outs = selective_scan_ref(*ins)
            wrt = [t for t, w in zip(ins, need) if w]
            grads = iter(torch.autograd.grad(outs, wrt, (dy, dh),
                                             allow_unused=True))
        return tuple(next(grads) if w else None for w in need)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor,
                   h: torch.Tensor | None = None) -> tuple:
    """u, dt: (b, S, d_in); B, Cm: (b, S, N); A: (d_in, N); h: (b, d_in,
    N), the state before the first token (zeros where None), not written.
    All f32. Returns (y (b, S, d_in), the state after the last token)."""
    _check(u, dt, B, Cm, A, h)
    ts = (u, dt, B, Cm, A) + (() if h is None else (h,))
    where = route("selective_scan", *ts)
    with charged("selective_scan", *work(*u.shape, A.shape[1])):
        if where == "cpu":
            return selective_scan_ref(u, dt, B, Cm, A, h)
        return SelectiveScan.apply(u, dt, B, Cm, A, h)
