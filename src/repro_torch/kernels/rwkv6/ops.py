"""Wrappers for the WKV6 kernels (``repro_torch/csrc/wkv6.cu``).

A tensor on the CPU goes to the plain version in ``ref``; a tensor on the
card launches the kernel, and anything else raises. There is no fallback
from one to the other. ``LAUNCHES`` counts forward kernel launches and
``BWD_LAUNCHES`` backward ones (``wkv6_bwd``: one call, four kernels on
the stream), so a run can show that its path went through them.

Autograd: on the CPU it runs through the plain version. On the card
every call goes through the ``WKV6`` autograd Function: its forward is
the forward kernel, its backward the ``wkv6_bwd`` kernel (the explicit
reverse recurrence of ``ref.wkv6_bwd_ref``). Without grad the Function
runs its forward once and records no graph.

Every forward charges ``work`` and every ``wkv6_bwd`` ``bwd_work`` to an
active counter (``kernels.charged``; on the CPU the gradient is the plain
version's autograd, whose ops count as they run). Under the dry run's
counter, meta tensors take the ``"meta"`` route, which launches nothing
and returns empty outputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import charged, itemsize, route
from repro_torch.kernels.rwkv6 import ref

HEAD_SIZES = (8, 16, 32, 64)     # template instances of the kernel
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COLS = 8                         # state columns per CTA
COLS_PER_THREAD = 2              # columns a thread carries
ROW_GROUPS = 8                   # threads per column, n / 8 rows each
CHUNK = 32                       # tokens staged in shared memory at a time
SUB = 8                          # tokens whose states wkv6_bwd holds at once
TILE_ROWS, TILE_COLS = 2, 4      # wkv6_bwd: a thread's tile of S and G
CARRY_THREADS = 128              # wkv6_bwd's carry kernel
SM_SMEM = 233472                 # bytes of shared memory an H100 SM holds
LAUNCHES = 0
BWD_LAUNCHES = 0


def work(b: int, h: int, s: int, n: int, dtype) -> tuple[int, int]:
    """(flops, bytes): per token and head 2n^2 for r.S, 4n for
    (r.(u*k)) v, 3n^2 for S*w + k v^T; r, k, v (``dtype``), w (f32) read
    and o (f32) written once, u read once."""
    es = itemsize(dtype)
    return (b * h * s * (5 * n * n + 4 * n),
            b * h * s * n * (3 * es + 4 + 4) + h * n * 4)


def bwd_work(b: int, h: int, s: int, n: int, dtype) -> tuple[int, int]:
    """(flops, bytes) of the backward from the inputs alone: per token
    and head 3n^2 to recompute the state, 2n^2 each for dr (S do), dk
    (G v), dv (k^T G) and dw (G * S summed), 3n^2 for G's update, and
    10n for the u and a_t terms; r, k, v, w and do (f32) read once, dr,
    dk, dv and dw written once, u read and du written once."""
    es = itemsize(dtype)
    return (b * h * s * (14 * n * n + 10 * n),
            b * h * s * n * (6 * es + 4 + 4 + 4) + 2 * h * n * 4)


def _dims(r, heads: int) -> tuple[int, int, int, int]:
    """(b, h, s, n) of r in the layout whose head axis is ``heads``."""
    return r.shape[0], r.shape[heads], r.shape[3 - heads], r.shape[3]


def launch_plan(b: int, h: int, s: int, n: int, dtype: torch.dtype) -> dict:
    """The launch ``csrc/wkv6.cu`` makes: ``grid`` (column groups, heads,
    batch), ``threads`` (``COLS / COLS_PER_THREAD`` x ``ROW_GROUPS``),
    ``smem_bytes`` (two chunk buffers: r, k and w of ``CHUNK`` tokens at
    all n rows, v at the CTA's columns, and an f32 partial of o per row
    group and column), ``chunks`` (``(t0, t1)`` token ranges, the last
    one ragged) and ``rows`` (each row group's rows)."""
    es = torch.empty(0, dtype=dtype).element_size()
    stage = CHUNK * (n * (2 * es + 4) + COLS * es + COLS * ROW_GROUPS * 4)
    return {"grid": (n // COLS, h, b),
            "threads": COLS // COLS_PER_THREAD * ROW_GROUPS,
            "smem_bytes": 2 * stage, "chunk": CHUNK, "cols": COLS,
            "row_groups": ROW_GROUPS,
            "chunks": [(t, min(t + CHUNK, s)) for t in range(0, s, CHUNK)],
            "rows": [range(g * n // ROW_GROUPS, (g + 1) * n // ROW_GROUPS)
                     for g in range(ROW_GROUPS)]}


def _check(r, k, v, w, u, heads: int) -> None:
    """Shapes and types the kernel takes; ``heads`` is the axis of H in
    the layout given."""
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"wkv6: r, k, v, w shapes {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}")
    h, n = r.shape[heads], r.shape[3]
    if tuple(u.shape) != (h, n):
        raise ValueError(f"wkv6: u {tuple(u.shape)}, want {(h, n)}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6: r, k, v dtypes {r.dtype}, {k.dtype}, "
                         f"{v.dtype}; float32 or bfloat16, all alike")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"wkv6: w and u must be float32 ({w.dtype}, "
                         f"{u.dtype})")
    if n not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {n} not in {HEAD_SIZES}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(r, k, v, w, u, heads: int) -> torch.Tensor:
    """Run the kernel in the layout whose head axis is ``heads`` (1:
    BHSN, 2: BSHN); the f32 output has r's shape and layout."""
    global LAUNCHES
    if r.is_meta:                    # the dry run: nothing to launch
        return torch.empty(r.shape, dtype=torch.float32, device="meta")
    from repro_torch.kernels.build import load
    # contiguous, and 16-byte aligned for the kernel's cp.async copies
    r, k, v, w, u = (_aligned(a.contiguous()) for a in (r, k, v, w, u))
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    seq = 3 - heads
    b, h, s, n = r.shape[0], r.shape[heads], r.shape[seq], r.shape[3]
    if b * h * s == 0:
        return out
    # r, k, v and w are contiguous and alike in shape: one set of strides
    rc = load().wkv6_fwd(
        *(ctypes.c_void_p(a.data_ptr()) for a in (r, k, v, w, u, out)),
        DTYPES[r.dtype], b, h, s, n, r.stride(0), r.stride(heads),
        r.stride(seq), out.stride(0), out.stride(heads), out.stride(seq),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {rc}")
    return out


def bwd_launch_plan(b: int, h: int, s: int, n: int, dtype: torch.dtype
                    ) -> dict:
    """The launches ``wkv6_bwd`` makes, in stream order. The state is split
    by rows: a CTA holds ``rows`` (16, or n below 16) of the n x n state
    at all n columns, a thread a ``TILE_ROWS`` x ``TILE_COLS`` tile of it,
    and the ``cluster`` = n / ``rows`` row groups of a chunk form a
    thread-block cluster. ``grid`` (row groups x chunks, h, b) is that of
    the local kernel (each chunk's decay product, its walks from zero as
    sums of products, a_t and du's partial; ``local_smem_bytes``: r, k, w
    at the CTA's rows and v, do at all columns for ``CHUNK`` tokens, a_t,
    and k and r times their decay products) and of the chunk kernel
    (``smem_bytes``: the stage, a_t, u at the CTA's rows, and ``SUB``
    tokens' partials in planes of one entry a thread and a padding entry
    after every 16 threads: dr, dk, dw as float2, dv as float4);
    ``tile_threads`` hold state, ``threads`` (at least a warp) run a CTA.
    Between them the carry kernel (``carry_grid``, ``carry_threads``: a
    thread per 4 columns of a row of a (b, h), S forward and G backward)
    turns the chunks' walks into start states and end Gs; the du kernel
    (``du_grid``) adds the chunks' du partials. ``workspace_floats`` by part: the chunks' start
    states and end Gs, their decays, a_t, the du partials.
    ``ctas_per_sm_by_smem`` and ``warps_per_scheduler_by_smem``: the chunk
    kernel's residency as its shared memory and threads allow (the card's
    registers may allow fewer; ``wkv6_bwd_occupancy`` in the library
    reports them)."""
    es = torch.empty(0, dtype=dtype).element_size()
    rows = min(16, n)
    groups, nch = n // rows, -(-s // CHUNK)
    tile = (rows // TILE_ROWS) * (n // TILE_COLS)
    threads = max(32, tile)
    stage = CHUNK * (rows * (2 * es + 4) + n * (es + 4)) + CHUNK * 4
    stride = tile + tile // 16
    smem = stage + rows * 4 + SUB * stride * (3 * 8 + 16)
    parts = {"starts": b * h * nch * n * n, "end_g": b * h * nch * n * n,
             "decay": b * h * nch * n, "a_t": b * h * nch * CHUNK,
             "du": b * nch * h * n}
    ctas = min(SM_SMEM // (smem + 1024), 2048 // threads, 32)
    return {"grid": (groups * nch, h, b), "cluster": groups, "rows": rows,
            "tile_threads": tile, "threads": threads, "smem_bytes": smem,
            "local_smem_bytes": stage + 2 * CHUNK * rows * 4,
            "carry_grid": (-(-(b * h * n * n // 4) // CARRY_THREADS), 2),
            "carry_threads": CARRY_THREADS, "du_grid": (h,),
            "workspace_floats": parts,
            "workspace_bytes": 4 * sum(parts.values()),
            "ctas_per_sm_by_smem": ctas,
            "warps_per_scheduler_by_smem": ctas * threads / 32 / 4}


def _launch_bwd(r, k, v, w, u, do, heads: int) -> tuple:
    """Run ``wkv6_bwd`` in the layout whose head axis is ``heads``:
    (dr, dk, dv) in r's dtype, dw and du in f32, in the inputs' shapes and
    layout. One call launches the four kernels of ``bwd_launch_plan`` (the
    chunks' walks from zero, the carry over the chunks, the chunks'
    reverse walks, du) on a workspace it allocates with ``torch.empty``."""
    global BWD_LAUNCHES
    if r.is_meta:                    # the dry run: nothing to launch
        return (*(torch.empty_like(a) for a in (r, k, v, w)),
                torch.empty_like(u))
    from repro_torch.kernels.build import load
    r, k, v, w, u, do = (_aligned(a.contiguous())
                         for a in (r, k, v, w, u, do.float()))
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.empty_like(u)
    seq = 3 - heads
    b, h, s, n = r.shape[0], r.shape[heads], r.shape[seq], r.shape[3]
    if b * h * s == 0:
        return dr.zero_(), dk.zero_(), dv.zero_(), dw.zero_(), du.zero_()
    plan = bwd_launch_plan(b, h, s, n, r.dtype)
    ws = torch.empty(plan["workspace_bytes"] // 4, dtype=torch.float32,
                     device=r.device)
    # every tensor is contiguous in one shape: one set of strides
    rc = load().wkv6_bwd(
        *(ctypes.c_void_p(a.data_ptr())
          for a in (r, k, v, w, u, do, dr, dk, dv, dw, du, ws)),
        DTYPES[r.dtype], b, h, s, n, r.stride(0), r.stride(heads),
        r.stride(seq),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    BWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"wkv6_bwd launch failed: CUDA error {rc}")
    return dr, dk, dv, dw, du


class WKV6(torch.autograd.Function):
    """The kernel with a gradient: forward ``_launch``, backward
    ``_launch_bwd`` on the saved inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, heads: int):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.heads = heads
        return _launch(r, k, v, w, u, heads)

    @staticmethod
    def backward(ctx, do):
        r = ctx.saved_tensors[0]
        with charged("wkv6_bwd", *bwd_work(*_dims(r, ctx.heads), r.dtype)):
            grads = _launch_bwd(*ctx.saved_tensors, do, ctx.heads)
        return (*grads, None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> torch.Tensor:
    """r,k,v,w: (B, H, S, n); u: (H, n). Returns (B, H, S, n) f32."""
    _check(r, k, v, w, u, heads=1)
    where = route("wkv6", r, k, v, w, u)
    with charged("wkv6", *work(*_dims(r, 1), r.dtype)):
        if where == "cpu":
            return ref.wkv6_ref(r, k, v, w, u)
        return WKV6.apply(r, k, v, w, u, 1)


def wkv6_bshn(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r,k,v,w: (B, S, H, n); u: (H, n) -> (B, S, H, n) f32 (the
    models/blocks._wkv6_scan layout). The kernels read and write this
    layout through strides, so nothing is transposed on the card."""
    _check(r, k, v, w, u, heads=2)
    where = route("wkv6", r, k, v, w, u)
    with charged("wkv6", *work(*_dims(r, 2), r.dtype)):
        if where == "cpu":
            args = (a.transpose(1, 2) for a in (r, k, v, w))
            return ref.wkv6_ref(*args, u).transpose(1, 2)
        return WKV6.apply(r, k, v, w, u, 2)
