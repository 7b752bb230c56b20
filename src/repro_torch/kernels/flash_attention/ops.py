"""Wrappers for the flash attention kernel
(``repro_torch/csrc/flash_attention.cu``).

A tensor on the CPU goes to the plain version in ``ref``; a tensor on the
card launches the kernel, and anything else raises. There is no fallback
from one to the other. On the card the dtype picks the kernel, both on
the tensor cores: bfloat16 as bf16 wgmma fed by TMA, float32 as three
TF32 wgmma products of operands split into hi and lo parts, which keeps
f32 accuracy (``launch_plan`` gives each kernel's launch and tiles).
``LAUNCHES`` counts kernel launches, so a run can show that its path
went through the kernel. Every call charges ``work`` (the causal
triangle it computes) to an active counter (``kernels.charged``); under
the dry run's counter, meta tensors take the ``"meta"`` route, which
launches nothing and returns an empty output.

Autograd: on the CPU it runs through the plain version, as the JAX
package differentiates its oracle. On the card every call goes through
``FlashAttention``, an autograd Function whose forward is the kernel
launch (counted once) and whose backward is ``bwd.attention_bwd``, torch
ops that recompute the softmax a block of query rows at a time. Without
grad (``torch.no_grad``, or no input that requires it) the Function runs
its forward and records no graph.

A head size below the kernel's instances (the reduced configs' 8) runs
on the instance ``padded_head`` names, with zero columns (``pad_head``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import charged, itemsize, route
from repro_torch.kernels.flash_attention import bwd, ref

HEAD_DIMS = (32, 64, 128)        # template instances of the kernel
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WARPGROUP = 128                  # threads of a warpgroup
STAGES = 2                       # K/V stages in shared memory
# per dtype: query rows per CTA, keys per K/V stage, and the warpgroups
# that load (bf16: a TMA producer; f32: loads and splits into tf32 hi and
# lo) and that run the math (64 query rows each)
TILES = {torch.float32: {"block_q": 64, "block_k": 32, "load": 1,
                         "math": 1},
         torch.bfloat16: {"block_q": 128, "block_k": 128, "load": 1,
                          "math": 2}}
LAUNCHES = 0


def work(b: int, h: int, kv: int, s: int, d: int, dtype,
         causal: bool = True) -> tuple[int, int]:
    """(flops, bytes) the function needs: 4 d flops per (query, key) pair
    it attends (s(s+1)/2 pairs per head when causal); q, k, v read once
    and o written once. ``dtype``: a torch dtype or its name."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return (4 * b * h * d * pairs,
            itemsize(dtype) * d * s * b * (2 * h + 2 * kv))


def _charge(q, k, causal: bool, heads: int):
    """``charged`` with this call's work: q (.., H, .., D) and k
    (.., KV, .., D) in the layout whose head axis is ``heads``."""
    b, s, d = q.shape[0], q.shape[3 - heads], q.shape[3]
    return charged("flash_attention", *work(
        b, q.shape[heads], k.shape[heads], s, d, q.dtype, causal))


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA, as ``csrc/flash_attention.cu``
    lays it out, with 1 KB of slack to align the swizzled tiles. f32: Q
    hi and lo (64 x d each), and per stage K hi, K lo, V^T hi and V^T lo
    (32 keys x d each), all f32, and a full and an empty mbarrier per
    stage. bf16: Q (128 x d) and per stage K and V (128 x d each), and a
    Q barrier and three per stage."""
    t = TILES[dtype]
    if dtype == torch.float32:
        return (2 * t["block_q"] * d * 4 + STAGES * 4 * t["block_k"] * d * 4
                + 16 * STAGES + 1024)
    tile = t["block_k"] * d * 2
    return tile * (1 + 2 * STAGES) + 8 * (1 + 3 * STAGES) + 1024


def launch_plan(b: int, h: int, kv: int, s: int, d: int,
                dtype: torch.dtype, causal: bool = True) -> dict:
    """The launch ``csrc/flash_attention.cu`` makes: ``grid`` (CTAs),
    ``threads``, ``smem_bytes``, ``block_q`` (query rows per CTA),
    ``block_k`` (keys per K/V stage), ``stages``, ``warpgroups`` (how
    many load and how many run the math), ``order`` (the (batch, head,
    query block) of each CTA in launch order: causal, the longest blocks
    first) and ``kv_tiles`` (the K/V tiles each query block runs, the
    causal skip included). ``kv`` only checks the GQA grouping."""
    if d not in HEAD_DIMS or dtype not in TILES or kv <= 0 or h % kv:
        raise ValueError(f"launch_plan: d={d} dtype={dtype} h={h} kv={kv}")
    t = TILES[dtype]
    bq, bk = t["block_q"], t["block_k"]
    nq, n_kv = -(-s // bq), -(-s // bk)
    order = []
    for i in range(nq * h * b):
        hb, slot = i % (h * b), i // (h * b)
        order.append((hb // h, hb % h, nq - 1 - slot if causal else slot))
    tiles = [min(n_kv, (q * bq + bq - 1) // bk + 1) if causal else n_kv
             for q in range(nq)]
    return {"grid": nq * h * b,
            "threads": (t["load"] + t["math"]) * WARPGROUP,
            "smem_bytes": smem_bytes(d, dtype), "block_q": bq,
            "block_k": bk, "stages": STAGES,
            "warpgroups": {"load": t["load"], "math": t["math"]},
            "order": order, "kv_tiles": tiles}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int):
    """Shapes and types the kernel takes; ``heads`` is the axis of H in
    the layout given."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    seq = 3 - heads
    if (q.shape[0], q.shape[seq], q.shape[3]) != \
            (k.shape[0], k.shape[seq], k.shape[3]):
        raise ValueError("flash_attention: q and k/v differ in batch, "
                         "sequence or head size")
    h, kv = q.shape[heads], k.shape[heads]
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} query heads over {kv} "
                         "kv heads")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; float32 or bfloat16, all alike")
    if padded_head(q.shape[3]) is None:
        raise ValueError(f"flash_attention: head size {q.shape[3]} is "
                         f"none of {HEAD_DIMS} nor one of them over a "
                         f"power of 4")


def padded_head(d: int) -> int | None:
    """The kernel instance that runs head size ``d``: ``d`` itself, or
    the smallest of ``HEAD_DIMS`` that is ``d`` times a power of 4 (so
    that ``pad_head`` scales q exactly); None if there is none."""
    for x in HEAD_DIMS:
        r = x // d if d > 0 else 0
        if r and x % d == 0 and r & (r - 1) == 0 and \
                (r.bit_length() - 1) % 2 == 0:
            return x
    return None


def pad_head(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """q, k, v (head size d the last axis) padded to D = ``padded_head(d)``
    columns: the zero columns add nothing to a score, and q is scaled by
    sqrt(D / d), a power of 2 and so exact, so that the kernel's
    1 / sqrt(D) is 1 / sqrt(d). The attention at d is the first d
    columns of the padded output."""
    d = q.shape[3]
    x = padded_head(d)
    if x == d:
        return q, k, v
    f = 1 << ((x // d).bit_length() - 1) // 2
    pad = (0, x - d)
    return (torch.nn.functional.pad(q * f, pad),
            torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad))


def _tma_ready(t: torch.Tensor, heads: int) -> bool:
    """What the bf16 kernel's TMA maps and the f32 kernel's 16-byte
    loads need: the head dimension contiguous, the base pointer and the
    (batch, head, seq) strides positive multiples of 16 bytes."""
    es = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
        st > 0 and st * es % 16 == 0
        for st in (t.stride(0), t.stride(heads), t.stride(3 - heads))))


def _launch(q, k, v, causal: bool, heads: int) -> torch.Tensor:
    """Run the kernel on q (.., H, .., D) and k, v (.., KV, .., D) in the
    layout whose head axis is ``heads`` (1: BHSD, 2: BSHD); the output
    has q's shape and layout. A tensor the kernel cannot address as it
    lies is first copied into a fresh contiguous one, and a head size
    below the instances is padded (``pad_head``)."""
    global LAUNCHES
    if q.is_meta:                    # the dry run: nothing to launch
        return torch.empty_like(q)
    from repro_torch.kernels.build import load
    lib = load()
    head = q.shape[3]
    q, k, v = (t if _tma_ready(t, heads) else
               t.clone(memory_format=torch.contiguous_format)
               for t in pad_head(q, k, v))
    out = torch.empty_like(q)
    seq = 3 - heads
    b, s, d = q.shape[0], q.shape[seq], q.shape[3]
    h, kv = q.shape[heads], k.shape[heads]
    if b * h * s == 0:
        return out[..., :head]

    def strides(t):                  # (batch, head, seq) in elements
        return t.stride(0), t.stride(heads), t.stride(seq)

    rc = lib.flash_attention_fwd(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        DTYPES[q.dtype], b, h, kv, s, d, int(causal), *strides(q),
        *strides(k), *strides(v), *strides(out),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    return out if head == d else out[..., :head].contiguous()


class FlashAttention(torch.autograd.Function):
    """The kernel with a gradient: forward ``_launch``, backward
    ``bwd.attention_bwd`` (torch ops) on the saved q, k, v and output."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, heads: int):
        out = _launch(q, k, v, causal, heads)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.heads = causal, heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        if ctx.heads == 2:               # BSHD views as BHSD, and back
            q, k, v, out, dout = (t.transpose(1, 2)
                                  for t in (q, k, v, out, dout))
        grads = bwd.attention_bwd(q, k, v, out, dout, causal=ctx.causal)
        if ctx.heads == 2:
            grads = tuple(t.transpose(1, 2) for t in grads)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, KV, S, D) with H % KV == 0. Returns
    (B, H, S, D) in q.dtype. Query head h reads kv head h // (H // KV)."""
    _check(q, k, v, heads=1)
    where = route("flash_attention", q, k, v)
    with _charge(q, k, causal, 1):
        if where == "cpu":
            return ref.attention_ref(q, k, v, causal=causal)
        return FlashAttention.apply(q, k, v, causal, 1)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KV, D) -- the models/blocks layout.
    The kernel reads and writes this layout through strides, so nothing
    is transposed on the card."""
    _check(q, k, v, heads=2)
    where = route("flash_attention", q, k, v)
    with _charge(q, k, causal, 2):
        if where == "cpu":
            out = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=causal)
            return out.transpose(1, 2)
        return FlashAttention.apply(q, k, v, causal, 2)
