"""The benchmark's yardstick, frozen here so that no change to the program
moves it: the peaks of one H100, the work formulas of the port's kernels
and of a granite-style MoE model, and the statistics every metric uses.

Peaks: one H100 SXM (NVIDIA's data sheet): dense bf16 on the tensor
cores, HBM3, and the host link to the mapped pool, PCIe 5.0 x16 (32 GT/s
x 16 lanes, 128b/130b) in one direction. The work formulas are copies of
the port's ``kernels/cellcopy/ops.work`` and
``kernels/flash_attention/ops.work`` as they stood when the benchmark
was written.
"""
from __future__ import annotations

import statistics

PEAK_BF16_FLOPS = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # bytes/s
PCIE_BW = 32e9 * 16 * 128 / 130 / 8   # bytes/s, ~63.0e9


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def cellcopy_least_s(nbytes: int) -> float:
    """The least time a copy of ``nbytes`` between the card and the mapped
    pool can take: each byte crosses PCIe once."""
    return nbytes / PCIE_BW


def flash_work(b: int, h: int, kv: int, s: int, d: int, itemsize: int,
               causal: bool = True) -> tuple[int, int]:
    """(flops, bytes) of one causal GQA attention call: 4 d flops per
    (query, key) pair attended, q, k, v read once and o written once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return (4 * b * h * d * pairs,
            itemsize * d * s * b * (2 * h + 2 * kv))


def flash_least_s(b: int, h: int, kv: int, s: int, d: int,
                  itemsize: int) -> float:
    flops, nbytes = flash_work(b, h, kv, s, d, itemsize)
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BW)


# --------------------------------------------------------------------------
# model FLOPs of a granite-style MoE decoder (attention + routed SwiGLU
# experts), what the model needs: routed entries before any capacity
# drop, the head only where logits are wanted
# --------------------------------------------------------------------------

def _layer_proj_flops(m: dict, tokens: int) -> int:
    d, h, kv = m["hidden_size"], m["num_attention_heads"], \
        m["num_key_value_heads"]
    dh = d // h
    qkv = 2 * tokens * d * (h * dh + 2 * kv * dh)
    out = 2 * tokens * h * dh * d
    router = 2 * tokens * d * m["num_local_experts"]
    experts = 2 * tokens * m["num_experts_per_tok"] * 3 * d \
        * m["intermediate_size"]
    return qkv + out + router + experts


def prefill_flops(m: dict, rows: int, seq: int) -> int:
    """A prefill of ``rows`` x ``seq`` tokens returning last-position
    logits."""
    h = m["num_attention_heads"]
    dh = m["hidden_size"] // h
    attn = 4 * dh * h * rows * seq * (seq + 1) // 2
    per_layer = _layer_proj_flops(m, rows * seq) + attn
    head = 2 * rows * m["hidden_size"] * m["vocab_size"]
    return m["num_hidden_layers"] * per_layer + head


def decode_flops(m: dict, rows: int, pos: int) -> int:
    """One decode step of ``rows`` tokens at position ``pos`` (attending
    ``pos + 1`` keys), returning a token a row from the whole head."""
    h = m["num_attention_heads"]
    dh = m["hidden_size"] // h
    attn = 4 * dh * h * rows * (pos + 1)
    per_layer = _layer_proj_flops(m, rows) + attn
    head = 2 * rows * m["hidden_size"] * m["vocab_size"]
    return m["num_hidden_layers"] * per_layer + head


# --------------------------------------------------------------------------
# statistics
# --------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, by linear
    interpolation between the closest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def merge_intervals(intervals) -> list[tuple[int, int]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def covered(intervals) -> int:
    """Total length covered by the union of ``intervals``."""
    return sum(e - s for s, e in merge_intervals(intervals))


def gaps(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The parts of ``[lo, hi)`` that no interval covers."""
    out, cur = [], lo
    for s, e in merge_intervals(clip(intervals, lo, hi)):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out
