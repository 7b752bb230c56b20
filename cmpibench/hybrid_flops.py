"""Model FLOPs of a Jamba-style hybrid (Mamba-1 and attention layers,
dense and MoE SwiGLU FFNs) in prefill, frozen here beside the benchmark
so that no change to the program moves them: what the model needs of a
chip that holds ``num_experts`` of the ``router_experts`` routed over.

Counted once a row (not once a model rank): every projection, the
attention's scores and values over the causal pairs, the Mamba conv and
scan (two FLOPs a multiply-add, the scan's update and read-out six a
(channel, state) pair a token), the router, the experts at top-k routes
times the held share (before any capacity drop), and the head at the
last position alone.
"""
from __future__ import annotations

from cmpibench.reference.jamba import layer_kinds


def prefill_flops(m: dict, rows: int, seq: int) -> int:
    d, h, kv = m["hidden_size"], m["num_attention_heads"], \
        m["num_key_value_heads"]
    dh = d // h
    f = m["intermediate_size"]
    d_in = m["mamba_expand"] * d
    n, r, dc = m["mamba_d_state"], m["mamba_dt_rank"], m["mamba_d_conv"]
    t = rows * seq
    total = 0
    for mixer, ffn in layer_kinds(m):
        if mixer == "attn":
            total += 2 * t * d * (h * dh + 2 * kv * dh) + 2 * t * h * dh * d
            total += 4 * dh * h * rows * seq * (seq + 1) // 2
        else:
            total += 2 * t * d * 2 * d_in                 # in_proj
            total += 2 * t * d_in * dc                    # conv
            total += 2 * t * d_in * (r + 2 * n)           # x_proj
            total += 2 * t * r * d_in                     # dt_proj
            total += 6 * t * d_in * n                     # the scan
            total += 2 * t * d_in * d                     # out_proj
        if ffn == "moe":
            total += 2 * t * d * m["router_experts"]
            total += (2 * t * m["num_experts_per_tok"] * 3 * d * f
                      * m["num_experts"] // m["router_experts"])
        else:
            total += 2 * t * 3 * d * f
    return total + 2 * rows * d * m["vocab_size"]
