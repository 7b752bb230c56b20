"""jamba2-mini — AI21-Jamba2-Mini: 32L d_model=4096 32H (GQA kv=8, head
128) d_ff=14336 vocab=65536, Mamba-1 and attention 7:1, MoE 16 experts
top-2 every other layer. [hf:ai21labs/AI21-Jamba2-Mini config.json]

Pattern: 8 layers with attention at offset 4 (``attn_layer_period`` 8,
``attn_layer_offset`` 4) and MoE at the odd positions
(``expert_layer_period`` 2, ``expert_layer_offset`` 1), dense SwiGLU at
the even ones; repeated 4 times. Mamba-1: d_state 16, d_conv 4, expand 2
(d_inner 8192), dt_rank 256, conv bias on, projection bias off, RMSNorms
on x_proj's dt, B and C. Attention has no positional encoding. The
router's top-2 softmax weights are not renormalised. The equations are
HF ``modeling_jamba``'s as recalled, not read.
"""
from repro_torch.configs.base import (BlockSpec, MambaConfig, MoEConfig,
                                      PortConfig)


def _layer(i: int) -> BlockSpec:
    return BlockSpec(mixer="attn" if i % 8 == 4 else "mamba",
                     ffn="moe" if i % 2 == 1 else "dense")


CONFIG = PortConfig(
    arch_id="jamba2-mini",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    pattern=tuple(_layer(i) for i in range(8)),
    moe=MoEConfig(n_experts=16, top_k=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
    norm_eps=1e-6,
    attn_rope=False,
    mamba_inner_norms=True,
    moe_renormalize=False,
)
