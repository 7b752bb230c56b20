"""jamba-1.5-large-398b — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave. [arXiv:2403.19887; hf]

Pattern: 8-layer block with attention at position 3 (1 attn : 7 mamba),
repeated 9 times. All FFNs are MoE (16 experts, top-2). Adafactor keeps
optimizer state within v5e HBM at 398B parameters.
"""
from repro_torch.configs.base import BlockSpec, MambaConfig, ModelConfig, MoEConfig

_MAMBA = BlockSpec(mixer="mamba", ffn="moe")
_ATTN = BlockSpec(mixer="attn", ffn="moe")

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    pattern=(_MAMBA, _MAMBA, _MAMBA, _ATTN, _MAMBA, _MAMBA, _MAMBA, _MAMBA),
    moe=MoEConfig(n_experts=16, top_k=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    rope_theta=10_000.0,
    fsdp=True,
    optimizer="adafactor",
)
