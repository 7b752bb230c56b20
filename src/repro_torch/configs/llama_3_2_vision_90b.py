"""llama-3.2-vision-90b — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attn image layers. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The modality frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (n_ctx_tokens, d_model); every 5th layer
cross-attends to them (20 cross + 80 self = 100 layers).
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    pattern=(
        BlockSpec(mixer="attn"),
        BlockSpec(mixer="attn"),
        BlockSpec(mixer="attn"),
        BlockSpec(mixer="attn"),
        BlockSpec(mixer="cross_attn"),
    ),
    n_ctx_tokens=1024,       # precomputed image patch embeddings (stub frontend)
    rope_theta=500_000.0,
    fsdp=True,
    optimizer="adamw",
)
