"""dbrx-132b — 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import BlockSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    pattern=(BlockSpec(mixer="attn", ffn="moe"),),
    moe=MoEConfig(n_experts=16, top_k=4),
    rope_theta=500_000.0,
    fsdp=True,
    optimizer="adamw",
)
