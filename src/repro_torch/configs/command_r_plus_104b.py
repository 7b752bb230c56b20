"""command-r-plus-104b — 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000. GQA, no-bias, Cohere-style parallel attn+FFN blocks.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    pattern=(BlockSpec(mixer="attn", parallel=True),),
    rope_theta=75_000.0,
    use_bias=False,
    tie_embeddings=True,
    fsdp=True,
    optimizer="adamw",
)
